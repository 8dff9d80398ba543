#!/usr/bin/env python
"""Per-RSD-model throughput probe (transfer-forced, like bench.py).

Measures batched likelihood evals/s for each rsd_model variant of the BOSS
CMASS config on the default backend. Prints one JSON line per variant.

Usage:
    python tools/bench_variants.py [streaming dispersion kaiser euclid_special esm joint]

'esm' benches the 9-parameter excursion-set pipeline
(configs/esm_sampling_config.yaml) instead of a boss_config rsd_model; it
is not in the no-args default list (its compile is the longest) — request
it explicitly. VICTOR_BENCH_STREAMING=fast composes with it.

'joint' benches the 5-parameter 2-quantile multiquantile fit (stacked
120-dim vector, rho=0.4 equicorrelated beta-varying cross-covariance,
per-quantile sigma_v__q<i> overrides — the same synthetic joint bundle the
calibration campaign uses, tools/coverage_test.py); 'joint<N>' (joint3,
joint5, ...) benches the N-quantile version (stacked N*60-dim vector,
kron((1-rho)I + rho 11^T, C(beta)) covariance) with an analytic chi2 gate
N*65.0118/(1+(N-1)rho). Throughput is JOINT evals/s; each joint eval runs
the theory pipeline once per quantile, so per-quantile theory throughput
is N x the printed number. Not in the default list; request explicitly.

Environment: VICTOR_BENCH_BATCH (default 32768), VICTOR_BENCH_CHUNK (64),
VICTOR_BENCH_REPS (5). Dispatch is asynchronous, so every timed repetition
waits with block_until_ready. Exits non-zero without a result when JAX
finds no GPU.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REFERENCE_EVALS_PER_SEC = 11.8   # upstream victor, one CPU core (BASELINE.md)


def main():
    import jax
    import jax.numpy as jnp

    from victor_tpu.io import build_tables, load_config
    from victor_tpu.likelihood.batched import make_batched_loglike
    from victor_tpu.utils.device import (card_name_and_power_limit,
                                         require_gpu)
    from victor_tpu.utils.profiling import enable_persistent_cache
    device = require_gpu()
    print(f"device: {device['kind']} x{device['count']}; "
          f'nvidia-smi: {card_name_and_power_limit()}', flush=True)
    enable_persistent_cache()

    variants = sys.argv[1:] or ['streaming', 'dispersion', 'kaiser',
                                'euclid_special']
    n = int(os.environ.get('VICTOR_BENCH_BATCH', 32768))
    chunk = int(os.environ.get('VICTOR_BENCH_CHUNK', 64))
    reps = int(os.environ.get('VICTOR_BENCH_REPS', 5))

    cfg = load_config(os.path.join(REPO, 'configs', 'boss_config.json'))
    cfg['model']['dir'] = REPO
    cfg['data']['dir'] = REPO

    accuracy_knobs = [k for k in ('VICTOR_BENCH_NITER',
                                  'VICTOR_BENCH_INTERIOR',
                                  'VICTOR_BENCH_FINAL',
                                  'VICTOR_BENCH_STREAMING')
                      if os.environ.get(k)]
    gate_failures = []

    rng = np.random.default_rng(0)
    theta = jnp.asarray(np.column_stack([
        rng.uniform(0.3, 0.6, n),      # fsigma8
        rng.uniform(0.25, 0.55, n),    # beta
        rng.uniform(250.0, 450.0, n),  # sigma_v
        rng.uniform(0.9, 1.1, n),      # epsilon
    ]))
    names = ['fsigma8', 'beta', 'sigma_v', 'epsilon']

    # 'esm' variant: the 9-parameter excursion-set pipeline (streaming RSD +
    # excursion_set matter model, configs/esm_sampling_config.yaml) — ranges
    # track the params-block ref scales so profiles stay in the regular
    # (no-shell-crossing) regime, like the sampler sees them
    esm_theta = jnp.asarray(np.column_stack([
        rng.uniform(0.6, 0.9, n),       # f
        rng.uniform(0.7, 0.9, n),       # sigma_8_0
        rng.uniform(-1.8, -1.2, n),     # b10
        rng.uniform(-5.0, -3.5, n),     # b01
        rng.uniform(7.0, 9.0, n),       # Rp
        rng.uniform(0.4, 0.55, n),      # Rx
        rng.uniform(0.3, 0.5, n),       # beta
        rng.uniform(300.0, 450.0, n),   # sigma_v
        rng.uniform(0.95, 1.05, n),     # epsilon
    ]))
    esm_names = ['f', 'sigma_8_0', 'b10', 'b01', 'Rp', 'Rx',
                 'beta', 'sigma_v', 'epsilon']

    for variant in variants:
        if variant.startswith('joint'):
            # 'joint' = 2 quantiles; 'joint<N>' (e.g. joint3, joint5) benches
            # the N-quantile stacked fit — per-quantile theory throughput is
            # N x the printed joint number, formalising the scaling curve
            # with quantile count
            nq = int(variant[5:]) if variant[5:] else 2
            sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
            from coverage_test import build_joint_boss_bundle
            from victor_tpu.likelihood.multiquantile import \
                make_batched_joint_loglike
            joint_overrides = {}
            if os.environ.get('VICTOR_BENCH_STREAMING'):
                joint_overrides['streaming_eval'] = \
                    os.environ['VICTOR_BENCH_STREAMING']
            rho = 0.4
            jb = build_joint_boss_bundle(rho=rho,
                                         model_overrides=joint_overrides,
                                         n_quantiles=nq)
            joint_names = ['fsigma8', 'beta'] \
                + [f'sigma_v__q{i}' for i in range(nq)] + ['epsilon']
            joint_theta = jnp.asarray(np.column_stack(
                [rng.uniform(0.3, 0.6, n),       # fsigma8 (shared)
                 rng.uniform(0.25, 0.55, n)]     # beta (shared)
                + [rng.uniform(250.0, 450.0, n) for _ in range(nq)]
                + [rng.uniform(0.9, 1.1, n)]))   # epsilon (shared)
            batched = make_batched_joint_loglike(jb, joint_names,
                                                 chunk=chunk)
            theta_v = joint_theta

            jax.block_until_ready(batched(theta_v))    # warm-up / compile
            t0 = time.perf_counter()
            for _ in range(reps):
                jax.block_until_ready(batched(theta_v))
            dt = time.perf_counter() - t0

            # analytic golden at {fsigma8 .47, beta .37, sv 380 x nq, eps 1}
            # through the equicorrelated joint covariance: identical
            # per-quantile residuals give chi2 = nq chi2_single /
            # (1 + (nq-1) rho); the nq=2 value 92.8740 is also pinned by the
            # f64 CPU run (regenerate: same call under JAX_PLATFORMS-forced
            # CPU + x64)
            golden = nq * 65.0118 / (1.0 + (nq - 1) * rho)
            gp = jnp.asarray([[0.47, 0.37] + [380.0] * nq + [1.0]])
            chi2 = float(np.asarray(batched(gp)[1])[0])
            gate = {'chi2': round(chi2, 4), 'analytic': round(golden, 4),
                    'ok': bool(abs(chi2 - golden) < 0.05)}
            if accuracy_knobs:
                gate['accuracy_knobs'] = accuracy_knobs
            elif not gate['ok']:
                gate_failures.append(variant)

            evals_per_sec = reps * n / dt
            print(json.dumps({
                'metric': f'likelihood_evals_per_sec[{variant}]',
                'value': evals_per_sec,
                'unit': f'joint evals/s ({nq} quantile theory evals each)',
                'vs_baseline': evals_per_sec / REFERENCE_EVALS_PER_SEC,
                'device': device,
                'parity_gate': gate,
            }), flush=True)
            continue
        if variant == 'esm':
            ecfg = load_config(os.path.join(REPO, 'configs',
                                            'esm_sampling_config.json'))
            ecfg['model']['dir'] = REPO
            ecfg['data']['dir'] = REPO
            vcfg = {'model': ecfg['model'], 'data': ecfg['data']}
            names_v, theta_v = esm_names, esm_theta
        else:
            vcfg = {'model': dict(cfg['model']), 'data': cfg['data']}
            vcfg['model']['rsd_model'] = variant
            names_v, theta_v = names, theta
        # optional dispersion-path knobs for profiling (see BASELINE.md
        # "Dispersion anatomy")
        if os.environ.get('VICTOR_BENCH_NITER'):
            vcfg['model']['niter'] = int(os.environ['VICTOR_BENCH_NITER'])
        if os.environ.get('VICTOR_BENCH_INTERIOR'):
            vcfg['model']['dispersion_interior'] = \
                os.environ['VICTOR_BENCH_INTERIOR']
        if os.environ.get('VICTOR_BENCH_FINAL'):
            vcfg['model']['dispersion_final'] = \
                os.environ['VICTOR_BENCH_FINAL']
        if os.environ.get('VICTOR_BENCH_STREAMING'):
            vcfg['model']['streaming_eval'] = \
                os.environ['VICTOR_BENCH_STREAMING']
        bundle = build_tables(vcfg['model'], vcfg['data'])
        batched = make_batched_loglike(bundle, names_v, chunk=chunk)

        jax.block_until_ready(batched(theta_v))    # warm-up / compile
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.block_until_ready(batched(theta_v))
        dt = time.perf_counter() - t0

        # chi2 parity gate at the notebook golden point (cell-22 values;
        # catches lost matmul-precision pins — reduced precision costs ~1.3
        # on chi2 — and any accuracy regression from the dispersion knobs)
        golden_chi2 = {'streaming': 65.0118, 'dispersion': 65.0299,
                       'kaiser': 103.9033, 'euclid_special': 4880.2898,
                       # f64 CPU value at the esm_sampling_config ref
                       # fiducial {f .78, s8 .81, b10 -1.544, b01 -4.228,
                       # Rp 7.973, Rx .467, beta .4, sv 380, eps 1.0}
                       'esm': 85.0288}
        gate = None
        if variant in golden_chi2:
            gp = jnp.asarray([[0.78, 0.81, -1.544, -4.228, 7.973, 0.467,
                               0.4, 380.0, 1.0]]) if variant == 'esm' \
                else jnp.asarray([[0.47, 0.37, 380.0, 1.0]])
            chi2 = float(np.asarray(batched(gp)[1])[0])
            gate = {'chi2': round(chi2, 4),
                    'ok': bool(abs(chi2 - golden_chi2[variant]) < 0.05)}
            if accuracy_knobs:
                # intentional approximation knobs are set: the gate is
                # informational (an ok:false here is expected, not a
                # regression)
                gate['accuracy_knobs'] = accuracy_knobs
            elif not gate['ok']:
                gate_failures.append(variant)

        evals_per_sec = reps * n / dt
        print(json.dumps({
            'metric': f'likelihood_evals_per_sec[{variant}]',
            'value': evals_per_sec,
            'unit': 'evals/s',
            'vs_baseline': evals_per_sec / REFERENCE_EVALS_PER_SEC,
            'device': device,
            **({'parity_gate': gate} if gate else {}),
        }), flush=True)

    if gate_failures:
        # fail the process so automation catches a lost precision pin
        # (chi2 ~66.3 means reduced-precision matmuls leaked back in)
        sys.exit(f'parity gate FAILED for: {", ".join(gate_failures)}')


if __name__ == '__main__':
    main()
