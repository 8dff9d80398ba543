#!/usr/bin/env python
"""Headline benchmark: batched BOSS CMASS likelihood throughput on one GPU.

Prints the card (JAX device kind, device count, and nvidia-smi's name and
power limit) on earlier lines, then ONE JSON line
{"metric", "value", "unit", "vs_baseline", "device"} last. Exits non-zero
without a result when JAX finds no GPU, and when the chi2 parity gate fails.

Baseline denominator: the upstream victor implementation measured at 11.8
likelihood evals/sec on one CPU core (BASELINE.md, streaming RSD model,
Sellentin likelihood, beta-varying D covariance — the exact
victor_usage_demo.ipynb configuration). We evaluate the same likelihood in
float32, vmapped over a large batch of parameter points in one jitted
dispatch.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

REFERENCE_CPU_EVALS_PER_SEC = 11.8   # upstream victor, one CPU core


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

    cfg = load_config(os.path.join(REPO, 'configs', 'boss_config.json'))
    cfg['model']['dir'] = REPO
    cfg['data']['dir'] = REPO

    bundle = build_tables(cfg['model'], cfg['data'])
    names = ['fsigma8', 'beta', 'sigma_v', 'epsilon']
    chunk = int(os.environ.get('VICTOR_BENCH_CHUNK', 64))
    batched = make_batched_loglike(bundle, names, chunk=chunk)

    # correctness spot-check at the notebook cell-22 golden point
    golden = jnp.asarray([[0.47, 0.37, 380.0, 1.0]])
    lnl, chi2 = batched(golden)
    if abs(float(chi2[0]) - 65.01) > 0.2:
        # exit NONZERO: a lost matmul precision pin reads chi2 ~66.3
        sys.exit(f'chi2 parity failure: {float(chi2[0]):.4f} (want 65.01)')

    # batch of realistic parameter draws around the posterior
    rng = np.random.default_rng(0)
    n = int(os.environ.get('VICTOR_BENCH_BATCH', 32768))
    theta = jnp.asarray(np.column_stack([
        rng.uniform(0.3, 0.6, n),      # fsigma8
        rng.uniform(0.25, 0.55, n),    # beta
        rng.uniform(250.0, 450.0, n),  # sigma_v
        rng.uniform(0.9, 1.1, n),      # epsilon
    ]), dtype=jnp.float32)

    jax.block_until_ready(batched(theta))          # warm-up / compile

    # dispatch is asynchronous: wait for each rep inside the timed region
    reps = int(os.environ.get('VICTOR_BENCH_REPS', 5))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(batched(theta))
    dt = time.perf_counter() - t0

    evals_per_sec = reps * n / dt
    print(json.dumps({
        'metric': 'likelihood_evals_per_sec',
        'value': evals_per_sec,
        'unit': 'evals/s',
        'vs_baseline': evals_per_sec / REFERENCE_CPU_EVALS_PER_SEC,
        'device': device,
    }), flush=True)


if __name__ == '__main__':
    main()
