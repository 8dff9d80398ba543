#!/usr/bin/env python
"""On-card smoke test of the main path, at full BOSS width.

    python chip_smoke.py               # every phase, one GPU
    python chip_smoke.py --devices 4   # the sharded path only, four GPUs

One process drives the card. Phases, in order, each printing one line with
its largest deviation beside the tolerance it is held to:

  device        JAX version, device kind and count, nvidia-smi's card name
                and power limit; no GPU means exit non-zero, no result.
  exact_theory  build_tables on the BOSS DR12 CMASS config, the direct
                (unbatched) theory and likelihood against the float64
                outputs of upstream victor in tests/fixtures/reference_boss.npz.
  batched       make_batched_loglike, chunk 64, 32768 points, under the
                default 'auto' modes and explicit 'exact', each against a
                float64 CPU evaluation of the same modes at 256 of the
                points; compile seconds and the compiled step's
                memory_analysis().
  rsd_esm       the dispersion, kaiser and euclid_special models and the
                9-parameter excursion-set model at 32768 points, and the
                excursion-set value_and_grad (the AD path), against float64
                on the CPU.
  samplers      `python -m victor_tpu run` as users call it: bare (adaptive
                MH), --sampler hmc, and --sampler smc to beta = 1, whose
                log-evidence must land within 0.5 of the quadrature value.

The float64 CPU reference runs in a child process with JAX_PLATFORMS=cpu,
so it never touches the card. With --devices 4 the script runs only the
sharded likelihood and HMC against their unsharded runs (rtol 1e-4, atol
1e-3), the sharded SMC against the unsharded one as estimators (within
their statistical error), and the CLI's auto-mesh SMC. The last line of
standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from victor_tpu.io import build_tables, load_config  # noqa: E402
from victor_tpu.likelihood import core as lk  # noqa: E402
from victor_tpu.likelihood.batched import (make_batched_loglike,  # noqa: E402
                                           make_loglike)
from victor_tpu.models import ccf_theory as th  # noqa: E402
from victor_tpu.utils.device import (card_name_and_power_limit,  # noqa: E402
                                     require_gpu)

N_BATCH = 32768          # bench.py's batch
CHUNK = 64               # bench.py's chunk
N_REF = 256              # points compared with the float64 CPU reference
N_GRAD = 64              # points of the excursion-set value_and_grad
TOL_XI = 2e-5            # f32 round-off over ~150k-point spline sums
# the chi2 and lnL tolerance applies to |d| / max(1, |reference| / 100): f32
# keeps ~7 significant digits, so a chi2 in the thousands (the
# euclid_special golden reads 4880) is held to the same relative accuracy
# as one of ~100. A matmul that lost its precision pin moves chi2 by ~1.
TOL_CHI2 = 5e-3          # f32 on the card vs float64, same modes
# the excursion-set pipeline (k-integrals, finite-difference s0 derivative)
# loses more to f32 round-off: 3.7e-3 against float64 on the CPU in f32
TOL_CHI2_ESM = 1e-2
TOL_GRAD = 1e-2          # |d grad| / max |grad|, f32 vs float64
LOGZ_QUADRATURE = 278.967    # tools/validate_posterior.py, BOSS config
TOL_LOGZ = 0.5
SMC_MOVES = '8'          # the calibrated recipe (BASELINE.md); at the CLI's
                         # default 5 moves seed 0 reads 0.45 above quadrature
SHARD_RTOL, SHARD_ATOL = 1e-4, 1e-3

BOSS_NAMES = ('fsigma8', 'beta', 'sigma_v', 'epsilon')
ESM_NAMES = ('f', 'sigma_8_0', 'b10', 'b01', 'Rp', 'Rx', 'beta', 'sigma_v',
             'epsilon')
EXACT = {'streaming_eval': 'exact', 'dispersion_final': 'exact',
         'beta_covariance': 'exact'}
GOLDEN = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}
MODELS = ('streaming', 'dispersion', 'kaiser', 'euclid_special', 'esm')


def config(name: str) -> dict:
    """A JSON twin config with its data paths anchored at the repo."""
    cfg = load_config(os.path.join(REPO, 'configs', name + '.json'))
    cfg['model']['dir'] = REPO
    cfg['data']['dir'] = REPO
    return cfg


def bundle_for(model: str):
    if model == 'esm':
        cfg = config('esm_sampling_config')
    else:
        cfg = config('boss_config')
        cfg['model']['rsd_model'] = model
    return build_tables(cfg['model'], cfg['data'])


def points(model: str, n: int, seed: int = 0) -> np.ndarray:
    """Parameter points around the posterior, as float32 values so the GPU
    and the float64 reference evaluate exactly the same points. Drawn row
    by row, so the first rows do not depend on `n`."""
    rng = np.random.default_rng(seed)
    if model == 'esm':
        cols = [(0.6, 0.9), (0.7, 0.9), (-1.8, -1.2), (-5.0, -3.5),
                (7.0, 9.0), (0.4, 0.55), (0.3, 0.5), (300.0, 450.0),
                (0.95, 1.05)]
    else:
        cols = [(0.3, 0.6), (0.25, 0.55), (250.0, 450.0), (0.9, 1.1)]
    lo, hi = np.asarray(cols).T
    return rng.uniform(lo, hi, size=(n, len(cols))).astype(np.float32)


def names_for(model: str):
    return ESM_NAMES if model == 'esm' else BOSS_NAMES


def esm_value_and_grad(bundle, theta):
    """(lnL, d lnL / d theta) per point: the AD path HMC and MAP take."""
    fn = make_loglike(bundle, ESM_NAMES, jit=False).func
    vg = jax.vmap(jax.value_and_grad(lambda tbl, th_: fn(tbl, th_)[0],
                                     argnums=1), in_axes=(None, 0))
    return jax.jit(vg)(bundle.tables, jnp.asarray(theta))


def cpu_reference(out_path: str) -> None:
    """float64 values at the first N_REF points of each model under the
    default 'auto' modes (and, for streaming, explicit 'exact'), and the
    excursion-set gradient at N_GRAD points, written to `out_path`.
    Runs in a child process whose JAX sees only the CPU."""
    if jax.default_backend() != 'cpu' or not jax.config.jax_enable_x64:
        raise RuntimeError('the reference runs on the CPU in float64')
    out = {}
    for model in MODELS:
        bundle = bundle_for(model)
        theta = jnp.asarray(points(model, N_REF), dtype=jnp.float64)
        for mode in ('auto', 'exact') if model == 'streaming' else ('auto',):
            fn = make_batched_loglike(
                bundle, names_for(model), chunk=CHUNK,
                opts_kw=EXACT if mode == 'exact' else None)
            lnl, chi2 = fn(theta)
            out[f'{model}_{mode}_lnl'], out[f'{model}_{mode}_chi2'] = lnl, chi2
        if model == 'esm':
            val, grad = esm_value_and_grad(
                bundle, jnp.asarray(points(model, N_GRAD), jnp.float64))
            out['esm_grad_value'], out['esm_grad'] = val, grad
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


FAILED = []   # phases whose checks failed; main() exits non-zero on any


class Phase:
    """Collects (name, value, tolerance) checks; `done` prints the phase's
    line and records the phase as failed if a value is not finite or
    exceeds its tolerance. Later phases still run, so one call shows every
    failure; an exception still stops the script at once."""

    def __init__(self, name: str):
        self.name, self.checks, self.info = name, [], {}
        self.t0 = time.perf_counter()

    def check(self, key: str, value, tol: float) -> None:
        self.checks.append((key, float(value), tol))

    def done(self) -> None:
        fields = [f'{k}={v:.3g} (tol {t:g})' for k, v, t in self.checks]
        fields += [f'{k}={v}' for k, v in self.info.items()]
        fields.append(f'{time.perf_counter() - self.t0:.1f}s')
        bad = [k for k, v, t in self.checks if not (np.isfinite(v) and v <= t)]
        if bad:
            fields.append(f'FAILED: {", ".join(bad)}')
            FAILED.append(self.name)
        print(f'phase {self.name}: ' + '; '.join(fields), flush=True)


def max_abs(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape or not np.all(np.isfinite(a)):
        return float('inf')
    return float(np.max(np.abs(a - b)))


def max_scaled(a, ref) -> float:
    """max |a - ref| / max(1, |ref| / 100), the chi2/lnL deviation."""
    ref = np.asarray(ref, np.float64)
    return max_abs(np.asarray(a, np.float64) / np.maximum(1, np.abs(ref) / 100),
                   ref / np.maximum(1, np.abs(ref) / 100))


def phase_device(expect_count: int) -> dict:
    device = require_gpu()
    ph = Phase('device')
    ph.info.update(jax=jax.__version__, kind=repr(device['kind']),
                   count=device['count'])
    ph.done()
    print(f'nvidia-smi: {card_name_and_power_limit()}', flush=True)
    if device['count'] != expect_count:
        sys.exit(f"expected {expect_count} GPUs, found {device['count']}")
    return device


def phase_exact_theory() -> None:
    """The direct (unbatched) exact path against upstream victor."""
    ph = Phase('exact_theory')
    bundle = bundle_for('streaming')
    ref = np.load(os.path.join(REPO, 'tests', 'fixtures', 'reference_boss.npz'))
    tables, spec = bundle.tables, bundle.spec
    opts0, fit0 = bundle.theory_opts, bundle.fit_opts
    xi_fn = jax.jit(lambda tbl, opts, p: th.theory_xi_grid(tbl, spec, opts, p),
                    static_argnums=1)
    ll_fn = jax.jit(lambda tbl, opts, fit, p: lk.log_likelihood(
        tbl, spec, opts, fit, p), static_argnums=(1, 2))

    def jp(p):
        return {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}

    dxi = 0.0
    for key, kw in (('xi_smu', {}),
                    ('xi_smu_dispersion', {'rsd_model': 'dispersion',
                                           'dispersion_interior': 'exact'}),
                    ('xi_smu_kaiser', {'rsd_model': 'kaiser'}),
                    ('xi_smu_euclid', {'rsd_model': 'euclid_special'}),
                    ('xi_smu_aniso', {'assume_isotropic': False})):
        xi = xi_fn(tables, opts0.replace(**kw), jp(GOLDEN))
        dxi = max(dxi, max_abs(xi, ref[key]))
    ph.check('max|dxi|', dxi, TOL_XI)

    cases = {  # fixture key -> (theory options, fit options, extra params)
        'streaming': ({}, {}, {}),
        'dispersion': ({'rsd_model': 'dispersion',
                        'dispersion_interior': 'exact'}, {}, {}),
        'kaiser': ({'rsd_model': 'kaiser'}, {}, {}),
        'streaming_aniso': ({'assume_isotropic': False}, {}, {}),
        'beta_interp_likelihood': ({}, {'beta_interpolation': 'likelihood'},
                                   {}),
        'golden_euclid': ({'rsd_model': 'euclid_special'}, {}, {}),
        'golden_kaiser_MQ': ({'rsd_model': 'kaiser'}, {},
                             {'M': 1.1, 'Q': 0.9}),
        'golden_kaiser_approx': ({'rsd_model': 'kaiser',
                                  'kaiser_approximation': True}, {}, {}),
        'golden_kaiser_noshift': ({'rsd_model': 'kaiser',
                                   'kaiser_coord_shift': False}, {}, {}),
        'golden_form_gaussian': ({}, {'form': 'gaussian'}, {}),
        'golden_form_hartlap': ({}, {'form': 'hartlap'}, {}),
        'golden_form_percival': ({}, {'form': 'percival'}, {}),
        'golden_empirical_corr': ({'empirical_corr': True}, {}, {'Av': 0.5}),
    }
    golden_names = [str(x) for x in ref['golden_names']]
    dchi2 = dlnl = 0.0
    for key, (okw, fkw, extra) in cases.items():
        if key in golden_names:
            i = golden_names.index(key)
            want_chi2, want_lnl = ref['golden_chi2'][i], ref['golden_lnl'][i]
        else:
            want_chi2, want_lnl = ref[key]
        lnl, chi2 = ll_fn(tables, opts0.replace(**okw), fit0.replace(**fkw),
                          jp({**GOLDEN, **extra}))
        dchi2 = max(dchi2, max_scaled(chi2, want_chi2))
        dlnl = max(dlnl, max_scaled(lnl, want_lnl))
    for row, want_chi2, want_lnl in zip(ref['grid_params'], ref['grid_chi2'],
                                        ref['grid_lnl']):
        lnl, chi2 = ll_fn(tables, opts0, fit0, jp(dict(zip(BOSS_NAMES, row))))
        dchi2 = max(dchi2, max_scaled(chi2, want_chi2))
        dlnl = max(dlnl, max_scaled(lnl, want_lnl))
    ph.check('dchi2', dchi2, TOL_CHI2)
    ph.check('dlnL', dlnl, TOL_CHI2)
    ph.info['goldens'] = len(cases) + len(ref['grid_chi2'])
    ph.done()


def compile_batched(bundle, names, theta, opts_kw=None):
    """make_batched_loglike compiled ahead of time: (compiled, tables,
    compile seconds)."""
    raw = make_batched_loglike(bundle, names, opts_kw=opts_kw, chunk=CHUNK,
                               jit=False)
    t0 = time.perf_counter()
    compiled = jax.jit(raw.func).lower(raw.args[0], theta).compile()
    return compiled, raw.args[0], time.perf_counter() - t0


def memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    return json.dumps({k[:-len('_size_in_bytes')]: getattr(m, k)
                       for k in dir(m) if k.endswith('_size_in_bytes')})


def run_batched(ph, model, mode, bundle, ref):
    """One batched graph at N_BATCH points against the float64 reference
    of the same modes; returns chi2 at the reference points."""
    theta = jnp.asarray(points(model, N_BATCH))
    compiled, tables, t_compile = compile_batched(
        bundle, names_for(model), theta, EXACT if mode == 'exact' else None)
    lnl, chi2 = jax.block_until_ready(compiled(tables, theta))
    lnl, chi2 = np.asarray(lnl), np.asarray(chi2)
    if lnl.shape != (N_BATCH,) or chi2.shape != (N_BATCH,):
        raise AssertionError(f'{model}.{mode}: shapes {lnl.shape} {chi2.shape}')
    bad = np.flatnonzero(~(np.isfinite(lnl) & np.isfinite(chi2)))
    ph.check(f'{model}.{mode}.non_finite', len(bad), 0)
    if len(bad):
        print(f'{model}.{mode}: non-finite rows {bad[:5].tolist()} theta '
              f'{np.asarray(theta)[bad[:5]].tolist()}', flush=True)
    for name, got in (('chi2', chi2), ('lnl', lnl)):
        ph.check(f'{model}.{mode}.d{name}',
                 max_scaled(got[:N_REF], ref[f'{model}_{mode}_{name}']),
                 TOL_CHI2_ESM if model == 'esm' else TOL_CHI2)
    ph.info[f'{model}.{mode}.compile_s'] = f'{t_compile:.1f}'
    print(f'memory_analysis {model}.{mode}: {memory_line(compiled)}',
          flush=True)
    return chi2[:N_REF]


def phase_batched(ref) -> None:
    ph = Phase('batched')
    bundle = bundle_for('streaming')
    chi2_auto = run_batched(ph, 'streaming', 'auto', bundle, ref)
    run_batched(ph, 'streaming', 'exact', bundle, ref)
    # the size of the fast modes' approximation, for the record
    ph.info['auto_vs_exact.max|dchi2|'] = (
        f"{max_abs(chi2_auto, ref['streaming_exact_chi2']):.3g} (float64: "
        f"{max_abs(ref['streaming_auto_chi2'], ref['streaming_exact_chi2']):.3g})")
    ph.done()


def phase_rsd_esm(ref) -> None:
    ph = Phase('rsd_esm')
    for model in ('dispersion', 'kaiser', 'euclid_special', 'esm'):
        run_batched(ph, model, 'auto', bundle_for(model), ref)
    bundle = bundle_for('esm')
    val, grad = esm_value_and_grad(bundle, points('esm', N_GRAD))
    ph.check('esm_grad.dlnL', max_scaled(val, ref['esm_grad_value']),
             TOL_CHI2_ESM)
    scale = np.max(np.abs(ref['esm_grad']), axis=1, keepdims=True)
    ph.check('esm_grad.max|dgrad|/max|grad|',
             max_abs(np.asarray(grad) / scale, ref['esm_grad'] / scale),
             TOL_GRAD)
    ph.done()


def run_cli(argv) -> dict:
    """`python -m victor_tpu <argv>` in this process; its JSON report."""
    from victor_tpu.__main__ import main as cli_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(list(argv))
    return json.loads(buf.getvalue())


def sampling_config(tmp: str, sampler: dict) -> str:
    cfg = config('boss_sampling_config')
    cfg['sampler'] = sampler
    path = os.path.join(tmp, 'run.json')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    return path


def chains_ok(root: str) -> int:
    """Rows of the GetDist chains under `root`; raises if any is not
    finite or the files do not parse."""
    from victor_tpu.sampling.chains import read_getdist
    names, weights, minus_lnpost, samples = read_getdist(root)
    if not (len(samples) and np.all(np.isfinite(samples))
            and np.all(np.isfinite(minus_lnpost))):
        raise AssertionError(f'{root}: empty or non-finite chains')
    return len(samples)


def phase_samplers(n_particles: int = 4096) -> None:
    ph = Phase('samplers')
    with tempfile.TemporaryDirectory() as tmp:
        cfg = sampling_config(tmp, {'kind': 'mh', 'n_chains': 8,
                                    'n_warmup': 200, 'n_samples': 300,
                                    'segment_steps': 100, 'seed': 0})
        t0 = time.perf_counter()
        out = run_cli(['run', cfg, '--output', os.path.join(tmp, 'mh')])
        ph.info['mh'] = (f"{chains_ok(os.path.join(tmp, 'mh'))} rows, "
                         f"acceptance {out['acceptance']}, "
                         f'{time.perf_counter() - t0:.1f}s')

        cfg = sampling_config(tmp, {'n_chains': 8, 'segment_steps': 10,
                                    'seed': 0})
        t0 = time.perf_counter()
        out = run_cli(['run', cfg, '--sampler', 'hmc', '--warmup', '20',
                       '--samples', '20', '--output',
                       os.path.join(tmp, 'hmc')])
        ph.info['hmc'] = (f"{chains_ok(os.path.join(tmp, 'hmc'))} rows, "
                          f"acceptance {out['acceptance']}, "
                          f'{time.perf_counter() - t0:.1f}s')

        t0 = time.perf_counter()
        out = run_cli(['run', cfg, '--sampler', 'smc', '--particles',
                       str(n_particles), '--moves', SMC_MOVES,
                       '--output', os.path.join(tmp, 'smc')])
        chains_ok(os.path.join(tmp, 'smc'))
        ph.check('smc.|logZ-quadrature|',
                 abs(out['log_evidence'] - LOGZ_QUADRATURE), TOL_LOGZ)
        ph.info['smc'] = (f"logZ {out['log_evidence']} "
                          f"+/- {out['log_evidence_se']}, "
                          f"{out['n_stages']} stages, "
                          f'{time.perf_counter() - t0:.1f}s')
    ph.done()


def phase_sharded(n_devices: int, n_particles: int = 4096) -> None:
    """The mesh path over every card against its unsharded run."""
    from victor_tpu.likelihood.batched import make_sharded_loglike
    from victor_tpu.parallel import make_mesh
    from victor_tpu.sampling import run_hmc_mcmc, run_smc

    ph = Phase('sharded')
    bundle = bundle_for('streaming')
    mesh = make_mesh(('batch',))
    theta = jnp.asarray(points('streaming', N_BATCH))
    lnl_un = np.asarray(make_batched_loglike(bundle, BOSS_NAMES,
                                             chunk=CHUNK)(theta)[0])
    sharded = make_sharded_loglike(bundle, BOSS_NAMES, mesh, axis='batch')
    step = CHUNK * n_devices     # each card evaluates one chunk per call
    lnl_sh = np.concatenate([np.asarray(sharded(theta[i:i + step])[0])
                             for i in range(0, N_BATCH, step)])
    ph.check('likelihood.max|dlnL|-rtol*|lnL|',
             np.max(np.abs(lnl_sh - lnl_un) - SHARD_RTOL * np.abs(lnl_un)),
             SHARD_ATOL)

    # SMC's resampling and adaptive ladder make discrete choices, so f32
    # rounding that differs between the 4-device and the 1-device program
    # can send the two runs down different particle histories: they are
    # compared as estimators, within their own statistical error
    block = config('boss_sampling_config')['params']
    smc = {}
    for tag, m in (('sharded', make_mesh(('particles',))), ('unsharded', None)):
        smc[tag] = run_smc(bundle, block, n_particles=n_particles,
                           n_moves=int(SMC_MOVES), seed=0, mesh=m)
    sh, un = smc['sharded'], smc['unsharded']
    ph.check('smc.|dlogZ|/se', abs(sh.logz - un.logz)
             / np.hypot(sh.logz_se, un.logz_se), 2.0)
    ph.check('smc.max|dmean|/std', np.max(
        np.abs(sh.particles.mean(0) - un.particles.mean(0))
        / un.particles.std(0)), 0.2)

    # two warmup and two sampling transitions: short enough that rounding
    # differences cannot flip an accept decision and send a chain elsewhere
    hmc = {}
    for tag, m in (('sharded', make_mesh(('chains',))), ('unsharded', None)):
        hmc[tag] = run_hmc_mcmc(bundle, block, n_chains=8, n_warmup=2,
                                n_samples=2, n_leapfrog=8, seed=0, mesh=m)
    ph.check('hmc.max|dchain|-rtol*|chain|', np.max(
        np.abs(hmc['sharded'].chain - hmc['unsharded'].chain)
        - SHARD_RTOL * np.abs(hmc['unsharded'].chain)), SHARD_ATOL)

    with tempfile.TemporaryDirectory() as tmp:
        cfg = sampling_config(tmp, {'seed': 0})
        out = run_cli(['run', cfg, '--sampler', 'smc', '--particles',
                       str(n_particles), '--moves', SMC_MOVES])
    ph.check('cli_smc.|logZ-quadrature|',
             abs(out['log_evidence'] - LOGZ_QUADRATURE), TOL_LOGZ)
    ph.info['cli_smc'] = f"logZ {out['log_evidence']}"
    ph.done()


def start_cpu_reference(tmp: str):
    """Start the float64 CPU reference child; returns (process, out path)."""
    out = os.path.join(tmp, 'cpu_reference.npz')
    env = {**os.environ, 'JAX_PLATFORMS': 'cpu', 'JAX_ENABLE_X64': '1'}
    proc = subprocess.Popen(
        [sys.executable, '-c',
         f'import chip_smoke; chip_smoke.cpu_reference({out!r})'],
        cwd=REPO, env=env)
    return proc, out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--devices', type=int, choices=(1, 4), default=1,
                        help='4: run only the sharded path, on four GPUs')
    args = parser.parse_args()

    device = phase_device(args.devices)
    from victor_tpu.utils.profiling import enable_persistent_cache
    enable_persistent_cache()
    if args.devices > 1:
        phase_sharded(args.devices)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            proc, ref_path = start_cpu_reference(tmp)
            try:
                phase_exact_theory()
                if proc.wait(timeout=900) != 0:
                    raise RuntimeError('float64 CPU reference failed')
                ref = dict(np.load(ref_path))
                phase_batched(ref)
                phase_rsd_esm(ref)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        phase_samplers()
    if FAILED:
        sys.exit(f'failed phases: {", ".join(FAILED)}')
    print(json.dumps({'ok': True, 'device': device}), flush=True)


if __name__ == '__main__':
    main()
