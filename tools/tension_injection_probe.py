#!/usr/bin/env python
"""Injected-shift validation of the tension pipeline on the BOSS machinery.

The `tension` statistics are validated in closed form on two-Gaussian
targets (tests/test_tension.py) and demonstrated on BOSS-vs-itself
(concordance, BASELINE.md). This probe closes the remaining question — does
the pipeline FLAG a real discordance through the full CCF likelihood? — by
manufacturing two noiseless datasets from the shipped BOSS tables:

  A: data vector = theory at the fiducial {fsigma8 .47, beta .37, sv 380,
     eps 1.0}
  B: the same with fsigma8 shifted by `--nsigma` posterior sigmas
     (sigma(fsigma8) = 0.054, grid-quadrature truth)

and running the full three-evidence pipeline (run_tension) on each of
--nsigma 0 (control: must report concordance, ln R > 0, shift ~ 0) and the
injected value (must report ln R < 0 and a parameter shift close to
nsigma/sqrt(2) — both clouds carry the same sigma, so the Gaussian shift
statistic sees Delta / sqrt(2) per direction).

The two statistics differ by design in WHEN they fire (measured, 2026-08-19):
the shift statistic reads an injected Delta immediately (4-sigma injection
-> 2.87 sigma reported vs 2.83 expected), while ln R must first overcome
the concordance prior-volume bonus (the control's +8.7 here, from four
wide prior directions): the measured evidence penalty is Delta^2/2 in
sigma units (the product posterior sits at the compromise point, each
dataset paying (Delta/2)^2 twice), so ln R crosses zero only near
Delta ~ sqrt(2 ln R_control) ~ 4.2 sigma. This prior-volume dependence is
the documented property of evidence ratios (sampling/tension.py docstring)
— hence the 6-sigma default, where both statistics must read tension.

Run alone on the accelerator:  python tools/tension_injection_probe.py [--nsigma 6]
Prints one JSON line per case; exits non-zero if the control fails to read
concordance or the injection fails to read tension.
"""

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tools'))

SIGMA_FSIGMA8 = 0.054       # grid-quadrature posterior sigma (BASELINE.md)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--nsigma', type=float, default=6.0,
                    help='injected fsigma8 shift in posterior sigmas '
                         '(>~ 4.2 for ln R to cross zero — see docstring)')
    ap.add_argument('--particles', type=int, default=4096)
    ap.add_argument('--moves', type=int, default=8)
    args = ap.parse_args()

    import jax.numpy as jnp
    import yaml

    from coverage_test import PARAMS_BLOCK, _mock_setup, shift_datavector
    from victor_tpu.io import build_tables
    from victor_tpu.models.ccf_theory import theory_vector
    from victor_tpu.sampling.tension import run_tension
    from victor_tpu.utils.profiling import enable_persistent_cache
    enable_persistent_cache()

    with open(os.path.join(REPO, 'configs', 'boss_config.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['model']['dir'] = REPO
    cfg['data']['dir'] = REPO
    bundle = build_tables(cfg['model'], cfg['data'])

    fid = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}
    tvec, dvec, _ = _mock_setup(bundle, fid)
    bundle_a = shift_datavector(bundle, np.asarray(tvec - dvec))

    failures = 0
    for case, ns in (('control', 0.0), ('injected', args.nsigma)):
        fid_b = dict(fid)
        fid_b['fsigma8'] = fid['fsigma8'] + ns * SIGMA_FSIGMA8
        tvec_b = theory_vector(bundle.tables, bundle.spec,
                               bundle.theory_opts,
                               {k: jnp.asarray(v) for k, v in fid_b.items()})
        bundle_b = shift_datavector(bundle, np.asarray(tvec_b) - dvec)

        res = run_tension(bundle_a, bundle_b, PARAMS_BLOCK,
                          n_particles=args.particles, n_moves=args.moves)
        if case == 'control':
            ok = res.logr > 0 and res.shift_nsigma < 2.0
            expect = 'ln R > 0, shift < 2 sigma'
        else:
            # both posteriors carry ~the same sigma, so the Gaussian shift
            # statistic sees Delta/sqrt(2); allow generous SMC noise
            ok = res.logr < 0 and \
                abs(res.shift_nsigma - ns / np.sqrt(2.0)) < 1.0
            expect = f'ln R < 0, shift ~ {ns / np.sqrt(2.0):.2f} sigma'
        failures += 0 if ok else 1
        print(json.dumps({
            'case': case, 'injected_nsigma': ns, 'ok': bool(ok),
            'expect': expect,
            'ln_R': round(res.logr, 3), 'ln_R_se': round(res.logr_se, 3),
            'verdict': 'concordance' if res.logr > 0 else 'tension',
            'shift_nsigma': round(res.shift_nsigma, 3),
            'shift_p': round(res.shift_p, 6),
            'logz': {'a': round(res.logz_a, 3), 'b': round(res.logz_b, 3),
                     'ab': round(res.logz_ab, 3)},
            'elapsed_s': round(res.elapsed_s, 1),
        }), flush=True)

    sys.exit(1 if failures else 0)


if __name__ == '__main__':
    main()
