#!/usr/bin/env python
"""Posterior-level validation of the opt-in fast evaluation modes.

Two opt-in throughput modes approximate exact spline passes with Chebyshev
compressions (BASELINE.md anatomy):

  --model dispersion  (default) validates `dispersion_final='fast'`: the
      jacobian reuses the final Picard update's exact v_r and uses a
      degree-48 Chebyshev dv_r. Pointwise bounds: xi <= 2e-5 abs,
      chi2 ~2e-3 (tests/test_golden.py).
  --model streaming  validates `streaming_eval='fast'`: degree-48 Chebyshev
      compressions of v_r and the mu-independent sigma_v template inside
      the velocity-pdf convolution. Pointwise bounds: xi <= 3e-5 abs,
      chi2 ~1.3e-2 (the pdf mean/width are more sensitive than the
      dispersion jacobian, hence the looser chi2).
  --model esm  validates `streaming_eval='fast'` composed with the
      excursion-set matter model (the 9-parameter pipeline,
      configs/esm_sampling_config.yaml): v_r comes from the ESM profile
      instead of the template, so the compression is re-validated on the
      posterior it actually runs in.

Pointwise bounds say the modes are accurate; the operative question for a
sampler-facing speed mode is whether the BOSS POSTERIOR moves. This runs
tempered SMC under exact vs fast (same seed) and compares moments + logZ.

Sampler choice: tempered SMC, not HMC. The posterior's beta direction has
likelihood structure at the data beta-grid scale (the same property
documented for the template model, tools/coverage_test.py), which leaves
straggler HMC chains with R-1 ~ 0.1-0.4 at any practical schedule —
measured 3 attempts, 8-16 chains x 2100 steps; the moment comparison was
dominated by unconverged-chain noise. SMC's population tempering handles
that structure, estimates the same moments from 4096 particles, and also
compares the log-evidence. (Side observation from the HMC attempts, same
seed and schedule: dispersion fast mode ran the full chain 3.3x faster
than exact — removing two masksum passes removes their reverse-mode
transposes too.)

Acceptance: per-parameter |Δmean| < 0.1 sigma, |Δsigma|/sigma < 10%, and
|ΔlogZ| < 2 x the combined (inflated) se.

Run alone on the accelerator:  python tools/validate_dispersion_fast.py
                       python tools/validate_dispersion_fast.py --model streaming
"""

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

OPTS = {
    'dispersion': lambda mode: {'rsd_model': 'dispersion',
                                'dispersion_final': mode},
    'streaming': lambda mode: {'rsd_model': 'streaming',
                               'streaming_eval': mode},
    # streaming fast mode composed with the excursion-set matter model
    # (the 9-parameter ESM pipeline; v_r comes from the ESM profile instead
    # of the template, so the Chebyshev compression is re-validated on it)
    'esm': lambda mode: {'streaming_eval': mode},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--model', default='dispersion', choices=sorted(OPTS))
    ap.add_argument('--seeds', type=int, default=1,
                    help='SMC seed replicates per mode; moments/logZ are '
                         'seed-averaged before comparison. 1 suffices for '
                         'the 4-param template posteriors; the 9-param ESM '
                         'posterior mixes slower (late-stage mutation '
                         'acceptance ~0.06), so single-seed moment noise is '
                         '~0.05 sigma and the 0.1-sigma acceptance needs '
                         '--seeds 3')
    args = ap.parse_args()

    import yaml
    from victor_tpu.io import build_tables
    from victor_tpu.sampling import run_smc
    from victor_tpu.utils.profiling import enable_persistent_cache
    enable_persistent_cache()

    if args.model == 'esm':
        # the 9-parameter excursion-set pipeline carries its own config
        # (streaming RSD + excursion_set matter model) and params block
        with open(os.path.join(REPO, 'configs',
                               'esm_sampling_config.yaml')) as f:
            ecfg = yaml.safe_load(f)
        ecfg['model']['dir'] = REPO
        ecfg['data']['dir'] = REPO
        cfg, block = ecfg, ecfg['params']
    else:
        with open(os.path.join(REPO, 'configs', 'boss_config.yaml')) as f:
            cfg = yaml.safe_load(f)
        cfg['model']['dir'] = REPO
        cfg['data']['dir'] = REPO
        with open(os.path.join(REPO, 'configs',
                               'boss_sampling_config.yaml')) as f:
            block = yaml.safe_load(f)['params']
    bundle = build_tables(cfg['model'], cfg['data'])

    runs = {}        # mode -> {'summaries': [per-seed], 'logz': [...]}
    for mode in ('exact', 'fast'):
        summaries, logzs, logz_ses = [], [], []
        for seed in range(args.seeds):
            res = run_smc(
                bundle, block, n_particles=4096, n_moves=8, seed=seed,
                opts_kw=OPTS[args.model](mode))
            summaries.append(res.summary())
            logzs.append(res.logz)
            logz_ses.append(res.logz_se)
            print(json.dumps({
                'model': args.model, 'mode': mode, 'seed': seed,
                'n_stages': len(res.betas) - 1,
                'logz': round(res.logz, 3), 'logz_se': round(res.logz_se, 3),
                'elapsed_s': round(res.elapsed_s, 1),
                'summary': {k: {'mean': round(v['mean'], 5),
                                'std': round(v['std'], 5)}
                            for k, v in res.summary().items()},
            }), flush=True)
        runs[mode] = {'summaries': summaries,
                      'logz': float(np.mean(logzs)),
                      # se of the seed-averaged logZ: the larger of the
                      # propagated per-run bar and the observed scatter
                      'logz_se': float(max(
                          np.hypot.reduce(logz_ses) / args.seeds,
                          (np.std(logzs, ddof=1) / np.sqrt(args.seeds))
                          if args.seeds > 1 else 0.0))}

    def seed_avg(mode):
        names = runs[mode]['summaries'][0].keys()
        return {n: {'mean': float(np.mean([s[n]['mean'] for s in
                                           runs[mode]['summaries']])),
                    'std': float(np.mean([s[n]['std'] for s in
                                          runs[mode]['summaries']]))}
                for n in names}

    ok = True
    report = {}
    se, sf = seed_avg('exact'), seed_avg('fast')
    for name in se:
        dm = abs(sf[name]['mean'] - se[name]['mean']) / se[name]['std']
        ds = abs(sf[name]['std'] - se[name]['std']) / se[name]['std']
        report[name] = {'dmean_over_sigma': round(dm, 4),
                        'dsigma_rel': round(ds, 4)}
        ok &= (dm < 0.1) and (ds < 0.1)
    dlz = abs(runs['fast']['logz'] - runs['exact']['logz'])
    selz = float(np.hypot(runs['fast']['logz_se'], runs['exact']['logz_se']))
    report['logZ'] = {'delta': round(dlz, 3), 'combined_se': round(selz, 3)}
    ok &= dlz < 2 * selz
    print(json.dumps({'check': f'{args.model}_fast_posterior_parity',
                      'ok': bool(ok), 'seeds': args.seeds,
                      'shifts': report}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == '__main__':
    main()
