#!/usr/bin/env python
"""Parameter-recovery (coverage) validation with synthetic data.

Draws N mock data vectors d_k = t(theta_fid) + L xi_k (L = Cholesky factor
of the covariance at the fiducial beta), refits every mock with the MAP +
Laplace machinery, and checks that the pulls (theta_hat - theta_fid)/sigma
are standard normal and that the nominal 68% intervals cover at the nominal
rate — an end-to-end statistical calibration test of the likelihood,
optimizer, and error bars together (the reference has no analogue; mock
validation there is manual).

All mocks share one compiled fit: the mock enters through the data-vector
tables, which ride as jit arguments, so fit k >= 2 costs no compile.

Measured on the BOSS config (200 mocks, gaussian form; BASELINE.md
statistical results): fsigma8 / sigma_v / epsilon pulls
are standard normal (std 1.04 / 1.00 / 0.97, |pull|<1 at 68/64/70%).
sigma_v shows a genuine -0.22 +/- 0.07 sigma mean pull: the classic
width-parameter MLE bias (sigma_v sets the velocity-pdf width; width MLEs
bias low, cf. 1/N vs 1/(N-1)) — shared by any maximum-likelihood analysis
of this likelihood, including the reference's. The reconstruction
parameter beta is the exception BY CONSTRUCTION: its information comes
from the data template's finite beta grid, whose spacing (~0.01) is
comparable to sigma(beta) (~0.007), so the per-mock beta likelihood has
grid-scale structure, the minimum hops between wiggles under noise, and
the quadratic Laplace sigma understates the mock-to-mock scatter (pull
std 2.86, heavy-tailed). Local delta-chi2=1 profile intervals do NOT fix
it (56.0 +/- 3.3% coverage at 200 mocks, itself an upper bound — window-
truncated sides count as covering; they follow the same wiggles).
The marginal posterior DOES: --method smc (100 mocks seed 0 + 200 mocks
seed 100, 2026-08-17) measures nominal central-68% coverage for every
parameter (200-mock: 70/70/67/64%, binomial sigma 3.3%; beta
posterior-mean pull std 1.0-1.15 vs 2.86 Laplace) — report credible
intervals from the samplers, not the Laplace sigma, for beta. The same
holds through the 9-param ESM pipeline (--model esm --method smc:
constrained directions nominal, prior-pinned shape nuisances shrink
toward the prior and overcover — BASELINE.md round 3). The strictest
check, --method sbc (100 prior-drawn truths, 2026-08-17), PASSES: every
marginal's posterior ranks are uniform (KS p 0.25-0.67) — the whole
prior/simulator/likelihood/sampler chain is self-consistent.

Usage:  python tools/coverage_test.py [--mocks 100] [--form gaussian]
        python tools/coverage_test.py --mocks 200 --beta-profile
                    # --beta-profile turns the advice above into machinery:
                    # per-mock delta-chi2=1 profile intervals for beta
                    # (profile_scan, 25 points over +/-4 sigma) and their
                    # measured coverage, alongside the Laplace pulls
        python tools/coverage_test.py --method smc --mocks 60
                    # calibrate the RECOMMENDED reporting path: per-mock
                    # tempered-SMC posteriors, central 68% credible-interval
                    # coverage and posterior-mean pulls (the marginal
                    # posterior integrates over beta's grid-scale wiggles
                    # that break both Laplace and profile intervals)
        python tools/coverage_test.py --method sbc --mocks 100
                    # simulation-based calibration (Talts et al. 2018):
                    # truths drawn FROM THE PRIOR, data simulated at each
                    # truth (covariance at its own beta), posterior sampled
                    # by SMC, fractional rank of the truth recorded —
                    # uniform ranks = the whole prior/simulator/likelihood/
                    # sampler chain is self-consistent
        python tools/coverage_test.py --model dispersion --method smc --mocks 50
                    # the same 4-param fit under the dispersion RSD mapping
                    # (exact final stage): SMC-posterior coverage measured
                    # nominal for every parameter, same sigma_v width-MLE
                    # skew as streaming (BASELINE.md round 3)
        python tools/coverage_test.py --model joint --method sbc --mocks 40
                    # 5-param 2-quantile JOINT fit: stacked data vectors,
                    # correlated cross-covariance (rho=0.4 off-diagonal
                    # blocks), shared cosmology/AP + per-quantile
                    # sigma_v__q<i> — rank-calibrates the multiquantile
                    # machinery end-to-end
        python tools/coverage_test.py --model esm --mocks 30
                    # 9-parameter excursion-set pipeline calibration:
                    # fiducial = the ESM MAP neighbourhood, params block
                    # from configs/esm_sampling_config.yaml. The ESM shape
                    # nuisances (b01, Rp, Rx) are honestly wide/degenerate
                    # (BASELINE.md) so their pulls are prior-influenced;
                    # the physics parameters (f, sigma_8_0, sigma_v,
                    # epsilon) are the calibration targets.
"""

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FIDUCIAL = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}

PARAMS_BLOCK = {
    'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.05}},
    'beta': {'prior': {'dist': 'uniform', 'min': 0.2, 'max': 0.6},
             'ref': {'dist': 'norm', 'loc': 0.37, 'scale': 0.03}},
    'sigma_v': {'prior': {'dist': 'uniform', 'min': 100.0, 'max': 500.0},
                'ref': {'dist': 'norm', 'loc': 380.0, 'scale': 30.0}},
    'epsilon': {'prior': {'dist': 'uniform', 'min': 0.8, 'max': 1.2},
                'ref': {'dist': 'norm', 'loc': 1.0, 'scale': 0.02}},
}


# one implementation for every mock consumer (this tool AND the
# parametric-bootstrap debiasing): victor_tpu.sampling.mocks
from victor_tpu.sampling.mocks import mock_setup as _mock_setup
from victor_tpu.sampling.mocks import shift_datavector


def run_coverage(bundle, n_mocks=100, seed=0, form='gaussian',
                 fiducial=FIDUCIAL, params_block=PARAMS_BLOCK,
                 n_starts=4, adam_steps=120, newton_steps=6,
                 beta_profile=False, debias=0):
    """Returns (pulls (n_mocks, ndim), hit68 fraction, names,
    beta_intervals) — beta_intervals is an (n_mocks, 2) array of per-mock
    delta-chi2=1 profile intervals for beta when beta_profile=True (the
    remedy for beta's grid-structure-broken Laplace sigma: the profile
    interval follows the actual likelihood wiggles), else None.

    `debias` > 0 applies the parametric-bootstrap correction
    (sampling/optimize.parametric_bootstrap, `debias` refits per mock):
    pulls use the debiased estimate over the bootstrap sigma — the
    calibration row behind `fit --bootstrap`."""
    from victor_tpu.sampling.optimize import (find_map,
                                              parametric_bootstrap,
                                              profile_scan)

    fit_kw = {'form': form}
    names = [n for n in params_block]
    tvec, dvec, L = _mock_setup(bundle, fiducial)

    rng = np.random.default_rng(seed)
    pulls = np.empty((n_mocks, len(names)))
    beta_iv = np.empty((n_mocks, 2)) if beta_profile else None
    for k in range(n_mocks):
        mock = tvec + L @ rng.standard_normal(len(tvec))
        # shift the stored data vector so that AT the fiducial beta it
        # equals the mock (the beta-dependence of the template is kept)
        mb = shift_datavector(bundle, mock - dvec)
        res = find_map(mb, params_block, n_starts=n_starts,
                       adam_steps=adam_steps, newton_steps=newton_steps,
                       seed=seed + k, fit_kw=fit_kw)
        if debias:
            bres = parametric_bootstrap(
                mb, params_block, res, n_boot=debias, n_starts=n_starts,
                adam_steps=adam_steps, newton_steps=newton_steps,
                seed=seed + 7919 * (k + 1), fit_kw=fit_kw)
            est, sd = bres.debiased, bres.std
        else:
            est, sd = res.params, res.std
        pulls[k] = [(est[n] - fiducial[n]) / max(sd[n], 1e-300)
                    for n in names]
        if beta_profile:
            # the machinery behind "use profile scans for beta": the
            # delta-chi2=1 interval follows the per-mock likelihood's
            # beta-grid-scale wiggles that the quadratic Laplace sigma
            # cannot (module docstring). 25 points over +/-4 Laplace
            # sigmas resolves the ~0.01 grid spacing ~4x.
            prof = profile_scan(mb, params_block, 'beta', n_grid=25,
                                n_sigma=4.0, seed=seed + k, fit_kw=fit_kw,
                                map_result=res)
            lo, hi = prof.interval(1.0)
            # a nan crossing = delta-chi2 never reaches 1 on that side
            # within the +/-4-Laplace-sigma scan window -> that side counts
            # as covering, so the printed profile coverage is an UPPER
            # bound; the truncated fraction is reported alongside it
            beta_iv[k] = [lo if np.isfinite(lo) else -np.inf,
                          hi if np.isfinite(hi) else np.inf]
    hit68 = float(np.mean(np.abs(pulls) < 1.0))
    return pulls, hit68, names, beta_iv


def _run_coverage_posterior(bundle, sample_fn, n_mocks, seed, fiducial,
                            params_block):
    """Shared posterior-coverage loop for the particle samplers.

    Mocks are drawn EXACTLY as in every other mode (one _mock_setup + one
    rng stream — the calibrations are only comparable if the mock draws and
    interval conventions are identical, which is why this loop exists
    once). `sample_fn(mock_bundle, mock_seed)` returns any result with
    `.space` and equal-weight `.particles`; central 68% credible intervals
    are equal-weight particle quantiles, pulls are posterior-mean pulls in
    posterior-std units.

    Returns (pulls (n_mocks, ndim), cover68 (ndim,), names)."""
    names = [n for n in params_block]
    fid = np.array([fiducial[n] for n in names])
    tvec, dvec, L = _mock_setup(bundle, fiducial)

    rng = np.random.default_rng(seed)
    pulls = np.empty((n_mocks, len(names)))
    hit = np.zeros((n_mocks, len(names)), dtype=bool)
    for k in range(n_mocks):
        mock = tvec + L @ rng.standard_normal(len(tvec))
        mb = shift_datavector(bundle, mock - dvec)
        res = sample_fn(mb, seed + k)
        order = [res.space.names.index(n) for n in names]
        p = res.particles[:, order]
        lo, hi = np.quantile(p, [0.1585, 0.8415], axis=0)
        hit[k] = (lo <= fid) & (fid <= hi)
        pulls[k] = (p.mean(axis=0) - fid) / p.std(axis=0)
    return pulls, hit.mean(axis=0), names


def run_coverage_smc(bundle, n_mocks=60, seed=0, form='gaussian',
                     fiducial=FIDUCIAL, params_block=PARAMS_BLOCK,
                     n_particles=2048, n_moves=6, chunk=64):
    """Coverage of the RECOMMENDED inference path: per-mock tempered-SMC
    posteriors, central 68% credible intervals (equal-weight particle
    quantiles), and posterior-mean pulls. This is the calibration of what
    the docs actually tell users to report — the marginal posterior —
    including for beta, whose grid-scale likelihood structure breaks both
    the Laplace sigma and the local delta-chi2=1 profile interval
    (marginalisation integrates over the wiggles).

    Returns (pulls (n_mocks, ndim) posterior-mean pulls in posterior-std
    units, cover68 (ndim,) per-parameter central-interval coverage, names).
    """
    from victor_tpu.sampling.smc import run_smc

    def sample(mb, mock_seed):
        return run_smc(mb, params_block, n_particles=n_particles,
                       n_moves=n_moves, seed=mock_seed,
                       fit_kw={'form': form}, chunk=chunk)
    return _run_coverage_posterior(bundle, sample, n_mocks, seed,
                                   fiducial, params_block)


def run_coverage_ns(bundle, n_mocks=50, seed=0, form='gaussian',
                    fiducial=FIDUCIAL, params_block=PARAMS_BLOCK,
                    n_live=512, n_steps=24, chunk=64, dlogz=0.01,
                    n_batch=None):
    """Coverage of the nested-sampling posterior path (run_nested): per-mock
    central 68% credible intervals from the equal-weight NS particles and
    posterior-mean pulls — the same calibration run_coverage_smc performs
    for SMC, for the methodologically independent estimator. Returns
    (pulls, cover68, names) with the same shapes/convention."""
    from victor_tpu.sampling.nested import run_nested

    def sample(mb, mock_seed):
        return run_nested(mb, params_block, n_live=n_live, n_steps=n_steps,
                          seed=mock_seed, fit_kw={'form': form}, chunk=chunk,
                          dlogz=dlogz, n_batch=n_batch)
    return _run_coverage_posterior(bundle, sample, n_mocks, seed,
                                   fiducial, params_block)


def run_coverage_mh(bundle, n_mocks=40, seed=0, form='gaussian',
                    fiducial=FIDUCIAL, params_block=PARAMS_BLOCK,
                    n_chains=8, n_warmup=500, n_samples=1500):
    """Coverage of the random-walk-Metropolis posterior path
    (run_hmc_mcmc(algorithm='mh') — the reference's cobaya sampler family):
    per-mock central 68% credible intervals from the pooled post-warmup
    draws, same mock stream and interval conventions as the SMC/NS runs.
    Completes the sampler calibration matrix for the MCMC-class posterior
    path. Returns (pulls, cover68, names)."""
    from victor_tpu.sampling import run_hmc_mcmc

    class _Particles:
        # adapt MCMCResult to the .space/.particles duck type the shared
        # loop consumes (pool chains x draws into equal-weight particles)
        def __init__(self, res):
            self.space = res.space
            self.particles = res.chain.reshape(-1, res.chain.shape[-1])

    def sample(mb, mock_seed):
        return _Particles(run_hmc_mcmc(
            mb, params_block, n_chains=n_chains, n_warmup=n_warmup,
            n_samples=n_samples, seed=mock_seed, algorithm='mh',
            segment_steps=n_warmup + n_samples, fit_kw={'form': form}))
    return _run_coverage_posterior(bundle, sample, n_mocks, seed,
                                   fiducial, params_block)


def run_coverage_ensemble(bundle, n_mocks=40, seed=0, form='gaussian',
                          fiducial=FIDUCIAL, params_block=PARAMS_BLOCK,
                          n_walkers=64, max_steps=3000, burn_frac=0.4):
    """Coverage of the ensemble-sampler posterior path (run_mcmc with the
    round-5 differential-evolution default move): per-mock central 68%
    credible intervals from the pooled post-burn-in walker draws, same mock
    stream and interval conventions as the SMC/NS/MH rows — the calibration
    row the round-4 verdict said the (then-stretch-move) ensemble sampler
    lacked. Returns (pulls, cover68, names)."""
    from victor_tpu.sampling import run_mcmc

    class _Particles:
        def __init__(self, res):
            self.space = res.space
            burn = int(len(res.chain) * burn_frac)
            self.particles = res.chain[burn:].reshape(
                -1, res.chain.shape[-1])

    def sample(mb, mock_seed):
        return _Particles(run_mcmc(
            mb, params_block, n_walkers=n_walkers, max_steps=max_steps,
            check_every=max_steps, rhat_stop=0.0, seed=mock_seed,
            fit_kw={'form': form}))
    return _run_coverage_posterior(bundle, sample, n_mocks, seed,
                                   fiducial, params_block)


# SBC parameter space: prior = generation distribution = the normals below
# (SBC requires them IDENTICAL; the usual wide-uniform sampling block would
# need generation draws from the full uniform, where beta leaves the data
# template grid). The scales are the posterior-typical region: SBC then
# validates the machinery exactly where it is used.
SBC_BLOCK = {
    'fsigma8': {'prior': {'dist': 'norm', 'loc': 0.47, 'scale': 0.05}},
    'beta': {'prior': {'dist': 'norm', 'loc': 0.37, 'scale': 0.03}},
    'sigma_v': {'prior': {'dist': 'norm', 'loc': 380.0, 'scale': 30.0}},
    'epsilon': {'prior': {'dist': 'norm', 'loc': 1.0, 'scale': 0.02}},
}


def run_sbc(bundle, n_mocks=100, seed=0, form='gaussian',
            params_block=None, n_particles=2048, n_moves=6, chunk=64):
    """Simulation-based calibration (Talts et al. 2018, arXiv:1804.06788):
    the full-Bayes self-consistency test. Per mock: draw theta_k from the
    prior, simulate d_k ~ N(t(theta_k), C(beta_k)), sample the posterior
    with tempered SMC, and record the FRACTIONAL RANK of theta_k in each
    marginal (the empirical posterior CDF evaluated at the true value).
    If prior, simulator, likelihood, and sampler are mutually consistent,
    the ranks are U(0,1) in every dimension — this tests the whole chain
    at once, including the prior handling and the sampler, which the
    fixed-fiducial coverage modes cannot.

    Unlike the fixed-fiducial modes, the data vector AND covariance are
    rebuilt at each mock's own beta_k (the generative model the likelihood
    actually assumes). Returns (ranks (n_mocks, ndim) in [0, 1], names).
    """
    from victor_tpu.sampling.smc import run_smc

    if form != 'gaussian':
        # SBC's rank-uniformity guarantee requires the FITTED likelihood to
        # equal the SIMULATOR density; mocks here are Gaussian draws, so a
        # sellentin/hartlap/percival fit would deviate from U(0,1) by
        # construction and read as a spurious calibration failure
        raise ValueError("run_sbc supports form='gaussian' only: the "
                         'Gaussian simulator must match the fitted '
                         'likelihood for ranks to be uniform')
    block = params_block or SBC_BLOCK
    names = list(block)
    for n in names:                      # SBC precondition, not a style check
        if block[n]['prior']['dist'] != 'norm':
            raise ValueError(
                'run_sbc draws generation parameters with numpy; priors '
                'must be norm so the draw matches ParamSpace.sample_prior '
                f"exactly (got {block[n]['prior']['dist']!r} for {n})")

    # beta draws must stay inside every beta grid the generative step
    # interpolates over: the DATA-side grids (beta_ccf for the data vector,
    # beta_cov for the covariance) and, when present, the model-side grid.
    # Outside them the generative step would silently clamp/extrapolate —
    # exactly the rank-uniformity breakage the raise below prevents. Grids
    # are None for fixed (beta-independent) inputs, where any draw is fine.
    from victor_tpu.likelihood.multiquantile import JointBundle
    if isinstance(bundle, JointBundle):
        tabs = [b.tables for b in bundle.bundles]
        extra = [] if bundle.beta_cov is None else [bundle.beta_cov]
    else:
        tabs, extra = [bundle.tables], []
    grids = extra + [g for t in tabs
                     for g in (getattr(t, 'beta_ccf', None),
                               getattr(t, 'beta_cov', None),
                               getattr(t, 'beta_grid', None))
                     if g is not None]
    blo = max((float(np.asarray(g)[0]) for g in grids), default=-np.inf)
    bhi = min((float(np.asarray(g)[-1]) for g in grids), default=np.inf)

    rng = np.random.default_rng(seed)
    ranks = np.empty((n_mocks, len(names)))
    for k in range(n_mocks):
        theta = {n: rng.normal(block[n]['prior']['loc'],
                               block[n]['prior']['scale']) for n in names}
        # with the shipped scales an out-of-grid beta is a >6-sigma event;
        # fail loudly rather than clip (clipping breaks rank uniformity)
        if not blo < theta['beta'] < bhi:
            raise RuntimeError(
                f'mock {k}: beta draw {theta["beta"]:.4f} outside the '
                f'narrowest beta grid [{blo:.4f}, {bhi:.4f}]')
        tvec, dvec, L = _mock_setup(bundle, theta)
        mock = tvec + L @ rng.standard_normal(len(tvec))
        mb = shift_datavector(bundle, mock - dvec)
        res = run_smc(mb, block, n_particles=n_particles, n_moves=n_moves,
                      seed=seed + 1000 + k, fit_kw={'form': form},
                      chunk=chunk)
        order = [res.space.names.index(n) for n in names]
        p = res.particles[:, order]
        truth = np.array([theta[n] for n in names])
        ranks[k] = (p < truth[None, :]).mean(axis=0)
    return ranks, names


# Joint multi-quantile calibration space: cosmology/AP shared across the
# two quantiles, one dispersion amplitude per quantile via the __q<i>
# override convention — 5 parameters through the stacked-vector +
# cross-covariance machinery (likelihood/multiquantile.py)
JOINT_FIDUCIAL = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v__q0': 380.0,
                  'sigma_v__q1': 380.0, 'epsilon': 1.0}

JOINT_PARAMS_BLOCK = {
    'fsigma8': PARAMS_BLOCK['fsigma8'],
    'beta': PARAMS_BLOCK['beta'],
    'sigma_v__q0': PARAMS_BLOCK['sigma_v'],
    'sigma_v__q1': PARAMS_BLOCK['sigma_v'],
    'epsilon': PARAMS_BLOCK['epsilon'],
}

SBC_BLOCK_JOINT = {
    'fsigma8': SBC_BLOCK['fsigma8'],
    'beta': SBC_BLOCK['beta'],
    'sigma_v__q0': SBC_BLOCK['sigma_v'],
    'sigma_v__q1': SBC_BLOCK['sigma_v'],
    'epsilon': SBC_BLOCK['epsilon'],
}


def build_joint_boss_bundle(rho=0.4, model_overrides=None, n_quantiles=2):
    """n-'quantile' JointBundle over the BOSS dataset with a beta-varying
    CORRELATED joint covariance kron(R, C(beta)), R the equicorrelated
    n x n correlation matrix (1-rho) I + rho 11^T — positive definite for
    -1/(n-1) < rho < 1. The off-diagonal blocks are the point: mock noise
    is correlated across quantiles exactly as density-split data vectors
    are, so a calibration through this bundle validates the
    cross-covariance handling, the stacked theory/data vectors, the
    per-quantile __q<i> overrides, and the (n_b, nD, nD) beta
    interpolation at once.

    `model_overrides` (dict) is merged into every quantile's model block
    (e.g. {'streaming_eval': 'fast'} for the opt-in Chebyshev fast mode).

    Analytic gate for identical per-quantile residuals x (all sigma_v__q<i>
    equal): 1^T R^-1 1 = n / (1 + (n-1) rho), so the joint chi2 is
    n * chi2_single / (1 + (n-1) rho)."""
    import copy
    import tempfile

    import h5py
    import yaml

    from victor_tpu.io import build_tables
    from victor_tpu.likelihood.multiquantile import build_joint_tables

    if not (-1.0 / (n_quantiles - 1) < rho < 1.0):
        raise ValueError(f'rho={rho} not PD for n_quantiles={n_quantiles}')
    with open(os.path.join(REPO, 'configs', 'boss_config.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['model']['dir'] = REPO
    cfg['data']['dir'] = REPO
    cfg['model'].update(model_overrides or {})
    single = build_tables(cfg['model'], cfg['data'])
    covs = np.asarray(single.tables.cov, dtype=np.float64)   # (n_b, D, D)
    beta = np.asarray(single.tables.beta_cov, dtype=np.float64)
    R = np.full((n_quantiles, n_quantiles), rho)
    np.fill_diagonal(R, 1.0)
    # kron over the quantile axis for every beta slice: (n_b, nD, nD)
    joint_cov = np.einsum('pq,bij->bpiqj', R, covs).reshape(
        len(beta), n_quantiles * covs.shape[1], n_quantiles * covs.shape[2])
    tmp = tempfile.mkdtemp(prefix='victor_joint_cov_')
    cov_fn = os.path.join(tmp, 'joint_cov.hdf5')
    with h5py.File(cov_fn, 'w') as f:
        f.create_dataset('covmat', data=joint_cov)
        f.create_dataset('beta', data=beta)

    q = {'model': copy.deepcopy(cfg['model']),
         'data': {'redshift_space_ccf':
                  copy.deepcopy(cfg['data']['redshift_space_ccf']),
                  'dir': REPO}}
    joint_cfg = {
        'quantiles': [copy.deepcopy(q) for _ in range(n_quantiles)],
        'covariance_matrix': {'data_file': cov_fn, 'cov_key': 'covmat',
                              'fixed_beta': False, 'beta_key': 'beta'},
        'likelihood': {'form': 'gaussian', 'nmocks': 1000,
                       'nparams': 3 + n_quantiles},
    }
    return build_joint_tables(joint_cfg)


ESM_FIDUCIAL = {'f': 0.778, 'sigma_8_0': 0.81, 'b10': -1.544,
                'b01': -4.228, 'Rp': 7.973, 'Rx': 0.467, 'beta': 0.37,
                'sigma_v': 380.0, 'epsilon': 1.0}

# 9-dim SBC space for the excursion-set pipeline: normals around the ESM
# MAP neighbourhood, scales sized to the posterior-typical region (shape
# nuisances narrower than their degenerate likelihood widths so every
# prior draw keeps the profile pipeline in its physical regime — Rp/Rx
# positive at >9 sigma)
SBC_BLOCK_ESM = {
    'f': {'prior': {'dist': 'norm', 'loc': 0.778, 'scale': 0.05}},
    'sigma_8_0': {'prior': {'dist': 'norm', 'loc': 0.81, 'scale': 0.05}},
    'b10': {'prior': {'dist': 'norm', 'loc': -1.544, 'scale': 0.15}},
    'b01': {'prior': {'dist': 'norm', 'loc': -4.228, 'scale': 0.4}},
    'Rp': {'prior': {'dist': 'norm', 'loc': 7.973, 'scale': 0.3}},
    'Rx': {'prior': {'dist': 'norm', 'loc': 0.467, 'scale': 0.05}},
    'beta': {'prior': {'dist': 'norm', 'loc': 0.37, 'scale': 0.03}},
    'sigma_v': {'prior': {'dist': 'norm', 'loc': 380.0, 'scale': 30.0}},
    'epsilon': {'prior': {'dist': 'norm', 'loc': 1.0, 'scale': 0.02}},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--mocks', type=int, default=100)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--form', default='gaussian',
                    help='likelihood form for generation+fit (gaussian = '
                         'exactly calibrated; sellentin adds the t-tail)')
    ap.add_argument('--model', default='template',
                    choices=['template', 'dispersion', 'kaiser',
                             'euclid_special', 'esm', 'joint'],
                    help='template = 4-param BOSS fit (streaming RSD); '
                         'dispersion/kaiser/euclid_special = the same fit '
                         'under another RSD mapping; esm = 9-param '
                         'excursion-set pipeline; joint = 5-param 2-quantile '
                         'joint fit with a correlated cross-covariance and '
                         'per-quantile sigma_v__q<i> overrides')
    ap.add_argument('--beta-profile', action='store_true',
                    help='also measure beta coverage with per-mock '
                         'delta-chi2=1 profile intervals (the remedy for '
                         'the grid-structure-broken Laplace sigma)')
    ap.add_argument('--method', default='map',
                    choices=['map', 'smc', 'sbc', 'ns', 'mh', 'ensemble'],
                    help='map = MAP + Laplace pulls/intervals; smc = '
                         'per-mock tempered-SMC posteriors with central '
                         '68%% credible-interval coverage (the calibration '
                         'of the recommended reporting path); sbc = '
                         'simulation-based calibration: prior-drawn truths, '
                         'posterior rank-uniformity (Talts et al. 2018) — '
                         'the full-Bayes self-consistency test; ns = the '
                         'smc calibration for the nested-sampling posterior '
                         'path (run_nested); mh = the same for the '
                         'random-walk-Metropolis chains '
                         '(run_hmc_mcmc(algorithm=mh))')
    ap.add_argument('--debias', type=int, default=0, metavar='N',
                    help='method=map only: apply the parametric-bootstrap '
                         'correction with N refits per mock (pulls use the '
                         'debiased estimate over the bootstrap sigma — the '
                         'calibration row behind `fit --bootstrap`)')
    ap.add_argument('--particles', type=int, default=2048,
                    help='SMC particles per mock (method=smc)')
    ap.add_argument('--moves', type=int, default=6,
                    help='SMC mutation moves per stage (method=smc)')
    args = ap.parse_args()
    if args.beta_profile and args.method != 'map':
        ap.error('--beta-profile applies to --method map only (the smc/sbc '
                 'methods already characterise the beta marginal)')
    if args.debias and args.method != 'map':
        ap.error('--debias applies to --method map only (the posterior '
                 'methods are already calibrated without correction)')


    import yaml

    from victor_tpu.io import build_tables
    from victor_tpu.utils.profiling import enable_persistent_cache
    enable_persistent_cache()

    if args.model == 'esm':
        with open(os.path.join(REPO, 'configs',
                               'esm_sampling_config.yaml')) as f:
            full = yaml.safe_load(f)
        cfg = {'model': full['model'], 'data': full['data']}
        cfg['model']['dir'] = REPO
        cfg['data']['dir'] = REPO
        bundle = build_tables(cfg['model'], cfg['data'])
        # the full cobaya-style block (latex keys are tolerated)
        block = full['params']
        fiducial = ESM_FIDUCIAL
    elif args.model == 'joint':
        bundle = build_joint_boss_bundle()
        block = JOINT_PARAMS_BLOCK
        fiducial = JOINT_FIDUCIAL
    else:
        with open(os.path.join(REPO, 'configs', 'boss_config.yaml')) as f:
            cfg = yaml.safe_load(f)
        cfg['model']['dir'] = REPO
        cfg['data']['dir'] = REPO
        if args.model != 'template':
            # same fit under another RSD mapping (dispersion runs the exact
            # final stage — the parity default, not the opt-in fast mode)
            cfg['model']['rsd_model'] = args.model
        bundle = build_tables(cfg['model'], cfg['data'])
        block = PARAMS_BLOCK
        fiducial = FIDUCIAL
        if args.model in ('kaiser', 'euclid_special'):
            # these mappings have no velocity-pdf convolution: theory_xi
            # never reads sigma_v, so its "posterior" would be the prior
            # and any coverage/rank number for it vacuous — drop it from
            # the calibration (3-parameter fit)
            block = {k: v for k, v in PARAMS_BLOCK.items() if k != 'sigma_v'}
            fiducial = {k: v for k, v in FIDUCIAL.items() if k != 'sigma_v'}

    if args.method == 'sbc':
        from scipy import stats
        sbc_block = {'esm': SBC_BLOCK_ESM,
                     'joint': SBC_BLOCK_JOINT}.get(args.model, SBC_BLOCK)
        if args.model in ('kaiser', 'euclid_special'):
            # sigma_v is not read by these mappings (see above): a rank
            # test on it would be trivially uniform, not evidence
            sbc_block = {k: v for k, v in SBC_BLOCK.items()
                         if k != 'sigma_v'}
        ranks, names = run_sbc(
            bundle, n_mocks=args.mocks, seed=args.seed, form=args.form,
            params_block=sbc_block,
            n_particles=args.particles, n_moves=args.moves)
        print(f'{args.mocks} mocks, likelihood form = {args.form}, '
              f'method = sbc (fractional posterior ranks of prior-drawn '
              f'truths; uniform = self-consistent)')
        for i, n in enumerate(names):
            r = ranks[:, i]
            ks = stats.kstest(r, 'uniform')
            hist = np.histogram(r, bins=10, range=(0, 1))[0]
            print(f'  {n:8s} rank mean {r.mean():.3f} (U(0,1): 0.500 +/- '
                  f'{1 / np.sqrt(12 * len(r)):.3f})   '
                  f'KS p = {ks.pvalue:.3f}   10-bin: {hist.tolist()}')
        return

    if args.method in ('smc', 'ns', 'mh', 'ensemble'):
        if args.method == 'ns':
            pulls, cover68, names = run_coverage_ns(
                bundle, n_mocks=args.mocks, seed=args.seed, form=args.form,
                fiducial=fiducial, params_block=block)
        elif args.method == 'mh':
            pulls, cover68, names = run_coverage_mh(
                bundle, n_mocks=args.mocks, seed=args.seed, form=args.form,
                fiducial=fiducial, params_block=block)
        elif args.method == 'ensemble':
            pulls, cover68, names = run_coverage_ensemble(
                bundle, n_mocks=args.mocks, seed=args.seed, form=args.form,
                fiducial=fiducial, params_block=block)
        else:
            pulls, cover68, names = run_coverage_smc(
                bundle, n_mocks=args.mocks, seed=args.seed, form=args.form,
                fiducial=fiducial, params_block=block,
                n_particles=args.particles, n_moves=args.moves)
        print(f'{args.mocks} mocks, likelihood form = {args.form}, '
              f'method = {args.method} (central 68% credible intervals)')
        bsig = 100 * np.sqrt(0.683 * 0.317 / len(pulls))
        for i, n in enumerate(names):
            p = pulls[:, i]
            print(f'  {n:8s} posterior-mean pull {p.mean():+6.3f} +/- '
                  f'{p.std() / np.sqrt(len(p)):.3f}   std {p.std():.3f}   '
                  f'central-68% coverage: {cover68[i] * 100:.0f}% '
                  f'(binomial sigma {bsig:.1f}%)')
        return

    pulls, hit68, names, beta_iv = run_coverage(
        bundle, n_mocks=args.mocks, seed=args.seed, form=args.form,
        fiducial=fiducial, params_block=block,
        beta_profile=args.beta_profile, debias=args.debias)
    print(f'{args.mocks} mocks, likelihood form = {args.form}'
          + (f', bootstrap-debiased (N={args.debias})' if args.debias
             else ''))
    for i, n in enumerate(names):
        p = pulls[:, i]
        print(f'  {n:8s} pull mean {p.mean():+6.3f} +/- '
              f'{p.std() / np.sqrt(len(p)):.3f}   std {p.std():.3f}   '
              f'|pull|<1: {np.mean(np.abs(p) < 1) * 100:.0f}%')
    # binomial sigma with n_mocks trials: the ndim pulls per mock share one
    # noise realization, so counting them as independent would understate
    # the error bar ~2x
    print(f'overall 68.3%-interval coverage: {hit68 * 100:.1f}% '
          f'(binomial sigma {100 * np.sqrt(0.683 * 0.317 / len(pulls)):.1f}%)')
    if beta_iv is not None:
        fb = fiducial['beta']
        cov_b = float(np.mean((beta_iv[:, 0] <= fb) & (fb <= beta_iv[:, 1])))
        widths = beta_iv[np.all(np.isfinite(beta_iv), axis=1)]
        half = (widths[:, 1] - widths[:, 0]) / 2 if len(widths) else [np.nan]
        trunc = float(np.mean(~np.isfinite(beta_iv).all(axis=1)))
        print(f'beta PROFILE-interval (delta-chi2=1) coverage: '
              f'{cov_b * 100:.1f}% '
              f'(binomial sigma {100 * np.sqrt(0.683 * 0.317 / len(beta_iv)):.1f}%); '
              f'median half-width {np.median(half):.4f}; '
              f'{trunc * 100:.0f}% of mocks truncated by the scan window '
              f'(those count as covering -> coverage is an upper bound)')


if __name__ == '__main__':
    main()
