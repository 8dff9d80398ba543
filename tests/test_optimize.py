"""MAP/Laplace fitter (sampling/optimize.py) on the BOSS likelihood.

Ground truth for the posterior moments comes from the sampler-free grid
quadrature (tools/validate_posterior.py, BASELINE.md): fsigma8 = 0.573 +/-
0.054, beta = 0.3667 +/- 0.011, sigma_v = 418 +/- 44, epsilon = 1.0089 +/-
0.011 on this exact config.
"""

import numpy as np
import pytest


BLOCK_4P = {
    'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.05}},
    'beta': {'prior': {'dist': 'uniform', 'min': 0.2, 'max': 0.6},
             'ref': {'dist': 'norm', 'loc': 0.4, 'scale': 0.03}},
    'sigma_v': {'prior': {'dist': 'uniform', 'min': 150.0, 'max': 700.0},
                'ref': {'dist': 'norm', 'loc': 380.0, 'scale': 30.0}},
    'epsilon': {'prior': {'dist': 'uniform', 'min': 0.8, 'max': 1.2},
                'ref': {'dist': 'norm', 'loc': 1.0, 'scale': 0.02}},
}

# quadrature ground truth (tools/validate_posterior.py)
QUAD_MEAN = {'fsigma8': 0.573, 'beta': 0.3667, 'sigma_v': 418.0,
             'epsilon': 1.0089}
QUAD_STD = {'fsigma8': 0.054, 'beta': 0.011, 'sigma_v': 44.0,
            'epsilon': 0.011}


@pytest.fixture(scope='module')
def map_result(boss_config):
    # reduced from (8 starts, 150 adam, 8 newton): the Newton polish drives
    # the gradient to stationarity regardless, and every assertion below has
    # margin; the full-strength settings run in the slow tier and the CLI
    from victor_tpu.io import build_tables
    from victor_tpu.sampling.optimize import find_map
    bundle = build_tables(boss_config['model'], boss_config['data'])
    return find_map(bundle, BLOCK_4P, n_starts=4, adam_steps=120,
                    newton_steps=6, seed=3)


class TestFindMAP:
    def test_beats_golden_point_and_is_stationary(self, map_result):
        # the golden point {0.47, 0.37, 380, 1.0} has chi2 = 65.01; the MAP
        # must fit better, and the gradient must vanish at the optimum
        assert map_result.chi2 < 65.01
        assert map_result.grad_norm < 5e-2
        assert map_result.n_converged == map_result.n_starts

    def test_map_within_posterior_bulk(self, map_result):
        # MAP vs quadrature mean: within 1 sigma per parameter (the posterior
        # is mildly skewed, so mode != mean, but far less than one sigma)
        for name, mean in QUAD_MEAN.items():
            err = abs(map_result.params[name] - mean) / QUAD_STD[name]
            assert err < 1.0, f'{name}: MAP {map_result.params[name]} vs ' \
                              f'quadrature mean {mean} ({err:.2f} sigma)'

    def test_laplace_errors_match_quadrature(self, map_result):
        # Laplace sigma vs the quadrature sigma: same scale (the posterior is
        # near-Gaussian; allow 40% for the skewness)
        for name, sd in QUAD_STD.items():
            ratio = map_result.std[name] / sd
            assert 0.6 < ratio < 1.4, f'{name}: Laplace {map_result.std[name]}' \
                                      f' vs quadrature {sd}'

    def test_correlation_structure(self, map_result):
        # fsigma8 and sigma_v are the known degenerate pair on this config
        # (BASELINE.md dense-mass discussion): strong positive correlation
        corr = map_result.correlation
        names = [p.name for p in map_result.space.sampled]
        i, j = names.index('fsigma8'), names.index('sigma_v')
        assert corr[i, j] > 0.5
        # valid correlation matrix
        assert np.all(np.abs(corr) <= 1.0 + 1e-9)
        np.testing.assert_allclose(np.diag(corr), 1.0, atol=1e-9)

    def test_summary_shape(self, map_result):
        s = map_result.summary()
        assert set(s) == {'fsigma8', 'beta', 'sigma_v', 'epsilon'}
        assert all({'value', 'std'} <= set(v) for v in s.values())


class TestParametricBootstrap:
    def test_bootstrap_shapes_and_consistency(self, boss_config, map_result):
        """Smoke tier: the bootstrap draws mocks from the FITTED model,
        refits them, and returns bias/covariance of the right shape with
        refit scatter on the scale of the Laplace sigma (the statistical
        100-mock calibration row is in BASELINE.md)."""
        from victor_tpu.io import build_tables
        from victor_tpu.sampling.optimize import parametric_bootstrap
        bundle = build_tables(boss_config['model'], boss_config['data'])
        bres = parametric_bootstrap(bundle, BLOCK_4P, map_result, n_boot=6,
                                    n_starts=2, adam_steps=60,
                                    newton_steps=4, seed=11)
        assert bres.theta_boot.shape[1] == 4
        assert len(bres.theta_boot) >= 4
        np.testing.assert_allclose(
            bres.theta_debiased, bres.theta_map - bres.bias)
        # refit scatter must be on the Laplace scale (same estimator on
        # noise of the fitted covariance), not degenerate at 6 draws:
        # within a factor ~4 of each Laplace sigma
        lap = np.sqrt(np.diag(map_result.cov))
        boot = np.sqrt(np.diag(bres.cov))
        ratio = boot / lap
        assert np.all(ratio > 0.25) and np.all(ratio < 4.0), ratio
        # the debiased point stays inside the posterior bulk
        for i, n in enumerate(bres.names):
            assert abs(bres.theta_debiased[i] - QUAD_MEAN[n]) < \
                5 * QUAD_STD[n]


class TestCacheKeyParamOrder:
    def test_reordered_params_block_fits_correctly(self):
        """A params block and its alphabetised reordering (what a YAML
        round-trip produces) must BOTH fit correctly in one process: the
        jit-fn caches must key on parameter ORDER, because the cached
        closures bake in the theta-component layout of the space they were
        compiled with. Regression for the sorted-cache-key collision that
        scrambled the analyze CLI's MAP (chi2 jumped to 3.8e7 with a nan
        gradient) whenever any find_map on the hand-ordered block ran
        first in the process (found by the analyze GOF assertion).

        Runs on an analytic callable target: the collision lives entirely
        in find_map's cache_key construction, which is target-agnostic, and
        the asymmetric bounds below make a layout scramble land parameter
        'b' (optimum 12.0) inside 'a''s [-1, 1] box — unmissable. (The
        original BOSS-bundle version of this test cost 353 s of CPU
        compile for the second full-size fit; this one fails identically
        under the bug, in seconds.)"""
        import jax.numpy as jnp
        from victor_tpu.sampling import optimize
        from victor_tpu.sampling.optimize import find_map

        def loglike(params):
            chi2 = ((params['a'] - 0.3) ** 2 / 0.01
                    + (params['b'] - 12.0) ** 2 / 1.0)
            return -0.5 * chi2, chi2

        hand = {  # deliberately NOT alphabetical
            'b': {'prior': {'dist': 'uniform', 'min': 5.0, 'max': 20.0},
                  'ref': {'dist': 'norm', 'loc': 11.0, 'scale': 1.0}},
            'a': {'prior': {'dist': 'uniform', 'min': -1.0, 'max': 1.0},
                  'ref': {'dist': 'norm', 'loc': 0.0, 'scale': 0.2}},
        }
        reordered = {k: hand[k] for k in sorted(hand)}
        assert list(reordered) != list(hand)

        kw = dict(n_starts=4, adam_steps=150, newton_steps=6, seed=3)
        m1 = find_map(loglike, hand, **kw)
        keys_after_first = set(optimize._FIT_CACHE)
        # identical settings — under a sorted key this call collides with
        # m1's compiled closures and decodes a scrambled layout
        m2 = find_map(loglike, reordered, **kw)
        for m in (m1, m2):
            assert abs(m.params['a'] - 0.3) < 1e-3, m.params
            assert abs(m.params['b'] - 12.0) < 1e-3, m.params
        # white-box: the reordering must occupy its OWN cache entry
        new_keys = set(optimize._FIT_CACHE) - keys_after_first
        assert len(new_keys) == 1, 'reordered block must not share a cache key'


class TestProfileScan:
    @pytest.mark.slow
    def test_profile_fsigma8(self, boss_config, map_result):
        """1D profile over fsigma8: the minimum sits at the MAP, the
        delta-chi2 = 1 interval half-width matches the Laplace sigma (the
        posterior is near-Gaussian), and nuisance optima track the ridge."""
        from victor_tpu.io import build_tables
        from victor_tpu.sampling.optimize import profile_scan
        bundle = build_tables(boss_config['model'], boss_config['data'])
        # newton_steps=0 keeps the CPU test fast (the vmapped hessian trace
        # dominates compile); warm-started Adam converges to ~1e-2 on chi2,
        # which is enough for the structural assertions below. The CLI/device
        # path runs with the Newton polish (default newton_steps=6).
        res = profile_scan(bundle, BLOCK_4P, 'fsigma8', n_grid=9,
                           n_sigma=2.5, adam_steps=80, newton_steps=0,
                           map_result=map_result)
        assert res.grid.shape == (9, 1)
        d = res.delta_chi2()
        # the profile minimum agrees with the global MAP chi2
        assert abs(res.chi2.min() - map_result.chi2) < 0.05
        # interior minimum, rising toward both edges
        i0 = int(np.argmin(d))
        assert 0 < i0 < 8
        assert d[0] > 1.0 and d[-1] > 1.0
        lo, hi = res.interval(1.0)
        half = 0.5 * (hi - lo)
        assert abs(half - map_result.std['fsigma8']) < \
            0.25 * map_result.std['fsigma8']
        # the fsigma8--sigma_v degeneracy: the profiled sigma_v optimum
        # increases along the scan
        j = res.free_names.index('sigma_v')
        sv = res.free_optima[:, j]
        assert sv[-1] > sv[0]

    def test_gaussian_profile_analytic_with_chunked_grid(self):
        """Callable target + grid chunking/padding: profiling one coordinate
        of a correlated bivariate Gaussian gives delta-chi2(x) =
        (x - mu_x)^2 / Sigma_xx exactly (the MARGINAL variance — profiling
        re-minimises the other coordinate at each x)."""
        import jax.numpy as jnp
        from victor_tpu.sampling.optimize import profile_scan
        MU = np.array([0.5, -0.3])
        COV = np.array([[1.0, 0.6], [0.6, 0.8]])
        ICOV = np.linalg.inv(COV)

        def loglike(params):
            d = jnp.stack([params['x'] - MU[0], params['y'] - MU[1]])
            chi2 = d @ jnp.asarray(ICOV) @ d
            return -0.5 * chi2, chi2

        block = {'x': {'prior': {'dist': 'uniform', 'min': -5.0, 'max': 5.0}},
                 'y': {'prior': {'dist': 'uniform', 'min': -5.0, 'max': 5.0}}}
        grid = np.linspace(-0.8, 1.8, 11)          # 1-D form: must be
        res = profile_scan(loglike, block, 'x', grid=grid, adam_steps=200,
                           newton_steps=4, grid_chunk=4)   # 3 chunks, 1 pad
        assert res.grid.shape == (11, 1)           # ...treated as 11 points
        grid = grid[:, None]
        want = (grid[:, 0] - MU[0]) ** 2 / COV[0, 0]
        np.testing.assert_allclose(res.delta_chi2(), want - want.min(),
                                   atol=2e-3)
        # the profiled y optimum tracks the regression line
        # y*(x) = mu_y + (Sigma_xy / Sigma_xx)(x - mu_x)
        slope = COV[0, 1] / COV[0, 0]
        np.testing.assert_allclose(
            res.free_optima[:, 0],
            MU[1] + slope * (grid[:, 0] - MU[0]), atol=5e-3)

    def test_scan_validates_names(self, boss_config, map_result):
        from victor_tpu.io import build_tables
        from victor_tpu.sampling.optimize import profile_scan
        bundle = build_tables(boss_config['model'], boss_config['data'])
        with pytest.raises(ValueError):
            profile_scan(bundle, BLOCK_4P, 'not_a_param',
                         map_result=map_result)


class TestFisherForecast:
    def test_fisher_matches_laplace_scale(self, boss_config, map_result):
        """Fisher forecast at the MAP point: for this near-Gaussian
        likelihood with weakly beta-dependent covariance the forecast
        sigmas should track the Laplace sigmas."""
        from victor_tpu.io import build_tables
        from victor_tpu.sampling.optimize import fisher_forecast
        bundle = build_tables(boss_config['model'], boss_config['data'])
        names = ('fsigma8', 'beta', 'sigma_v', 'epsilon')
        res = fisher_forecast(bundle, map_result.params, names)
        assert np.all(np.isfinite(res.fisher))
        lap = map_result.std
        for n in names:
            ratio = res.std[n] / lap[n]
            assert 0.5 < ratio < 2.0, \
                f'{n}: Fisher {res.std[n]:.4g} vs Laplace {lap[n]:.4g}'
        # same degeneracy structure
        corr_f = res.correlation
        i, j = names.index('fsigma8'), names.index('sigma_v')
        assert corr_f[i, j] > 0.4

    def test_missing_beta_raises_for_beta_dependent_data(self, boss_config):
        """A forecast over a beta-dependent data vector / covariance with no
        fiducial beta (given or derivable) must raise loudly — the old
        silent 0.4 fallback produced plausible-but-wrong Fisher sigmas
        (same semantics as likelihood/core.chi_squared and the JointBundle
        branch)."""
        from victor_tpu.errors import InputError
        from victor_tpu.io import build_tables
        from victor_tpu.sampling.optimize import fisher_forecast
        bundle = build_tables(boss_config['model'], boss_config['data'])
        with pytest.raises(InputError, match='beta'):
            fisher_forecast(bundle,
                            {'fsigma8': 0.47, 'sigma_v': 380.0,
                             'epsilon': 1.0},
                            ('fsigma8', 'sigma_v', 'epsilon'))

    def test_derived_params_chain_through(self, boss_config, map_result):
        """Derived lambdas (the cobaya params-block vocabulary) must chain
        through the forecast derivative: sampling svx with derived
        sigma_v = svx gives exactly the Fisher of sampling sigma_v
        directly — without the chain rule the derived parameter would be
        absent from the residual entirely."""
        from victor_tpu.io import build_tables
        from victor_tpu.sampling.optimize import fisher_forecast
        from victor_tpu.sampling.priors import ParamSpace
        bundle = build_tables(boss_config['model'], boss_config['data'])
        names = ('fsigma8', 'beta', 'sigma_v', 'epsilon')
        direct = fisher_forecast(bundle, map_result.params, names)
        block = {
            'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05,
                                  'max': 1.5}},
            'beta': {'prior': {'dist': 'uniform', 'min': 0.2, 'max': 0.6}},
            'svx': {'prior': {'dist': 'uniform', 'min': 150.0,
                              'max': 700.0}},
            'epsilon': {'prior': {'dist': 'uniform', 'min': 0.8,
                                  'max': 1.2}},
            'sigma_v': {'value': 'lambda svx: svx'},
        }
        space = ParamSpace(block)
        fid = dict(map_result.params)
        fid['svx'] = fid.pop('sigma_v')
        res = fisher_forecast(bundle, fid, space.names,
                              derived=space.derived)
        assert res.names == ('fsigma8', 'beta', 'svx', 'epsilon')
        np.testing.assert_allclose(
            [res.std[n] for n in res.names],
            [direct.std[n] for n in names], rtol=1e-6)

    def test_derived_beta_resolves_fiducial_covariance(self, boss_config,
                                                       map_result):
        """When beta itself is derived (beta: {value: lambda bx: bx}), the
        fiducial-beta covariance must be interpolated at the DERIVED value,
        not the 0.4 fallback: sampling bx with derived beta must reproduce
        the direct-beta Fisher exactly."""
        from victor_tpu.io import build_tables
        from victor_tpu.sampling.optimize import fisher_forecast
        from victor_tpu.sampling.priors import ParamSpace
        bundle = build_tables(boss_config['model'], boss_config['data'])
        names = ('fsigma8', 'beta', 'sigma_v', 'epsilon')
        direct = fisher_forecast(bundle, map_result.params, names)
        block = {
            'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05,
                                  'max': 1.5}},
            'bx': {'prior': {'dist': 'uniform', 'min': 0.2, 'max': 0.6}},
            'sigma_v': {'prior': {'dist': 'uniform', 'min': 150.0,
                                  'max': 700.0}},
            'epsilon': {'prior': {'dist': 'uniform', 'min': 0.8,
                                  'max': 1.2}},
            'beta': {'value': 'lambda bx: bx'},
        }
        space = ParamSpace(block)
        fid = dict(map_result.params)
        fid['bx'] = fid.pop('beta')
        res = fisher_forecast(bundle, fid, space.names,
                              derived=space.derived)
        np.testing.assert_allclose(
            [res.std[n] for n in ('fsigma8', 'bx', 'sigma_v', 'epsilon')],
            [direct.std[n] for n in names], rtol=1e-6)

    def test_chained_derived_beta_and_explicit_conflict(self, boss_config,
                                                        map_result):
        """beta reached through CHAINED lambdas (beta <- bhalf <- bx) must
        still resolve the fiducial covariance (a one-hop argname lookup
        silently fell back to beta=0.4), and an explicit conflicting
        'beta' entry in the fiducial must lose to the derived value (the
        residual recomputes beta from the lambda, so honoring the explicit
        entry would mix interpolation points)."""
        from victor_tpu.io import build_tables
        from victor_tpu.sampling.optimize import fisher_forecast
        from victor_tpu.sampling.priors import ParamSpace
        bundle = build_tables(boss_config['model'], boss_config['data'])
        names = ('fsigma8', 'beta', 'sigma_v', 'epsilon')
        direct = fisher_forecast(bundle, map_result.params, names)
        block = {
            'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05,
                                  'max': 1.5}},
            'bx': {'prior': {'dist': 'uniform', 'min': 0.2, 'max': 0.6}},
            'sigma_v': {'prior': {'dist': 'uniform', 'min': 150.0,
                                  'max': 700.0}},
            'epsilon': {'prior': {'dist': 'uniform', 'min': 0.8,
                                  'max': 1.2}},
            'bhalf': {'value': 'lambda bx: bx'},
            'beta': {'value': 'lambda bhalf: bhalf'},
        }
        space = ParamSpace(block)
        fid = dict(map_result.params)
        fid['bx'] = fid.pop('beta')
        fid['beta'] = 0.55            # bogus explicit entry: must be ignored
        res = fisher_forecast(bundle, fid, space.names,
                              derived=space.derived)
        np.testing.assert_allclose(
            [res.std[n] for n in ('fsigma8', 'bx', 'sigma_v', 'epsilon')],
            [direct.std[n] for n in names], rtol=1e-6)


class TestLaplaceEvidence:
    def test_gaussian_laplace_evidence_is_exact(self):
        """For a Gaussian likelihood under a wide uniform box prior the
        Laplace evidence IS the evidence: lnZ = lnL_max - ln V +
        (d/2) ln 2pi + (1/2) ln det Sigma."""
        import jax.numpy as jnp
        from victor_tpu.sampling.optimize import find_map
        MU = np.array([0.5, -0.3])
        COV = np.array([[1.0, 0.6], [0.6, 0.8]])
        ICOV = np.linalg.inv(COV)

        def loglike(params):
            d = jnp.stack([params['x'] - MU[0], params['y'] - MU[1]])
            chi2 = d @ jnp.asarray(ICOV) @ d
            return -0.5 * chi2, chi2

        block = {'x': {'prior': {'dist': 'uniform', 'min': -20.0,
                                 'max': 20.0}},
                 'y': {'prior': {'dist': 'uniform', 'min': -20.0,
                                 'max': 20.0}}}
        m = find_map(loglike, block, n_starts=4, adam_steps=300,
                     newton_steps=6, seed=0)
        want = (-np.log(40.0 * 40.0) + np.log(2.0 * np.pi)
                + 0.5 * np.linalg.slogdet(COV)[1])
        assert abs(m.log_evidence_laplace - want) < 1e-3

    def test_prior_truncation_correction(self):
        """A direction with Laplace sigma >> the prior box (the ESM shape-
        nuisance regime) must carry the Gaussian-mass truncation factor:
        lnL = -x'^2/2 - (y/50)^2/2 on the box [-5,5]^2 has the analytic
        lnZ = ln[ sqrt(2 pi) * int_-5^5 exp(-y^2/5000) dy / 100 ] = -1.3855;
        the UNtruncated Laplace would report +1.14 (2.5 nats high)."""
        import jax.numpy as jnp
        from scipy.stats import norm
        from victor_tpu.sampling.optimize import find_map

        def loglike(params):
            chi2 = (params['x'] - 0.3) ** 2 + (params['y'] / 50.0) ** 2
            return -0.5 * chi2, chi2

        block = {'x': {'prior': {'dist': 'uniform', 'min': -5.0,
                                 'max': 5.0}},
                 'y': {'prior': {'dist': 'uniform', 'min': -5.0,
                                 'max': 5.0}}}
        m = find_map(loglike, block, n_starts=4, adam_steps=300,
                     newton_steps=8, seed=0)
        assert m.hessian_pd
        ix = np.sqrt(2 * np.pi) * (norm.cdf(4.7) - norm.cdf(-5.3))
        iy = np.sqrt(2 * np.pi) * 50.0 * (norm.cdf(0.1) - norm.cdf(-0.1))
        want = np.log(ix * iy / 100.0)
        assert abs(m.log_evidence_laplace - want) < 0.02, \
            (m.log_evidence_laplace, want)

    def test_halfnorm_support_truncation(self):
        """One-sided priors (halfnorm: support [lo, inf)) must participate
        in the box truncation: a MAP at the boundary keeps only half the
        Gaussian mass. Previously only uniform/loguniform were truncated,
        overstating lnZ by up to ln 2 per such direction. Also pins the
        memoization (the Genz integral is unseeded quasi-MC — two property
        accesses must return the identical float)."""
        from victor_tpu.sampling.optimize import MAPResult
        from victor_tpu.sampling.priors import ParamSpace
        space = ParamSpace({'x': {'prior': {'dist': 'halfnorm', 'loc': 0.0,
                                            'scale': 10.0}}})
        m = MAPResult(space=space, theta=np.array([0.0]), lnpost=0.0,
                      lnlike=0.0, chi2=0.0, cov=np.array([[4.0]]),
                      grad_norm=0.0, n_starts=1, n_converged=1,
                      hessian_pd=True)
        want = 0.5 * np.log(2 * np.pi) + 0.5 * np.log(4.0) + np.log(0.5)
        first = m.log_evidence_laplace
        assert abs(first - want) < 1e-6, (first, want)
        assert m.log_evidence_laplace == first

    def test_degenerate_hessian_gives_nan_evidence(self):
        """A likelihood flat in one direction has a singular Hessian at the
        optimum; the eigenvalue-clipped Laplace covariance is PD by
        construction, so without the hessian_pd flag the saddle/degenerate
        case would silently quote a grossly inflated finite lnZ."""
        import jax.numpy as jnp
        from victor_tpu.sampling.optimize import find_map

        def loglike(params):
            chi2 = (params['x'] - 0.3) ** 2           # y unconstrained
            return -0.5 * chi2, chi2

        block = {'x': {'prior': {'dist': 'uniform', 'min': -5.0,
                                 'max': 5.0}},
                 'y': {'prior': {'dist': 'uniform', 'min': -5.0,
                                 'max': 5.0}}}
        m = find_map(loglike, block, n_starts=4, adam_steps=200,
                     newton_steps=4, seed=0)
        assert not m.hessian_pd
        assert np.isnan(m.log_evidence_laplace)
        # the sigmas themselves stay finite (indicative large values)
        assert all(np.isfinite(v) for v in m.std.values())

    def test_boss_laplace_evidence_tracks_quadrature(self, map_result):
        """On the BOSS posterior the Laplace evidence must land within a
        fraction of a nat of the ground truth: grid-quadrature logZ =
        278.967 on the boss_sampling_config priors, whose box differs from
        BLOCK_4P only in the sigma_v range (400 vs 550 wide) -> expected
        278.967 + ln(400/550) = 278.65 here (the ~3% of posterior sigma_v
        mass above 500 shifts this by +0.03, well inside the tolerance)."""
        lz = map_result.log_evidence_laplace
        assert np.isfinite(lz)
        assert abs(lz - 278.65) < 0.8, lz


class TestReferencePoint:
    def test_halfnorm_fiducial_is_prior_mean_not_support_edge(self):
        """A halfnorm sigma_v with loc=0 must get a strictly-interior
        fiducial (the prior mean loc + scale*sqrt(2/pi)), not the support
        edge 0 where the velocity-PDF division makes eval return -inf and
        forecast a NaN Jacobian."""
        import math

        from victor_tpu.__main__ import _reference_point
        from victor_tpu.sampling.priors import ParamSpace
        space = ParamSpace({
            'sigma_v': {'prior': {'dist': 'halfnorm', 'loc': 0.0,
                                  'scale': 300.0}},
            'amp': {'prior': {'dist': 'halfnorm', 'loc': 1.0, 'scale': 2.0},
                    'ref': {'dist': 'halfnorm', 'loc': 1.0, 'scale': 0.5}},
            'mu': {'prior': {'dist': 'norm', 'loc': 5.0, 'scale': 2.0}},
        })
        pt = _reference_point(space)
        assert pt['sigma_v'] == pytest.approx(300.0 * math.sqrt(2 / math.pi))
        assert pt['amp'] == pytest.approx(1.0 + 0.5 * math.sqrt(2 / math.pi))
        assert pt['mu'] == pytest.approx(5.0)    # norm: loc IS the mean


class TestForecastCLI:
    def test_cli_forecast_matches_library(self, capsys, tmp_path,
                                          boss_config):
        import json

        import yaml

        from victor_tpu.__main__ import main
        p = tmp_path / 'fc.yaml'
        cfg = dict(boss_config)
        cfg['params'] = BLOCK_4P
        p.write_text(yaml.safe_dump(cfg))
        main(['forecast', str(p), '--param', 'fsigma8=0.47'])
        out = json.loads(capsys.readouterr().out)
        assert set(out['sigma_fisher']) == set(BLOCK_4P)
        assert out['fiducial']['fsigma8'] == 0.47
        for sig in out['sigma_fisher'].values():
            assert np.isfinite(sig) and sig > 0
        # the fiducial sits at the ref locations, near the MAP, so the
        # forecast sigmas carry the known posterior scales and degeneracy
        assert 0.02 < out['sigma_fisher']['fsigma8'] < 0.15
        assert out['correlation']['fsigma8']['sigma_v'] > 0.4
        # every override is echoed (incl. names outside the params block,
        # where a typo would otherwise vanish silently)
        assert out['overrides'] == {'fsigma8': 0.47}

    def test_cli_forecast_rejects_derived_override(self, tmp_path,
                                                   boss_config):
        import yaml

        from victor_tpu.__main__ import main
        cfg = dict(boss_config)
        cfg['params'] = dict(BLOCK_4P)
        cfg['params']['fs8x'] = {'value': 'lambda fsigma8: 2 * fsigma8'}
        p = tmp_path / 'fc2.yaml'
        p.write_text(yaml.safe_dump(cfg))
        with pytest.raises(SystemExit, match='derived'):
            main(['forecast', str(p), '--param', 'fs8x=0.9'])


class TestFitCLI:
    @pytest.mark.slow
    def test_cli_fit_runs(self, capsys, tmp_path, boss_config):
        import json
        import yaml
        from victor_tpu.__main__ import main
        p = tmp_path / 'fit.yaml'
        cfg = dict(boss_config)
        cfg['params'] = BLOCK_4P
        p.write_text(yaml.safe_dump(cfg))
        cm = str(tmp_path / 'fit.covmat')
        main(['fit', str(p), '--starts', '4', '--adam-steps', '60',
              '--covmat-out', cm])
        out = json.loads(capsys.readouterr().out)
        assert out['chi2'] < 66.0
        assert set(out['best_fit']) == {'fsigma8', 'beta', 'sigma_v', 'epsilon'}
        # --covmat-out writes the Laplace covariance in cobaya format, with
        # diagonals matching the reported Laplace sigmas (fit -> `run
        # --covmat` seeding workflow)
        from victor_tpu.sampling.chains import read_covmat
        names = ['fsigma8', 'beta', 'sigma_v', 'epsilon']
        cov = read_covmat(cm, names)
        for i, n in enumerate(names):
            np.testing.assert_allclose(np.sqrt(cov[i, i]),
                                       out['std_laplace'][n], rtol=1e-4)


class TestAnalyzeCLI:
    @pytest.mark.slow
    def test_cli_analyze_writes_report_and_chains(self, capsys, tmp_path,
                                                  boss_config):
        """The one-command pipeline: MAP + SMC posterior/evidence ->
        report.md + GetDist chains + JSON summary (tiny settings; the
        report's headline is the central-68% credible interval — the
        calibrated reporting path)."""
        import json
        import os
        import yaml
        from victor_tpu.__main__ import main
        p = tmp_path / 'an.yaml'
        cfg = dict(boss_config)
        cfg['params'] = BLOCK_4P
        p.write_text(yaml.safe_dump(cfg))
        outdir = str(tmp_path / 'analysis')
        # starts/adam-steps match the map_result fixture's compiled graph
        # exactly, so in the full suite this test adds no new find_map
        # compile (the vmap width and scan length are part of the shape)
        main(['analyze', str(p), '--output', outdir, '--starts', '4',
              '--adam-steps', '120', '--particles', '48', '--moves', '2'])
        out = json.loads(capsys.readouterr().out)
        assert os.path.isfile(out['report'])
        report = open(out['report']).read()
        assert 'central 68%' in report and 'log Z' in report
        assert 'Goodness of fit' in report
        assert os.path.isfile(os.path.join(outdir, 'chains.1.txt'))
        # reproducibility snapshot of the analyzed config
        saved = yaml.safe_load(open(os.path.join(outdir, 'input.yaml')))
        assert saved['params'] == BLOCK_4P
        # figures: corner + data-vs-MAP multipoles, referenced from report.md
        assert sorted(os.path.basename(f) for f in out['figures']) == \
            ['corner.png', 'multipoles.png']
        for f in out['figures']:
            assert os.path.getsize(f) > 1000
        assert '![' in report and 'corner.png' in report
        for n in ('fsigma8', 'beta', 'sigma_v', 'epsilon'):
            lo, hi = out['posterior'][n]['central_68']
            assert lo < out['posterior'][n]['mean'] < hi
        # the BOSS model fits its own data: both adequacy measures should be
        # unremarkable (chi2 ~57/56 dof; ppp conservative by construction)
        assert 0.01 < out['p_value'] < 0.99
        assert 0.01 < out['posterior_predictive_p'] < 0.999


class TestPlotScanTool:
    def test_1d_and_2d_plots(self, tmp_path):
        import sys as _sys
        import os as _os
        _sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), '..',
                                          'tools'))
        import plot_scan
        x = np.linspace(-1, 1, 11)
        res1 = {'scan': ['a'], 'grid': [[v] for v in x],
                'delta_chi2': (4 * x ** 2).tolist()}
        out1 = plot_scan.plot_scan(res1, str(tmp_path / 's1.png'))
        assert _os.path.getsize(out1) > 3000
        g = np.stack(np.meshgrid(x, x, indexing='ij'), -1).reshape(-1, 2)
        res2 = {'scan': ['a', 'b'], 'grid': g.tolist(),
                'delta_chi2': (4 * (g ** 2).sum(1)).tolist()}
        out2 = plot_scan.plot_scan(res2, str(tmp_path / 's2.png'))
        assert _os.path.getsize(out2) > 3000
