"""End-to-end golden parity tests vs the reference implementation.

Fixtures are generated by tools/run_reference_baseline.py from the shimmed
reference, which reproduces the victor_usage_demo.ipynb cell-22 outputs
(streaming chi2=65.01 etc.) exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from victor_tpu.io import build_tables
from victor_tpu.models import ccf_theory as th
from victor_tpu.likelihood import core as lk

GOLDEN_PARAMS = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}


def jparams(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.fixture(scope='module')
def bundle(boss_config):
    return build_tables(boss_config['model'], boss_config['data'])


class TestTheoryStages:
    def test_velocity_terms(self, bundle, ref_fixtures):
        vr, dvr = th.velocity_terms(bundle.tables, bundle.spec, bundle.theory_opts,
                                    jparams(GOLDEN_PARAMS))
        np.testing.assert_allclose(np.asarray(vr), ref_fixtures['vel_vr'], atol=1e-10)
        np.testing.assert_allclose(np.asarray(dvr), ref_fixtures['vel_dvr'], atol=1e-12)

    def test_delta_profiles(self, bundle, ref_fixtures):
        d, D, _, _ = th.delta_profiles(bundle.tables, bundle.spec,
                                       bundle.theory_opts, jparams(GOLDEN_PARAMS))
        np.testing.assert_allclose(np.asarray(d), ref_fixtures['delta'], atol=1e-12)
        np.testing.assert_allclose(np.asarray(D), ref_fixtures['integrated_delta'],
                                   atol=1e-12)

    def test_real_multipoles_pchip(self, bundle, ref_fixtures):
        got = th.real_multipoles(bundle.tables, bundle.spec, jnp.asarray(0.37))
        np.testing.assert_allclose(np.asarray(got), ref_fixtures['real_mult_interp'],
                                   atol=1e-13)

    @pytest.mark.parametrize('key,opts_kw', [
        ('xi_smu', {}),
        # the exact-interior path reproduces the reference float-for-float;
        # the default 'chebyshev' interior is covered by
        # test_dispersion_chebyshev_interior_bound below
        ('xi_smu_dispersion', {'rsd_model': 'dispersion',
                               'dispersion_interior': 'exact'}),
        ('xi_smu_kaiser', {'rsd_model': 'kaiser'}),
        ('xi_smu_euclid', {'rsd_model': 'euclid_special'}),
        ('xi_smu_aniso', {'assume_isotropic': False}),
    ])
    def test_xi_smu(self, bundle, ref_fixtures, key, opts_kw):
        opts = bundle.theory_opts.replace(**opts_kw)
        xi = th.theory_xi_grid(bundle.tables, bundle.spec, opts, jparams(GOLDEN_PARAMS))
        np.testing.assert_allclose(np.asarray(xi), ref_fixtures[key], atol=1e-12)

    def test_dispersion_chebyshev_interior_bound(self, bundle):
        """The default dispersion path runs its interior Picard iterations on
        a Chebyshev compression of the velocity spline (final iteration
        exact). The contraction (~0.08/step) bounds its deviation from the
        all-exact loop below the reference's own 5-iteration convergence
        error; assert the documented bounds on xi, chi2 and lnL."""
        opts_c = bundle.theory_opts.replace(rsd_model='dispersion')
        opts_e = opts_c.replace(dispersion_interior='exact')
        p = jparams(GOLDEN_PARAMS)
        xi_c = th.theory_xi_grid(bundle.tables, bundle.spec, opts_c, p)
        xi_e = th.theory_xi_grid(bundle.tables, bundle.spec, opts_e, p)
        assert float(jnp.max(jnp.abs(xi_c - xi_e))) < 2e-5
        lnl_c, chi_c = lk.log_likelihood(bundle.tables, bundle.spec, opts_c,
                                         bundle.fit_opts, p)
        lnl_e, chi_e = lk.log_likelihood(bundle.tables, bundle.spec, opts_e,
                                         bundle.fit_opts, p)
        assert abs(float(chi_c) - float(chi_e)) < 1e-3
        assert abs(float(lnl_c) - float(lnl_e)) < 1e-3

    def test_dispersion_fast_final_bound(self, bundle):
        """Opt-in dispersion_final='fast': the jacobian reuses the final
        update's exact v_r (error ~ the fixed-point convergence error) and a
        degree-48 Chebyshev dv_r. Measured <=9e-6 on xi — below the default
        interior compression's own 2e-5 bound; assert the same bounds as
        the interior test, at the golden point and a displaced point."""
        opts_f = bundle.theory_opts.replace(rsd_model='dispersion',
                                            dispersion_final='fast')
        opts_e = bundle.theory_opts.replace(rsd_model='dispersion')
        for p in (GOLDEN_PARAMS,
                  {'fsigma8': 0.55, 'beta': 0.45, 'sigma_v': 320.0,
                   'epsilon': 1.05}):
            jp = jparams(p)
            xi_f = th.theory_xi_grid(bundle.tables, bundle.spec, opts_f, jp)
            xi_e = th.theory_xi_grid(bundle.tables, bundle.spec, opts_e, jp)
            assert float(jnp.max(jnp.abs(xi_f - xi_e))) < 2e-5
            lnl_f, chi_f = lk.log_likelihood(bundle.tables, bundle.spec,
                                             opts_f, bundle.fit_opts, jp)
            lnl_e, chi_e = lk.log_likelihood(bundle.tables, bundle.spec,
                                             opts_e, bundle.fit_opts, jp)
            # measured 2.2e-3 at the golden point: the smooth dv_r residual
            # cancels less in the multipole projection than the oscillatory
            # interior-Chebyshev one, so the chi2 bound is looser than the
            # interior test's 1e-3; posterior-level validation (BASELINE.md
            # round 3) is the operative accuracy gate for this mode
            assert abs(float(chi_f) - float(chi_e)) < 5e-3
            assert abs(float(lnl_f) - float(lnl_e)) < 5e-3

    def test_streaming_fast_bound(self, bundle):
        """Opt-in streaming_eval='fast': degree-48 Chebyshev compressions of
        v_r and the mu-independent sigma_v template. Measured xi deviation
        <= 2e-5 and chi2 shift ~1e-2 (the pdf mean/width are more sensitive
        than the dispersion jacobian, so the chi2 bound is looser);
        posterior-level validation is the operative gate (BASELINE.md)."""
        opts_f = bundle.theory_opts.replace(streaming_eval='fast')
        assert bundle.tables.sv_surf.y_const    # BOSS: isotropic template
        for p in (GOLDEN_PARAMS,
                  {'fsigma8': 0.55, 'beta': 0.45, 'sigma_v': 320.0,
                   'epsilon': 1.05}):
            jp = jparams(p)
            xi_f = th.theory_xi_grid(bundle.tables, bundle.spec, opts_f, jp)
            xi_e = th.theory_xi_grid(bundle.tables, bundle.spec,
                                     bundle.theory_opts, jp)
            assert float(jnp.max(jnp.abs(xi_f - xi_e))) < 3e-5
            lnl_f, chi_f = lk.log_likelihood(bundle.tables, bundle.spec,
                                             opts_f, bundle.fit_opts, jp)
            lnl_e, chi_e = lk.log_likelihood(bundle.tables, bundle.spec,
                                             bundle.theory_opts,
                                             bundle.fit_opts, jp)
            assert abs(float(chi_f) - float(chi_e)) < 3e-2
            assert abs(float(lnl_f) - float(lnl_e)) < 3e-2

    def test_theory_multipoles(self, bundle, ref_fixtures):
        m = th.theory_multipoles_grid(bundle.tables, bundle.spec,
                                      bundle.theory_opts, jparams(GOLDEN_PARAMS))
        np.testing.assert_allclose(np.asarray(m[0]), ref_fixtures['theory_mult_0'],
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(m[1]), ref_fixtures['theory_mult_2'],
                                   atol=1e-12)

    def test_theory_vector_and_datavector(self, bundle, ref_fixtures):
        tv = th.theory_vector(bundle.tables, bundle.spec, bundle.theory_opts,
                              jparams(GOLDEN_PARAMS))
        np.testing.assert_allclose(np.asarray(tv), ref_fixtures['theory_vector'],
                                   atol=1e-12)
        dv = lk.multipole_datavector(bundle.tables, bundle.spec, jnp.asarray(0.37))
        np.testing.assert_allclose(np.asarray(dv), ref_fixtures['data_vector'],
                                   atol=1e-13)

    def test_covariance_interpolation_quirk(self, bundle, ref_fixtures):
        """The endpoint-blend lerp (ccf_fit.py:226) must match exactly."""
        cov = lk.interpolated_covariance(bundle.tables, bundle.spec, jnp.asarray(0.37))
        np.testing.assert_allclose(np.asarray(cov), ref_fixtures['cov_interp'],
                                   atol=1e-15)
        icov = lk.interpolated_precision(bundle.tables, bundle.spec, jnp.asarray(0.37))
        np.testing.assert_allclose(np.asarray(icov), ref_fixtures['icov_interp'],
                                   atol=1e-10)


class TestLikelihoodGoldens:
    """The notebook cell-22 checkpoints and a wider option matrix."""

    def _check(self, bundle, opts, fit, params, want_chi2, want_lnl, tol=1e-8):
        lnl, chisq = lk.log_likelihood(bundle.tables, bundle.spec, opts, fit,
                                       jparams(params))
        assert abs(float(chisq) - want_chi2) < tol
        assert abs(float(lnl) - want_lnl) < tol

    def test_streaming_notebook_checkpoint(self, bundle):
        # victor_usage_demo.ipynb cell 22
        lnl, chisq = lk.log_likelihood(bundle.tables, bundle.spec,
                                       bundle.theory_opts, bundle.fit_opts,
                                       jparams(GOLDEN_PARAMS))
        assert abs(float(chisq) - 65.01) < 0.01
        assert abs(float(lnl) - 284.76) < 0.01

    @pytest.mark.parametrize('name,opts_kw,fit_kw,extra', [
        ('streaming', {}, {}, {}),
        ('dispersion', {'rsd_model': 'dispersion',
                        'dispersion_interior': 'exact'}, {}, {}),
        ('kaiser', {'rsd_model': 'kaiser'}, {}, {}),
        ('streaming_aniso', {'assume_isotropic': False}, {}, {}),
        ('beta_interp_likelihood', {}, {'beta_interpolation': 'likelihood'}, {}),
    ])
    def test_cell22_matrix(self, bundle, ref_fixtures, name, opts_kw, fit_kw, extra):
        names = [str(x) for x in ref_fixtures['golden_names']]
        i = names.index(name)
        self._check(bundle, bundle.theory_opts.replace(**opts_kw),
                    bundle.fit_opts.replace(**fit_kw),
                    {**GOLDEN_PARAMS, **extra},
                    ref_fixtures['golden_chi2'][i], ref_fixtures['golden_lnl'][i])

    @pytest.mark.parametrize('key,opts_kw,fit_kw,extra', [
        ('golden_euclid', {'rsd_model': 'euclid_special'}, {}, {}),
        ('golden_kaiser_MQ', {'rsd_model': 'kaiser'}, {}, {'M': 1.1, 'Q': 0.9}),
        ('golden_kaiser_approx', {'rsd_model': 'kaiser', 'kaiser_approximation': True}, {}, {}),
        ('golden_kaiser_noshift', {'rsd_model': 'kaiser', 'kaiser_coord_shift': False}, {}, {}),
        ('golden_form_gaussian', {}, {'form': 'gaussian'}, {}),
        ('golden_form_hartlap', {}, {'form': 'hartlap'}, {}),
        ('golden_form_percival', {}, {'form': 'percival'}, {}),
        ('golden_empirical_corr', {'empirical_corr': True}, {}, {'Av': 0.5}),
    ])
    def test_extended_matrix(self, bundle, ref_fixtures, key, opts_kw, fit_kw, extra):
        chi2, lnl = ref_fixtures[key]
        self._check(bundle, bundle.theory_opts.replace(**opts_kw),
                    bundle.fit_opts.replace(**fit_kw),
                    {**GOLDEN_PARAMS, **extra}, chi2, lnl)

    def test_beta_outside_data_grid_returns_neg_inf(self, bundle):
        """Likelihood-mode beta outside the data beta grid -> (-inf, +inf).

        Intent divergence from the reference, documented in PARITY.md: the
        reference indexes the data grid with an unclipped searchsorted result
        and crashes with IndexError (ccf_fit.py:389-390) when beta is above
        the grid; below the grid its t<0 silently extrapolates. The jit-safe
        branchless path maps both sides to the standard invalid-point
        sentinel (-inf, +inf) instead, which samplers treat as zero
        posterior mass.
        """
        fit = bundle.fit_opts.replace(beta_interpolation='likelihood')
        grid = np.asarray(bundle.tables.beta_ccf)
        for beta in (float(grid[-1]) + 0.05, float(grid[0]) - 0.05):
            lnl, chisq = lk.log_likelihood(
                bundle.tables, bundle.spec, bundle.theory_opts, fit,
                jparams({**GOLDEN_PARAMS, 'beta': beta}))
            assert float(lnl) == -np.inf
            assert float(chisq) == np.inf
        # just inside each edge stays finite
        for beta in (float(grid[0]) + 1e-4, float(grid[-1]) - 1e-4):
            lnl, _ = lk.log_likelihood(
                bundle.tables, bundle.spec, bundle.theory_opts, fit,
                jparams({**GOLDEN_PARAMS, 'beta': beta}))
            assert np.isfinite(float(lnl))

    def test_beta_on_grid_points_likelihood_mode(self, bundle):
        """Likelihood-mode beta exactly ON a grid point is valid and agrees
        with datavector mode (which has an is_exact shortcut). Regression:
        beta == grid[0] used to hit a 0/0 in the bracketing-interval t and
        the NaN guard converted the valid edge point to (-inf, +inf)."""
        fit_lk = bundle.fit_opts.replace(beta_interpolation='likelihood')
        fit_dv = bundle.fit_opts.replace(beta_interpolation='datavector')
        grid = np.asarray(bundle.tables.beta_ccf)
        for beta in (float(grid[0]), float(grid[-1]), float(grid[7])):
            p = jparams({**GOLDEN_PARAMS, 'beta': beta})
            lnl_lk, chi_lk = lk.log_likelihood(
                bundle.tables, bundle.spec, bundle.theory_opts, fit_lk, p)
            lnl_dv, chi_dv = lk.log_likelihood(
                bundle.tables, bundle.spec, bundle.theory_opts, fit_dv, p)
            assert np.isfinite(float(lnl_lk))
            assert abs(float(lnl_lk) - float(lnl_dv)) < 1e-8
            assert abs(float(chi_lk) - float(chi_dv)) < 1e-8

    def test_beta_gradient_finite_likelihood_mode(self, bundle):
        """Reverse-mode d lnL / d beta must be finite everywhere inside the
        grid (the unguarded 0/0 used to poison the whole gradient with NaN
        for out-of-bracket lanes under vmap)."""
        import jax

        fit = bundle.fit_opts.replace(beta_interpolation='likelihood')
        grid = np.asarray(bundle.tables.beta_ccf)

        def lnl(beta):
            p = jparams({**GOLDEN_PARAMS, 'beta': beta})
            return lk.log_likelihood(bundle.tables, bundle.spec,
                                     bundle.theory_opts, fit, p)[0]

        for beta in (float(grid[0]), 0.5 * (float(grid[3]) + float(grid[4])),
                     float(grid[-1])):
            g = jax.grad(lnl)(jnp.asarray(beta, dtype=jnp.float64))
            assert np.isfinite(float(g))

    def test_random_grid_50pts(self, bundle, ref_fixtures):
        gp = ref_fixtures['grid_params']
        for i in range(len(gp)):
            p = {'fsigma8': gp[i, 0], 'beta': gp[i, 1],
                 'sigma_v': gp[i, 2], 'epsilon': gp[i, 3]}
            self._check(bundle, bundle.theory_opts, bundle.fit_opts, p,
                        ref_fixtures['grid_chi2'][i], ref_fixtures['grid_lnl'][i],
                        tol=1e-9)


class TestPhysicalInvariances:
    def test_ap_rescaling_modes_agree_at_unity(self, bundle):
        """At epsilon=alpha=astar=1 the astar and mu-integral template
        rescalings are the same identity operation (ccf_model.py:606-613)."""
        p = jparams({'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0,
                     'epsilon': 1.0, 'astar': 1.0})
        a = th.theory_xi_grid(bundle.tables, bundle.spec,
                              bundle.theory_opts.replace(
                                  velocity_independent_of_AP=True), p)
        b = th.theory_xi_grid(bundle.tables, bundle.spec,
                              bundle.theory_opts.replace(
                                  velocity_independent_of_AP=False), p)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-10)

    def test_epsilon_equals_aperp_apar(self, bundle):
        """(aperp, apar) = (eps^(1/3), eps^(-2/3)) must reproduce the epsilon
        parameterisation exactly (ccf_model.py:589-596)."""
        eps = 1.05
        p1 = jparams({'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0,
                      'epsilon': eps})
        p2 = jparams({'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0,
                      'aperp': eps ** (1.0 / 3.0), 'apar': eps ** (-2.0 / 3.0)})
        a = th.theory_xi_grid(bundle.tables, bundle.spec, bundle.theory_opts, p1)
        b = th.theory_xi_grid(bundle.tables, bundle.spec, bundle.theory_opts, p2)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)


def test_separation_floor_keeps_line_of_sight_finite():
    """On the line of sight (s_perp = 0) r_par can cancel or underflow to
    zero in f32; the floored separation keeps r_par / rr, v_r / rr and the
    gradient finite, and leaves ordinary separations bit-identical."""
    import jax
    for dtype in (jnp.float32, jnp.float64):
        zero = jnp.zeros((), dtype)
        rr = th.separation(zero, zero)
        assert rr > 0 and np.isfinite(float(1.0 / rr))
        g = jax.grad(lambda r: th.separation(zero, r))(zero)
        assert np.isfinite(float(g))
        s_perp, r_par = jnp.asarray([3.0, 0.0], dtype), jnp.asarray([4.0, 1e-3], dtype)
        np.testing.assert_array_equal(np.asarray(th.separation(s_perp, r_par)),
                                      np.asarray(jnp.sqrt(s_perp ** 2 + r_par ** 2)))
