"""Unit parity tests: victor_tpu.ops primitives vs scipy."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.interpolate import (InterpolatedUnivariateSpline, PchipInterpolator,
                               RectBivariateSpline)

from victor_tpu import ops


RNG = np.random.default_rng(1234)


class TestSpline1D:
    def setup_method(self, _):
        self.x = np.sort(RNG.uniform(0, 100, 31))
        self.y = RNG.normal(size=31)
        self.q = RNG.uniform(-10, 110, 5000)

    def test_clamped_matches_ius_ext3(self):
        spl = ops.Spline1D.build(self.x, clamp=True)
        got = np.asarray(spl(jnp.asarray(self.y), jnp.asarray(self.q)))
        want = InterpolatedUnivariateSpline(self.x, self.y, k=3, ext=3)(self.q)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)

    def test_extrapolating_matches_ius_ext0(self):
        spl = ops.Spline1D.build(self.x, clamp=False)
        got = np.asarray(spl(jnp.asarray(self.y), jnp.asarray(self.q)))
        want = InterpolatedUnivariateSpline(self.x, self.y, k=3, ext=0)(self.q)
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-8)

    @pytest.mark.parametrize('strategy', ['gather', 'masksum'])
    def test_nonfinite_queries_propagate_nan(self, strategy):
        """NaN queries must come out NaN under BOTH strategies (the masksum
        select used to return a finite-but-bogus 0, hiding invalid parameter
        points from the likelihood's NaN guard); inf with clamp=True
        follows ext=3 boundary clamping like scipy."""
        spl = ops.Spline1D.build(self.x, clamp=True)
        coeffs = spl.coeffs(jnp.asarray(self.y))
        q = jnp.asarray([np.nan, np.inf, -np.inf, 50.0])
        got = np.asarray(ops.ppoly_eval(spl.x, coeffs, q, clamp=True,
                                        strategy=strategy))
        assert np.isnan(got[0])
        ius = InterpolatedUnivariateSpline(self.x, self.y, k=3, ext=3)
        np.testing.assert_allclose(got[1], ius(self.x[-1]), rtol=1e-9)
        np.testing.assert_allclose(got[2], ius(self.x[0]), rtol=1e-9)
        np.testing.assert_allclose(got[3], ius(50.0), rtol=1e-9)

    def test_dynamic_eval_propagates_nan(self):
        from victor_tpu.ops.splines import cubic_coeffs_dynamic, ppoly_eval_dynamic
        x = jnp.asarray(np.sort(RNG.uniform(0, 100, 16)))
        y = jnp.asarray(RNG.normal(size=16))
        c = cubic_coeffs_dynamic(x, y)
        got = np.asarray(ppoly_eval_dynamic(x, c, jnp.asarray([np.nan, 50.0])))
        assert np.isnan(got[0]) and np.isfinite(got[1])

    def test_batched_values(self):
        Y = RNG.normal(size=(3, 31))
        spl = ops.Spline1D.build(self.x, clamp=True)
        coeffs = spl.coeffs(jnp.asarray(Y))
        assert coeffs.shape == (3, 30, 4)
        got = np.asarray(spl.eval(coeffs[1], jnp.asarray(self.q)))
        want = InterpolatedUnivariateSpline(self.x, Y[1], k=3, ext=3)(self.q)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)

    @pytest.mark.parametrize('strategy', ['gather', 'masksum'])
    def test_multichannel_eval_bit_identical(self, strategy):
        """K channels sharing a knot vector evaluate in one fused pass with
        per-channel floats bit-identical to separate single-channel calls
        (the hot path fuses the (v_r, dv_r) pair and the multipole stack)."""
        Y = RNG.normal(size=(3, 31))
        spl = ops.Spline1D.build(self.x, clamp=True)
        coeffs = spl.coeffs(jnp.asarray(Y))
        q2 = jnp.asarray(self.q.reshape(50, 100))   # multi-dim queries too
        fused = np.asarray(ops.ppoly_eval(spl.x, coeffs, q2, clamp=True,
                                          strategy=strategy))
        assert fused.shape == (3, 50, 100)
        for k in range(3):
            single = np.asarray(ops.ppoly_eval(spl.x, coeffs[k], q2,
                                               clamp=True, strategy=strategy))
            np.testing.assert_array_equal(fused[k], single)


class TestEvalMatrices:
    def test_spline_eval_matrix(self):
        x = np.linspace(0, 10, 25)
        q = RNG.uniform(-1, 11, 200)
        E = ops.spline_eval_matrix(x, q, ext=3)
        y = RNG.normal(size=25)
        np.testing.assert_allclose(
            E @ y, InterpolatedUnivariateSpline(x, y, k=3, ext=3)(q), atol=1e-11)

    def test_gradient_matrix(self):
        x = np.sort(RNG.uniform(0, 5, 40))
        G = ops.gradient_matrix(x)
        y = np.sin(x)
        np.testing.assert_allclose(G @ y, np.gradient(y, x), atol=1e-13)


class TestPchip:
    def test_matches_scipy_incl_extrapolation(self):
        x = np.linspace(0.15, 0.75, 31)
        Y = RNG.normal(size=(31, 2, 30))
        table = ops.PchipTable.build(x, Y)
        p = PchipInterpolator(x, Y, axis=0)
        for q in [0.15, 0.37, 0.4283, 0.75, 0.12, 0.80]:
            np.testing.assert_allclose(np.asarray(table(q)), p(q), atol=1e-12,
                                       err_msg=f'beta={q}')


class TestBicubic:
    def test_matches_rbs_ev_with_clamping(self):
        gx = np.linspace(3, 147, 25)
        gy = np.linspace(0, 1, 50)
        Z = np.cos(gx[:, None] / 20) * (1 + 0.3 * gy[None, :] ** 2)
        surf = ops.Bicubic2D.build(gx, gy, Z)
        rbs = RectBivariateSpline(gx, gy, Z)
        q = RNG.uniform(-5, 160, 3000)
        p = RNG.uniform(-1.2, 1.2, 3000)
        got = np.asarray(surf.ev(jnp.asarray(q), jnp.asarray(p)))
        want = rbs.ev(np.clip(q, gx[0], gx[-1]), np.clip(p, gy[0], gy[-1]))
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


class TestIntegrate:
    def test_simpson_avg_matches_old_scipy(self):
        import sys, os
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'tools'))
        from refshim import simps as old_simps
        for n in [49, 50, 51, 100]:
            x = np.linspace(-6, 6, n)
            y = np.exp(-x ** 2 / 2) * (1 + 0.3 * x)
            w = ops.simpson_weights(n, dx=x[1] - x[0])
            np.testing.assert_allclose(w @ y, old_simps(y, x=x), rtol=1e-13,
                                       err_msg=f'n={n}')

    def test_trapz_weights(self):
        x = np.sort(RNG.uniform(0, 1, 37))
        y = RNG.normal(size=37)
        np.testing.assert_allclose(ops.trapz_weights(x) @ y, np.trapezoid(y, x),
                                   rtol=1e-13)


class TestLegendre:
    @pytest.mark.parametrize('ell', [0, 1, 2, 3, 4, 6])
    def test_matches_scipy(self, ell):
        from scipy.special import legendre
        mu = np.linspace(-1, 1, 101)
        np.testing.assert_allclose(ops.legendre_p(ell, mu), legendre(ell)(mu),
                                   atol=1e-12)

    @pytest.mark.parametrize('ell', [5, 7, 8, 11, 12])
    def test_recurrence_orders_match_scipy(self, ell):
        """The reference accepts ANY order through scipy.special.legendre
        (victor/utils.py:53); the Bonnet-recurrence fallback must too —
        odd dipole/octupole analyses are valid reference workflows."""
        from scipy.special import eval_legendre
        mu = np.linspace(-1, 1, 101)
        np.testing.assert_allclose(ops.legendre_p(ell, mu),
                                   eval_legendre(ell, mu), atol=1e-12)
        with pytest.raises(ValueError):
            ops.legendre_p(-1, mu)

    def test_odd_multipole_transform(self):
        """multipoles_from_fn / fn_from_multipoles with odd ells (the
        previously-NotImplementedError path): mu^3 decomposes exactly as
        (3 P_1 + 2 P_3)/5, so a cubic-in-mu function has known odd
        multipoles and zero P_5 content."""
        from victor_tpu.utils.multipoles import (fn_from_multipoles,
                                                 multipoles_from_fn)
        r = np.linspace(10.0, 120.0, 30)
        g = np.exp(-r / 60.0)

        def f(rj, mu):
            return np.exp(-rj / 60.0) * (1.0 + 0.5 * mu + 0.2 * mu ** 3)

        mults = multipoles_from_fn(f, r, ell=[1, 3, 5], even=False,
                                   npts=4001)
        np.testing.assert_allclose(mults['1'], (0.5 + 0.12) * g, rtol=1e-6)
        np.testing.assert_allclose(mults['3'], 0.08 * g, rtol=1e-5)
        np.testing.assert_allclose(mults['5'], 0.0, atol=1e-5)  # trapz O(h^2)

        rec = fn_from_multipoles(r, [1, 3],
                                 np.stack([mults['1'], mults['3']]))
        mu = np.linspace(-0.9, 0.9, 21)
        got = np.asarray(rec(r, mu))               # (len(mu), len(r))
        want = (0.5 * mu[:, None] + 0.2 * mu[:, None] ** 3) * g[None, :]
        np.testing.assert_allclose(got, want, atol=2e-4)


class TestProjection:
    def test_multipole_projection_matches_reference_pipeline(self):
        """P @ xi_col must equal interp2d-cubic + 200-pt trapz (utils.py:9-58)."""
        import sys, os
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'tools'))
        import refshim
        refshim.install()
        sys.path.insert(0, '/root/reference')
        from victor import utils as ref_utils
        from refshim import interp2d

        s = np.linspace(2, 118, 30)
        mu = np.linspace(0, 1, 100)
        xi = np.exp(-s[None, :] / 40) * (1 - 0.5 * mu[:, None] ** 2) - 0.3
        xi += 0.01 * RNG.normal(size=xi.shape)
        xi_model = interp2d(s, mu, xi, kind='cubic')
        want = ref_utils.multipoles_from_fn(xi_model, s, [0, 2])
        P = ops.multipole_projection_matrix(mu, [0, 2])
        got = P @ xi
        np.testing.assert_allclose(got[0], want['0'], atol=1e-10)
        np.testing.assert_allclose(got[1], want['2'], atol=1e-10)


class TestSpecial:
    def test_hyp2f1_growth(self):
        from scipy.special import hyp2f1
        z = -np.linspace(0.01, 30, 50)
        got = np.asarray(ops.hyp2f1_growth(jnp.asarray(z)))
        want = hyp2f1(5 / 6, 3 / 2, 11 / 6, z)
        np.testing.assert_allclose(got, want, rtol=1e-10)

    def test_growth_factor_matches_reference_formula(self):
        from victor_tpu.models.cosmology import BackgroundCosmology
        cosmo = BackgroundCosmology({'Omega_m': 0.31})
        zs = np.array([0.0, 0.5, 0.57, 1.0, 2.0])
        got = np.asarray(ops.growth_factor_lcdm(jnp.asarray(zs), 0.31, 0.69))
        want = cosmo.growth_factor(zs)
        np.testing.assert_allclose(got, want, rtol=1e-10)


class TestStrategyChoice:
    @pytest.mark.parametrize('backend,want', [('cpu', 'gather'),
                                              ('gpu', 'masksum')])
    def test_default_strategy_per_backend(self, backend, want):
        """ppoly_eval's strategy when none is given: the measured
        end-to-end winner per backend (PERF.md)."""
        from victor_tpu.ops.splines import default_strategy
        assert default_strategy(backend) == want


class TestUtilsTransforms:
    """utils.multipoles_from_fn / fn_from_multipoles vs the reference."""

    def test_multipoles_from_fn_parity(self):
        import sys, os
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'tools'))
        import refshim
        refshim.install()
        from victor import utils as ref_utils
        from victor_tpu.utils import multipoles_from_fn
        r = np.linspace(5, 100, 12)

        def frmu(rr, mu):
            mu = np.atleast_1d(mu)
            return (np.exp(-rr / 40.0) * (1 + 0.3 * mu ** 2))[:, None]

        for even in (True, False):
            ref = ref_utils.multipoles_from_fn(frmu, r, ell=[0, 2, 4], even=even)
            got = multipoles_from_fn(frmu, r, ell=[0, 2, 4], even=even)
            for l in (0, 2, 4):
                np.testing.assert_allclose(got[f'{l}'], ref[f'{l}'],
                                           rtol=1e-10, atol=1e-15)

    def test_fn_from_multipoles_parity(self):
        import sys, os
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'tools'))
        import refshim
        refshim.install()
        from victor import utils as ref_utils
        from victor_tpu.utils import fn_from_multipoles
        rng = np.random.default_rng(2)
        r = np.linspace(5, 100, 15)
        mult = rng.standard_normal((2, 15))
        ref_fn = ref_utils.fn_from_multipoles(r, [0, 2], mult)
        got_fn = fn_from_multipoles(r, [0, 2], mult)
        q = np.linspace(6, 99, 9)
        m = np.linspace(-0.95, 0.95, 7)
        np.testing.assert_allclose(got_fn(q, m), ref_fn(q, m), rtol=1e-10)
        with pytest.raises(ValueError):
            fn_from_multipoles(r, [0, 2], mult[:1])


class TestChebyshev:
    """chebyshev_fit/eval back the dispersion-interior and fast-mode
    compressions (models/ccf_theory.py); the trig variant is the measured
    rejected alternative (see its docstring / BASELINE.md round 3)."""

    def _series(self):
        import jax.numpy as jnp
        from victor_tpu.ops.splines import chebyshev_fit
        fn = lambda r: -120.0 * (r / 30.0) * jnp.exp(-r / 35.0)  # noqa: E731
        a, b = 0.01, 120.0
        return fn, a, b, chebyshev_fit(fn, a, b, degree=48)

    def test_fit_interpolates(self):
        from victor_tpu.ops.splines import chebyshev_eval
        fn, a, b, coef = self._series()
        q = jnp.linspace(a, b, 777)
        np.testing.assert_allclose(np.asarray(chebyshev_eval(coef, a, b, q)),
                                   np.asarray(fn(q)), atol=5e-9)

    def test_trig_matches_clenshaw_inside_domain(self):
        from victor_tpu.ops.splines import chebyshev_eval, chebyshev_eval_trig
        _, a, b, coef = self._series()
        q = jnp.asarray(np.random.default_rng(0).uniform(a + 1e-3, b - 1e-3,
                                                         2000))
        np.testing.assert_allclose(
            np.asarray(chebyshev_eval_trig(coef, a, b, q)),
            np.asarray(chebyshev_eval(coef, a, b, q)), atol=1e-10)

    def test_trig_gradients_finite_at_clip(self):
        """d(arccos)/du is infinite at |u|=1; the eps-inset clip must keep
        gradients finite for queries at and beyond the domain edges."""
        import jax
        from victor_tpu.ops.splines import chebyshev_eval_trig
        _, a, b, coef = self._series()
        q = jnp.asarray([a - 5.0, a, 0.5 * (a + b), b, b + 10.0])
        g = jax.vmap(jax.grad(lambda x: chebyshev_eval_trig(coef, a, b, x)))(q)
        assert np.all(np.isfinite(np.asarray(g)))
        gc = jax.grad(lambda c: jnp.sum(chebyshev_eval_trig(c, a, b, q)))(coef)
        assert np.all(np.isfinite(np.asarray(gc)))
