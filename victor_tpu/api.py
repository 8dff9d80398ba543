"""Class-based API with the reference victor surface (CCFModel / CCFFit).

A user of the reference package can construct these with the same `model:` /
`data:` config dicts and call the same methods with the same signatures
(victor/ccf_model.py:24, victor/ccf_fit.py:10). Internally everything routes
through the functional jit/vmap core, so single calls are device-accelerated
and the same object can hand out its `bundle` for batched/sampled use.

Inputs/outputs are numpy (host) for notebook ergonomics; per-call option
overrides accept the reference kwarg vocabulary and trigger a (cached)
retrace only when they change the computation's structure.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import FitOptions, TheoryOptions
from .errors import InputError
from .io.tables import CCFModelBundle, build_tables
from .likelihood import core as _lk
from .models import ccf_theory as _th
from . import ops

_THEORY_KEYS = set(TheoryOptions.__dataclass_fields__)
_FIT_KEYS = set(FitOptions.__dataclass_fields__)


def _split_kwargs(kwargs):
    opts_kw = {k: v for k, v in kwargs.items() if k in _THEORY_KEYS}
    fit_kw = {k: v for k, v in kwargs.items() if k in _FIT_KEYS}
    unknown = set(kwargs) - _THEORY_KEYS - _FIT_KEYS
    if unknown:
        raise InputError(f'Unrecognised option override(s): {sorted(unknown)}')
    return opts_kw, fit_kw


def _jp(params: Dict) -> Dict:
    return {k: jnp.asarray(v) for k, v in params.items()
            if not isinstance(v, (str, dict, list))}


class Interp2D:
    """Callable 2D interpolator with the old scipy.interp2d convention the
    reference returns from theory_xi_2D (victor/ccf_model.py:893): f(x, y)
    evaluates on the tensor grid and returns shape (len(y), len(x)).

    Default kind='linear' because that is scipy.interp2d's default and what
    the reference's bare `si.interp2d(sperp, spar, xi)` calls use
    (ccf_model.py:893,933) — node values are interpolation-free either way,
    but off-node queries must match the reference surface."""

    def __init__(self, x, y, z_yx, kind: str = 'linear'):
        from scipy.interpolate import RectBivariateSpline
        k = 3 if kind == 'cubic' else 1
        self._spl = RectBivariateSpline(np.asarray(x), np.asarray(y),
                                        np.asarray(z_yx).T, kx=k, ky=k, s=0)

    def __call__(self, x, y):
        x = np.atleast_1d(np.asarray(x, dtype=float))
        y = np.atleast_1d(np.asarray(y, dtype=float))
        return self._spl(x, y).T


class CCFModel:
    """Theory engine with the reference class surface (victor/ccf_model.py:24)."""

    def __init__(self, model: Dict, _bundle: Optional[CCFModelBundle] = None):
        self.model_config = model
        self.bundle = _bundle if _bundle is not None else build_tables(model, None)
        t = self.bundle.tables
        self.r = np.asarray(t.r)
        self.z_eff = float(t.z_eff)
        self.iaH = float(t.iaH)
        self.poles_r = list(self.bundle.spec.poles_r)
        self.fixed_real_input = self.bundle.spec.fixed_real_input

    # ------------------------------------------------------------------
    # jit caches
    # ------------------------------------------------------------------
    # NOTE: the tables pytree is always a jit *argument*, never a closure
    # constant — constant-embedding makes MLIR lowering read every array back
    # from the device and bakes the tables into the compiled program.
    # Caches are PER-INSTANCE dicts, not functools.lru_cache on the methods:
    # a class-level lru keyed on (self, opts) pins up to 64 instances — and
    # their device-resident table pytrees — alive after the caller drops
    # them (a per-mock CCFFit loop would leak HBM).
    def _memo(self, key, build):
        cache = self.__dict__.setdefault('_jit_fns', {})
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def _xi_points_fn(self, opts):
        def build():
            spec = self.bundle.spec
            jfn = jax.jit(lambda t, S, Mu, p:
                          _th.theory_xi_points(t, spec, opts, p, S, Mu))
            return functools.partial(jfn, self.bundle.tables)
        return self._memo(('xi_points', opts), build)

    def _xi_grid_fn(self, opts):
        def build():
            spec = self.bundle.spec
            jfn = jax.jit(lambda t, s, mu, p:
                          _th.theory_xi_grid(t, spec, opts, p, s=s, mu=mu))
            return functools.partial(jfn, self.bundle.tables)
        return self._memo(('xi_grid', opts), build)

    def _proj_matrix(self, poles: tuple):
        """Projection matrix + the mu grid xi must be evaluated on.

        Even poles project over mu in [0, 1] with factor 2l+1; any odd pole
        switches ALL requested poles to the full mu in [-1, 1] grid with
        factor (2l+1)/2, exactly as the reference does
        (victor/ccf_model.py:816-823) — projecting an odd P_ell against a
        [0, 1] evaluation would return the spurious nonzero half-integral
        instead of the ~0 a mu-even xi gives."""
        odd = any(ell % 2 for ell in poles)

        def build():
            if odd:
                mu = np.linspace(-1.0, 1.0,
                                 len(np.asarray(self.bundle.tables.mu_grid)))
            else:
                mu = np.asarray(self.bundle.tables.mu_grid)
            return (jnp.asarray(ops.multipole_projection_matrix(
                mu, list(poles), npts=200, even=not odd)), jnp.asarray(mu))
        return self._memo(('proj', poles), build)

    def _opts(self, kwargs) -> TheoryOptions:
        opts_kw, _ = _split_kwargs(kwargs)
        return self.bundle.theory_opts.replace(**opts_kw)

    # ------------------------------------------------------------------
    # reference API
    # ------------------------------------------------------------------
    def get_interpolated_real_multipoles(self, beta=None) -> np.ndarray:
        """(n_ell, n_r) real-space multipoles at beta (victor/ccf_model.py:299)."""
        t, spec = self.bundle.tables, self.bundle.spec
        if beta is None and not spec.fixed_real_input:
            raise InputError('Need to supply a valid value of beta for interpolation')
        b = jnp.asarray(0.0 if beta is None else beta)
        return np.atleast_2d(np.asarray(_th.real_multipoles(t, spec, b)))

    def delta_profiles(self, r, params: Dict, **kwargs):
        """(delta(r), Delta(r)) (victor/ccf_model.py:328-383).

        Node values are computed by the functional core at the r_v knots and
        interpolated to `r` with the same ext=3 cubic spline the reference
        uses downstream (exact at the knots)."""
        opts = self._opts(kwargs)
        t = self.bundle.tables
        d_rv, D_rv, _, _ = _th.delta_profiles(t, self.bundle.spec, opts,
                                              _jp(params))
        from scipy.interpolate import InterpolatedUnivariateSpline as IUS
        r_v = np.asarray(t.r_v)
        r = np.atleast_1d(np.asarray(r, dtype=float))
        return (IUS(r_v, np.asarray(d_rv), k=3, ext=3)(r),
                IUS(r_v, np.asarray(D_rv), k=3, ext=3)(r))

    def velocity_terms(self, r, params: Dict, **kwargs):
        """(v_r(r), dv_r/dr(r)) (victor/ccf_model.py:385-492); exact at the
        r_v knots, spline-interpolated elsewhere."""
        opts = self._opts(kwargs)
        t = self.bundle.tables
        vr, dvr = _th.velocity_terms(t, self.bundle.spec, opts, _jp(params))
        from scipy.interpolate import InterpolatedUnivariateSpline as IUS
        r_v = np.asarray(t.r_v)
        r = np.atleast_1d(np.asarray(r, dtype=float))
        return (IUS(r_v, np.asarray(vr), k=3, ext=3)(r),
                IUS(r_v, np.asarray(dvr), k=3, ext=3)(r))

    def theory_xi(self, s, mu, params: Dict, **kwargs):
        """xi^s at paired (s, mu) points of any matching shape
        (victor/ccf_model.py:538; the reference's rectangular-grid rebuild
        via np.unique — its bug 5 — is replaced by true pointwise support)."""
        opts = self._opts(kwargs)
        s_arr = np.atleast_1d(np.asarray(s, dtype=float))
        mu_arr = np.atleast_1d(np.asarray(mu, dtype=float))
        s_b, mu_b = np.broadcast_arrays(s_arr, mu_arr)
        fn = self._xi_points_fn(opts)
        out = fn(jnp.asarray(s_b.ravel()), jnp.asarray(mu_b.ravel()),
                 _jp(params))
        out = np.asarray(out).reshape(s_b.shape)
        return float(out[0]) if np.ndim(s) == 0 and np.ndim(mu) == 0 else out

    def theory_multipoles(self, s, params: Dict, poles=(0, 2), **kwargs):
        """Multipoles of the theory xi at radial bins `s`: dict keyed '0','2',...
        (victor/ccf_model.py:791-827)."""
        opts = self._opts(kwargs)
        poles = tuple(np.atleast_1d(poles).tolist())
        proj, mu_grid = self._proj_matrix(poles)
        s_arr = jnp.asarray(np.atleast_1d(np.asarray(s, dtype=float)))
        xi = self._xi_grid_fn(opts)(s_arr, mu_grid, _jp(params))
        mult = np.asarray(jnp.matmul(proj, xi, precision='highest'))
        return {f'{ell}': mult[i] for i, ell in enumerate(poles)}

    def theory_multipole_vector(self, s, params: Dict, poles=(0, 2), **kwargs):
        """Stacked multipole vector (victor/ccf_model.py:829-860)."""
        m = self.theory_multipoles(s, params, poles=poles, **kwargs)
        return np.concatenate([m[f'{ell}'] for ell in np.atleast_1d(poles)])

    def theory_xi_2D(self, params: Dict, rmax: float = 85, **kwargs) -> Interp2D:
        """2D xi^s(s_perp, s_par) interpolator (victor/ccf_model.py:862-894),
        computed in one vectorised dispatch instead of the reference's
        pointwise double loop."""
        sperp = np.linspace(0.01, rmax)
        spar = np.linspace(-rmax, rmax)
        PP, LL = np.meshgrid(sperp, spar)
        ss = np.sqrt(PP ** 2 + LL ** 2)
        mm = LL / ss
        xi = self.theory_xi(ss, mm, params, **kwargs)
        return Interp2D(sperp, spar, xi)

    def xi_2D_from_multipoles(self, params: Dict, rmax: float = 85, **kwargs) -> Interp2D:
        """2D ccf reconstructed from ell=0,2,4 multipoles
        (victor/ccf_model.py:896-934)."""
        from scipy.interpolate import InterpolatedUnivariateSpline as IUS
        s = np.linspace(0.01, rmax)
        mult = self.theory_multipoles(s, params, poles=(0, 2, 4), **kwargs)
        splines = {ell: IUS(s, mult[f'{ell}'], k=3) for ell in (0, 2, 4)}
        sperp = np.linspace(0.01, rmax)
        spar = np.linspace(-rmax, rmax)
        PP, LL = np.meshgrid(sperp, spar)
        ss = np.sqrt(PP ** 2 + LL ** 2)
        mm = LL / ss
        grid = np.zeros_like(ss)
        for ell in (0, 2, 4):
            grid += splines[ell](ss) * np.asarray(ops.legendre_p(ell, mm))
        return Interp2D(sperp, spar, grid)

    # ------------------------------------------------------------------
    # plotting (host-side matplotlib; victor/ccf_model.py:936-1041)
    # ------------------------------------------------------------------
    def plot_model_multipoles(self, *parameters, s=None, ell=2, diff=False,
                              ax=None, **kwargs):
        import matplotlib.pyplot as plt
        ax = ax or plt.gca()
        if s is None:
            s = self.r
        for params in parameters:
            options = params.get('options', {})
            label = params.get('label', None)
            plot_kwargs = params.get('plot_kwargs', {})
            theory = self.theory_multipoles(s, params, poles=ell, **options)[f'{ell}']
            ind = [0, 2, 4].index(ell)
            if diff:
                refth = np.interp(s, self.r, self.get_interpolated_real_multipoles(
                    params.get('beta', None))[ind])
            else:
                refth = np.zeros_like(theory)
            ax.plot(s, theory - refth, label=label, **plot_kwargs)
        ax.set_xlabel(kwargs.get('xlabel', r'$s\;[h^{-1}\mathrm{Mpc}]$'))
        ax.set_ylabel(kwargs.get('ylabel', ''))
        return ax

    def plot_realspace_multipoles(self, *parameters, r=None, ell=2, ax=None,
                                  **kwargs):
        import matplotlib.pyplot as plt
        ax = ax or plt.gca()
        if self.fixed_real_input and len(parameters) == 0:
            parameters = [{}]
        if r is None:
            r = self.r
        ind = [0, 2, 4].index(ell)
        for params in parameters:
            mult = np.interp(r, self.r, self.get_interpolated_real_multipoles(
                params.get('beta', None))[ind])
            ax.plot(r, mult, label=params.get('label', None),
                    **params.get('plot_kwargs', {}))
        ax.set_xlabel(kwargs.get('xlabel', r'$s\;[h^{-1}\mathrm{Mpc}]$'))
        ax.set_ylabel(kwargs.get('ylabel', ''))
        return ax


class CCFFit(CCFModel):
    """Likelihood layer with the reference class surface (victor/ccf_fit.py:10)."""

    def __init__(self, model: Dict, data: Dict,
                 _bundle: Optional[CCFModelBundle] = None):
        # _bundle: adopt an already-built table set instead of re-running
        # the host-side ingestion (same contract as CCFModel's _bundle —
        # the CLI's analyze figure path holds one already)
        bundle = _bundle if _bundle is not None else build_tables(model, data)
        super().__init__(model, _bundle=bundle)
        self.data_config = data
        t = bundle.tables
        self.s = np.asarray(t.s)
        self.poles_s = list(bundle.spec.poles_s)
        self.fixed_data = bundle.spec.fixed_data

    def _loglike_fn(self, opts, fit):
        def build():
            spec = self.bundle.spec
            jfn = jax.jit(lambda t, p: _lk.log_likelihood(t, spec, opts, fit, p))
            return functools.partial(jfn, self.bundle.tables)
        return self._memo(('loglike', opts, fit), build)

    def _chi2_fn(self, opts):
        def build():
            spec = self.bundle.spec
            jfn = jax.jit(lambda t, p: _lk.chi_squared(t, spec, opts, p))
            return functools.partial(jfn, self.bundle.tables)
        return self._memo(('chi2', opts), build)

    # ------------------------------------------------------------------
    def get_interpolated_redshift_multipoles(self, beta=None) -> np.ndarray:
        t, spec = self.bundle.tables, self.bundle.spec
        if beta is None and not spec.fixed_data:
            raise InputError('Need to supply a valid value of beta for interpolation')
        b = jnp.asarray(0.0 if beta is None else beta)
        dv = _lk.multipole_datavector(t, spec, b)
        return np.atleast_2d(np.asarray(dv).reshape(len(self.poles_s), len(self.s)))

    def multipole_datavector(self, beta=None) -> np.ndarray:
        t, spec = self.bundle.tables, self.bundle.spec
        if beta is None and not spec.fixed_data:
            raise InputError('Need to supply a valid value of beta for interpolation')
        b = jnp.asarray(0.0 if beta is None else beta)
        return np.asarray(_lk.multipole_datavector(t, spec, b))

    def get_interpolated_covariance(self, beta=None) -> np.ndarray:
        t, spec = self.bundle.tables, self.bundle.spec
        if beta is None and not spec.fixed_covmat:
            # reference ccf_fit.py:213-214; beta=0.0 would silently clamp
            # to the boundary covmat, giving wrong errors/correlations
            raise InputError('Need to supply a valid value of beta for interpolation')
        b = jnp.asarray(0.0 if beta is None else beta)
        return np.asarray(_lk.interpolated_covariance(t, spec, b))

    def get_interpolated_precision(self, beta=None) -> np.ndarray:
        t, spec = self.bundle.tables, self.bundle.spec
        if beta is None and not spec.fixed_covmat:
            raise InputError('Need to supply a valid value of beta for interpolation')
        b = jnp.asarray(0.0 if beta is None else beta)
        return np.asarray(_lk.interpolated_precision(t, spec, b))

    def correlation_matrix(self, beta=None) -> np.ndarray:
        """Normalised correlation matrix (victor/ccf_fit.py:262-284)."""
        cov = self.get_interpolated_covariance(beta)
        d = np.sqrt(np.diag(cov))
        return cov / np.outer(d, d)

    def diagonal_errors(self, beta=None) -> np.ndarray:
        """Per-bin errors from the covariance diagonal
        (victor/ccf_fit.py:286-304)."""
        cov = self.get_interpolated_covariance(beta)
        return np.sqrt(np.diag(cov)).reshape(len(self.poles_s), len(self.s))

    def chi_squared(self, params: Dict, **kwargs):
        """(chi2, covariance) (victor/ccf_fit.py:325-354)."""
        opts_kw, _ = _split_kwargs(kwargs)
        opts = self.bundle.theory_opts.replace(**opts_kw)
        chisq, cov = self._chi2_fn(opts)(_jp(params))
        if cov is None:
            # explicit beta_covariance='factored' override: the factored
            # path never materialises the blended covariance — rebuild it
            # here since this API promises to return it
            cov = self.get_interpolated_covariance(
                params.get('beta') if not self.bundle.spec.fixed_covmat
                else None)
        return float(chisq), np.asarray(cov)

    def log_likelihood(self, params: Dict, **kwargs):
        """(lnlike, chi2) (victor/ccf_fit.py:356-483)."""
        opts_kw, fit_kw = _split_kwargs(kwargs)
        opts = self.bundle.theory_opts.replace(**opts_kw)
        fit = self.bundle.fit_opts.replace(**fit_kw)
        lnl, chisq = self._loglike_fn(opts, fit)(_jp(params))
        return float(lnl), float(chisq)

    # ------------------------------------------------------------------
    def plot_multipole_comparison(self, *parameters, s=None, ell=2, diff=False,
                                  ax=None, **kwargs):
        """Data points with errors vs theory curves (victor/ccf_fit.py:485-584)."""
        import matplotlib.pyplot as plt
        ax = ax or plt.gca()
        if s is None:
            s = self.s
        ind = [0, 2, 4].index(ell)
        calculate_chi2 = kwargs.get('chi2', False)

        betas_plotted = set()
        for params in parameters:
            options = params.get('options', {})
            label = params.get('label', None)
            plot_kwargs = params.get('plot_kwargs', {})
            if calculate_chi2:
                chi2, _ = self.chi_squared(params, **options)
                label = (label + ' ' if label else '') + f'$\\chi^2={chi2:.2f}$'
            theory = self.theory_multipoles(s, params, poles=ell, **options)[f'{ell}']
            if diff:
                refth = np.interp(s, self.r, self.get_interpolated_real_multipoles(
                    params.get('beta', None))[ind])
            else:
                refth = np.zeros_like(theory)
            line = ax.plot(s, theory - refth, label=label, **plot_kwargs)

            beta_key = None if self.fixed_data else float(params['beta'])
            if beta_key not in betas_plotted:
                betas_plotted.add(beta_key)
                datam = self.get_interpolated_redshift_multipoles(
                    params.get('beta', None))[ind]
                errors = self.diagonal_errors(params.get('beta', None))[ind]
                if diff:
                    refd = np.interp(self.s, self.r,
                                     self.get_interpolated_real_multipoles(
                                         params.get('beta', None))[ind])
                else:
                    refd = np.zeros_like(datam)
                ax.errorbar(self.s, datam - refd, yerr=errors, fmt='o',
                            color=line[0].get_color(), markersize=4, capsize=2)
        ax.set_xlabel(kwargs.get('xlabel', r'$s\;[h^{-1}\mathrm{Mpc}]$'))
        ax.set_ylabel(kwargs.get('ylabel', ''))
        return ax
