"""Excursion-set model (ESM) void density profiles, fully on device.

JAX re-design of the reference ExcursionSetProfile
(victor/excursion_set_profile.py, Massara & Sheth arXiv:1811.03132 based):
the P(k) grid is the fixed 200-point log grid (excursion_set_profile.py:61),
all sj variance integrals are trapezoid contractions over it, and the
parameter-dependent Eulerian radius grid is handled with *dynamic-knot* cubic
splines (ops.cubic_coeffs_dynamic) so the whole profile is jit/vmap-able and
cosmological parameters (h, Omega_m, Omega_b, ns, sigma_8_0) can be sampled
on device in Eisenstein-Hu mode — replacing the reference's
lru_cache-per-cosmology CPU construction (victor/ccf_model.py:19-22).

CAMB mode ingests a precomputed (k, P(k, z=0), sigma8(0), sigma8(z)) table
(tools/make_camb_table.py) since CAMB itself is host-only Fortran; the EH
fallback mirrors excursion_set_profile.py:63-70.

Shell-crossing / NaN handling (excursion_set_profile.py:347-362): the
reference deletes NaN Eulerian radii and non-monotonic (shell-crossed) points
before splining. Here the same cleanup is a fixed-shape masked re-sort
(`_masked_monotone_interp`): in the regular regime (no shell crossing) it is
bit-identical to the reference; in the pathological regime dropped points are
moved past the evaluation range so the interpolant matches the reference's
intent without data-dependent shapes.

The nonlinear velocity pipeline implements the *intended* density_evolution
(the reference's is unreachable: `model_1halo` unbound at
excursion_set_profile.py:460 and `eulerian_model_profiles` undefined at :408).
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp

from ..ops.special import growth_factor_lcdm
from ..ops.splines import (cubic_coeffs_dynamic, gradient_nonuniform,
                           ppoly_eval_dynamic)
from .eisenstein_hu import (eisenstein_hu_params, power_eh, sigma80,
                            tophat_window)

TWO_PI2 = 2.0 * jnp.pi ** 2

# all k-integral contractions pin full precision: XLA's default f32 matmul
# precision (TF32 on the GPU) would silently degrade the s_j variances (and
# the finite-difference _s0_derivative_term built from their differences)
from ..ops.splines import matmul_highest as _mm_hi  # noqa: E402


# ---------------------------------------------------------------------------
# cosmology-dependent state
# ---------------------------------------------------------------------------

def esm_growth_factor(z, omega_m, omega_l):
    """D(z)/D(0) closed form (excursion_set_profile.py:106-119) —
    identical to ops.special.growth_factor_lcdm, kept as an alias so the
    closed form lives in exactly one place."""
    return growth_factor_lcdm(z, omega_m, omega_l)


# parameter defaults shared by the EH branch and the grid-interpolation
# branch (set_ESM_params, victor/ccf_model.py:494-536): an axis parameter
# a chain holds fixed must interpolate at the same value EH mode would use
_ESM_COSMO_DEFAULTS = {'H0': 67.5, 'Omega_m': 0.31, 'Omega_b': 0.048,
                       'ns': 0.96}


def _esm_grid_interp(tables, spec, params):
    """Multilinear interpolation of the cosmology-grid P(k) tables.

    The varying-cosmology CAMB mode (the role of the reference's per-tuple
    lru_cache CAMB rebuild, victor/excursion_set_profile.py:84-104, made
    device-evaluable): `tables.esm_pk_grid` holds log P(k, z=0) at every
    point of a small grid over the axes named in `spec.esm_grid_names`
    (e.g. H0/Omega_m/Omega_b/ns), flattened to (n_cells, nk); sigma8(0)
    and sigma8(z_eff) from the generator ride along as (n_cells,) tables.
    Interpolation is multilinear in the axes, linear in log P(k) (P(k) is
    log-smooth in cosmology over sampling-scale boxes), with values clamped
    to the grid hull. The 2^A-corner accumulation unrolls statically
    (A <= 4 -> <= 16 gathers of one row each — trivially small traced
    graph, CLAUDE.md rule 5).

    Returns (pk0, s80_fid, s8z_fid) — the un-normalised fiducial pieces
    esm_state rescales by (sigma_8_0 / s80_fid)^2.
    """
    import itertools

    axes, names = tables.esm_grid_axes, spec.esm_grid_names
    shape = tuple(int(g.shape[0]) for g in axes)
    los, ts = [], []
    for g, name in zip(axes, names):
        x = jnp.asarray(params.get(name, _ESM_COSMO_DEFAULTS.get(name, 0.0)))
        n = g.shape[0]
        if n == 1:      # singleton axis: no interpolation, weight-0 corner
            los.append(jnp.zeros((), jnp.int32))
            ts.append(jnp.zeros(()))
            continue
        kidx = jnp.searchsorted(g, x, side='left', method='compare_all')
        lo = jnp.clip(kidx - 1, 0, n - 2)
        t = (x - g[lo]) / (g[lo + 1] - g[lo])
        los.append(lo)
        ts.append(jnp.clip(t, 0.0, 1.0))    # clamp outside the grid hull
    logpk = jnp.zeros(tables.esm_pk_grid.shape[-1])
    s80 = jnp.zeros(())
    s8z = jnp.zeros(())
    for corner in itertools.product((0, 1), repeat=len(shape)):
        w = jnp.ones(())
        flat = jnp.zeros((), jnp.int32)
        for a, c in enumerate(corner):
            w = w * (ts[a] if c else 1.0 - ts[a])
            # singleton axes only ever contribute their c=0 corner (t=0
            # zeroes the c=1 weight); clip keeps the dead index in bounds
            flat = flat * shape[a] + jnp.minimum(los[a] + c, shape[a] - 1)
        logpk = logpk + w * tables.esm_pk_grid[flat]
        s80 = s80 + w * tables.esm_s80_grid[flat]
        s8z = s8z + w * tables.esm_s8z_grid[flat]
    return jnp.exp(logpk), s80, s8z


def esm_state(tables, spec, params):
    """Resolve the normalised z=0 power spectrum and growth for this call.

    Parameter defaults follow set_ESM_params (victor/ccf_model.py:494-536).
    Returns dict with k, kw (trapz weights), pk (normalised P(k, 0)), Dz,
    s8z (sigma8 at z_eff after normalisation), delta_c.
    """
    omm = params.get('Omega_m', _ESM_COSMO_DEFAULTS['Omega_m'])
    omk = params.get('Omega_k', 0.0)
    oml = 1.0 - omm - omk
    s80 = params.get('sigma_8_0', 0.81)
    k = tables.esm_k
    Dz = esm_growth_factor(tables.z_eff, omm, oml)
    if spec.esm_use_eh:
        h = params.get('H0', _ESM_COSMO_DEFAULTS['H0']) / 100.0
        omb = params.get('Omega_b', _ESM_COSMO_DEFAULTS['Omega_b'])
        ns = params.get('ns', _ESM_COSMO_DEFAULTS['ns'])
        p = eisenstein_hu_params(h, omm, omb, ns=ns, As=2e-9)
        pk0 = power_eh(p, k)
        s80_fid = sigma80(p)
        s8z_fid = s80_fid * Dz
    elif getattr(tables, 'esm_pk_grid', None) is not None:
        # varying-cosmology grid mode: shape-cosmology parameters on the
        # grid axes are sampleable with generator-grade (e.g. CAMB) P(k)
        pk0, s80_fid, s8z_fid = _esm_grid_interp(tables, spec, params)
    else:
        pk0 = tables.esm_pk0
        s80_fid = tables.esm_s80
        s8z_fid = tables.esm_s8z
    norm = (s80 / s80_fid) ** 2
    return {
        'k': k, 'kw': tables.esm_kw, 'pk': pk0 * norm, 'Dz': Dz,
        's8z': s8z_fid * jnp.sqrt(norm),
        'delta_c': params.get('delta_c', 1.686),
    }


# ---------------------------------------------------------------------------
# window functions and variance integrals (excursion_set_profile.py:159-214)
# ---------------------------------------------------------------------------

def _w_tophat(kr):
    """Spherical top-hat window; shares the AD-stable implementation with
    sigma80 (see eisenstein_hu.tophat_window for why plain AD of the
    formula NaNs f32 Hessians)."""
    return tophat_window(kr)


def _w_cut(k, R, Rx):
    return _w_tophat(k * R) * jnp.exp(-0.5 * (k * R / Rx) ** 2)


def _sj_pq(st, Rp, Rq, Rx, j=0):
    """Cross variance s_j^{pq}; Rq may be a vector -> returns its shape."""
    k, kw, pk = st['k'], st['kw'], st['pk']
    Rq = jnp.atleast_1d(Rq)
    integ = (k ** (2 + 2 * j) * pk * _w_cut(k, Rp, Rx))[None, :] * \
        _w_tophat(Rq[:, None] * k[None, :]) / TWO_PI2
    return _mm_hi(integ, kw)


def _sj_pp(st, Rp, Rx, j=0):
    """Auto variance s_j^{pp} (scalar)."""
    k, kw, pk = st['k'], st['kw'], st['pk']
    integ = k ** (2 + 2 * j) * pk * _w_cut(k, Rp, Rx) ** 2 / TWO_PI2
    return _mm_hi(integ, kw)


def _s0_derivative_term(st, Rp, Rq, Rx):
    """d s0_pq / d s0_pp by 5-point central differences
    (excursion_set_profile.py:206-214)."""
    step = 0.01 * Rp
    rp = Rp + jnp.asarray([-2.0, -1.0, 1.0, 2.0]) * step
    d_pq = (-_sj_pq(st, rp[3], Rq, Rx) + 8.0 * _sj_pq(st, rp[2], Rq, Rx)
            - 8.0 * _sj_pq(st, rp[1], Rq, Rx) + _sj_pq(st, rp[0], Rq, Rx)) / (12.0 * step)
    d_pp = (-_sj_pp(st, rp[3], Rx) + 8.0 * _sj_pp(st, rp[2], Rx)
            - 8.0 * _sj_pp(st, rp[1], Rx) + _sj_pp(st, rp[0], Rx)) / (12.0 * step)
    return d_pq / d_pp


def lagrangian_profile(st, Rq, b10, b01, Rp, Rx):
    """Excursion-set Lagrangian enclosed density (excursion_set_profile.py:216-237)."""
    return b10 * _sj_pq(st, Rp, Rq, Rx) + \
        b01 * 2.0 * _sj_pp(st, Rp, Rx) * _s0_derivative_term(st, Rp, Rq, Rx)


def eulerian_1halo(st, r_lagrange, b10, b01, Rp, Rx):
    """Spherical-evolution (1-halo) term + Eulerian radii
    (excursion_set_profile.py:239-278). Shell-crossed radii come out NaN."""
    DeltaL = lagrangian_profile(st, r_lagrange, b10, b01, Rp, Rx)
    dc = st['delta_c']
    one_halo = (1.0 - st['Dz'] * DeltaL / dc) ** (-dc) - 1.0
    r_euler = r_lagrange / (1.0 + one_halo) ** (1.0 / 3.0)
    return r_euler, one_halo


def eulerian_2halo(st, r_euler, Rp, Rx):
    """Void-motion (2-halo) term at Eulerian radii
    (excursion_set_profile.py:280-307); vectorised over r_euler (the
    reference loops in Python at :364-367)."""
    k, kw, pk = st['k'], st['kw'], st['pk']
    s0 = _sj_pp(st, Rp, Rx, j=0)
    s1 = _sj_pp(st, Rp, Rx, j=1)
    bv = 1.0 - k ** 2 * (s0 / s1)
    base = bv * _w_cut(k, Rp, Rx) * pk * k ** 2 / TWO_PI2
    integ = base[None, :] * _w_tophat(r_euler[:, None] * k[None, :])
    return _mm_hi(integ, kw)


# ---------------------------------------------------------------------------
# masked monotone cleanup + dynamic spline (fixed-shape shell-crossing repair)
# ---------------------------------------------------------------------------

def _masked_monotone_interp(r_euler, values, queries, clamp=False):
    """Interpolate (r_euler, values) at `queries` after the reference's
    NaN / shell-crossing cleanup (excursion_set_profile.py:347-362), with
    fixed shapes.

    Keep rule: a point survives iff it is finite and strictly below every
    later radius (reverse running minimum) — in the regular monotone regime
    this keeps everything and reproduces IUS(r_euler, values) exactly.
    Dropped points are re-sorted past the largest kept radius with constant
    value continuation, where they cannot influence in-range evaluation
    beyond spline end effects.
    """
    n = r_euler.shape[0]
    finite = jnp.isfinite(r_euler) & jnp.isfinite(values)
    key = jnp.where(finite, r_euler, jnp.inf)
    revmin_incl = jax.lax.associative_scan(jnp.minimum, key[::-1])[::-1]
    revmin_excl = jnp.concatenate([revmin_incl[1:],
                                   jnp.full((1,), jnp.inf, key.dtype)])
    keep = finite & (key < revmin_excl)

    order = jnp.argsort(jnp.where(keep, key, jnp.inf))
    re_s = key[order]
    val_s = values[order]
    n_keep = jnp.sum(keep)
    last = jnp.maximum(n_keep - 1, 0)
    last_re = re_s[last]
    last_val = val_s[last]
    i = jnp.arange(n)
    re_p = jnp.where(i < n_keep, re_s, last_re + (i - n_keep + 1.0))
    val_p = jnp.where(i < n_keep, val_s, last_val)

    coeffs = cubic_coeffs_dynamic(re_p, val_p)
    return ppoly_eval_dynamic(re_p, coeffs, queries, clamp=clamp)


# ---------------------------------------------------------------------------
# hooks consumed by the theory core
# ---------------------------------------------------------------------------

def enclosed_profile_at(tables, spec, params, queries):
    """Eulerian enclosed density Delta(r) at `queries`
    (model_enclosed_density_profile, excursion_set_profile.py:309-371)."""
    st = esm_state(tables, spec, params)
    b10, b01 = params['b10'], params['b01']
    Rp, Rx = params['Rp'], params['Rx']
    r_lag = tables.r_v
    r_euler, one_halo = eulerian_1halo(st, r_lag, b10, b01, Rp, Rx)
    two_halo = eulerian_2halo(st, r_euler, Rp, Rx)
    model_full = one_halo + st['Dz'] ** 2 * two_halo
    return _masked_monotone_interp(r_euler, model_full, queries, clamp=False)


def esm_delta_profiles(tables, spec, opts, params):
    """(delta_rv, Delta_rv, delta_100, Delta_100) for the theory core
    (victor/ccf_model.py:373-381 + the respline at :421-423)."""
    r_v = tables.r_v
    Delta_rv = enclosed_profile_at(tables, spec, params, r_v)
    deriv = gradient_nonuniform(Delta_rv, r_v)
    delta_rv = Delta_rv + r_v * deriv / 3.0
    # velocity_terms resplines the node values over r_v with ext=3 and
    # evaluates on the fine grid (ccf_model.py:421-423,456-459)
    c_d = tables.spline_vel.coeffs(delta_rv)
    c_D = tables.spline_vel.coeffs(Delta_rv)
    r100 = tables.rgrid100
    delta_100 = tables.spline_vel.eval(c_d, r100)
    Delta_100 = tables.spline_vel.eval(c_D, r100)
    return delta_rv, Delta_rv, delta_100, Delta_100


def density_evolution_at(tables, spec, params, queries, pairwise=False):
    """(1/f) dDelta/dln a at `queries` — the *intended* density_evolution
    (excursion_set_profile.py:412-486, reference implementation unreachable
    due to the unbound `model_1halo`; see module docstring)."""
    st = esm_state(tables, spec, params)
    b10, b01 = params['b10'], params['b01']
    Rp, Rx = params['Rp'], params['Rx']
    x = tables.esm_x50
    r_euler, dSph = eulerian_1halo(st, x, b10, b01, Rp, Rx)
    # clean, then work on the cleaned grid: derivative of the 1-halo term and
    # the 2-halo contribution are evaluated at the Eulerian radii
    dSph_q = _masked_monotone_interp(r_euler, dSph, queries, clamp=False)
    # derivative of the 1-halo interpolant: reference differentiates the
    # nodal values on the cleaned grid; evaluate via the same masked interp
    # of the gradient (exact in the regular regime)
    grad_nodes = gradient_nonuniform(dSph, r_euler)
    dSph_deriv_q = _masked_monotone_interp(r_euler, grad_nodes, queries,
                                           clamp=False)
    delta2_q = st['Dz'] * eulerian_2halo(st, queries, Rp, Rx)
    dc = st['delta_c']
    factor = 2.0 if pairwise else 1.0
    return dc * (1.0 + dSph_q + queries * dSph_deriv_q / 3.0) * \
        ((1.0 + dSph_q) ** (1.0 / dc) - 1.0) + factor * st['Dz'] * delta2_q


def esm_velocity_terms(tables, spec, opts, params, growth_term, iaH_true,
                       delta_rv, delta_100):
    """Nonlinear mean velocity from the ESM evolution term
    (victor/ccf_model.py:460-482). `growth_term` is f (params['f'])."""
    r_v, r100 = tables.r_v, tables.rgrid100
    # one density_evolution_at call over the concatenated query points: the
    # evolution term is pointwise in the queries, and a second call would
    # re-trace the whole ESM state / 1-halo / cleanup pipeline (trace time
    # dominates sampler wall-clock — CLAUDE.md)
    ld = density_evolution_at(tables, spec, params,
                              jnp.concatenate([r_v, r100]))
    ld_rv, ld_100 = ld[:r_v.shape[0]], ld[r_v.shape[0]:]
    if not opts.empirical_corr:
        vr = -growth_term * r_v * ld_rv / (3.0 * iaH_true * (1.0 + delta_rv))
    else:
        Av = params.get('Av', 0.0)
        vr = -growth_term * r_v * ld_rv * (1.0 + Av * delta_rv) / \
            (3.0 * iaH_true * (1.0 + delta_rv))
    # the reference's fine-grid derivative deliberately omits the empirical
    # correction factor (ccf_model.py:470-482) — reproduced for parity
    vr_100 = -growth_term * r100 * ld_100 / (3.0 * iaH_true * (1.0 + delta_100))
    dvr = _mm_hi(tables.dvr_op, vr_100)
    return vr, dvr


def esm_s8z(tables, spec, params):
    """sigma8(z_eff) after normalisation — the derived quantity the reference
    intends to expose as fsigma8 = f * s8z (victor/ccf_model.py:530-532,
    CCFLikelihood.py:40-42; broken there by the string-comparison bug)."""
    return esm_state(tables, spec, params)['s8z']


# ---------------------------------------------------------------------------
# class wrapper with the reference surface (victor/excursion_set_profile.py:6)
# ---------------------------------------------------------------------------

class ExcursionSetProfile:
    """Standalone class API mirroring the reference ExcursionSetProfile.

    Thin host-side wrapper over the functional pipeline above; profile
    methods return callables (evaluated on device per call), matching the
    reference's returned scipy interpolator ergonomics.
    `model_density_profile` and `density_evolution` implement the intended
    behaviour (both are broken/unreachable in the reference; SURVEY.md §2b).
    """

    def __init__(self, h, omega_m, omega_b, z=0, ns=0.965, omega_k=0,
                 mnu=0.06, npts=200, use_eisenstein_hu=True, camb_accuracy=1,
                 pk_table=None):
        import numpy as np
        from .. import ops as _ops

        self.omega_m = omega_m
        self.omega_b = omega_b
        self.omega_l = 1 - omega_m - omega_k
        self.z = z
        k = np.logspace(-4, np.log10(2), npts)
        tbl = dict(z_eff=jnp.asarray(float(z)), esm_k=jnp.asarray(k),
                   esm_kw=jnp.asarray(_ops.trapz_weights(k)),
                   esm_pk0=None, esm_s80=None, esm_s8z=None,
                   esm_x50=None)
        use_eh = use_eisenstein_hu
        if not use_eh and pk_table is not None:
            # resample onto this instance's k grid (the table may have been
            # generated with a different npts/kmax) — same cubic-spline
            # ingestion as io/tables.py
            from scipy.interpolate import InterpolatedUnivariateSpline as IUS
            tbl['esm_pk0'] = jnp.asarray(
                IUS(np.asarray(pk_table['k']), np.asarray(pk_table['pk0']),
                    k=3)(k))
            tbl['esm_s80'] = jnp.asarray(pk_table['sigma8_0'])
            tbl['esm_s8z'] = jnp.asarray(pk_table['sigma8_z'])
        elif not use_eh:
            # the reference prints a fallback warning when camb is absent
            # (excursion_set_profile.py:63-70); here the CAMB path is a
            # precomputed pk_table (tools/make_camb_table.py) — falling back
            # silently would hand out percent-level-different P(k)
            from ..utils.logging import get_logger
            get_logger('esm').warning(
                'use_eisenstein_hu=False requires pk_table= (generate one '
                'with tools/make_camb_table.py); falling back to the '
                'Eisenstein-Hu fitting formula')
            use_eh = True
        self._tables = types.SimpleNamespace(**tbl)
        self._spec = types.SimpleNamespace(esm_use_eh=use_eh)
        self._base = {'H0': h * 100.0, 'Omega_m': omega_m, 'Omega_b': omega_b,
                      'ns': ns, 'Omega_k': omega_k}
        st = esm_state(self._tables, self._spec,
                       {**self._base, 'sigma_8_0': 1.0})
        # fiducial (un-normalised) sigma8 values, reference attribute names
        if use_eh:
            p = eisenstein_hu_params(h, omega_m, omega_b, ns=ns, As=2e-9)
            self.s80_fiducial = float(sigma80(p))
            self.s8z_fiducial = self.s80_fiducial * float(st['Dz'])
        else:
            self.s80_fiducial = float(pk_table['sigma8_0'])
            self.s8z_fiducial = float(pk_table['sigma8_z'])
        self.normalisation = 1.0
        self._sigma8 = None
        self.use_eisenstein_hu = use_eh

    # -- reference methods ------------------------------------------------
    def growth_factor(self, z):
        return float(esm_growth_factor(jnp.asarray(float(z)), self.omega_m,
                                       self.omega_l))

    def set_normalisation(self, sigma8, z=0):
        if z == 0:
            self.normalisation = (sigma8 / self.s80_fiducial) ** 2
            self._sigma8 = sigma8
        else:
            self.normalisation = (sigma8 / self.s8z_fiducial) ** 2
            self._sigma8 = sigma8 * self.s80_fiducial / self.s8z_fiducial

    def _params(self, b10, b01, Rp, Rx, delta_c=1.686):
        s80 = self._sigma8 if self._sigma8 is not None else self.s80_fiducial
        return {k: jnp.asarray(v) for k, v in
                {**self._base, 'sigma_8_0': s80, 'b10': b10, 'b01': b01,
                 'Rp': Rp, 'Rx': Rx, 'delta_c': delta_c}.items()}

    def power(self, k, z):
        st = esm_state(self._tables, self._spec,
                       {**self._base,
                        'sigma_8_0': self.s80_fiducial})  # un-normalised
        import numpy as np
        from ..ops.splines import cubic_coeffs_dynamic, ppoly_eval_dynamic
        D = esm_growth_factor(jnp.asarray(float(z)), self.omega_m, self.omega_l)
        coeffs = cubic_coeffs_dynamic(st['k'], st['pk'])
        return np.asarray(ppoly_eval_dynamic(st['k'], coeffs,
                                             jnp.asarray(k)) * D ** 2)

    def model_enclosed_density_profile(self, r, z, b10, b01, Rp, Rx,
                                       delta_c=1.686):
        import numpy as np
        # snapshot the tables with this call's z: the returned callable must
        # not alias mutable instance state (the reference returns snapshot
        # scipy splines — a later call with a different z must not change
        # profiles handed out earlier)
        t = types.SimpleNamespace(**{**vars(self._tables),
                                     'z_eff': jnp.asarray(float(z))})
        params = self._params(b10, b01, Rp, Rx, delta_c)
        spec = self._spec
        r = np.atleast_1d(np.asarray(r, dtype=float))

        class _Profile:
            def __call__(_s, q):
                # reuse the module pipeline with r as the Lagrangian grid
                st = esm_state(t, spec, params)
                re_, oneh = eulerian_1halo(st, jnp.asarray(r), params['b10'],
                                           params['b01'], params['Rp'],
                                           params['Rx'])
                two = eulerian_2halo(st, re_, params['Rp'], params['Rx'])
                model = oneh + st['Dz'] ** 2 * two
                return np.asarray(_masked_monotone_interp(
                    re_, model, jnp.asarray(np.atleast_1d(q))))
        return _Profile()

    def model_density_profile(self, r, z, b10, b01, Rp, Rx, delta_c=1.686):
        import numpy as np
        enclosed = self.model_enclosed_density_profile(r, z, b10, b01, Rp, Rx,
                                                       delta_c)
        r = np.atleast_1d(np.asarray(r, dtype=float))
        vals = enclosed(r)
        deriv = np.gradient(vals, r)
        from scipy.interpolate import InterpolatedUnivariateSpline as IUS
        return IUS(r, vals + r * deriv / 3.0)

    def density_evolution(self, z, b10, b01, Rp, Rx, delta_c=1.686,
                          r_max=120, pairwise=False):
        import numpy as np
        # snapshot (see model_enclosed_density_profile): the returned fn
        # must keep THIS call's z and x-grid
        t = types.SimpleNamespace(
            **{**vars(self._tables),
               'z_eff': jnp.asarray(float(z)),
               'esm_x50': jnp.asarray(np.linspace(0.1, r_max, 50))})
        params = self._params(b10, b01, Rp, Rx, delta_c)
        spec = self._spec

        def fn(q):
            return np.asarray(density_evolution_at(
                t, spec, params, jnp.asarray(np.atleast_1d(q)),
                pairwise=pairwise))
        return fn
