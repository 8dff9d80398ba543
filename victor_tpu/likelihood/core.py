"""Likelihood evaluation: chi-squared + four likelihood forms, batched on device.

Functional parity with CCFFit (victor/ccf_fit.py:166-483), including:
  * PCHIP interpolation of the data vector over the reconstruction beta grid,
  * the reference's *exact* covariance interpolation semantics - boundary
    clamping, exact-grid-point shortcut, and the (1-t) C[low] + t C[END]
    endpoint-blend that the reference's `[0][-1]` index produces
    (ccf_fit.py:225-228,256-260) - the notebook goldens were produced with it,
  * the Gaussian / Hartlap / Sellentin / Percival forms (:415-473),
  * log-det normalisation when the covariance varies with beta (:398-413,
    445-453),
  * both 'datavector' and 'likelihood' beta-interpolation modes (:383-440),
  * branchless singular-covariance and NaN guards returning (-inf, +inf)
    (:400-410,447-450,477-481) so the whole thing stays jit/vmap-safe.

`log_likelihood` is pure; wrap in `jax.vmap` (see `batched.py`) to evaluate
thousands of parameter points per dispatch.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import FitOptions, TableSpec, TheoryOptions
from ..errors import InputError
from ..models.ccf_theory import pchip_eval, theory_vector


def multipole_datavector(tables, spec: TableSpec, beta):
    """Stacked redshift-space data vector (victor/ccf_fit.py:306-323)."""
    if spec.fixed_data:
        return tables.data_mult_fixed.reshape(-1)
    return pchip_eval(tables.beta_ccf, tables.data_mult_pchip_c, beta).reshape(-1)


def _interp_matrix_stack(grid, stack, beta):
    """The reference's covariance interpolation over the beta grid
    (victor/ccf_fit.py:195-260), reproduced branchlessly.

    Semantics: clamp outside the grid to the boundary matrix; return the grid
    matrix exactly at grid points; otherwise blend (1-t) * stack[low] +
    t * stack[-1] with t = (beta - grid[low]) / (grid[-1] - grid[low]) - the
    "high" index is the *last* grid point, reproducing `[0][-1]` at
    ccf_fit.py:226,258 which the shipped golden values depend on.
    """
    n = grid.shape[0]
    k = jnp.searchsorted(grid, beta, side='left', method='compare_all')  # first index with grid >= beta
    low = jnp.clip(k - 1, 0, n - 1)
    is_exact = grid[jnp.clip(k, 0, n - 1)] == beta
    # double-where the denominator: low == n-1 (beta above the grid) makes
    # it zero, and although the where-clamps below fix the primal, the
    # 0/0 -> 0*inf path poisons reverse-mode gradients with NaN (HMC
    # momenta / MAP steps silently NaN while the likelihood stays finite)
    denom = grid[n - 1] - grid[low]
    t = (beta - grid[low]) / jnp.where(denom == 0, 1.0, denom)
    out = (1.0 - t) * stack[low] + t * stack[n - 1]
    out = jnp.where(is_exact, stack[jnp.clip(k, 0, n - 1)], out)
    out = jnp.where(beta < grid[0], stack[0], out)
    out = jnp.where(beta > grid[-1], stack[-1], out)
    return out


def _use_factored(tables, spec: TableSpec, opts: TheoryOptions) -> bool:
    """Whether the 'factored' beta-covariance path applies: resolved mode
    (an unresolved 'auto' evaluates exact, like the other perf modes), a
    beta-varying covariance, and an available pencil factorization (the
    build emits None for degenerate/non-PD stacks)."""
    return (getattr(opts, 'beta_covariance', 'auto') == 'factored'
            and not spec.fixed_covmat
            and getattr(tables, 'cov_logdet', None) is not None)


def _factored_chi_squared(grid, icov_stack, diff, beta):
    """diff^T interp(C^-1) diff without materialising the blended matrix:
    contract diff against EVERY grid precision (batched matmuls — no
    per-eval (D, D) dynamic-slice gathers) and scalar-interpolate the
    quadratic forms with the reference's exact interpolation semantics
    (_interp_matrix_stack on a (n_b,) stack of scalars). Mathematically
    identical because the interpolation is linear in the matrix."""
    tmp = jnp.einsum('nij,j->ni', icov_stack, diff, precision='highest')
    q = jnp.einsum('ni,i->n', tmp, diff, precision='highest')
    return _interp_matrix_stack(grid, q, beta)


def _pencil_like_factor(grid, logdets, lam, beta):
    """-0.5 log det of the blended covariance via the build-time pencil
    factorization (io/tables.py:_pencil_precompute): O(D) per eval in
    place of the dense O(D^3) slogdet, with the same branchless
    clamp / exact-grid-point / endpoint-blend semantics as
    _interp_matrix_stack. Returns (factor, ok) like _like_factor; the
    blend is PD iff every (1-t) + t*lam_i > 0 (congruence inertia)."""
    n = grid.shape[0]
    k = jnp.searchsorted(grid, beta, side='left', method='compare_all')
    low = jnp.clip(k - 1, 0, n - 1)
    at_grid = grid[jnp.clip(k, 0, n - 1)] == beta
    denom = grid[n - 1] - grid[low]
    t = (beta - grid[low]) / jnp.where(denom == 0, 1.0, denom)
    s = (1.0 - t) + t * lam[low]
    pos = s > 0
    ld = logdets[low] + jnp.sum(jnp.log(jnp.where(pos, s, 1.0)))
    # overrides mirror _interp_matrix_stack: exact grid point and clamps
    # use the grid logdet directly (all grid slices are PD by construction
    # — _pencil_precompute refuses otherwise — so ok is True there)
    override = at_grid | (beta < grid[0]) | (beta > grid[-1])
    ld_override = jnp.where(at_grid, logdets[jnp.clip(k, 0, n - 1)],
                            jnp.where(beta < grid[0], logdets[0],
                                      logdets[n - 1]))
    ld = jnp.where(override, ld_override, ld)
    ok = jnp.where(override, jnp.asarray(True), jnp.all(pos))
    return -0.5 * ld, ok


def interpolated_covariance(tables, spec: TableSpec, beta):
    if spec.fixed_covmat:
        return tables.cov
    return _interp_matrix_stack(tables.beta_cov, tables.cov, beta)


def interpolated_precision(tables, spec: TableSpec, beta):
    if spec.fixed_covmat:
        return tables.icov
    return _interp_matrix_stack(tables.beta_cov, tables.icov, beta)


def chi_squared(tables, spec: TableSpec, opts: TheoryOptions, params):
    """(theory - data)^T C^-1 (theory - data); also returns the covariance used
    (victor/ccf_fit.py:325-354)."""
    if tables.cov is None:
        # trace-time guard: build_tables permits a covariance-less data
        # block (joint-fit quantiles supply the JOINT covariance instead,
        # likelihood/multiquantile.py) — using such a bundle through the
        # SINGLE-dataset likelihood would otherwise die in the einsum below
        # with an opaque NoneType trace error
        raise InputError('data block has no covariance_matrix: a '
                         'single-dataset likelihood needs one (only joint '
                         'quantiles: blocks may omit it, supplying the '
                         'joint covariance instead)')
    if 'beta' not in params and not (spec.fixed_data and spec.fixed_covmat):
        # trace-time check (params is a Python dict): the reference raises
        # here too (ccf_fit.py:389 'Need to supply a valid value of beta');
        # silently interpolating the beta-dependent data/covariance at the
        # 0.0 default would extrapolate far off the grid and return
        # garbage-but-finite likelihoods
        raise InputError('Need to supply a value of beta to interpolate the '
                         'beta-dependent data vector / covariance')
    tv = theory_vector(tables, spec, opts, params)
    beta = params.get('beta', jnp.asarray(0.0))
    dv = multipole_datavector(tables, spec, beta)
    diff = tv - dv
    if _use_factored(tables, spec, opts):
        # factored path: no blended covariance is materialised — callers
        # needing the log-det use _pencil_like_factor (log_likelihood does)
        chisq = _factored_chi_squared(tables.beta_cov, tables.icov, diff,
                                      beta)
        return chisq, None
    cov = interpolated_covariance(tables, spec, beta)
    icov = interpolated_precision(tables, spec, beta)
    # full matmul precision: XLA's default f32 dot precision (TF32 on the
    # GPU) would cost ~1e-2 on chi^2
    chisq = jnp.einsum('i,ij,j->', diff, icov, diff, precision='highest')
    return chisq, cov


def _like_factor(cov):
    """-0.5 log det C with a singular-covariance guard: returns (factor, ok)."""
    sign, logdet = jnp.linalg.slogdet(cov)
    ok = sign == 1
    return -0.5 * logdet, ok


def _cov_like_factor(tables, cov, beta):
    """like-factor dispatch: dense slogdet when chi_squared materialised the
    blended covariance (exact path), pencil logdet when the factored path
    skipped it (cov is None)."""
    if cov is None:
        return _pencil_like_factor(tables.beta_cov, tables.cov_logdet,
                                   tables.cov_pencil, beta)
    return _like_factor(cov)


def _apply_form(chisq, like_factor, fit: FitOptions, ndata: int):
    """The four likelihood forms (victor/ccf_fit.py:415-437,455-473)."""
    form = fit.form.lower()
    if form == 'sellentin':
        nmocks = fit.nmocks
        return -nmocks * jnp.log(1.0 + chisq / (nmocks - 1)) / 2.0 + like_factor
    if form == 'hartlap':
        nmocks = fit.nmocks
        a = (nmocks - ndata - 2) / (nmocks - 1)
        return -0.5 * chisq * a + like_factor
    if form == 'percival':
        nmocks = fit.nmocks
        if fit.nparams is None:
            raise InputError("likelihood form 'percival' requires nparams")
        nparams = fit.nparams
        B = (nmocks - ndata - 2) / ((nmocks - ndata - 1) * (nmocks - ndata - 4))
        m = nparams + 2 + (nmocks - 1 + B * (ndata - nparams)) / (1 + B * (ndata - nparams))
        return -m * jnp.log(1.0 + chisq / (nmocks - 1)) / 2.0 + like_factor
    if form == 'gaussian':
        return -0.5 * chisq + like_factor
    raise InputError('Unrecognised likelihood form')


def log_likelihood(tables, spec: TableSpec, opts: TheoryOptions,
                   fit: FitOptions, params):
    """(lnlike, chisq) at one parameter point (victor/ccf_fit.py:356-483)."""
    ndata = spec.n_s * len(spec.poles_s)

    if fit.beta_interpolation == 'likelihood' and not spec.fixed_data:
        # bracket beta on the data grid, evaluate chi^2 at both grid points and
        # linearly interpolate the log-likelihoods (ccf_fit.py:383-440)
        beta = params['beta']
        grid = tables.beta_ccf
        n = grid.shape[0]
        k = jnp.searchsorted(grid, beta, side='left', method='compare_all')  # first >= beta
        low = jnp.clip(k - 1, 0, n - 1)
        high = jnp.clip(k, 0, n - 1)
        # double-where the denominator (same hazard as _interp_matrix_stack):
        # low == high whenever beta <= grid[0] or beta > grid[-1], and the
        # bare 0/0 (a) returned (-inf, +inf) even at the VALID on-grid point
        # beta == grid[0] (NaN guard caught the 0/0) and (b) poisoned
        # reverse-mode gradients with NaN for every parameter. With the
        # guard, beta == grid[0] gives t = 0 -> the exact grid[0] likelihood;
        # out-of-grid betas get the explicit sentinel below.
        denom = grid[high] - grid[low]
        t = (beta - grid[low]) / jnp.where(denom == 0, 1.0, denom)
        p_low = dict(params); p_low['beta'] = grid[low]
        p_high = dict(params); p_high['beta'] = grid[high]
        chisq_low, cov_low = chi_squared(tables, spec, opts, p_low)
        chisq_high, cov_high = chi_squared(tables, spec, opts, p_high)

        if not spec.fixed_covmat:
            lf_low, ok_low = _cov_like_factor(tables, cov_low, grid[low])
            lf_high, ok_high = _cov_like_factor(tables, cov_high, grid[high])
            ok = ok_low & ok_high
        else:
            lf_low = lf_high = jnp.zeros(())
            ok = jnp.asarray(True)

        ln_low = _apply_form(chisq_low, lf_low, fit, ndata)
        ln_high = _apply_form(chisq_high, lf_high, fit, ndata)
        lnlike = (1.0 - t) * ln_low + t * ln_high
        chisq = (1.0 - t) * chisq_low + t * chisq_high
        # beta outside the data grid: the reference raises IndexError
        # (ccf_fit.py:389-390); the documented jit-safe intent fix is the
        # (-inf, +inf) sentinel (PARITY.md) — previously produced by the
        # accidental 0/0 NaN that the guard above removes, now explicit
        out_of_grid = jnp.logical_or(beta < grid[0], beta > grid[-1])
        lnlike = jnp.where(out_of_grid, -jnp.inf, lnlike)
        chisq = jnp.where(out_of_grid, jnp.inf, chisq)
    else:
        chisq, cov = chi_squared(tables, spec, opts, params)
        if not spec.fixed_covmat:
            lf, ok = _cov_like_factor(tables, cov,
                                      params.get('beta', jnp.asarray(0.0)))
        else:
            lf = jnp.zeros(())
            ok = jnp.asarray(True)
        lnlike = _apply_form(chisq, lf, fit, ndata)

    # guards: singular covariance or NaN -> (-inf, +inf) (ccf_fit.py:400-410,477-481)
    bad = jnp.logical_or(~ok, jnp.isnan(lnlike))
    lnlike = jnp.where(bad, -jnp.inf, lnlike)
    chisq = jnp.where(bad, jnp.inf, chisq)
    return lnlike, chisq
