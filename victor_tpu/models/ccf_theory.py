"""Functional CCF theory engine: real-space -> redshift-space mapping on device.

This is the jit/vmap-able re-design of the reference hot path
(victor/ccf_model.py:328-860). All tables/operators are precomputed
(victor_tpu/io/tables.py); a single evaluation is pure gathers + elementwise
math + small matmuls over a fixed (n_mu, n_s, n_v) grid, so thousands of
parameter points run per dispatch under `jax.vmap`.

RSD models: 'streaming' (Gaussian streaming, ccf_model.py:649-657),
'dispersion' (change-of-variables streaming with a fixed-point coordinate
solve, :658-671), 'kaiser' (incl. Hamaus M/Q nuisances, approximation and
coord-shift toggles, :692-741), 'euclid_special' (:743-784). AP dilation,
template rescaling (astar or the mu-integral factor), anisotropic real-space
input, and the `realspace_ccf_from_data` inverse-AP mode are all supported.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from ..config import TableSpec, TheoryOptions
from ..errors import InputError
from ..ops.legendre import legendre_p
# single implementation shared with ops.PchipTable (keeping one copy means
# a future fix cannot miss the other call site); re-exported for
# likelihood/core.py
from ..ops.splines import pchip_eval  # noqa: F401

SQRT2PI = 2.5066282746310002

# full-precision matmul: the operators are small, so the pin costs nothing,
# while XLA's default f32 matmul precision (TF32 on the GPU) would cost
# ~1e-2 on chi^2
from ..ops.splines import matmul_highest as _mm  # noqa: E402


def resolve_ap(params):
    """AP parameter resolution (victor/ccf_model.py:589-596)."""
    if 'epsilon' in params:
        epsilon = params['epsilon']
        apar = params.get('alpha', 1.0) * epsilon ** (-2.0 / 3.0)
        aperp = epsilon * apar
    else:
        aperp = params.get('aperp', 1.0)
        apar = params.get('apar', 1.0)
        epsilon = aperp / apar
    return epsilon, aperp, apar




def separation(s_perp, r_par):
    """Real-space separation sqrt(s_perp^2 + r_par^2), floored at
    sqrt(tiny) of the dtype (1.1e-19 in f32, 1.5e-154 in f64).

    On the line of sight (s_perp = 0) r_par can cancel exactly to zero, and
    the dispersion model's Picard updates shrink it geometrically towards
    zero at small separations, where f32 underflows (the GPU flushes
    subnormals to zero). A zero separation turns r_par / rr and v_r / rr
    into NaN or inf, and the likelihood's guard then rejects the whole
    parameter point. The floor keeps those ratios finite; it is far below
    any separation the model resolves, so float64 results are unchanged.
    The floor is applied to the squared separation, so the gradient stays
    finite there too.
    """
    r2 = s_perp ** 2 + r_par ** 2
    return jnp.sqrt(jnp.maximum(r2, jnp.finfo(r2.dtype).tiny))


def real_multipoles(tables, spec: TableSpec, beta):
    """Interpolated real-space multipoles (n_ell, n_r)
    (victor/ccf_model.py:299-326)."""
    if spec.fixed_real_input:
        return tables.real_mult_fixed
    return pchip_eval(tables.beta_grid, tables.real_mult_pchip_c, beta)


def delta_profiles(tables, spec: TableSpec, opts: TheoryOptions, params):
    """Matter-density monopole and its enclosed integral at the r_v and
    rgrid100 node sets (victor/ccf_model.py:328-383).

    Returns (delta_rv, Delta_rv, delta_100, Delta_100)."""
    if opts.matter_model == 'template':
        return (tables.delta_rv, tables.Delta_rv,
                tables.delta_r100, tables.Delta_r100)
    if opts.matter_model == 'linear_bias':
        bias = params.get('bias', tables.bias_default)
        if 'beta' not in params and not spec.fixed_real_input:
            # reference raises through get_interpolated_real_multipoles
            # (ccf_model.py:321-322); a 0.0 default would silently
            # extrapolate the beta-interpolated multipoles off the grid
            raise InputError('Need to supply a valid value of beta for '
                             'interpolation')
        beta = params.get('beta', jnp.asarray(0.0))
        y0 = real_multipoles(tables, spec, beta)[0]
        return (_mm(tables.lb_delta_op, y0) / bias, _mm(tables.lb_Delta_op, y0) / bias,
                _mm(tables.lb_delta100_op, y0) / bias, _mm(tables.lb_Delta100_op, y0) / bias)
    if opts.matter_model == 'excursion_set':
        from .excursion_set import esm_delta_profiles
        return esm_delta_profiles(tables, spec, opts, params)
    raise InputError(f'Invalid choice of matter_model {opts.matter_model}')


def velocity_terms(tables, spec: TableSpec, opts: TheoryOptions, params):
    """Mean radial velocity v_r and dv_r/dr at the r_v nodes
    (victor/ccf_model.py:385-492).

    Velocities are multiplied by the *true* 1/(aH); the sequential (non-elif)
    growth-term resolution of the reference is preserved."""
    _, _, apar = resolve_ap(params)
    iaH_true = tables.iaH * apar

    delta_rv, Delta_rv, delta_100, Delta_100 = delta_profiles(tables, spec, opts, params)

    growth_term = None
    if opts.matter_model == 'linear_bias':
        if opts.realspace_ccf_from_data:
            growth_term = params['beta'] * params.get('bias', tables.bias_default)
        else:
            growth_term = params['fsigma8'] / tables.template_sigma8
    if opts.matter_model == 'template':
        growth_term = params['fsigma8'] / tables.template_sigma8
    if opts.matter_model == 'excursion_set':
        growth_term = params['f']
    if opts.mean_model == 'template':
        growth_term = (params['fsigma8'] / tables.template_fsigma8) * \
            tables.template_hubble_ratio * tables.redshift_shift / apar

    r_v, r100 = tables.r_v, tables.rgrid100
    if opts.mean_model == 'linear':
        if not opts.empirical_corr:
            vr = -growth_term * r_v * Delta_rv / (3.0 * iaH_true)
            dvr = -growth_term * (delta_rv - 2.0 * Delta_rv / 3.0) / iaH_true
        else:
            Av = params.get('Av', 0.0)
            vr = -growth_term * r_v * Delta_rv * (1.0 + Av * delta_rv) / (3.0 * iaH_true)
            vr100 = -growth_term * r100 * Delta_100 * (1.0 + Av * delta_100) / (3.0 * iaH_true)
            dvr = _mm(tables.dvr_op, vr100)
    elif opts.mean_model == 'nonlinear':
        from .excursion_set import esm_velocity_terms
        vr, dvr = esm_velocity_terms(tables, spec, opts, params, growth_term,
                                     iaH_true, delta_rv, delta_100)
    elif opts.mean_model == 'template':
        if not spec.has_velocity_template:
            raise InputError('velocity_terms: Cannot use template option as no '
                             'template has been supplied.')
        vr = tables.vr_template_rv * growth_term
        dvr = _mm(tables.dvr_op, tables.vr_template_100 * growth_term)
    else:
        raise InputError(f'Invalid choice of mean_model {opts.mean_model}')

    return vr, dvr


def theory_xi_grid(tables, spec: TableSpec, opts: TheoryOptions, params,
                   s: Optional[jnp.ndarray] = None,
                   mu: Optional[jnp.ndarray] = None):
    """Redshift-space xi(s, mu) on the (n_mu, n_s) outer-product grid
    (victor/ccf_model.py:538-789)."""
    s = tables.s if s is None else s
    mu = tables.mu_grid if mu is None else mu
    n_mu, n_s = mu.shape[0], s.shape[0]
    S = jnp.broadcast_to(s[None, :], (n_mu, n_s)).reshape(-1)
    Mu = jnp.broadcast_to(mu[:, None], (n_mu, n_s)).reshape(-1)
    return theory_xi_points(tables, spec, opts, params, S, Mu).reshape(n_mu, n_s)


def theory_xi_points(tables, spec: TableSpec, opts: TheoryOptions, params,
                     S: jnp.ndarray, Mu: jnp.ndarray):
    """Redshift-space xi at paired scattered points (S, Mu), both flat (q,).

    The workhorse behind `theory_xi_grid` and the 2D-ccf API; replaces the
    reference's pointwise double loop (victor/ccf_model.py:889-892) with one
    vectorised evaluation."""
    # --- scalar parameter resolution ---
    if spec.fixed_real_input and opts.matter_model != 'linear_bias':
        beta = jnp.asarray(0.40)   # irrelevant in this case (ccf_model.py:583-585)
    else:
        beta = params['beta']
    epsilon, aperp, apar = resolve_ap(params)
    iaH_true = tables.iaH * apar

    # AP rescaling of templates (ccf_model.py:606-613)
    if opts.velocity_independent_of_AP:
        resc = params.get('astar', 1.0) * jnp.ones(())
    else:
        integrand = apar * jnp.sqrt(1.0 + (1.0 - tables.mu_ap ** 2) * (epsilon ** 2 - 1.0))
        resc = jnp.sum(tables.mu_ap_w * integrand)
    # excursion-set predicts the absolute scale: velocity templates unrescaled
    # (ccf_model.py:626-632)
    resc_vel = jnp.ones(()) if opts.matter_model == 'excursion_set' else resc

    # --- table-dependent coefficients ---
    y_mult = real_multipoles(tables, spec, beta)        # (n_ell, n_r)
    c_mult = tables.spline_mult.coeffs(y_mult)          # (n_ell, n_r-1, 4)
    vr, dvr = velocity_terms(tables, spec, opts, params)
    c_vr = tables.spline_vel.coeffs(vr)
    c_dvr = tables.spline_vel.coeffs(dvr)

    def vr_at(q):
        return tables.spline_vel.eval(c_vr, q / resc_vel)

    def dvr_at(q):
        return tables.spline_vel.eval(c_dvr, q / resc_vel) / resc_vel

    def vr_dvr_at(q):
        """(v_r, dv_r/dr) at the same points. The two splines evaluate
        separately so XLA fuses each pass independently: a fused
        two-channel masksum (stacked coefficients, shared interval masks)
        adds a channel axis that can break the broadcast+reduce fusion and
        materialise the (n-1, 2, n_v, q) intermediate in device memory."""
        return vr_at(q), dvr_at(q)

    # --- AP-corrected coordinates (ccf_model.py:641-644) ---
    # layout: the (mu, s) points form one flat trailing axis q (so the
    # minor dimension is large and padding is negligible); the
    # velocity-node axis, when present, leads: (n_v, q).
    needs_v = opts.rsd_model in ('streaming', 'dispersion')
    X = tables.x_nodes[:, None] if needs_v else None               # (n_v, 1)
    s_perp = S * jnp.sqrt(1.0 - Mu ** 2) * aperp
    s_par = S * Mu * apar
    s_true = jnp.sqrt(s_par ** 2 + s_perp ** 2)

    def xi_real(q_r, q_mu):
        """Real-space xi at (r, mu_r): rescaled template or data coordinates
        (ccf_model.py:616-621,673-687)."""
        if opts.realspace_ccf_from_data:
            r_eval = q_r           # splines on unrescaled reference r
        else:
            r_eval = q_r / resc    # splines on rescaled r == eval base at q/resc
        if opts.assume_isotropic:
            return tables.spline_mult.eval(c_mult[0], r_eval)
        # one fused multi-channel masksum over the shared multipole knots
        vals = tables.spline_mult.eval(c_mult, r_eval)     # (n_ell, ...)
        out = jnp.zeros_like(q_r)
        for i, ell in enumerate(spec.poles_r):
            out = out + vals[i] * legendre_p(ell, q_mu)
        return out

    def data_coords(r_par, s_perp):
        """Inverse-AP shift back to fiducial coordinates for data-derived
        real-space CCF (ccf_model.py:673-679)."""
        r_par_fid = r_par / apar
        r_perp_fid = s_perp / aperp
        rr = jnp.sqrt(r_par_fid ** 2 + r_perp_fid ** 2)
        return rr, r_par_fid / rr

    if needs_v:
        sigma_v = params.get('sigma_v', 380.0)
        v_par = X * sigma_v

        if opts.rsd_model == 'streaming':
            r_par = s_par - v_par * iaH_true
            rr = separation(s_perp, r_par)
            mu_r = r_par / rr
            if opts.streaming_eval == 'fast' and tables.sv_surf.y_const:
                # Throughput mode (streaming_eval='fast'): the two
                # 150k-point spline evaluations whose queries are smooth in
                # rr — v_r and the mu-independent sigma_v template —
                # evaluate on degree-48 Chebyshev compressions (~1.5x fewer
                # ops each than the 30-interval masksum, and the two
                # Clenshaw recurrences share rr). Same technique/degree as the
                # validated dispersion fast mode; bounds in
                # test_golden.py::test_streaming_fast_bound, posterior
                # validation in BASELINE.md round 3. mu-dependent sigma_v
                # surfaces (y_const=False) keep the exact bicubic — only
                # the 1D factor compresses losslessly enough.
                from ..ops.splines import chebyshev_eval, chebyshev_fit
                lo = tables.spline_vel.x[0] * resc_vel
                hi = tables.spline_vel.x[-1] * resc_vel
                coef_v = chebyshev_fit(vr_at, lo, hi, degree=48)
                slo = tables.sv_surf.x[0] * resc
                shi = tables.sv_surf.x[-1] * resc

                def sv_1d(q):
                    return tables.sv_surf.ev(q / resc, jnp.zeros_like(q))

                coef_s = chebyshev_fit(sv_1d, slo, shi, degree=48)
                mean = chebyshev_eval(coef_v, lo, hi, rr) * mu_r
                sv = sigma_v * chebyshev_eval(coef_s, slo, shi, rr)
            else:
                if opts.streaming_eval == 'fast':
                    # fast mode requested but the dispersion template is
                    # mu-dependent: only the 1D factor compresses losslessly
                    # enough, so the exact bicubic must run. Say so once per
                    # trace — silently measuring/validating the exact path
                    # while believing it is the fast one is worse than the
                    # lost speedup.
                    import logging
                    logging.getLogger('victor_tpu.theory').warning(
                        "streaming_eval='fast' ignored: the sigma_v surface "
                        'is mu-dependent (anisotropic dispersion template); '
                        'running the exact evaluation')
                sv = sigma_v * tables.sv_surf.ev(rr / resc, mu_r)
                mean = vr_at(rr) * mu_r
            vel_pdf = jnp.exp(-0.5 * ((v_par - mean) / sv) ** 2) / (SQRT2PI * sv)
            jacobian = 1.0
        else:  # dispersion
            # Fixed-point solve for the mean real-space coordinate
            # (victor/ccf_model.py:658-664). The Picard iteration contracts at
            # ~0.08/step on BOSS-like profiles, so the INTERIOR iterations only
            # need the velocity spline to ~1e-3: they use a degree-24 Chebyshev
            # compression (fit error 7e-4 relative on the BOSS velocity
            # profile; ~3x fewer ops than the 30-interval masksum), while
            # the FINAL iteration and all downstream quantities evaluate the
            # exact spline. The contraction bounds the end effect below both
            # f32 noise and the reference's own 5-iteration convergence error
            # (~1e-5 from the true fixed point): measured 1.7e-6 relative on
            # r_par at degree 32, ~2.4e-6 at the shipped degree 24; the
            # test_golden.py bound test asserts |xi| deviation < 2e-5 and
            # |chi2| < 1e-3 against the exact path at the shipped degree.
            from ..ops.splines import chebyshev_eval, chebyshev_fit
            lo = tables.spline_vel.x[0] * resc_vel
            hi = tables.spline_vel.x[-1] * resc_vel
            A = s_par - v_par * iaH_true
            if opts.niter == 0 or opts.dispersion_interior == 'exact':
                r_par = A / (1.0 + iaH_true * vr_at(s_true) / s_true)
                for _ in range(max(opts.niter - 1, 0)):
                    rr = separation(s_perp, r_par)
                    r_par = A / (1.0 + iaH_true * vr_at(rr) / rr)
                n_final = min(opts.niter, 1)   # niter=0: initial guess only
            else:
                coef = chebyshev_fit(vr_at, lo, hi, degree=24)

                def vr_fast(q):
                    return chebyshev_eval(coef, lo, hi, q)

                r_par = A / (1.0 + iaH_true * vr_fast(s_true) / s_true)
                for _ in range(opts.niter - 1):
                    rr = separation(s_perp, r_par)
                    r_par = A / (1.0 + iaH_true * vr_fast(rr) / rr)
                n_final = 1

            # final stage: the exact Picard update + the jacobian's
            # v_r/dv_r — the three exact spline passes of the dispersion
            # model (PERF.md times this stage on the GPU)
            if n_final:
                rr_prev = separation(s_perp, r_par)
                vr_prev = vr_at(rr_prev)               # exact final pass
                r_par = A / (1.0 + iaH_true * vr_prev / rr_prev)
            rr = separation(s_perp, r_par)
            mu_r = r_par / rr
            if n_final and opts.dispersion_final == 'fast':
                # At the converged fixed point |rr - rr_prev| is of the
                # order of the convergence error itself (~1e-5 relative),
                # so the final update's exact v_r(rr_prev) stands in for
                # v_r(rr) at error ~ dv_r*(rr-rr_prev) — SMALLER than the
                # interior Chebyshev error — and dv_r uses a degree-48
                # Chebyshev compression (the jacobian tolerates more dv_r
                # error than r_par tolerates v_r error, but degree 24
                # measured 3.7e-4 on xi vs 9e-6 at 48; Clenshaw-48 is still
                # ~1.5x fewer ops than the 30-interval masksum). Net effect
                # measured at <=9e-6 on xi — below the interior
                # compression's own 2e-5 bound
                # (test_dispersion_fast_final_bound).
                vr_rr = vr_prev
                coef_d = chebyshev_fit(dvr_at, lo, hi, degree=48)
                dvr_rr = chebyshev_eval(coef_d, lo, hi, rr)
            else:
                vr_rr = vr_at(rr)
                dvr_rr = dvr_at(rr)
            # 1 + iaH (mu^2 dv_r/dr + (1 - mu^2) v_r/r): written with
            # 1 - mu^2 = (s_perp/rr)^2 rather than as v_r/r - mu^2 v_r/r,
            # whose two large terms cancel on the line of sight at small
            # separations (f32 keeps nothing of them below rr ~ 1e-7)
            sin2 = (s_perp / rr) ** 2
            jacobian = 1.0 / (1.0 + iaH_true * ((1.0 - sin2) * dvr_rr
                                                + sin2 * vr_rr / rr))
            sv = sigma_v * tables.sv_surf.ev(rr / resc, mu_r)
            vel_pdf = jnp.exp(-0.5 * (v_par / sv) ** 2) / (SQRT2PI * sv)

        if opts.realspace_ccf_from_data:
            rr_eval, mu_eval = data_coords(r_par, s_perp)
        else:
            rr_eval, mu_eval = rr, mu_r
        xi_rmu = xi_real(rr_eval, mu_eval)

        # velocity integral: old-scipy simps(even='avg') weights on the fixed
        # 50-node grid, dv = sigma_v * dx (ccf_model.py:690)
        integrand = (1.0 + xi_rmu) * jacobian * vel_pdf
        xi_smu = sigma_v * jnp.einsum('vq,v->q', integrand, tables.vel_weights,
                                      precision='highest') - 1.0
        return xi_smu

    # --- kaiser / euclid_special: no velocity integral (ccf_model.py:692-784) ---
    M = params.get('M', 1.0)
    Q = params.get('Q', 1.0)
    if opts.kaiser_coord_shift:
        r_par = s_par / (1.0 + M * iaH_true * vr_at(s_true) / s_true)
        for _ in range(opts.niter):
            rr = separation(s_perp, r_par)
            r_par = s_par / (1.0 + M * iaH_true * vr_at(rr) / rr)
    else:
        # deliberately incorrect variant kept for reproducing published results
        # (ccf_model.py:704-707)
        r_par = s_par
    rr = separation(s_perp, r_par)
    mu_r = r_par / rr

    if opts.rsd_model == 'kaiser':
        vr_rr, dvr_rr = vr_dvr_at(rr)
        J = M * vr_rr * iaH_true / rr + \
            M * Q * mu_r ** 2 * iaH_true * (dvr_rr - vr_rr / rr)
    elif opts.rsd_model == 'euclid_special':
        vr_rr, dvr_rr = vr_dvr_at(rr)
        J = 3.0 * M * vr_rr * iaH_true / rr + \
            2.0 * M * Q * mu_r ** 2 * iaH_true * (dvr_rr - vr_rr / rr)
    else:
        raise InputError(f'theory_xi: Unrecognised choice of model {opts.rsd_model}')

    if opts.realspace_ccf_from_data:
        rr_eval, mu_eval = data_coords(r_par, s_perp)
    else:
        rr_eval, mu_eval = rr, mu_r
    xi_rmu = xi_real(rr_eval, mu_eval)

    if opts.rsd_model == 'kaiser':
        if not opts.kaiser_approximation:
            xi_smu = (1.0 + M * xi_rmu) / (1.0 + J) - 1.0
        else:
            xi_smu = M * xi_rmu - J
    else:
        xi_smu = M * xi_rmu - J
    return xi_smu


def theory_multipoles_grid(tables, spec: TableSpec, opts: TheoryOptions, params,
                           s: Optional[jnp.ndarray] = None):
    """Theory multipoles at the data s bins: (n_ell_s, n_s)
    (victor/ccf_model.py:791-827, with the bicubic-resample + 200-pt trapz
    projection folded into tables.proj)."""
    xi_smu = theory_xi_grid(tables, spec, opts, params, s=s)
    return _mm(tables.proj, xi_smu)


def theory_vector(tables, spec: TableSpec, opts: TheoryOptions, params,
                  s: Optional[jnp.ndarray] = None):
    """Stacked theory multipole vector of length n_ell_s * n_s
    (victor/ccf_model.py:829-860)."""
    mult = theory_multipoles_grid(tables, spec, opts, params, s=s)
    return mult.reshape(-1)
