"""Best-fit (MAP) and Laplace/Fisher error estimation.

The reference ecosystem gets point estimates from external minimizers
(cobaya's `minimize` sampler wrapping scipy/py-bobyqa over the same
likelihood; victor itself ships none). Here the posterior is differentiable
end-to-end on device (gradients cost ~1.2x a forward pass — BASELINE.md), so
the on-device equivalent is direct: vmapped multi-start Adam in the
unbounded reparameterisation, a damped-Newton polish with the exact
`jax.hessian`, and a Laplace covariance from the Hessian at the optimum.

The objective is the *physical-space* posterior density ln L(theta) +
ln pi(theta) (no reparameterisation Jacobian), so the reported point is the
conventional MAP / best fit, and for uniform priors exactly the maximum-
likelihood point; the sigmoid/log maps only keep iterates inside the prior
support (sampling/priors.py:210-240).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.logging import get_logger
from .priors import ParamSpace
from .targets import JitFnCache

log = get_logger('optimize')

_FIT_CACHE = JitFnCache()


@dataclasses.dataclass
class MAPResult:
    space: ParamSpace
    theta: np.ndarray              # (ndim,) best-fit point, physical space
    lnpost: float                  # ln L + ln prior at the optimum
    lnlike: float
    chi2: float
    cov: np.ndarray                # (ndim, ndim) Laplace covariance
    grad_norm: float               # |d lnpost / d theta| at the optimum
    n_starts: int
    n_converged: int               # starts that ended at a finite objective
    # whether the (pre-regularisation) Hessian at the optimum was positive
    # definite: find_map's |eigenvalue|-clipped inversion makes `cov` PD by
    # construction, so this flag is the ONLY record of indefiniteness —
    # log_evidence_laplace must not quote a saddle point as an evidence
    hessian_pd: bool = True

    @property
    def params(self) -> Dict[str, float]:
        return {p.name: float(self.theta[i])
                for i, p in enumerate(self.space.sampled)}

    @property
    def std(self) -> Dict[str, float]:
        sd = np.sqrt(np.clip(np.diag(self.cov), 0.0, np.inf))
        return {p.name: float(sd[i]) for i, p in enumerate(self.space.sampled)}

    @property
    def correlation(self) -> np.ndarray:
        sd = np.sqrt(np.clip(np.diag(self.cov), 1e-300, np.inf))
        return self.cov / np.outer(sd, sd)

    @property
    def log_evidence_laplace(self) -> float:
        """Laplace (saddle-point) approximation to the log-evidence:
        ln Z ~= ln post(MAP) + (d/2) ln 2pi + 1/2 ln det Sigma, with Sigma
        the Laplace covariance, TRUNCATED to the prior box: the Gaussian
        mass inside the bounded directions' box (correlations included —
        Genz quasi-MC via scipy's multivariate_normal.cdf) multiplies Z.
        Without the truncation a posterior with prior-pinned directions
        (sigma >> box, e.g. the 9-param ESM shape nuisances) overstates
        lnZ by several nats (measured +5.8 on the ESM fit vs SMC/NS), and
        the cheaper product-of-marginal-masses overcorrects when the
        pinned directions are correlated (measured -4.7 on the same fit);
        for a direction the likelihood doesn't constrain at all the
        truncation cancels the 1/2 ln 2 pi sigma^2 term exactly,
        recovering the uniform-prior contribution of 0.

        A free cross-check of the SMC/NS estimates for near-Gaussian
        posteriors with an interior MAP; NaN when the Hessian at the
        optimum was not positive definite (the eigenvalue-clipped `cov` is
        PD by construction, so the slogdet alone cannot tell a saddle from
        a maximum — quote the sampler evidence then).

        Memoized: the Genz integral is quasi-MC (unseeded in scipy), so
        recomputing on every property access would cost a QMC pass each
        time AND could print two slightly different values in one report."""
        cached = getattr(self, '_lnz_laplace', None)
        if cached is None:
            cached = self._compute_log_evidence_laplace()
            object.__setattr__(self, '_lnz_laplace', cached)
        return cached

    def _compute_log_evidence_laplace(self) -> float:
        from scipy.stats import multivariate_normal as _mvn
        if not self.hessian_pd:
            return float('nan')
        sign, logdet = np.linalg.slogdet(self.cov)
        if sign <= 0 or not np.isfinite(logdet):
            return float('nan')
        d = self.cov.shape[0]
        lnz = self.lnpost + 0.5 * d * np.log(2.0 * np.pi) + 0.5 * logdet
        lo, hi = self.space.bounds()
        lo = np.asarray(lo, dtype=np.float64)
        hi = np.asarray(hi, dtype=np.float64)
        # every direction with a finite support edge participates in the
        # truncation (uniform/loguniform boxes AND the one-sided halfnorm
        # support [lo, inf) — the evidence integrand is zero outside the
        # prior support regardless of the prior's shape inside it);
        # mvn.cdf accepts +/-inf limits for the unbounded sides
        idx = [i for i in range(d)
               if np.isfinite(lo[i]) or np.isfinite(hi[i])]
        if idx:
            sub = np.ix_(idx, idx)
            try:
                mass = float(_mvn.cdf(
                    hi[idx], mean=self.theta[idx], cov=self.cov[sub],
                    lower_limit=lo[idx]))
            except (ValueError, np.linalg.LinAlgError):
                return float('nan')
            if not np.isfinite(mass) or mass <= 0.0:
                return float('nan')
            lnz += np.log(min(mass, 1.0))
        return float(lnz)

    def summary(self) -> Dict[str, Dict[str, float]]:
        sd = self.std
        return {name: {'value': val, 'std': sd[name]}
                for name, val in self.params.items()}


def _damped_newton_step(obj, y):
    """One Levenberg-damped Newton step on scalar objective obj(y).

    Rejects non-finite or non-improving steps (returns y unchanged). Shared
    by find_map's polish and profile_scan's per-grid-point refinement so the
    damping floor / acceptance rule cannot silently diverge between them."""
    g = jax.grad(obj)(y)
    H = jax.hessian(obj)(y)
    # Levenberg damping keeps the step well-posed when H is not PD
    lam = 1e-6 * jnp.maximum(jnp.trace(H) / y.shape[0], 1.0)
    dy = jnp.linalg.solve(H + lam * jnp.eye(y.shape[0]), g)
    y_new = y - dy
    ok = jnp.isfinite(y_new).all() & (obj(y_new) < obj(y))
    return jnp.where(ok, y_new, y)


def _make_objectives(bundle, space: ParamSpace, opts_kw, fit_kw):
    """(tables_arg, lnpost(theta), neg-lnpost(y), (lnlike, chi2)(theta),
    cache_id) for a target `bundle` — CCFModelBundle, JointBundle, or a
    callable params-dict -> (lnlike, aux) like run_smc accepts."""
    from .targets import resolve_target

    tables_arg, loglike, cache_id = resolve_target(bundle, opts_kw, fit_kw)

    def lnpost_theta(tbl, theta):
        params = space.full_params(theta)
        lnl, _ = loglike(tbl, params)
        total = lnl + space.log_prior(theta)
        return jnp.where(jnp.isfinite(total), total, -jnp.inf)

    def neg_lnpost_y(tbl, y):
        return -lnpost_theta(tbl, space.to_bounded(y))

    def like_stats(tbl, theta):
        return loglike(tbl, space.full_params(theta))

    return tables_arg, lnpost_theta, neg_lnpost_y, like_stats, cache_id


def find_map(bundle, params_block: Dict,
             n_starts: int = 32, adam_steps: int = 250,
             newton_steps: int = 8, learning_rate: float = 0.05,
             seed: int = 0, opts_kw: Optional[Dict] = None,
             fit_kw: Optional[Dict] = None) -> MAPResult:
    """Multi-start MAP + Laplace covariance.

    Stage 1: `n_starts` points drawn from the params block's ref/prior
    distributions descend in parallel (one vmapped Adam scan, a single
    device dispatch). Stage 2: the best endpoint is polished with damped
    Newton using the exact posterior Hessian. Stage 3: the Laplace
    covariance inv(-H) at the optimum, in physical parameter space.

    Accepts a single-dataset CCFModelBundle or a multi-quantile JointBundle,
    like run_mcmc / run_hmc_mcmc.
    """
    import optax

    space = ParamSpace(params_block)
    tables_arg, lnpost_theta, neg_y, like_stats, cache_id = _make_objectives(
        bundle, space, opts_kw, fit_kw)

    # the sampled tuple is deliberately NOT sorted: parameter ORDER is
    # semantic (the cached closures bake in the theta-component layout of
    # THIS space, while the caller's space supplies theta0 and decodes the
    # result). Sorting here once collided a hand-ordered params block with
    # its alphabetised YAML round-trip: same key, different layouts ->
    # the optimum decoded with scrambled components (chi2 jumped 6 orders
    # of magnitude, found by the analyze-CLI GOF assertion).
    cache_key = (cache_id, tuple((p.name, p.dist, p.lo, p.hi)
                                 for p in space.sampled),
                 tuple(sorted(space.fixed.items())),
                 tuple((d.name, d.argnames, d.src) for d in space.derived),
                 n_starts, adam_steps, learning_rate)
    fns = _FIT_CACHE.setdefault(cache_key, {})

    if 'adam' not in fns:
        opt = optax.adam(learning_rate)

        def adam_run(tbl, y0):
            def one(y_init):
                def step(carry, _):
                    y, st = carry
                    val, g = jax.value_and_grad(lambda yy: neg_y(tbl, yy))(y)
                    g = jnp.where(jnp.isfinite(g), g, 0.0)
                    upd, st = opt.update(g, st, y)
                    return (optax.apply_updates(y, upd), st), val
                (yf, _), _ = jax.lax.scan(step, (y_init, opt.init(y_init)),
                                          None, length=adam_steps)
                return yf, neg_y(tbl, yf)
            return jax.vmap(one)(y0)

        fns['adam'] = jax.jit(adam_run)

        fns['newton'] = jax.jit(
            lambda tbl, y: _damped_newton_step(lambda yy: neg_y(tbl, yy), y))
        fns['laplace'] = jax.jit(lambda tbl, th: (
            jax.hessian(lambda t: -lnpost_theta(tbl, t))(th),
            jax.grad(lambda t: lnpost_theta(tbl, t))(th)))
        fns['grad_theta'] = jax.jit(
            lambda tbl, th: jax.grad(lambda t: lnpost_theta(tbl, t))(th))
        fns['stats'] = jax.jit(like_stats)

    key = jax.random.PRNGKey(seed)
    theta0 = space.sample_ref(key, n_starts)
    y0 = space.to_unbounded(theta0)

    ys, vals = fns['adam'](tables_arg, y0)
    vals = np.asarray(vals)
    finite = np.isfinite(vals)
    if not finite.any():
        raise RuntimeError('find_map: every start diverged; check the priors '
                           'and ref distributions in the params block')
    best = int(np.nanargmin(np.where(finite, vals, np.inf)))
    y = ys[best]
    for _ in range(newton_steps):
        y = fns['newton'](tables_arg, y)

    theta = space.to_bounded(y)
    H, g = fns['laplace'](tables_arg, theta)
    H = np.asarray(H, dtype=np.float64)
    if not np.all(np.isfinite(H)):
        # Defensive fallback: should no longer trigger for the shipped
        # models — the one known f32 second-order failure (quotient-rule
        # overflow in the spherical top-hat window's nested AD) is fixed at
        # the source with a custom derivative rule
        # (eisenstein_hu.tophat_window). If some future model path NaNs its
        # exact Hessian, central finite differences of the AD gradient give
        # a usable covariance at 2*ndim extra gradient evals.
        log.info('exact Hessian non-finite; using finite differences of the '
                 'AD gradient for the Laplace covariance')
        th0 = np.asarray(theta, dtype=np.float64)
        widths = np.array([(p.hi - p.lo) if p.dist in ('uniform', 'loguniform')
                           else p.hi for p in space.sampled])
        hs = 1e-3 * widths
        H = np.zeros((space.ndim, space.ndim))
        for i in range(space.ndim):
            tp, tm = th0.copy(), th0.copy()
            tp[i] += hs[i]
            tm[i] -= hs[i]
            gp = np.asarray(fns['grad_theta'](tables_arg, jnp.asarray(
                tp, dtype=theta.dtype)), dtype=np.float64)
            gm = np.asarray(fns['grad_theta'](tables_arg, jnp.asarray(
                tm, dtype=theta.dtype)), dtype=np.float64)
            H[:, i] = -(gp - gm) / (2.0 * hs[i])   # H = -d2 lnpost
        H = 0.5 * (H + H.T)
    # eigenvalue-clipped inversion: with near-degenerate directions (or an
    # f32 finite-difference Hessian) H can be indefinite at the noise level;
    # clipping to a tiny positive floor yields large-but-finite sigmas for
    # the unconstrained directions instead of zeros/NaNs
    hessian_pd = False
    try:
        w, V = np.linalg.eigh(0.5 * (H + H.T))
        hessian_pd = bool(w.min() > 0)
        if not hessian_pd:
            log.info('Laplace Hessian not positive definite (min eig '
                     '%.2e); using |eigenvalue| regularisation — sigmas '
                     'along the indefinite directions are indicative only '
                     '(use HMC for publication errors)', w.min())
        floor = max(np.abs(w).max(), 1e-300) * 1e-12
        cov = (V / np.maximum(np.abs(w), floor)) @ V.T
    except np.linalg.LinAlgError:
        cov = np.full_like(H, np.nan)
    lnl, chi2 = fns['stats'](tables_arg, theta)
    lnpost = float(np.asarray(lnl) + np.asarray(space.log_prior(theta)))

    result = MAPResult(
        space=space, theta=np.asarray(theta, dtype=np.float64),
        lnpost=lnpost, lnlike=float(lnl), chi2=float(chi2),
        cov=cov, grad_norm=float(np.linalg.norm(np.asarray(g))),
        n_starts=n_starts, n_converged=int(finite.sum()),
        hessian_pd=hessian_pd)
    log.info('MAP: chi2=%.4f lnpost=%.4f |grad|=%.2e (%d/%d starts finite)',
             result.chi2, result.lnpost, result.grad_norm,
             result.n_converged, n_starts)
    return result


@dataclasses.dataclass
class BootstrapResult:
    """Parametric-bootstrap calibration of a MAP fit."""
    names: tuple
    theta_map: np.ndarray          # (ndim,) the original MAP estimate
    bias: np.ndarray               # (ndim,) E[theta_hat | truth=MAP] - MAP
    theta_debiased: np.ndarray     # (ndim,) theta_map - bias
    cov: np.ndarray                # (ndim, ndim) bootstrap covariance
    theta_boot: np.ndarray         # (n_boot, ndim) the refit estimates
    n_failed: int                  # refits with a non-finite best objective

    @property
    def std(self) -> Dict[str, float]:
        sd = np.sqrt(np.clip(np.diag(self.cov), 0.0, np.inf))
        return {n: float(sd[i]) for i, n in enumerate(self.names)}

    @property
    def debiased(self) -> Dict[str, float]:
        return {n: float(self.theta_debiased[i])
                for i, n in enumerate(self.names)}


def parametric_bootstrap(bundle, params_block: Dict, map_result: MAPResult,
                         n_boot: int = 64, seed: int = 1000,
                         n_starts: int = 4, adam_steps: int = 120,
                         newton_steps: int = 6,
                         opts_kw: Optional[Dict] = None,
                         fit_kw: Optional[Dict] = None) -> BootstrapResult:
    """Parametric-bootstrap bias correction + frequentist covariance of MAP.

    Draws `n_boot` synthetic data vectors from the FITTED generative model
    (theory vector at the MAP, noise from the covariance at the MAP beta),
    refits each with the same machinery, and returns the estimator's
    measured bias b = mean(theta_boot) - theta_map (so theta_map - b is the
    debiased estimate) and its measured covariance. This is the calibrated
    remedy for the width-MLE skew of amplitude-like parameters: the 200-mock
    campaign measured a genuine -0.22 sigma mean pull on sigma_v (the
    classic 1/N width bias — BASELINE.md round 3) that the Laplace curvature
    cannot see; the bootstrap measures the estimator's actual sampling
    distribution instead of its local quadratic proxy. Each refit reuses the
    same compiled fit (mocks enter through the data-vector tables, which
    ride as jit arguments), so refit k >= 2 costs no compile.

    Caveats: the correction is first-order (bias estimated at theta = MAP,
    not at the unknown truth — standard bootstrap), and beta's grid-scale
    likelihood wiggles remain non-Gaussian (pull std ~2.9; report sampler
    credible intervals for beta — the coverage_test module docstring).
    """
    from .mocks import mock_setup, shift_datavector

    space = map_result.space
    # the generative model needs every parameter the theory reads (fixed +
    # derived included), at the fitted point
    fid = {k: float(np.asarray(v))
           for k, v in space.full_params(jnp.asarray(map_result.theta)).items()}
    tvec, dvec, L = mock_setup(bundle, fid)
    names = tuple(p.name for p in space.sampled)

    rng = np.random.default_rng(seed)
    thetas = np.empty((n_boot, space.ndim))
    n_failed = 0
    for k in range(n_boot):
        mock = tvec + L @ rng.standard_normal(len(tvec))
        mb = shift_datavector(bundle, mock - dvec)
        try:
            res = find_map(mb, params_block, n_starts=n_starts,
                           adam_steps=adam_steps, newton_steps=newton_steps,
                           seed=seed + 1 + k, opts_kw=opts_kw, fit_kw=fit_kw)
            thetas[k] = res.theta
        except RuntimeError:
            thetas[k] = np.nan
            n_failed += 1
    ok = np.all(np.isfinite(thetas), axis=1)
    if ok.sum() < max(4, n_boot // 2):
        raise RuntimeError(
            f'parametric_bootstrap: only {int(ok.sum())}/{n_boot} refits '
            'converged; the fitted model cannot generate refittable mocks')
    good = thetas[ok]
    bias = good.mean(axis=0) - map_result.theta
    cov = np.cov(good.T) if space.ndim > 1 else \
        np.atleast_2d(np.var(good, ddof=1))
    result = BootstrapResult(
        names=names, theta_map=map_result.theta.copy(), bias=bias,
        theta_debiased=map_result.theta - bias, cov=cov,
        theta_boot=good, n_failed=int(n_boot - ok.sum()))
    log.info('parametric bootstrap: %d/%d refits; largest |bias|/sigma = '
             '%.2f (%s)', int(ok.sum()), n_boot,
             float(np.max(np.abs(bias) / np.sqrt(np.diag(cov)))),
             names[int(np.argmax(np.abs(bias) / np.sqrt(np.diag(cov))))])
    return result


@dataclasses.dataclass
class FisherResult:
    names: tuple
    fiducial: np.ndarray        # (ndim,)
    fisher: np.ndarray          # (ndim, ndim) F_ij = d_i t . C^-1 . d_j t
    cov: np.ndarray             # inv(F): forecast parameter covariance

    @property
    def std(self) -> Dict[str, float]:
        sd = np.sqrt(np.clip(np.diag(self.cov), 0.0, np.inf))
        return {n: float(sd[i]) for i, n in enumerate(self.names)}

    @property
    def correlation(self) -> np.ndarray:
        sd = np.sqrt(np.clip(np.diag(self.cov), 1e-300, np.inf))
        return self.cov / np.outer(sd, sd)


def fisher_forecast(bundle, fiducial: Dict, names,
                    opts_kw: Optional[Dict] = None,
                    fit_kw: Optional[Dict] = None,
                    derived=()) -> FisherResult:
    """Gaussian Fisher-matrix forecast at a fiducial parameter point.

    `derived` takes DerivedParam-like entries (``.name``, ``.argnames``,
    ``.fn``, ``.src``) — the cobaya-style derived lambdas of a params block
    (e.g. aperp/apar from alpha, epsilon) — applied after the forecast
    parameters are assembled, so the derivative chains through them.

    F_ij = (d r / d theta_i)^T C^-1 (d r / d theta_j), with r = t - d the
    residual of the theory multipole vector against the (beta-interpolated)
    data vector, and C the covariance at the fiducial beta — the expected
    parameter covariance from the local response of the fit (no external
    numerical-derivative machinery: the residual is differentiated exactly
    with jax.jacfwd). Differentiating the RESIDUAL rather than the theory
    alone matters for reconstruction analyses: beta moves the data vector
    through the beta grid as well as the theory (victor/ccf_fit.py:306-323),
    and that data response carries most of the beta information.

    Unlike the Laplace covariance from `find_map` (curvature of the actual
    posterior at the MAP), the Fisher forecast uses only the model, the
    data-template response, and the covariance; for a Gaussian likelihood
    with parameter-independent C the two agree in expectation.

    Accepts a single-dataset CCFModelBundle or a multi-quantile JointBundle
    (stacked residual against the joint cross-covariance), like find_map.
    """
    from ..errors import InputError
    from ..likelihood.core import interpolated_precision, multipole_datavector
    from ..likelihood.multiquantile import (JointBundle, joint_datavector,
                                            joint_precision,
                                            joint_theory_vector)
    from ..models.ccf_theory import theory_vector

    names = tuple(names)
    derived = tuple(derived)
    derived_names = {d.name for d in derived}
    fixed = {k: jnp.asarray(v) for k, v in fiducial.items()
             if k not in names and k not in derived_names}
    th0 = jnp.asarray([float(fiducial[n]) for n in names])
    # ONE fiducial beta for both the data-vector default and the covariance
    # (they previously used different fallbacks, mixing interpolation
    # points). A DERIVED beta (params-block `beta: {value: lambda ...}`)
    # wins over any explicit fiducial entry — the residual recomputes it
    # from the lambda, so honoring the explicit value here would evaluate
    # the covariance and the residual at different betas. The full derived
    # chain is evaluated in block order (chained lambdas supported — a
    # one-hop argname lookup missed beta <- bhalf <- bx and silently fell
    # back to 0.4).
    if any(d.name == 'beta' for d in derived):
        vals = {k: jnp.asarray(float(v)) for k, v in fiducial.items()
                if k not in derived_names}
        try:
            for dd in derived:
                vals[dd.name] = dd.fn(*[vals[a] for a in dd.argnames])
            beta_fid = vals['beta']
        except KeyError:
            beta_fid = None
    else:
        beta_fid = fiducial.get('beta')
    beta_missing = beta_fid is None
    beta_fid = 0.4 if beta_missing else float(beta_fid)

    def assemble(th):
        params = dict(fixed)
        for i, n in enumerate(names):
            params[n] = th[i]
        for d in derived:
            params[d.name] = d.fn(*[params[a] for a in d.argnames])
        return params

    # the fixed fiducial values are closure constants of the jitted residual,
    # so they must be part of the cache key
    derived_key = tuple((d.name, d.argnames, d.src) for d in derived)
    fixed_key = tuple(sorted((k, float(v)) for k, v in fiducial.items()
                             if k not in names and k not in derived_names))

    if isinstance(bundle, JointBundle):
        if not bundle.fixed_covmat and beta_missing:
            # same semantics as joint_chi_squared: the joint covariance
            # interpolates on the GLOBAL beta — silently forecasting at the
            # 0.4 fallback would be garbage-but-finite
            raise InputError('Need a fiducial beta (given or derivable '
                             'from the fiducial) to interpolate the '
                             'beta-dependent joint covariance')
        cache_key = ('fisher-joint',
                     tuple((b.spec, b.theory_opts) for b in bundle.bundles),
                     bundle.fixed_covmat, bundle.ndata,
                     repr(sorted((opts_kw or {}).items())),
                     names, beta_fid, derived_key, fixed_key)
        fns = _FIT_CACHE.setdefault(cache_key, {})
        if 'jac' not in fns:
            def residual(jb, th):
                params = assemble(th)
                return joint_theory_vector(jb, params, opts_kw) - \
                    joint_datavector(jb, params)

            fns['jac'] = jax.jit(lambda jb, th: (
                jax.jacfwd(lambda t: residual(jb, t))(th),
                joint_precision(jb, jnp.asarray(beta_fid))))
        J, icov = fns['jac'](bundle, th0)
    else:
        opts = bundle.theory_opts.replace(**(opts_kw or {}))
        fit = bundle.fit_opts.replace(**(fit_kw or {}))
        spec = bundle.spec
        if beta_missing and not (spec.fixed_data and spec.fixed_covmat):
            # same loud semantics as likelihood/core.chi_squared and the
            # JointBundle branch above: forecasting a beta-dependent data
            # vector / covariance at the hard-coded 0.4 fallback would
            # produce plausible-but-wrong Fisher sigmas with no warning
            raise InputError('Need a fiducial beta (given or derivable from '
                             'the fiducial) to interpolate the '
                             'beta-dependent data vector / covariance')
        cache_key = ('fisher', spec, opts, fit, names, beta_fid,
                     derived_key, fixed_key)
        fns = _FIT_CACHE.setdefault(cache_key, {})
        if 'jac' not in fns:
            def residual(tbl, th):
                params = assemble(th)
                beta = params.get('beta', jnp.asarray(beta_fid))
                return theory_vector(tbl, spec, opts, params) - \
                    multipole_datavector(tbl, spec, beta)

            fns['jac'] = jax.jit(lambda tbl, th: (
                jax.jacfwd(lambda t: residual(tbl, t))(th),
                interpolated_precision(tbl, spec, jnp.asarray(beta_fid))))
        J, icov = fns['jac'](bundle.tables, th0)
    J = np.asarray(J, dtype=np.float64)            # (ndata, ndim)
    icov = np.asarray(icov, dtype=np.float64)
    F = J.T @ icov @ J
    F = 0.5 * (F + F.T)
    try:
        cov = np.linalg.inv(F)
    except np.linalg.LinAlgError:
        cov = np.full_like(F, np.nan)
    res = FisherResult(names=names,
                       fiducial=np.asarray(th0, dtype=np.float64),
                       fisher=F, cov=cov)
    log.info('Fisher forecast at %s: sigma = %s',
             {n: float(fiducial[n]) for n in names},
             {k: round(v, 5) for k, v in res.std.items()})
    return res


@dataclasses.dataclass
class ProfileResult:
    scan_names: tuple
    grid: np.ndarray            # (G, n_scan) scanned parameter values
    chi2: np.ndarray            # (G,) profile chi2 (minimised over the rest)
    lnlike: np.ndarray          # (G,)
    free_optima: np.ndarray     # (G, n_free) nuisance optima per grid point
    free_names: tuple
    map_result: MAPResult       # the global MAP used for anchoring/warm starts

    def delta_chi2(self) -> np.ndarray:
        return self.chi2 - self.chi2.min()

    def interval(self, level: float = 1.0):
        """(lo, hi) crossing points of delta-chi2 == level (1D scans only);
        level 1.0 = 68.3%, 4.0 = 95.4% for one parameter."""
        if self.grid.shape[1] != 1:
            raise ValueError('interval() needs a 1D scan')
        x = self.grid[:, 0]
        d = self.delta_chi2()
        i0 = int(np.argmin(d))

        def cross(dd, xx):
            for j in range(len(dd) - 1):
                if (dd[j] - level) * (dd[j + 1] - level) <= 0 and dd[j] != dd[j + 1]:
                    f = (level - dd[j]) / (dd[j + 1] - dd[j])
                    return float(xx[j] + f * (xx[j + 1] - xx[j]))
            return float('nan')
        lo = cross(d[:i0 + 1][::-1], x[:i0 + 1][::-1])
        hi = cross(d[i0:], x[i0:])
        return lo, hi


def profile_scan(bundle, params_block: Dict, scan_names,
                 grid: Optional[np.ndarray] = None, n_grid: int = 21,
                 n_sigma: float = 4.0, adam_steps: int = 150,
                 newton_steps: int = 6, learning_rate: float = 0.05,
                 seed: int = 0, opts_kw: Optional[Dict] = None,
                 fit_kw: Optional[Dict] = None, grid_chunk: int = 32,
                 map_result: Optional[MAPResult] = None) -> ProfileResult:
    """Profile likelihood: minimise chi2 over the nuisance parameters at
    every point of a grid in `scan_names` — the frequentist companion to the
    marginal posteriors (delta-chi2 = 1 gives the 68.3% interval for one
    parameter).

    All grid points optimise SIMULTANEOUSLY: one vmapped Adam descent over
    (G, n_free) warm-started at the global MAP's nuisance values, then a
    vmapped damped-Newton polish — the whole scan costs a handful of device
    dispatches regardless of G. Default grid: MAP +/- n_sigma Laplace sigmas,
    clipped into the prior support.
    """
    scan_names = tuple(scan_names) if not isinstance(scan_names, str) \
        else (scan_names,)
    space = ParamSpace(params_block)
    names = space.names
    for s in scan_names:
        if s not in names:
            raise ValueError(f'scan parameter {s!r} is not sampled in the '
                             f'params block (sampled: {names})')
    free_names = tuple(n for n in names if n not in scan_names)
    if not free_names:
        raise ValueError('profile_scan needs at least one free parameter; '
                         'use a plain grid evaluation otherwise')

    # sub-space over the free (nuisance) parameters for the reparameterisation
    fspace = ParamSpace({k: params_block[k] for k in free_names})

    if map_result is None:
        map_result = find_map(bundle, params_block, seed=seed,
                              adam_steps=adam_steps, opts_kw=opts_kw,
                              fit_kw=fit_kw)

    if grid is None:
        lo_b, hi_b = space.bounds()
        axes = []
        for s in scan_names:
            i = names.index(s)
            sd = max(np.sqrt(max(map_result.cov[i, i], 0.0)), 1e-12)
            a = max(map_result.theta[i] - n_sigma * sd, lo_b[i])
            b = min(map_result.theta[i] + n_sigma * sd, hi_b[i])
            axes.append(np.linspace(a, b, n_grid))
        grid = np.stack(np.meshgrid(*axes, indexing='ij'),
                        axis=-1).reshape(-1, len(scan_names))
    # a user-supplied 1-D array is a 1-D scan's grid, NOT one G-dim point
    # (np.atleast_2d would turn shape (G,) into (1, G))
    grid = np.asarray(grid, dtype=np.float64)
    if grid.ndim == 1:
        grid = grid[:, None]
    if grid.ndim != 2 or grid.shape[1] != len(scan_names):
        raise ValueError(f'grid must have shape (G, {len(scan_names)}); '
                         f'got {grid.shape}')

    from .targets import resolve_target
    tables_arg, loglike, cache_id = resolve_target(bundle, opts_kw, fit_kw)

    def params_at(theta_free, scan_vals):
        params = {k: jnp.asarray(v) for k, v in space.fixed.items()}
        for i, n in enumerate(free_names):
            params[n] = theta_free[..., i]
        for i, n in enumerate(scan_names):
            params[n] = scan_vals[..., i]
        for d in space.derived:
            params[d.name] = d.fn(*[params[a] for a in d.argnames])
        return params

    def neg_y(tbl, y_free, g):
        theta_free = fspace.to_bounded(y_free)
        lnl, _ = loglike(tbl, params_at(theta_free, g))
        total = lnl + fspace.log_prior(theta_free)
        return -jnp.where(jnp.isfinite(total), total, -jnp.inf)

    import optax
    opt = optax.adam(learning_rate)

    # cache the jitted scan across calls (CLAUDE.md rule 4: jax's jit cache
    # keys on the function OBJECT — a fresh closure per call would re-trace
    # the hessian-laden graph every invocation). The key covers everything
    # the closure captures: target statics, the parameter-space structure,
    # the fixed values (closure constants), and the loop lengths.
    # sampled tuple NOT sorted — order is semantic (see find_map's cache key)
    scan_cache_key = ('scan', cache_id, scan_names, free_names,
                      tuple((p.name, p.dist, p.lo, p.hi)
                            for p in space.sampled),
                      tuple(sorted(space.fixed.items())),
                      tuple((d.name, d.argnames, d.src) for d in space.derived),
                      adam_steps, newton_steps, learning_rate)
    _cached = _FIT_CACHE.setdefault(scan_cache_key, {})

    def scan_all(tbl, y0, gs):
        def per_point(y_init, g):
            def step(carry, _):
                y, st = carry
                val, gr = jax.value_and_grad(
                    lambda yy: neg_y(tbl, yy, g))(y)
                gr = jnp.where(jnp.isfinite(gr), gr, 0.0)
                upd, st = opt.update(gr, st, y)
                return (optax.apply_updates(y, upd), st), None
            (y, _), _ = jax.lax.scan(step, (y_init, opt.init(y_init)),
                                     None, length=adam_steps)

            if newton_steps:      # hessian trace is the compile hog: skip at 0
                y, _ = jax.lax.scan(
                    lambda yc, _: (_damped_newton_step(
                        lambda yy: neg_y(tbl, yy, g), yc), None),
                    y, None, length=newton_steps)

            theta_free = fspace.to_bounded(y)
            lnl, aux = loglike(tbl, params_at(theta_free, g))
            return theta_free, lnl, aux
        return jax.vmap(per_point)(y0, gs)

    if 'scan_all' not in _cached:
        _cached['scan_all'] = jax.jit(scan_all)
    scan_all = _cached['scan_all']

    theta_map_free = np.array([map_result.params[n] for n in free_names])
    y_map = fspace.to_unbounded(jnp.asarray(theta_map_free))

    # chunk the grid axis: the vmapped hessian/jvp intermediates are
    # (chunk, n_free, n_v, q)-sized, so a large 2D grid in one dispatch
    # exhausts device memory (observed at 225 points); fixed chunk shape
    # keeps it one compile + a handful of dispatches
    G = len(grid)
    chunk = min(grid_chunk, G)
    n_chunks = -(-G // chunk)
    pad = n_chunks * chunk - G
    grid_p = np.concatenate([grid, np.repeat(grid[:1], pad, axis=0)]) \
        if pad else grid
    y0 = jnp.broadcast_to(y_map, (chunk, len(free_names)))
    outs = [scan_all(tables_arg, y0, jnp.asarray(grid_p[i * chunk:(i + 1) * chunk]))
            for i in range(n_chunks)]
    theta_free, lnl, chi2 = (jnp.concatenate([o[k] for o in outs])[:G]
                             for k in range(3))

    result = ProfileResult(
        scan_names=scan_names, grid=grid,
        chi2=np.asarray(chi2, dtype=np.float64),
        lnlike=np.asarray(lnl, dtype=np.float64),
        free_optima=np.asarray(theta_free, dtype=np.float64),
        free_names=free_names, map_result=map_result)
    log.info('profile scan over %s: %d points, min chi2 %.4f',
             scan_names, len(grid), float(result.chi2.min()))
    return result
