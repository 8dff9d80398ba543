"""Importance reweighting of a stored posterior — the `cobaya post` role.

Reference users post-process chains with `cobaya post` (add/modify a
likelihood or prior and reweight an existing chain without re-sampling);
victor itself has no such facility. This module is the on-device
equivalent for victor_tpu's own samplers: take the particles of a finished
run (SMC / NS equal-weight particles, or MCMC draws — anything exported in
GetDist format by sampling/chains.py), recompute the log-posterior under a
MODIFIED target (different likelihood form, model options, fixed-parameter
values, priors, fast/exact evaluation mode, ...), and reweight

    w_i' = w_i * exp[ (lnL_new + lnPrior_new)(theta_i)
                      - (lnL_old + lnPrior_old)(theta_i) ].

Because both targets evaluate in one chunked vmapped dispatch at the full
batched-likelihood throughput, reweighting a 4096-particle posterior costs
one batched likelihood pass — option-sensitivity
studies that would otherwise each need a fresh sampler run become
interactive.

The same weights also give the evidence ratio by importance sampling,

    ln Z_new - ln Z_old = ln E_old[ exp(Delta_i) ]
                        = ln( sum_i w_i e^{Delta_i} / sum_i w_i ),

valid because ParamSpace priors are normalized densities (priors.py). The
reported standard error is the delta-method/self-normalized-IS bar assuming
independent draws; SMC/NS particles carry residual correlations (the same
caveat documented on SMCResult), so treat it as a lower bound and prefer a
direct run when |Delta lnZ| is within a few bars. The reweighting ESS
(sum w')^2 / sum w'^2 is the honesty check: when the new target moves
outside the old posterior's support the ESS collapses and the result means
nothing — `reweight` warns below `min_ess_fraction`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import InputError
from ..utils.logging import get_logger
from .priors import ParamSpace
from .targets import JitFnCache

log = get_logger('post')

_POST_CACHE = JitFnCache()


@dataclasses.dataclass
class PostResult:
    space: ParamSpace            # the NEW parameter space
    theta: np.ndarray            # (n, ndim) input particles (unchanged)
    weights_old: np.ndarray      # (n,) input weights
    weights: np.ndarray          # (n,) reweighted, normalized to mean 1
    lnl_old: np.ndarray          # (n,) old log-likelihood at theta
    lnl_new: np.ndarray          # (n,)
    log_prob: np.ndarray         # (n,) new lnL + lnPrior
    aux: np.ndarray              # (n, n_aux) aux outputs under the NEW target
    delta_logz: float            # ln Z_new - ln Z_old (importance estimate)
    delta_logz_se: float         # self-normalized-IS bar (independent-draw)
    ess: float                   # reweighting effective sample size
    n: int

    @property
    def efficiency(self) -> float:
        return self.ess / max(self.n, 1)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Weighted posterior moments per sampled parameter (new target)."""
        return _weighted_moments(self.theta, self.weights, self.space)


def _weighted_moments(theta, w, space):
    w = w / w.sum()
    out = {}
    for i, p in enumerate(space.sampled):
        mean = float(np.sum(w * theta[:, i]))
        out[p.name] = {'mean': mean,
                       'std': float(np.sqrt(np.sum(w * (theta[:, i] - mean) ** 2)))}
    return out


def reweight(bundle_old, bundle_new, params_block: Dict, theta: np.ndarray,
             weights: Optional[np.ndarray] = None,
             params_block_new: Optional[Dict] = None,
             opts_kw_old: Optional[Dict] = None,
             fit_kw_old: Optional[Dict] = None,
             opts_kw_new: Optional[Dict] = None,
             fit_kw_new: Optional[Dict] = None,
             chunk: Optional[int] = 64,
             min_ess_fraction: float = 0.1,
             output: Optional[str] = None,
             aux_names: Optional[list] = None) -> PostResult:
    """Reweight posterior draws from an old target to a new one.

    `bundle_old` / `bundle_new` are any run_smc-style targets
    (CCFModelBundle, JointBundle, or callable params -> (lnl, aux));
    `params_block` is the cobaya-style block the chains were sampled with,
    `params_block_new` an optional replacement (same sampled-parameter names
    and order; priors/fixed/derived may differ — changed priors enter the
    weights). `theta` is (n, ndim) in params_block's sampled order,
    `weights` the existing row weights (default 1).

    Returns a PostResult; with `output`, writes reweighted GetDist chains
    (fractional weight column) that GetDist consumes directly.
    """
    from ..likelihood.batched import chunked_vmap
    from .targets import resolve_target, space_cache_key

    space_old = ParamSpace(params_block)
    space_new = ParamSpace(params_block_new) if params_block_new is not None \
        else space_old
    old_names = [p.name for p in space_old.sampled]
    new_names = [p.name for p in space_new.sampled]
    if old_names != new_names:
        raise InputError(
            'reweight', 'params_block_new must sample the same parameters '
            f'in the same order (old {old_names}, new {new_names}); '
            'adding/removing sampled parameters needs a fresh run')

    theta = np.asarray(theta, dtype=np.float64)
    if theta.ndim != 2 or theta.shape[1] != space_old.ndim:
        raise InputError('reweight', f'theta must be (n, {space_old.ndim}); '
                                     f'got {theta.shape}')
    n = theta.shape[0]
    w_old = np.ones(n) if weights is None else \
        np.asarray(weights, dtype=np.float64)
    if w_old.shape != (n,) or (w_old < 0).any() or w_old.sum() == 0:
        raise InputError('reweight', 'weights must be (n,) non-negative '
                                     'with positive sum')

    # reweighting is pure forward evaluation of stored draws — gradient-
    # free, so 'auto' perf modes resolve fast (consistent with the
    # samplers that produced the chains; explicit opts_kw_* opt out)
    tbl_old, loglike_old, cid_old = resolve_target(bundle_old, opts_kw_old,
                                                   fit_kw_old,
                                                   gradient_free=True)
    tbl_new, loglike_new, cid_new = resolve_target(bundle_new, opts_kw_new,
                                                   fit_kw_new,
                                                   gradient_free=True)

    # unlike the particle samplers' wrappers (targets.make_unbounded_wrappers)
    # these evaluate at BOUNDED theta straight from the stored chains — no
    # reparameterisation, no Jacobian term
    def _make(loglike, space):
        def scalar(tbl, th):
            lnl, aux = loglike(tbl, space.full_params(th))
            return jnp.where(jnp.isfinite(lnl), lnl, -jnp.inf), \
                jnp.atleast_1d(aux)

        def batched(tbl, ths):
            fn = lambda th: scalar(tbl, th)    # noqa: E731
            if chunk and ths.shape[0] > chunk:
                return chunked_vmap(fn, chunk)(ths)
            return jax.vmap(fn)(ths)
        return jax.jit(batched)

    # no old/new role tag in the key: the same target in either role reuses
    # one compiled function (reweight(A, B) then reweight(B, C) must not
    # recompile B), and the explicit guard keeps _make lazy on cache hits
    key_old = (cid_old, space_cache_key(space_old), chunk)
    key_new = (cid_new, space_cache_key(space_new), chunk)
    if key_old not in _POST_CACHE:
        _POST_CACHE[key_old] = _make(loglike_old, space_old)
    fn_old = _POST_CACHE[key_old]
    if key_new not in _POST_CACHE:
        _POST_CACHE[key_new] = _make(loglike_new, space_new)
    fn_new = _POST_CACHE[key_new]

    th_dev = jnp.asarray(theta)
    lnl_old, _ = fn_old(tbl_old, th_dev)
    lnl_new, aux_new = fn_new(tbl_new, th_dev)
    lnl_old = np.asarray(lnl_old, dtype=np.float64)
    lnl_new = np.asarray(lnl_new, dtype=np.float64)
    aux_new = np.asarray(aux_new, dtype=np.float64)
    lp_old = np.asarray(space_old.log_prior(th_dev), dtype=np.float64)
    lp_new = np.asarray(space_new.log_prior(th_dev), dtype=np.float64)

    bad = ~np.isfinite(lnl_old + lp_old)
    if bad.any():
        # a draw where the OLD posterior is zero cannot have come from it —
        # the chains and the old config disagree; it carries no information
        # about the ratio, so it leaves BOTH sides of the estimate (keeping
        # it in the denominator would deterministically bias Delta lnZ low)
        log.warning('%d/%d particles have zero OLD posterior density — the '
                    'chains do not match the old config (they are dropped '
                    'from the reweighting)', int(bad.sum()), n)
    w_eff = np.where(bad, 0.0, w_old)
    delta = np.full(n, -np.inf)
    ok = ~bad
    delta[ok] = (lnl_new[ok] + lp_new[ok]) - (lnl_old[ok] + lp_old[ok])

    finite = np.isfinite(delta) & (w_eff > 0)
    if not finite.any():
        raise InputError('reweight', 'every particle has zero weight under '
                                     'the new target — the posteriors do '
                                     'not overlap; run a fresh sampler')
    dmax = float(delta[finite].max())
    r = np.where(finite, np.exp(delta - dmax), 0.0)

    wsum = w_eff.sum()
    ratio = float(np.sum(w_eff * r) / wsum)           # = E_old[e^Delta] e^-dmax
    delta_logz = float(np.log(ratio) + dmax)
    # self-normalized IS delta-method bar (independent-draw assumption)
    var = float(np.sum(w_eff ** 2 * (r - ratio) ** 2) / wsum ** 2)
    delta_logz_se = float(np.sqrt(var) / ratio) if ratio > 0 else np.inf

    w_new = w_eff * r
    w_new = w_new * (n / w_new.sum())                 # normalize to mean 1
    ess = float(w_new.sum() ** 2 / np.sum(w_new ** 2))
    if ess < min_ess_fraction * n:
        log.warning('reweighting ESS = %.0f of %d particles (%.1f%%) — the '
                    'new target sits in the old posterior tail; moments and '
                    'Delta lnZ are unreliable, run a fresh sampler', ess, n,
                    100 * ess / n)

    log_prob = lnl_new + lp_new
    result = PostResult(
        space=space_new, theta=theta, weights_old=w_old, weights=w_new,
        lnl_old=lnl_old, lnl_new=lnl_new, log_prob=log_prob, aux=aux_new,
        delta_logz=delta_logz, delta_logz_se=delta_logz_se, ess=ess, n=n)
    log.info('reweighted %d particles: Delta lnZ = %.3f +/- %.3f, '
             'ESS = %.0f (%.1f%%)', n, delta_logz, delta_logz_se, ess,
             100 * result.efficiency)

    if output:
        from . import chains as chain_io
        if aux_names is None:
            is_callable = isinstance(cid_new, tuple) and cid_new \
                and cid_new[0] == 'callable'
            aux_names = [f'aux_{j}' for j in range(aux_new.shape[1])] \
                if is_callable else ['chi2_ccf_correct']
        chain_io.export_getdist(output, space_new, theta[:, None, :],
                                log_prob[:, None], aux_new[:, None, :],
                                aux_names=aux_names, burn_in=0,
                                n_chain_files=1, weights=w_new[:, None])
        log.info('reweighted chains written to %s.*', output)
    return result
