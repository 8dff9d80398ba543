"""Tempered sequential Monte Carlo with Bayesian-evidence estimation.

Neither the reference nor cobaya's default Metropolis provides the evidence
Z = integral of L(theta) pi(theta) d theta (cobaya users reach for external
nested samplers). On an accelerator an SMC sampler is the natural fit: the whole
particle population evaluates in one vmapped dispatch per stage, the
temperature ladder adapts itself, and log Z falls out of the incremental
importance weights for free.

Algorithm (adaptive-beta SMC, systematic resampling, random-walk Metropolis
mutations):

  1. N particles drawn from the PRIOR (ParamSpace.sample_prior — exact prior
     draws are what make the evidence estimate unbiased).
  2. At inverse temperature beta, choose the next step d-beta by bisection so
     the effective sample size of w_i = exp(d-beta * lnL_i) stays at
     `ess_target * N` (Beskos et al. 2016 adaptive tempering).
  3. log Z accumulates log mean_i exp(d-beta * lnL_i) per stage.
  4. Systematic resample by w, then `n_moves` random-walk Metropolis steps
     targeting pi(theta) L(theta)^beta in the unbounded reparameterisation,
     with proposal covariance 2.38^2/d times the weighted particle covariance
     (adapts to the tempered posterior's shape each stage).

Each stage is ONE jitted device program (resample + all moves under
lax.scan); only the (N,) log-likelihood vector returns to the host for the
d-beta bisection, so an entire run is O(10-30) small dispatches.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.logging import get_logger
from .priors import ParamSpace
from .targets import JitFnCache

log = get_logger('smc')

_SMC_CACHE = JitFnCache()

# The internal CLT standard error assumes independent importance weights;
# resampling/mutation correlations make it optimistic. Measured on the BOSS
# posterior (BASELINE.md seed study): seed-to-seed scatter 0.12 vs CLT se
# 0.038 — a factor ~3. The REPORTED logz_se is inflated by this factor so the
# quoted bar covers the observed scatter; the raw CLT value stays available
# as logz_se_clt.
LOGZ_SE_INFLATION = 3.0


@dataclasses.dataclass
class SMCResult:
    space: ParamSpace
    particles: np.ndarray       # (N, ndim) physical-space posterior draws
    log_prob: np.ndarray        # (N,) lnL + ln prior at the particles
    aux: np.ndarray             # (N, n_aux) auxiliary outputs (chi2)
    logz: float                 # log evidence estimate
    logz_se: float              # reported standard error of logz: the
                                # internal CLT se inflated by
                                # LOGZ_SE_INFLATION (measured resampling-
                                # correlation factor) so it covers the
                                # observed seed-to-seed scatter
    logz_se_clt: float          # raw independent-weights CLT se (optimistic)
    betas: np.ndarray           # temperature ladder actually used (incl. 0, 1)
    ess: np.ndarray             # pre-resampling ESS FRACTION (ESS/N, 0..1)
                                # per stage — not an absolute sample count
    acceptance: np.ndarray      # mutation acceptance per stage
    elapsed_s: float

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {p.name: {'mean': float(self.particles[:, i].mean()),
                         'std': float(self.particles[:, i].std())}
                for i, p in enumerate(self.space.sampled)}


def _systematic_resample(key, w, n):
    """Systematic resampling: indices i with multiplicity ~ n * w_i."""
    u = (jax.random.uniform(key, ()) + jnp.arange(n)) / n
    cdf = jnp.cumsum(w)
    return jnp.clip(jnp.searchsorted(cdf, u, side='left',
                                     method='compare_all'), 0, n - 1)


def _ess_fraction(lnw):
    """ESS of normalised exp(lnw) as a fraction of the particle count."""
    lnw = lnw - lnw.max()
    w = np.exp(lnw)
    w /= w.sum()
    return 1.0 / (len(w) * float((w ** 2).sum()))


def _choose_dbeta(lnl, beta, ess_target):
    """Largest d-beta <= 1-beta with ESS(exp(d-beta*lnl)) >= ess_target*N."""
    hi = 1.0 - beta
    if _ess_fraction(hi * lnl) >= ess_target:
        return hi
    lo = 0.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if _ess_fraction(mid * lnl) >= ess_target:
            lo = mid
        else:
            hi = mid
    return max(lo, 1e-8)


def run_smc(bundle, params_block: Dict, n_particles: int = 2048,
            ess_target: float = 0.5, n_moves: int = 5, seed: int = 0,
            opts_kw: Optional[Dict] = None, fit_kw: Optional[Dict] = None,
            chunk: Optional[int] = 64,
            mesh: Optional[jax.sharding.Mesh] = None,
            mesh_axis=None, max_stages: int = 200,
            checkpoint: Optional[str] = None, resume: bool = False,
            output: Optional[str] = None,
            aux_names: Optional[list] = None) -> SMCResult:
    """Sample the posterior AND estimate the evidence by tempered SMC.

    `bundle` is a CCFModelBundle, a multi-quantile JointBundle, or (for
    testing / custom targets) a callable params-dict -> (lnlike, aux_scalar).
    `chunk` bounds per-dispatch memory exactly like likelihood/batched.py.
    With `mesh`, the particle axis is sharded (tables replicated); the
    resampling gather turns into XLA collectives automatically.

    `checkpoint`: write the full sampler state (particles, temperatures,
    running log Z) at every stage boundary; `resume=True` continues an
    interrupted run exactly — the d-beta bisection is deterministic in the
    restored log-likelihoods and the PRNG key is part of the state, so a
    resumed run is bit-identical to an uninterrupted one.
    """
    from .targets import (guarded_cholesky, make_unbounded_wrappers,
                          resolve_target, space_cache_key)

    space = ParamSpace(params_block)
    # SMC is gradient-free: 'auto' perf modes resolve to the validated
    # fast modes (config.resolve_perf_mode; explicit opts are the opt-out)
    tables_arg, loglike, cache_id = resolve_target(bundle, opts_kw, fit_kw,
                                                   gradient_free=True)

    # load a checkpoint FIRST: its particle count overrides the n_particles
    # argument (which also feeds the chunk decision and the jit-cache key)
    state = None
    if resume and checkpoint and os.path.isfile(checkpoint):
        z = np.load(checkpoint, allow_pickle=False)
        state = {k: z[k] for k in z.files}
        if state['y'].shape[0] != n_particles:
            log.info('resume: checkpoint has %d particles; overriding the '
                     'n_particles=%d argument', state['y'].shape[0],
                     n_particles)
            n_particles = int(state['y'].shape[0])
        log.info('resumed SMC from %s at beta=%.4f (stage %d)',
                 checkpoint, float(state['beta']), len(state['betas']) - 1)

    _, lnprior_scalar, batched_lnlike = make_unbounded_wrappers(
        space, loglike, chunk)

    cache_key = (cache_id, space_cache_key(space),
                 n_particles, n_moves, chunk,
                 None if mesh is None else (mesh.shape_tuple, mesh_axis))
    fns = _SMC_CACHE.setdefault(cache_key, {})

    if 'init' not in fns:
        fns['init'] = jax.jit(batched_lnlike)

        def stage(tbl, y, lnl, lnpri, aux, key, w, beta_new):
            n = y.shape[0]
            # proposal from the PRE-resampling weighted covariance
            chol = guarded_cholesky(w, y)

            key, k_res = jax.random.split(key)
            idx = _systematic_resample(k_res, w, n)
            y, lnl, lnpri, aux = y[idx], lnl[idx], lnpri[idx], aux[idx]

            def move(carry, k):
                y, lnl, lnpri, aux, n_acc = carry
                k1, k2 = jax.random.split(k)
                eps = jax.random.normal(k1, y.shape)
                y_p = y + jnp.matmul(eps, chol.T, precision='highest')
                lnl_p, aux_p = batched_lnlike(tbl, y_p)
                lnpri_p = jax.vmap(lnprior_scalar)(y_p)
                ln_acc = (beta_new * lnl_p + lnpri_p) - \
                         (beta_new * lnl + lnpri)
                accept = jnp.log(jax.random.uniform(k2, (n,))) < ln_acc
                y = jnp.where(accept[:, None], y_p, y)
                lnl = jnp.where(accept, lnl_p, lnl)
                lnpri = jnp.where(accept, lnpri_p, lnpri)
                aux = jnp.where(accept[:, None], aux_p, aux)
                return (y, lnl, lnpri, aux, n_acc + accept.mean()), None

            keys = jax.random.split(key, n_moves + 1)
            (y, lnl, lnpri, aux, n_acc), _ = jax.lax.scan(
                move, (y, lnl, lnpri, aux, jnp.zeros(())), keys[1:])
            return y, lnl, lnpri, aux, keys[0], n_acc / n_moves

        fns['stage'] = jax.jit(stage)
        fns['lnprior'] = jax.jit(jax.vmap(lnprior_scalar))

    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        if mesh_axis is None:
            mesh_axis = tuple(mesh.axis_names)
        shard = NamedSharding(mesh, P(mesh_axis))
        rep = NamedSharding(mesh, P())
        tables_arg = jax.device_put(tables_arg, rep)

    t0 = time.time()
    if state is None:
        theta0 = space.sample_prior(k0, n_particles)
        y = space.to_unbounded(theta0)
        if mesh is not None:
            y = jax.device_put(y, shard)
        lnl, aux = fns['init'](tables_arg, y)
        lnpri = fns['lnprior'](y)
        beta = 0.0
        logz = 0.0
        var_sum = 0.0
        betas, ess_hist, acc_hist = [0.0], [], []
    else:
        y = jnp.asarray(state['y'])
        lnl = jnp.asarray(state['lnl'])
        lnpri = jnp.asarray(state['lnpri'])
        aux = jnp.asarray(state['aux'])
        key = jnp.asarray(state['key'])
        if mesh is not None:
            y, lnl, lnpri, aux = (jax.device_put(a, shard)
                                  for a in (y, lnl, lnpri, aux))
        beta = float(state['beta'])
        logz = float(state['logz'])
        var_sum = float(state['var_sum'])
        betas = list(np.asarray(state['betas']))
        ess_hist = list(np.asarray(state['ess']))
        acc_hist = list(np.asarray(state['acc']))

    def _save_checkpoint():
        if not checkpoint:
            return
        d = os.path.dirname(os.path.abspath(checkpoint))
        os.makedirs(d, exist_ok=True)
        # atomic write-then-rename, matching chains.save_checkpoint: a kill
        # mid-write must not destroy the previous good checkpoint
        tmp = checkpoint + '.tmp.npz'
        np.savez(tmp, y=np.asarray(y), lnl=np.asarray(lnl),
                 lnpri=np.asarray(lnpri), aux=np.asarray(aux),
                 key=np.asarray(key), beta=beta, logz=logz,
                 var_sum=var_sum, betas=np.asarray(betas),
                 ess=np.asarray(ess_hist), acc=np.asarray(acc_hist))
        os.replace(tmp, checkpoint)

    if beta >= 1.0 and state is not None:
        max_stages = 0       # resumed a finished run: fall through to result
    for _ in range(max_stages):
        lnl_h = np.asarray(lnl, dtype=np.float64)
        finite = np.isfinite(lnl_h)
        lnl_h = np.where(finite, lnl_h, -1e30)   # prior draws with L=0
        dbeta = _choose_dbeta(lnl_h, beta, ess_target)
        beta_new = min(beta + dbeta, 1.0)

        lnw = dbeta * lnl_h
        m = lnw.max()
        w = np.exp(lnw - m)
        logz += m + np.log(w.mean())
        w_norm = w / w.sum()
        ess = 1.0 / (n_particles * float((w_norm ** 2).sum()))
        var_sum += max(1.0 / ess - 1.0, 0.0) / n_particles
        ess_hist.append(ess)

        y, lnl, lnpri, aux, key, acc = fns['stage'](
            tables_arg, y, lnl, lnpri, aux, key,
            jnp.asarray(w_norm, dtype=y.dtype), jnp.asarray(beta_new, y.dtype))
        acc_hist.append(float(acc))
        betas.append(beta_new)
        beta = beta_new
        _save_checkpoint()
        log.info('SMC stage %d: beta=%.4f ESS/N=%.2f acc=%.2f logZ=%.3f',
                 len(betas) - 1, beta, ess, float(acc), logz)
        if beta >= 1.0:
            break
    if beta < 1.0:
        raise RuntimeError(f'SMC did not reach beta=1 in {max_stages} stages '
                           '(state saved to the checkpoint if one was given; '
                           'resume=True continues exactly)')

    theta = np.asarray(space.to_bounded(y), dtype=np.float64)
    lnl_h = np.asarray(lnl, dtype=np.float64)
    lnp = lnl_h + np.asarray(space.log_prior(jnp.asarray(theta)))
    se_clt = float(np.sqrt(var_sum))
    result = SMCResult(
        space=space, particles=theta, log_prob=lnp,
        aux=np.asarray(aux, dtype=np.float64),
        logz=float(logz), logz_se=LOGZ_SE_INFLATION * se_clt,
        logz_se_clt=se_clt,
        betas=np.asarray(betas), ess=np.asarray(ess_hist),
        acceptance=np.asarray(acc_hist), elapsed_s=time.time() - t0)
    log.info('SMC done: %d stages, logZ = %.3f +/- %.3f '
             '(CLT se %.3f x %.0f correlation inflation; %.1f s)',
             len(betas) - 1, result.logz, result.logz_se, se_clt,
             LOGZ_SE_INFLATION, result.elapsed_s)
    if output:
        from . import chains as chain_io
        if aux_names is None:
            # the default aux for CCF bundle targets is the chi2 derived
            # column; callable targets return an arbitrary aux statistic and
            # must not inherit that label
            is_callable = isinstance(cache_id, tuple) and cache_id \
                and cache_id[0] == 'callable'
            aux_names = ['aux_0'] if is_callable else ['chi2_ccf_correct']
        chain_io.export_getdist(output, space, theta[:, None, :],
                                lnp[:, None], result.aux[:, None, :],
                                aux_names=aux_names, burn_in=0,
                                n_chain_files=1)
        log.info('posterior particles written to %s.*', output)
    return result
