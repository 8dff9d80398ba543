"""Shared resolution of a likelihood target for the estimation layer.

find_map / profile_scan / run_smc all accept the same three target kinds:
a single-dataset CCFModelBundle, a multi-quantile JointBundle, or a bare
callable params-dict -> (lnlike, aux). This helper is the single place that
dispatches them (previously three near-identical copies, which had already
diverged: the SMC JointBundle branch lost opts_kw/fit_kw from its jit-cache
key, silently reusing functions compiled with the FIRST call's overrides).

The same lesson applies to the pieces the particle samplers share, so they
live here too: `make_unbounded_wrappers` (the scalar/batched likelihood and
prior closures over the unbounded reparameterisation), `guarded_cholesky`
(the jittered, NaN-fallback proposal factor), and `space_cache_key` (the
ParamSpace part of every jit-fn cache key). smc.py and nested.py used to
carry verbatim copies of all three — a fix to the -inf guard, the jitter
floor, or the key fields had four places to miss.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp


class JitFnCache(collections.OrderedDict):
    """Bounded LRU dict for module-level jitted-function caches.

    The sampler/optimizer layers cache compiled segment/init functions per
    (target, params-block, knob) key so repeat calls skip re-lowering the
    big likelihood graphs (tens of seconds each). An unbounded dict pins every
    compiled executable AND everything its key's closures capture — for
    callable targets that includes the user closure and any device tables
    it holds — for the process lifetime (the HBM-leak class api.py's _memo
    comment documents). A seed-study that varies key fields (chunk,
    n_particles, space structure) grows it without limit.

    LRU with a generous bound: eviction only triggers past `maxsize`
    distinct configurations in one process, so steady-state loops (coverage
    mocks, seed studies — a handful of keys, hit every iteration) never
    recompile; a runaway key-churn process stays bounded instead of leaking.
    """

    def __init__(self, maxsize: int = 32):
        super().__init__()
        self.maxsize = maxsize

    def __getitem__(self, key):
        val = super().__getitem__(key)
        self.move_to_end(key)
        return val

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.move_to_end(key)
        while len(self) > self.maxsize:
            self.popitem(last=False)

    def setdefault(self, key, default=None):
        if key in self:
            return self[key]                  # __getitem__ refreshes LRU
        self[key] = default
        return default


@dataclasses.dataclass(frozen=True)
class ProductTarget:
    """Product of INDEPENDENT dataset likelihoods at shared parameters:
    lnL(params) = sum over members (block-diagonal joint covariance, no
    cross-terms — for correlated datasets build a JointBundle with the full
    cross-covariance instead). Members are any target kind resolve_target
    accepts (CCFModelBundle, JointBundle, callable), resolved recursively;
    the member tables travel as a tuple pytree through the jit argument.
    This is the target behind the tension statistics (sampling/tension.py):
    the evidence ratio needs Z of the combined dataset under one shared
    parameter vector."""
    members: tuple


def resolve_perf_kw(theory_opts_list, opts_kw: Optional[Dict],
                    gradient_free: bool) -> Optional[Dict]:
    """Resolve 'auto' perf modes into an opts_kw override dict.

    The JointBundle path applies `opts_kw` uniformly over every member
    bundle, so the resolution must happen in kw space: a field is injected
    only when the caller didn't override it AND every member left it at
    'auto' (a mixed explicit/auto mix is honored as-is — injecting would
    silently override the explicit members). See config.resolve_perf_mode
    for the fast/exact policy and the opt-out.
    """
    from ..config import PERF_MODE_FIELDS, resolve_perf_mode
    kw = dict(opts_kw or {})
    autos = [f for f in PERF_MODE_FIELDS if f not in kw and
             all(getattr(o, f) == 'auto' for o in theory_opts_list)]
    if autos:
        # reuse the policy (and its trace-time log line) on a probe opts
        probe = resolve_perf_mode(theory_opts_list[0], gradient_free)
        kw.update({f: getattr(probe, f) for f in autos})
    return kw or None


def resolve_target(bundle, opts_kw: Optional[Dict], fit_kw: Optional[Dict],
                   gradient_free: bool = False
                   ) -> Tuple[object, callable, tuple]:
    """Returns (tables_arg, loglike(tbl, params) -> (lnl, aux), cache_id).

    `tables_arg` is the pytree to pass as the jit argument; `cache_id` is a
    hashable key covering everything the loglike closure captures (statics,
    option overrides) so jitted functions can be cached per target.

    `gradient_free=True` declares that the returned loglike is only ever
    evaluated forward (no AD through it): 'auto' perf modes resolve to the
    posterior-validated fast modes (config.resolve_perf_mode). Gradient-
    based consumers keep the default False, resolving 'auto' to 'exact'.
    """
    from ..likelihood.core import log_likelihood
    from ..likelihood.multiquantile import JointBundle, joint_log_likelihood

    kw_id = (repr(sorted((opts_kw or {}).items())),
             repr(sorted((fit_kw or {}).items())))

    if isinstance(bundle, ProductTarget):
        parts = [resolve_target(m, opts_kw, fit_kw, gradient_free)
                 for m in bundle.members]
        tables = tuple(p[0] for p in parts)
        fns = tuple(p[1] for p in parts)

        def loglike(tbl, params):
            vals = [fn(t, params) for fn, t in zip(fns, tbl)]
            lnl = sum(v[0] for v in vals)
            aux = sum(v[1] for v in vals)      # summed chi2 across members
            return lnl, aux
        return tables, loglike, ('product', tuple(p[2] for p in parts))

    if callable(bundle) and not hasattr(bundle, 'tables') \
            and not isinstance(bundle, JointBundle):
        user_fn = bundle

        def loglike(tbl, params):
            return user_fn(params)
        return jnp.zeros(()), loglike, ('callable', id(bundle))

    if isinstance(bundle, JointBundle):
        jkw = resolve_perf_kw([b.theory_opts for b in bundle.bundles],
                              opts_kw, gradient_free)
        kw_id = (repr(sorted((jkw or {}).items())), kw_id[1])

        def loglike(tbl, params):
            return joint_log_likelihood(tbl, params, jkw, fit_kw)
        cache_id = ('joint',
                    tuple((b.spec, b.theory_opts) for b in bundle.bundles),
                    bundle.fit_opts, bundle.fixed_covmat, bundle.ndata,
                    kw_id)
        return bundle, loglike, cache_id

    from ..config import resolve_perf_mode
    opts = resolve_perf_mode(bundle.theory_opts.replace(**(opts_kw or {})),
                             gradient_free)
    fit = bundle.fit_opts.replace(**(fit_kw or {}))
    spec = bundle.spec

    def loglike(tbl, params):
        return log_likelihood(tbl, spec, opts, fit, params)
    return bundle.tables, loglike, (spec, opts, fit)


def space_cache_key(space) -> tuple:
    """The ParamSpace component of a jit-fn cache key.

    The sampled tuple is NOT sorted — parameter order is semantic (the
    cached closures bake in the space's theta layout; see find_map's cache
    key and the scrambled-theta regression test)."""
    return (tuple((p.name, p.dist, p.lo, p.hi) for p in space.sampled),
            tuple(sorted(space.fixed.items())),
            tuple((d.name, d.argnames, d.src) for d in space.derived))


def make_unbounded_wrappers(space, loglike, chunk: Optional[int]):
    """(lnlike_scalar, lnprior_scalar, batched_lnlike) over the unbounded
    reparameterisation y = space.to_unbounded(theta).

    Shared by the particle samplers (smc.py, nested.py): non-finite lnL maps
    to -inf (branchless guard), the prior picks up the reparameterisation
    Jacobian, and the batched form chunks through likelihood/batched.py's
    chunked_vmap to bound per-dispatch memory."""
    from ..likelihood.batched import chunked_vmap

    def lnlike_scalar(tbl, y):
        theta = space.to_bounded(y)
        lnl, aux = loglike(tbl, space.full_params(theta))
        return jnp.where(jnp.isfinite(lnl), lnl, -jnp.inf), jnp.stack([aux])

    def lnprior_scalar(y):
        theta = space.to_bounded(y)
        return space.log_prior(theta) + space.log_jacobian(y)

    def batched_lnlike(tbl, ys):
        fn = lambda y: lnlike_scalar(tbl, y)    # noqa: E731
        if chunk and ys.shape[0] > chunk:
            return chunked_vmap(fn, chunk)(ys)
        return jax.vmap(fn)(ys)

    return lnlike_scalar, lnprior_scalar, batched_lnlike


def guarded_cholesky(w, y, scale=1.0):
    """Proposal Cholesky of the w-weighted covariance of y, times the
    Haario 2.38/sqrt(d) factor and `scale`.

    The jitter scales with trace(C)/d (a fixed 1e-10 is below f32 rounding
    on late-stage near-degenerate particle clouds, where the Cholesky can
    NaN and silently freeze every mutation) and a diagonal fallback covers
    the remaining non-finite factors."""
    d = y.shape[1]
    mu = jnp.einsum('i,ij->j', w, y, precision='highest')
    yc = y - mu
    C = jnp.einsum('i,ij,ik->jk', w, yc, yc, precision='highest')
    jitter = jnp.maximum(1e-6 * jnp.trace(C) / d, 1e-30)
    C = C + jitter * jnp.eye(d)
    chol = jnp.linalg.cholesky(C)
    chol = jnp.where(jnp.isfinite(chol).all(), chol,
                     jnp.diag(jnp.sqrt(jnp.diag(C))))
    return chol * (2.38 / jnp.sqrt(d)) * scale
