"""Batched likelihood evaluation: thousands of parameter points per dispatch.

The reference evaluates strictly one parameter point per `log_likelihood` call
(victor/ccf_fit.py:356) and parallelises only via independent MPI chain
processes. Here the likelihood is a pure function of a parameter pytree, so
batching is a `jax.vmap` and multi-chip scaling is a sharding annotation —
no message passing, no per-point Python overhead.

Typical use::

    bundle = build_tables(cfg['model'], cfg['data'])
    lnlike = make_loglike(bundle, ['fsigma8', 'beta', 'sigma_v', 'epsilon'])
    batched = make_batched_loglike(bundle, ['fsigma8', 'beta', 'sigma_v', 'epsilon'])
    lnl, chi2 = batched(theta)           # theta: (N, 4) -> (N,), (N,)
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp

from ..io.tables import CCFModelBundle
from .core import log_likelihood


def theta_to_params(theta: jnp.ndarray, param_names: Sequence[str],
                    base_params: Optional[Dict] = None) -> Dict:
    """Map a flat parameter vector (P,) to the params dict the core consumes.

    `base_params` supplies fixed (non-sampled) values; sampled entries override.
    """
    params = dict(base_params or {})
    for i, name in enumerate(param_names):
        params[name] = theta[..., i]
    return params


def make_loglike(bundle: CCFModelBundle, param_names: Sequence[str],
                 base_params: Optional[Dict] = None,
                 opts_kw: Optional[Dict] = None, fit_kw: Optional[Dict] = None,
                 jit: bool = True):
    """Jitted scalar log-likelihood: theta (P,) -> (lnlike, chisq).

    The tables pytree is passed as a jit *argument*, never a closure constant:
    embedding it as constants makes MLIR lowering read every array back from
    the device and bakes the tables into the compiled program.
    """
    opts = bundle.theory_opts.replace(**(opts_kw or {}))
    fit = bundle.fit_opts.replace(**(fit_kw or {}))
    tables, spec = bundle.tables, bundle.spec
    names = tuple(param_names)
    base = {k: jnp.asarray(v) for k, v in (base_params or {}).items()}

    def fn(tbl, theta):
        params = theta_to_params(theta, names, base)
        return log_likelihood(tbl, spec, opts, fit, params)

    if not jit:
        return functools.partial(fn, tables)
    jfn = jax.jit(fn)
    return lambda theta: jfn(tables, theta)


def chunked_vmap(fn, chunk: int):
    """vmap `fn`, processing the batch in fixed-size chunks under lax.map.

    The theory grid is ~150k points per parameter set, so an unchunked vmap
    over thousands of points would materialise tens of GB of intermediates;
    chunking keeps peak memory at chunk * grid while XLA still vectorises
    fully within each chunk. Batch sizes not divisible by `chunk` are padded
    (the pad rows are evaluated and discarded).
    """
    vfn = jax.vmap(fn)

    def run(theta):
        n = theta.shape[0]
        n_chunks = -(-n // chunk)
        pad = n_chunks * chunk - n
        theta_p = jnp.concatenate([theta, theta[:1].repeat(pad, 0)], axis=0) \
            if pad else theta
        chunks = theta_p.reshape(n_chunks, chunk, *theta.shape[1:])
        out = jax.lax.map(vfn, chunks)
        return jax.tree_util.tree_map(
            lambda x: x.reshape(n_chunks * chunk, *x.shape[2:])[:n], out)

    return run


def make_batched_loglike(bundle: CCFModelBundle, param_names: Sequence[str],
                         base_params: Optional[Dict] = None,
                         opts_kw: Optional[Dict] = None,
                         fit_kw: Optional[Dict] = None,
                         jit: bool = True, chunk: Optional[int] = None,
                         gradient_free: bool = True):
    """Jitted batched log-likelihood: theta (N, P) -> ((N,), (N,)).

    The whole theory pipeline (splines, velocity integral, multipole
    projection, covariance solve) is vmapped, so a single dispatch evaluates
    the full batch as large fused tensor ops. `chunk` bounds peak
    memory for large batches (see `chunked_vmap`); None vmaps the whole batch.

    This is the throughput surface (bench, quadrature, coverage), so
    `gradient_free=True` by default: 'auto' perf modes resolve to the
    posterior-validated fast modes (config.resolve_perf_mode). Pass
    gradient_free=False (or explicit opts_kw) before differentiating
    through the returned function.
    """
    from ..config import resolve_perf_mode
    opts = resolve_perf_mode(bundle.theory_opts.replace(**(opts_kw or {})),
                             gradient_free)
    fit = bundle.fit_opts.replace(**(fit_kw or {}))
    tables, spec = bundle.tables, bundle.spec
    names = tuple(param_names)
    base = {k: jnp.asarray(v) for k, v in (base_params or {}).items()}

    def scalar(tbl, theta):
        params = theta_to_params(theta, names, base)
        return log_likelihood(tbl, spec, opts, fit, params)

    def fn(tbl, theta):
        mapped = lambda th: scalar(tbl, th)  # noqa: E731
        # > chunk (not bare truthiness): a batch smaller than one chunk
        # would otherwise be padded up to a full chunk and evaluated whole
        # (same guard as multiquantile / targets.make_unbounded_wrappers)
        if chunk and theta.shape[0] > chunk:
            return chunked_vmap(mapped, chunk)(theta)
        return jax.vmap(mapped)(theta)

    if not jit:
        return functools.partial(fn, tables)
    jfn = jax.jit(fn)
    return lambda theta: jfn(tables, theta)


def make_sharded_loglike(bundle: CCFModelBundle, param_names: Sequence[str],
                         mesh: jax.sharding.Mesh, axis: str = 'walkers',
                         base_params: Optional[Dict] = None,
                         opts_kw: Optional[Dict] = None,
                         fit_kw: Optional[Dict] = None,
                         gradient_free: bool = True):
    """Batched log-likelihood sharded over a device mesh axis.

    Tables are replicated (a few MB); the parameter batch is sharded along
    `axis`, so each chip evaluates its slice and no collectives are needed in
    the forward pass — the on-device replacement for the reference's
    "independent MPI chains" model (victor/README.md:30).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..config import resolve_perf_mode
    opts = resolve_perf_mode(bundle.theory_opts.replace(**(opts_kw or {})),
                             gradient_free)
    fit = bundle.fit_opts.replace(**(fit_kw or {}))
    tables, spec = bundle.tables, bundle.spec
    names = tuple(param_names)
    base = {k: jnp.asarray(v) for k, v in (base_params or {}).items()}

    def fn(tbl, theta):
        def scalar(th):
            params = theta_to_params(th, names, base)
            return log_likelihood(tbl, spec, opts, fit, params)
        return jax.vmap(scalar)(theta)

    rep = NamedSharding(mesh, P())
    in_spec = NamedSharding(mesh, P(axis))
    out_spec = NamedSharding(mesh, P(axis))
    jfn = jax.jit(fn, in_shardings=(rep, in_spec),
                  out_shardings=(out_spec, out_spec))
    tables_rep = jax.device_put(tables, rep)
    return lambda theta: jfn(tables_rep, theta)
