"""No-U-Turn Sampler: dynamic trajectory lengths on top of the HMC machinery.

The reference delegates sampling to cobaya's random-walk Metropolis
(victor/README.md:30); victor_tpu's flagship sampler is dense-mass HMC with
jittered trajectory lengths (sampling/hmc.py), which suffices for BOSS-like
posteriors. NUTS removes the trajectory-length tuning entirely: each
transition doubles a leapfrog trajectory until the path starts to U-turn,
and draws the next state multinomially from the whole trajectory
(Hoffman & Gelman 2014; multinomial/biased-progressive form of Betancourt
1701.02434). It is the robust choice for harder/curved posteriors (e.g.
high-dimensional joint density-split fits).

Device design: the recursive tree build is rewritten ITERATIVELY (the
recursion is data-dependent and unbounded, which XLA cannot trace):

  * the outer doubling loop is a `lax.while_loop` over tree depth;
  * each doubling runs 2^depth leapfrog steps in a `lax.while_loop` whose
    body contains exactly ONE posterior+gradient evaluation — the whole
    likelihood graph appears once in the trace, as in hmc.py;
  * the within-subtree U-turn checks of the recursive algorithm are
    reproduced exactly with an O(max_depth) checkpoint buffer: writing leaf
    m (m even) to slot popcount(m), and checking an odd leaf n against the
    contiguous slot range [popcount(n >> t), popcount(n) - 1] where t is
    the number of trailing one-bits of n — these are precisely the internal
    tree nodes whose rightmost leaf is n (verified against the recursive
    enumeration in tests/test_sampling.py).

Warmup (staged eps -> diagonal -> dense metric, dual averaging) is shared
with HMC: the state is an hmc.HMCState and the stage transitions are the
same functions, so `runner.run_hmc_mcmc(algorithm='nuts')` gets segmented
dispatches, checkpoints, exact resume and mesh sharding for free.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .hmc import (HMCState, _adapt_and_pack, _mv, init_state,
                  staged_segment)

_DIVERGENCE = 1000.0     # Stan's Delta_max energy-error cutoff


class _TreeState(NamedTuple):
    """Carry of the iterative tree build (one chain)."""
    # current (rightmost-in-direction) point
    q: jnp.ndarray
    p: jnp.ndarray
    grad: jnp.ndarray
    lnp: jnp.ndarray
    aux: jnp.ndarray
    # multinomial proposal drawn from the subtree so far
    q_prop: jnp.ndarray
    lnp_prop: jnp.ndarray
    grad_prop: jnp.ndarray
    aux_prop: jnp.ndarray
    log_sum_w: jnp.ndarray       # logsumexp of -H over subtree leaves
    sum_accept: jnp.ndarray      # sum of min(1, exp(H0 - H_leaf))
    # U-turn checkpoint buffers (max_depth slots)
    q_ckpt: jnp.ndarray          # (max_depth, ndim)
    v_ckpt: jnp.ndarray          # (max_depth, ndim) velocities M^-1 p
    leaf: jnp.ndarray            # leaf counter within the subtree
    turning: jnp.ndarray
    diverging: jnp.ndarray
    key: jax.Array


def _popcount(n):
    """Population count for small non-negative int32 (max_depth <= 16)."""
    bits = (n[..., None] >> jnp.arange(16)) & 1
    return jnp.sum(bits, axis=-1)


def _trailing_ones(n):
    bits = (n[..., None] >> jnp.arange(16)) & 1
    return jnp.sum(jnp.cumprod(bits, axis=-1), axis=-1)


def _is_turning(q_minus, v_minus, q_plus, v_plus):
    """Generalised U-turn criterion with velocities v = M^-1 p."""
    dq = q_plus - q_minus
    return (jnp.dot(dq, v_minus, precision='highest') < 0.0) | \
        (jnp.dot(dq, v_plus, precision='highest') < 0.0)


def _leapfrog(value_grad: Callable, q, p, grad, eps, L):
    """One leapfrog step with dense inverse mass LL^T; returns the new
    point and its velocity/energy pieces."""
    p = p + 0.5 * eps * grad
    q = q + eps * _mv(L, _mv(L.T, p))
    (lnp, aux), grad = value_grad(q)
    p = p + 0.5 * eps * grad
    v = _mv(L, _mv(L.T, p))
    ke = 0.5 * jnp.sum(_mv(L.T, p) ** 2)
    return q, p, grad, lnp, aux, v, ke


def _build_subtree(value_grad: Callable, ts: _TreeState, depth, eps, L, H0,
                   max_depth: int):
    """Run 2^depth leapfrog steps from ts.(q,p,grad), accumulating the
    multinomial proposal and performing the recursive algorithm's U-turn
    checks via the checkpoint scheme (module docstring)."""
    n_steps = jnp.int32(1) << depth

    def cond(ts):
        return (ts.leaf < n_steps) & ~ts.turning & ~ts.diverging

    def body(ts):
        q, p, grad, lnp, aux, v, ke = _leapfrog(
            value_grad, ts.q, ts.p, ts.grad, eps, L)
        H = -lnp + ke
        dH = H - H0
        dH = jnp.where(jnp.isnan(dH), jnp.inf, dH)
        diverging = dH > _DIVERGENCE
        log_w = -H
        # multinomial within-subtree proposal: switch with prob
        # exp(log_w - logaddexp(log_sum_w, log_w))
        key, k_sw = jax.random.split(ts.key)
        log_total = jnp.logaddexp(ts.log_sum_w, log_w)
        take = jnp.log(jax.random.uniform(k_sw, ())) < (log_w - log_total)
        take = take & ~diverging
        q_prop = jnp.where(take, q, ts.q_prop)
        lnp_prop = jnp.where(take, lnp, ts.lnp_prop)
        grad_prop = jnp.where(take, grad, ts.grad_prop)
        aux_prop = jnp.where(take, aux, ts.aux_prop)
        sum_accept = ts.sum_accept + jnp.minimum(1.0, jnp.exp(-dH))
        log_sum_w = jnp.where(diverging, ts.log_sum_w, log_total)

        n = ts.leaf
        even = (n % 2) == 0
        # store even leaves at slot popcount(n)
        slot = _popcount(n)
        q_ckpt = jnp.where(even, ts.q_ckpt.at[slot].set(q), ts.q_ckpt)
        v_ckpt = jnp.where(even, ts.v_ckpt.at[slot].set(v), ts.v_ckpt)
        # check odd leaves against slots [popcount(n >> t), popcount(n)-1]
        t = _trailing_ones(n)
        idx_min = _popcount(n >> t)
        idx_max = _popcount(n) - 1

        def check(j, turning):
            active = (~even) & (j >= idx_min) & (j <= idx_max)
            turn_j = _is_turning(q_ckpt[j], v_ckpt[j], q, v)
            return turning | (active & turn_j)

        turning = lax.fori_loop(0, max_depth, check, ts.turning)

        return _TreeState(q=q, p=p, grad=grad, lnp=lnp, aux=aux,
                          q_prop=q_prop, lnp_prop=lnp_prop,
                          grad_prop=grad_prop, aux_prop=aux_prop,
                          log_sum_w=log_sum_w, sum_accept=sum_accept,
                          q_ckpt=q_ckpt, v_ckpt=v_ckpt, leaf=n + 1,
                          turning=turning, diverging=diverging, key=key)

    return lax.while_loop(cond, body, ts)


def _nuts_step(value_grad: Callable, state: HMCState, max_depth: int,
               adapt, target_accept: float = 0.8,
               mu_offset: float = 1.5) -> HMCState:
    """One NUTS transition (one chain) + shared warmup adaptation."""
    import jax.scipy.linalg as jsl
    ndim = state.q.shape[0]
    key, k_mom, k_tree = jax.random.split(state.key, 3)
    L = state.chol_cov
    eps = jnp.exp(state.log_eps)
    xi = jax.random.normal(k_mom, (ndim,))
    p0 = jsl.solve_triangular(L.T, xi, lower=False)
    v0 = _mv(L, _mv(L.T, p0))
    H0 = -state.lnp + 0.5 * jnp.sum(_mv(L.T, p0) ** 2)

    # global tree: endpoints with momenta pointing OUTWARD
    class_carry = dict(
        q_l=state.q, p_l=-p0, grad_l=state.grad, v_l=-v0,
        q_r=state.q, p_r=p0, grad_r=state.grad, v_r=v0,
        q_prop=state.q, lnp_prop=state.lnp, grad_prop=state.grad,
        aux_prop=state.aux,
        log_sum_w=-H0 * jnp.ones(()),
        sum_accept=jnp.zeros(()), n_leaves=jnp.zeros(()),
        depth=jnp.zeros((), jnp.int32),
        turning=jnp.zeros((), bool), diverging=jnp.zeros((), bool),
        key=k_tree)

    def cond(c):
        return (c['depth'] < max_depth) & ~c['turning'] & ~c['diverging']

    def body(c):
        key, k_dir, k_merge, k_sub = jax.random.split(c['key'], 4)
        go_right = jax.random.bernoulli(k_dir)
        q0 = jnp.where(go_right, c['q_r'], c['q_l'])
        p0s = jnp.where(go_right, c['p_r'], c['p_l'])
        g0 = jnp.where(go_right, c['grad_r'], c['grad_l'])

        ts = _TreeState(
            q=q0, p=p0s, grad=g0, lnp=jnp.zeros(()), aux=c['aux_prop'],
            q_prop=q0, lnp_prop=-jnp.inf * jnp.ones(()),
            grad_prop=g0, aux_prop=c['aux_prop'],
            log_sum_w=-jnp.inf * jnp.ones(()), sum_accept=jnp.zeros(()),
            q_ckpt=jnp.zeros((max_depth, ndim)),
            v_ckpt=jnp.zeros((max_depth, ndim)),
            leaf=jnp.zeros((), jnp.int32),
            turning=jnp.zeros((), bool), diverging=jnp.zeros((), bool),
            key=k_sub)
        ts = _build_subtree(value_grad, ts, c['depth'], eps, L, H0, max_depth)

        sum_accept = c['sum_accept'] + ts.sum_accept
        n_leaves = c['n_leaves'] + ts.leaf.astype(c['n_leaves'].dtype)
        ok = ~ts.turning & ~ts.diverging

        # biased progressive sampling: take the new subtree's proposal with
        # prob min(1, W_new / W_old)
        take = jnp.log(jax.random.uniform(k_merge, ())) < \
            (ts.log_sum_w - c['log_sum_w'])
        take = take & ok
        q_prop = jnp.where(take, ts.q_prop, c['q_prop'])
        lnp_prop = jnp.where(take, ts.lnp_prop, c['lnp_prop'])
        grad_prop = jnp.where(take, ts.grad_prop, c['grad_prop'])
        aux_prop = jnp.where(take, ts.aux_prop, c['aux_prop'])
        log_sum_w = jnp.where(ok, jnp.logaddexp(c['log_sum_w'], ts.log_sum_w),
                              c['log_sum_w'])

        # update the moved endpoint; outward momentum on the left is -p
        v_new = _mv(L, _mv(L.T, ts.p))
        q_l = jnp.where(go_right, c['q_l'], ts.q)
        p_l = jnp.where(go_right, c['p_l'], ts.p)
        grad_l = jnp.where(go_right, c['grad_l'], ts.grad)
        v_l = jnp.where(go_right, c['v_l'], v_new)
        q_r = jnp.where(go_right, ts.q, c['q_r'])
        p_r = jnp.where(go_right, ts.p, c['p_r'])
        grad_r = jnp.where(go_right, ts.grad, c['grad_r'])
        v_r = jnp.where(go_right, v_new, c['v_r'])

        # full-tree U-turn check (momenta point outward: negate the left one)
        turning_tree = _is_turning(q_l, -v_l, q_r, v_r)
        turning = ts.turning | (ok & turning_tree)

        return dict(q_l=q_l, p_l=p_l, grad_l=grad_l, v_l=v_l,
                    q_r=q_r, p_r=p_r, grad_r=grad_r, v_r=v_r,
                    q_prop=q_prop, lnp_prop=lnp_prop, grad_prop=grad_prop,
                    aux_prop=aux_prop, log_sum_w=log_sum_w,
                    sum_accept=sum_accept, n_leaves=n_leaves,
                    depth=c['depth'] + 1,
                    turning=turning, diverging=ts.diverging, key=key)

    c = lax.while_loop(cond, body, class_carry)

    moved = jnp.any(c['q_prop'] != state.q)
    accept_stat = c['sum_accept'] / jnp.maximum(c['n_leaves'], 1.0)
    return _adapt_and_pack(state, c['q_prop'], c['lnp_prop'], c['grad_prop'],
                           c['aux_prop'], key, accept_stat, moved, adapt,
                           target_accept, mu_offset=mu_offset)


def chain_segment(value_grad: Callable, state: HMCState, i0, length: int,
                  n_warmup: int, max_depth: int = 8, eps0: float = 0.1,
                  target_accept: float = 0.8
                  ) -> Tuple[HMCState, Tuple[jnp.ndarray, ...]]:
    """Advance one NUTS chain `length` steps from global index i0, with the
    same staged warmup (eps -> diag metric -> dense metric -> freeze) and
    segmentation semantics as hmc.chain_segment."""
    if not 1 <= max_depth <= 16:
        # _popcount/_trailing_ones index 16 bits; beyond that the U-turn
        # bookkeeping would silently corrupt (and 2^16 leapfrogs per step is
        # already far past any sane trajectory)
        from ..errors import InputError
        raise InputError(f'NUTS max_depth must be in [1, 16], got {max_depth}')
    return staged_segment(
        lambda st, adapt, mu: _nuts_step(value_grad, st, max_depth, adapt,
                                         target_accept, mu_offset=mu),
        state, i0, length, n_warmup, eps0)


def run_segment(logpost_y: Callable, states: HMCState, i0, length: int,
                n_warmup: int, max_depth: int = 8, eps0: float = 0.1,
                target_accept: float = 0.8):
    """Vmapped NUTS segment over the chain axis (one bounded dispatch)."""
    value_grad = jax.value_and_grad(logpost_y, has_aux=True)
    return jax.vmap(
        lambda st: chain_segment(value_grad, st, i0, length, n_warmup,
                                 max_depth, eps0, target_accept))(states)


def run_nuts(logpost_y: Callable, y0: jnp.ndarray, key: jax.Array = None,
             n_warmup: int = 300, n_samples: int = 700, max_depth: int = 8,
             eps0: float = 0.1, target_accept: float = 0.8,
             keys: jax.Array = None):
    """Vmapped independent NUTS chains (single-dispatch convenience API,
    mirroring hmc.run_hmc)."""
    value_grad = jax.value_and_grad(logpost_y, has_aux=True)

    def one_chain(q0, k):
        state = init_state(value_grad, q0, k, eps0)
        state, samples = chain_segment(value_grad, state,
                                       jnp.zeros((), jnp.int32),
                                       n_warmup + n_samples, n_warmup,
                                       max_depth, eps0, target_accept)
        return state, jax.tree.map(lambda x: x[n_warmup:], samples)

    if keys is None:
        keys = jax.random.split(key, y0.shape[0])
    return jax.vmap(one_chain)(y0, keys)
