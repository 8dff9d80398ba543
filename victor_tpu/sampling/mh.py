"""Adaptive random-walk Metropolis: the reference's own sampler, on device.

The reference samples with cobaya's Metropolis-Hastings over MPI processes
(victor/README.md:30; config/boss_cobaya_config.yaml:44-48 — proposal widths
per parameter, covariance learned during burn-in). This is the on-device
equivalent: vmapped independent chains whose Gaussian proposal uses the
SAME staged adaptation machinery as HMC (sampling/hmc.py) — Welford
accumulation of the dense chain covariance (identity -> diagonal -> dense,
Haario-style) plus dual averaging of a global scale toward the
Roberts-Gelman-Gilks random-walk optimum of 0.234 acceptance.

Why ship it next to HMC/NUTS: (1) sampler-family parity — a reference user
migrating a cobaya MH workflow gets the same algorithm class, adapted the
same way cobaya adapts (covariance learning), with the same chain-file
output; (2) MH is gradient-free, so the forward-only fast modes
(`streaming_eval='fast'`, `dispersion_final='fast'`) compose — the same
property that makes SMC/NS 1.3x faster applies here, whereas HMC must keep
the exact path (BASELINE.md round 3); (3) a cross-check of gradient-based
posteriors by a method with no gradient in it.

State reuses HMCState (grad pinned to zeros — never read): the checkpoint
serialization (chains.save_hmc_checkpoint), the staged warmup scan
(hmc.staged_segment) and the runner's segmented dispatch loop
(runner.run_hmc_mcmc) all work unchanged, and a schedule fix applies to all
three samplers at once.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from ..ops.splines import matmul_highest as _mv
from .hmc import HMCState, _adapt_and_pack, staged_segment

# random-walk optimum (Roberts, Gelman & Gilks 1997); HMC's 0.8 would force
# vanishing steps
TARGET_ACCEPT = 0.234


def _default_eps0(ndim: int) -> float:
    """Optimal RWM scale 2.38/sqrt(d) once the proposal matches the posterior
    covariance — the dual-averaging anchor; adaptation refines from here."""
    return 2.38 / float(ndim) ** 0.5


def _mh_step(value_fn: Callable, state: HMCState, adapt,
             target_accept: float = TARGET_ACCEPT,
             mu_offset: float = 1.5) -> HMCState:
    key, k_prop, k_acc = jax.random.split(state.key, 3)
    eps = jnp.exp(state.log_eps)
    xi = jax.random.normal(k_prop, state.q.shape)
    # symmetric Gaussian proposal with covariance eps^2 * (L L^T), L the
    # staged Welford Cholesky — cobaya's learned proposal covariance role
    q1 = state.q + eps * _mv(state.chol_cov, xi)
    lnp1, aux1 = value_fn(q1)
    log_accept = lnp1 - state.lnp
    log_accept = jnp.where(jnp.isnan(log_accept), -jnp.inf, log_accept)
    accept_prob = jnp.minimum(1.0, jnp.exp(log_accept))
    accept = jnp.log(jax.random.uniform(k_acc, ())) < log_accept

    q = jnp.where(accept, q1, state.q)
    lnp = jnp.where(accept, lnp1, state.lnp)
    aux = jnp.where(accept, aux1, state.aux)
    return _adapt_and_pack(state, q, lnp, state.grad, aux, key, accept_prob,
                           accept, adapt, target_accept, mu_offset=mu_offset)


def init_state(value_fn: Callable, q0: jnp.ndarray, key: jax.Array,
               eps0: float = None, chol0: jnp.ndarray = None) -> HMCState:
    """Value-only init (no gradient graph is ever built or compiled).

    `chol0`: optional (ndim, ndim) initial proposal-covariance Cholesky —
    the role of cobaya's per-parameter `proposal:` widths / input `covmat`
    (diag of y-space widths, or the Cholesky of a converted covmat). The
    Welford staging replaces it from the chain's own covariance at the
    first warmup reset; a good seed just makes stage-1 mix immediately."""
    lnp, aux = value_fn(q0)
    ndim = q0.shape[0]
    eps0 = _default_eps0(ndim) if eps0 is None else eps0
    return HMCState(
        q=q0, lnp=lnp, grad=jnp.zeros(ndim), aux=jnp.atleast_1d(aux), key=key,
        log_eps=jnp.log(jnp.asarray(eps0)),
        log_eps_avg=jnp.log(jnp.asarray(eps0)),
        h_bar=jnp.zeros(()),
        welford_mean=jnp.zeros(ndim), welford_m2=jnp.zeros((ndim, ndim)),
        welford_n=jnp.zeros(()),
        chol_cov=jnp.eye(ndim) if chol0 is None else chol0,
        n_accepted=jnp.zeros(()))


def chain_segment(value_fn: Callable, state: HMCState, i0, length: int,
                  n_warmup: int, eps0: float = None,
                  target_accept: float = TARGET_ACCEPT
                  ) -> Tuple[HMCState, Tuple[jnp.ndarray, ...]]:
    """Advance ONE chain `length` MH steps from global step `i0` (same
    staged-warmup schedule and bit-identical segmenting as HMC/NUTS)."""
    eps0 = _default_eps0(state.q.shape[0]) if eps0 is None else eps0
    return staged_segment(
        lambda st, adapt, mu: _mh_step(value_fn, st, adapt, target_accept,
                                       mu_offset=mu),
        state, i0, length, n_warmup, eps0)


def init_chains(logpost_y: Callable, y0: jnp.ndarray, keys: jax.Array,
                eps0: float = None, chol0: jnp.ndarray = None) -> HMCState:
    """Vmapped initial state for a batch of chains (value-only).

    `chol0`: optional initial proposal Cholesky, (ndim, ndim) shared or
    (n_chains, ndim, ndim) per-chain."""
    if chol0 is None:
        return jax.vmap(lambda q, k: init_state(logpost_y, q, k, eps0))(
            y0, keys)
    chol0 = jnp.broadcast_to(chol0, y0.shape + y0.shape[-1:])
    return jax.vmap(lambda q, k, c: init_state(logpost_y, q, k, eps0, c))(
        y0, keys, chol0)


def run_segment(logpost_y: Callable, states: HMCState, i0, length: int,
                n_warmup: int, eps0: float = None,
                target_accept: float = TARGET_ACCEPT):
    """Vmapped chain_segment over the chain axis: one bounded dispatch.

    logpost_y(y) -> (lnp, aux); unlike hmc/nuts.run_segment this never calls
    jax.grad — the traced program is the forward likelihood only, so it
    compiles faster and forward-only fast modes keep their full speedup.
    """
    return jax.vmap(
        lambda st: chain_segment(logpost_y, st, i0, length, n_warmup,
                                 eps0, target_accept))(states)
