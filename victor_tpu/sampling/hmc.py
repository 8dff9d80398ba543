"""Hamiltonian Monte Carlo with on-device warmup adaptation.

The gradient-based companion to the ensemble sampler: the entire likelihood
(splines, velocity convolution, covariance solve) is exactly differentiable
under `jax.grad` (AD matches finite differences to ~1e-6), so HMC cuts the
per-walker autocorrelation of the stretch move by an order of magnitude —
this is what makes the cobaya R−1 < 0.01 criterion reachable in seconds of
wall-clock on one accelerator, versus minutes for random-walk samplers.

Design: chains are fully independent and vmapped. Each chain adapts its own
step size by dual averaging and a DENSE mass matrix (full posterior
covariance, Welford-accumulated) through Stan-style staged warmup, with
jittered trajectory lengths; bounded (uniform-prior) parameters are sampled
in an
unbounded logit reparameterisation with the exact log-Jacobian
(ParamSpace.to_unbounded / log_jacobian), so trajectories never hit the
support boundary. Everything — warmup and sampling — runs under `lax.scan`
inside one jit.

No reference counterpart (victor delegates sampling to cobaya's
random-walk Metropolis, victor/README.md:30).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

# full-precision matvecs: XLA's default f32 matmul precision (TF32 on the
# GPU) would perturb leapfrog trajectories and kinetic energies at ~1e-3,
# skewing the acceptance statistic that drives dual averaging
from ..ops.splines import matmul_highest as _mv  # noqa: E402


class HMCState(NamedTuple):
    q: jnp.ndarray            # (ndim,) position (unbounded space)
    lnp: jnp.ndarray          # scalar log posterior at q
    grad: jnp.ndarray         # (ndim,) gradient at q
    aux: jnp.ndarray          # (n_aux,) auxiliary outputs (e.g. chi2)
    key: jax.Array
    # adaptation state
    log_eps: jnp.ndarray      # current log step size
    log_eps_avg: jnp.ndarray  # dual-averaging iterate
    h_bar: jnp.ndarray        # dual-averaging error accumulator
    welford_mean: jnp.ndarray
    welford_m2: jnp.ndarray   # (ndim, ndim) full-covariance accumulator
    welford_n: jnp.ndarray
    chol_cov: jnp.ndarray     # (ndim, ndim) lower Cholesky of the position
                              # covariance estimate == inverse mass matrix
    n_accepted: jnp.ndarray


def _leapfrog(value_grad: Callable, q, p, grad, lnp, aux, eps, chol_cov,
              n_steps: int):
    """n_steps leapfrog integration steps with a dense (inverse-)mass matrix
    Sigma = L L^T; returns (q, p, lnp, grad, aux).

    (lnp, aux) ride through the carry so the trajectory costs exactly ONE
    posterior+gradient evaluation per step — a post-loop re-evaluation would
    double the dominant subgraph in the traced program (the full likelihood
    forward+backward), doubling HMC compile time."""
    def body(_, carry):
        q, p, grad, lnp, aux = carry
        p = p + 0.5 * eps * grad
        q = q + eps * _mv(chol_cov, _mv(chol_cov.T, p))
        (lnp, aux), grad = value_grad(q)
        p = p + 0.5 * eps * grad
        return (q, p, grad, lnp, aux)

    return lax.fori_loop(0, n_steps, body, (q, p, grad, lnp, aux))


def _hmc_step(value_grad: Callable, state: HMCState, n_leapfrog: int,
              adapt: bool, target_accept: float = 0.8,
              t0: float = 10.0, gamma: float = 0.05, kappa: float = 0.75,
              mu_offset: float = 1.5) -> HMCState:
    import jax.scipy.linalg as jsl
    key, k_mom, k_acc, k_jit, k_len = jax.random.split(state.key, 5)
    eps = jnp.exp(state.log_eps) * \
        jax.random.uniform(k_jit, (), minval=0.9, maxval=1.1)
    # jittered trajectory length breaks the periodic return of fixed-length
    # trajectories (which wrecks ESS once the dense metric isotropises the
    # posterior)
    n_steps = jax.random.randint(k_len, (), max(1, n_leapfrog // 2),
                                 n_leapfrog + 1)
    L = state.chol_cov
    # momenta ~ N(0, M) with M = (L L^T)^{-1}: p = L^{-T} xi
    xi = jax.random.normal(k_mom, state.q.shape)
    p0 = jsl.solve_triangular(L.T, xi, lower=False)
    ke0 = 0.5 * jnp.sum(_mv(L.T, p0) ** 2)

    q1, p1, grad1, lnp1, aux1 = _leapfrog(value_grad, state.q, p0, state.grad,
                                          state.lnp, state.aux, eps, L, n_steps)
    ke1 = 0.5 * jnp.sum(_mv(L.T, p1) ** 2)
    log_accept = (lnp1 - ke1) - (state.lnp - ke0)
    log_accept = jnp.where(jnp.isnan(log_accept), -jnp.inf, log_accept)
    accept_prob = jnp.minimum(1.0, jnp.exp(log_accept))
    accept = jnp.log(jax.random.uniform(k_acc, ())) < log_accept

    q = jnp.where(accept, q1, state.q)
    lnp = jnp.where(accept, lnp1, state.lnp)
    grad = jnp.where(accept, grad1, state.grad)
    aux = jnp.where(accept, aux1, state.aux)

    return _adapt_and_pack(state, q, lnp, grad, aux, key, accept_prob,
                           accept, adapt, target_accept, t0, gamma, kappa,
                           mu_offset)


def _adapt_and_pack(state: HMCState, q, lnp, grad, aux, key, accept_stat,
                    accept, adapt, target_accept: float,
                    t0: float = 10.0, gamma: float = 0.05,
                    kappa: float = 0.75, mu_offset: float = 1.5) -> HMCState:
    """Shared post-transition adaptation (used by both HMC and NUTS steps):
    dual averaging of log eps toward the target acceptance statistic (Hoffman
    & Gelman 2014 §3.2) + Welford accumulation of the full posterior
    covariance (dense mass), both frozen outside warmup."""
    n = state.welford_n + 1.0
    h_bar = jnp.where(
        adapt,
        (1.0 - 1.0 / (n + t0)) * state.h_bar
        + (target_accept - accept_stat) / (n + t0),
        state.h_bar)
    # mu_offset anchors the shrinkage point at log(10 * eps0)
    log_eps = jnp.where(adapt, mu_offset - jnp.sqrt(n) / gamma * h_bar,
                        state.log_eps)
    w = n ** (-kappa)
    log_eps_avg = jnp.where(adapt, w * log_eps + (1.0 - w) * state.log_eps_avg,
                            state.log_eps_avg)

    delta = q - state.welford_mean
    welford_mean = jnp.where(adapt, state.welford_mean + delta / n,
                             state.welford_mean)
    welford_m2 = jnp.where(adapt,
                           state.welford_m2
                           + jnp.outer(delta, q - welford_mean),
                           state.welford_m2)

    return HMCState(q=q, lnp=lnp, grad=grad, aux=aux, key=key,
                    log_eps=log_eps, log_eps_avg=log_eps_avg, h_bar=h_bar,
                    welford_mean=welford_mean, welford_m2=welford_m2,
                    welford_n=jnp.where(adapt, n, state.welford_n),
                    chol_cov=state.chol_cov,
                    n_accepted=state.n_accepted + accept)


def init_state(value_grad: Callable, q0: jnp.ndarray, key: jax.Array,
               eps0: float = 0.1, chol0: jnp.ndarray = None) -> HMCState:
    """`chol0`: optional (ndim, ndim) initial Cholesky of the INVERSE mass
    matrix (= position-covariance estimate) — seeds the metric from a
    cobaya-style input covmat; the staged warmup replaces it from the
    chain's own Welford covariance at the first reset."""
    (lnp, aux), grad = value_grad(q0)
    ndim = q0.shape[0]
    return HMCState(
        q=q0, lnp=lnp, grad=grad, aux=jnp.atleast_1d(aux), key=key,
        log_eps=jnp.log(jnp.asarray(eps0)),
        log_eps_avg=jnp.log(jnp.asarray(eps0)),
        h_bar=jnp.zeros(()),
        welford_mean=jnp.zeros(ndim), welford_m2=jnp.zeros((ndim, ndim)),
        welford_n=jnp.zeros(()),
        chol_cov=jnp.eye(ndim) if chol0 is None else chol0,
        n_accepted=jnp.zeros(()))


def warmup_and_sample(value_grad: Callable, q0: jnp.ndarray, key: jax.Array,
                      n_warmup: int, n_samples: int, n_leapfrog: int = 16,
                      eps0: float = 0.1, target_accept: float = 0.8
                      ) -> Tuple[HMCState, Tuple[jnp.ndarray, ...]]:
    """One chain: staged warmup (eps-only -> diagonal metric -> dense
    metric, see inline comments) then draw n_samples.

    Returns (final_state, (q_samples, lnp_samples, aux_samples)) with
    positions still in the unbounded space.
    """
    state = init_state(value_grad, q0, key, eps0)
    state, samples = chain_segment(value_grad, state, jnp.zeros((), jnp.int32),
                                   n_warmup + n_samples, n_warmup,
                                   n_leapfrog, eps0, target_accept)
    return state, jax.tree.map(lambda x: x[n_warmup:], samples)


def _reset_adaptation(st, chol):
    chol = jnp.where(jnp.all(jnp.isfinite(chol)), chol, st.chol_cov)
    return st._replace(chol_cov=chol,
                       h_bar=jnp.zeros(()), welford_n=jnp.zeros(()),
                       welford_mean=jnp.zeros_like(st.welford_mean),
                       welford_m2=jnp.zeros_like(st.welford_m2))


def _diag_reset(st):
    var = st.welford_m2.diagonal() / jnp.maximum(st.welford_n - 1.0, 1.0)
    var = jnp.where(var > 0, var, 1.0)
    return _reset_adaptation(st, jnp.diag(jnp.sqrt(var)))


def _dense_reset(st):
    ndim = st.q.shape[0]
    cov = st.welford_m2 / jnp.maximum(st.welford_n - 1.0, 1.0)
    diag = jnp.diag(jnp.where(jnp.diag(cov) > 0, jnp.diag(cov), 1.0))
    cov = 0.8 * cov + 0.2 * diag + 1e-10 * jnp.eye(ndim)
    return _reset_adaptation(st, jnp.linalg.cholesky(cov))


def _freeze(st):
    return st._replace(log_eps=st.log_eps_avg, n_accepted=jnp.zeros(()))


def staged_segment(step_fn: Callable, state: HMCState, i0, length: int,
                   n_warmup: int, eps0: float
                   ) -> Tuple[HMCState, Tuple[jnp.ndarray, ...]]:
    """Shared staged-warmup scan for HMC and NUTS chain segments.

    `step_fn(st, adapt, mu_offset)` advances one step; the warmup staging
    (eps -> diag metric -> dense metric -> freeze, fired on the GLOBAL step
    index so segmented runs are bit-identical to monolithic ones) lives
    here once — it previously existed verbatim in both samplers, where a
    schedule change applied to one would silently diverge the other."""
    import math
    mu_offset = math.log(10.0 * eps0)
    w1 = n_warmup // 3
    w2 = n_warmup // 3

    def body(st, i):
        st = lax.cond(i == w1, _diag_reset, lambda s: s, st)
        st = lax.cond(i == w1 + w2, _dense_reset, lambda s: s, st)
        st = lax.cond(i == n_warmup, _freeze, lambda s: s, st)
        st = step_fn(st, i < n_warmup, mu_offset)
        return st, (st.q, st.lnp, st.aux)

    return lax.scan(body, state, i0 + jnp.arange(length))


def chain_segment(value_grad: Callable, state: HMCState, i0, length: int,
                  n_warmup: int, n_leapfrog: int = 16, eps0: float = 0.1,
                  target_accept: float = 0.8
                  ) -> Tuple[HMCState, Tuple[jnp.ndarray, ...]]:
    """Advance ONE chain `length` steps starting at global step index `i0`.

    Stan-style staged adaptation: (1) eps only under the identity metric,
    collecting variances -> set a DIAGONAL metric; (2) eps re-adapts under
    the diagonal metric (good mixing now), collecting the full covariance
    -> set the DENSE metric (shrunk toward its diagonal); (3) final eps
    re-adaptation, then freeze at the averaged step size and sample.
    A dense metric estimated straight from the identity phase is garbage on
    correlated posteriors (stuck chains); the dense metric itself
    isotropises e.g. the fsigma8-sigma_v degeneracy valley.

    ALL stages run inside ONE lax.scan, with stage transitions fired by the
    global step index (lax.cond on tiny branches). Separate scans per stage
    would each re-trace the step body — whose dominant subgraph is the full
    likelihood forward+backward — and compile the big graph 4x over.
    Because transitions key on the *global* index, a run split into segments
    (bounded dispatches; see runner.run_hmc_mcmc) is bit-identical to one
    monolithic dispatch.
    """
    return staged_segment(
        lambda st, adapt, mu: _hmc_step(value_grad, st, n_leapfrog, adapt,
                                        target_accept, mu_offset=mu),
        state, i0, length, n_warmup, eps0)


def init_chains(logpost_y: Callable, y0: jnp.ndarray, keys: jax.Array,
                eps0: float = 0.1, chol0: jnp.ndarray = None) -> HMCState:
    """Vmapped initial HMCState for a batch of chains. `chol0`: optional
    initial inverse-mass Cholesky, (ndim, ndim) shared or per-chain."""
    value_grad = jax.value_and_grad(logpost_y, has_aux=True)
    if chol0 is None:
        return jax.vmap(lambda q, k: init_state(value_grad, q, k, eps0))(
            y0, keys)
    chol0 = jnp.broadcast_to(chol0, y0.shape + y0.shape[-1:])
    return jax.vmap(lambda q, k, c: init_state(value_grad, q, k, eps0, c))(
        y0, keys, chol0)


def run_segment(logpost_y: Callable, states: HMCState, i0, length: int,
                n_warmup: int, n_leapfrog: int = 16, eps0: float = 0.1,
                target_accept: float = 0.8):
    """Vmapped `chain_segment` over the chain axis: one bounded dispatch.

    Splitting a run into segments keeps each XLA dispatch short (a single
    monolithic warmup+sample program at 32 chains runs for minutes) and
    gives mid-run checkpoints; results are bit-identical to the monolithic
    dispatch.
    """
    value_grad = jax.value_and_grad(logpost_y, has_aux=True)
    return jax.vmap(
        lambda st: chain_segment(value_grad, st, i0, length, n_warmup,
                                 n_leapfrog, eps0, target_accept))(states)


def run_hmc(logpost_y: Callable, y0: jnp.ndarray, key: jax.Array = None,
            n_warmup: int = 300, n_samples: int = 700, n_leapfrog: int = 16,
            eps0: float = 0.1, target_accept: float = 0.8,
            keys: jax.Array = None):
    """Vmapped independent HMC chains.

    logpost_y(y) -> (lnp, aux) on the unbounded space; y0: (n_chains, ndim).
    Either `key` (split internally) or pre-split per-chain `keys`
    (n_chains, ...) may be given; pass pre-split keys when the chain axis is
    sharded so the key array carries the sharding (the on-device replacement for
    the reference's per-process MPI chains, victor/README.md:30).
    Returns (states, (q, lnp, aux)) with sample arrays shaped
    (n_chains, n_samples, ...).
    """
    value_grad = jax.value_and_grad(logpost_y, has_aux=True)

    def one_chain(q0, k):
        return warmup_and_sample(value_grad, q0, k, n_warmup, n_samples,
                                 n_leapfrog, eps0, target_accept)

    if keys is None:
        keys = jax.random.split(key, y0.shape[0])
    return jax.vmap(one_chain)(y0, keys)
