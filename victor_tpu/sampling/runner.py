"""High-level MCMC driver: the on-device `cobaya-run` equivalent.

Reference flow (victor/likelihoods/CCFLikelihood.py + cobaya MH + MPI chains,
SURVEY.md §3.5) becomes: parse the same YAML params block -> ParamSpace;
compose prior + vmapped likelihood into one on-device posterior; advance a
sharded walker ensemble in jitted segments; check split-R-hat between
segments (the cobaya R-1 < 0.01 stop, config/boss_cobaya_config.yaml:46-47);
checkpoint sampler state every segment; export GetDist-format chains.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..io.tables import CCFModelBundle
from ..utils.logging import get_logger
from . import chains as chain_io
from . import diagnostics, ensemble
from .priors import ParamSpace
from .targets import JitFnCache

log = get_logger('sampling')


def _freeze(obj):
    """Recursively freeze dicts/lists into hashable tuples (jit-cache keys)."""
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


_HMC_RUNNERS = JitFnCache()
_ENSEMBLE_RUNNERS = JitFnCache()


@dataclasses.dataclass
class MCMCResult:
    space: ParamSpace
    chain: np.ndarray          # (n_recorded, n_walkers, ndim)
    log_prob: np.ndarray       # (n_recorded, n_walkers)
    aux: np.ndarray            # (n_recorded, n_walkers, n_aux)
    state: ensemble.EnsembleState
    rhat: np.ndarray
    acceptance: float
    n_steps: int
    elapsed_s: float

    def flat(self, burn_in: Optional[int] = None) -> np.ndarray:
        b = len(self.chain) // 3 if burn_in is None else burn_in
        return self.chain[b:].reshape(-1, self.chain.shape[-1])

    def summary(self, burn_in: Optional[int] = None) -> Dict[str, Dict[str, float]]:
        flat = self.flat(burn_in)
        return {p.name: {'mean': float(flat[:, i].mean()),
                         'std': float(flat[:, i].std()),
                         'rhat': float(self.rhat[i])}
                for i, p in enumerate(self.space.sampled)}


def _posterior_parts(bundle, space: ParamSpace,
                     opts_kw: Optional[Dict] = None,
                     fit_kw: Optional[Dict] = None,
                     gradient_free: bool = True):
    """(logpost(tables, coords), tables_arg, cache_id) via the shared
    targets.resolve_target dispatch — the single place that knows how to
    turn a CCFModelBundle / JointBundle / ProductTarget / callable into a
    (tables_arg, loglike, cache-key) triple. runner.py used to carry two
    verbatim copies of that dispatch, which is exactly how the SMC
    JointBundle branch once lost opts_kw/fit_kw from its jit-cache key
    (see targets.py docstring)."""
    from .targets import resolve_target

    # the ensemble stretch move is gradient-free, so 'auto' perf modes
    # resolve fast by default (callers differentiating through logpost
    # must pass gradient_free=False)
    tables_arg, loglike, cache_id = resolve_target(bundle, opts_kw, fit_kw,
                                                   gradient_free)

    def logpost(tbl, coords):
        def scalar(theta):
            params = space.full_params(theta)
            return loglike(tbl, params)
        inner = ensemble.make_logpost(space.log_prior, jax.vmap(scalar))
        return inner(coords)

    return logpost, tables_arg, cache_id


def make_posterior(bundle, space: ParamSpace,
                   opts_kw: Optional[Dict] = None,
                   fit_kw: Optional[Dict] = None, bind_tables: bool = True,
                   gradient_free: bool = True):
    """Batched (lnpost, aux) function over walker coordinate arrays (W, P).

    Accepts anything targets.resolve_target does (single-dataset
    CCFModelBundle, multi-quantile JointBundle, ProductTarget, callable).
    With bind_tables=False, returns logpost(tables, coords) so callers can
    pass the tables pytree as a jit argument — embedding it as closure
    constants makes MLIR lowering read every array back from the device
    and bakes the tables into the compiled program.

    `gradient_free=True` (default) resolves 'auto' perf modes to the
    validated fast modes; pass False before differentiating through the
    returned function (config.resolve_perf_mode)."""
    logpost, tables_arg, _ = _posterior_parts(bundle, space, opts_kw, fit_kw,
                                              gradient_free)
    if bind_tables:
        return lambda coords: logpost(tables_arg, coords)
    return logpost


def run_hmc_mcmc(bundle: CCFModelBundle, params_block: Dict,
                 n_chains: int = 8, n_warmup: int = 300, n_samples: int = 700,
                 n_leapfrog: int = 16, seed: int = 0,
                 opts_kw: Optional[Dict] = None, fit_kw: Optional[Dict] = None,
                 output: Optional[str] = None,
                 checkpoint: Optional[str] = None, resume: bool = False,
                 burn_in_fraction: float = 0.0,
                 mesh: Optional[jax.sharding.Mesh] = None,
                 mesh_axis=None, segment_steps: int = 100,
                 algorithm: str = 'hmc', max_depth: int = 8,
                 covmat=None, rhat_stop: Optional[float] = None) -> MCMCResult:
    """Gradient-based sampling: vmapped adaptive HMC chains (sampling/hmc.py).

    ~10x lower autocorrelation per draw than the stretch move; warmup +
    sampling run as ONE jitted computation with no host round trips.
    Positions are sampled in the unbounded reparameterisation and returned
    in the physical space.

    `mesh`: optional device mesh; chains are independent, so their axis is
    sharded over `mesh_axis` (default: all mesh axes) and each device advances
    its local chains with zero collectives — the on-device replacement for
    the reference's `mpirun -n N cobaya-run` per-process chains
    (victor/README.md:30). Accepts a single-dataset CCFModelBundle or a
    multi-quantile JointBundle.

    The run executes in bounded dispatches of `segment_steps` steps
    (bit-identical to one monolithic dispatch): a single XLA program holding
    the full warmup+sampling scan can run for minutes at high chain counts
    and offers no mid-run checkpoints. Each segment boundary writes the checkpoint (exact resume).

    `algorithm`: 'hmc' (fixed jittered trajectories, sampling/hmc.py),
    'nuts' (dynamic trajectory length up to 2^max_depth leapfrogs,
    sampling/nuts.py), or 'mh' (gradient-free adaptive random-walk
    Metropolis — the reference's cobaya sampler family, sampling/mh.py;
    needs ~10x the draws of HMC but composes with the forward-only fast
    modes). All three share state/warmup, so checkpoints, segmenting and
    mesh sharding behave identically. n_leapfrog is ignored for NUTS/MH.

    `covmat`: optional cobaya-format `.covmat` path (or a theta-space
    (ndim, ndim) array ordered like the sampled block) seeding the initial
    proposal covariance (MH) / inverse-mass metric (HMC/NUTS) — the role of
    cobaya's `mcmc: {covmat: ...}` input; parameters absent from the file
    fall back to their `proposal:` width squared, as cobaya does. Every
    exported chain writes `<output>.covmat` back, so covmat files
    round-trip between runs (and to/from cobaya itself). Without a covmat,
    MH seeds its proposal diagonal from the block's `proposal:` widths.

    `rhat_stop`: optional convergence stop — cobaya's `Rminus1_stop` role:
    after each post-warmup segment with >= 50 recorded draws, stop early
    once split-max(R-1) < rhat_stop. n_samples then acts as the draw CAP.
    Early stopping only truncates the run, so the recorded draws remain
    bit-identical to a fixed-length run's prefix.
    """
    from . import hmc as _hmc
    from . import mh as _mh
    from . import nuts as _nuts
    from .targets import resolve_target

    space = ParamSpace(params_block)
    # only MH is gradient-free here: HMC/NUTS differentiate through the
    # likelihood, where the fast modes' Clenshaw transpose is measurably
    # SLOWER than exact (BASELINE.md round 3) — 'auto' resolves per path
    tables_arg, loglike, cache_id = resolve_target(
        bundle, opts_kw, fit_kw, gradient_free=(algorithm == 'mh'))

    covmat_arr = None
    if covmat is not None:
        from ..errors import InputError
        if isinstance(covmat, str):
            # absent params fall back to proposal^2 (cobaya's fill rule);
            # nan marks "absent AND no proposal" for the loud check below
            prop_var = np.array([(p.proposal ** 2) if p.proposal else np.nan
                                 for p in space.sampled])
            covmat_arr = chain_io.read_covmat(covmat, space.names,
                                              fallback_var=prop_var)
        else:
            covmat_arr = np.asarray(covmat, dtype=float)
        if covmat_arr.shape != (space.ndim, space.ndim):
            raise InputError(
                f'covmat shape {covmat_arr.shape} does not match the '
                f'{space.ndim} sampled parameters {space.names}')
        if np.any(np.isnan(covmat_arr)):
            missing = [p.name for i, p in enumerate(space.sampled)
                       if np.isnan(covmat_arr[i, i])]
            raise InputError(
                f'covmat has no entry for {missing} and those parameters '
                'have no proposal: width to fall back on')
        try:
            np.linalg.cholesky(covmat_arr)
        except np.linalg.LinAlgError:
            raise InputError('covmat is not positive definite')

    def logpost_y(tbl, y):
        theta = space.to_bounded(y)
        params = space.full_params(theta)
        lnl, chisq = loglike(tbl, params)
        lp = space.log_prior(theta) + space.log_jacobian(y)
        total = lnl + lp
        total = jnp.where(jnp.isfinite(total), total, -jnp.inf)
        return total, jnp.stack([chisq])

    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    prev = None
    resume_state = None
    resume_i0 = None
    if resume and checkpoint:
        try:
            resume_state, pc, pl, pa, resume_i0 = \
                chain_io.load_hmc_checkpoint(checkpoint)
            prev = (pc, pl, pa) if pc is not None else None
            log.info('resumed HMC from %s at step %s', checkpoint, resume_i0)
        except FileNotFoundError:
            pass
    if resume_state is not None:
        # the checkpoint's chain count is authoritative: the jit cache key,
        # acceptance denominator and GetDist chain-file split below must all
        # use the resumed count, not the caller's default
        n_chains = int(resume_state.q.shape[0])
    theta0 = space.sample_ref(k0, n_chains)
    y0 = space.to_unbounded(theta0) if resume_state is None else resume_state.q
    chain_keys = jax.random.split(key, n_chains)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        if mesh_axis is None:
            mesh_axis = tuple(mesh.axis_names)
        shard = NamedSharding(mesh, P(mesh_axis))
        rep = NamedSharding(mesh, P())
        y0 = jax.device_put(y0, shard)
        chain_keys = jax.device_put(chain_keys, shard)
        tables_arg = jax.device_put(tables_arg, rep)
        if resume_state is not None:
            resume_state = jax.device_put(resume_state, shard)

    t0 = time.time()
    # cache the jitted segment/init functions across calls (a fresh lambda
    # per call would defeat jax's jit cache and recompile the big HMC graph)
    # the params block's TOP-LEVEL order is semantic (it fixes the theta
    # layout the cached closures bake in), so it is frozen order-preserving;
    # inner dicts (prior/ref specs) and kwarg overrides are by-name and are
    # normalised by _freeze's sort. Sorting the top level once collided a
    # hand-ordered block with its alphabetised YAML round-trip (see
    # find_map's cache key for the observed failure).
    cache_key = (tuple((k, _freeze(v)) for k, v in params_block.items()),
                 cache_id, _freeze(opts_kw),
                 _freeze(fit_kw), n_warmup, n_leapfrog, n_chains,
                 algorithm, max_depth,
                 None if covmat_arr is None else covmat_arr.tobytes(),
                 None if mesh is None else (mesh.shape_tuple, mesh_axis))
    fns = _HMC_RUNNERS.setdefault(cache_key, {})

    cov_t = None if covmat_arr is None else jnp.asarray(covmat_arr)

    def _chol0(y):
        """Per-chain initial chol_cov seed (None -> identity): covmat
        (all samplers) or the block's proposal: widths (MH). Theta-space
        inputs map to the unbounded sampling space through the diagonal
        reparameterisation Jacobian at each chain's own start point."""
        if cov_t is not None:
            def one(yy):
                j = space.dtheta_dy_diag(yy)
                return jnp.linalg.cholesky(cov_t / jnp.outer(j, j))
            return jax.vmap(one)(y)
        if algorithm == 'mh' and any(p.proposal for p in space.sampled):
            return jax.vmap(jnp.diag)(space.proposal_scales_unbounded(y))
        return None

    if 'init' not in fns:
        if algorithm == 'mh':
            # value-only init: never builds the gradient graph
            fns['init'] = jax.jit(lambda tbl, y, ks: _mh.init_chains(
                lambda yy: logpost_y(tbl, yy), y, ks, chol0=_chol0(y)))
        else:
            fns['init'] = jax.jit(lambda tbl, y, ks: _hmc.init_chains(
                lambda yy: logpost_y(tbl, yy), y, ks, chol0=_chol0(y)))

    def _segment_fn(length):
        if ('seg', length) not in fns:
            if algorithm == 'nuts':
                fns[('seg', length)] = jax.jit(
                    lambda tbl, st, i: _nuts.run_segment(
                        lambda yy: logpost_y(tbl, yy), st, i, length,
                        n_warmup=n_warmup, max_depth=max_depth))
            elif algorithm == 'mh':
                fns[('seg', length)] = jax.jit(
                    lambda tbl, st, i: _mh.run_segment(
                        lambda yy: logpost_y(tbl, yy), st, i, length,
                        n_warmup=n_warmup))
            else:
                fns[('seg', length)] = jax.jit(
                    lambda tbl, st, i: _hmc.run_segment(
                        lambda yy: logpost_y(tbl, yy), st, i, length,
                        n_warmup=n_warmup, n_leapfrog=n_leapfrog))
        return fns[('seg', length)]

    n_total = n_warmup + n_samples
    # a fresh run truncates <output>.progress; a resumed one appends
    fresh_progress = resume_state is None
    if resume_state is not None and resume_i0 is not None:
        states, i0 = resume_state, int(resume_i0)
        if i0 >= n_total:
            # resuming a completed run extends it by n_samples more draws
            # (adaptation stays frozen: all new indices are >= n_warmup)
            n_total = i0 + n_samples
    else:
        states = fns['init'](tables_arg, y0, chain_keys)
        i0 = 0
    recs = [prev] if prev is not None else []   # post-warmup (S,C,·) records
    while i0 < n_total:
        length = min(segment_steps, n_total - i0)
        states, (qs, lnps, auxs) = _segment_fn(length)(
            tables_arg, states, jnp.asarray(i0, jnp.int32))
        # np.asarray forces the device->host transfer (completion barrier)
        qs, lnps, auxs = np.asarray(qs), np.asarray(lnps), np.asarray(auxs)
        i0 += length
        keep = length - max(min(n_warmup - (i0 - length), length), 0)
        if keep > 0:
            q_keep = qs[:, length - keep:]
            # record the THETA-space log-posterior: the sampler's lnp target
            # includes the reparameterisation log-Jacobian (y-space), which
            # would skew GetDist's -lnpost column against the physical
            # coordinates and disagree with the SMC/ensemble exports
            lnp_keep = lnps[:, length - keep:] \
                - np.asarray(space.log_jacobian(q_keep))
            recs.append((
                np.asarray(space.to_bounded(q_keep)).transpose(1, 0, 2),
                lnp_keep.T,
                auxs[:, length - keep:].transpose(1, 0, 2)))
        if checkpoint:
            chain_io.save_hmc_checkpoint(
                checkpoint, jax.device_get(states),
                *((np.concatenate([r[j] for r in recs]) for j in range(3))
                  if recs else (None, None, None)),
                i0=i0)
        # diagnostics only when a consumer exists: the concatenation grows
        # with the run and split-R-hat is pure host work per segment
        need_diag = bool(output) or rhat_stop is not None
        sofar = np.concatenate([r[0] for r in recs]) \
            if recs and need_diag else None
        n_rec = 0 if sofar is None else len(sofar)
        rm1 = (float(np.max(diagnostics.split_rhat(sofar) - 1))
               if n_rec >= 4 else float('nan'))
        if output:
            # cobaya's <root>.progress monitoring file: one row per segment
            acc_now = float(np.mean(np.asarray(states.n_accepted))
                            / max(n_rec if n_rec else i0, 1))
            chain_io.append_progress(output, n_rec, acc_now, rm1,
                                     reset=fresh_progress)
            fresh_progress = False
        if rhat_stop is not None and n_rec >= 50:
            log.info('step %d: max(R-1)=%.4f (stop at %.3g)',
                     i0, rm1, rhat_stop)
            if rm1 < rhat_stop:
                log.info('converged: R-1 < %.3g at %d draws '
                         '(cap was %d)', rhat_stop, n_rec,
                         n_total - n_warmup)
                break
    if recs:
        chain = np.concatenate([r[0] for r in recs])   # (S, C, P)
        lnp = np.concatenate([r[1] for r in recs])
        aux = np.concatenate([r[2] for r in recs])
    else:
        ndim_a = states.aux.shape[-1]
        chain = np.empty((0, n_chains, space.ndim))
        lnp = np.empty((0, n_chains))
        aux = np.empty((0, n_chains, ndim_a))
    rhat = diagnostics.split_rhat(chain)
    n_recorded = max(len(chain), 1)
    acc = float(np.mean(np.asarray(states.n_accepted)) / n_recorded)
    # split-R-hat needs >=4 samples per chain to be defined; logging a nan
    # for a short smoke segment reads like a failure when it isn't
    max_rm1 = float(np.max(rhat - 1)) if len(chain) >= 4 else None
    log.info('HMC: %d chains x %d samples, acceptance=%.3f max(R-1)=%s',
             n_chains, len(chain), acc,
             'n/a (<4 samples)' if max_rm1 is None else f'{max_rm1:.4f}')

    result = MCMCResult(
        space=space, chain=chain, log_prob=lnp, aux=aux,
        state=jax.device_get(states), rhat=rhat, acceptance=acc,
        n_steps=len(chain), elapsed_s=time.time() - t0)
    if output:
        burn = int(len(chain) * burn_in_fraction)
        # one GetDist file per chain (cobaya/MPI's chains/test.<N>.txt layout)
        chain_io.export_getdist(output, space, chain, lnp, aux,
                                aux_names=['chi2_ccf_correct'], burn_in=burn,
                                n_chain_files=n_chains)
        log.info('chains written to %s.*', output)
    return result


def run_mcmc(bundle: CCFModelBundle, params_block: Dict,
             n_walkers: int = 256, max_steps: int = 2000,
             rhat_stop: float = 0.01, check_every: int = 100,
             burn_in_fraction: float = 0.3, thin: int = 1,
             seed: int = 0, mesh: Optional[jax.sharding.Mesh] = None,
             mesh_axis: str = 'walkers',
             opts_kw: Optional[Dict] = None, fit_kw: Optional[Dict] = None,
             output: Optional[str] = None,
             checkpoint: Optional[str] = None,
             resume: bool = False, n_chain_files: int = 4,
             move: str = 'de') -> MCMCResult:
    """Sample the posterior; returns chains + diagnostics.

    `mesh`: optional device mesh; walker state is sharded along `mesh_axis`
    so each segment runs data-parallel across chips with no host round trips
    inside the segment.

    `move`: 'de' (default — differential evolution, ter Braak 2006; measured
    to converge the flagship BOSS config where the stretch move stalls at
    R-1 ~ 0.011, BASELINE.md round 5) or 'stretch' (Goodman & Weare, the
    round-1..4 behavior).
    """
    space = ParamSpace(params_block)
    # tables is the pytree passed as the jit argument (full JointBundle for
    # multi-quantile fits); cache_id covers everything the logpost_t closure
    # bakes in — both from the shared resolve_target dispatch
    logpost_t, tables, cache_id = _posterior_parts(bundle, space,
                                                   opts_kw, fit_kw)
    key = jax.random.PRNGKey(seed)

    # cache the jitted init/segment functions across calls (a fresh lambda
    # per call would defeat jax's object-keyed jit cache and re-lower the
    # full ensemble segment graph on every run_mcmc call — minutes of
    # tracing per seed-study repeat; same pattern as _HMC_RUNNERS above)
    cache_key = (tuple((k, _freeze(v)) for k, v in params_block.items()),
                 cache_id, _freeze(opts_kw), _freeze(fit_kw),
                 check_every, thin, move,
                 None if mesh is None else (mesh.shape_tuple, mesh_axis))
    fns = _ENSEMBLE_RUNNERS.setdefault(cache_key, {})

    segments: list = []
    if resume and checkpoint:
        try:
            state, prev_chain, prev_lnp, prev_aux = chain_io.load_checkpoint(checkpoint)
            if prev_chain is not None:
                segments.append((prev_chain, prev_lnp, prev_aux))
            log.info('resumed from %s at step %d', checkpoint, int(state.n_steps))
        except FileNotFoundError:
            state = None
    else:
        state = None
    fresh_progress = state is None   # truncate <output>.progress on fresh runs
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        rep = NamedSharding(mesh, P())
        tables = jax.device_put(tables, rep)

    if state is None:
        key, k0 = jax.random.split(key)
        coords = space.sample_ref(k0, n_walkers)
        if 'init' not in fns:
            fns['init'] = jax.jit(lambda t, c, k: ensemble.init_state(
                lambda x: logpost_t(t, x), c, k))
        state = fns['init'](tables, coords, key)

    if mesh is not None:
        shard = NamedSharding(mesh, P(mesh_axis))
        state = ensemble.EnsembleState(
            coords=jax.device_put(state.coords, shard),
            log_prob=jax.device_put(state.log_prob, shard),
            aux=jax.device_put(state.aux, shard),
            key=jax.device_put(state.key, rep),
            n_accepted=jax.device_put(state.n_accepted, shard),
            n_steps=jax.device_put(state.n_steps, rep))

    if 'segment' not in fns:
        fns['segment'] = jax.jit(
            lambda t, st: ensemble.run(lambda c: logpost_t(t, c), st,
                                       check_every, thin=thin, move=move),
            donate_argnums=1)
    segment = fns['segment']

    t0 = time.time()
    total_recorded = sum(len(c[0]) for c in segments)
    while total_recorded * thin < max_steps:
        state, (coords_seg, lnp_seg, aux_seg) = segment(tables, state)
        jax.block_until_ready(lnp_seg)
        segments.append((np.asarray(coords_seg), np.asarray(lnp_seg),
                         np.asarray(aux_seg)))
        total_recorded += len(segments[-1][0])

        chain = np.concatenate([s[0] for s in segments])
        burn = int(len(chain) * burn_in_fraction)
        post = chain[burn:] if len(chain) - burn >= 4 else chain
        rhat = diagnostics.split_rhat(post)
        acc = diagnostics.acceptance_fraction(state.n_accepted, float(state.n_steps))
        log.info('step %d: max(R-1)=%.4f acceptance=%.3f',
                 total_recorded * thin, float(np.max(rhat - 1)), acc)
        if checkpoint:
            chain_io.save_checkpoint(
                checkpoint, jax.device_get(state), chain,
                np.concatenate([s[1] for s in segments]),
                np.concatenate([s[2] for s in segments]))
        if output:
            # cobaya's <root>.progress monitoring file: one row per segment
            chain_io.append_progress(output, total_recorded * thin, acc,
                                     float(np.max(rhat - 1)),
                                     reset=fresh_progress)
            fresh_progress = False
        if np.max(rhat - 1) < rhat_stop and total_recorded * thin >= 2 * check_every:
            break

    chain = np.concatenate([s[0] for s in segments])
    lnp = np.concatenate([s[1] for s in segments])
    aux = np.concatenate([s[2] for s in segments])
    # recompute R-hat from the final chain: when a resumed checkpoint
    # already satisfies max_steps the while loop never runs and the result
    # would otherwise report the rhat=inf initializer for a converged chain
    burn = int(len(chain) * burn_in_fraction)
    post = chain[burn:] if len(chain) - burn >= 4 else chain
    rhat = diagnostics.split_rhat(post)
    result = MCMCResult(
        space=space, chain=chain, log_prob=lnp, aux=aux,
        state=jax.device_get(state), rhat=rhat,
        acceptance=diagnostics.acceptance_fraction(state.n_accepted,
                                                   float(state.n_steps)),
        n_steps=int(state.n_steps), elapsed_s=time.time() - t0)

    if output:
        burn = int(len(chain) * burn_in_fraction)
        # walker groups -> GetDist chain files (cobaya/MPI layout); GetDist
        # computes cross-chain R-hat from >= 2 files
        chain_io.export_getdist(output, space, chain, lnp, aux,
                                aux_names=['chi2_ccf_correct'], burn_in=burn,
                                n_chain_files=n_chain_files)
        log.info('chains written to %s.*', output)
    return result
