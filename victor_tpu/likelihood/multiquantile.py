"""Density-split multi-quantile joint fits: stacked CCF data vectors with a
full cross-covariance, batched over quantiles.

Density-split analyses fit several quantile-defined centre sets (e.g. DS1-DS5)
simultaneously: each quantile has its own model inputs (real-space CCF,
density/velocity templates) and redshift-space data vector, and a single
joint covariance couples all of them. The reference package handles one
dataset per CCFFit instance and has no joint machinery; here a JointBundle
carries one frozen table-set per quantile plus the joint (possibly
beta-dependent) covariance, and the joint likelihood is a pure jit/vmap-able
function reusing the single-dataset theory core per quantile.

Per-quantile parameter overrides use a `<name>__q<i>` suffix convention:
`sigma_v__q0` overrides `sigma_v` for quantile 0 only (each quantile can have
its own dispersion amplitude / AP nuisances while sharing cosmology/growth).

Config schema::

    joint:
      quantiles:          # list of single-dataset blocks (no covariance)
        - model: {...}
          data: {redshift_space_ccf: {...}}
        - ...
      covariance_matrix:  # joint cross-covariance over the stacked vector
        data_file: ...
        cov_key: covmat
        fixed_beta: False
        beta_key: beta
      likelihood: {form: sellentin, nmocks: 1000, nparams: ...}
      beta_interpolation: datavector
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FitOptions, fit_options_from_config
from ..errors import InputError
from ..io.loaders import load_key_value_file
from ..io.tables import CCFModelBundle, build_tables
from ..models.ccf_theory import theory_vector
from .core import _apply_form, _factored_chi_squared, _interp_matrix_stack, \
    _like_factor, _pencil_like_factor, multipole_datavector


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class JointBundle:
    """Per-quantile bundles + the joint covariance over the stacked vector.

    A pytree (bundle tables + covariances are leaves; shapes/options static)
    so the whole thing is a jit argument — never closure constants."""
    bundles: Tuple[CCFModelBundle, ...]
    cov: jax.Array                   # (D, D) or (n_b, D, D)
    icov: jax.Array
    beta_cov: Optional[jax.Array]
    fixed_covmat: bool = dataclasses.field(metadata=dict(static=True))
    fit_opts: FitOptions = dataclasses.field(metadata=dict(static=True))
    ndata: int = dataclasses.field(metadata=dict(static=True))
    # pencil factorization of the joint beta-covariance stack (see
    # io/tables.py:_pencil_precompute) — the lever that keeps the joint
    # likelihood's covariance cost O(n_b * D^2) matmul flops + O(D) logdet
    # instead of per-eval (D, D) gathers + an O(D^3) slogdet as the
    # stacked vector D = N*60 grows with the quantile count
    cov_logdet: Optional[jax.Array] = None     # (n_b,)
    cov_pencil: Optional[jax.Array] = None     # (n_b, D)


def build_joint_tables(joint: Dict, base_dir: str = '') -> JointBundle:
    """Build a JointBundle from a `joint:` config block (schema above).

    Host-built and shipped to the accelerator in one batched transfer
    (io.tables.host_build_then_transfer); the nested per-quantile
    build_tables calls see the host CPU as the ambient device and skip
    their own transfers, so an N-quantile bundle is still ONE transaction."""
    from ..io.tables import host_build_then_transfer
    return host_build_then_transfer(
        lambda: _build_joint_tables_host(joint, base_dir))


def _build_joint_tables_host(joint: Dict, base_dir: str = '') -> JointBundle:
    quantiles = joint.get('quantiles')
    if not quantiles:
        raise InputError('joint fit requires a non-empty quantiles: list')
    bundles = []
    for qi, q in enumerate(quantiles):
        model = dict(q['model'])
        data = dict(q.get('data') or {})
        if not data:
            # a data-less quantile would inflate D from the model r grid and
            # die later inside jit with an opaque NoneType error
            raise InputError(f'joint quantile {qi} needs a data: block '
                             '(its slice of the stacked data vector)')
        model.setdefault('dir', base_dir)
        data.setdefault('dir', base_dir)
        if 'covariance_matrix' in data:
            raise InputError('quantile data blocks must not carry their own '
                             'covariance_matrix; supply the joint one')
        bundles.append(build_tables(model, data))

    D = sum(b.spec.n_s * len(b.spec.poles_s) for b in bundles)

    covariance = joint.get('covariance_matrix')
    if not covariance:
        raise InputError('joint fit requires a covariance_matrix block')
    cov_fn = os.path.join(base_dir, covariance['data_file'])
    if not os.path.isfile(cov_fn):
        raise InputError(f'Joint covariance file {cov_fn} not found')
    cdict = load_key_value_file(cov_fn)
    cov_key = covariance.get('cov_key', 'covmat')
    if cov_key not in cdict:
        raise InputError(f'Key {cov_key} not found in file {cov_fn}')
    cov = np.asarray(cdict[cov_key], dtype=np.float64)

    fixed_covmat = covariance.get('fixed_beta', True)
    beta_cov = None
    if not fixed_covmat:
        beta_key = covariance.get('beta_key', 'beta')
        if beta_key not in cdict:
            raise InputError(f'Joint covariance beta key {beta_key} not found')
        beta_cov = np.asarray(cdict[beta_key], dtype=np.float64)
        if cov.shape != (len(beta_cov), D, D):
            raise InputError(f'Joint covariance shape {cov.shape} does not '
                             f'match ({len(beta_cov)}, {D}, {D})')
        if not np.all(np.diff(beta_cov) > 0):
            # _interp_matrix_stack's searchsorted silently mis-interpolates
            # on an unsorted grid (same check as io/tables.py single-dataset)
            raise InputError('Joint covariance beta grid must be strictly '
                             'increasing')
    elif cov.shape != (D, D):
        raise InputError(f'Joint covariance shape {cov.shape} does not match '
                         f'({D}, {D})')

    fit_opts = fit_options_from_config(joint)
    if fit_opts.beta_interpolation == 'likelihood':
        # the single-dataset core supports this mode (likelihood/core.py), but
        # the bracketing grid is ambiguous when quantiles carry their own beta
        # grids; refuse rather than silently fall back to datavector interp
        raise InputError("beta_interpolation: 'likelihood' is not supported "
                         "for joint multi-quantile fits; use 'datavector'")
    cov_logdet = cov_pencil = None
    if not fixed_covmat:
        from ..io.tables import _pencil_precompute
        cov_logdet, cov_pencil = _pencil_precompute(cov)
    return JointBundle(
        bundles=tuple(bundles),
        cov=jnp.asarray(cov), icov=jnp.asarray(np.linalg.inv(cov)),
        beta_cov=None if beta_cov is None else jnp.asarray(beta_cov),
        fixed_covmat=fixed_covmat, fit_opts=fit_opts, ndata=D,
        cov_logdet=None if cov_logdet is None else jnp.asarray(cov_logdet),
        cov_pencil=None if cov_pencil is None else jnp.asarray(cov_pencil))


def quantile_params(params: Dict, i: int) -> Dict:
    """Resolve `<name>__q<i>` per-quantile overrides for quantile i."""
    suffix = f'__q{i}'
    out = {k: v for k, v in params.items() if '__q' not in k}
    for k, v in params.items():
        if k.endswith(suffix):
            out[k[: -len(suffix)]] = v
    return out


def _check_quantile_indices(params: Dict, n_quantiles: int) -> None:
    """Trace-time guard: a `__q<i>` override whose index matches no quantile
    would otherwise be silently dropped by quantile_params — the parameter
    becomes a dead coordinate the likelihood is exactly flat in (singular
    MAP Hessians, prior-shaped posteriors) with no error anywhere."""
    for k in params:
        if '__q' not in k:
            continue
        name, _, idx = k.rpartition('__q')
        if not name or not idx.isdigit() or int(idx) >= n_quantiles:
            raise InputError(
                f"per-quantile override '{k}' matches no quantile: this "
                f'joint fit has {n_quantiles} quantiles '
                f'(valid suffixes __q0..__q{n_quantiles - 1})')


def joint_theory_vector(jb: JointBundle, params: Dict,
                        opts_kw: Optional[Dict] = None) -> jnp.ndarray:
    """Stacked theory vector over quantiles (length jb.ndata)."""
    _check_quantile_indices(params, len(jb.bundles))
    parts = []
    for i, b in enumerate(jb.bundles):
        opts = b.theory_opts.replace(**(opts_kw or {}))
        parts.append(theory_vector(b.tables, b.spec, opts,
                                   quantile_params(params, i)))
    return jnp.concatenate(parts)


def joint_datavector(jb: JointBundle, params: Dict) -> jnp.ndarray:
    parts = []
    for i, b in enumerate(jb.bundles):
        p = quantile_params(params, i)
        if 'beta' not in p and not b.spec.fixed_data:
            raise InputError(f'Quantile {i} has a beta-dependent data vector '
                             f'but neither beta nor beta__q{i} was supplied')
        beta = p.get('beta', jnp.asarray(0.0))
        parts.append(multipole_datavector(b.tables, b.spec, beta))
    return jnp.concatenate(parts)


def joint_covariance(jb: JointBundle, beta) -> jax.Array:
    if jb.fixed_covmat:
        return jb.cov
    return _interp_matrix_stack(jb.beta_cov, jb.cov, beta)


def joint_precision(jb: JointBundle, beta) -> jax.Array:
    if jb.fixed_covmat:
        return jb.icov
    return _interp_matrix_stack(jb.beta_cov, jb.icov, beta)


def _joint_use_factored(jb: JointBundle, opts_kw: Optional[Dict]) -> bool:
    """Joint-path analogue of core._use_factored: the resolved mode rides
    in opts_kw (resolve_perf_kw applies it uniformly); absent that, a
    uniform explicit setting across member bundles is honored."""
    mode = (opts_kw or {}).get('beta_covariance')
    if mode is None:
        modes = {b.theory_opts.beta_covariance for b in jb.bundles}
        mode = modes.pop() if len(modes) == 1 else 'auto'
    return (mode == 'factored' and not jb.fixed_covmat
            and jb.cov_logdet is not None)


def joint_chi_squared(jb: JointBundle, params: Dict,
                      opts_kw: Optional[Dict] = None):
    tv = joint_theory_vector(jb, params, opts_kw)
    dv = joint_datavector(jb, params)
    if 'beta' not in params and not jb.fixed_covmat:
        # the joint covariance interpolates on the GLOBAL beta (per-quantile
        # beta__q<i> overrides do not apply to the shared matrix); silently
        # blending at the 0.0 default would be garbage-but-finite
        raise InputError('Need a global beta to interpolate the '
                         'beta-dependent joint covariance')
    beta = params.get('beta', jnp.asarray(0.0))
    diff = tv - dv
    if _joint_use_factored(jb, opts_kw):
        # factored path (config.TheoryOptions.beta_covariance): contract
        # against every grid precision once, scalar-interpolate — no
        # (N*60, N*60) materialisation; callers needing the log-det use the
        # pencil (joint_log_likelihood does)
        chisq = _factored_chi_squared(jb.beta_cov, jb.icov, diff, beta)
        return chisq, None
    cov = joint_covariance(jb, beta)
    icov = joint_precision(jb, beta)
    chisq = jnp.einsum('i,ij,j->', diff, icov, diff, precision='highest')
    return chisq, cov


def joint_log_likelihood(jb: JointBundle, params: Dict,
                         opts_kw: Optional[Dict] = None,
                         fit_kw: Optional[Dict] = None):
    """(lnlike, chisq) for the joint multi-quantile fit; same likelihood
    forms and guards as the single-dataset path (victor/ccf_fit.py:356-483
    semantics over the stacked vector)."""
    fit = jb.fit_opts.replace(**(fit_kw or {}))
    if fit.beta_interpolation == 'likelihood':
        # also guarded at build time (build_joint_tables); re-check here so a
        # runtime fit_kw override cannot silently fall back to datavector
        raise InputError("beta_interpolation: 'likelihood' is not supported "
                         "for joint multi-quantile fits; use 'datavector'")
    chisq, cov = joint_chi_squared(jb, params, opts_kw)
    if not jb.fixed_covmat:
        if cov is None:   # factored path: pencil logdet, no materialisation
            lf, ok = _pencil_like_factor(
                jb.beta_cov, jb.cov_logdet, jb.cov_pencil,
                params.get('beta', jnp.asarray(0.0)))
        else:
            lf, ok = _like_factor(cov)
    else:
        lf = jnp.zeros(())
        ok = jnp.asarray(True)
    lnlike = _apply_form(chisq, lf, fit, jb.ndata)
    bad = jnp.logical_or(~ok, jnp.isnan(lnlike))
    return jnp.where(bad, -jnp.inf, lnlike), jnp.where(bad, jnp.inf, chisq)


def make_batched_joint_loglike(jb: JointBundle, param_names: Sequence[str],
                               base_params: Optional[Dict] = None,
                               opts_kw: Optional[Dict] = None,
                               fit_kw: Optional[Dict] = None,
                               chunk: Optional[int] = None,
                               gradient_free: bool = True):
    """Jitted vmapped joint likelihood: theta (N, P) -> ((N,), (N,)).

    Table pytrees are jit arguments (never closure constants). `chunk`
    bounds peak memory like batched.make_batched_loglike — a joint fit's
    per-eval working set is n_quantiles times the single-dataset one, so
    large unchunked batches would exhaust device memory.

    Throughput surface: `gradient_free=True` resolves 'auto' perf modes to
    the validated fast modes (targets.resolve_perf_kw policy); pass False
    (or explicit opts_kw) before differentiating through it."""
    from ..sampling.targets import resolve_perf_kw
    from .batched import chunked_vmap, theta_to_params

    opts_kw = resolve_perf_kw([b.theory_opts for b in jb.bundles],
                              opts_kw, gradient_free)
    names = tuple(param_names)
    base = {k: jnp.asarray(v) for k, v in (base_params or {}).items()}

    def fn(jb_arg, theta):
        def scalar(t):
            params = theta_to_params(t, names, base)
            return joint_log_likelihood(jb_arg, params, opts_kw, fit_kw)
        if chunk and theta.shape[0] > chunk:
            return chunked_vmap(scalar, chunk)(theta)
        return jax.vmap(scalar)(theta)

    jfn = jax.jit(fn, static_argnames=())
    return lambda theta: jfn(jb, theta)


def make_sharded_joint_loglike(jb: JointBundle, param_names: Sequence[str],
                               mesh, axis='walkers',
                               base_params: Optional[Dict] = None,
                               opts_kw: Optional[Dict] = None,
                               fit_kw: Optional[Dict] = None,
                               gradient_free: bool = True):
    """Batched joint multiquantile likelihood sharded over a device mesh.

    The joint analogue of batched.make_sharded_loglike, and the SURVEY §5
    lever for growing stacked data vectors: the per-quantile tables and the
    (n_b, N·60, N·60) joint covariance stack are replicated (a few MB) while
    the parameter batch is sharded along `axis` (a name or tuple of names of
    the mesh), so each chip contracts its theta slice against the stack with
    NO collectives in the forward pass — the joint covariance contraction
    scales across chips exactly like the single-dataset map. `axis` may
    cover multiple mesh axes (e.g. ('chains', 'walkers')) to use the whole
    mesh; the batch length must be divisible by the spanned device count.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..sampling.targets import resolve_perf_kw
    from .batched import theta_to_params

    opts_kw = resolve_perf_kw([b.theory_opts for b in jb.bundles],
                              opts_kw, gradient_free)
    names = tuple(param_names)
    base = {k: jnp.asarray(v) for k, v in (base_params or {}).items()}

    def fn(jb_arg, theta):
        def scalar(t):
            params = theta_to_params(t, names, base)
            return joint_log_likelihood(jb_arg, params, opts_kw, fit_kw)
        return jax.vmap(scalar)(theta)

    rep = NamedSharding(mesh, P())
    io_spec = NamedSharding(mesh, P(axis))
    jfn = jax.jit(fn, in_shardings=(rep, io_spec),
                  out_shardings=(io_spec, io_spec))
    jb_rep = jax.device_put(jb, rep)
    return lambda theta: jfn(jb_rep, theta)
