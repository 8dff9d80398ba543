"""Parameter-space specification parsed from cobaya-style `params:` blocks.

The reference delegates priors/reference-distributions/proposals/derived
parameters to cobaya (config/boss_cobaya_config.yaml:50-97,
victor/likelihoods/CCFLikelihood.yaml:8-40). Here the same YAML vocabulary is
parsed into a `ParamSpace` whose `log_prior` and `sample_ref` are pure JAX
functions, so priors evaluate on-device inside the vmapped posterior.

Supported per-parameter forms:
  name:                      -> sampled, spec from an outer default (or error)
  name: 1.9                  -> fixed value
  name: {prior: {dist: uniform, min, max}, ref: {...}, proposal, latex}
  name: {prior: {dist: norm, loc, scale}, ...}
  name: {prior: {dist: loguniform, min, max}, ...}    (scipy a/b also accepted)
  name: {prior: {dist: halfnorm, loc, scale}, ...}
  name: {value: "lambda a, b: ..."}   -> derived from other params
  name: {derived: True}      -> derived output (filled by the likelihood)

A scalar ref (`ref: 0.47`) or a zero-width ref would start every ensemble
walker at the identical point, making the stretch move permanently degenerate
(proposal == current point for all walkers); the start scatter falls back to
the `proposal` width, else 1% of the prior scale.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import InputError


@dataclasses.dataclass(frozen=True)
class SampledParam:
    name: str
    dist: str                 # 'uniform' | 'norm' | 'loguniform' | 'halfnorm'
    lo: float                 # min (uniform/loguniform) / loc (norm/halfnorm)
    hi: float                 # max (uniform/loguniform) / scale (norm/halfnorm)
    ref_dist: str = 'prior'
    ref_loc: float = 0.0
    ref_scale: float = 1.0
    ref_lo: float = 0.0       # min/max for uniform/loguniform refs
    ref_hi: float = 0.0
    proposal: Optional[float] = None
    latex: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DerivedParam:
    name: str
    fn: Callable              # params dict -> value
    argnames: Tuple[str, ...]
    latex: Optional[str] = None
    src: str = ''             # raw lambda text — part of jit-fn cache keys
                              # (name+argnames alone would alias two lambdas
                              # with the same signature but different bodies)


def _parse_lambda(expr: str) -> Tuple[Callable, Tuple[str, ...]]:
    """Compile a cobaya-style 'lambda a, b: ...' derived-parameter string.

    Evaluated with jnp as the only free module so the result traces under jit.
    """
    expr = expr.strip()
    if not expr.startswith('lambda'):
        raise InputError(f"Derived parameter value must be a lambda string, got {expr!r}")
    header = expr[len('lambda'):expr.index(':')]
    argnames = tuple(a.strip() for a in header.split(',') if a.strip())
    fn = eval(expr, {'np': jnp, 'jnp': jnp, 'math': math})  # noqa: S307 (trusted config)
    return fn, argnames


class ParamSpace:
    """Sampled + fixed + derived parameters with JAX prior/ref functions."""

    def __init__(self, params_block: Dict):
        self.sampled: List[SampledParam] = []
        self.fixed: Dict[str, float] = {}
        self.derived: List[DerivedParam] = []
        for name, spec in (params_block or {}).items():
            if spec is None:
                raise InputError(
                    f"Parameter '{name}' has no specification; give a prior, a "
                    "fixed value, or a derived lambda")
            if isinstance(spec, (int, float)):
                self.fixed[name] = float(spec)
                continue
            if not isinstance(spec, dict):
                raise InputError(f"Bad specification for parameter '{name}': {spec!r}")
            if spec.get('derived') is True:
                continue  # output-only derived (e.g. chi2), produced by the runner
            if 'value' in spec:
                val = spec['value']
                if isinstance(val, str):
                    fn, args = _parse_lambda(val)
                    self.derived.append(DerivedParam(name, fn, args,
                                                     spec.get('latex'), val))
                else:
                    self.fixed[name] = float(val)
                continue
            prior = spec.get('prior')
            if prior is None:
                raise InputError(f"Parameter '{name}' needs a prior, value, or derived flag")
            dist = prior.get('dist', 'uniform')
            if dist in ('uniform', 'loguniform'):
                # scipy.stats.loguniform uses a/b; cobaya configs write min/max
                lo = float(prior['min'] if 'min' in prior else prior['a'])
                hi = float(prior['max'] if 'max' in prior else prior['b'])
                if dist == 'loguniform' and lo <= 0:
                    raise InputError(f"loguniform prior for '{name}' needs min > 0")
            elif dist in ('norm', 'halfnorm'):
                lo = float(prior.get('loc', 0.0))
                hi = float(prior.get('scale', 1.0))
            else:
                raise InputError(f"Unsupported prior dist '{dist}' for '{name}'")
            ref = spec.get('ref')
            if ref is None:
                ref = {}
            if isinstance(ref, (int, float)):   # scalar ref, incl. `ref: 0`
                ref = {'dist': 'norm', 'loc': float(ref), 'scale': 0.0}
            # a ref block without an explicit dist means norm in cobaya
            # ({loc, scale} shorthand); an empty/missing ref falls back to
            # prior draws. Unsupported dists error loudly — silently
            # scattering starts over the whole prior hid misconfiguration.
            ref_dist = ref.get('dist', 'norm' if ref else 'prior')
            if ref_dist not in ('prior', 'norm', 'uniform', 'loguniform',
                                'halfnorm'):
                raise InputError(
                    f"Unsupported ref dist '{ref_dist}' for '{name}'")
            ref_lo = ref_hi = 0.0
            if ref_dist in ('uniform', 'loguniform'):
                ref_lo = float(ref['min'] if 'min' in ref else ref['a'])
                ref_hi = float(ref['max'] if 'max' in ref else ref['b'])
            ref_scale = float(ref.get('scale', 1.0))
            if ref_dist in ('norm', 'halfnorm') and ref_scale == 0.0:
                # zero start scatter would collapse the walker ensemble (see
                # module docstring); proposal width, else 1% of prior scale
                if spec.get('proposal'):
                    ref_scale = float(spec['proposal'])
                elif dist in ('uniform', 'loguniform'):
                    ref_scale = 0.01 * (hi - lo)
                else:
                    ref_scale = 0.01 * hi
            self.sampled.append(SampledParam(
                name=name, dist=dist, lo=lo, hi=hi,
                ref_dist=ref_dist,
                ref_loc=float(ref.get('loc', 0.0)),
                ref_scale=ref_scale,
                ref_lo=ref_lo, ref_hi=ref_hi,
                proposal=spec.get('proposal'),
                latex=spec.get('latex'),
            ))

    # ------------------------------------------------------------------
    @property
    def names(self) -> List[str]:
        return [p.name for p in self.sampled]

    @property
    def ndim(self) -> int:
        return len(self.sampled)

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        lo = np.array([p.lo if p.dist in ('uniform', 'loguniform', 'halfnorm')
                       else -np.inf for p in self.sampled])
        hi = np.array([p.hi if p.dist in ('uniform', 'loguniform')
                       else np.inf for p in self.sampled])
        return lo, hi

    # ------------------------------------------------------------------
    def log_prior(self, theta: jnp.ndarray) -> jnp.ndarray:
        """Log prior density at theta (..., ndim); -inf outside support."""
        lp = jnp.zeros(theta.shape[:-1])
        for i, p in enumerate(self.sampled):
            x = theta[..., i]
            if p.dist == 'uniform':
                inside = (x >= p.lo) & (x <= p.hi)
                lp = jnp.where(inside, lp - math.log(p.hi - p.lo), -jnp.inf)
            elif p.dist == 'loguniform':
                inside = (x >= p.lo) & (x <= p.hi)
                lp = jnp.where(inside,
                               lp - jnp.log(x) - math.log(math.log(p.hi / p.lo)),
                               -jnp.inf)
            elif p.dist == 'halfnorm':
                inside = x >= p.lo
                dens = -0.5 * ((x - p.lo) / p.hi) ** 2 - math.log(p.hi) \
                    + 0.5 * math.log(2.0 / math.pi)
                lp = jnp.where(inside, lp + dens, -jnp.inf)
            else:  # norm
                lp = lp - 0.5 * ((x - p.lo) / p.hi) ** 2 \
                     - math.log(p.hi) - 0.5 * math.log(2 * math.pi)
        return lp

    def sample_prior(self, key: jax.Array, n: int) -> jnp.ndarray:
        """Draw n points from the prior itself (NOT the ref distribution).

        SMC's evidence estimate requires the initial particle cloud to be
        exact prior draws; `sample_ref` (narrow start scatter) would bias
        log Z."""
        keys = jax.random.split(key, self.ndim)
        cols = []
        for i, p in enumerate(self.sampled):
            if p.dist == 'uniform':
                col = jax.random.uniform(keys[i], (n,), minval=p.lo, maxval=p.hi)
            elif p.dist == 'loguniform':
                col = jnp.exp(jax.random.uniform(
                    keys[i], (n,), minval=math.log(p.lo), maxval=math.log(p.hi)))
            elif p.dist == 'halfnorm':
                col = p.lo + p.hi * jnp.abs(jax.random.normal(keys[i], (n,)))
            else:  # norm
                col = p.lo + p.hi * jax.random.normal(keys[i], (n,))
            cols.append(col)
        return jnp.stack(cols, axis=-1)

    def sample_ref(self, key: jax.Array, n: int) -> jnp.ndarray:
        """Draw n starting points from the ref distributions (prior fallback),
        clipped into the prior support."""
        keys = jax.random.split(key, self.ndim)
        cols = []
        for i, p in enumerate(self.sampled):
            if p.ref_dist == 'norm':
                col = p.ref_loc + p.ref_scale * jax.random.normal(keys[i], (n,))
            elif p.ref_dist == 'uniform':
                col = jax.random.uniform(keys[i], (n,),
                                         minval=p.ref_lo, maxval=p.ref_hi)
            elif p.ref_dist == 'loguniform':
                col = jnp.exp(jax.random.uniform(
                    keys[i], (n,), minval=math.log(p.ref_lo),
                    maxval=math.log(p.ref_hi)))
            elif p.ref_dist == 'halfnorm':
                col = p.ref_loc \
                    + p.ref_scale * jnp.abs(jax.random.normal(keys[i], (n,)))
            elif p.dist == 'uniform':
                col = jax.random.uniform(keys[i], (n,), minval=p.lo, maxval=p.hi)
            elif p.dist == 'loguniform':
                col = jnp.exp(jax.random.uniform(
                    keys[i], (n,), minval=math.log(p.lo), maxval=math.log(p.hi)))
            elif p.dist == 'halfnorm':
                col = p.lo + p.hi * jnp.abs(jax.random.normal(keys[i], (n,)))
            else:
                col = p.lo + p.hi * jax.random.normal(keys[i], (n,))
            if p.dist in ('uniform', 'loguniform'):
                width = p.hi - p.lo
                col = jnp.clip(col, p.lo + 1e-6 * width, p.hi - 1e-6 * width)
            elif p.dist == 'halfnorm':
                col = jnp.maximum(col, p.lo + 1e-6 * p.hi)
            cols.append(col)
        return jnp.stack(cols, axis=-1)

    # ------------------------------------------------------------------
    # unbounded reparameterisation (for gradient-based samplers): interval
    # priors (uniform: linear scale; loguniform: log scale) map through a
    # scaled logit, half-line priors (halfnorm) through log, norm priors
    # through identity — trajectories never hit the support boundary
    # ------------------------------------------------------------------
    def to_unbounded(self, theta: jnp.ndarray) -> jnp.ndarray:
        cols = []
        for i, p in enumerate(self.sampled):
            x = theta[..., i]
            if p.dist in ('uniform', 'loguniform'):
                if p.dist == 'loguniform':
                    u = (jnp.log(x) - math.log(p.lo)) / math.log(p.hi / p.lo)
                else:
                    u = (x - p.lo) / (p.hi - p.lo)
                # dtype-safe bounds: 1 - 1e-12 rounds to 1.0 in f32 (the device
                # path), making the upper clip a no-op — a draw at (or
                # rounding to) the support edge would map to logit(1) = +inf
                # and poison the SMC/NS particle moments (same f32-rounding
                # class as the halfnorm tiny-floor below). epsneg is the
                # largest eps with 1 - eps < 1 exactly representable.
                eps = jnp.finfo(jnp.asarray(u).dtype).epsneg
                u = jnp.clip(u, eps, 1 - eps)
                cols.append(jnp.log(u) - jnp.log1p(-u))
            elif p.dist == 'halfnorm':
                # dtype-safe floor: 1e-300 underflows to 0.0 in f32 (the device
                # path), turning the guard into log(0) = -inf at x == p.lo
                tiny = jnp.finfo(jnp.asarray(x).dtype).tiny
                cols.append(jnp.log(jnp.maximum(x - p.lo, tiny)))
            else:
                cols.append(x)
        return jnp.stack(cols, axis=-1)

    def to_bounded(self, y: jnp.ndarray) -> jnp.ndarray:
        cols = []
        for i, p in enumerate(self.sampled):
            v = y[..., i]
            if p.dist == 'uniform':
                cols.append(p.lo + (p.hi - p.lo) * jax.nn.sigmoid(v))
            elif p.dist == 'loguniform':
                cols.append(jnp.exp(math.log(p.lo)
                                    + math.log(p.hi / p.lo) * jax.nn.sigmoid(v)))
            elif p.dist == 'halfnorm':
                cols.append(p.lo + jnp.exp(v))
            else:
                cols.append(v)
        return jnp.stack(cols, axis=-1)

    def log_jacobian(self, y: jnp.ndarray) -> jnp.ndarray:
        """log |d theta / d y| summed over parameters."""
        lj = jnp.zeros(y.shape[:-1])
        for i, p in enumerate(self.sampled):
            v = y[..., i]
            if p.dist == 'uniform':
                lj = lj + math.log(p.hi - p.lo) + jax.nn.log_sigmoid(v) \
                    + jax.nn.log_sigmoid(-v)
            elif p.dist == 'loguniform':
                # theta = exp(log lo + W sig(v)), W = log(hi/lo):
                # dtheta/dv = theta * W * sig(v) sig(-v)
                s = jax.nn.sigmoid(v)
                lj = lj + math.log(p.lo) + math.log(p.hi / p.lo) * s \
                    + math.log(math.log(p.hi / p.lo)) \
                    + jax.nn.log_sigmoid(v) + jax.nn.log_sigmoid(-v)
            elif p.dist == 'halfnorm':
                lj = lj + v
        return lj

    def dtheta_dy_diag(self, y: jnp.ndarray) -> jnp.ndarray:
        """Per-parameter d theta_i / d y_i at y (..., ndim).

        The reparameterisation is elementwise, so its Jacobian is diagonal;
        this is the factor that maps theta-space proposal widths / covmats
        (cobaya's `proposal:` entries and `.covmat` files, reference
        config/boss_cobaya_config.yaml:60,72,84,96) into the unbounded
        space the samplers actually step in."""
        cols = []
        for i, p in enumerate(self.sampled):
            v = y[..., i]
            if p.dist == 'uniform':
                cols.append((p.hi - p.lo)
                            * jax.nn.sigmoid(v) * jax.nn.sigmoid(-v))
            elif p.dist == 'loguniform':
                theta = jnp.exp(math.log(p.lo)
                                + math.log(p.hi / p.lo) * jax.nn.sigmoid(v))
                cols.append(theta * math.log(p.hi / p.lo)
                            * jax.nn.sigmoid(v) * jax.nn.sigmoid(-v))
            elif p.dist == 'halfnorm':
                cols.append(jnp.exp(v))
            else:  # norm: identity map
                cols.append(jnp.ones_like(v))
        return jnp.stack(cols, axis=-1)

    def proposal_scales_unbounded(self, y: jnp.ndarray) -> jnp.ndarray:
        """Per-parameter proposal widths mapped to the unbounded space at y
        (..., ndim): sigma_y_i = proposal_i / (d theta_i / d y_i).
        Parameters without a `proposal:` entry keep 1.0 — the identity seed
        the samplers previously always started from. Clipped to [1e-3, 20]:
        near a support edge d theta/d y -> 0 and an unclipped seed would
        blow up the stage-1 warmup before Welford can correct it."""
        j = self.dtheta_dy_diag(y)
        prop = jnp.asarray([p.proposal if p.proposal else jnp.nan
                            for p in self.sampled])
        scales = jnp.where(jnp.isnan(prop), 1.0,
                           jnp.clip(prop / j, 1e-3, 20.0))
        return jnp.broadcast_to(scales, y.shape)

    # ------------------------------------------------------------------
    def full_params(self, theta: jnp.ndarray) -> Dict:
        """theta (..., ndim) -> params dict incl. fixed and derived values."""
        params = {k: jnp.asarray(v) for k, v in self.fixed.items()}
        for i, p in enumerate(self.sampled):
            params[p.name] = theta[..., i]
        for d in self.derived:
            params[d.name] = d.fn(*[params[a] for a in d.argnames])
        return params

    def derived_values(self, theta: jnp.ndarray) -> Dict:
        params = self.full_params(theta)
        return {d.name: params[d.name] for d in self.derived}
