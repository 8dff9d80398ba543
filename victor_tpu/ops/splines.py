"""Fixed-shape spline primitives for accelerator execution.

Design: every interpolation in the reference pipeline (victor/ccf_model.py) uses
scipy splines with *fixed knot vectors* whose evaluation is *linear in the table
values*. We therefore split each spline into

  (a) a host-side "prep" step (numpy/scipy, done once at table-build time) that
      extracts either a dense linear operator (values -> piecewise-polynomial
      coefficients, or values -> values-at-fixed-query-points), and
  (b) a device-side "eval" step (pure jnp, jit/vmap-safe) that locates the
      interval with a searchsorted and evaluates the local polynomial.

Because the host prep *probes scipy itself* with unit basis vectors, device
evaluation agrees with scipy to float64 rounding - this is how we achieve exact
numerical parity with the reference (e.g. `InterpolatedUnivariateSpline(k=3)`
at victor/ccf_model.py:17, `PchipInterpolator` at :326, `RectBivariateSpline`
at :654) without re-deriving any of FITPACK's boundary conventions.

Alcock-Paczynski note: the reference rebuilds splines on AP-rescaled knot
vectors `r * rescaling_factor` inside the hot loop (ccf_model.py:613,635).
Cubic splines are affinely covariant, so `spline(c*x, y)(q) == spline(x, y)(q/c)`
exactly; we keep all knots fixed and rescale the *query* instead, which is what
makes the whole hot path precomputable.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp


#: matmul with the full-precision pin — THE shared definition (imported by
#: the theory/ESM/sampler hot paths). Without it XLA may run f32 matmuls in
#: a reduced-precision mode (TF32 on the GPU), which costs ~1 on chi2;
#: keeping one copy means a future change to how the pin is expressed
#: cannot miss a site and reintroduce the degradation.
matmul_highest = functools.partial(jnp.matmul, precision='highest')


# ---------------------------------------------------------------------------
# Host-side preparation (numpy / scipy)
# ---------------------------------------------------------------------------

def cubic_deriv_operator(x: np.ndarray) -> np.ndarray:
    """Linear operator D (n, n) mapping values y to not-a-knot nodal derivatives.

    The interpolating cubic spline is then recovered in (well-conditioned)
    Hermite form per interval - see `Spline1D.coeffs`. Matches
    scipy.interpolate.InterpolatedUnivariateSpline(x, y, k=3) exactly
    (verified: IUS(k=3, s=0) == CubicSpline(bc_type='not-a-knot')).
    Probing the *derivative* operator instead of the raw piecewise-polynomial
    coefficients (entries ~1/h rather than ~1/h^3) keeps the values->spline
    map accurate to ~1e-12 even on irregular knot vectors.
    """
    from scipy.interpolate import CubicSpline
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    D = np.zeros((n, n))
    for j in range(n):
        e = np.zeros(n)
        e[j] = 1.0
        D[:, j] = CubicSpline(x, e, bc_type='not-a-knot')(x, 1)
    return D


def hermite_coeffs(x, y, d):
    """Per-interval ascending-power cubic coefficients from values + derivatives.

    Works for numpy or jnp inputs; y/d may have leading batch axes over the
    trailing knot axis. Returns (..., n-1, 4).
    """
    np_ = jnp if isinstance(y, jax.Array) or isinstance(d, jax.Array) else np
    h = x[1:] - x[:-1]
    dy = (y[..., 1:] - y[..., :-1]) / h
    c0 = y[..., :-1]
    c1 = d[..., :-1]
    c2 = (3.0 * dy - 2.0 * d[..., :-1] - d[..., 1:]) / h
    c3 = (d[..., :-1] + d[..., 1:] - 2.0 * dy) / (h * h)
    return np_.stack([c0, c1, c2, c3], axis=-1)


def spline_eval_matrix(x: np.ndarray, q: np.ndarray, ext: int = 0) -> np.ndarray:
    """Dense matrix E (len(q), len(x)) with E @ y == IUS(x, y, k=3, ext=ext)(q).

    Used to fold fixed-query-point spline evaluations (e.g. the derivative
    grids at victor/ccf_model.py:456-459) into single matmuls.
    """
    from scipy.interpolate import InterpolatedUnivariateSpline
    x = np.asarray(x, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    n = len(x)
    E = np.zeros((len(q), n))
    for j in range(n):
        e = np.zeros(n)
        e[j] = 1.0
        E[:, j] = InterpolatedUnivariateSpline(x, e, k=3, ext=ext)(q)
    return E


def gradient_matrix(x: np.ndarray) -> np.ndarray:
    """Dense matrix G with G @ y == np.gradient(y, x): 2nd-order central
    differences in the interior, 1st-order one-sided at the edges (numpy's
    default edge_order=1 — which the unit-vector probe below reproduces
    exactly; do NOT re-derive this analytically with 2nd-order edge rows,
    that would break bit-parity with the reference's np.gradient pipeline)."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    G = np.zeros((n, n))
    for j in range(n):
        e = np.zeros(n)
        e[j] = 1.0
        G[:, j] = np.gradient(e, x)
    return G


def pchip_coeffs(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """PCHIP piecewise-polynomial coefficients for a *static* table.

    y may have trailing axes: shape (n, ...). Returns coeffs of shape
    (n-1, 4, ...) in ascending power order: on interval i,
        f(q) = sum_k c[i, k] * (q - x[i])**k.
    Matches scipy.interpolate.PchipInterpolator(x, y, axis=0) exactly
    (used at victor/ccf_model.py:326 and victor/ccf_fit.py:193 for the
    beta-grid interpolation of multipole tables).
    """
    from scipy.interpolate import PchipInterpolator
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    p = PchipInterpolator(x, y, axis=0)
    # p.c shape: (4, n-1, ...) descending powers -> (n-1, 4, ...) ascending
    c = np.moveaxis(p.c[::-1], [0, 1], [1, 0])
    return np.ascontiguousarray(c)


def bicubic_cell_coeffs(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Per-cell bicubic polynomial coefficients of RectBivariateSpline(x, y, z).

    Returns A of shape (nx-1, ny-1, 4, 4) in *normalized* cell coordinates:
        f(q, p) = sum_{a,b} A[i, j, a, b] * u**a * v**b,
        u = (q - x[i]) / (x[i+1] - x[i]),  v = (p - y[j]) / (y[j+1] - y[j]).
    Extracted by exactly fitting the (bicubic) restriction of the spline on a
    4x4 sample grid per cell; agrees with `RectBivariateSpline.ev` to ~1e-13.
    Replaces the AP-rescaled dispersion-template spline at
    victor/ccf_model.py:654,667. Note FITPACK's `.ev` *clamps* out-of-range
    arguments to the grid boundary; the device eval below reproduces that.
    """
    from scipy.interpolate import RectBivariateSpline
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    rbs = RectBivariateSpline(x, y, z, kx=3, ky=3, s=0)
    nx, ny = len(x) - 1, len(y) - 1
    offs = np.array([0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0])
    V = offs[:, None] ** np.arange(4)[None, :]
    Vinv = np.linalg.inv(V)
    dx = np.diff(x)
    dy = np.diff(y)
    xs = (x[:-1, None] + offs[None, :] * dx[:, None]).ravel()
    ys = (y[:-1, None] + offs[None, :] * dy[:, None]).ravel()
    XX, YY = np.meshgrid(xs, ys, indexing='ij')
    F = rbs.ev(XX.ravel(), YY.ravel()).reshape(nx, 4, ny, 4)
    A = np.einsum('pu,iujv,qv->ijpq', Vinv, F, Vinv)
    return np.ascontiguousarray(A)


# ---------------------------------------------------------------------------
# Device-side pytree containers + evaluation (pure jnp)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Spline1D:
    """A cubic spline with fixed knots whose values may change at runtime.

    `deriv_op` maps values to nodal derivatives (build with
    `cubic_deriv_operator`); coefficients are recovered in Hermite form.
    `clamp` reproduces scipy ext=3 (constant extrapolation); clamp=False gives
    ext=0 (polynomial extension of the end pieces).
    """
    x: jax.Array                       # (n,)
    deriv_op: jax.Array                # (n, n)
    clamp: bool = dataclasses.field(metadata=dict(static=True), default=True)

    @classmethod
    def build(cls, x, clamp: bool = True) -> 'Spline1D':
        x = np.asarray(x, dtype=np.float64)
        return cls(x=jnp.asarray(x), deriv_op=jnp.asarray(cubic_deriv_operator(x)),
                   clamp=clamp)

    def coeffs(self, y: jax.Array) -> jax.Array:
        """(..., n) values -> (..., n-1, 4) local polynomial coefficients."""
        d = jnp.einsum('ij,...j->...i', self.deriv_op, y, precision='highest')
        return hermite_coeffs(self.x, y, d)

    def eval(self, coeffs: jax.Array, q: jax.Array) -> jax.Array:
        return ppoly_eval(self.x, coeffs, q, clamp=self.clamp)

    def __call__(self, y: jax.Array, q: jax.Array) -> jax.Array:
        return self.eval(self.coeffs(y), q)


def default_strategy(backend: str) -> str:
    """`ppoly_eval`'s evaluation strategy for a JAX backend name: the
    measured end-to-end winner (PERF.md). On an H100 'masksum' beats
    'gather' on the streaming, dispersion and excursion-set likelihoods;
    on the CPU 'gather' wins."""
    return 'masksum' if backend == 'gpu' else 'gather'


def ppoly_eval(x: jax.Array, coeffs: jax.Array, q: jax.Array,
               clamp: bool = True, strategy: str | None = None) -> jax.Array:
    """Evaluate a piecewise cubic at query points q.

    x:      (n,) breakpoints (sorted)
    coeffs: (..., n-1, 4) ascending-power local coefficients
    q:      arbitrary shape
    clamp:  if True, clamp q into [x[0], x[-1]] (scipy ext=3 semantics);
            otherwise the end polynomials extend (ext=0 / PPoly extrapolate).
    strategy: 'gather' (searchsorted + coefficient gather) or 'masksum'
            (interval-mask accumulation with zero gathers). None picks by
            backend (`default_strategy`). Both are bit-identical selections
            of the same local polynomial.
    """
    n = x.shape[0]
    qq = jnp.clip(q, x[0], x[-1]) if clamp else q
    if strategy is None:
        strategy = default_strategy(jax.default_backend())

    if strategy == 'gather':
        idx = jnp.clip(jnp.searchsorted(x, qq, side='right',
                                        method='compare_all') - 1, 0, n - 2)
        t = qq - x[idx]
        # gather each coefficient plane separately: a fused (..., *q.shape, 4)
        # gather pads its minor axis of 4 in the device layout
        c0 = coeffs[..., idx, 0]
        c1 = coeffs[..., idx, 1]
        c2 = coeffs[..., idx, 2]
        c3 = coeffs[..., idx, 3]
        return ((c3 * t + c2) * t + c1) * t + c0

    # masksum: interval-masked local polynomials summed over a broadcast
    # interval axis. Interval membership reproduces
    # clip(searchsorted(right)-1, 0, n-2): interval 0 extends to -inf,
    # interval n-2 to +inf. XLA fuses the broadcast + reduction so the
    # (n-1, ...) intermediate is never materialised — runtime matches a
    # static unroll bit-for-bit, but the traced graph is ~n-1 times smaller
    # (an unrolled version cost seconds of tracing and 10x the compile time;
    # lax.fori_loop additionally bounced the accumulator through HBM).
    #
    # Leading coefficient axes (K channels sharing the knot vector, e.g. the
    # (v_r, dv_r) pair or the real-space multipole stack) evaluate in ONE
    # pass: the query offsets `t` and the interval masks are computed once
    # and broadcast over the channel axes, so K fused channels cost roughly
    # (4 + 5K)/(9K) of K separate passes. Per channel the op
    # sequence (and therefore the float result) is identical to a
    # single-channel call.
    lead = coeffs.ndim - 2            # number of leading channel axes
    qx = (None,) * (1 + lead)         # broadcast q under (interval, *lead)
    xe = (slice(None),) + (None,) * (lead + qq.ndim)
    ce = (Ellipsis,) + (None,) * qq.ndim
    cm = jnp.moveaxis(coeffs, -2, 0)  # (n-1, *lead, 4)
    t = qq[qx] - x[:-1][xe]
    c0 = cm[..., 0][ce]
    c1 = cm[..., 1][ce]
    c2 = cm[..., 2][ce]
    c3 = cm[..., 3][ce]
    p = ((c3 * t + c2) * t + c1) * t + c0
    neg_inf = jnp.asarray([-jnp.inf], dtype=x.dtype)
    pos_inf = jnp.asarray([jnp.inf], dtype=x.dtype)
    lo = jnp.concatenate([neg_inf, x[1:-1]])
    hi = jnp.concatenate([x[1:-1], pos_inf])
    m = (qq[qx] >= lo[xe]) & (qq[qx] < hi[xe])
    # `+ (qq - qq)` propagates NaN queries: a NaN fails every interval mask,
    # so the select alone would return a finite-but-bogus 0 where the gather
    # strategy (and scipy) propagate NaN — silently hiding invalid parameter
    # points from the likelihood's NaN guard. The post-sum term is 0 for
    # finite queries (bit-identical result) and NaN for NaN queries, and
    # costs two ops per POINT — a NaN-aware mask would cost per interval on
    # this elementwise-bound hot path.
    return jnp.sum(jnp.where(m, p, 0.0), axis=0) + (qq - qq)


def pchip_eval(x, coeffs, q):
    """Evaluate host-precomputed PCHIP coefficients (n-1, 4, ...) at scalar q
    (polynomial end-extrapolation, no clamp — scipy PchipInterpolator
    semantics). Shared by PchipTable and the raw-array call sites in the
    theory/likelihood hot paths."""
    n = x.shape[0]
    idx = jnp.clip(jnp.searchsorted(x, q, side='right',
                                    method='compare_all') - 1, 0, n - 2)
    t = q - x[idx]
    c = coeffs[idx]                              # (4, ...)
    return ((c[3] * t + c[2]) * t + c[1]) * t + c[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PchipTable:
    """A static PCHIP-interpolated table f(beta) -> (...) built on the host.

    Reproduces scipy PchipInterpolator (polynomial end-extrapolation, no clamp),
    as used for the beta-reconstruction grids (victor/ccf_model.py:326).
    """
    x: jax.Array          # (n,)
    coeffs: jax.Array     # (n-1, 4, ...) ascending powers

    @classmethod
    def build(cls, x, y):
        return cls(x=jnp.asarray(x), coeffs=jnp.asarray(pchip_coeffs(x, y)))

    def __call__(self, q: jax.Array) -> jax.Array:
        """Evaluate at scalar q; returns array with the table's trailing shape."""
        return pchip_eval(self.x, self.coeffs, q)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Bicubic2D:
    """Static bicubic surface with FITPACK `.ev` semantics (clamped arguments).

    Stored in exact SVD tensor-product form: RectBivariateSpline(x, y, z) is a
    tensor-product interpolant, linear in z, so with z = sum_m u_m v_m^T (SVD)
    the surface is exactly sum_m S_x[u_m](q) * S_y[v_m](p) where S_x/S_y are
    the 1D FITPACK cubic interpolants (== not-a-knot). Evaluation is then a
    handful of 1D piecewise-cubic evals — no 2D cell gathers of (4, 4)
    coefficient blocks.
    Rank is truncated at machine precision; separable surfaces (e.g. the BOSS
    isotropic dispersion template, constant in mu) collapse to rank 1.
    """
    x: jax.Array          # (nx,)
    y: jax.Array          # (ny,)
    cu: jax.Array         # (R, nx-1, 4) x-factor piecewise-cubic coefficients
    cv: jax.Array         # (R, ny-1, 4) y-factor piecewise-cubic coefficients
    y_const: bool = dataclasses.field(metadata=dict(static=True), default=False)

    @classmethod
    def build(cls, x, y, z):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        z = np.asarray(z, dtype=np.float64)
        U, s, Vt = np.linalg.svd(z, full_matrices=False)
        rank = max(1, int(np.sum(s > s[0] * 1e-13))) if s[0] > 0 else 1
        Dx = cubic_deriv_operator(x)
        Dy = cubic_deriv_operator(y)
        cu = np.stack([hermite_coeffs(x, U[:, m] * s[m], Dx @ (U[:, m] * s[m]))
                       for m in range(rank)])
        cv = np.stack([hermite_coeffs(y, Vt[m], Dy @ Vt[m])
                       for m in range(rank)])
        # y-independent surface (e.g. an isotropic dispersion template tiled
        # over mu, io/tables.py): every y-factor is a constant function, so
        # evaluation skips the y-direction piecewise polynomial entirely —
        # ~40% of the hot-path interval terms for the BOSS config. Fold the
        # constants into cu so ev() multiplies by nothing.
        scale = np.max(np.abs(Vt[:rank])) or 1.0
        y_const = bool(np.all(np.ptp(Vt[:rank], axis=1) < 1e-13 * scale))
        if y_const:
            cu = cu * Vt[:rank, 0][:, None, None]  # fold constant y-values in
        return cls(x=jnp.asarray(x), y=jnp.asarray(y),
                   cu=jnp.asarray(cu), cv=jnp.asarray(cv), y_const=y_const)

    def ev(self, q: jax.Array, p: jax.Array) -> jax.Array:
        # FITPACK .ev clamps out-of-range arguments to the grid boundary
        qc = jnp.clip(q, self.x[0], self.x[-1])
        rank = self.cu.shape[0]
        if self.y_const:
            out = None
            for m in range(rank):
                term = ppoly_eval(self.x, self.cu[m], qc, clamp=False)
                out = term if out is None else out + term
            return out
        pc = jnp.clip(p, self.y[0], self.y[-1])
        out = None
        for m in range(rank):
            term = ppoly_eval(self.x, self.cu[m], qc, clamp=False) * \
                   ppoly_eval(self.y, self.cv[m], pc, clamp=False)
            out = term if out is None else out + term
        return out


# ---------------------------------------------------------------------------
# Dynamic-knot primitives (knot positions traced, e.g. ESM Eulerian radii)
# ---------------------------------------------------------------------------

def cubic_coeffs_dynamic(x, y):
    """Not-a-knot cubic spline coefficients for *traced* knot positions.

    Unlike `Spline1D` (fixed knots, host-probed operator), this solves the
    not-a-knot first-derivative system on device (dense solve; the ESM grids
    are ~50-100 knots, so the solve is tiny). Matches
    scipy.interpolate.CubicSpline(x, y, bc_type='not-a-knot') == IUS(k=3),
    which the reference builds on the parameter-dependent Eulerian radius
    grid every call (victor/excursion_set_profile.py:371,486).
    Returns Hermite-form local coefficients (n-1, 4) for `ppoly_eval`.
    """
    n = x.shape[0]
    dx = x[1:] - x[:-1]
    slope = (y[..., 1:] - y[..., :-1]) / dx

    A = jnp.zeros((n, n), dtype=x.dtype)
    b = jnp.zeros(y.shape[:-1] + (n,), dtype=x.dtype)
    # interior rows (scipy _cubic.py not-a-knot formulation)
    idx = jnp.arange(1, n - 1)
    A = A.at[idx, idx - 1].set(dx[1:])
    A = A.at[idx, idx].set(2.0 * (dx[1:] + dx[:-1]))
    A = A.at[idx, idx + 1].set(dx[:-1])
    b = b.at[..., 1:-1].set(3.0 * (dx[1:] * slope[..., :-1] +
                                   dx[:-1] * slope[..., 1:]))
    # not-a-knot boundaries
    d0 = x[2] - x[0]
    dN = x[n - 1] - x[n - 3]
    A = A.at[0, 0].set(dx[1])
    A = A.at[0, 1].set(d0)
    b = b.at[..., 0].set(((dx[0] + 2.0 * d0) * dx[1] * slope[..., 0]
                          + dx[0] ** 2 * slope[..., 1]) / d0)
    A = A.at[n - 1, n - 1].set(dx[n - 3])
    A = A.at[n - 1, n - 2].set(dN)
    b = b.at[..., n - 1].set((dx[n - 2] ** 2 * slope[..., n - 3]
                              + (2.0 * dN + dx[n - 2]) * dx[n - 3]
                              * slope[..., n - 2]) / dN)
    d = jnp.linalg.solve(A, b[..., None])[..., 0]
    return hermite_coeffs(x, y, d)


def ppoly_eval_dynamic(x, coeffs, q, clamp: bool = True):
    """Piecewise-cubic evaluation when knots `x` are traced values.

    Same interval semantics as `ppoly_eval`, via the same broadcast
    interval-axis mask-sum (works unchanged for traced knots: the masks are
    elementwise comparisons) — no gathers, tiny traced graph.
    """
    qq = jnp.clip(q, x[0], x[-1]) if clamp else q
    expand = (slice(None),) + (None,) * qq.ndim
    t = qq[None] - x[:-1][expand]
    c0 = coeffs[:, 0][expand]
    c1 = coeffs[:, 1][expand]
    c2 = coeffs[:, 2][expand]
    c3 = coeffs[:, 3][expand]
    p = ((c3 * t + c2) * t + c1) * t + c0
    neg_inf = jnp.asarray([-jnp.inf], dtype=x.dtype)
    pos_inf = jnp.asarray([jnp.inf], dtype=x.dtype)
    lo = jnp.concatenate([neg_inf, x[1:-1]])
    hi = jnp.concatenate([x[1:-1], pos_inf])
    m = (qq[None] >= lo[expand]) & (qq[None] < hi[expand])
    # `+ (qq - qq)` propagates NaN queries — see ppoly_eval
    return jnp.sum(jnp.where(m, p, 0.0), axis=0) + (qq - qq)


def gradient_nonuniform(y, x):
    """np.gradient(y, x) parity for traced inputs: 2nd-order interior,
    1st-order one-sided edges (numpy default edge_order=1).
    Used for the reference's repeated np.gradient calls on parameter-dependent
    profiles (victor/ccf_model.py:379,472; excursion_set_profile.py:411)."""
    hd = x[1:-1] - x[:-2]
    hs = x[2:] - x[1:-1]
    interior = (hd ** 2 * y[..., 2:] + (hs ** 2 - hd ** 2) * y[..., 1:-1]
                - hs ** 2 * y[..., :-2]) / (hs * hd * (hd + hs))
    left = (y[..., 1] - y[..., 0]) / (x[1] - x[0])
    right = (y[..., -1] - y[..., -2]) / (x[-1] - x[-2])
    return jnp.concatenate([left[..., None], interior, right[..., None]], axis=-1)


# ---------------------------------------------------------------------------
# Chebyshev compression of a 1D function (cheap re-evaluation)
# ---------------------------------------------------------------------------

import functools as _functools


@_functools.lru_cache(maxsize=None)
def _cheb_probe_inverse(degree: int) -> tuple:
    """(INV, nodes): static inverse of the Chebyshev collocation matrix at
    the degree+1 Chebyshev points (coef = INV @ f(nodes)) and the node
    cosines."""
    k = np.arange(degree + 1)
    nodes = np.cos((2 * k + 1) * np.pi / (2 * (degree + 1)))
    T = np.cos(np.outer(np.arccos(nodes), np.arange(degree + 1)))
    return np.linalg.inv(T), nodes


def chebyshev_fit(fn, a, b, degree: int = 32):
    """Fit fn on [a, b] (a, b may be traced) by a degree-`degree` Chebyshev
    interpolant: returns the (degree+1,) coefficient array.

    Used to compress a spline into a dense polynomial that evaluates in
    ~2*degree FMA per point instead of ~12 ops per knot interval — a ~5x op
    reduction for the 30-knot velocity spline. The interpolant of a C^2
    cubic spline converges fast enough that degree 32 reaches ~5e-4 relative
    (measured on the BOSS velocity profile); use ONLY where a downstream
    contraction bounds the error (see models/ccf_theory.py dispersion loop).
    """
    inv, nodes = _cheb_probe_inverse(degree)
    mid = 0.5 * (a + b)
    half = 0.5 * (b - a)
    rn = mid + half * jnp.asarray(nodes)
    f = fn(rn)
    return jnp.einsum('ij,j->i', jnp.asarray(inv), f, precision='highest')


def chebyshev_eval(coef: jax.Array, a, b, q: jax.Array) -> jax.Array:
    """Clenshaw evaluation of a Chebyshev series on [a, b]; q clipped into
    the domain (matching constant extrapolation to fit accuracy)."""
    u = jnp.clip((2.0 * q - (a + b)) / (b - a), -1.0, 1.0)
    b1 = jnp.zeros_like(u)
    b2 = jnp.zeros_like(u)
    for k in range(coef.shape[0] - 1, 0, -1):
        b1, b2 = 2.0 * u * b1 - b2 + coef[k], b1
    return u * b1 - b2 + coef[0]


def chebyshev_eval_trig(coef: jax.Array, a, b, q: jax.Array) -> jax.Array:
    """The same series as `chebyshev_eval` through the trigonometric identity
    T_k(u) = cos(k*arccos(u)): one arccos + a (K, q) cos basis + one
    contraction — a k-PARALLEL graph whose reverse-mode transpose is a
    parallel broadcast-reduce, versus Clenshaw's 2(K-1)-step sequential
    recurrence.

    Rejected as a fix for streaming fast mode's AD cost: the Clenshaw
    recurrence's sequential steps are each one cheap FMA over the
    150k-point vector, while the trig form replaces them with ~K
    transcendentals per point. Kept as the reference point for that
    conclusion, with exact-parity tests.

    u is clipped just INSIDE [-1, 1]: beyond the fit domain the series is
    constant-extrapolated to fit accuracy anyway, and the margin keeps
    d(arccos)/du = -1/sqrt(1-u^2) finite under AD (at u = +-1 exactly the
    gradient would be inf -> NaN in the samplers)."""
    eps = 1e-6
    u = jnp.clip((2.0 * q - (a + b)) / (b - a), -1.0 + eps, 1.0 - eps)
    theta = jnp.arccos(u)
    k = jnp.arange(coef.shape[0], dtype=coef.dtype)
    basis = jnp.cos(theta[..., None] * k)
    return jnp.einsum('...k,k->...', basis, coef, precision='highest')
