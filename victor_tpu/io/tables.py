"""Build frozen device-resident tables from reference-schema config dicts.

This performs, once at init time on the host, everything the reference does in
`CCFModel.__init__`/`CCFFit.__init__` (victor/ccf_model.py:33-297,
victor/ccf_fit.py:15-164) *plus* the extraction of linear operators that let
the per-evaluation hot path run as pure gathers/matmuls on device:

  * PCHIP piecewise polynomials over the reconstruction beta grids,
  * cubic-spline nodal-derivative operators on the fixed r knot vectors,
  * the enclosed-density integral operator (linear-bias matter model),
  * resampled-gradient operators for the numerically-differentiated velocity
    branches,
  * bicubic cell coefficients of the (savgol-filtered, monopole-normalised)
    velocity dispersion surface,
  * the Legendre multipole projection matrix,
  * fixed quadrature weights (old-scipy `simps even='avg'` on the 50-node
    velocity grid; trapz for the AP mu-integral),
  * inverse covariance / covariance stacks over the beta grid.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import ops
from ..config import (FitOptions, TableSpec, TheoryOptions,
                      fit_options_from_config, theory_options_from_config)
from ..errors import InputError
from ..models.cosmology import BackgroundCosmology
from .loaders import load_key_value_file, select_simulation


# ---------------------------------------------------------------------------
# pytree containers
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CCFTables:
    """All device-resident arrays/operators needed for theory + likelihood."""
    # --- scalars ---
    iaH: jax.Array
    template_sigma8: Optional[jax.Array]
    bias_default: jax.Array
    # --- real-space CCF over (beta,) r ---
    r: jax.Array                               # (n_r,)
    beta_grid: Optional[jax.Array]             # (n_b,) or None if fixed input
    real_mult_fixed: Optional[jax.Array]       # (n_ell, n_r)
    real_mult_pchip_c: Optional[jax.Array]     # (n_b-1, 4, n_ell, n_r)
    spline_mult: ops.Spline1D                  # knots r, clamped
    # --- velocity knot vector r_v = [0.01, r...] ---
    r_v: jax.Array                             # (n_r+1,)
    spline_vel: ops.Spline1D                   # knots r_v, clamped
    rgrid100: jax.Array                        # (100,) fine derivative grid
    dvr_op: jax.Array                          # (n_r+1, 100) resampled gradient
    # --- matter model (template) ---
    delta_rv: Optional[jax.Array]              # (n_r+1,)
    Delta_rv: Optional[jax.Array]              # (n_r+1,)
    delta_r100: Optional[jax.Array]            # (100,)
    Delta_r100: Optional[jax.Array]            # (100,)
    # --- matter model (linear bias): operators acting on the real monopole ---
    lb_delta_op: Optional[jax.Array]           # (n_r+1, n_r)
    lb_Delta_op: Optional[jax.Array]           # (n_r+1, n_r)
    lb_delta100_op: Optional[jax.Array]        # (100, n_r)
    lb_Delta100_op: Optional[jax.Array]        # (100, n_r)
    # --- velocity mean template ---
    vr_template_rv: Optional[jax.Array]        # (n_r+1,)
    vr_template_100: Optional[jax.Array]       # (100,)
    template_fsigma8: Optional[jax.Array]
    template_hubble_ratio: Optional[jax.Array]
    redshift_shift: Optional[jax.Array]        # (1+z_sim)/(1+z_eff)
    # --- velocity dispersion surface ---
    sv_surf: ops.Bicubic2D
    # --- integration / projection fixtures ---
    x_nodes: jax.Array                         # (n_v,) linspace(-6, 6)
    vel_weights: jax.Array                     # (n_v,) simps weights in x units
    mu_ap: jax.Array                           # (50,) linspace(1e-10, 1)
    mu_ap_w: jax.Array                         # (50,) trapz weights
    proj: jax.Array                            # (n_ell_s, n_mu)
    mu_grid: jax.Array                         # (n_mu,)
    # --- excursion-set model fixtures (None unless matter excursion_set) ---
    z_eff: jax.Array
    esm_k: Optional[jax.Array]                 # (200,) log k grid
    esm_kw: Optional[jax.Array]                # (200,) trapz weights
    esm_pk0: Optional[jax.Array]               # (200,) CAMB P(k, z=0) table
    esm_s80: Optional[jax.Array]               # sigma8(0) of the fiducial table
    esm_s8z: Optional[jax.Array]               # sigma8(z_eff) of the fiducial table
    esm_x50: Optional[jax.Array]               # (50,) density_evolution grid
    # --- data side (None when built without a data block) ---
    s: Optional[jax.Array]                     # (n_s,)
    beta_ccf: Optional[jax.Array]
    data_mult_fixed: Optional[jax.Array]       # (n_ell_s, n_s)
    data_mult_pchip_c: Optional[jax.Array]     # (n_b-1, 4, n_ell_s, n_s)
    beta_cov: Optional[jax.Array]
    cov: Optional[jax.Array]                   # (n_b, D, D) or (D, D)
    icov: Optional[jax.Array]
    # beta-covariance pencil factorization (build-time; None when the
    # covariance is fixed or a slice is non-PD): logdets of each grid
    # covariance and the generalized eigenvalues lam_i^(b) of
    # (C_end, C_b), enabling the O(D) 'factored' logdet of the blended
    # matrix (1-t) C_b + t C_end — see config.TheoryOptions.beta_covariance
    cov_logdet: Optional[jax.Array] = None     # (n_b,)
    cov_pencil: Optional[jax.Array] = None     # (n_b, D)
    # cosmology-grid CAMB mode (None unless pk_grid_file configured):
    # multilinear-interpolable log P(k) + generator sigma8 tables over a
    # small cosmology grid (axis names static in TableSpec.esm_grid_names)
    esm_grid_axes: Optional[tuple] = None      # tuple of (n_a,) axis grids
    esm_pk_grid: Optional[jax.Array] = None    # (n_cells, nk) log P(k, 0)
    esm_s80_grid: Optional[jax.Array] = None   # (n_cells,)
    esm_s8z_grid: Optional[jax.Array] = None   # (n_cells,)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CCFModelBundle:
    """Tables + static spec + default options, ready for the functional core.

    Registered as a pytree (tables are leaves; spec/options static metadata)
    so a whole bundle can be passed as a jit argument."""
    tables: CCFTables
    spec: TableSpec = dataclasses.field(metadata=dict(static=True))
    theory_opts: TheoryOptions = dataclasses.field(metadata=dict(static=True))
    fit_opts: Optional[FitOptions] = dataclasses.field(
        metadata=dict(static=True), default=None)


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

def _multipoles_from_rmu_grid(r, mu, ccf_rmu, ells, npts=200):
    """r-mu grid -> multipoles, matching the reference conversion
    (victor/ccf_model.py:169-181: *linear* interp2d + utils.multipoles_from_fn
    with a 200-point [0,1] trapz)."""
    mu_fine = np.linspace(0.0, 1.0, npts)
    tw = ops.trapz_weights(mu_fine)
    # piecewise-linear resample of each column (old interp2d kind='linear'
    # evaluated at the exact r nodes reduces to 1D linear interp over mu)
    cols = np.empty((len(r), npts))
    for i in range(len(r)):
        cols[i] = np.interp(mu_fine, mu, ccf_rmu[i])
    out = {}
    for ell in ells:
        w = (2 * ell + 1) * tw * ops.legendre_p(ell, mu_fine)
        out[f'{ell}'] = cols @ w
    return out


def _pencil_precompute(stack):
    """Host-side generalized-eigenvalue factorization of a beta-covariance
    stack (n_b, D, D): returns (logdets (n_b,), lam (n_b, D)) such that
    log det((1-t) C_b + t C_end) = logdets[b] + sum_i log((1-t) + t*lam[b, i])
    (congruence: C_b = L L^T makes the blend congruent to
    diag((1-t) + t*lam) scaled by det(C_b)). Powers the 'factored'
    beta_covariance mode, replacing the per-eval O(D^3) slogdet of the
    reference's blended covariance (ccf_fit.py:398-413) with an O(D)
    spectrum sum. Returns (None, None) — callers fall back to the dense
    'exact' path — if any slice is non-PD (a real covariance never is;
    degenerate test fixtures can be)."""
    import scipy.linalg

    n = stack.shape[0]
    logdets = np.empty(n)
    lams = np.empty(stack.shape[:2])
    try:
        for b in range(n):
            sign, ld = np.linalg.slogdet(stack[b])
            if sign != 1:
                raise np.linalg.LinAlgError(f'covariance slice {b} not PD')
            logdets[b] = ld
            lams[b] = scipy.linalg.eigh(stack[-1], stack[b],
                                        eigvals_only=True)
    except (np.linalg.LinAlgError, scipy.linalg.LinAlgError) as e:
        logging.getLogger('victor_tpu.tables').warning(
            'beta-covariance pencil factorization unavailable (%s): '
            "'factored' mode will fall back to the dense exact path", e)
        return None, None
    return logdets, lams


def _as_f64(x):
    return jnp.asarray(np.asarray(x, dtype=np.float64))


def _opt(x):
    return None if x is None else _as_f64(x)


# ---------------------------------------------------------------------------
# main builder
# ---------------------------------------------------------------------------

def _host_cpu_device():
    """The host CPU device, or None if the CPU backend is unavailable."""
    try:
        return jax.local_devices(backend='cpu')[0]
    except Exception:
        return None


def _transfer_needed(target) -> bool:
    """Whether the ambient default device is a non-CPU accelerator."""
    return (target or jax.devices()[0]).platform != 'cpu'


def host_build_then_transfer(builder):
    """Run builder() with the host CPU as the default device, then move the
    returned pytree to the ambient default device in ONE batched device_put.

    Building directly on an accelerator enqueues one small transfer per
    array (34 for a BOSS bundle); the batched form is one. Numerics are
    unchanged: dtype canonicalisation is identical on both paths, and the
    builders' math is host numpy/scipy either way. On a CPU-backend session
    this is a no-op, and nested calls (a joint bundle building its
    per-quantile bundles) compose: the inner call sees the host CPU as the
    ambient default device and skips its own transfer.
    """
    target = getattr(jax.config, 'jax_default_device', None)
    cpu = _host_cpu_device()
    if cpu is None or not _transfer_needed(target):
        return builder()
    with jax.default_device(cpu):
        out = builder()
    return jax.device_put(out, target or jax.devices()[0])


def build_tables(model: dict, data: Optional[dict] = None,
                 n_mu: int = 100, n_v: int = 50) -> CCFModelBundle:
    """Build CCFTables from reference-schema `model:` (and optional `data:`)
    dicts, on the host, shipped in one batched transfer
    (host_build_then_transfer)."""
    return host_build_then_transfer(
        lambda: _build_tables_host(model, data, n_mu=n_mu, n_v=n_v))


def _build_tables_host(model: dict, data: Optional[dict] = None,
                       n_mu: int = 100, n_v: int = 50) -> CCFModelBundle:
    """build_tables body; arrays land on the ambient default device."""

    # ---------------- cosmology / iaH (ccf_model.py:43-45) ----------------
    z_eff = model['z_eff']
    cosmo = BackgroundCosmology(model.get('cosmology'))
    iaH = (1 + z_eff) / (100 * cosmo.Ez(z_eff))

    base_dir = model.get('dir', '')
    input_fn = os.path.join(base_dir, model['input_model_data_file'])
    input_data = load_key_value_file(input_fn)

    # ---------------- real-space ccf (ccf_model.py:99-181) ----------------
    realspace = model['realspace_ccf']
    fmt = realspace.get('format', 'multipoles')
    fixed_real_input = not realspace.get('reconstruction', False)
    ccf_keys = list(np.atleast_1d(realspace['ccf_keys']))

    beta_grid = None
    if not fixed_real_input:
        beta_key = realspace.get('beta_key', None)
        if beta_key is None:
            raise InputError('Reconstruction specified for realspace ccf but no beta key provided')
        if beta_key not in input_data:
            raise InputError(f'Key {beta_key} not found in input model data file')
        beta_grid = np.asarray(input_data[beta_key], dtype=np.float64)
        if not np.all(np.diff(beta_grid) > 0):
            raise InputError('Realspace beta grid must be strictly monotonically increasing')

    bad_keys = (fmt == 'multipoles' and len(ccf_keys) < 2) or \
               (fmt == 'rmu' and len(ccf_keys) != 3)
    if bad_keys:
        raise InputError(f'Wrong number of ccf keys provided for ccf format {fmt}')
    for key in ccf_keys:
        if key not in input_data:
            raise InputError(f'Key {key} not found in input model data file')

    isim = realspace.get('simulation_number', None)

    if fmt == 'multipoles':
        r = np.asarray(input_data[ccf_keys[0]], dtype=np.float64)
        poles_r = tuple([0, 2, 4][:len(ccf_keys) - 1])
        real_mult = {}
        for i, ell in enumerate(poles_r):
            arr = select_simulation(np.asarray(input_data[ccf_keys[i + 1]]), isim)
            if fixed_real_input:
                if arr.shape != r.shape:
                    raise InputError(
                        f'Shape of real ccf multipole {ell} is {arr.shape}, expected {r.shape}')
            else:
                if arr.shape != (len(beta_grid), len(r)):
                    raise InputError(
                        f'Shape of real ccf multipole {ell} is {arr.shape}, '
                        f'expected ({len(beta_grid)}, {len(r)})')
            real_mult[ell] = np.asarray(arr, dtype=np.float64)
    elif fmt == 'rmu':
        r = np.asarray(input_data[ccf_keys[0]], dtype=np.float64)
        mu_in = np.asarray(input_data[ccf_keys[1]], dtype=np.float64)
        ccf = select_simulation(np.asarray(input_data[ccf_keys[2]]), isim)
        poles_r = (0, 2, 4)
        if fixed_real_input:
            if ccf.shape != (len(r), len(mu_in)):
                raise InputError(
                    f'Shape of real ccf is {ccf.shape}, expected ({len(r)}, {len(mu_in)})')
            m = _multipoles_from_rmu_grid(r, mu_in, ccf, poles_r)
            real_mult = {ell: m[f'{ell}'] for ell in poles_r}
        else:
            if ccf.shape != (len(beta_grid), len(r), len(mu_in)):
                raise InputError(
                    f'Shape of real ccf is {ccf.shape}, expected '
                    f'({len(beta_grid)}, {len(r)}, {len(mu_in)})')
            real_mult = {ell: np.zeros((len(beta_grid), len(r))) for ell in poles_r}
            for b in range(len(beta_grid)):
                m = _multipoles_from_rmu_grid(r, mu_in, ccf[b], poles_r)
                for ell in poles_r:
                    real_mult[ell][b] = m[f'{ell}']
    else:
        raise InputError(f"Unrecognised realspace ccf format '{fmt}'")

    stacked = np.stack([real_mult[ell] for ell in poles_r])   # (n_ell, [n_b,] n_r)
    if fixed_real_input:
        real_mult_fixed = stacked
        real_mult_pchip_c = None
    else:
        real_mult_fixed = None
        # PCHIP over beta, axis=1 of (n_ell, n_b, n_r) == axis 0 after moveaxis
        real_mult_pchip_c = ops.pchip_coeffs(beta_grid, np.moveaxis(stacked, 1, 0))

    # ---------------- matter ccf (ccf_model.py:183-220,328-383) ----------------
    matter = model['matter_ccf']
    matter_model = matter.get('model', 'linear_bias')
    realspace_from_data = realspace.get('from_data', False)
    template_sigma8 = matter.get('template_sigma8', None)
    if matter_model == 'linear_bias' and not realspace_from_data and not template_sigma8:
        raise InputError(
            'When using linear bias for the matter ccf and the real-space ccf is from a '
            'template, template_sigma8 must be provided')
    if matter_model == 'template' and not template_sigma8:
        raise InputError('When using template model for the matter ccf, template_sigma8 must be provided')

    # the r vector comes straight from the input file: validate it like the
    # beta grids are, before the spline-operator builders (which would raise
    # raw scipy errors, or silently produce garbage Hermite coefficients via
    # h=0, on a non-monotonic/duplicated grid)
    if r.ndim != 1 or len(r) < 4 or np.any(np.diff(r) <= 0) or r[0] <= 0.01 \
            or r[-1] <= 0.1:
        raise InputError('radial grid in the input model data file must be a '
                         'strictly increasing 1D vector with >= 4 points, all '
                         'above the r=0.01 velocity anchor and extending past '
                         f'r=0.1; got shape {r.shape}')
    r_v = np.concatenate([[0.01], r])
    rgrid100 = np.linspace(0.1, r.max(), 100)
    # velocity_terms re-splines NODAL values over r_v (ext=3) and evaluates
    # THAT on the fine grid (ref ccf_model.py:421-423,456-459) — a
    # spline-of-spline composition; linear in the nodal values, so it is one
    # more fixed operator, shared by the template and linear_bias branches
    respline_100 = ops.spline_eval_matrix(r_v, rgrid100, ext=3)

    delta_rv = Delta_rv = delta_r100 = Delta_r100 = None
    lb_delta_op = lb_Delta_op = lb_delta100_op = lb_Delta100_op = None

    if matter_model == 'template':
        template_keys = list(np.atleast_1d(matter.get('template_keys')))
        integrated = matter.get('integrated', False)
        if len(template_keys) != 2:
            raise InputError('Wrong number of matter ccf template keys provided: '
                             'expected 2 (radial distance and monopole)')
        for key in template_keys:
            if key not in input_data:
                raise InputError(f'Key {key} not found in input model data file')
        r_delta = np.asarray(input_data[template_keys[0]], dtype=np.float64)
        delta_in = np.asarray(input_data[template_keys[1]], dtype=np.float64)
        if len(r_delta) != len(delta_in):
            raise InputError(
                f'Shape of matter ccf template is {len(delta_in)}, expected {len(r_delta)}')
        from scipy.interpolate import InterpolatedUnivariateSpline as IUS
        from scipy.integrate import quad
        r50 = np.linspace(r_delta.min(), r_delta.max())    # 50-pt grid as reference
        if integrated:
            int_spl = IUS(r_delta, delta_in, k=3, ext=3)
            deriv = np.gradient(int_spl(r50), r50)
            delta_spl = IUS(r50, int_spl(r50) + r50 * deriv / 3.0, k=3, ext=3)
        else:
            delta_spl = IUS(r_delta, delta_in, k=3, ext=3)
            integral = np.array([
                quad(lambda x, ri=ri: 3 * delta_spl(x) * x ** 2 / ri ** 3,
                     0, ri, full_output=1)[0] for ri in r50])
            int_spl = IUS(r50, integral, k=3, ext=3)
        delta_rv, Delta_rv = delta_spl(r_v), int_spl(r_v)
        delta_r100, Delta_r100 = respline_100 @ delta_rv, respline_100 @ Delta_rv
    elif matter_model == 'linear_bias':
        lb_delta_op = ops.spline_eval_matrix(r, r_v, ext=3)
        lb_Delta_op = ops.enclosed_density_operator(r, r_v)
        lb_delta100_op = respline_100 @ lb_delta_op
        lb_Delta100_op = respline_100 @ lb_Delta_op
    elif matter_model == 'excursion_set':
        pass  # fixtures built below; profiles computed on device per call
    else:
        raise InputError(f'Invalid choice of matter_model {matter_model}')

    # ESM fixtures (victor/excursion_set_profile.py:61; set_ESM_params
    # ccf_model.py:494-536). P(k) comes from Eisenstein-Hu computed on device
    # (cosmology sampleable) or from a pregenerated CAMB table
    # (tools/make_camb_table.py) since CAMB cannot run on device.
    esm_k = esm_kw = esm_pk0 = esm_s80 = esm_s8z = esm_x50 = None
    esm_grid_axes = esm_pk_grid = esm_s80_grid = esm_s8z_grid = None
    esm_grid_names: tuple = ()
    esm_use_eh = True
    if matter_model == 'excursion_set':
        esm_opts = matter.get('excursion_set_options') or {}
        esm_k = np.logspace(-4, np.log10(2), 200)
        esm_kw = ops.trapz_weights(esm_k)
        esm_x50 = np.linspace(0.1, r.max(), 50)
        use_eh = esm_opts.get('use_eisenstein_hu', False)
        pk_table = esm_opts.get('pk_table_file')
        pk_grid = esm_opts.get('pk_grid_file')
        if not use_eh and pk_grid:
            # varying-cosmology CAMB mode: a grid of generator P(k) tables
            # over named cosmology axes, multilinearly interpolated on
            # device per likelihood call — the device-evaluable analogue of
            # the reference's per-cosmology-tuple CAMB rebuild
            # (excursion_set_profile.py:84-104). File format documented in
            # tools/make_camb_table.py --grid.
            esm_use_eh = False
            from scipy.interpolate import InterpolatedUnivariateSpline as IUS
            g = np.load(os.path.join(base_dir, pk_grid), allow_pickle=False)
            esm_grid_names = tuple(str(s) for s in np.atleast_1d(
                g['axis_names']))
            axes = [np.asarray(g[f'grid_{n}'], dtype=np.float64)
                    for n in esm_grid_names]
            for n, ax in zip(esm_grid_names, axes):
                if ax.ndim != 1 or (len(ax) > 1 and
                                    not np.all(np.diff(ax) > 0)):
                    raise InputError(f'pk_grid_file axis {n} must be a '
                                     'strictly increasing 1-D grid')
            shape = tuple(len(ax) for ax in axes)
            logpk = np.asarray(g['logpk0'], dtype=np.float64)
            if logpk.shape[:-1] != shape:
                raise InputError(
                    f'pk_grid_file logpk0 shape {logpk.shape} does not '
                    f'match the axis grids {shape} + (nk,)')
            kg = np.asarray(g['k'], dtype=np.float64)
            flat = logpk.reshape(-1, logpk.shape[-1])
            # cubic resample of log P(k) onto the framework k grid (same
            # ingestion convention as the single-table branch)
            esm_pk_grid = np.stack([IUS(kg, row, k=3)(esm_k)
                                    for row in flat])
            for key in ('sigma8_0', 'sigma8_z'):
                if np.asarray(g[key]).shape != shape:
                    raise InputError(f'pk_grid_file {key} shape must match '
                                     f'the axis grids {shape}')
            esm_s80_grid = np.asarray(g['sigma8_0'],
                                      dtype=np.float64).reshape(-1)
            esm_s8z_grid = np.asarray(g['sigma8_z'],
                                      dtype=np.float64).reshape(-1)
            esm_grid_axes = tuple(axes)
        elif not use_eh and pk_table:
            esm_use_eh = False
            tbl = np.load(os.path.join(base_dir, pk_table))
            from scipy.interpolate import InterpolatedUnivariateSpline as IUS
            esm_pk0 = IUS(tbl['k'], tbl['pk0'], k=3)(esm_k)
            esm_s80 = float(tbl['sigma8_0'])
            esm_s8z = float(tbl['sigma8_z'])
        elif not use_eh:
            from ..utils.logging import get_logger
            get_logger('io').warning(
                'excursion_set requested CAMB but no pk_table_file given; '
                'falling back to the Eisenstein-Hu approximation '
                '(mirrors reference fallback, excursion_set_profile.py:63-70)')

    # ---------------- velocity pdf (ccf_model.py:222-297) ----------------
    velocity = model['velocity_pdf']
    mean_model = velocity['mean'].get('model', 'linear')
    vr_template_rv = vr_template_100 = None
    template_fsigma8 = template_hubble_ratio = redshift_shift = None
    has_velocity_template = False
    if mean_model == 'template':
        template_fsigma8 = velocity['mean'].get('template_fsigma8')
        if not template_fsigma8:
            raise InputError('When using template model for the mean of the velocity pdf, '
                             'a value for template_fsigma8 must be provided')
        # explicit None checks (guarding YAML `null`), NOT `or`: z_sim = 0 is
        # a legitimate z=0 simulation snapshot (redshift_shift = 1/(1+z_eff),
        # ref ccf_model.py:231) and must not be coerced to z_eff
        z_sim = velocity['mean'].get('z_sim')
        z_sim = z_eff if z_sim is None else z_sim
        template_hubble_ratio = velocity['mean'].get('template_hubble_ratio')
        template_hubble_ratio = 1 if template_hubble_ratio is None \
            else template_hubble_ratio
        redshift_shift = (1 + z_sim) / (1 + z_eff)
        template_keys = list(np.atleast_1d(velocity['mean'].get('template_keys')))
        if len(template_keys) != 2:
            raise InputError(f'{len(template_keys)} velocity mean template keys provided, require 2')
        for key in template_keys:
            if key not in input_data:
                raise InputError(f'Key {key} not found in input model data file')
        r_for_v = np.asarray(input_data[template_keys[0]], dtype=np.float64)
        vr_in = np.asarray(input_data[template_keys[1]], dtype=np.float64)
        if len(r_for_v) != len(vr_in):
            raise InputError(f'Shape of mean velocity template is {len(vr_in)}, '
                             f'expected {len(r_for_v)}')
        from scipy.interpolate import InterpolatedUnivariateSpline as IUS
        v_spl = IUS(r_for_v, vr_in, k=3, ext=3)
        vr_template_rv, vr_template_100 = v_spl(r_v), v_spl(rgrid100)
        has_velocity_template = True
    if mean_model == 'nonlinear' and matter_model != 'excursion_set':
        raise InputError('Cannot have nonlinear mean velocity model unless using '
                         'excursion_set matter model')

    dispersion = velocity.get('dispersion', {})
    disp_model = dispersion.get('model', 'constant')
    if disp_model == 'template':
        template_keys = list(np.atleast_1d(dispersion.get('template_keys')))
        if len(template_keys) < 2 or len(template_keys) > 3:
            raise InputError(f'{len(template_keys)} velocity dispersion template keys '
                             'provided, require 2 or 3')
        for key in template_keys:
            if key not in input_data:
                raise InputError(f'Key {key} not found in input model data file')
        r_sv = np.asarray(input_data[template_keys[0]], dtype=np.float64)
        sv = np.asarray(input_data[template_keys[-1]], dtype=np.float64)
        # same hazard as the r grid above: an unsorted grid from the input
        # file feeds np.interp (silent garbage) and the Bicubic2D builder
        # (raw scipy error) — validate with a named error instead
        if r_sv.ndim != 1 or len(r_sv) < 2 or np.any(np.diff(r_sv) <= 0):
            raise InputError('dispersion template radial grid must be a '
                             'strictly increasing 1D vector')
        if len(template_keys) == 2:
            mu_sv = np.linspace(0, 1)
            sv = (np.ones((len(mu_sv), len(r_sv))) * sv).T
        else:
            mu_sv = np.asarray(input_data[template_keys[1]], dtype=np.float64)
            if mu_sv.ndim != 1 or len(mu_sv) < 2 \
                    or np.any(np.diff(mu_sv) <= 0):
                raise InputError('dispersion template mu grid must be a '
                                 'strictly increasing 1D vector')
        if sv.shape != (len(r_sv), len(mu_sv)):
            raise InputError(f'Dispersion template shape {sv.shape} does not match '
                             f'expected ({len(r_sv), len(mu_sv)})')
        if dispersion.get('filter', True):
            from scipy.signal import savgol_filter
            window = dispersion.get('filter_window', 3)
            polyorder = dispersion.get('filter_order', 1)
            sv = np.array([savgol_filter(sv[:, i], window, polyorder)
                           for i in range(sv.shape[1])]).T
    elif disp_model == 'constant':
        # reference intent (the 'constant' branch at ccf_model.py:284-287 is
        # dead code due to an unbound local; we implement the intent: unit
        # dispersion shape, so sigma_v alone sets the scale)
        r_sv = r.copy()
        mu_sv = np.linspace(0, 1)
        sv = np.ones((len(r_sv), len(mu_sv)))
    else:
        raise InputError(f"Bad choice '{disp_model}' for dispersion model, "
                         "options are 'constant' or 'template'")

    # normalise by the large-r limit of the monopole (ccf_model.py:294-297):
    # linear interp2d of sv(r, mu) evaluated at the r nodes reduces to linear
    # interpolation of each row over mu; monopole = trapz over 200 mu points.
    mu_fine = np.linspace(0.0, 1.0, 200)
    tw = ops.trapz_weights(mu_fine)
    rows = np.stack([np.interp(mu_fine, mu_sv, sv[i]) for i in range(len(r_sv))])
    sv_monopole = rows @ tw          # ell=0 factor (2l+1)=1
    sv_norm = sv / sv_monopole[-1]
    sv_surf = ops.Bicubic2D.build(r_sv, mu_sv, sv_norm)

    # ---------------- integration / projection fixtures ----------------
    x_nodes = np.linspace(-6.0, 6.0, n_v)
    vel_weights = ops.simpson_weights(n_v, dx=x_nodes[1] - x_nodes[0])
    mu_ap = np.linspace(1e-10, 1.0)
    mu_ap_w = ops.trapz_weights(mu_ap)
    mu_grid = np.linspace(0.0, 1.0, n_mu)

    # ---------------- data block (ccf_fit.py:44-164) ----------------
    s = beta_ccf = data_mult_fixed = data_mult_pchip_c = None
    beta_cov = cov = icov = cov_logdet = cov_pencil = None
    poles_s = poles_r
    fixed_data = True
    fixed_covmat = True
    fit_opts = None

    if data is not None:
        data_dir = data.get('dir', '')
        if data.get('redshift_space_ccf', {}).get('data_file') is None:
            raise InputError('data block must provide redshift_space_ccf.data_file')
        data_fn = os.path.join(data_dir, data['redshift_space_ccf']['data_file'])
        # the covariance block is optional: multi-quantile joint fits supply
        # one joint cross-covariance at the JointBundle level instead
        # (victor_tpu/likelihood/multiquantile.py)
        has_cov = 'covariance_matrix' in data and data['covariance_matrix']
        if has_cov and data['covariance_matrix'].get('data_file') is None:
            raise InputError('covariance_matrix block must provide data_file')
        cov_fn = os.path.join(data_dir, data['covariance_matrix']['data_file']) \
            if has_cov else None
        for fn in ([data_fn, cov_fn] if has_cov else [data_fn]):
            if not os.path.isfile(fn):
                raise InputError(f'Data file {fn} not found')
        ccf = data['redshift_space_ccf']
        ddict = load_key_value_file(data_fn)
        isim_d = ccf.get('simulation_number', None)
        fixed_data = not ccf.get('reconstruction', False)
        if not fixed_data:
            beta_key = ccf.get('beta_key', None)
            if beta_key and beta_key in ddict:
                beta_ccf = np.asarray(ddict[beta_key], dtype=np.float64)
                if not np.all(np.diff(beta_ccf) > 0):
                    raise InputError('Redshift-space beta grid must be strictly '
                                     'monotonically increasing')
            else:
                if fixed_real_input:
                    raise InputError('Reconstruction beta information required for '
                                     'redshift-space ccf but not found')
                beta_ccf = beta_grid.copy()
        dfmt = ccf.get('format', 'multipoles')
        dkeys = list(np.atleast_1d(ccf['ccf_keys']))
        bad = (dfmt == 'multipoles' and len(dkeys) < 2) or (dfmt == 'rmu' and len(dkeys) != 3)
        if bad:
            raise InputError(f'Wrong number of redshift-space ccf keys provided for format {dfmt}')
        for key in dkeys:
            if key not in ddict:
                raise InputError(f'Key {key} not found in file {data_fn}')
        if dfmt != 'multipoles':
            raise InputError('Currently only multipole format is supported for '
                             'redshift-space ccf data and covmat')
        s = np.asarray(ddict[dkeys[0]], dtype=np.float64)
        poles_s = tuple([0, 2, 4][:len(dkeys) - 1])
        dm = {}
        for i, ell in enumerate(poles_s):
            arr = select_simulation(np.asarray(ddict[dkeys[i + 1]]), isim_d)
            if fixed_data:
                if arr.shape != s.shape:
                    raise InputError(f'Shape of redshift ccf multipole {ell} is '
                                     f'{arr.shape}, expected {s.shape}')
            else:
                if arr.shape != (len(beta_ccf), len(s)):
                    raise InputError(f'Shape of redshift ccf multipole {ell} is '
                                     f'{arr.shape}, expected ({len(beta_ccf)}, {len(s)})')
            dm[ell] = np.asarray(arr, dtype=np.float64)
        dstack = np.stack([dm[ell] for ell in poles_s])
        if fixed_data:
            data_mult_fixed = dstack
        else:
            data_mult_pchip_c = ops.pchip_coeffs(beta_ccf, np.moveaxis(dstack, 1, 0))

        # covariance (ccf_fit.py:116-164)
        if has_cov:
            covariance = data['covariance_matrix']
            cdict = load_key_value_file(cov_fn)
            if not fixed_data:
                fixed_covmat = covariance.get('fixed_beta', True)
                if not fixed_covmat:
                    beta_key = covariance.get('beta_key', None)
                    if beta_key and beta_key in cdict:
                        beta_cov = np.asarray(cdict[beta_key], dtype=np.float64)
                        if not np.all(np.diff(beta_cov) > 0):
                            raise InputError('Covariance beta grid must be strictly '
                                             'monotonically increasing')
                    else:
                        beta_cov = beta_ccf.copy()
            else:
                fixed_covmat = True
            cov_key = covariance['cov_key']
            if cov_key not in cdict:
                raise InputError(f'Key {cov_key} not found in file {cov_fn}')
            cov = np.asarray(cdict[cov_key], dtype=np.float64)
            D = len(s) * len(poles_s)
            if fixed_covmat:
                if cov.shape != (D, D):
                    raise InputError('Unexpected shape of (fixed) covariance matrix')
            else:
                if cov.shape != (len(beta_cov), D, D):
                    raise InputError('Unexpected shape of (beta-varying) covariance matrix')
            icov = np.linalg.inv(cov)
            if not fixed_covmat:
                cov_logdet, cov_pencil = _pencil_precompute(cov)
        fit_opts = fit_options_from_config(data)

    # projection matrix over the theory mu grid for the data-side multipoles
    proj = ops.multipole_projection_matrix(mu_grid, list(poles_s), npts=200, even=True)

    tables = CCFTables(
        iaH=_as_f64(iaH),
        template_sigma8=_opt(template_sigma8),
        bias_default=_as_f64(matter.get('bias', 1.9)),
        r=_as_f64(r),
        beta_grid=_opt(beta_grid),
        real_mult_fixed=_opt(real_mult_fixed),
        real_mult_pchip_c=_opt(real_mult_pchip_c),
        spline_mult=ops.Spline1D.build(r, clamp=True),
        r_v=_as_f64(r_v),
        spline_vel=ops.Spline1D.build(r_v, clamp=True),
        rgrid100=_as_f64(rgrid100),
        dvr_op=_as_f64(ops.resampled_gradient_operator(rgrid100, r_v)),
        delta_rv=_opt(delta_rv), Delta_rv=_opt(Delta_rv),
        delta_r100=_opt(delta_r100), Delta_r100=_opt(Delta_r100),
        lb_delta_op=_opt(lb_delta_op), lb_Delta_op=_opt(lb_Delta_op),
        lb_delta100_op=_opt(lb_delta100_op), lb_Delta100_op=_opt(lb_Delta100_op),
        vr_template_rv=_opt(vr_template_rv), vr_template_100=_opt(vr_template_100),
        template_fsigma8=_opt(template_fsigma8),
        template_hubble_ratio=_opt(template_hubble_ratio),
        redshift_shift=_opt(redshift_shift),
        sv_surf=sv_surf,
        z_eff=_as_f64(z_eff),
        esm_k=_opt(esm_k), esm_kw=_opt(esm_kw), esm_pk0=_opt(esm_pk0),
        esm_s80=_opt(esm_s80), esm_s8z=_opt(esm_s8z), esm_x50=_opt(esm_x50),
        x_nodes=_as_f64(x_nodes), vel_weights=_as_f64(vel_weights),
        mu_ap=_as_f64(mu_ap), mu_ap_w=_as_f64(mu_ap_w),
        proj=_as_f64(proj), mu_grid=_as_f64(mu_grid),
        s=_opt(s), beta_ccf=_opt(beta_ccf),
        data_mult_fixed=_opt(data_mult_fixed),
        data_mult_pchip_c=_opt(data_mult_pchip_c),
        beta_cov=_opt(beta_cov), cov=_opt(cov), icov=_opt(icov),
        cov_logdet=_opt(cov_logdet), cov_pencil=_opt(cov_pencil),
        esm_grid_axes=(None if esm_grid_axes is None
                       else tuple(_as_f64(a) for a in esm_grid_axes)),
        esm_pk_grid=_opt(esm_pk_grid),
        esm_s80_grid=_opt(esm_s80_grid), esm_s8z_grid=_opt(esm_s8z_grid),
    )

    spec = TableSpec(
        poles_r=poles_r, poles_s=poles_s,
        fixed_real_input=fixed_real_input, fixed_data=fixed_data,
        fixed_covmat=fixed_covmat,
        has_velocity_template=has_velocity_template,
        has_matter_template=matter_model == 'template',
        esm_use_eh=esm_use_eh,
        esm_grid_names=esm_grid_names,
        n_s=len(s) if s is not None else len(r),
        n_mu=n_mu, n_v=n_v,
    )

    theory_opts = theory_options_from_config(model)
    return CCFModelBundle(tables=tables, spec=spec, theory_opts=theory_opts,
                          fit_opts=fit_opts)
