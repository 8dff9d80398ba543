"""Option-matrix parity vs the (shimmed) reference for the loader/model paths
not covered by the BOSS golden fixtures: linear-bias matter model,
realspace-from-data mode, (r,mu)-format input, velocity-mean templates, the
shipped toy example config, simulation_number selection, and .npy inputs.
"""

import copy
import os
import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'tools'))
import refshim  # noqa: E402

refshim.install()

from victor_tpu.io import build_tables  # noqa: E402
from victor_tpu.likelihood import core as lk  # noqa: E402
from victor_tpu.models import ccf_theory as th  # noqa: E402

PARAMS = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def ref_loglike(model, data, params):
    from victor.ccf_fit import CCFFit
    fit = CCFFit(copy.deepcopy(model), copy.deepcopy(data))
    return fit.log_likelihood(dict(params))


def our_loglike(model, data, params):
    b = build_tables(copy.deepcopy(model), copy.deepcopy(data))
    lnl, chi2 = lk.log_likelihood(b.tables, b.spec, b.theory_opts, b.fit_opts,
                                  jp(params))
    return float(lnl), float(chi2)


class TestMatterAndAPModes:
    def test_linear_bias(self, boss_config):
        cfg = copy.deepcopy(boss_config)
        cfg['model']['matter_ccf'] = {'model': 'linear_bias', 'bias': 1.9,
                                      'template_sigma8': 0.628}
        p = {**PARAMS, 'bias': 1.9}
        ref = ref_loglike(cfg['model'], cfg['data'], p)
        got = our_loglike(cfg['model'], cfg['data'], p)
        np.testing.assert_allclose(got, ref, rtol=1e-8)

    def test_realspace_from_data(self, boss_config):
        cfg = copy.deepcopy(boss_config)
        cfg['model']['realspace_ccf']['from_data'] = True
        cfg['model']['matter_ccf'] = {'model': 'linear_bias', 'bias': 1.9}
        p = {**PARAMS, 'bias': 1.9, 'epsilon': 1.03}
        ref = ref_loglike(cfg['model'], cfg['data'], p)
        got = our_loglike(cfg['model'], cfg['data'], p)
        np.testing.assert_allclose(got, ref, rtol=1e-8)


class TestInputFormats:
    def test_rmu_format(self, boss_config, tmp_path):
        """(r, mu)-grid real-space input converted to multipoles on load
        (victor/ccf_model.py:169-181)."""
        src = os.path.join(REPO, boss_config['model']['input_model_data_file'])
        with h5py.File(src) as f:
            r = f['r'][:]
            mono = f['monopole'][:]   # (31, 30) beta grid
            quad = f['quadrupole'][:]
            payload = {k: f[k][:] for k in f}
        mu = np.linspace(0.0, 1.0, 64)
        p2 = 1.5 * mu ** 2 - 0.5
        # fixed input: use the central beta row
        ccf_rmu = mono[15][:, None] + quad[15][:, None] * p2[None, :]
        fn = tmp_path / 'rmu_model.hdf5'
        with h5py.File(fn, 'w') as f:
            for k, v in payload.items():
                if k not in ('monopole', 'quadrupole', 'beta'):
                    f.create_dataset(k, data=v)
            f.create_dataset('mu', data=mu)
            f.create_dataset('xi_rmu', data=ccf_rmu)
        cfg = copy.deepcopy(boss_config)
        cfg['model']['input_model_data_file'] = str(fn)
        cfg['model']['dir'] = ''
        cfg['model']['realspace_ccf'] = {
            'reconstruction': False, 'format': 'rmu',
            'ccf_keys': ['r', 'mu', 'xi_rmu'], 'assume_isotropic': True}
        # fixed real input -> the data block must name its own beta grid
        cfg['data']['redshift_space_ccf']['beta_key'] = 'beta'
        p = {'fsigma8': 0.47, 'sigma_v': 380.0, 'epsilon': 1.0, 'beta': 0.37}
        ref = ref_loglike(cfg['model'], cfg['data'], p)
        got = our_loglike(cfg['model'], cfg['data'], p)
        np.testing.assert_allclose(got, ref, rtol=1e-8)

    def test_npy_input(self, boss_config, tmp_path):
        src = os.path.join(REPO, boss_config['model']['input_model_data_file'])
        with h5py.File(src) as f:
            payload = {k: f[k][:] for k in f}
        fn = tmp_path / 'model.npy'
        np.save(fn, payload)
        cfg = copy.deepcopy(boss_config)
        cfg['model']['input_model_data_file'] = str(fn)
        cfg['model']['dir'] = ''
        got = our_loglike(cfg['model'], cfg['data'], PARAMS)
        base = our_loglike({**copy.deepcopy(boss_config['model'])},
                           boss_config['data'], PARAMS)
        np.testing.assert_allclose(got, base, rtol=1e-12)

    def test_simulation_number(self, boss_config, tmp_path):
        src = os.path.join(REPO, boss_config['model']['input_model_data_file'])
        with h5py.File(src) as f:
            payload = {k: f[k][:] for k in f}
        rng = np.random.default_rng(0)
        stacked = {k: payload[k] for k in payload}
        # fixed input: stack 3 mock monopoles, mock 1 is the beta-15 row
        mono = np.stack([payload['monopole'][15] + rng.normal(0, 1e-3, 30),
                         payload['monopole'][15],
                         payload['monopole'][15] - rng.normal(0, 1e-3, 30)])
        quad = np.stack([payload['quadrupole'][15]] * 3)
        fn = tmp_path / 'mocks.hdf5'
        with h5py.File(fn, 'w') as f:
            for k, v in stacked.items():
                if k not in ('monopole', 'quadrupole', 'beta'):
                    f.create_dataset(k, data=v)
            f.create_dataset('monopole', data=mono)
            f.create_dataset('quadrupole', data=quad)
        cfg = copy.deepcopy(boss_config)
        cfg['model']['input_model_data_file'] = str(fn)
        cfg['model']['dir'] = ''
        cfg['model']['realspace_ccf'] = {
            'reconstruction': False, 'format': 'multipoles',
            'ccf_keys': ['r', 'monopole', 'quadrupole'],
            'simulation_number': 1, 'assume_isotropic': True}
        b = build_tables(cfg['model'], None)
        np.testing.assert_array_equal(np.asarray(b.tables.real_mult_fixed[0]),
                                      mono[1])


class TestVelocityTemplate:
    def _template_cfg(self, boss_config, tmp_path, z_sim):
        src = os.path.join(REPO, boss_config['model']['input_model_data_file'])
        with h5py.File(src) as f:
            payload = {k: f[k][:] for k in f}
        r = payload['r']
        vr = -120.0 * (r / 30.0) * np.exp(-r / 35.0)   # smooth outflow profile
        fn = tmp_path / 'vel_model.hdf5'
        with h5py.File(fn, 'w') as f:
            for k, v in payload.items():
                f.create_dataset(k, data=v)
            f.create_dataset('rv', data=r)
            f.create_dataset('vr', data=vr)
        cfg = copy.deepcopy(boss_config)
        cfg['model']['input_model_data_file'] = str(fn)
        cfg['model']['dir'] = ''
        cfg['model']['velocity_pdf']['mean'] = {
            'model': 'template', 'template_fsigma8': 0.45, 'z_sim': z_sim,
            'template_hubble_ratio': 1.02, 'template_keys': ['rv', 'vr']}
        return cfg

    def test_template_mean_model(self, boss_config, tmp_path):
        """velocity_pdf.mean.model='template' with fsigma8/H/z rescaling
        (victor/ccf_model.py:439-443,483-490)."""
        cfg = self._template_cfg(boss_config, tmp_path, z_sim=0.52)
        ref = ref_loglike(cfg['model'], cfg['data'], PARAMS)
        got = our_loglike(cfg['model'], cfg['data'], PARAMS)
        np.testing.assert_allclose(got, ref, rtol=1e-8)

    def test_template_mean_model_z_sim_zero(self, boss_config, tmp_path):
        """z_sim=0 (a z=0 snapshot) is a legitimate falsy config value: the
        redshift rescale must be 1/(1+z_eff), not silently coerced to z_eff
        (ref ccf_model.py:231 uses plain .get with no falsy coercion)."""
        cfg = self._template_cfg(boss_config, tmp_path, z_sim=0)
        ref = ref_loglike(cfg['model'], cfg['data'], PARAMS)
        got = our_loglike(cfg['model'], cfg['data'], PARAMS)
        np.testing.assert_allclose(got, ref, rtol=1e-8)
        # and z_sim=0 really differs from the z_eff default
        cfg2 = self._template_cfg(boss_config, tmp_path, z_sim=None)
        cfg2['model']['velocity_pdf']['mean'].pop('z_sim')
        got_default = our_loglike(cfg2['model'], cfg2['data'], PARAMS)
        assert abs(np.asarray(got_default)[0] - np.asarray(got)[0]) > 1e-6


class TestEmpiricalCorrDerivative:
    def test_empirical_corr_dvr_respline(self, boss_config):
        """The empirical-correction derivative grid must evaluate the
        RE-SPLINE of the nodal delta/Delta values over r_v (ref
        ccf_model.py:421-423,456-459), not the source template spline
        directly — the BOSS rdelta grid (55 pts) differs from r_v (31 pts),
        and the direct evaluation diverges from the reference by ~3.6% in
        dvr. Streaming goldens never consume dvr, so this path needs its own
        pin (dispersion-exact e2e + node-level dvr)."""
        import dataclasses
        from victor.ccf_model import CCFModel as RefModel
        cfg = copy.deepcopy(boss_config)
        cfg['model']['velocity_pdf']['mean']['empirical_corr'] = True
        cfg['model']['rsd_model'] = 'dispersion'
        p = {**PARAMS, 'Av': 0.5}
        ref_model = RefModel(copy.deepcopy(cfg['model']))
        rv = np.append([0.01], ref_model.r)
        ref_vr, ref_dvr = ref_model.velocity_terms(rv, dict(p))
        b = build_tables(copy.deepcopy(cfg['model']), copy.deepcopy(cfg['data']))
        assert b.theory_opts.empirical_corr
        vr, dvr = th.velocity_terms(b.tables, b.spec, b.theory_opts, jp(p))
        np.testing.assert_allclose(np.asarray(vr), ref_vr, rtol=1e-10)
        np.testing.assert_allclose(np.asarray(dvr), ref_dvr, rtol=1e-10)
        # and end-to-end through the dvr-consuming dispersion jacobian
        opts = dataclasses.replace(b.theory_opts, dispersion_interior='exact')
        got = lk.log_likelihood(b.tables, b.spec, opts, b.fit_opts, jp(p))
        ref = ref_loglike(cfg['model'], cfg['data'], p)
        np.testing.assert_allclose((float(got[0]), float(got[1])), ref,
                                   rtol=1e-9)


class TestToyExample:
    def test_example_void_model(self):
        """The shipped fixed-input monopole-only toy config
        (reference config/example_model_input.yaml)."""
        from victor.ccf_model import CCFModel
        model = {
            'input_model_data_file': 'data/example_data/example_void_model.hdf5',
            'dir': REPO, 'rsd_model': 'streaming', 'z_eff': 0.50,
            'cosmology': {'Omega_m': 0.31},
            'realspace_ccf': {'reconstruction': False, 'format': 'multipoles',
                              'ccf_keys': ['r', 'monopole']},
            'matter_ccf': {'model': 'template', 'integrated': False,
                           'template_keys': ['rdelta', 'delta'],
                           'template_sigma8': 0.628, 'bias': 1.9},
            'velocity_pdf': {'mean': {'model': 'linear'},
                             'dispersion': {'model': 'template',
                                            'template_keys': ['rsv', 'sigmav']}},
        }
        ref_model = CCFModel(copy.deepcopy(model))
        b = build_tables(copy.deepcopy(model), None)
        p = {'fsigma8': 0.47, 'sigma_v': 380.0, 'epsilon': 1.0}
        s = np.asarray(b.tables.r)
        ref_mult = ref_model.theory_multipoles(s, dict(p), poles=[0, 2])
        xi = th.theory_xi_grid(b.tables, b.spec, b.theory_opts, jp(p), s=jnp.asarray(s))
        import victor_tpu.ops as ops
        proj = ops.multipole_projection_matrix(
            np.asarray(b.tables.mu_grid), [0, 2], npts=200, even=True)
        ours = proj @ np.asarray(xi)
        np.testing.assert_allclose(ours[0], ref_mult['0'], atol=1e-9)
        np.testing.assert_allclose(ours[1], ref_mult['2'], atol=1e-9)


class TestRemainingOptions:
    def test_constant_dispersion_model(self, boss_config):
        """dispersion.model='constant' — dead code in the reference (unbound
        local, victor/ccf_model.py:284-297, SURVEY bug 1); implemented as
        intended: unit dispersion shape so sigma_v sets the scale."""
        cfg = copy.deepcopy(boss_config)
        cfg['model']['velocity_pdf']['dispersion'] = {'model': 'constant'}
        b = build_tables(cfg['model'], cfg['data'])
        lnl, chi2 = lk.log_likelihood(b.tables, b.spec, b.theory_opts,
                                      b.fit_opts, jp(PARAMS))
        assert np.isfinite(float(lnl))
        # constant surface: sv == 1 everywhere
        sv = b.tables.sv_surf.ev(jnp.asarray([10.0, 50.0]), jnp.asarray([0.1, 0.9]))
        np.testing.assert_allclose(np.asarray(sv), 1.0, atol=1e-12)

    def test_md_covariance_variant(self, boss_config):
        """The 15-point MD beta-grid covariance file parity vs reference."""
        cfg = copy.deepcopy(boss_config)
        cfg['data']['covariance_matrix']['data_file'] = \
            'data/BOSS_DR12_CMASS_data/' \
            'CMASS_zobovVoids_reconRs10_0.43z0.7_medianRvcut_variable_isotropic_MD_covariance.hdf5'
        ref = ref_loglike(cfg['model'], cfg['data'], PARAMS)
        got = our_loglike(cfg['model'], cfg['data'], PARAMS)
        np.testing.assert_allclose(got, ref, rtol=1e-8)

    def test_fixed_covariance_variant(self, boss_config):
        """fixed_beta covariance (no log-det term, ccf_fit.py:445-453)."""
        cfg = copy.deepcopy(boss_config)
        cfg['data']['covariance_matrix'] = {
            'data_file': 'data/BOSS_DR12_CMASS_data/'
                         'CMASS_zobovVoids_reconRs10_0.43z0.7_medianRvcut_fixed_D_covariance.hdf5',
            'cov_key': 'covmat', 'fixed_beta': True}
        ref = ref_loglike(cfg['model'], cfg['data'], PARAMS)
        got = our_loglike(cfg['model'], cfg['data'], PARAMS)
        np.testing.assert_allclose(got, ref, rtol=1e-8)

    def test_anisotropic_dispersion_template(self, boss_config, tmp_path):
        """3-key sigma_v(r, mu) dispersion template (victor/ccf_model.py:
        252-283) including savgol filtering and monopole normalisation."""
        src = os.path.join(REPO, boss_config['model']['input_model_data_file'])
        with h5py.File(src) as f:
            payload = {k: f[k][:] for k in f}
        r_sv = payload['rsv']
        mu_sv = np.linspace(0.0, 1.0, 21)
        # mu-dependent surface built off the isotropic template
        sv2d = payload['sigmav'][:, None] * (1.0 + 0.25 * mu_sv[None, :] ** 2)
        fn = tmp_path / 'aniso_model.hdf5'
        with h5py.File(fn, 'w') as f:
            for k, v in payload.items():
                f.create_dataset(k, data=v)
            f.create_dataset('musv', data=mu_sv)
            f.create_dataset('sigmav2d', data=sv2d)
        cfg = copy.deepcopy(boss_config)
        cfg['model']['input_model_data_file'] = str(fn)
        cfg['model']['dir'] = ''
        cfg['model']['velocity_pdf']['dispersion'] = {
            'model': 'template', 'template_keys': ['rsv', 'musv', 'sigmav2d']}
        ref = ref_loglike(cfg['model'], cfg['data'], PARAMS)
        got = our_loglike(cfg['model'], cfg['data'], PARAMS)
        np.testing.assert_allclose(got, ref, rtol=1e-7)

    def test_streaming_fast_on_anisotropic_template_warns_and_runs_exact(
            self, boss_config, tmp_path):
        """streaming_eval='fast' requires a mu-independent sigma_v surface;
        on an anisotropic template it must fall back to the exact bicubic
        AND say so (a silent fallback would let a user believe they
        measured/validated the fast mode — models/ccf_theory.py)."""
        import logging
        src = os.path.join(REPO, boss_config['model']['input_model_data_file'])
        with h5py.File(src) as f:
            payload = {k: f[k][:] for k in f}
        mu_sv = np.linspace(0.0, 1.0, 21)
        sv2d = payload['sigmav'][:, None] * (1.0 + 0.25 * mu_sv[None, :] ** 2)
        fn = tmp_path / 'aniso_model.hdf5'
        with h5py.File(fn, 'w') as f:
            for k, v in payload.items():
                f.create_dataset(k, data=v)
            f.create_dataset('musv', data=mu_sv)
            f.create_dataset('sigmav2d', data=sv2d)
        cfg = copy.deepcopy(boss_config)
        cfg['model']['input_model_data_file'] = str(fn)
        cfg['model']['dir'] = ''
        cfg['model']['velocity_pdf']['dispersion'] = {
            'model': 'template', 'template_keys': ['rsv', 'musv', 'sigmav2d']}
        exact = our_loglike(cfg['model'], cfg['data'], PARAMS)
        cfg['model']['streaming_eval'] = 'fast'
        # the victor_tpu root logger has propagate=False, so capture with an
        # explicit handler rather than caplog's root-based capture
        records = []

        class _Grab(logging.Handler):
            def emit(self, record):
                records.append(record)

        h = _Grab(level=logging.WARNING)
        logging.getLogger('victor_tpu.theory').addHandler(h)
        try:
            fast = our_loglike(cfg['model'], cfg['data'], PARAMS)
        finally:
            logging.getLogger('victor_tpu.theory').removeHandler(h)
        assert any('fast' in r.getMessage() and 'mu-dependent' in r.getMessage()
                   for r in records)
        np.testing.assert_allclose(fast, exact, rtol=1e-12)

    def test_hexadecapole_three_multipole_fit(self, boss_config, tmp_path):
        """ell=0,2,4 stacking: 90-dim data vector + (3x30)^2 covariance."""
        rng = np.random.default_rng(7)
        # model file: add a (31, 30) hexadecapole (small, smooth)
        src_m = os.path.join(REPO, boss_config['model']['input_model_data_file'])
        with h5py.File(src_m) as f:
            mpay = {k: f[k][:] for k in f}
        r = mpay['r']
        hexa_m = 0.02 * np.exp(-r / 50.0)[None, :] * np.ones((31, 1))
        fm = tmp_path / 'model3.hdf5'
        with h5py.File(fm, 'w') as f:
            for k, v in mpay.items():
                f.create_dataset(k, data=v)
            f.create_dataset('hexadecapole', data=hexa_m)
        # data file: add hexadecapole + build a fixed 90x90 covariance
        src_d = os.path.join(REPO, boss_config['data']['redshift_space_ccf']['data_file'])
        with h5py.File(src_d) as f:
            dpay = {k: f[k][:] for k in f}
        hexa_d = 0.02 * np.exp(-dpay['s'] / 50.0)[None, :] * np.ones((31, 1)) \
            + rng.normal(0, 1e-3, (31, 30))
        fd = tmp_path / 'data3.hdf5'
        with h5py.File(fd, 'w') as f:
            for k, v in dpay.items():
                f.create_dataset(k, data=v)
            f.create_dataset('hexadecapole', data=hexa_d)
        A = rng.normal(0, 1e-2, (90, 120))
        cov90 = A @ A.T + np.eye(90) * 1e-4
        fc = tmp_path / 'cov3.hdf5'
        with h5py.File(fc, 'w') as f:
            f.create_dataset('covmat', data=cov90)
        cfg = copy.deepcopy(boss_config)
        cfg['model']['input_model_data_file'] = str(fm)
        cfg['model']['dir'] = ''
        cfg['model']['realspace_ccf']['ccf_keys'] = \
            ['r', 'monopole', 'quadrupole', 'hexadecapole']
        cfg['data']['redshift_space_ccf']['data_file'] = str(fd)
        cfg['data']['redshift_space_ccf']['ccf_keys'] = \
            ['s', 'monopole', 'quadrupole', 'hexadecapole']
        cfg['data']['covariance_matrix'] = {'data_file': str(fc),
                                            'cov_key': 'covmat',
                                            'fixed_beta': True}
        cfg['data']['dir'] = ''
        p = {**PARAMS, 'assume_isotropic': False}
        del p['assume_isotropic']
        cfg['model']['realspace_ccf']['assume_isotropic'] = False
        ref = ref_loglike(cfg['model'], cfg['data'], PARAMS)
        got = our_loglike(cfg['model'], cfg['data'], PARAMS)
        np.testing.assert_allclose(got, ref, rtol=1e-7)


class TestOptionValidation:
    def test_perf_mode_typos_raise(self):
        """The perf-mode strings select silently-diverging code paths in
        ccf_theory.py (an unrecognised value would fall through to the
        exact branch), so a typo must raise at options-construction time —
        both from YAML (theory_options_from_config) and from the per-call
        kwarg-override path (TheoryOptions.replace)."""
        import pytest as _pytest
        from victor_tpu.config import TheoryOptions, theory_options_from_config
        for bad in (dict(dispersion_final='Fast'),
                    dict(streaming_eval='chebyshev'),
                    dict(dispersion_interior='cheby')):
            with _pytest.raises(ValueError, match='must be one of'):
                TheoryOptions(**bad)
            with _pytest.raises(ValueError, match='must be one of'):
                TheoryOptions().replace(**bad)
            with _pytest.raises(ValueError, match='must be one of'):
                theory_options_from_config(dict(bad))
        # valid values still construct
        assert TheoryOptions(dispersion_final='exact',
                             streaming_eval='fast').streaming_eval == 'fast'


def test_hamaus_fig5_reproduction():
    """The Hamaus et al. (2020) Fig. 5 reproduction (reference
    model_options_demo.ipynb cells 22-24): the three approximate-Kaiser
    variants at the paper's reported best fit {beta .347, eps 1.0058,
    M 1.138, Q 1.22} with matter_model=linear_bias on the example void
    model, float-parity with the reference code on ell=0,2,4, and the
    discriminating quadrupole signs at s = 0.5 R_v (only the coord-shift-
    free variant is positive — the notebook's published conclusion).

    Reproduction note: the reference's stored notebook output predates its
    current code, under which the beta-only call raises KeyError('fsigma8')
    (victor/ccf_model.py:432); passing fsigma8 = beta*bias*template_sigma8
    makes the growth term exactly beta*b — the published parameterisation —
    and is what both codes receive here."""
    import yaml

    from victor.ccf_model import CCFModel as RefModel

    from victor_tpu import CCFModel

    with open(os.path.join(REPO, 'configs',
                           'example_model_input.yaml')) as f:
        model = yaml.safe_load(f)['model']
    model['dir'] = REPO
    model['matter_ccf']['model'] = 'linear_bias'
    bias = model['matter_ccf']['bias']
    s8t = model['matter_ccf']['template_sigma8']
    hamaus = {'beta': 0.347, 'epsilon': 1.0058, 'M': 1.138, 'Q': 1.22,
              'fsigma8': 0.347 * bias * s8t}
    variants = {
        'full': {},
        'approx': {'kaiser_approximation': True},
        'approx_nocoord': {'kaiser_approximation': True,
                           'kaiser_coord_shift': False},
    }
    s = np.linspace(0.01, 3, 50)
    ours = CCFModel(copy.deepcopy(model))
    ref = RefModel(copy.deepcopy(model))
    q05 = {}
    for name, opts in variants.items():
        m_ours = ours.theory_multipoles(s, dict(hamaus), poles=(0, 2, 4),
                                        rsd_model='kaiser', **opts)
        m_ref = ref.theory_multipoles(s, dict(hamaus), poles=[0, 2, 4],
                                      rsd_model='kaiser', **opts)
        for ell in ('0', '2', '4'):
            np.testing.assert_allclose(
                np.asarray(m_ours[ell]), np.asarray(m_ref[ell]),
                atol=1e-12, err_msg=f'{name} ell={ell}')
        q05[name] = float(np.interp(0.5, s, np.asarray(m_ours['2'])))
    # the Fig. 5 discriminator: quadrupole sign at 0.5 R_v
    assert q05['full'] < 0 and q05['approx'] < 0 and q05['approx_nocoord'] > 0
    np.testing.assert_allclose(q05['full'], -0.0259, atol=5e-4)
    np.testing.assert_allclose(q05['approx'], -0.0091, atol=5e-4)
    np.testing.assert_allclose(q05['approx_nocoord'], 0.0392, atol=5e-4)
