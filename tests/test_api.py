"""Facade API (CCFModel/CCFFit), plottools, converters, and CLI tests."""

import json
import os

import numpy as np
import pytest

import matplotlib
matplotlib.use('Agg')

from victor_tpu import CCFFit, CCFModel  # noqa: E402
from victor_tpu.errors import InputError  # noqa: E402

GOLDEN_PARAMS = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}


@pytest.fixture(scope='module')
def fit(boss_config):
    return CCFFit(boss_config['model'], boss_config['data'])


class TestCCFFitFacade:
    def test_log_likelihood_golden(self, fit):
        lnl, chi2 = fit.log_likelihood(GOLDEN_PARAMS)
        assert abs(chi2 - 65.01) < 0.01
        assert abs(lnl - 284.76) < 0.01

    def test_chi_squared_returns_cov(self, fit):
        chi2, cov = fit.chi_squared(GOLDEN_PARAMS)
        assert isinstance(chi2, float)
        assert cov.shape == (60, 60)

    def test_option_overrides(self, fit, ref_fixtures):
        names = [str(x) for x in ref_fixtures['golden_names']]
        i = names.index('kaiser')
        lnl, chi2 = fit.log_likelihood(GOLDEN_PARAMS, rsd_model='kaiser')
        np.testing.assert_allclose(chi2, ref_fixtures['golden_chi2'][i], rtol=1e-8)
        with pytest.raises(InputError):
            fit.log_likelihood(GOLDEN_PARAMS, not_an_option=True)

    def test_theory_xi_pointwise_matches_grid(self, fit, ref_fixtures):
        s = np.asarray(fit.s)
        mu = np.linspace(0, 1, 100)
        xi = fit.theory_xi(s[None, :], mu[:, None], GOLDEN_PARAMS)
        np.testing.assert_allclose(xi, ref_fixtures['xi_smu'], atol=1e-10)
        # scalar call
        val = fit.theory_xi(float(s[3]), 0.5, GOLDEN_PARAMS)
        assert isinstance(val, float)
        np.testing.assert_allclose(val, xi[50, 3], atol=1e-3)

    def test_theory_multipoles(self, fit, ref_fixtures):
        m = fit.theory_multipoles(fit.s, GOLDEN_PARAMS, poles=[0, 2])
        np.testing.assert_allclose(m['0'], ref_fixtures['theory_mult_0'], atol=1e-10)
        np.testing.assert_allclose(m['2'], ref_fixtures['theory_mult_2'], atol=1e-10)
        tv = fit.theory_multipole_vector(fit.s, GOLDEN_PARAMS, poles=[0, 2])
        np.testing.assert_allclose(tv, ref_fixtures['theory_vector'], atol=1e-10)

    def test_matrices_and_errors(self, fit):
        corr = fit.correlation_matrix(0.37)
        np.testing.assert_allclose(np.diag(corr), 1.0, atol=1e-12)
        errs = fit.diagonal_errors(0.37)
        assert errs.shape == (2, 30)
        assert np.all(errs > 0)

    def test_interpolated_multipoles(self, fit, ref_fixtures):
        dm = fit.get_interpolated_redshift_multipoles(0.37)
        np.testing.assert_allclose(dm.reshape(-1), ref_fixtures['data_vector'],
                                   atol=1e-12)
        rm = fit.get_interpolated_real_multipoles(0.37)
        np.testing.assert_allclose(rm, ref_fixtures['real_mult_interp'], atol=1e-12)

    def test_theory_xi_2D(self, fit):
        xi2d = fit.theory_xi_2D(GOLDEN_PARAMS, rmax=60)
        grid = xi2d(np.array([10.0, 30.0]), np.array([-20.0, 0.5, 20.0]))
        assert grid.shape == (3, 2)
        # even in s_par to good accuracy
        np.testing.assert_allclose(grid[0], grid[2], atol=1e-4)
        # central deep-void value is negative
        assert xi2d(5.0, 0.5)[0, 0] < -0.3

    def test_xi_2D_from_multipoles(self, fit):
        xi2d = fit.xi_2D_from_multipoles(GOLDEN_PARAMS, rmax=60)
        direct = fit.theory_xi_2D(GOLDEN_PARAMS, rmax=60)
        a = xi2d(np.array([20.0]), np.array([15.0]))
        b = direct(np.array([20.0]), np.array([15.0]))
        np.testing.assert_allclose(a, b, atol=0.02)

    def test_odd_multipoles_use_full_mu_range(self, fit):
        """Requesting an odd pole must switch ALL poles to the full
        mu in [-1, 1] projection (victor/ccf_model.py:816-823): a mu-even
        xi then gives exactly 0 for the odd poles. Regression: the even=True
        projection over [0, 1] returned the spurious nonzero half-integral
        for odd P_ell."""
        s = np.linspace(15.0, 55.0, 5)
        mixed = fit.theory_multipoles(s, GOLDEN_PARAMS, poles=(0, 1, 2, 3))
        assert np.max(np.abs(mixed['1'])) < 1e-10
        assert np.max(np.abs(mixed['3'])) < 1e-10
        # even poles agree with the half-range projection up to the two
        # grids' quadrature-resolution difference (the reference has the
        # same property: 100 points over [-1,1] vs [0,1])
        even = fit.theory_multipoles(s, GOLDEN_PARAMS, poles=(0, 2))
        np.testing.assert_allclose(mixed['0'], even['0'], atol=2e-4)
        np.testing.assert_allclose(mixed['2'], even['2'], atol=2e-4)

    def test_interp2d_default_is_linear(self):
        """The reference's theory_xi_2D/xi_2D_from_multipoles return bare
        si.interp2d(...) whose default kind is LINEAR (ccf_model.py:893,933)
        — off-node queries must match that surface, not a cubic one."""
        from victor_tpu.api import Interp2D
        x = np.array([0.0, 1.0, 2.0, 3.0])
        z = (x ** 3)[None, :].repeat(4, 0)         # cubic in x, flat in y
        f = Interp2D(x, x, z)
        # linear interpolation of x^3 between 1 and 2 at 1.5: (1+8)/2 = 4.5
        np.testing.assert_allclose(f(1.5, 1.0)[0][0], 4.5, rtol=1e-12)

    def test_delta_velocity_profiles(self, fit, ref_fixtures):
        r_v = np.asarray(fit.bundle.tables.r_v)
        d, D = fit.delta_profiles(r_v, GOLDEN_PARAMS)
        np.testing.assert_allclose(d, ref_fixtures['delta'], atol=1e-10)
        vr, dvr = fit.velocity_terms(r_v, GOLDEN_PARAMS)
        np.testing.assert_allclose(vr, ref_fixtures['vel_vr'], atol=1e-8)

    def test_plots_run(self, fit):
        import matplotlib.pyplot as plt
        ax = fit.plot_multipole_comparison(
            {**GOLDEN_PARAMS, 'label': 'streaming'},
            {**GOLDEN_PARAMS, 'options': {'rsd_model': 'kaiser'},
             'label': 'kaiser'},
            ell=2, chi2=True)
        assert len(ax.lines) >= 2
        plt.close('all')
        ax = fit.plot_model_multipoles({**GOLDEN_PARAMS}, ell=0, diff=True)
        assert len(ax.lines) == 1
        plt.close('all')
        ax = fit.plot_realspace_multipoles({'beta': 0.37}, ell=2)
        assert len(ax.lines) == 1
        plt.close('all')

    def test_plot_2D_ccf(self, fit):
        import matplotlib.pyplot as plt
        from victor_tpu.plottools import plot_2D_ccf
        xi2d = fit.theory_xi_2D(GOLDEN_PARAMS, rmax=60)
        plot_2D_ccf(xi2d, np.linspace(1, 59, 30), contours=[-0.5, -0.2, 0.0])
        plt.close('all')


class TestConverters:
    def test_old_model_and_data_files(self, tmp_path):
        import h5py
        from victor_tpu.utils import (convert_old_data_files_to_hdf5,
                                      convert_old_model_files_to_hdf5)
        r = np.linspace(5, 120, 24)
        mult = np.concatenate([np.sin(r / 50), np.cos(r / 50)])
        np.save(tmp_path / 'real.npy', {'rvals': r, 'multipoles': mult})
        np.save(tmp_path / 'matter.npy', {'rvals': r, 'delta': -np.exp(-r / 30)})
        np.save(tmp_path / 'vel.npy', {'rvals': r, 'sigma_v_los': 300 + r})
        out = tmp_path / 'model.hdf5'
        convert_old_model_files_to_hdf5(tmp_path / 'real.npy', out,
                                        matter_ccf_file=tmp_path / 'matter.npy',
                                        velocity_file=tmp_path / 'vel.npy')
        with h5py.File(out) as f:
            assert set(f.keys()) == {'r', 'monopole', 'quadrupole', 'rdelta',
                                     'delta', 'rsv', 'sigmav'}
            np.testing.assert_allclose(f['monopole'][:], np.sin(r / 50))

        # beta-grid variant + covariance
        beta = np.linspace(0.3, 0.5, 5)
        mult_b = np.tile(mult, (5, 1))
        np.save(tmp_path / 'red.npy', {'rvals': r, 'multipoles': mult_b})
        np.save(tmp_path / 'beta.npy', beta)
        cov = np.eye(48)
        np.save(tmp_path / 'cov.npy', cov)
        convert_old_data_files_to_hdf5(tmp_path / 'red.npy', tmp_path / 'data.hdf5',
                                       beta_file=tmp_path / 'beta.npy',
                                       covmat_file=tmp_path / 'cov.npy',
                                       output_covmat_file=tmp_path / 'cov.hdf5')
        with h5py.File(tmp_path / 'data.hdf5') as f:
            assert f['monopole'].shape == (5, 24)
            np.testing.assert_array_equal(f['beta'][:], beta)
        with h5py.File(tmp_path / 'cov.hdf5') as f:
            np.testing.assert_array_equal(f['covmat'][:], cov)

    def test_quijote_converter(self, tmp_path):
        import h5py
        import json
        from victor_tpu.utils import convert_hans_quijote_to_hdf5
        rng = np.random.default_rng(0)
        nmock, nr = 6, 8
        r = np.linspace(5, 100, nr).tolist()
        mocks = []
        for i in range(nmock):
            entry = {}
            for stem in ['CCF_multipole_Halo_RECON_Void_RECON',
                         'CCF_multipole_Halo_RSD_Void_RECON']:
                entry[f'{stem}_radius'] = r
                for ell in (0, 2, 4):
                    entry[f'{stem}_xi{ell}'] = rng.normal(size=nr).tolist()
            for stem, keys in [('profile_DM_REAL_Void_RECON', ['delta', 'Delta']),
                               ('profile_Halo_REAL_Void_RECON', ['v', 'sigma'])]:
                entry[f'{stem}_radius'] = r
                for kk in keys:
                    entry[f'{stem}_{kk}'] = rng.normal(size=nr).tolist()
            mocks.append(entry)
        with open(tmp_path / 'quijote.json', 'w') as f:
            json.dump(mocks, f)
        out = tmp_path / 'quijote.hdf5'
        convert_hans_quijote_to_hdf5(tmp_path / 'quijote.json', out)
        with h5py.File(out) as f:
            assert f['xi0_s'].shape == (nmock, nr)
            assert f['D_ell02_covmat'].shape == (2 * nr, 2 * nr)
            assert f['D_ell024_covmat'].shape == (3 * nr, 3 * nr)
            np.testing.assert_allclose(f['average_xi0_r'][:],
                                       f['xi0_r'][:].mean(axis=0))


class TestCLI:
    def test_eval(self, boss_config, tmp_path, capsys):
        import yaml
        from victor_tpu.__main__ import main
        cfg_path = tmp_path / 'cfg.yaml'
        with open(cfg_path, 'w') as f:
            yaml.safe_dump(boss_config, f)
        main(['eval', str(cfg_path),
              '--param', 'fsigma8=0.47', '--param', 'beta=0.37',
              '--param', 'sigma_v=380', '--param', 'epsilon=1.0'])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert abs(out['chi2'] - 65.01) < 0.01

    def test_eval_set_override(self, boss_config, tmp_path, capsys):
        """--set (available on every config-taking subcommand, the cobaya
        command-line-override role) reaches the model options: switching
        rsd_model to kaiser must land on the kaiser cell-22 golden."""
        import yaml
        from victor_tpu.__main__ import main
        cfg_path = tmp_path / 'cfg.yaml'
        with open(cfg_path, 'w') as f:
            yaml.safe_dump(boss_config, f)
        main(['eval', str(cfg_path), '--set', 'model.rsd_model=kaiser',
              '--param', 'fsigma8=0.47', '--param', 'beta=0.37',
              '--param', 'sigma_v=380', '--param', 'epsilon=1.0'])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert abs(out['chi2'] - 103.90) < 0.01

    def test_corner_plot(self, tmp_path):
        """plottools.corner_plot (the analyze/plot_chains corner): weighted
        samples, subset selection, saved artifact."""
        from victor_tpu.plottools import corner_plot
        rng = np.random.default_rng(3)
        samples = rng.standard_normal((500, 3))
        out = corner_plot(samples, ['a', 'b', 'c'],
                          str(tmp_path / 'corner.png'),
                          weights=rng.random(500), params=['c', 'a'])
        import os
        assert os.path.getsize(out) > 1000

    def test_bench(self, boss_config, tmp_path, capsys):
        import yaml
        from victor_tpu.__main__ import main
        cfg = dict(boss_config)
        cfg['params'] = {
            'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5}},
            'beta': {'prior': {'dist': 'uniform', 'min': 0.2, 'max': 0.6}},
            'sigma_v': 380.0, 'epsilon': 1.0,
        }
        cfg_path = tmp_path / 'cfg.yaml'
        with open(cfg_path, 'w') as f:
            yaml.safe_dump(cfg, f)
        main(['bench', str(cfg_path), '--batch', '8', '--reps', '1',
              '--chunk', '8'])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out['evals_per_sec'] > 0

    def test_json_sanitize(self):
        """Non-finite floats (e.g. the undefined R-hat of a 2-draw smoke
        run) must print as null, not bare NaN/Infinity (invalid strict
        JSON that jq and non-Python consumers reject)."""
        from victor_tpu.__main__ import _json_sanitize
        out = _json_sanitize({'a': float('nan'), 'b': [1.0, float('inf')],
                              'c': {'d': -float('inf'), 'e': 2}})
        text = json.dumps(out)
        assert json.loads(text) == {'a': None, 'b': [1.0, None],
                                    'c': {'d': None, 'e': 2}}


class TestCobayaAdapter:
    def test_import_and_gate(self):
        from victor_tpu.likelihoods import CCFLikelihood
        lk = CCFLikelihood.__new__(CCFLikelihood)
        with pytest.raises(ImportError):
            lk.initialize()

    def test_defaults_yaml_matches_reference_vocabulary(self):
        """The class-defaults YAML must carry the reference's full parameter
        vocabulary (victor/likelihoods/CCFLikelihood.yaml:1-40)."""
        import victor_tpu.likelihoods as pkg
        import yaml
        path = os.path.join(os.path.dirname(pkg.__file__), 'CCFLikelihood.yaml')
        assert os.path.isfile(path)
        with open(path) as f:
            defaults = yaml.safe_load(f)
        assert set(defaults) >= {'model', 'data', 'config_file', 'params'}
        expected = {'fsigma8', 'beta', 'epsilon', 'b', 'alpha', 'aperp',
                    'apar', 'astar', 'sigma_v', 'Av', 'f', 'sigma_8_0',
                    'b10', 'b01', 'Rp', 'Rx', 'Omega_m', 'Omega_b', 'H0',
                    'ns', 'mnu', 'Omega_k', 'delta_c', 'M', 'Q',
                    'chi2_ccf_correct'}
        assert set(defaults['params']) == expected
        assert defaults['params']['chi2_ccf_correct'] == {
            'derived': True, 'latex': r'\chi^2'}

    def test_adapter_executes_under_cobaya_stub(self, boss_config):
        """Execute initialize() + calculate() through a minimal stand-in for
        cobaya's Likelihood base class (cobaya itself is not installed):
        logp and derived chi2 must hit the notebook cell-22 goldens."""
        import importlib
        import sys
        import types

        cobaya = types.ModuleType('cobaya')
        cobaya_like = types.ModuleType('cobaya.likelihood')

        class Likelihood:      # the attribute-bag contract the adapter uses
            pass

        cobaya_like.Likelihood = Likelihood
        cobaya.likelihood = cobaya_like
        sys.modules['cobaya'] = cobaya
        sys.modules['cobaya.likelihood'] = cobaya_like
        try:
            mod = importlib.reload(
                importlib.import_module('victor_tpu.likelihoods.CCFLikelihood'))
            lk = mod.CCFLikelihood()
            lk.model = boss_config['model']
            lk.data = boss_config['data']
            lk.config_file = None
            lk.initialize()
            # fsigma8 is only advertised for excursion_set configs (where
            # calculate() actually provides it); boss_config is template
            assert lk.get_can_provide_params() == ['chi2_ccf_correct']
            state = {}
            lk.calculate(state, want_derived=True,
                         fsigma8=0.47, beta=0.37, sigma_v=380.0, epsilon=1.0)
            assert abs(state['logp'] - 284.76) < 0.01
            assert abs(state['derived']['chi2_ccf_correct'] - 65.01) < 0.01
            # the ESM branch DOES advertise the derived fsigma8 (checked by
            # flipping the static option; avoids building a full ESM bundle)
            import dataclasses as _dc
            lk.ccf_fit.bundle = _dc.replace(
                lk.ccf_fit.bundle,
                theory_opts=_dc.replace(lk.ccf_fit.bundle.theory_opts,
                                        matter_model='excursion_set'))
            assert lk.get_can_provide_params() == \
                ['chi2_ccf_correct', 'fsigma8']
        finally:
            del sys.modules['cobaya']
            del sys.modules['cobaya.likelihood']
            importlib.reload(
                importlib.import_module('victor_tpu.likelihoods.CCFLikelihood'))


class TestCobayaConfigIngestion:
    def test_toy_example_config_model_only(self, capsys):
        """configs/example_model_input.yaml (the reference's toy config,
        config/example_model_input.yaml:1-23) evaluates out of the box:
        model-only, so eval prints theory multipoles instead of a chi2."""
        from victor_tpu.__main__ import main
        main(['eval', 'configs/example_model_input.yaml',
              '--param', 'fsigma8=0.47'])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert 'theory_multipoles' in out and '0' in out['theory_multipoles']
        mono = np.asarray(out['theory_multipoles']['0'])
        assert mono.shape == (len(out['s']),)
        assert np.all(np.isfinite(mono)) and mono.min() < -0.04

    def test_reference_cobaya_run_config(self, capsys):
        """The reference's own cobaya-run YAML works unchanged
        (model/data nested under likelihood.CCFLikelihood)."""
        from victor_tpu.__main__ import main
        main(['eval', '/root/reference/config/boss_cobaya_config.yaml',
              '--param', 'beta=0.37'])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert abs(out['chi2'] - 65.01) < 0.01


class TestHostBuildTransfer:
    def test_host_build_then_batched_transfer_is_bit_identical(
            self, boss_config, monkeypatch):
        """build_tables on a non-CPU backend builds on the host CPU device
        and moves the bundle in ONE batched device_put (~34 per-array
        transfers collapse to one; see build_tables docstring).
        Simulate the non-CPU branch on this CPU-only box by patching
        _transfer_needed: the
        target resolves to devices()[0] (a CPU device here), so the transfer
        machinery runs end-to-end and must be bit-identical to the direct
        host build, with every leaf committed to the target device."""
        import jax
        from victor_tpu.io import tables as tables_mod
        direct = tables_mod._build_tables_host(
            boss_config['model'], boss_config['data'])
        monkeypatch.setattr(tables_mod, '_transfer_needed', lambda t: True)
        moved = tables_mod.build_tables(boss_config['model'],
                                        boss_config['data'])
        target = jax.devices()[0]
        leaves_a = jax.tree.leaves(direct)
        leaves_b = jax.tree.leaves(moved)
        assert len(leaves_a) == len(leaves_b) > 30
        for a, b in zip(leaves_a, leaves_b):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert b.committed and b.devices() == {target}


class TestInputValidation:
    def test_missing_data_file_keys_raise_input_error(self, boss_config):
        """Malformed data blocks get the InputError contract, not a raw
        TypeError from os.path.join(None)."""
        import copy
        from victor_tpu.io import build_tables
        cfg = copy.deepcopy(boss_config)
        del cfg['data']['redshift_space_ccf']['data_file']
        with pytest.raises(InputError, match='data_file'):
            build_tables(cfg['model'], cfg['data'])
        cfg = copy.deepcopy(boss_config)
        del cfg['data']['covariance_matrix']['data_file']
        with pytest.raises(InputError, match='data_file'):
            build_tables(cfg['model'], cfg['data'])

    def test_non_monotonic_r_raises_input_error(self, boss_config, tmp_path):
        """A non-sorted radial grid in the input file must raise InputError
        instead of crashing inside scipy (or silently building garbage
        h=0 Hermite coefficients for duplicated knots)."""
        import copy
        import os
        import h5py
        from victor_tpu.io import build_tables
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        src = os.path.join(repo, boss_config['model']['input_model_data_file'])
        with h5py.File(src) as f:
            payload = {k: f[k][:] for k in f}
        payload['r'] = payload['r'][::-1].copy()
        fn = tmp_path / 'bad_model.hdf5'
        with h5py.File(fn, 'w') as f:
            for k, v in payload.items():
                f.create_dataset(k, data=v)
        cfg = copy.deepcopy(boss_config)
        cfg['model']['input_model_data_file'] = str(fn)
        cfg['model']['dir'] = ''
        with pytest.raises(InputError, match='strictly increasing'):
            build_tables(cfg['model'], None)
        # an all-tiny grid (max <= 0.1) would make the 100-pt fine grid
        # linspace(0.1, r.max()) DEcreasing — same InputError contract
        payload['r'] = np.linspace(0.02, 0.09, 30)
        fn2 = tmp_path / 'bad_model2.hdf5'
        with h5py.File(fn2, 'w') as f:
            for k, v in payload.items():
                f.create_dataset(k, data=v)
        cfg['model']['input_model_data_file'] = str(fn2)
        with pytest.raises(InputError, match='strictly increasing'):
            build_tables(cfg['model'], None)

    def test_non_monotonic_dispersion_grid_raises(self, boss_config, tmp_path):
        """The dispersion-template r grid gets the same guard as r: unsorted
        grids otherwise feed np.interp (silent garbage) and the Bicubic2D
        builder (raw scipy error)."""
        import copy
        import os
        import h5py
        from victor_tpu.io import build_tables
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        src = os.path.join(repo, boss_config['model']['input_model_data_file'])
        with h5py.File(src) as f:
            payload = {k: f[k][:] for k in f}
        payload['rsv'] = payload['rsv'][::-1].copy()
        fn = tmp_path / 'bad_disp.hdf5'
        with h5py.File(fn, 'w') as f:
            for k, v in payload.items():
                f.create_dataset(k, data=v)
        cfg = copy.deepcopy(boss_config)
        cfg['model']['input_model_data_file'] = str(fn)
        cfg['model']['dir'] = ''
        with pytest.raises(InputError, match='strictly increasing'):
            build_tables(cfg['model'], None)


class TestBetaNoneParity:
    def test_beta_none_raises_like_reference(self, fit):
        """Reference raises InputError for beta=None on beta-grid inputs
        (victor/ccf_model.py:321-322, ccf_fit.py:188-189)."""
        with pytest.raises(InputError):
            fit.get_interpolated_real_multipoles(None)
        with pytest.raises(InputError):
            fit.get_interpolated_redshift_multipoles(None)
        with pytest.raises(InputError):
            fit.multipole_datavector(None)
        # beta-dependent covariance: same contract (ccf_fit.py:213-214);
        # beta=0.0 would silently clamp to the boundary covmat
        with pytest.raises(InputError):
            fit.get_interpolated_covariance(None)
        with pytest.raises(InputError):
            fit.get_interpolated_precision(None)
        with pytest.raises(InputError):
            fit.correlation_matrix(None)

    def test_delta_profiles_linear_bias_needs_beta(self, fit):
        """linear_bias delta profiles interpolate the beta-grid multipoles;
        a missing beta must raise, not silently extrapolate at 0.0."""
        import jax.numpy as jnp
        from victor_tpu.models.ccf_theory import delta_profiles
        b = fit.bundle
        opts = b.theory_opts.replace(matter_model='linear_bias')
        with pytest.raises(InputError, match='beta'):
            delta_profiles(b.tables, b.spec, opts,
                           {'bias': jnp.asarray(1.9)})

    def test_pdf_form_validated(self):
        from victor_tpu.config import TheoryOptions
        with pytest.raises(ValueError, match='pdf_form'):
            TheoryOptions(pdf_form='exponential')

    def test_jit_fn_cache_is_per_instance(self, fit):
        """The jit-fn caches must live on the instance, not in a class-level
        lru keyed on self (which pinned instances + their device tables)."""
        import functools
        fit.chi_squared({'fsigma8': 0.47, 'beta': 0.37,
                         'sigma_v': 380.0, 'epsilon': 1.0})
        assert '_jit_fns' in fit.__dict__
        assert not any(isinstance(getattr(type(fit), n, None),
                                  functools._lru_cache_wrapper)
                       for n in ('_chi2_fn', '_loglike_fn', '_xi_grid_fn'))
