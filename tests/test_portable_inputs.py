"""The main path's inputs load without the optional h5py and PyYAML:
`.npy` twins of the BOSS HDF5 files and JSON twins of the main-path
configs, written by tools/make_npy_twins.py."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from victor_tpu.io import build_tables, load_config, load_key_value_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOSS = 'data/BOSS_DR12_CMASS_data/CMASS_zobovVoids_reconRs10_0.43z0.7_medianRvcut_'
CONFIGS = ('boss_config', 'boss_sampling_config', 'esm_sampling_config')


@pytest.mark.parametrize('stem', ['PatchyMean_model', 'data',
                                  'variable_D_covariance'])
def test_npy_twin_equals_hdf5(stem):
    src = load_key_value_file(os.path.join(REPO, BOSS + stem + '.hdf5'))
    twin = load_key_value_file(os.path.join(REPO, BOSS + stem + '.npy'))
    assert sorted(twin) == sorted(src)
    for key in src:
        assert twin[key].dtype == src[key].dtype
        np.testing.assert_array_equal(twin[key], src[key])


def _hdf5_paths(cfg):
    """The config with its .npy input names mapped back to the HDF5 files."""
    for block, key in (('model', 'input_model_data_file'),):
        cfg[block][key] = cfg[block][key].replace('.npy', '.hdf5')
    for block in ('redshift_space_ccf', 'covariance_matrix'):
        sub = cfg['data'][block]
        sub['data_file'] = sub['data_file'].replace('.npy', '.hdf5')
    return cfg


@pytest.mark.parametrize('name', CONFIGS)
def test_json_twin_matches_yaml(name):
    twin = load_config(os.path.join(REPO, 'configs', name + '.json'))
    yaml_cfg = load_config(os.path.join(REPO, 'configs', name + '.yaml'))
    assert twin['model']['input_model_data_file'].endswith('.npy')
    assert _hdf5_paths(twin) == yaml_cfg


def test_json_twin_builds_the_same_tables():
    bundles = []
    for ext in ('json', 'yaml'):
        cfg = load_config(os.path.join(REPO, 'configs', 'boss_config.' + ext))
        cfg['model']['dir'] = cfg['data']['dir'] = REPO
        bundles.append(build_tables(cfg['model'], cfg['data']))
    a, b = bundles
    assert (a.spec, a.theory_opts, a.fit_opts) == \
        (b.spec, b.theory_opts, b.fit_opts)
    for x, y in zip(jax.tree_util.tree_leaves(a.tables),
                    jax.tree_util.tree_leaves(b.tables)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


BLOCKED = '''
import sys
sys.modules['yaml'] = None
sys.modules['h5py'] = None
import jax
jax.config.update('jax_enable_x64', True)
import jax.numpy as jnp
from victor_tpu.io import build_tables, load_config
from victor_tpu.likelihood import core as lk
cfg = load_config('configs/boss_config.json')
bundle = build_tables(cfg['model'], cfg['data'])
params = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}
lnl, chi2 = lk.log_likelihood(bundle.tables, bundle.spec, bundle.theory_opts,
                              bundle.fit_opts,
                              {k: jnp.asarray(v) for k, v in params.items()})
print('chi2', float(chi2), 'lnl', float(lnl))
for path in ('configs/boss_config.yaml', cfg['model']['input_model_data_file']
             .replace('.npy', '.hdf5')):
    try:
        load_config(path) if path.endswith('.yaml') else \\
            __import__('victor_tpu').io.load_key_value_file(path)
    except ImportError as e:
        print('missing:', e)
'''


def test_main_path_without_yaml_and_h5py():
    """Tables and the cell-22 golden chi2 build with yaml and h5py
    unimportable; reading a YAML or HDF5 file then names the package."""
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    out = subprocess.run([sys.executable, '-c', BLOCKED], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    chi2, lnl = float(lines[0].split()[1]), float(lines[0].split()[3])
    assert abs(chi2 - 65.01177758) < 1e-6 and abs(lnl - 284.76438935) < 1e-6
    assert "'pyyaml' package" in lines[1]
    assert "'h5py' package" in lines[2]
