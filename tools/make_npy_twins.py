#!/usr/bin/env python
"""Write the h5py-free and PyYAML-free twins of the main-path BOSS inputs.

The BOSS configs name three HDF5 files (model templates, data multipoles,
beta-varying covariance). This script reads each committed HDF5 file and
writes the same {key: array} mapping next to it as an `.npy` pickled dict,
the format `io.load_key_value_file` reads without h5py. It then writes a
JSON twin of each main-path YAML config whose file names point at those
`.npy` files, so the configs load without PyYAML.

Needs h5py and PyYAML; run it from the repository root after changing a
BOSS input or one of the configs below:

    python tools/make_npy_twins.py
"""

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CONFIGS = ('boss_config', 'boss_sampling_config', 'esm_sampling_config')


def npy_twin(path: str) -> str:
    """The .npy file name that stands for an HDF5 input."""
    return os.path.splitext(path)[0] + '.npy'


def config_data_files(cfg: dict) -> list:
    """The input files a reference-schema config names."""
    data = cfg.get('data', {})
    return [cfg['model']['input_model_data_file'],
            data['redshift_space_ccf']['data_file'],
            data['covariance_matrix']['data_file']]


def main():
    import yaml

    from victor_tpu.io.loaders import load_key_value_file

    files = set()
    for name in CONFIGS:
        with open(os.path.join(REPO, 'configs', name + '.yaml')) as f:
            cfg = yaml.safe_load(f)
        paths = config_data_files(cfg)
        files.update(paths)
        cfg['model']['input_model_data_file'] = npy_twin(paths[0])
        cfg['data']['redshift_space_ccf']['data_file'] = npy_twin(paths[1])
        cfg['data']['covariance_matrix']['data_file'] = npy_twin(paths[2])
        out = os.path.join(REPO, 'configs', name + '.json')
        with open(out, 'w') as f:
            json.dump(cfg, f, indent=2)
            f.write('\n')
        print('wrote', os.path.relpath(out, REPO))
    for path in sorted(files):
        out = npy_twin(os.path.join(REPO, path))
        np.save(out, load_key_value_file(os.path.join(REPO, path)),
                allow_pickle=True)
        print('wrote', os.path.relpath(out, REPO))


if __name__ == '__main__':
    main()
