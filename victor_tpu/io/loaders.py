"""File loading utilities (HDF5 / npy key-value stores, run configs).

Reproduces the reference's format handling (victor/ccf_model.py:53-68):
a model/data file is a flat mapping from string keys to arrays, stored either
as an .npy pickled dict or an HDF5 file. Run configs are YAML, or JSON by
extension. h5py and PyYAML are optional: the .npy and JSON forms need
neither.
"""

from __future__ import annotations

import importlib
import json
import os

import numpy as np

from ..errors import InputError

NPY_EXTENSIONS = ('.npy',)


def optional_import(module: str, package: str):
    """Import an optional dependency, naming the package if it is missing."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f'this needs the {package!r} package, which is '
                          'not installed') from e


def load_key_value_file(path: str) -> dict:
    """Load a model/data input file into a {key: ndarray} dict.

    `.npy` files hold a pickled dict (as np.save writes one); anything else
    is read as HDF5, like the reference."""
    if not os.path.isfile(path):
        raise InputError(f'File {path} containing input data not found')
    if path.endswith(NPY_EXTENSIONS):
        return np.load(path, allow_pickle=True).item()
    h5py = optional_import('h5py', 'h5py')
    with h5py.File(path, 'r') as f:
        return {key: f[key][:] for key in f.keys()}


def load_config(path: str) -> dict:
    """Read a run config: JSON if the name ends in .json, YAML otherwise."""
    with open(path) as f:
        if path.endswith('.json'):
            return json.load(f)
        return optional_import('yaml', 'pyyaml').safe_load(f)


def select_simulation(arr: np.ndarray, isim) -> np.ndarray:
    """Optional `simulation_number` selection from stacked mock arrays
    (victor/ccf_model.py:129,139-141)."""
    if isim is None:
        return arr
    if isinstance(isim, (int, np.integer)):
        return arr[int(isim)]
    raise InputError('If provided, simulation_number must be an integer')
