from .loaders import load_config, load_key_value_file, select_simulation
from .tables import CCFTables, CCFModelBundle, build_tables

__all__ = ['load_config', 'load_key_value_file', 'select_simulation',
           'CCFTables', 'CCFModelBundle', 'build_tables']
