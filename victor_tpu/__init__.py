"""victor_tpu: a JAX/XLA framework for void-galaxy and
density-split cross-correlation modelling and likelihood analysis.

Re-designed from scratch with the capabilities of the reference `victor`
package (see SURVEY.md): the theory pipeline is a fully jit/vmap-able
functional core over device-resident tables, the likelihood is batched so
thousands of parameter points evaluate per dispatch, and posterior sampling
runs on-device across a `jax.sharding.Mesh`.
"""

from ._version import __version__
from .errors import InputError
from .models.cosmology import BackgroundCosmology
from .api import CCFModel, CCFFit
from .models.esm import ExcursionSetProfile
from . import plottools, utils

__all__ = ['__version__', 'InputError', 'BackgroundCosmology',
           'CCFModel', 'CCFFit', 'ExcursionSetProfile', 'plottools', 'utils']
