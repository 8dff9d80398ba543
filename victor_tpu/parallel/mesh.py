"""Device-mesh utilities: the on-device replacement for the reference's MPI.

The reference's only multiprocess facility is `mpirun -n N cobaya-run` —
N independent chains that communicate solely for the Gelman-Rubin check
(victor/README.md:30). Here the equivalent is a `jax.sharding.Mesh` with a
('chains', 'walkers') layout: chains x walkers are data-parallel across
devices, tables are replicated, and cross-chain statistics (R-hat, ESS) are
computed with ordinary jnp reductions under jit — XLA inserts the
collectives (NCCL on GPUs); there is no explicit message passing anywhere.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialise multi-host JAX. No-op single-host.

    Call once at program start on each host before any device use; after it,
    `jax.devices()` spans the full slice and the same single-controller pjit
    code scales across hosts.
    """
    if num_processes is None or num_processes <= 1:
        if coordinator_address is not None and num_processes is None:
            # a coordinator with no process count is a misconfigured
            # multi-host launch — failing fast beats N hosts silently
            # running independent single-host programs with wrong results
            raise ValueError(
                'distributed_init: coordinator_address was given but '
                'num_processes is None — pass the process count (and '
                'process_id) for a multi-host launch')
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh(axis_names: Sequence[str] = ('chains', 'walkers'),
              shape: Optional[Tuple[int, ...]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh over available devices.

    Default layout puts `chains` on the outer axis and `walkers` within:
    both are embarrassingly parallel for likelihood evaluation. The GPUs of
    one host are joined all to all by NVLink, so every device pair is
    equally close and the devices fill the mesh in enumeration order.
    If `shape` is omitted, devices are factored as evenly as possible.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        # put the largest factor on the LAST axis so the biggest batch axis
        # (walkers) gets the most devices; middle axes stay singleton.
        # e.g. 8 devices, 2 axes -> (2, 4); 3 axes -> (2, 1, 4)
        a = 1
        if len(axis_names) > 1:
            for cand in range(int(math.isqrt(n)), 0, -1):
                if n % cand == 0:
                    a = cand
                    break
        shape = (a,) + (1,) * (len(axis_names) - 2) + (n // a,) \
            if len(axis_names) > 1 else (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f'mesh shape {shape} does not cover {n} devices')
    return Mesh(np.asarray(devices).reshape(shape), tuple(axis_names))


def shard_along(x, mesh: Mesh, axes: Sequence[Optional[str]]):
    """Device-put `x` sharded with PartitionSpec(*axes) over `mesh`."""
    return jax.device_put(x, NamedSharding(mesh, P(*axes)))


def replicate(x, mesh: Mesh):
    """Device-put `x` fully replicated over `mesh` (for tables/operators)."""
    return jax.device_put(x, NamedSharding(mesh, P()))


def cross_chain_rhat(chains_by_param):
    """Split-R-hat over a (n_chains, n_draws, n_params) array.

    Under jit with the chains axis sharded, the means/variances lower to
    XLA all-reduces — the mesh-native Gelman-Rubin check.
    """
    import jax.numpy as jnp
    x = chains_by_param
    m, n = x.shape[0], x.shape[1]
    half = n // 2
    if half < 2:
        # fewer than 2 draws per split half: R-hat is undefined — report
        # "not converged" rather than dividing by n = 0
        return jnp.full(x.shape[2:], jnp.inf)
    x = jnp.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)  # split chains
    m, n = 2 * m, half
    chain_mean = jnp.mean(x, axis=1)                    # (m, P)
    chain_var = jnp.var(x, axis=1, ddof=1)              # (m, P)
    B = n * jnp.var(chain_mean, axis=0, ddof=1)
    W = jnp.mean(chain_var, axis=0)
    var_post = (n - 1) / n * W + B / n
    # W == 0 (every chain constant — a stuck sampler) would give NaN, which
    # fails every `rhat - 1 < stop` test SILENTLY; +inf fails them too but
    # says "not converged" instead of "undefined"
    bad = W <= 0
    return jnp.where(bad, jnp.inf, jnp.sqrt(var_post / jnp.where(bad, 1.0,
                                                                 W)))
