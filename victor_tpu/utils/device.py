"""The accelerator a measurement runs on, checked and named.

Measurement entry points (bench.py, chip_smoke.py, tools/bench_variants.py)
refuse to run on anything but a GPU, so that no CPU number is ever reported
under the name of a device metric, and print which card they ran on.
"""

from __future__ import annotations

import subprocess
import sys

import jax


def require_gpu() -> dict:
    """{'platform', 'kind', 'count'} of the visible GPUs; exits non-zero
    without printing a result when JAX found no GPU."""
    if jax.default_backend() != 'gpu':
        sys.exit(f'no GPU: JAX backend is {jax.default_backend()!r}; this '
                 'entry point measures the GPU and has no CPU fallback')
    dev = jax.devices()[0]
    return {'platform': dev.platform, 'kind': dev.device_kind,
            'count': len(jax.devices())}


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for each card, one per
    line, read by a child process that does not touch JAX."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
