"""Tracing / profiling hooks (SURVEY §5: absent in the reference).

- `timed(name)`: wall-clock phase timer — use around init/compile/eval/
  sample phases; register device outputs via the yielded handle to force
  completion (see docstring); results accumulate in `phase_times()` and
  log at DEBUG.
- `trace(logdir)`: context manager around `jax.profiler.trace` for a full
  device trace viewable in TensorBoard/Perfetto.
- `throughput(fn, args, reps)`: compile-excluded evals/sec measurement, the
  BASELINE.md metric.
- `debug_nans(enable)`: toggles jax_debug_nans (the jit-era equivalent of a
  sanitizer: any NaN produced under jit raises at the producing op).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import jax

from .logging import get_logger

log = get_logger('profiling')
_PHASES: Dict[str, float] = defaultdict(float)
_COUNTS: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def timed(name: str):
    """Accumulating wall-clock timer.

    For host-synchronous work (table builds, api calls returning Python
    floats) just wrap the block. For async-dispatched device work, register
    the outputs so the timer can force completion before stopping the
    clock — there is NO global barrier for pure jitted computations
    (jax.effects_barrier only waits on effectful runtime tokens)::

        with timed('eval') as watch:
            out = fn(theta)
            watch(out)        # block_until_ready at exit
    """
    outs = []
    t0 = time.perf_counter()
    try:
        yield outs.append
    finally:
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        _PHASES[name] += dt
        _COUNTS[name] += 1
        log.debug('phase %s: %.3fs (total %.3fs over %d)', name, dt,
                  _PHASES[name], _COUNTS[name])


def phase_times() -> Dict[str, Dict[str, float]]:
    return {k: {'total_s': _PHASES[k], 'count': _COUNTS[k]}
            for k in sorted(_PHASES)}


def reset_phase_times() -> None:
    _PHASES.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device profile into `logdir` (TensorBoard 'profile' plugin
    or Perfetto can open it)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.info('profiler trace written to %s', logdir)


def throughput(fn, *args, reps: int = 5, warmup: int = 1):
    """(result, evals_per_sec_per_call) excluding compile: runs `fn(*args)`
    `warmup` times, then times `reps` calls. Dispatch is asynchronous, so
    each rep waits for every output with block_until_ready."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
        jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    return out, 1.0 / dt


def debug_nans(enable: bool = True) -> None:
    jax.config.update('jax_debug_nans', enable)


#: the compile cache used when JAX_COMPILATION_CACHE_DIR is not set: a fixed
#: path, because the cache directory is part of every entry's key
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), '.cache', 'xla')


def enable_persistent_cache(path: str | None = None,
                            min_compile_secs: float = 1.0,
                            force: bool = False) -> None:
    """Enable JAX's on-disk compilation cache (accelerator backends only).

    Cold compiles of the big theory/HMC graphs take tens of seconds; the
    persistent cache lets later processes on the same machine load them.
    Call before the first jit execution.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already caches there and this
    sets nothing. Otherwise the cache goes to `path`, by default
    DEFAULT_CACHE_DIR (`<repo>/.cache/xla`).

    On a CPU backend this is a deliberate no-op (unless force=True): CPU
    compiles are fast, and XLA:CPU caches AOT machine code keyed loosely
    enough that an entry written on a host with wider vector features loads
    on a narrower host with a SIGILL warning — observed when a virtual-mesh
    dry run shared the cache directory with earlier runs.
    """
    if os.environ.get('JAX_COMPILATION_CACHE_DIR'):
        log.info('persistent compilation cache at %s (environment)',
                 os.environ['JAX_COMPILATION_CACHE_DIR'])
        return
    if not force and jax.default_backend() == 'cpu':
        log.info('persistent compilation cache skipped (cpu backend)')
        return
    path = path or DEFAULT_CACHE_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update('jax_compilation_cache_dir', path)
    jax.config.update('jax_persistent_cache_min_compile_time_secs',
                      min_compile_secs)
    log.info('persistent compilation cache at %s', path)
