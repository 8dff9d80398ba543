import os

# Run the test suite on a virtual 8-device CPU mesh so multi-device sharding
# code is exercised without accelerators (the JAX-idiomatic fake backend).
os.environ['JAX_PLATFORMS'] = 'cpu'
flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (flags + ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402

# the config override also applies when jax was imported before this file,
# as long as no backend has been initialised yet
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)
assert jax.devices()[0].platform == 'cpu'

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Persist XLA:CPU compilations across suite runs (default ON; opt out with
# VICTOR_TEST_COMPILE_CACHE=0). The suite's wall clock is dominated by jit
# compiles; with the cache warm, repeat runs are several times faster. Same
# rule as every entry point (utils/profiling.enable_persistent_cache): a set
# JAX_COMPILATION_CACHE_DIR wins. Otherwise XLA:CPU cache entries, which
# embed AOT machine code keyed loosely enough that an entry written on a
# host with wider vector features SIGILLs on a narrower host, go to a
# directory keyed by a CPU-feature fingerprint: a different host simply
# starts its own cold cache instead of loading a poisoned one.
if os.environ.get('VICTOR_TEST_COMPILE_CACHE', '1') != '0':
    import hashlib
    import platform

    def _cpu_fingerprint() -> str:
        feat = platform.machine()
        try:
            with open('/proc/cpuinfo') as f:
                for line in f:
                    if line.startswith(('flags', 'Features')):
                        feat += ' '.join(sorted(line.split(':', 1)[1].split()))
                        break
        except OSError:
            feat += platform.processor()
        return hashlib.sha256(feat.encode()).hexdigest()[:12]

    from victor_tpu.utils.profiling import enable_persistent_cache
    enable_persistent_cache(
        path=os.path.join(REPO, '.cache', f'test_xla-{_cpu_fingerprint()}'),
        min_compile_secs=0.5, force=True)
FIXTURES = os.path.join(REPO, 'tests', 'fixtures')


@pytest.fixture(autouse=True, scope='module')
def _clear_jax_caches_between_modules():
    """Free compiled-executable memory between test modules.

    A full `--runslow` session compiles ~450 XLA:CPU programs; around the
    ~400th, XLA:CPU reproducibly SEGFAULTS/aborts on the next large
    compile (or on cache (de)serialization of it) — native resource
    exhaustion inside the compiler/JIT, independent of Python stack depth
    or the persistent cache (diagnosed 2026-08-21; CLAUDE.md rule 10).
    Dropping jax's executable caches after each module frees the loaded
    code; cross-module recompiles reload from the persistent disk cache,
    so the wall-clock cost is small."""
    yield
    jax.clear_caches()


def pytest_addoption(parser):
    parser.addoption('--runslow', action='store_true', default=False,
                     help='also run tests marked slow (full sampler/optimizer '
                          'iteration counts; the default run covers the same '
                          'code paths at reduced cost)')


def pytest_collection_modifyitems(config, items):
    if config.getoption('--runslow'):
        return
    skip_slow = pytest.mark.skip(reason='slow: needs --runslow')
    for item in items:
        if 'slow' in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture(scope='session')
def ref_fixtures():
    """Golden outputs generated from the (shimmed) reference implementation."""
    path = os.path.join(FIXTURES, 'reference_boss.npz')
    if not os.path.exists(path):
        pytest.skip('reference fixtures not generated (run tools/run_reference_baseline.py)')
    return np.load(path, allow_pickle=True)


@pytest.fixture(scope='session')
def boss_config():
    import yaml
    with open(os.path.join(REPO, 'configs', 'boss_config.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['model']['dir'] = REPO
    cfg['data']['dir'] = REPO
    return cfg
