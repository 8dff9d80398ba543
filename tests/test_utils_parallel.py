"""utils.profiling and parallel.mesh helper coverage."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from victor_tpu.parallel import (cross_chain_rhat, make_mesh, replicate,
                                 shard_along, distributed_init)
from victor_tpu.utils import (debug_nans, phase_times, reset_phase_times,
                              throughput, timed)


class TestMesh:
    def test_make_mesh_shapes(self):
        devs = jax.devices()
        assert len(devs) == 8
        m2 = make_mesh(('chains', 'walkers'))
        assert m2.devices.shape in ((2, 4), (4, 2))
        m1 = make_mesh(('walkers',))
        assert m1.devices.shape == (8,)
        with pytest.raises(ValueError):
            make_mesh(('a', 'b'), shape=(3, 2))

    def test_make_mesh_enumeration_order(self):
        """Devices fill the mesh in enumeration order (all-to-all NVLink
        makes every placement equal); an explicit list keeps its order."""
        devs = jax.devices()
        m = make_mesh(('chains', 'walkers'))
        assert list(m.devices.flat) == devs
        rev = make_mesh(('walkers',), devices=devs[::-1])
        assert list(rev.devices.flat) == devs[::-1]

    def test_shard_and_replicate(self):
        mesh = make_mesh(('walkers',))
        x = jnp.arange(16.0).reshape(16, 1)
        xs = shard_along(x, mesh, ['walkers'])
        assert not xs.sharding.is_fully_replicated
        xr = replicate(x, mesh)
        assert xr.sharding.is_fully_replicated
        np.testing.assert_array_equal(np.asarray(xs), np.asarray(x))

    def test_distributed_init_noop(self):
        distributed_init()                      # single-host: must be a no-op
        distributed_init(num_processes=1)
        # a coordinator with no process count is a misconfigured multi-host
        # launch: fail fast instead of silently running single-host
        with pytest.raises(ValueError, match='num_processes'):
            distributed_init(coordinator_address='host0:1234')
        # a coordinator with no process count is a misconfigured multi-host
        # launch: fail fast instead of silently running single-host
        with pytest.raises(ValueError, match='num_processes'):
            distributed_init(coordinator_address='host0:1234')

    def test_cross_chain_rhat_converged_vs_not(self):
        rng = np.random.default_rng(0)
        good = rng.normal(0, 1, (8, 400, 2))
        r = np.asarray(cross_chain_rhat(jnp.asarray(good)))
        assert np.all(r < 1.03)
        bad = good + np.arange(8)[:, None, None]     # separated chains
        r2 = np.asarray(cross_chain_rhat(jnp.asarray(bad)))
        assert np.all(r2 > 1.5)

    def test_cross_chain_rhat_stuck_chains_is_inf(self):
        """Every chain constant (a stuck sampler, W = 0) must read as
        'not converged' (+inf) rather than NaN — NaN fails the
        rhat - 1 < stop convergence test silently with no diagnostic."""
        stuck = np.ones((4, 100, 2))
        r = np.asarray(cross_chain_rhat(jnp.asarray(stuck)))
        assert np.all(np.isinf(r))
        short = np.random.default_rng(0).normal(size=(4, 1, 2))
        r1 = np.asarray(cross_chain_rhat(jnp.asarray(short)))
        assert not np.any(np.isnan(r1))

    def test_cross_chain_rhat_stuck_chains_is_inf(self):
        """Every chain constant (a stuck sampler, W = 0) must read as
        'not converged' (+inf) rather than NaN — NaN fails the
        `rhat - 1 < stop` convergence test silently with no diagnostic."""
        stuck = np.ones((4, 100, 2))
        r = np.asarray(cross_chain_rhat(jnp.asarray(stuck)))
        assert np.all(np.isinf(r))
        short = np.random.default_rng(0).normal(size=(4, 1, 2))
        r1 = np.asarray(cross_chain_rhat(jnp.asarray(short)))
        assert not np.any(np.isnan(r1))


class TestProfiling:
    def test_timed_and_phase_times(self):
        reset_phase_times()
        with timed('unit-test-phase'):
            _ = jnp.arange(10).sum()
        pt = phase_times()
        assert pt['unit-test-phase']['count'] == 1
        assert pt['unit-test-phase']['total_s'] >= 0
        reset_phase_times()
        assert phase_times() == {}

    def test_throughput(self):
        f = jax.jit(lambda x: (x * 2).sum())
        out, calls_per_sec = throughput(f, jnp.arange(100.0), reps=3)
        assert float(out) == float(jnp.arange(100.0).sum() * 2)
        assert calls_per_sec > 0

    def test_debug_nans_toggle(self):
        debug_nans(True)
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: x / 0.0 * 0.0)(jnp.asarray(0.0))
        debug_nans(False)
        assert bool(jnp.isnan(jax.jit(lambda x: x / 0.0 * 0.0)(jnp.asarray(0.0))))


class TestCompileCache:
    """enable_persistent_cache: JAX_COMPILATION_CACHE_DIR wins and the code
    then sets nothing; otherwise the cache goes to the fixed repo path."""

    SCRIPT = (
        'import jax, jax.numpy as jnp\n'
        'from victor_tpu.utils.profiling import enable_persistent_cache\n'
        'enable_persistent_cache(force=True)\n'
        'jax.jit(lambda x: jnp.sin(x) @ x.T)(jnp.ones((64, 64)))'
        '.block_until_ready()\n'
        'print(jax.config.jax_compilation_cache_dir)\n')

    def _run(self, env_update, drop=()):
        import os
        import subprocess
        import sys
        env = {k: v for k, v in os.environ.items() if k not in drop}
        env.update(JAX_PLATFORMS='cpu', **env_update)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        out = subprocess.run([sys.executable, '-c', self.SCRIPT], env=env,
                             cwd=repo, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr
        return out.stdout.strip().splitlines()[-1]

    def test_environment_directory_wins(self, tmp_path):
        got = self._run({'JAX_COMPILATION_CACHE_DIR': str(tmp_path),
                         'JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS': '0',
                         'JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES': '0'})
        assert got == str(tmp_path)
        assert any(n.startswith('jit__lambda') for n in
                   __import__('os').listdir(tmp_path))

    def test_fixed_repo_path_otherwise(self):
        from victor_tpu.utils.profiling import DEFAULT_CACHE_DIR
        got = self._run({}, drop=('JAX_COMPILATION_CACHE_DIR',))
        assert got == DEFAULT_CACHE_DIR
        assert DEFAULT_CACHE_DIR.endswith('/.cache/xla')


@pytest.mark.slow
def test_distributed_init_two_process_probe():
    """The multi-process branch of distributed_init
    (jax.distributed.initialize) must actually execute: two CPU-backend
    processes on a 127.0.0.1 coordinator run the sharded BOSS likelihood
    (each process's addressable shard matches single-process values) and a
    cross-process Gelman-Rubin reduction (real gloo collectives) — the
    reference's `mpirun -n N cobaya-run` analogue
    (tools/distributed_probe.py)."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.join(os.path.dirname(__file__), '..')
    out = subprocess.run(
        [sys.executable, os.path.join(repo, 'tools', 'distributed_probe.py'),
         '--timeout', '800'],
        capture_output=True, text=True, timeout=900, cwd=repo)
    assert out.returncode == 0, out.stdout + out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary == {'check': 'distributed_init_two_process',
                       'ok': True, 'n_processes': 2}
