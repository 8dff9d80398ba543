#!/usr/bin/env python
"""Execute the multi-process `distributed_init` path end-to-end on CPU.

The reference's multi-host story is `mpirun -n N cobaya-run` — N
cooperating processes (victor/README.md:30). The on-device equivalent is
`parallel.mesh.distributed_init` → `jax.distributed.initialize`, after
which the SAME single-controller pjit programs span every host's devices.
The single-host code paths are covered by the virtual 8-device mesh tests;
this probe is the one place the *multi-process* branch actually runs:

  parent:  spawns two child processes with a 127.0.0.1 coordinator;
  child i: `distributed_init(coordinator, num_processes=2, process_id=i)`
           (the `jax.distributed.initialize` branch), then over the
           resulting 2-process global mesh runs
             1. the sharded batched BOSS likelihood — each process checks
                its addressable shard bit-matches the locally-computed
                unsharded values (no collectives: the "independent MPI
                chains" model);
             2. `cross_chain_rhat` with the chain axis sharded across
                processes — the reductions lower to REAL cross-process
                collectives (gloo on XLA:CPU), checked against the
                single-process value (the Gelman-Rubin check is the one
                statistic the reference's MPI processes communicate for).

Prints one JSON line per child plus a summary; exits non-zero on any
failure or timeout. CPU-only (forces the cpu platform in-process before
any device query); safe to run alongside accelerator work.

Usage:  python tools/distributed_probe.py [--timeout 900]
"""

import argparse
import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def child(process_id: int, coordinator: str, num_processes: int) -> None:
    import jax
    # before any device query, so the CPU backend is the one initialised
    jax.config.update('jax_platforms', 'cpu')

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import yaml
    from victor_tpu.io import build_tables
    from victor_tpu.likelihood.batched import (make_batched_loglike,
                                               make_sharded_loglike)
    from victor_tpu.parallel import make_mesh
    from victor_tpu.parallel.mesh import cross_chain_rhat, distributed_init

    # --- the branch under test ------------------------------------------
    distributed_init(coordinator_address=coordinator,
                     num_processes=num_processes, process_id=process_id)
    assert jax.process_count() == num_processes, jax.process_count()
    n_dev = len(jax.devices())
    assert n_dev >= num_processes, (n_dev, num_processes)

    with open(os.path.join(REPO, 'configs', 'boss_config.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['model']['dir'] = REPO
    cfg['data']['dir'] = REPO
    bundle = build_tables(cfg['model'], cfg['data'])
    names = ['fsigma8', 'beta', 'sigma_v', 'epsilon']

    # --- 1. sharded likelihood batch over the global mesh ---------------
    mesh = make_mesh(('walkers',))
    n = 16 * n_dev
    rng = np.random.default_rng(0)                 # identical on all procs
    theta = np.column_stack([
        rng.uniform(0.3, 0.6, n), rng.uniform(0.25, 0.55, n),
        rng.uniform(250.0, 450.0, n), rng.uniform(0.9, 1.1, n)])
    # exact evaluation on BOTH sides: this probe pins the DISTRIBUTED
    # machinery, and the f32 Chebyshev fast path's Clenshaw recurrences
    # fuse differently under partitioned lowering (>1e-6 relative drift vs
    # the single-device program — observed 2026-08-20), which would make
    # the shard comparison test the fast mode's sensitivity instead
    sharded = make_sharded_loglike(bundle, names, mesh, axis='walkers',
                                   gradient_free=False)
    # numpy can't carry a cross-process sharding: build the global array
    # from the (identical-on-every-process) host data explicitly
    tsh = NamedSharding(mesh, P('walkers'))
    theta_g = jax.make_array_from_callback(
        theta.shape, tsh, lambda idx: theta[idx].astype(np.float32))
    lnl_global = sharded(theta_g)[0]
    # single-process jitted reference on the LOCAL default device only
    lnl_ref = np.asarray(make_batched_loglike(bundle, names,
                                              gradient_free=False)(
        jax.numpy.asarray(theta, dtype=jax.numpy.float32))[0])
    shard_ok, shard_bit = True, True
    for s in lnl_global.addressable_shards:
        sl = s.index[0]
        vals = np.asarray(s.data)
        shard_bit &= bool(np.array_equal(vals, lnl_ref[sl]))
        # partitioned lowering may fuse differently from the single-device
        # program — same discipline as chip_smoke.py --devices 4
        shard_ok &= bool(np.allclose(vals, lnl_ref[sl], rtol=1e-6))
    assert np.all(np.isfinite(lnl_ref)), 'non-finite reference lnL'

    # --- 2. cross-process Gelman-Rubin ----------------------------------
    chains = rng.standard_normal((4, 200, len(names))).astype(np.float64) \
        + rng.uniform(-0.1, 0.1, (4, 1, len(names)))
    cmesh = make_mesh(('chains',))
    csh = NamedSharding(cmesh, P('chains'))
    rep = NamedSharding(cmesh, P())
    chains_g = jax.make_array_from_callback(
        chains.shape, csh, lambda idx: chains[idx])
    rhat_sh = np.asarray(jax.jit(cross_chain_rhat, in_shardings=csh,
                                 out_shardings=rep)(chains_g))
    rhat_ref = np.asarray(cross_chain_rhat(jax.numpy.asarray(chains)))
    rhat_ok = bool(np.allclose(rhat_sh, rhat_ref, rtol=1e-12, atol=1e-12))

    ok = bool(shard_ok and rhat_ok)
    print(json.dumps({
        'child': process_id, 'ok': ok,
        'process_count': jax.process_count(), 'n_devices': n_dev,
        'likelihood_shards_match': shard_ok,
        'likelihood_shards_bit_equal': shard_bit,
        'rhat_cross_process_matches': rhat_ok,
        'rhat_max': round(float(np.max(rhat_sh)), 6),
    }), flush=True)
    sys.exit(0 if ok else 1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--timeout', type=float, default=900.0)
    ap.add_argument('--child', action='store_true')
    ap.add_argument('--process-id', type=int)
    ap.add_argument('--coordinator')
    ap.add_argument('--num-processes', type=int, default=2)
    args = ap.parse_args()

    if args.child:
        child(args.process_id, args.coordinator, args.num_processes)
        return

    with socket.socket() as s:                     # free localhost port
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    coord = f'127.0.0.1:{port}'
    env = dict(os.environ)
    env.pop('JAX_PLATFORMS', None)                 # child forces cpu itself
    # one device per process (the realistic multi-host proxy): an inherited
    # --xla_force_host_platform_device_count=8 (the test suite's virtual
    # mesh) would give 2x8=16 global devices and over-partition the probe's
    # small arrays — strip it and pin our own
    flags = [f for f in env.get('XLA_FLAGS', '').split()
             if not f.startswith('--xla_force_host_platform_device_count')]
    env['XLA_FLAGS'] = ' '.join(
        flags + ['--xla_force_host_platform_device_count=1'])
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--child',
         '--process-id', str(i), '--coordinator', coord,
         '--num-processes', str(args.num_processes)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for i in range(args.num_processes)]
    outs, fails = [], 0
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += '\n[parent] TIMEOUT'
        outs.append(out)
        if p.returncode != 0:
            fails += 1
    for out in outs:
        # surface each child's final JSON line (and everything on failure)
        lines = [ln for ln in out.splitlines() if ln.strip()]
        tail = [ln for ln in lines if ln.startswith('{')]
        print(tail[-1] if tail and fails == 0 else out, flush=True)
    print(json.dumps({'check': 'distributed_init_two_process',
                      'ok': fails == 0,
                      'n_processes': args.num_processes}), flush=True)
    sys.exit(0 if fails == 0 else 1)


if __name__ == '__main__':
    main()
