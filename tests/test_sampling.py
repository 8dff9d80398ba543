"""Sampling subsystem: priors, ensemble sampler, diagnostics, chain IO."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from victor_tpu.sampling import (ParamSpace, init_state, run, make_logpost,
                                 split_rhat, effective_sample_size,
                                 save_checkpoint, load_checkpoint,
                                 export_getdist)
from victor_tpu.sampling import ensemble

COBAYA_BLOCK = {
    'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.05},
                'proposal': 0.02, 'latex': r'f\sigma_8'},
    'beta': {'prior': {'dist': 'uniform', 'min': 0.2, 'max': 0.6},
             'ref': {'dist': 'norm', 'loc': 0.4, 'scale': 0.05}},
    'b': 1.9,
    'aperp': {'value': 'lambda alpha, epsilon: alpha * epsilon**(1/3)'},
    'alpha': 1,
    'epsilon': {'prior': {'dist': 'norm', 'loc': 1.0, 'scale': 0.05}},
}


class TestParamSpace:
    def test_parse(self):
        sp = ParamSpace(COBAYA_BLOCK)
        assert sp.names == ['fsigma8', 'beta', 'epsilon']
        assert sp.fixed == {'b': 1.9, 'alpha': 1.0}
        assert [d.name for d in sp.derived] == ['aperp']

    def test_log_prior(self):
        sp = ParamSpace(COBAYA_BLOCK)
        inside = jnp.asarray([0.5, 0.4, 1.0])
        outside = jnp.asarray([0.5, 0.7, 1.0])
        lp_in = float(sp.log_prior(inside))
        assert np.isfinite(lp_in)
        assert float(sp.log_prior(outside)) == -np.inf
        # uniform densities + standard normal at peak
        expect = -np.log(1.45) - np.log(0.4) - np.log(0.05) - 0.5 * np.log(2 * np.pi)
        np.testing.assert_allclose(lp_in, expect, rtol=1e-12)

    def test_derived_and_full_params(self):
        sp = ParamSpace(COBAYA_BLOCK)
        theta = jnp.asarray([0.45, 0.35, 1.1])
        params = sp.full_params(theta)
        np.testing.assert_allclose(float(params['aperp']), 1.1 ** (1 / 3), rtol=1e-12)
        assert float(params['b']) == 1.9

    def test_sample_ref_in_support(self):
        sp = ParamSpace(COBAYA_BLOCK)
        draws = sp.sample_ref(jax.random.PRNGKey(0), 500)
        lo, hi = sp.bounds()
        assert np.all(np.asarray(draws) >= lo) and np.all(np.asarray(draws) <= hi)

    def test_to_unbounded_finite_at_support_edges_f32(self):
        """Regression: the interval branch clipped u to [1e-12, 1 - 1e-12],
        but 1 - 1e-12 rounds to 1.0 in f32 (the device path) so a draw at (or
        rounding to) the upper prior edge mapped to logit(1) = +inf, which
        NaN-poisons the SMC/NS particle moments downstream. The clip must
        be dtype-safe (epsneg) on both sides, like the halfnorm tiny floor."""
        sp = ParamSpace({
            'u': {'prior': {'dist': 'uniform', 'min': 0.0, 'max': 1.0}},
            'lg': {'prior': {'dist': 'loguniform', 'min': 1e-3, 'max': 10.0}},
            'hn': {'prior': {'dist': 'halfnorm', 'loc': 0.0, 'scale': 1.0}},
        })
        edges = jnp.asarray([[0.0, 1e-3, 0.0],
                             [1.0, 10.0, 5.0]], dtype=jnp.float32)
        y = sp.to_unbounded(edges)
        assert np.all(np.isfinite(np.asarray(y)))
        # round trip stays at (or clamps just inside) the support
        back = np.asarray(sp.to_bounded(y), dtype=np.float64)
        lo, hi = sp.bounds()
        assert np.all(back >= np.asarray(lo) - 1e-6)
        assert np.all(back <= np.where(np.isfinite(hi), hi, np.inf) + 1e-6)

    def test_scalar_ref_gets_start_scatter(self):
        # cobaya scalar refs (ref: 0.47) must NOT start every walker at the
        # identical point (the stretch-move ensemble would be permanently
        # degenerate); scatter falls back to proposal, else 1% of prior width
        block = {
            'a': {'prior': {'dist': 'uniform', 'min': 0.0, 'max': 2.0},
                  'ref': 0.47, 'proposal': 0.02},
            'b': {'prior': {'dist': 'uniform', 'min': 0.0, 'max': 1.0},
                  'ref': 0.5},
        }
        sp = ParamSpace(block)
        assert sp.sampled[0].ref_scale == 0.02           # proposal width
        assert sp.sampled[1].ref_scale == pytest.approx(0.01)  # 1% of width
        draws = np.asarray(sp.sample_ref(jax.random.PRNGKey(0), 64))
        assert draws[:, 0].std() > 0 and draws[:, 1].std() > 0

    def test_loguniform_prior(self):
        from scipy import stats
        block = {'s': {'prior': {'dist': 'loguniform', 'min': 1e-3, 'max': 10.0}}}
        sp = ParamSpace(block)
        x = 0.37
        expect = stats.loguniform.logpdf(x, 1e-3, 10.0)
        np.testing.assert_allclose(float(sp.log_prior(jnp.asarray([x]))),
                                   expect, rtol=1e-10)
        assert float(sp.log_prior(jnp.asarray([5e-4]))) == -np.inf
        draws = np.asarray(sp.sample_ref(jax.random.PRNGKey(1), 2000))
        assert draws.min() >= 1e-3 and draws.max() <= 10.0
        # log-scale uniformity: median of log-draws near the log-midpoint
        mid = 0.5 * (np.log(1e-3) + np.log(10.0))
        assert abs(np.median(np.log(draws)) - mid) < 0.2

    def test_halfnorm_prior(self):
        from scipy import stats
        block = {'s': {'prior': {'dist': 'halfnorm', 'loc': 2.0, 'scale': 3.0}}}
        sp = ParamSpace(block)
        x = 4.5
        expect = stats.halfnorm.logpdf(x, loc=2.0, scale=3.0)
        np.testing.assert_allclose(float(sp.log_prior(jnp.asarray([x]))),
                                   expect, rtol=1e-10)
        assert float(sp.log_prior(jnp.asarray([1.9]))) == -np.inf

    def test_uniform_ref(self):
        """A cobaya `ref: {dist: uniform, min, max}` must start points inside
        that window, not silently scatter them over the whole prior."""
        block = {'a': {'prior': {'dist': 'uniform', 'min': 0.0, 'max': 10.0},
                       'ref': {'dist': 'uniform', 'min': 4.9, 'max': 5.1}}}
        sp = ParamSpace(block)
        draws = np.asarray(sp.sample_ref(jax.random.PRNGKey(0), 500))
        assert draws.min() >= 4.9 and draws.max() <= 5.1

    def test_ref_without_dist_means_norm(self):
        # cobaya's {loc, scale} shorthand: previously ignored (prior draws)
        block = {'a': {'prior': {'dist': 'uniform', 'min': 0.0, 'max': 10.0},
                       'ref': {'loc': 5.0, 'scale': 0.01}}}
        sp = ParamSpace(block)
        draws = np.asarray(sp.sample_ref(jax.random.PRNGKey(0), 200))
        assert abs(draws.mean() - 5.0) < 0.05 and draws.std() < 0.05

    def test_unsupported_ref_dist_errors(self):
        from victor_tpu.errors import InputError
        block = {'a': {'prior': {'dist': 'uniform', 'min': 0.0, 'max': 1.0},
                       'ref': {'dist': 'beta', 'a': 2, 'b': 2}}}
        with pytest.raises(InputError):
            ParamSpace(block)

    def test_halfnorm_boundary_finite_in_f32(self):
        """to_unbounded at x == lo must stay finite in f32 (the device path):
        the old 1e-300 floor underflows to 0.0 and produced log(0) = -inf."""
        block = {'s': {'prior': {'dist': 'halfnorm', 'loc': 2.0, 'scale': 3.0}}}
        sp = ParamSpace(block)
        y = sp.to_unbounded(jnp.asarray([2.0], dtype=jnp.float32))
        assert np.all(np.isfinite(np.asarray(y)))

    def test_unbounded_transforms_new_dists(self):
        # round-trip + change-of-variables normalization: the pushforward
        # density exp(logprior(theta(y)) + logjac(y)) must integrate to 1
        # over the unbounded coordinate
        specs = {
            's': {'prior': {'dist': 'loguniform', 'min': 1e-2, 'max': 4.0}},
            't': {'prior': {'dist': 'halfnorm', 'loc': 1.0, 'scale': 2.0}},
        }
        sp2 = ParamSpace(specs)
        theta = jnp.asarray([[0.5, 2.5], [3.0, 1.1]])
        np.testing.assert_allclose(
            np.asarray(sp2.to_bounded(sp2.to_unbounded(theta))),
            np.asarray(theta), rtol=1e-10)
        yy = np.linspace(-40, 40, 40001)
        for name, spec in specs.items():
            sp = ParamSpace({name: spec})
            g = jnp.asarray(yy[:, None])
            dens = np.exp(np.asarray(sp.log_prior(sp.to_bounded(g))
                                     + sp.log_jacobian(g)))
            np.testing.assert_allclose(np.trapezoid(dens, yy), 1.0, rtol=1e-4)


def _gaussian_logpost(mean, cov_inv):
    def fn(coords):
        d = coords - mean
        lnp = -0.5 * jnp.einsum('wi,ij,wj->w', d, cov_inv, d)
        return lnp, jnp.zeros((coords.shape[0], 1))
    return fn


class TestJitFnCache:
    def test_lru_bound_and_refresh(self):
        from victor_tpu.sampling.targets import JitFnCache
        c = JitFnCache(maxsize=3)
        for k in 'abc':
            c.setdefault(k, {k: 1})
        assert list(c) == ['a', 'b', 'c']
        c.setdefault('a', {'stale': True})   # hit: refreshes, keeps value
        assert c['a'] == {'a': 1}
        c.setdefault('d', {})                # evicts the LRU entry ('b')
        assert 'b' not in c and list(c)[-1] == 'd' and 'a' in c
        assert len(c) == 3

    def test_direct_setitem_bounded(self):
        from victor_tpu.sampling.targets import JitFnCache
        c = JitFnCache(maxsize=2)
        c['x'] = 1
        c['y'] = 2
        c['z'] = 3
        assert len(c) == 2 and 'x' not in c


class TestEnsemble:
    def test_recovers_gaussian(self):
        mean = jnp.asarray([1.0, -2.0])
        cov = np.array([[1.0, 0.6], [0.6, 2.0]])
        logpost = _gaussian_logpost(mean, jnp.asarray(np.linalg.inv(cov)))
        key = jax.random.PRNGKey(1)
        x0 = mean + jax.random.normal(key, (64, 2))
        state = init_state(logpost, x0, key)
        state, (chain, lnp, aux) = jax.jit(
            lambda s: run(logpost, s, 3000))(state)
        flat = np.asarray(chain[500:]).reshape(-1, 2)
        np.testing.assert_allclose(flat.mean(axis=0), np.asarray(mean), atol=0.1)
        np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.3)
        rhat = split_rhat(np.asarray(chain[500:]))
        assert np.all(rhat < 1.05)
        ess = effective_sample_size(np.asarray(chain[500:]))
        assert np.all(ess > 100)
        acc = float(np.mean(np.asarray(state.n_accepted)) / float(state.n_steps))
        assert 0.2 < acc < 0.9

    def test_deterministic(self):
        logpost = _gaussian_logpost(jnp.zeros(2), jnp.eye(2))
        key = jax.random.PRNGKey(7)
        x0 = jax.random.normal(key, (16, 2))
        s1 = init_state(logpost, x0, key)
        s2 = init_state(logpost, x0, key)
        _, (c1, _, _) = run(logpost, s1, 20)
        _, (c2, _, _) = run(logpost, s2, 20)
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))

    def test_thin_records_every_kth_state(self):
        logpost = _gaussian_logpost(jnp.zeros(2), jnp.eye(2))
        key = jax.random.PRNGKey(7)
        x0 = jax.random.normal(key, (16, 2))
        _, (c1, _, _) = run(logpost, init_state(logpost, x0, key), 20)
        _, (c2, _, _) = run(logpost, init_state(logpost, x0, key), 20, thin=2)
        assert c2.shape[0] == 10
        # thinning changes only the recording, not the step sequence
        np.testing.assert_array_equal(np.asarray(c2), np.asarray(c1)[1::2])
        # thin > n_steps used to yield a zero-length scan that silently
        # never advanced the state (an infinite loop in the runner)
        with pytest.raises(ValueError):
            run(logpost, init_state(logpost, x0, key), 5, thin=2)


class TestChainIO:
    def test_checkpoint_roundtrip_and_resume(self, tmp_path):
        logpost = _gaussian_logpost(jnp.zeros(2), jnp.eye(2))
        key = jax.random.PRNGKey(3)
        x0 = jax.random.normal(key, (16, 2))
        state = init_state(logpost, x0, key)
        state, _ = run(logpost, state, 10)
        path = str(tmp_path / 'ckpt.npz')
        save_checkpoint(path, state)
        restored, chain, _, _ = load_checkpoint(path)
        # resumed run continues bit-identically with the original
        _, (c_orig, _, _) = run(logpost, state, 10)
        _, (c_res, _, _) = run(logpost, restored, 10)
        np.testing.assert_array_equal(np.asarray(c_orig), np.asarray(c_res))

    def test_getdist_export(self, tmp_path):
        sp = ParamSpace(COBAYA_BLOCK)
        n_steps, n_walkers = 5, 8
        chain = np.random.default_rng(0).normal(
            [0.47, 0.4, 1.0], 0.02, (n_steps, n_walkers, 3))
        lnp = -np.ones((n_steps, n_walkers))
        aux = np.full((n_steps, n_walkers, 1), 65.0)
        root = str(tmp_path / 'chains' / 'test')
        chain_file = export_getdist(root, sp, chain, lnp, aux,
                                    aux_names=['chi2_ccf_correct'])
        table = np.loadtxt(chain_file)
        # columns: weight, -lnp, 3 sampled, aperp derived, chi2
        assert table.shape == (n_steps * n_walkers, 2 + 3 + 1 + 1)
        np.testing.assert_allclose(table[:, 0], 1.0)
        np.testing.assert_allclose(table[:, 1], 1.0)
        np.testing.assert_allclose(table[:, -1], 65.0)
        # aperp column consistent with the lambda
        np.testing.assert_allclose(table[:, 5],
                                   table[:, 4] * 0 + chain.reshape(-1, 3)[:, 2] ** (1 / 3),
                                   rtol=1e-6)
        names = open(root + '.paramnames').read().splitlines()
        assert names[0].startswith('fsigma8')
        assert any(line.startswith('aperp*') for line in names)
        ranges = open(root + '.ranges').read().splitlines()
        assert ranges[0].split() == ['fsigma8', '0.05', '1.5']

    def test_getdist_export_per_chain_files(self, tmp_path):
        """cobaya/MPI layout: one <root>.<i>.txt per chain group, so GetDist
        sees N chains and can compute cross-chain R-hat
        (reference config/boss_cobaya_config.yaml:1)."""
        sp = ParamSpace(COBAYA_BLOCK)
        n_steps, n_walkers = 5, 8
        chain = np.random.default_rng(0).normal(
            [0.47, 0.4, 1.0], 0.02, (n_steps, n_walkers, 3))
        lnp = -np.ones((n_steps, n_walkers))
        aux = np.full((n_steps, n_walkers, 1), 65.0)
        root = str(tmp_path / 'chains' / 'test')
        export_getdist(root, sp, chain, lnp, aux,
                       aux_names=['chi2_ccf_correct'], n_chain_files=4)
        tables = [np.loadtxt(f'{root}.{i}.txt') for i in range(1, 5)]
        assert not os.path.exists(f'{root}.5.txt')
        assert all(t.shape == (n_steps * 2, 7) for t in tables)
        # every (step, walker) row lands in exactly one file; walker w -> file w//2
        np.testing.assert_allclose(
            np.sort(np.concatenate([t[:, 2] for t in tables])),
            np.sort(chain[..., 0].reshape(-1)), rtol=1e-6)
        np.testing.assert_allclose(
            np.sort(tables[0][:, 2]),
            np.sort(chain[:, :2, 0].reshape(-1)), rtol=1e-6)
        assert os.path.exists(root + '.paramnames')
        assert os.path.exists(root + '.ranges')


class TestEndToEndMCMC:
    def test_short_boss_run(self, boss_config, tmp_path):
        """Tiny smoke run of the full runner on the BOSS likelihood."""
        from victor_tpu.io import build_tables
        from victor_tpu.sampling import run_mcmc
        bundle = build_tables(boss_config['model'], boss_config['data'])
        block = {
            'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                        'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.02}},
            'beta': {'prior': {'dist': 'uniform', 'min': 0.2, 'max': 0.6},
                     'ref': {'dist': 'norm', 'loc': 0.4, 'scale': 0.02}},
            'sigma_v': 380.0,
            'epsilon': 1.0,
        }
        res = run_mcmc(bundle, block, n_walkers=8, max_steps=6, check_every=3,
                       rhat_stop=0.0, seed=2,
                       output=str(tmp_path / 'chains' / 'boss'),
                       checkpoint=str(tmp_path / 'ckpt.npz'))
        assert res.chain.shape == (6, 8, 2)
        assert np.all(np.isfinite(res.log_prob))
        assert os.path.exists(tmp_path / 'chains' / 'boss.1.txt')
        assert os.path.exists(tmp_path / 'ckpt.npz')

        # resume with the checkpoint already satisfying max_steps: the
        # segment loop never runs, but the result must report the chain's
        # R-hat (a rhat=inf initializer here read as non-convergence), and
        # the second call must reuse the cached jitted runner functions
        from victor_tpu.sampling.runner import _ENSEMBLE_RUNNERS
        n_cached = len(_ENSEMBLE_RUNNERS)
        res2 = run_mcmc(bundle, block, n_walkers=8, max_steps=6,
                        check_every=3, rhat_stop=0.0, seed=2,
                        checkpoint=str(tmp_path / 'ckpt.npz'), resume=True)
        assert res2.chain.shape == (6, 8, 2)      # nothing appended
        assert np.all(np.isfinite(res2.rhat))
        assert len(_ENSEMBLE_RUNNERS) == n_cached


class TestNUTS:
    def test_checkpoint_scheme_covers_recursive_uturn_pairs(self):
        """The iterative U-turn bookkeeping must reproduce exactly the
        (leftmost, rightmost) leaf pairs of every internal node of the
        recursive tree: store even leaf m at slot popcount(m); at odd leaf n
        with t trailing one-bits, check slots popcount(n >> t) .. popcount(n)-1."""
        def recursive_pairs(lo, size):
            if size == 1:
                return set()
            half = size // 2
            return ({(lo, lo + size - 1)}
                    | recursive_pairs(lo, half)
                    | recursive_pairs(lo + half, half))

        for depth in range(1, 8):
            slots = {}
            checked = set()
            for n in range(2 ** depth):
                if n % 2 == 0:
                    slots[bin(n).count('1')] = n
                else:
                    t = len(bin(n)) - len(bin(n).rstrip('1'))
                    idx_min = bin(n >> t).count('1')
                    idx_max = bin(n).count('1') - 1
                    for j in range(idx_min, idx_max + 1):
                        checked.add((slots[j], n))
            assert checked == recursive_pairs(0, 2 ** depth), f'depth {depth}'

    def test_nuts_recovers_correlated_gaussian(self):
        from victor_tpu.sampling import nuts
        cov = np.array([[1.0, 0.95 * 3.0], [0.95 * 3.0, 9.0]])
        ci = jnp.asarray(np.linalg.inv(cov))

        def logpost(y):
            return -0.5 * y @ ci @ y, jnp.zeros((1,))

        key = jax.random.PRNGKey(4)
        y0 = jax.random.normal(key, (8, 2)) * jnp.asarray([1.0, 3.0])
        states, (ys, lnps, _) = jax.jit(lambda y, k: nuts.run_nuts(
            logpost, y, k, n_warmup=300, n_samples=500, max_depth=8))(y0, key)
        chain = np.asarray(ys).transpose(1, 0, 2)
        assert np.all(np.isfinite(np.asarray(lnps)))
        assert np.all(split_rhat(chain) < 1.02)
        flat = chain.reshape(-1, 2)
        np.testing.assert_allclose(flat.mean(axis=0), 0.0, atol=0.15)
        np.testing.assert_allclose(np.cov(flat.T), cov, rtol=0.2, atol=0.2)
        assert np.all(effective_sample_size(chain) > 800)

    def test_nuts_segments_bitexact_vs_monolithic(self):
        from victor_tpu.sampling import nuts
        mean = jnp.asarray([1.0, -2.0])
        ci = jnp.asarray(np.linalg.inv(np.array([[1.0, 0.6], [0.6, 2.0]])))

        def logpost(y):
            d = y - mean
            return -0.5 * d @ ci @ d, jnp.zeros((1,))

        key = jax.random.PRNGKey(5)
        y0 = mean + jax.random.normal(key, (4, 2))
        keys = jax.random.split(key, 4)
        n_warmup, n_samples = 12, 9
        _, (ys_mono, _, _) = jax.jit(lambda y, ks: nuts.run_nuts(
            logpost, y, keys=ks, n_warmup=n_warmup, n_samples=n_samples,
            max_depth=6))(y0, keys)

        from victor_tpu.sampling import hmc
        states = hmc.init_chains(logpost, y0, keys)
        recs, i0 = [], 0
        seg = jax.jit(lambda st, i: nuts.run_segment(
            logpost, st, i, 7, n_warmup=n_warmup, max_depth=6))
        while i0 < n_warmup + n_samples:
            states, (qs, _, _) = seg(states, jnp.asarray(i0, jnp.int32))
            recs.append(np.asarray(qs))
            i0 += 7
        ys_seg = np.concatenate(recs, axis=1)[:, n_warmup:n_warmup + n_samples]
        np.testing.assert_array_equal(ys_seg, np.asarray(ys_mono))

    def test_nuts_sharded_on_mesh(self):
        """NUTS chains sharded over the 8-device mesh: the batched
        while_loops (tree doubling + subtree build) must partition cleanly
        and reproduce the unsharded run."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        from victor_tpu.parallel import make_mesh
        from victor_tpu.sampling import nuts
        cov = np.array([[1.0, 0.6], [0.6, 2.0]])
        ci = jnp.asarray(np.linalg.inv(cov))

        def logpost(y):
            return -0.5 * y @ ci @ y, jnp.zeros((1,))

        key = jax.random.PRNGKey(6)
        y0 = jax.random.normal(key, (8, 2))
        keys = jax.random.split(key, 8)
        run = jax.jit(lambda y, ks: nuts.run_nuts(
            logpost, y, keys=ks, n_warmup=20, n_samples=20, max_depth=6))
        _, (ys_ref, _, _) = run(y0, keys)
        mesh = make_mesh(('chains',))
        shard = NamedSharding(mesh, P('chains'))
        _, (ys_sh, _, _) = run(jax.device_put(y0, shard),
                               jax.device_put(keys, shard))
        np.testing.assert_allclose(np.asarray(ys_sh), np.asarray(ys_ref),
                                   rtol=2e-5, atol=1e-6)

    @pytest.mark.slow  # NUTS correctness is covered by the gaussian +
    # bitexact-segment tests above; this adds only the NUTS-x-BOSS graph
    def test_nuts_on_boss(self, boss_config):
        from victor_tpu.io import build_tables
        from victor_tpu.sampling import run_hmc_mcmc
        bundle = build_tables(boss_config['model'], boss_config['data'])
        block = {
            'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                        'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.02}},
            'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0,
        }
        res = run_hmc_mcmc(bundle, block, n_chains=2, n_warmup=6, n_samples=6,
                           seed=0, algorithm='nuts', max_depth=4)
        assert res.chain.shape == (6, 2, 1)
        assert np.all(np.isfinite(res.log_prob))
        lo, hi = res.space.bounds()
        assert np.all(res.chain >= lo) and np.all(res.chain <= hi)


class TestHMC:
    def test_transforms_roundtrip(self):
        sp = ParamSpace(COBAYA_BLOCK)
        theta = jnp.asarray([[0.5, 0.35, 1.05], [1.2, 0.59, 0.9]])
        y = sp.to_unbounded(theta)
        back = sp.to_bounded(y)
        np.testing.assert_allclose(np.asarray(back), np.asarray(theta), rtol=1e-10)
        assert np.all(np.isfinite(np.asarray(sp.log_jacobian(y))))

    def test_hmc_recovers_gaussian(self):
        from victor_tpu.sampling import hmc
        mean = jnp.asarray([1.0, -2.0])
        cov = np.array([[1.0, 0.6], [0.6, 2.0]])
        cov_inv = jnp.asarray(np.linalg.inv(cov))

        def logpost(y):
            d = y - mean
            return -0.5 * d @ cov_inv @ d, jnp.zeros((1,))

        key = jax.random.PRNGKey(0)
        y0 = mean + jax.random.normal(key, (8, 2))
        states, (ys, lnps, auxs) = jax.jit(lambda y, k: hmc.run_hmc(
            logpost, y, k, n_warmup=200, n_samples=500, n_leapfrog=8))(y0, key)
        flat = np.asarray(ys).reshape(-1, 2)
        np.testing.assert_allclose(flat.mean(axis=0), np.asarray(mean), atol=0.12)
        np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.35)
        acc = float(np.mean(np.asarray(states.n_accepted)) / 500)
        assert 0.6 < acc <= 1.0
        # HMC chains should be nearly independent draws: strict R-hat
        chain = np.asarray(ys).transpose(1, 0, 2)
        assert np.all(split_rhat(chain) < 1.02)
        ess = effective_sample_size(chain)
        assert np.all(ess > 1000)  # >25% efficiency from 8x500 draws

    def test_hmc_on_boss(self, boss_config):
        from victor_tpu.io import build_tables
        from victor_tpu.sampling import run_hmc_mcmc
        bundle = build_tables(boss_config['model'], boss_config['data'])
        block = {
            'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                        'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.02}},
            'beta': {'prior': {'dist': 'uniform', 'min': 0.2, 'max': 0.6},
                     'ref': {'dist': 'norm', 'loc': 0.4, 'scale': 0.02}},
            'sigma_v': 380.0, 'epsilon': 1.0,
        }
        res = run_hmc_mcmc(bundle, block, n_chains=2, n_warmup=6, n_samples=6,
                           n_leapfrog=3, seed=0)
        assert res.chain.shape == (6, 2, 2)
        assert np.all(np.isfinite(res.log_prob))
        lo, hi = res.space.bounds()
        assert np.all(res.chain >= lo) and np.all(res.chain <= hi)
        # the recorded log_prob is the THETA-space posterior (lnl + prior),
        # matching the SMC/ensemble exports — NOT the sampler's y-space
        # target, which adds the reparameterisation log-Jacobian
        from victor_tpu.likelihood.core import log_likelihood
        theta = jnp.asarray(res.chain[0, 0])
        params = res.space.full_params(theta)
        lnl, _ = log_likelihood(bundle.tables, bundle.spec,
                                bundle.theory_opts, bundle.fit_opts, params)
        expect = float(lnl) + float(res.space.log_prior(theta))
        np.testing.assert_allclose(res.log_prob[0, 0], expect, rtol=1e-5)

    def test_hmc_dense_mass_on_correlated_gaussian(self):
        """The staged dense-mass adaptation must handle a rho=0.95 valley
        (diagonal-mass HMC mixes ~20x slower there)."""
        from victor_tpu.sampling import hmc
        cov = np.array([[1.0, 0.95 * 3.0], [0.95 * 3.0, 9.0]])
        ci = jnp.asarray(np.linalg.inv(cov))

        def logpost(y):
            return -0.5 * y @ ci @ y, jnp.zeros((1,))

        key = jax.random.PRNGKey(2)
        y0 = jax.random.normal(key, (8, 2)) * jnp.asarray([1.0, 3.0])
        states, (ys, _, _) = jax.jit(lambda y, k: hmc.run_hmc(
            logpost, y, k, n_warmup=300, n_samples=500, n_leapfrog=8))(y0, key)
        chain = np.asarray(ys).transpose(1, 0, 2)
        assert np.all(split_rhat(chain) < 1.02)
        flat = chain.reshape(-1, 2)
        np.testing.assert_allclose(np.cov(flat.T), cov, rtol=0.2, atol=0.15)
        # the adapted metric should absorb the correlation: high ESS
        assert np.all(effective_sample_size(chain) > 1000)

    def test_hmc_samples_loguniform_halfnorm_priors(self):
        """HMC in the unbounded reparameterisation recovers the prior itself
        when the likelihood is flat — exercising the loguniform/halfnorm
        logit/log transforms and their Jacobians end-to-end."""
        from victor_tpu.sampling import hmc
        sp = ParamSpace({
            's': {'prior': {'dist': 'loguniform', 'min': 0.01, 'max': 10.0}},
            't': {'prior': {'dist': 'halfnorm', 'loc': 1.0, 'scale': 2.0}},
        })

        def logpost_y(y):
            theta = sp.to_bounded(y)
            return sp.log_prior(theta) + sp.log_jacobian(y), jnp.zeros((1,))

        key = jax.random.PRNGKey(7)
        y0 = sp.to_unbounded(sp.sample_ref(key, 8))
        _, (ys, _, _) = jax.jit(lambda y, k: hmc.run_hmc(
            logpost_y, y, k, n_warmup=200, n_samples=600, n_leapfrog=8))(y0, key)
        draws = np.asarray(sp.to_bounded(ys)).reshape(-1, 2)
        assert draws[:, 0].min() >= 0.01 and draws[:, 0].max() <= 10.0
        assert draws[:, 1].min() >= 1.0
        # loguniform: E[log s] = log-midpoint; halfnorm: E[t] = loc+scale*sqrt(2/pi)
        np.testing.assert_allclose(np.log(draws[:, 0]).mean(),
                                   0.5 * (np.log(0.01) + np.log(10.0)), atol=0.25)
        np.testing.assert_allclose(draws[:, 1].mean(),
                                   1.0 + 2.0 * np.sqrt(2 / np.pi), atol=0.15)

    def test_hmc_segments_bitexact_vs_monolithic(self):
        """Segmented dispatch (runner-style) must reproduce one monolithic
        warmup+sample scan bit-for-bit: stage transitions key on the global
        step index."""
        from victor_tpu.sampling import hmc
        mean = jnp.asarray([1.0, -2.0])
        ci = jnp.asarray(np.linalg.inv(np.array([[1.0, 0.6], [0.6, 2.0]])))

        def logpost(y):
            d = y - mean
            return -0.5 * d @ ci @ d, jnp.zeros((1,))

        key = jax.random.PRNGKey(3)
        y0 = mean + jax.random.normal(key, (4, 2))
        keys = jax.random.split(key, 4)
        n_warmup, n_samples = 20, 15
        _, (ys_mono, lnp_mono, _) = jax.jit(lambda y, ks: hmc.run_hmc(
            logpost, y, keys=ks, n_warmup=n_warmup, n_samples=n_samples,
            n_leapfrog=4))(y0, keys)

        states = hmc.init_chains(logpost, y0, keys)
        recs = []
        i0 = 0
        seg = jax.jit(lambda st, i: hmc.run_segment(
            logpost, st, i, 7, n_warmup=n_warmup, n_leapfrog=4))
        seg_last = jax.jit(lambda st, i: hmc.run_segment(
            logpost, st, i, 35 - 28, n_warmup=n_warmup, n_leapfrog=4))
        while i0 < n_warmup + n_samples:
            fn = seg if i0 + 7 <= 35 else seg_last
            states, (qs, lnps, auxs) = fn(states, jnp.asarray(i0, jnp.int32))
            recs.append((np.asarray(qs), np.asarray(lnps)))
            i0 += 7
        ys_seg = np.concatenate([r[0] for r in recs], axis=1)[:, n_warmup:]
        lnp_seg = np.concatenate([r[1] for r in recs], axis=1)[:, n_warmup:]
        np.testing.assert_array_equal(ys_seg, np.asarray(ys_mono))
        np.testing.assert_array_equal(lnp_seg, np.asarray(lnp_mono))

    def test_hmc_sharded_on_mesh(self, boss_config):
        """HMC chains sharded across the 8-device CPU mesh must match the
        unsharded run exactly (independent chains, zero collectives)."""
        from victor_tpu.io import build_tables
        from victor_tpu.parallel import make_mesh
        from victor_tpu.sampling import run_hmc_mcmc
        bundle = build_tables(boss_config['model'], boss_config['data'])
        block = {
            'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                        'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.02}},
            'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0,
        }
        mesh = make_mesh(('chains',))
        r_mesh = run_hmc_mcmc(bundle, block, n_chains=8, n_warmup=4,
                              n_samples=4, n_leapfrog=2, seed=0, mesh=mesh)
        r_none = run_hmc_mcmc(bundle, block, n_chains=8, n_warmup=4,
                              n_samples=4, n_leapfrog=2, seed=0)
        assert r_mesh.chain.shape == (4, 8, 1)
        np.testing.assert_allclose(r_mesh.chain, r_none.chain, rtol=5e-6)

    def test_hmc_checkpoint_resume(self, boss_config, tmp_path):
        from victor_tpu.io import build_tables
        from victor_tpu.sampling import run_hmc_mcmc
        bundle = build_tables(boss_config['model'], boss_config['data'])
        block = {
            'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                        'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.02}},
            'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0,
        }
        ckpt = str(tmp_path / 'hmc.npz')
        r1 = run_hmc_mcmc(bundle, block, n_chains=2, n_warmup=4, n_samples=4,
                          n_leapfrog=2, seed=0, checkpoint=ckpt)
        assert os.path.exists(ckpt)
        # resume passes a DIFFERENT n_chains: the checkpoint's actual chain
        # count must win (mesh sizing / chain-file split / acceptance
        # denominator all depend on it)
        r2 = run_hmc_mcmc(bundle, block, n_chains=5, n_warmup=4, n_samples=4,
                          n_leapfrog=2, seed=1, checkpoint=ckpt, resume=True)
        # resumed run starts from the checkpointed positions and appends
        assert r2.chain.shape == (8, 2, 1)
        np.testing.assert_array_equal(r2.chain[:4], r1.chain)


class TestMH:
    """Adaptive random-walk Metropolis (sampling/mh.py) — the on-device
    equivalent of the reference's cobaya MH sampler (victor/README.md:30)."""

    def test_mh_recovers_correlated_gaussian(self):
        """The staged dense-proposal adaptation (cobaya's covariance
        learning role) must recover a rho=0.6 Gaussian at the 0.234
        random-walk acceptance optimum."""
        from victor_tpu.sampling import hmc, mh
        mean = jnp.asarray([1.0, -2.0])
        cov = np.array([[1.0, 0.6 * np.sqrt(2.0)], [0.6 * np.sqrt(2.0), 2.0]])
        ci = jnp.asarray(np.linalg.inv(cov))

        def logpost(y):
            d = y - mean
            return -0.5 * d @ ci @ d, jnp.zeros((1,))

        key = jax.random.PRNGKey(7)
        y0 = mean + jax.random.normal(key, (8, 2))
        keys = jax.random.split(key, 8)
        n_warmup, n_samples = 1000, 3000
        states = mh.init_chains(logpost, y0, keys)
        run = jax.jit(lambda st, i: mh.run_segment(
            logpost, st, i, n_warmup + n_samples, n_warmup=n_warmup))
        states, (ys, lnps, _) = run(states, jnp.zeros((), jnp.int32))
        chain = np.asarray(ys)[:, n_warmup:].transpose(1, 0, 2)
        assert np.all(np.isfinite(np.asarray(lnps)))
        # n_accepted was reset at the warmup->sampling freeze: post-warmup
        # acceptance should sit near the Roberts-Gelman-Gilks 0.234 target
        acc = np.asarray(states.n_accepted) / n_samples
        assert np.all(acc > 0.1) and np.all(acc < 0.45), acc
        assert np.all(split_rhat(chain) < 1.05)
        flat = chain.reshape(-1, 2)
        np.testing.assert_allclose(flat.mean(axis=0), np.asarray(mean),
                                   atol=0.15)
        np.testing.assert_allclose(np.cov(flat.T), cov, rtol=0.25, atol=0.2)
        # random-walk efficiency is ~10-25% per draw in 2D once the proposal
        # covariance matches; require well above "stuck chain" territory
        assert np.all(effective_sample_size(chain) > 500)
        # shares HMCState for checkpoint/segment compatibility; the grad
        # slot must stay the zero placeholder (never read, never filled)
        np.testing.assert_array_equal(np.asarray(states.grad), 0.0)

    def test_mh_never_builds_the_gradient_graph(self):
        """MH's selling point vs HMC: forward-only fast modes keep their
        speedup because jax.grad is never traced. A log-posterior whose
        JVP rule raises proves init+segment stay value-only (hmc.init_chains
        on the same target raises)."""
        from victor_tpu.sampling import hmc, mh

        @jax.custom_jvp
        def forward_only(y):
            return -0.5 * jnp.sum(y ** 2)

        @forward_only.defjvp
        def _jvp(primals, tangents):
            raise RuntimeError('gradient path was traced')

        def logpost(y):
            return forward_only(y), jnp.zeros((1,))

        y0 = jnp.asarray([[0.1, -0.2], [0.3, 0.4]])
        keys = jax.random.split(jax.random.PRNGKey(0), 2)
        states = mh.init_chains(logpost, y0, keys)
        _, (ys, _, _) = jax.jit(lambda st: mh.run_segment(
            logpost, st, jnp.zeros((), jnp.int32), 6, n_warmup=3))(states)
        assert np.all(np.isfinite(np.asarray(ys)))
        with pytest.raises(RuntimeError, match='gradient path'):
            hmc.init_chains(logpost, y0, keys)

    def test_mh_segments_bitexact_vs_monolithic(self):
        """Same global-step-indexed staging as HMC/NUTS: a segmented run
        must be bit-identical to one monolithic dispatch."""
        from victor_tpu.sampling import mh
        mean = jnp.asarray([1.0, -2.0])
        ci = jnp.asarray(np.linalg.inv(np.array([[1.0, 0.6], [0.6, 2.0]])))

        def logpost(y):
            d = y - mean
            return -0.5 * d @ ci @ d, jnp.zeros((1,))

        key = jax.random.PRNGKey(8)
        y0 = mean + jax.random.normal(key, (4, 2))
        keys = jax.random.split(key, 4)
        n_warmup, n_samples = 20, 15
        states0 = mh.init_chains(logpost, y0, keys)
        _, (ys_mono, lnp_mono, _) = jax.jit(lambda st: mh.run_segment(
            logpost, st, jnp.zeros((), jnp.int32), n_warmup + n_samples,
            n_warmup=n_warmup))(states0)

        states = mh.init_chains(logpost, y0, keys)
        recs, i0 = [], 0
        seg = jax.jit(lambda st, i, ln: mh.run_segment(
            logpost, st, i, ln, n_warmup=n_warmup), static_argnums=2)
        while i0 < n_warmup + n_samples:
            length = min(7, n_warmup + n_samples - i0)
            states, (qs, lnps, _) = seg(states, jnp.asarray(i0, jnp.int32),
                                        length)
            recs.append((np.asarray(qs), np.asarray(lnps)))
            i0 += length
        ys_seg = np.concatenate([r[0] for r in recs], axis=1)
        lnp_seg = np.concatenate([r[1] for r in recs], axis=1)
        np.testing.assert_array_equal(ys_seg, np.asarray(ys_mono))
        np.testing.assert_array_equal(lnp_seg, np.asarray(lnp_mono))

    def test_mh_on_boss(self, boss_config):
        """run_hmc_mcmc(algorithm='mh') end-to-end on the real likelihood:
        same runner, checkpoints and chain-record plumbing as HMC."""
        from victor_tpu.io import build_tables
        from victor_tpu.sampling import run_hmc_mcmc
        bundle = build_tables(boss_config['model'], boss_config['data'])
        block = {
            'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                        'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.02}},
            'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0,
        }
        res = run_hmc_mcmc(bundle, block, n_chains=2, n_warmup=8, n_samples=8,
                           seed=0, algorithm='mh', segment_steps=6)
        assert res.chain.shape == (8, 2, 1)
        assert np.all(np.isfinite(res.log_prob))
        lo, hi = res.space.bounds()
        assert np.all(res.chain >= lo) and np.all(res.chain <= hi)
        # recorded log_prob is the THETA-space posterior (parity with the
        # HMC/SMC exports, see test_hmc_on_boss). MH is gradient-free, so
        # it samples the FAST-resolved likelihood ('auto' perf modes) —
        # re-evaluate through the same resolution, and pin that the exact
        # value differs only by the validated fast-mode drift
        from victor_tpu.likelihood.core import log_likelihood
        from victor_tpu.sampling.targets import resolve_target
        theta = jnp.asarray(res.chain[0, 0])
        params = res.space.full_params(theta)
        tbl, loglike_fast, _ = resolve_target(bundle, None, None,
                                              gradient_free=True)
        lnl_fast = loglike_fast(tbl, params)[0]
        expect = float(lnl_fast) + float(res.space.log_prior(theta))
        np.testing.assert_allclose(res.log_prob[0, 0], expect, rtol=1e-10)
        lnl_exact, _ = log_likelihood(bundle.tables, bundle.spec,
                                      bundle.theory_opts, bundle.fit_opts,
                                      params)
        np.testing.assert_allclose(float(lnl_exact), float(lnl_fast),
                                   rtol=1e-4)

    @pytest.mark.slow  # the checkpoint format is HMC's (default-tested) and
    # the staged schedule is pinned by test_mh_segments_bitexact_vs_monolithic
    def test_mh_checkpoint_resume(self, boss_config, tmp_path):
        """MH reuses HMCState, so the HMC checkpoint format resumes it
        exactly (the resumed run extends the first one's chain verbatim)."""
        from victor_tpu.io import build_tables
        from victor_tpu.sampling import run_hmc_mcmc
        bundle = build_tables(boss_config['model'], boss_config['data'])
        block = {
            'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                        'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.02}},
            'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0,
        }
        ckpt = str(tmp_path / 'mh.npz')
        r1 = run_hmc_mcmc(bundle, block, n_chains=2, n_warmup=4, n_samples=4,
                          seed=0, algorithm='mh', checkpoint=ckpt,
                          segment_steps=4)
        assert os.path.exists(ckpt)
        r2 = run_hmc_mcmc(bundle, block, n_chains=2, n_warmup=4, n_samples=4,
                          seed=1, algorithm='mh', checkpoint=ckpt,
                          resume=True, segment_steps=4)
        assert r2.chain.shape == (8, 2, 1)
        np.testing.assert_array_equal(r2.chain[:4], r1.chain)

    @pytest.mark.slow  # the mesh plumbing is run_hmc_mcmc's, default-tested
    # by test_hmc_sharded_on_mesh; MH's step adds no sharding-relevant ops
    def test_mh_sharded_on_mesh(self, boss_config):
        """MH chains sharded across the 8-device CPU mesh must match the
        unsharded run (independent chains, zero collectives — the same
        contract as HMC/NUTS)."""
        from victor_tpu.io import build_tables
        from victor_tpu.parallel import make_mesh
        from victor_tpu.sampling import run_hmc_mcmc
        bundle = build_tables(boss_config['model'], boss_config['data'])
        block = {
            'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                        'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.02}},
            'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0,
        }
        mesh = make_mesh(('chains',))
        r_mesh = run_hmc_mcmc(bundle, block, n_chains=8, n_warmup=4,
                              n_samples=4, seed=0, algorithm='mh', mesh=mesh)
        r_none = run_hmc_mcmc(bundle, block, n_chains=8, n_warmup=4,
                              n_samples=4, seed=0, algorithm='mh')
        assert r_mesh.chain.shape == (4, 8, 1)
        np.testing.assert_allclose(r_mesh.chain, r_none.chain, rtol=5e-6)

    @pytest.mark.slow  # the CLI MH path runs twice in the default tier
    # already (cobaya-nesting + reference-config tests below)
    def test_cli_mh_smoke(self, boss_config, tmp_path, capsys):
        """`run --sampler mh` end-to-end (the cobaya-MH migration path);
        CLI --warmup/--samples override the MH-specific long defaults."""
        import json
        import yaml
        from victor_tpu.__main__ import main
        cfg = dict(boss_config)
        cfg['params'] = {
            'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                        'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.02}},
            'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0,
        }
        cfg['sampler'] = {'kind': 'mh', 'n_chains': 2, 'segment_steps': 8}
        p = tmp_path / 'mh.yaml'
        p.write_text(yaml.safe_dump(cfg))
        main(['run', str(p), '--warmup', '8', '--samples', '8',
              '--seed', '3', '--output', str(tmp_path / 'c' / 'mh')])
        out = json.loads(capsys.readouterr().out)
        assert out['sampler'] == 'mh'
        assert out['n_samples'] == 8
        assert np.isfinite(out['summary']['fsigma8']['mean'])
        # per-chain GetDist files, same layout as cobaya/MPI chains
        assert (tmp_path / 'c' / 'mh.1.txt').exists()
        assert (tmp_path / 'c' / 'mh.2.txt').exists()

    def test_rhat_early_stop_truncates_bitexactly(self):
        """rhat_stop (cobaya's Rminus1_stop role): the run stops once
        split-R-1 clears the threshold, and the recorded draws are the
        bit-exact prefix of the fixed-length run (stopping only
        truncates)."""
        from victor_tpu.sampling import run_hmc_mcmc

        def loglike(params):
            chi2 = params['a'] ** 2 + params['b'] ** 2
            return -0.5 * chi2, chi2

        block = {
            'a': {'prior': {'dist': 'norm', 'loc': 0.0, 'scale': 1.0},
                  'ref': {'dist': 'norm', 'loc': 0.0, 'scale': 0.5}},
            'b': {'prior': {'dist': 'norm', 'loc': 0.0, 'scale': 1.0},
                  'ref': {'dist': 'norm', 'loc': 0.0, 'scale': 0.5}},
        }
        res = run_hmc_mcmc(loglike, block, n_chains=8, n_warmup=100,
                           n_samples=3000, seed=0, algorithm='mh',
                           segment_steps=100, rhat_stop=0.2)
        assert 50 <= res.n_steps < 3000
        assert np.max(res.rhat - 1) < 0.2
        res_full = run_hmc_mcmc(loglike, block, n_chains=8, n_warmup=100,
                                n_samples=res.n_steps + 200, seed=0,
                                algorithm='mh', segment_steps=100)
        np.testing.assert_array_equal(res_full.chain[:res.n_steps],
                                      res.chain)

    def test_cobaya_mcmc_nesting_maps_to_mh(self, boss_config, tmp_path,
                                            monkeypatch, capsys):
        """A cobaya-style `sampler: {mcmc: {...}}` config runs the algorithm
        it asks for — adaptive random-walk Metropolis — with its covmat
        mapped to the proposal seed (cobaya's `mcmc: {covmat: ...}`)."""
        import json
        import yaml
        import victor_tpu.sampling as sampling_mod
        from victor_tpu.__main__ import main

        seen = {}
        real = sampling_mod.run_hmc_mcmc

        def spy(bundle, params_block, **kw):
            seen.update(kw)
            return real(bundle, params_block, **kw)

        monkeypatch.setattr(sampling_mod, 'run_hmc_mcmc', spy)
        cm = tmp_path / 'prop.covmat'
        cm.write_text('# fsigma8\n4.0e-4\n')
        cfg = dict(boss_config)
        cfg['params'] = {
            'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                        'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.02}},
            'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0,
        }
        cfg['sampler'] = {'mcmc': {'max_samples': 100000,
                                   'Rminus1_stop': 0.01,
                                   'covmat': str(cm)},
                          'n_chains': 2}
        p = tmp_path / 'cob.yaml'
        p.write_text(yaml.safe_dump(cfg))
        main(['run', str(p), '--warmup', '6', '--samples', '6', '--seed', '0'])
        out = json.loads(capsys.readouterr().out)
        assert out['sampler'] == 'mh'
        assert seen['algorithm'] == 'mh'
        assert seen['covmat'] == str(cm)
        assert np.isfinite(out['summary']['fsigma8']['mean'])

    def test_reference_cobaya_config_runs_mh(self, tmp_path, capsys):
        """The reference's OWN cobaya YAML (config/boss_cobaya_config.yaml)
        runs unchanged through `run`, dispatching the sampler family it
        specifies (mcmc -> mh) with its proposal widths seeding the
        proposal — the complete cobaya-workflow migration check."""
        import json
        from victor_tpu.__main__ import main
        main(['run', '/root/reference/config/boss_cobaya_config.yaml',
              '--warmup', '6', '--samples', '6', '--chains', '2',
              '--seed', '0'])
        out = json.loads(capsys.readouterr().out)
        assert out['sampler'] == 'mh'
        assert out['n_samples'] == 6
        for v in out['summary'].values():
            assert np.isfinite(v['mean'])


class TestProgressFile:
    """cobaya writes `<root>.progress` (N / timestamp / acceptance / R-1 per
    checkpoint) next to its chains; the runners reproduce it so migrating
    users keep tail/plot-progress convergence monitoring."""

    BLOCK = {
        'a': {'prior': {'dist': 'norm', 'loc': 0.0, 'scale': 1.0},
              'ref': {'dist': 'norm', 'loc': 0.0, 'scale': 0.5}},
        'b': {'prior': {'dist': 'norm', 'loc': 0.0, 'scale': 1.0},
              'ref': {'dist': 'norm', 'loc': 0.0, 'scale': 0.5}},
    }

    @staticmethod
    def _loglike(params):
        chi2 = params['a'] ** 2 + params['b'] ** 2
        return -0.5 * chi2, chi2

    def test_mh_run_writes_progress_rows(self, tmp_path):
        from victor_tpu.sampling import run_hmc_mcmc
        root = str(tmp_path / 'chains' / 'toy')
        run_hmc_mcmc(self._loglike, dict(self.BLOCK), n_chains=4,
                     n_warmup=10, n_samples=20, seed=0, algorithm='mh',
                     segment_steps=10, output=root)
        lines = open(root + '.progress').read().splitlines()
        assert lines[0].startswith('# N')
        rows = [ln.split() for ln in lines[1:]]
        assert len(rows) == 3                      # one per segment
        ns = [int(r[0]) for r in rows]
        assert ns == sorted(ns) and ns[-1] == 20   # cumulative draw count
        # timestamp occupies columns 1-2; acceptance and R-1 parse as floats
        assert 0.0 <= float(rows[-1][3]) <= 1.0
        assert np.isfinite(float(rows[-1][4]))
        # a fresh run truncates the file rather than appending forever
        run_hmc_mcmc(self._loglike, dict(self.BLOCK), n_chains=4,
                     n_warmup=10, n_samples=20, seed=1, algorithm='mh',
                     segment_steps=10, output=root)
        assert len(open(root + '.progress').read().splitlines()) == 4

    def test_ensemble_run_writes_progress(self, tmp_path):
        from victor_tpu.sampling import run_mcmc
        root = str(tmp_path / 'ens')
        run_mcmc(self._loglike, dict(self.BLOCK), n_walkers=16,
                 max_steps=40, check_every=20, rhat_stop=0.0, seed=0,
                 output=root)
        lines = open(root + '.progress').read().splitlines()
        assert lines[0].startswith('# N')
        assert len(lines) >= 2
        assert int(lines[-1].split()[0]) >= 40

    def test_de_move_samples_correct_gaussian(self):
        """The differential-evolution move (the round-5 ensemble default)
        must target the correct distribution: a correlated 2D Gaussian's
        moments recovered on a toy run."""
        rho = 0.8
        icov = np.linalg.inv(np.array([[1.0, rho], [rho, 1.0]]))

        def logpost(x):
            lnp = -0.5 * jnp.einsum('wi,ij,wj->w', x, jnp.asarray(icov), x)
            return lnp, jnp.zeros((x.shape[0], 1))

        key = jax.random.PRNGKey(0)
        coords = jax.random.normal(key, (64, 2)) * 0.5
        state = ensemble.init_state(logpost, coords, key)
        state, (xs, _, _) = jax.jit(
            lambda st: ensemble.run(logpost, st, 800, move='de'))(state)
        draws = np.asarray(xs[300:]).reshape(-1, 2)     # post burn-in
        assert np.abs(draws.mean(axis=0)).max() < 0.1
        np.testing.assert_allclose(np.corrcoef(draws.T)[0, 1], rho,
                                   atol=0.05)
        np.testing.assert_allclose(draws.std(axis=0), 1.0, atol=0.1)
        # the sweep accepted a healthy fraction (DE near the 2.38 optimum)
        acc = float(np.mean(np.asarray(state.n_accepted))
                    / float(state.n_steps))
        assert 0.1 < acc < 0.9

    def test_unknown_move_raises(self):
        def logpost(x):
            return -0.5 * jnp.sum(x ** 2, axis=-1), jnp.zeros((x.shape[0], 1))
        key = jax.random.PRNGKey(0)
        state = ensemble.init_state(logpost, jax.random.normal(key, (8, 2)),
                                    key)
        with pytest.raises(ValueError, match="'de' or 'stretch'"):
            ensemble.step(logpost, state, move='walk')

    def test_run_mcmc_defaults_to_de(self):
        """run_mcmc ships the DE move (the stretch move measurably stalls
        on the flagship config — BASELINE.md round 4/5)."""
        import inspect

        from victor_tpu.sampling import run_mcmc
        assert inspect.signature(run_mcmc).parameters['move'].default == 'de'

    def test_read_progress_roundtrip_and_plot(self, tmp_path):
        import sys as _sys
        _sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..',
                                         'tools'))
        import plot_chains

        from victor_tpu.sampling.chains import append_progress, read_progress
        root = str(tmp_path / 'p')
        append_progress(root, 0, 0.1, float('nan'), reset=True)
        append_progress(root, 10, 0.25, 1.5)
        append_progress(root, 20, 0.3, 0.02)
        prog = read_progress(root)
        np.testing.assert_array_equal(prog['n'], [0, 10, 20])
        np.testing.assert_allclose(prog['acceptance'], [0.1, 0.25, 0.3])
        assert np.isnan(prog['rminus1'][0])
        np.testing.assert_allclose(prog['rminus1'][1:], [1.5, 0.02])
        out = plot_chains.progress_plot(root, str(tmp_path / 'prog.png'))
        assert os.path.getsize(out) > 0

    def test_read_progress_parses_real_cobaya_rows(self, tmp_path):
        """A genuine cobaya .progress row has a SINGLE-token ISO timestamp
        (one fewer field than append_progress's `date time`); columns must
        anchor from the row's end or acceptance/R-1 read off by one."""
        from victor_tpu.sampling.chains import read_progress
        root = str(tmp_path / 'cob')
        with open(root + '.progress', 'w') as f:
            f.write('# N timestamp acceptance_rate Rminus1 Rminus1_cl\n')
            f.write('120 2024-05-01T12:00:00 0.2340 1.500000 2.100000\n')
            f.write('240 2024-05-01T12:05:00 0.2710 0.030000 0.080000\n')
        prog = read_progress(root)
        np.testing.assert_array_equal(prog['n'], [120, 240])
        np.testing.assert_allclose(prog['acceptance'], [0.234, 0.271])
        np.testing.assert_allclose(prog['rminus1'], [1.5, 0.03])

    def test_plot_chains_progress_only_midrun(self, tmp_path, monkeypatch,
                                              capsys):
        """Mid-run monitoring: .progress exists but chain .txt files are
        only exported at run end — --progress must plot and exit cleanly,
        not crash in load_chains (the exact case the flag targets)."""
        import sys as _sys
        _sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..',
                                         'tools'))
        import plot_chains

        from victor_tpu.sampling.chains import append_progress
        root = str(tmp_path / 'mid')
        append_progress(root, 10, 0.25, 0.5, reset=True)
        monkeypatch.setattr(_sys, 'argv',
                            ['plot_chains.py', root, '--progress'])
        plot_chains.main()   # must not raise
        captured = capsys.readouterr()
        assert 'progress plot:' in captured.out
        assert os.path.getsize(root + '_progress.png') > 0


class TestCobayaSamplerMappings:
    """cobaya sampler-block migration beyond `mcmc:` (tested above):
    `polychord:` maps to the native nested sampler with cobaya's vocabulary
    (nlive / precision_criterion / num_repeats), `minimize:` dispatches to
    the fit/MAP machinery, and `mcmc: {max_samples}` must reach the MH path
    as its draw cap. Backends are faked: these pin the *dispatch*, the real
    samplers have their own end-to-end tests."""

    BLOCK = {
        'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                    'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.02},
                    'proposal': 0.02},
        'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0,
    }

    def test_mcmc_max_samples_caps_mh_draws(self, boss_config, tmp_path,
                                            monkeypatch, capsys):
        """cobaya's max_samples must reach the MH path as the n_samples cap
        (it was once merged only into max_steps — an ensemble-path key the
        defaulted-to MH sampler never reads, silently dropping the cap)."""
        import json
        import types

        import yaml

        import victor_tpu.sampling as sampling_mod
        from victor_tpu.__main__ import main

        seen = {}

        def fake(bundle, params_block, **kw):
            seen.update(kw)
            return types.SimpleNamespace(
                n_steps=3, acceptance=0.3, elapsed_s=0.1,
                summary=lambda burn_in=None: {})

        monkeypatch.setattr(sampling_mod, 'run_hmc_mcmc', fake)
        cfg = dict(boss_config)
        cfg['params'] = dict(self.BLOCK)
        cfg['sampler'] = {'mcmc': {'max_samples': 4321,
                                   'Rminus1_stop': 0.05}}
        p = tmp_path / 'cap.yaml'
        p.write_text(yaml.safe_dump(cfg))
        main(['run', str(p), '--seed', '0',
              '--output', str(tmp_path / 'c' / 'cap')])
        assert seen['algorithm'] == 'mh'
        assert seen['n_samples'] == 4321
        assert seen['rhat_stop'] == 0.05
        out = json.loads(capsys.readouterr().out)
        assert out['sampler'] == 'mh'
        # cobaya's <root>.input.yaml reproducibility artifact: the config AS
        # GIVEN (the mcmc: nesting intact, not the normalised sampler block)
        saved = yaml.safe_load(open(tmp_path / 'c' / 'cap.input.yaml'))
        assert saved['sampler']['mcmc']['max_samples'] == 4321

    def test_polychord_maps_to_ns(self, boss_config, tmp_path, monkeypatch,
                                  capsys):
        """A cobaya `sampler: {polychord: {...}}` block runs the native
        nested sampler with nlive -> n_live, precision_criterion -> dlogz,
        num_repeats -> n_steps."""
        import json
        import types

        import yaml

        import victor_tpu.sampling as sampling_mod
        from victor_tpu.__main__ import main

        seen = {}

        def fake(bundle, params_block, **kw):
            seen.update(kw)
            return types.SimpleNamespace(
                n_live=10, n_iter=5, n_like=50, logz=1.0, logz_se=0.1,
                h=2.0, ess=20.0, elapsed_s=0.1, aux=np.full((6, 1), 60.0),
                summary=lambda: {})

        monkeypatch.setattr(sampling_mod, 'run_nested', fake)
        cfg = dict(boss_config)
        cfg['params'] = dict(self.BLOCK)
        cfg['sampler'] = {'polychord': {'nlive': 96,
                                        'precision_criterion': 0.2,
                                        'num_repeats': 7}}
        p = tmp_path / 'pc.yaml'
        p.write_text(yaml.safe_dump(cfg))
        main(['run', str(p), '--seed', '1'])
        assert seen['n_live'] == 96
        assert seen['dlogz'] == 0.2
        assert seen['n_steps'] == 7
        out = json.loads(capsys.readouterr().out)
        assert out['sampler'] == 'ns'
        assert out['log_evidence'] == 1.0

    def test_minimize_dispatches_to_fit(self, boss_config, tmp_path,
                                        monkeypatch):
        """A cobaya `sampler: {minimize: {...}}` block dispatches `run` to
        the MAP machinery (cmd_fit) with the mapped options and the CLI
        seed."""
        import yaml

        import victor_tpu.__main__ as cli

        seen = {}
        monkeypatch.setattr(cli, 'cmd_fit', lambda a: seen.update(vars(a)))
        cfg = dict(boss_config)
        cfg['params'] = dict(self.BLOCK)
        cfg['sampler'] = {'minimize': {'n_starts': 5, 'adam_steps': 17,
                                       'covmat_out':
                                       str(tmp_path / 'o.covmat')}}
        p = tmp_path / 'min.yaml'
        p.write_text(yaml.safe_dump(cfg))
        cli.main(['run', str(p), '--seed', '2'])
        assert seen['starts'] == 5
        assert seen['adam_steps'] == 17
        assert seen['seed'] == 2
        assert seen['covmat_out'] == str(tmp_path / 'o.covmat')
        assert seen['config'] == str(p)

    def test_minimize_with_output_root_writes_side_artifacts(
            self, boss_config, tmp_path, monkeypatch):
        """A minimize: run with an output: root must still write the
        <root>.input.yaml snapshot (the dispatch once returned before the
        snapshot block) and plumb the root through as the default covmat
        destination."""
        import yaml

        import victor_tpu.__main__ as cli

        seen = {}
        monkeypatch.setattr(cli, 'cmd_fit', lambda a: seen.update(vars(a)))
        cfg = dict(boss_config)
        cfg['params'] = dict(self.BLOCK)
        cfg['sampler'] = {'minimize': {'n_starts': 3}}
        cfg['output'] = str(tmp_path / 'min' / 'map')
        p = tmp_path / 'min3.yaml'
        p.write_text(yaml.safe_dump(cfg))
        cli.main(['run', str(p), '--seed', '0'])
        assert seen['covmat_out'] == str(tmp_path / 'min' / 'map.covmat')
        saved = yaml.safe_load(open(tmp_path / 'min' / 'map.input.yaml'))
        assert 'minimize' in saved['sampler']

    def test_explicit_sampler_flag_overrides_minimize(self, boss_config,
                                                      tmp_path, monkeypatch,
                                                      capsys):
        """--sampler on the command line wins over a config minimize: block
        (same precedence as over kind:)."""
        import json
        import types

        import yaml

        import victor_tpu.__main__ as cli
        import victor_tpu.sampling as sampling_mod

        called = {}
        monkeypatch.setattr(
            cli, 'cmd_fit',
            lambda a: called.setdefault('fit', True))

        def fake(bundle, params_block, **kw):
            called['mcmc'] = True
            return types.SimpleNamespace(
                n_steps=3, acceptance=0.3, elapsed_s=0.1, rhat=np.ones(1),
                summary=lambda burn_in=None: {})

        monkeypatch.setattr(sampling_mod, 'run_mcmc', fake)
        cfg = dict(boss_config)
        cfg['params'] = dict(self.BLOCK)
        cfg['sampler'] = {'minimize': {'n_starts': 5}}
        p = tmp_path / 'min2.yaml'
        p.write_text(yaml.safe_dump(cfg))
        cli.main(['run', str(p), '--sampler', 'ensemble', '--seed', '0'])
        assert called == {'mcmc': True}
        assert json.loads(capsys.readouterr().out)['n_steps'] == 3

    def test_bare_run_defaults_to_mh(self, boss_config, tmp_path,
                                     monkeypatch, capsys):
        """Bare `run` (no --sampler, no sampler.kind) must dispatch the
        calibrated MH sampler — the reference's cobaya-mcmc algorithm
        class — NOT the experimental ensemble sampler (the round-1..3
        default, measured unconverged at its default budget)."""
        import json
        import types

        import yaml

        import victor_tpu.sampling as sampling_mod
        from victor_tpu.__main__ import main

        seen = {}

        def fake(bundle, params_block, **kw):
            seen.update(kw)
            return types.SimpleNamespace(
                n_steps=3, acceptance=0.3, elapsed_s=0.1,
                summary=lambda burn_in=None: {})

        monkeypatch.setattr(sampling_mod, 'run_hmc_mcmc', fake)
        cfg = dict(boss_config)
        cfg['params'] = dict(self.BLOCK)
        p = tmp_path / 'bare.yaml'
        p.write_text(yaml.safe_dump(cfg))
        main(['run', str(p), '--seed', '0'])
        assert seen['algorithm'] == 'mh'
        assert json.loads(capsys.readouterr().out)['sampler'] == 'mh'

    def test_nuts_dispatch_defaults(self, boss_config, tmp_path,
                                    monkeypatch, capsys):
        """Bare `--sampler nuts` ships the convergence recipe: depth 6 (the
        measured dense-mass speed/robustness point) and a 4000-draw cap
        (n_samples acts as a cap under rhat_stop — seeds 0-2 measured
        converging at 500-2,800 draws, BASELINE.md round 5). Explicit
        --max-depth / sampler keys must still win."""
        import json
        import types

        import yaml

        import victor_tpu.sampling as sampling_mod
        from victor_tpu.__main__ import main

        seen = {}

        def fake(bundle, params_block, **kw):
            seen.update(kw)
            return types.SimpleNamespace(
                n_steps=3, acceptance=0.3, elapsed_s=0.1,
                summary=lambda burn_in=None: {})

        monkeypatch.setattr(sampling_mod, 'run_hmc_mcmc', fake)
        cfg = dict(boss_config)
        cfg['params'] = dict(self.BLOCK)
        p = tmp_path / 'nuts.yaml'
        p.write_text(yaml.safe_dump(cfg))
        main(['run', str(p), '--sampler', 'nuts', '--seed', '0'])
        assert seen['algorithm'] == 'nuts'
        assert seen['max_depth'] == 6
        assert seen['n_samples'] == 4000
        assert seen['n_warmup'] == 300
        # the draw budget is a CAP even without a sampler block: nuts
        # defaults the convergence stop on (cobaya's 0.01)
        assert seen['rhat_stop'] == 0.01
        capsys.readouterr()
        # explicit depth wins; hmc keeps depth 8
        main(['run', str(p), '--sampler', 'nuts', '--max-depth', '9',
              '--seed', '0'])
        assert seen['max_depth'] == 9
        capsys.readouterr()
        main(['run', str(p), '--sampler', 'hmc', '--seed', '0'])
        assert seen['max_depth'] == 8
        assert seen['n_samples'] == 700
        capsys.readouterr()

    def test_defaulted_mh_warns_on_ensemble_only_keys(
            self, boss_config, tmp_path, monkeypatch, capsys):
        """A migrating config with only ensemble tuning keys (n_walkers/
        max_steps/check_every — the old shipped boss_sampling_config.yaml
        shape) and no kind: dispatches MH with its own defaults; that must
        be LOUD, or the user's tuning is silently ignored."""
        import logging
        import types

        import yaml

        import victor_tpu.sampling as sampling_mod
        from victor_tpu.__main__ import main

        def fake(bundle, params_block, **kw):
            return types.SimpleNamespace(
                n_steps=3, acceptance=0.3, elapsed_s=0.1,
                summary=lambda burn_in=None: {})

        monkeypatch.setattr(sampling_mod, 'run_hmc_mcmc', fake)
        cfg = dict(boss_config)
        cfg['params'] = dict(self.BLOCK)
        cfg['sampler'] = {'n_walkers': 64, 'max_steps': 500}
        p = tmp_path / 'old_ensemble.yaml'
        p.write_text(yaml.safe_dump(cfg))
        records = []

        class _Grab(logging.Handler):
            def emit(self, record):
                records.append(record)

        h = _Grab(level=logging.WARNING)
        logging.getLogger('victor_tpu.cli').addHandler(h)
        try:
            main(['run', str(p), '--seed', '0'])
        finally:
            logging.getLogger('victor_tpu.cli').removeHandler(h)
        capsys.readouterr()
        msgs = [r.getMessage() for r in records]
        assert any('ensemble-only keys' in m and 'n_walkers' in m
                   and 'max_steps' in m for m in msgs)

    def test_unconverged_ensemble_exits_nonzero(self, boss_config, tmp_path,
                                                monkeypatch, capsys):
        """An explicit --sampler ensemble run that ends above rhat_stop
        must exit nonzero (the ensemble sampler has no calibration row; an
        unconverged run must not look like a result). rhat_stop: 0 opts
        out (the run-exactly-max_steps idiom)."""
        import json
        import types

        import yaml

        import victor_tpu.sampling as sampling_mod
        from victor_tpu.__main__ import main

        def fake(bundle, params_block, **kw):
            return types.SimpleNamespace(
                n_steps=40, acceptance=0.3, elapsed_s=0.1,
                rhat=np.asarray([1.2, 1.05]),
                summary=lambda: {})

        monkeypatch.setattr(sampling_mod, 'run_mcmc', fake)
        cfg = dict(boss_config)
        cfg['params'] = dict(self.BLOCK)
        p = tmp_path / 'ens.yaml'
        p.write_text(yaml.safe_dump(cfg))
        with pytest.raises(SystemExit) as ei:
            main(['run', str(p), '--sampler', 'ensemble', '--seed', '0'])
        assert 'did NOT converge' in str(ei.value)
        out = json.loads(capsys.readouterr().out)
        assert out['converged'] is False
        assert out['max_rminus1'] == 0.2
        # explicit opt-out: rhat_stop 0 runs to completion, exit 0
        cfg['sampler'] = {'rhat_stop': 0.0}
        p2 = tmp_path / 'ens0.yaml'
        p2.write_text(yaml.safe_dump(cfg))
        main(['run', str(p2), '--sampler', 'ensemble', '--seed', '0'])
        out = json.loads(capsys.readouterr().out)
        assert out['converged'] is False   # still reported truthfully


class TestProposalSeeding:
    """cobaya's proposal-covariance workflow: per-param `proposal:` widths
    seed MH's initial proposal, `.covmat` files seed all three HMCState
    samplers, and every chain export writes `<root>.covmat` back
    (reference config/boss_cobaya_config.yaml:60,72,84,96)."""

    def test_dtheta_dy_diag_matches_autodiff(self):
        """The hand-written diagonal Jacobian must equal jacfwd(to_bounded)
        for every supported prior family."""
        sp = ParamSpace({
            'u': {'prior': {'dist': 'uniform', 'min': 0.2, 'max': 0.6}},
            'lu': {'prior': {'dist': 'loguniform', 'min': 0.1, 'max': 10.0}},
            'hn': {'prior': {'dist': 'halfnorm', 'loc': 1.0, 'scale': 2.0}},
            'n': {'prior': {'dist': 'norm', 'loc': 0.0, 'scale': 1.0}},
        })
        y = jnp.asarray([0.3, -0.7, 0.2, 1.1])
        full = jax.jacfwd(sp.to_bounded)(y)
        np.testing.assert_allclose(np.asarray(sp.dtheta_dy_diag(y)),
                                   np.diag(np.asarray(full)), rtol=1e-6)
        # the reparameterisation is elementwise: off-diagonals are zero
        np.testing.assert_allclose(
            np.asarray(full) - np.diag(np.diag(np.asarray(full))), 0.0,
            atol=1e-12)

    def test_proposal_scales_map_to_unbounded(self):
        """sigma_y = proposal / (dtheta/dy); params without proposal get
        the 1.0 identity seed."""
        sp = ParamSpace({
            'a': {'prior': {'dist': 'uniform', 'min': 0.0, 'max': 2.0},
                  'proposal': 0.02},
            'b': {'prior': {'dist': 'norm', 'loc': 0.0, 'scale': 1.0}},
        })
        y = jnp.asarray([0.4, 0.0])
        scales = np.asarray(sp.proposal_scales_unbounded(y))
        j = np.asarray(sp.dtheta_dy_diag(y))
        np.testing.assert_allclose(scales[0], 0.02 / j[0], rtol=1e-6)
        assert scales[1] == 1.0

    def test_mh_runner_seeds_proposal_from_block(self, boss_config):
        """A `proposal:` width in the params block must reach the MH init
        (visible as a converted-width chol_cov after a 0-warmup segment of
        length 0 is impossible — so probe mh.init_chains directly with the
        runner's own seeding function)."""
        from victor_tpu.sampling import mh
        sp = ParamSpace({
            'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                        'proposal': 0.02},
        })
        y0 = sp.to_unbounded(jnp.asarray([[0.47], [0.5]]))
        keys = jax.random.split(jax.random.PRNGKey(0), 2)
        chol0 = jax.vmap(jnp.diag)(sp.proposal_scales_unbounded(y0))
        states = mh.init_chains(lambda y: (-0.5 * jnp.sum(y ** 2),
                                           jnp.zeros((1,))),
                                y0, keys, chol0=chol0)
        np.testing.assert_allclose(np.asarray(states.chol_cov),
                                   np.asarray(chol0), rtol=1e-6)
        # and the widths are the theta-space 0.02 mapped through 1/J
        j = np.asarray(jax.vmap(sp.dtheta_dy_diag)(y0))
        np.testing.assert_allclose(np.asarray(states.chol_cov)[:, 0, 0],
                                   0.02 / j[:, 0], rtol=1e-5)

    def test_covmat_export_and_roundtrip(self, tmp_path):
        """export_getdist writes a cobaya-format <root>.covmat whose matrix
        is the (weighted) chain covariance; read_covmat loads, reorders and
        subsets it."""
        from victor_tpu.sampling.chains import read_covmat
        sp = ParamSpace(COBAYA_BLOCK)
        rng = np.random.default_rng(0)
        chain = rng.normal([0.5, 0.4, 1.0], [0.05, 0.02, 0.01],
                           size=(200, 4, 3))
        lnp = -0.5 * np.sum(chain ** 2, axis=-1)
        root = str(tmp_path / 'c' / 'run')
        export_getdist(root, sp, chain, lnp)
        flat = chain.reshape(-1, 3)
        cov = read_covmat(root + '.covmat',
                          ['fsigma8', 'beta', 'epsilon'])
        np.testing.assert_allclose(cov, np.cov(flat.T), rtol=1e-6)
        # reorder + subset with a proposal^2 fallback for the absent name
        sub = read_covmat(root + '.covmat', ['epsilon', 'new', 'fsigma8'],
                          fallback_var=np.array([np.nan, 0.04, np.nan]))
        np.testing.assert_allclose(sub[0, 0], cov[2, 2], rtol=1e-6)
        np.testing.assert_allclose(sub[2, 2], cov[0, 0], rtol=1e-6)
        np.testing.assert_allclose(sub[0, 2], cov[2, 0], rtol=1e-6)
        assert sub[1, 1] == 0.04 and sub[0, 1] == 0.0
        from victor_tpu.errors import InputError
        with pytest.raises(InputError, match='shares no'):
            read_covmat(root + '.covmat', ['nope'])
        # write_covmat -> read_covmat round-trips any matrix (incl. 1x1)
        from victor_tpu.sampling.chains import write_covmat
        write_covmat(str(tmp_path / 'one.covmat'), ['x'], np.array([[4.0]]))
        np.testing.assert_allclose(
            read_covmat(str(tmp_path / 'one.covmat'), ['x']), [[4.0]])

    def test_run_with_covmat_seed(self, boss_config, tmp_path):
        """run_hmc_mcmc(covmat=...) end-to-end: a cobaya-format file seeds
        the sampler and the run completes; a non-PD file errors loudly."""
        from victor_tpu.errors import InputError
        from victor_tpu.io import build_tables
        from victor_tpu.sampling import run_hmc_mcmc
        bundle = build_tables(boss_config['model'], boss_config['data'])
        block = {
            'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                        'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.02}},
            'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0,
        }
        cm = tmp_path / 'seed.covmat'
        cm.write_text('# fsigma8\n2.5e-3\n')
        res = run_hmc_mcmc(bundle, block, n_chains=2, n_warmup=6, n_samples=6,
                           seed=0, algorithm='mh', covmat=str(cm))
        assert res.chain.shape == (6, 2, 1)
        assert np.all(np.isfinite(res.log_prob))
        bad = tmp_path / 'bad.covmat'
        bad.write_text('# fsigma8\n-1.0\n')
        with pytest.raises(InputError, match='positive definite'):
            run_hmc_mcmc(bundle, block, n_chains=2, n_warmup=6, n_samples=6,
                         seed=0, algorithm='mh', covmat=str(bad))
        # a covmat missing a sampled param with no proposal fallback errors
        block2 = dict(block)
        block2['epsilon'] = {'prior': {'dist': 'uniform', 'min': 0.8,
                                       'max': 1.2}}
        with pytest.raises(InputError, match='no entry for'):
            run_hmc_mcmc(bundle, block2, n_chains=2, n_warmup=6, n_samples=6,
                         seed=0, algorithm='mh', covmat=str(cm))


class TestPlotChainsTool:
    def test_quicklook_on_exported_chains(self, tmp_path, capsys):
        """tools/plot_chains.py reads our GetDist exports, computes
        cross-chain R-hat, and writes a corner png."""
        import sys as _sys
        _sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..',
                                         'tools'))
        import plot_chains

        from victor_tpu.sampling import ParamSpace
        from victor_tpu.sampling.chains import export_getdist
        rng = np.random.default_rng(5)
        block = {
            'a': {'prior': {'dist': 'uniform', 'min': -5.0, 'max': 5.0}},
            'b': {'prior': {'dist': 'uniform', 'min': -5.0, 'max': 5.0}},
        }
        space = ParamSpace(block)
        chain = rng.normal(size=(200, 8, 2)) * [1.0, 2.0] + [0.5, -1.0]
        lnp = -0.5 * (chain ** 2).sum(-1)
        root = str(tmp_path / 'chains' / 'toy')
        export_getdist(root, space, chain, lnp, n_chain_files=4)
        # a stray non-chain file matching the glob must be skipped, not
        # crash the numeric sort (e.g. cobaya leaves <root>.input.yaml-era
        # siblings; here a .info.txt)
        with open(f'{root}.info.txt', 'w') as f:
            f.write('not a chain\n')

        chains, names = plot_chains.load_chains(root)
        assert len(chains) == 4 and names[:2] == ['a', 'b']
        rhat = plot_chains.cross_chain_rhat(chains, 0)
        assert 0.99 < rhat < 1.05           # same distribution in all files
        data = np.concatenate(chains)[:, 2:]
        assert abs(data[:, 0].mean() - 0.5) < 0.1
        out = plot_chains.corner_plot(chains, names, root + '_corner.png')
        assert os.path.exists(out) and os.path.getsize(out) > 5000
