"""End-to-end statistical calibration: parameter recovery on synthetic data.

tools/coverage_test.py draws mock data vectors from the covariance at a
fiducial point and refits them; with the gaussian likelihood form the pulls
(theta_hat - theta_fid)/sigma_Laplace must be standard normal. A small mock
count keeps the test fast — the assertions are sized to its binomial/CLT
noise; the tool's default (100 mocks) tightens them on real hardware.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'tools'))


class TestCoverage:
    @pytest.fixture(scope='class')
    def pulls(self, boss_config):
        from coverage_test import run_coverage
        from victor_tpu.io import build_tables
        bundle = build_tables(boss_config['model'], boss_config['data'])
        pulls, hit68, names, _ = run_coverage(
            bundle, n_mocks=8, seed=11, form='gaussian',
            n_starts=4, adam_steps=100, newton_steps=6)
        return pulls, hit68, names

    @pytest.mark.slow
    def test_pulls_are_standard_normal(self, pulls):
        """beta is excluded from the tight calibration bands: its per-mock
        likelihood has beta-grid-scale structure (template spacing ~0.01 vs
        sigma(beta) ~0.007) so its pulls are heavy-tailed by construction —
        see tools/coverage_test.py module docstring (60-mock run:
        fsigma8/sigma_v/epsilon pull std 1.03/1.04/0.94; beta 2.4)."""
        p, hit68, names = pulls
        assert np.all(np.isfinite(p))
        ib = names.index('beta')
        smooth = np.delete(p, ib, axis=1).reshape(-1)   # 8 mocks x 3 params
        # mean: sigma_mean = 1/sqrt(24) = 0.20 -> generous band
        assert abs(smooth.mean()) < 0.8, f'biased pulls: {smooth.mean():.3f}'
        # scatter: std(std) ~ 1/sqrt(2*24) = 0.14
        assert 0.55 < smooth.std() < 1.6, \
            f'miscalibrated sigmas: {smooth.std():.3f}'
        # beta: heavy-tailed but must stay bounded and centred-ish
        assert np.abs(p[:, ib]).max() < 15.0
        assert 0.35 < hit68 < 0.95, f'68%-coverage: {hit68:.2f}'

    @pytest.mark.slow
    def test_smc_posterior_coverage_smoke(self, boss_config):
        """--method smc plumbing: per-mock tempered-SMC posteriors produce
        finite posterior-mean pulls and sane central intervals. The real
        calibration runs on the accelerator (100 mocks, BASELINE.md: nominal
        coverage for every parameter incl. beta, whose marginal posterior
        integrates over the grid-scale wiggles that break Laplace/profile
        intervals); 2 tiny mocks here just pin the code path."""
        from coverage_test import run_coverage_smc
        from victor_tpu.io import build_tables
        bundle = build_tables(boss_config['model'], boss_config['data'])
        # 48 particles matches test_smc's CPU-sized bundle run: the full
        # BOSS likelihood in f64 on one core is the cost, not the sampler
        pulls, cover68, names = run_coverage_smc(
            bundle, n_mocks=2, seed=5, form='gaussian',
            n_particles=48, n_moves=2, chunk=16)
        assert pulls.shape == (2, 4)
        assert np.all(np.isfinite(pulls))
        # posterior-mean pulls in posterior-std units: |pull| > 6 would mean
        # a broken interval even at 48 particles
        assert np.abs(pulls).max() < 6.0
        assert cover68.shape == (len(names),)
        assert np.all((cover68 >= 0.0) & (cover68 <= 1.0))

    @pytest.mark.slow
    def test_ns_posterior_coverage_smoke(self, boss_config):
        """--method ns plumbing: per-mock nested-sampling posteriors produce
        finite posterior-mean pulls and sane central intervals — the same
        smoke the SMC path has, for the methodologically independent
        estimator. The real calibration runs on the accelerator
        (50 mocks, BASELINE.md)."""
        from coverage_test import run_coverage_ns
        from victor_tpu.io import build_tables
        bundle = build_tables(boss_config['model'], boss_config['data'])
        pulls, cover68, names = run_coverage_ns(
            bundle, n_mocks=2, seed=5, form='gaussian',
            n_live=48, n_batch=12, n_steps=3, chunk=16, dlogz=0.5)
        assert pulls.shape == (2, 4)
        assert np.all(np.isfinite(pulls))
        assert np.abs(pulls).max() < 6.0
        assert cover68.shape == (len(names),)
        assert np.all((cover68 >= 0.0) & (cover68 <= 1.0))

    @pytest.mark.slow
    def test_sbc_rank_smoke(self, boss_config):
        """--method sbc plumbing: prior-drawn truths, per-truth data vector
        and covariance, fractional posterior ranks in [0, 1]. The real
        rank-uniformity measurement runs on the accelerator (100 mocks,
        BASELINE.md);
        2 tiny mocks here pin the code path, including the per-mock
        beta_k-dependent mock generation."""
        from coverage_test import run_sbc
        from victor_tpu.io import build_tables
        bundle = build_tables(boss_config['model'], boss_config['data'])
        ranks, names = run_sbc(bundle, n_mocks=2, seed=3,
                               n_particles=48, n_moves=2, chunk=16)
        assert ranks.shape == (2, 4)
        assert np.all((ranks >= 0.0) & (ranks <= 1.0))
        # a rank pinned at exactly 0 or 1 in BOTH mocks would mean the
        # posterior never brackets the truth — broken inference
        assert not np.any(np.all((ranks == 0.0) | (ranks == 1.0), axis=0))

    def test_joint_sbc_rank_smoke(self):
        """--model joint plumbing: the JointBundle dispatch in
        shift_datavector/_mock_setup through run_sbc over the 5-param
        2-quantile space (shared fsigma8/beta/epsilon + per-quantile
        sigma_v__q<i>) with the correlated rho=0.4 cross-covariance. The
        real rank-uniformity measurement runs on the accelerator (BASELINE.md)."""
        from coverage_test import (SBC_BLOCK_JOINT, build_joint_boss_bundle,
                                   run_sbc)
        jb = build_joint_boss_bundle()
        ranks, names = run_sbc(jb, n_mocks=1, seed=3,
                               params_block=SBC_BLOCK_JOINT,
                               n_particles=32, n_moves=2, chunk=16)
        assert names == list(SBC_BLOCK_JOINT)
        assert ranks.shape == (1, 5)
        assert np.all((ranks >= 0.0) & (ranks <= 1.0))

    def test_joint_mock_shift_is_exact(self):
        """shift_datavector on a JointBundle splits delta at the stacked-
        vector block boundaries: the joint data vector moves by exactly
        delta at every beta."""
        import jax.numpy as jnp
        from coverage_test import build_joint_boss_bundle, shift_datavector
        from victor_tpu.likelihood.multiquantile import joint_datavector
        jb = build_joint_boss_bundle()
        rng = np.random.default_rng(5)
        delta = rng.normal(size=jb.ndata)
        mb = shift_datavector(jb, delta)
        for beta in [0.37, 0.4123]:
            p = {'beta': jnp.asarray(beta)}
            a = np.asarray(joint_datavector(jb, p))
            b = np.asarray(joint_datavector(mb, p))
            np.testing.assert_allclose(b - a, delta, atol=1e-12)

    def test_mock_shift_is_exact_at_fiducial_beta(self, boss_config):
        """shift_datavector moves the beta-interpolated data vector by
        exactly delta at every beta (constant shift commutes with PCHIP)."""
        import jax.numpy as jnp
        from coverage_test import shift_datavector
        from victor_tpu.io import build_tables
        from victor_tpu.likelihood.core import multipole_datavector
        bundle = build_tables(boss_config['model'], boss_config['data'])
        rng = np.random.default_rng(3)
        d0 = np.asarray(multipole_datavector(bundle.tables, bundle.spec,
                                             jnp.asarray(0.4123)))
        delta = rng.normal(size=d0.shape)
        mb = shift_datavector(bundle, delta)
        for beta in [0.37, 0.4123, 0.55]:
            a = np.asarray(multipole_datavector(bundle.tables, bundle.spec,
                                                jnp.asarray(beta)))
            b = np.asarray(multipole_datavector(mb.tables, mb.spec,
                                                jnp.asarray(beta)))
            np.testing.assert_allclose(b - a, delta, atol=1e-12)
