"""Batched + mesh-sharded likelihood evaluation parity tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from victor_tpu.io import build_tables
from victor_tpu.likelihood.batched import (make_loglike, make_batched_loglike,
                                           make_sharded_loglike)
from victor_tpu.parallel import make_mesh

NAMES = ['fsigma8', 'beta', 'sigma_v', 'epsilon']


@pytest.fixture(scope='module')
def bundle(boss_config):
    return build_tables(boss_config['model'], boss_config['data'])


@pytest.fixture(scope='module')
def theta_batch(ref_fixtures):
    gp = np.asarray(ref_fixtures['grid_params'])[:16]
    return jnp.asarray(gp)


def test_batched_matches_scalar(bundle, theta_batch, ref_fixtures):
    # reference-parity check: pin the exact evaluation (gradient_free=False
    # resolves the 'auto' perf modes to 'exact'); the fast default is
    # pinned separately by test_batched_default_resolves_fast
    scalar = make_loglike(bundle, NAMES)
    batched = make_batched_loglike(bundle, NAMES, gradient_free=False)
    lnl_b, chi2_b = batched(theta_batch)
    for i in range(theta_batch.shape[0]):
        lnl_s, chi2_s = scalar(theta_batch[i])
        np.testing.assert_allclose(float(lnl_b[i]), float(lnl_s), rtol=1e-12)
        np.testing.assert_allclose(float(chi2_b[i]), float(chi2_s), rtol=1e-12)
    # and against the reference goldens
    np.testing.assert_allclose(np.asarray(chi2_b),
                               np.asarray(ref_fixtures['grid_chi2'])[:16], rtol=1e-8)
    np.testing.assert_allclose(np.asarray(lnl_b),
                               np.asarray(ref_fixtures['grid_lnl'])[:16], rtol=1e-8)


def test_sharded_matches_batched(bundle, theta_batch):
    assert len(jax.devices()) == 8
    mesh = make_mesh(('walkers',))
    sharded = make_sharded_loglike(bundle, NAMES, mesh, axis='walkers')
    batched = make_batched_loglike(bundle, NAMES)
    lnl_s, chi2_s = sharded(theta_batch)
    lnl_b, chi2_b = batched(theta_batch)
    np.testing.assert_allclose(np.asarray(lnl_s), np.asarray(lnl_b), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(chi2_s), np.asarray(chi2_b), rtol=1e-12)


def test_batched_default_resolves_fast(bundle, theta_batch):
    """The throughput surface defaults gradient-free: 'auto' perf modes
    resolve to the posterior-validated fast modes — bit-identical to an
    explicit streaming_eval='fast', and measurably different from (but
    close to) the exact path (config.resolve_perf_mode policy)."""
    default = make_batched_loglike(bundle, NAMES)
    explicit_fast = make_batched_loglike(
        bundle, NAMES, opts_kw={'streaming_eval': 'fast',
                                'dispersion_final': 'fast'})
    exact = make_batched_loglike(bundle, NAMES, gradient_free=False)
    lnl_d = np.asarray(default(theta_batch)[0])
    lnl_f = np.asarray(explicit_fast(theta_batch)[0])
    lnl_e = np.asarray(exact(theta_batch)[0])
    np.testing.assert_array_equal(lnl_d, lnl_f)
    assert not np.array_equal(lnl_d, lnl_e)          # fast really ran
    np.testing.assert_allclose(lnl_d, lnl_e, rtol=1e-3)   # and is close


def test_resolve_perf_mode_policy():
    """'auto' -> fast on gradient-free paths, exact on AD paths; explicit
    values always win; resolve_target carries the resolution into its
    cache key so fast/exact consumers never share compiled functions."""
    from victor_tpu.config import TheoryOptions, resolve_perf_mode
    auto = TheoryOptions()
    assert auto.streaming_eval == 'auto'
    assert auto.dispersion_final == 'auto'
    fast = resolve_perf_mode(auto, gradient_free=True)
    assert (fast.streaming_eval, fast.dispersion_final) == ('fast', 'fast')
    # AD paths: streaming exact (the Clenshaw transpose is slower than
    # exact), but dispersion_final STILL fast — it removes passes and
    # their transposes (HMC 3.3x, BASELINE.md round 3)
    exact = resolve_perf_mode(auto, gradient_free=False)
    assert (exact.streaming_eval, exact.dispersion_final) == \
        ('exact', 'fast')
    pinned = TheoryOptions(streaming_eval='exact', dispersion_final='exact')
    out = resolve_perf_mode(pinned, gradient_free=True)
    assert (out.streaming_eval, out.dispersion_final) == ('exact', 'exact')


def test_dispersion_final_fused_is_rejected():
    """'fused' named a removed kernel: it must raise like any typo, never
    fall through to another final-stage path."""
    from victor_tpu.config import TheoryOptions
    with pytest.raises(ValueError, match='must be one of'):
        TheoryOptions(dispersion_final='fused')


def test_resolve_target_gradient_free_cache_keys(bundle):
    from victor_tpu.sampling.targets import resolve_target
    _, _, cid_free = resolve_target(bundle, None, None, gradient_free=True)
    _, _, cid_grad = resolve_target(bundle, None, None, gradient_free=False)
    assert cid_free != cid_grad
    assert cid_free[1].streaming_eval == 'fast'
    assert cid_grad[1].streaming_eval == 'exact'
    # dispersion_final resolves fast on BOTH paths (it speeds AD too)
    assert cid_free[1].dispersion_final == 'fast'
    assert cid_grad[1].dispersion_final == 'fast'
    # explicit override wins regardless of the path
    _, _, cid_pin = resolve_target(bundle, {'streaming_eval': 'exact'},
                                   None, gradient_free=True)
    assert cid_pin[1].streaming_eval == 'exact'


def test_resolve_perf_kw_joint_policy():
    """Joint fits resolve in kw space: inject only when the caller didn't
    override AND every member is 'auto' (a mixed explicit/auto membership
    is honored as-is — injection would override the explicit members)."""
    from victor_tpu.config import TheoryOptions
    from victor_tpu.sampling.targets import resolve_perf_kw
    auto, pinned = TheoryOptions(), TheoryOptions(streaming_eval='exact')
    kw = resolve_perf_kw([auto, auto], None, gradient_free=True)
    assert kw == {'streaming_eval': 'fast', 'dispersion_final': 'fast',
                  'beta_covariance': 'factored'}
    kw = resolve_perf_kw([auto, auto], {'streaming_eval': 'exact'},
                         gradient_free=True)
    assert kw['streaming_eval'] == 'exact'
    assert kw['dispersion_final'] == 'fast'
    kw = resolve_perf_kw([auto, pinned], None, gradient_free=True)
    assert kw is None or 'streaming_eval' not in kw


def test_base_params_override(bundle):
    scalar = make_loglike(bundle, ['fsigma8', 'beta'],
                          base_params={'sigma_v': 380.0, 'epsilon': 1.0})
    lnl, chi2 = scalar(jnp.asarray([0.47, 0.37]))
    assert abs(float(chi2) - 65.01) < 0.01


def test_missing_beta_raises_input_error(bundle):
    """The reference raises 'Need to supply a valid value of beta' when the
    data/covariance are beta-dependent (victor/ccf_fit.py:389); a silent
    0.0 default would extrapolate far off the grid and return
    garbage-but-finite likelihoods."""
    from victor_tpu.errors import InputError
    from victor_tpu.likelihood.core import log_likelihood
    params = {'fsigma8': jnp.asarray(0.47), 'sigma_v': jnp.asarray(380.0),
              'epsilon': jnp.asarray(1.0)}
    with pytest.raises(InputError, match='beta'):
        log_likelihood(bundle.tables, bundle.spec, bundle.theory_opts,
                       bundle.fit_opts, params)


def test_cov_interp_gradient_finite_outside_grid():
    """Covariance interpolation clamps beta outside the grid; the clamp
    must also have a clean (zero) gradient — the 0/0 at low == n-1 used
    to poison reverse-mode with NaN while the primal stayed finite."""
    from victor_tpu.likelihood.core import _interp_matrix_stack
    grid = jnp.asarray([0.3, 0.4, 0.5])
    stack = jnp.stack([i * jnp.eye(2) for i in (1.0, 2.0, 3.0)])

    def f(b):
        return _interp_matrix_stack(grid, stack, b).sum()

    for beta, expect in [(0.55, 6.0), (0.25, 2.0), (0.5, 6.0), (0.45, None)]:
        val, g = jax.value_and_grad(f)(jnp.asarray(beta))
        assert np.isfinite(float(val)) and np.isfinite(float(g)), beta
        if expect is not None:
            np.testing.assert_allclose(float(val), expect, rtol=1e-12)
        if beta in (0.55, 0.25):
            assert float(g) == 0.0          # clamped outside the grid
