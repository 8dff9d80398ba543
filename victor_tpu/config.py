"""Static configuration for the CCF theory/likelihood pipeline.

The reference drives everything off two nested YAML dicts (`model:` and
`data:`, schema documented in the reference config/boss_config.yaml:1-119) plus
per-call kwargs that override init defaults (victor/ccf_model.py:565-567).
Here the options that change the *structure* of the computation are collected
into hashable frozen dataclasses used as jit static arguments; per-call
overrides become `dataclasses.replace(...)` producing a (cached) new trace.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


RSD_MODELS = ('streaming', 'dispersion', 'kaiser', 'euclid_special')
MATTER_MODELS = ('linear_bias', 'template', 'excursion_set')
MEAN_MODELS = ('linear', 'nonlinear', 'template')
LIKELIHOOD_FORMS = ('gaussian', 'hartlap', 'sellentin', 'percival')


@dataclasses.dataclass(frozen=True)
class TheoryOptions:
    """Model-evaluation options (defaults mirror victor/ccf_model.py:85-97)."""
    rsd_model: str = 'streaming'
    kaiser_approximation: bool = False
    kaiser_coord_shift: bool = True
    assume_isotropic: bool = True
    realspace_ccf_from_data: bool = False
    matter_model: str = 'template'
    mean_model: str = 'linear'
    empirical_corr: bool = False
    pdf_form: str = 'gaussian'
    velocity_independent_of_AP: bool = True
    niter: int = 5
    # interior iterations of the dispersion fixed-point solve: 'chebyshev'
    # compresses the velocity spline for the (niter-1) interior Picard steps
    # (final step always exact; result within ~2e-6 relative of 'exact' —
    # see models/ccf_theory.py); 'exact' reproduces the reference float-
    # for-float and is used by the parity test suite
    dispersion_interior: str = 'chebyshev'
    # streaming-model evaluation: 'auto' (default — resolves to 'fast' on
    # gradient-free paths and 'exact' on AD paths, see resolve_perf_mode),
    # 'exact', or 'fast' (degree-48 Chebyshev compressions of the v_r
    # spline and the mu-independent sigma_v template — the technique
    # validated for the dispersion final stage; bounds in test_golden.py,
    # posterior validation in BASELINE.md: all posterior shifts <= 0.026
    # sigma). 'fast' is a FORWARD-path optimization (batched likelihood /
    # SMC / quadrature; also posterior-validated composed with the
    # excursion-set matter model): under reverse-mode AD the Clenshaw
    # recurrence's sequential transpose costs more than the exact splines'
    # — which is why 'auto' keeps 'exact' for HMC/NUTS/MAP. Neither cost is
    # measured on a GPU yet (PERF.md). An unresolved 'auto' reaching the
    # theory layer evaluates as 'exact' (the fast
    # branches test == 'fast'), so direct log_likelihood/theory calls —
    # eval, goldens, parity tests — are exact unless opted in.
    streaming_eval: str = 'auto'
    # final stage of the dispersion solve (the last Picard update and the
    # jacobian's v_r/dv_r evaluations): 'auto' (default — resolves to
    # 'fast', see resolve_perf_mode), 'exact' (three exact spline passes,
    # reference semantics), or 'fast' (reuses the final update's exact v_r
    # for the jacobian — error of the order of the fixed-point convergence
    # error itself — and a Chebyshev-compressed dv_r; validated at the
    # posterior level, BASELINE.md)
    dispersion_final: str = 'auto'
    # beta-varying covariance evaluation: 'auto' (default — resolves to
    # 'factored' on gradient-free paths, 'exact' on AD/parity paths),
    # 'exact' (materialise the blended (D, D) covariance + precision per
    # eval and take a dense slogdet — reference semantics float-for-float,
    # ccf_fit.py:195-260,398-413), or 'factored' (MATHEMATICALLY EXACT
    # refactoring, different fp association only: chi^2 contracts the diff
    # against every grid precision ONCE per eval (batched matmuls, no
    # per-eval (D, D) gathers) and scalar-interpolates the quadratic forms
    # — valid because the reference's interpolation is linear in the
    # matrix — while -0.5 log det of the blended covariance comes from a
    # build-time generalized-eigenvalue pencil factorization
    # det((1-t) C_b + t C_end) = det(C_b) * prod_i((1-t) + t lam_i^(b)),
    # O(D) per eval instead of an O(D^3) LU. This is the lever that closes
    # the N-quantile joint scaling tail: at D = N*60 the dense path's
    # per-eval slogdet + stack gathers grow as D^3/D^2 while theory grows
    # linearly in N. Agreement with 'exact' is at fp-roundoff level
    # (tests/test_factored_covariance.py pins ~1e-9 relative in f64).
    beta_covariance: str = 'auto'

    def __post_init__(self):
        # the perf-mode strings select silently-diverging code paths in
        # ccf_theory.py (an unrecognised value would fall through to the
        # exact branch), so a typo must raise here — rsd_model and the
        # physics-model fields are validated at their dispatch sites with
        # the reference's own error messages
        for field, allowed in (
                ('dispersion_interior', ('chebyshev', 'exact')),
                ('dispersion_final', ('auto', 'exact', 'fast')),
                ('streaming_eval', ('auto', 'exact', 'fast')),
                ('beta_covariance', ('auto', 'exact', 'factored')),
                # the reference parses velocity_pdf.form but never reads it
                # (ccf_model.py:94 is its only occurrence) — the gaussian
                # PDF is hard-coded in both codebases, so any other value
                # must raise rather than silently run gaussian
                ('pdf_form', ('gaussian',))):
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(
                    f'{field}={v!r}: must be one of {allowed}')

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class FitOptions:
    """Likelihood-evaluation options (victor/ccf_fit.py:41-42)."""
    beta_interpolation: str = 'datavector'     # 'datavector' | 'likelihood'
    form: str = 'gaussian'
    nmocks: int = 1
    nparams: Optional[int] = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """Static structural facts about the loaded tables (shapes/modes)."""
    poles_r: Tuple[int, ...] = (0, 2)
    poles_s: Tuple[int, ...] = (0, 2)
    fixed_real_input: bool = False
    fixed_data: bool = False
    fixed_covmat: bool = False
    has_velocity_template: bool = False
    has_matter_template: bool = True
    esm_use_eh: bool = True
    # cosmology-grid CAMB mode (models/esm.py:_esm_grid_interp): parameter
    # names of the grid axes, in storage order; () = single-table/EH mode
    esm_grid_names: Tuple[str, ...] = ()
    n_s: int = 30
    n_mu: int = 100
    n_v: int = 50


PERF_MODE_FIELDS = ('streaming_eval', 'dispersion_final', 'beta_covariance')


def resolve_perf_mode(opts: TheoryOptions, gradient_free: bool
                      ) -> TheoryOptions:
    """Resolve 'auto' perf modes for a concrete evaluation path.

    The two fields resolve differently because their AD behavior differs
    (the speed of either mode is not measured on a GPU yet, PERF.md):

    * `streaming_eval`: 'fast' on gradient-free paths only (batched
      likelihood, SMC, NS, MH, ensemble); on AD paths (HMC, NUTS, MAP,
      Fisher) it resolves 'exact', because the degree-48 Clenshaw
      recurrence's sequential reverse-mode transpose is a long serial
      chain of small operations.
    * `dispersion_final`: 'fast' on BOTH paths — it REMOVES two of the
      three exact final-stage passes (and therefore their transposes too);
      its error is of the order of the fixed-point convergence error itself
      and it is posterior-validated.

    All validated shifts <= 0.05 sigma (BASELINE.md round 3). Explicit
    'exact'/'fast' values are always honored — config
    `streaming_eval: exact` / `dispersion_final: exact` is the opt-out;
    direct theory/likelihood calls and parity tests see an unresolved
    'auto', which the theory layer evaluates as exact.

    Logged once per distinct resolution at trace-build time so a run's
    mode is visible in its logs.
    """
    targets = {'streaming_eval': 'fast' if gradient_free else 'exact',
               'dispersion_final': 'fast',
               # 'factored' is a mathematically exact refactoring (see the
               # TheoryOptions field docstring) resolved on gradient-free
               # paths only, so AD/parity paths (gradient_free=False, which
               # the parity suite pins) keep the reference's float-for-float
               # dense-slogdet semantics
               'beta_covariance': 'factored' if gradient_free else 'exact'}
    updates = {f: targets[f] for f in PERF_MODE_FIELDS
               if getattr(opts, f) == 'auto'}
    if not updates:
        return opts
    fast_fields = sorted(f for f, v in updates.items() if v != 'exact')
    if fast_fields:
        import logging
        key = (opts.rsd_model, gradient_free, tuple(fast_fields))
        if key not in _PERF_MODE_LOGGED:
            _PERF_MODE_LOGGED.add(key)
            logging.getLogger('victor_tpu.config').info(
                '%s path: %s resolved to the posterior-validated fast mode '
                "(opt out with explicit 'exact' in the model config)",
                'gradient-free' if gradient_free else 'AD',
                '/'.join(fast_fields))
    return opts.replace(**updates)


_PERF_MODE_LOGGED: set = set()


def theory_options_from_config(model: dict) -> TheoryOptions:
    """Build TheoryOptions from a reference-schema `model:` dict."""
    matter = model.get('matter_ccf', {})
    velocity = model.get('velocity_pdf', {})
    return TheoryOptions(
        rsd_model=model.get('rsd_model', 'streaming'),
        kaiser_approximation=model.get('kaiser_approximation', False),
        kaiser_coord_shift=model.get('kaiser_coord_shift', True),
        assume_isotropic=model.get('realspace_ccf', {}).get('assume_isotropic', True),
        realspace_ccf_from_data=model.get('realspace_ccf', {}).get('from_data', False),
        matter_model=matter.get('model', 'linear_bias'),
        mean_model=velocity.get('mean', {}).get('model', 'linear'),
        empirical_corr=velocity.get('mean', {}).get('empirical_corr', False),
        pdf_form=velocity.get('form', 'gaussian'),
        velocity_independent_of_AP=velocity.get(
            'rescale_templates_independent_of_AP', True),
        niter=model.get('niter', 5),
        dispersion_interior=model.get('dispersion_interior', 'chebyshev'),
        dispersion_final=model.get('dispersion_final', 'auto'),
        streaming_eval=model.get('streaming_eval', 'auto'),
        beta_covariance=model.get('beta_covariance', 'auto'),
    )


def fit_options_from_config(data: dict) -> FitOptions:
    like = data.get('likelihood', {'form': 'Gaussian'})
    return FitOptions(
        beta_interpolation=data.get('beta_interpolation', 'datavector'),
        form=like.get('form', 'gaussian').lower(),
        nmocks=like.get('nmocks', 1),
        nparams=like.get('nparams'),
    )
