from .splines import (Spline1D, PchipTable, Bicubic2D, ppoly_eval,
                      cubic_deriv_operator, hermite_coeffs, spline_eval_matrix,
                      gradient_matrix, pchip_coeffs, bicubic_cell_coeffs,
                      cubic_coeffs_dynamic, ppoly_eval_dynamic,
                      gradient_nonuniform, matmul_highest)
from .integrate import trapz_weights, simpson_weights, gauss_legendre
from .legendre import legendre_p
from .operators import (multipole_projection_matrix, enclosed_density_operator,
                        resampled_gradient_operator)
from .special import hyp2f1_growth, growth_factor_lcdm

__all__ = [
    'Spline1D', 'PchipTable', 'Bicubic2D', 'ppoly_eval',
    'cubic_deriv_operator', 'hermite_coeffs', 'spline_eval_matrix',
    'gradient_matrix', 'pchip_coeffs', 'bicubic_cell_coeffs',
    'trapz_weights', 'simpson_weights', 'gauss_legendre', 'legendre_p',
    'multipole_projection_matrix', 'enclosed_density_operator',
    'resampled_gradient_operator', 'hyp2f1_growth', 'growth_factor_lcdm',
    'cubic_coeffs_dynamic', 'ppoly_eval_dynamic', 'gradient_nonuniform',
    'matmul_highest',
]
