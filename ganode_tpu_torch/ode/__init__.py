"""Differential-equation solvers (twin of ``ganode_tpu.ode``): fixed-grid
Runge-Kutta, adaptive dopri5 and their continuous adjoints; SDEs (Euler,
Milstein, reversible Heun and its exact adjoint); CDEs over cubic splines."""
from .adaptive import odeint_adaptive, odeint_adaptive_adjoint
from .adjoint import odeint_backsolve
from .cde import cdeint
from .sde import brownian_increments, sdeint, sdeint_reversible_adjoint
from .solve import SolveStats, nfe_fixed_grid, odeint, odeint_final
from .spline import (
    CubicSpline,
    hermite_cubic_coefficients,
    linear_coefficients,
    natural_cubic_coefficients,
)
from .tableaus import ADAPTIVE, DOPRI5, FIXED_GRID, ButcherTableau

__all__ = ["ADAPTIVE", "ButcherTableau", "CubicSpline", "DOPRI5", "FIXED_GRID",
           "SolveStats", "brownian_increments", "cdeint",
           "hermite_cubic_coefficients", "linear_coefficients",
           "natural_cubic_coefficients", "nfe_fixed_grid", "odeint",
           "odeint_adaptive", "odeint_adaptive_adjoint", "odeint_backsolve",
           "odeint_final", "sdeint", "sdeint_reversible_adjoint"]
