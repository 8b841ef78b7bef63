"""ODE integration (twin of ``ganode_tpu.ode``): fixed-grid Runge-Kutta,
adaptive dopri5, and their continuous adjoints. SDEs and CDEs wait for
ROADMAP M10."""
from .adaptive import odeint_adaptive, odeint_adaptive_adjoint
from .adjoint import odeint_backsolve
from .solve import SolveStats, nfe_fixed_grid, odeint, odeint_final, rk_step
from .tableaus import ADAPTIVE, DOPRI5, FIXED_GRID, ButcherTableau

__all__ = ["ADAPTIVE", "ButcherTableau", "DOPRI5", "FIXED_GRID", "SolveStats",
           "nfe_fixed_grid", "odeint", "odeint_adaptive",
           "odeint_adaptive_adjoint", "odeint_backsolve", "odeint_final",
           "rk_step"]
