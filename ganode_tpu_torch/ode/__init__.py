"""Fixed-grid ODE integration (the fixed-grid part of ``ganode_tpu.ode``)."""
from .solve import odeint, rk_step
from .tableaus import FIXED_GRID, ButcherTableau

__all__ = ["ButcherTableau", "FIXED_GRID", "odeint", "rk_step"]
