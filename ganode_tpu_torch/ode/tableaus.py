"""Butcher tableaus for the explicit fixed-grid Runge-Kutta steppers (the
fixed-grid part of ``ganode_tpu/ode/tableaus.py``; dopri5 and the adaptive
solver wait for ROADMAP M9).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    """Explicit RK tableau. a is strictly lower-triangular, given as row tuples."""

    a: Tuple[Tuple[float, ...], ...]
    b: Tuple[float, ...]
    c: Tuple[float, ...]
    order: int = 1

    @property
    def stages(self) -> int:
        return len(self.b)


EULER = ButcherTableau(a=((),), b=(1.0,), c=(0.0,), order=1)

# Explicit midpoint.
MIDPOINT = ButcherTableau(
    a=((), (0.5,)),
    b=(0.0, 1.0),
    c=(0.0, 0.5),
    order=2,
)

# Heun's method (a.k.a. explicit trapezoid / RK2) — what the reference calls "rk2".
HEUN2 = ButcherTableau(
    a=((), (1.0,)),
    b=(0.5, 0.5),
    c=(0.0, 1.0),
    order=2,
)

# Kutta's third-order method.
RK3 = ButcherTableau(
    a=((), (0.5,), (-1.0, 2.0)),
    b=(1 / 6, 2 / 3, 1 / 6),
    c=(0.0, 0.5, 1.0),
    order=3,
)

# The classic RK4 — the reference's workhorse latent-dynamics solver.
RK4 = ButcherTableau(
    a=((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
    b=(1 / 6, 1 / 3, 1 / 3, 1 / 6),
    c=(0.0, 0.5, 0.5, 1.0),
    order=4,
)

# 3/8 rule fourth-order variant.
RK38 = ButcherTableau(
    a=((), (1 / 3,), (-1 / 3, 1.0), (1.0, -1.0, 1.0)),
    b=(1 / 8, 3 / 8, 3 / 8, 1 / 8),
    c=(0.0, 1 / 3, 2 / 3, 1.0),
    order=4,
)

FIXED_GRID: dict[str, ButcherTableau] = {
    "euler": EULER,
    "midpoint": MIDPOINT,
    "rk2": HEUN2,
    "heun": HEUN2,
    "rk3": RK3,
    "rk4": RK4,
    "rk38": RK38,
}
