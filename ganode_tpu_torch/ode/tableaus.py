"""Butcher tableaus for the explicit Runge-Kutta steppers (twin of
``ganode_tpu/ode/tableaus.py``): the fixed-grid methods, and Dormand-Prince
5(4) with its embedded 4th-order error weights for the adaptive solver. The
JAX file's dense-output coefficients are left out: the adaptive solver clips
its steps to land on each output time, so nothing interpolates.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    """Explicit RK tableau. a is strictly lower-triangular, given as row tuples."""

    a: Tuple[Tuple[float, ...], ...]
    b: Tuple[float, ...]
    c: Tuple[float, ...]
    # embedded lower-order weights for error estimation (adaptive methods)
    b_err: Optional[Tuple[float, ...]] = None
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

# Dormand-Prince 5(4): 7 stages, FSAL, with embedded 4th-order error weights.
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (
    5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
    -92097 / 339200, 187 / 2100, 1 / 40,
)
DOPRI5 = ButcherTableau(
    a=_DP_A,
    b=_DP_B5,
    c=(0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
    b_err=tuple(b5 - b4 for b5, b4 in zip(_DP_B5, _DP_B4)),
    order=5,
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

ADAPTIVE: dict[str, ButcherTableau] = {
    "dopri5": DOPRI5,
}
