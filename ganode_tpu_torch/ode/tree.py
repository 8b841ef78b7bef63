"""Arithmetic over solver states that are tuples of tensors (twin of the
helpers in ``ganode_tpu/ode/tree.py`` that the adaptive solver and the
adjoints use; a JAX pytree state is a tuple here)."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

Tree = Tuple[torch.Tensor, ...]


def tree_lincomb(coeffs: Sequence[float], trees: Sequence[Tree],
                 base: Tree | None = None) -> Tree:
    """``base + sum_i coeffs[i] * trees[i]`` leafwise, summed in the JAX
    order (``base`` first, then each term in turn; without ``base`` the first
    term starts the sum). The coefficients are host scalars, each applied in
    its leaf's dtype."""
    if not trees:
        return base
    out = []
    for j in range(len(trees[0])):
        if base is not None:
            acc, first = base[j], 0
        else:
            acc, first = float(coeffs[0]) * trees[0][j], 1
        for c, t in zip(coeffs[first:], trees[first:]):
            acc = acc + float(c) * t[j]
        out.append(acc)
    return tuple(out)


def tree_zeros_like(tree: Tree) -> Tree:
    return tuple(torch.zeros_like(x) for x in tree)
