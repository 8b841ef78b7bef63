"""Arithmetic over trees of tensors (twin of the helpers in
``ganode_tpu/ode/tree.py``). A tree is a tuple of tensors (a solver state, as
the adaptive solver and the adjoints carry it) or a dict of name -> tensor
(one network's parameters, as the ODE-GAN trainer steps them): the JAX
pytrees each stands for."""
from __future__ import annotations

import functools
from typing import Callable, Dict, Sequence, Tuple, Union

import torch

Tree = Union[Tuple[torch.Tensor, ...], Dict[str, torch.Tensor]]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` leafwise over trees of one structure (a dict's by its keys)."""
    if isinstance(tree, dict):
        return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
    return tuple(fn(*leaves) for leaves in zip(tree, *rest))


def tree_leaves(tree: Tree) -> list:
    """The leaves in JAX's order: a dict's by sorted key."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return list(tree)


def tree_axpy(c: float, x: Tree, y: Tree) -> Tree:
    """``y + c * x`` leafwise, ``c`` a host scalar applied in each leaf's
    dtype."""
    return tree_map(lambda xi, yi: yi + float(c) * xi, x, y)


def tree_lincomb(coeffs: Sequence[float], trees: Sequence[Tree],
                 base: Tree | None = None) -> Tree:
    """``base + sum_i coeffs[i] * trees[i]`` leafwise, summed in the JAX
    order (``base`` first, then each term in turn; without ``base`` the first
    term starts the sum). The coefficients are host scalars, each applied in
    its leaf's dtype."""
    if not trees:
        return base

    def leaf(*leaves):
        if base is not None:
            acc, terms, cs = leaves[0], leaves[1:], coeffs
        else:
            acc, terms, cs = float(coeffs[0]) * leaves[0], leaves[1:], coeffs[1:]
        for c, t in zip(cs, terms):
            acc = acc + float(c) * t
        return acc

    return tree_map(leaf, *([base] if base is not None else []), *trees)


def tree_sq_norm(a: Tree) -> torch.Tensor:
    """``sum_i sum(a_i ** 2)`` over the leaves in JAX's order, in the
    leaves' dtype."""
    return functools.reduce(torch.add, (torch.sum(torch.square(x))
                                        for x in tree_leaves(a)))


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)
