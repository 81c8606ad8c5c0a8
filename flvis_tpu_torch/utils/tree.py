"""Structure-wise maps over the port's state records (frozen dataclasses,
NamedTuples, plain tuples and lists of tensors) — the counterpart of
jax.tree.map for the records this package defines.  Non-tensor leaves
(static ints such as a camera's width, None) are taken from the first
record unchanged."""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, *rest):
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name), *[getattr(r, f.name) for r in rest])
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, *leaves) for leaves in zip(tree, *rest)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    return tree


def tree_leaves(tree) -> list:
    """The tensor leaves of `tree`, in tree_map's order."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def tree_spec(tree) -> str:
    """`tree`'s structure as a comparable string: its records and non-tensor
    leaves, each tensor as its (shape, dtype, device)."""
    return repr(tree_map(lambda t: (tuple(t.shape), t.dtype, t.device), tree))


def tree_where(cond, a, b):
    """Leafwise torch.where(cond, a, b) for a scalar (0-d) condition."""
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)
