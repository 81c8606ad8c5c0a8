"""Honest device synchronisation for benchmarking (port of
flvis_tpu/utils/timing.py).

CUDA work is asynchronous: a timer read right after a call measures only
its launch.  `sync(tree)` after the timed region waits for the devices that
hold the tree's tensors: one torch.cuda.synchronize per CUDA device among
the tensor leaves (the reference fetches a value that data-depends on
every leaf, since its remote backend's block_until_ready returned early;
torch's synchronize is a true barrier).  CPU tensors need nothing.
"""

from __future__ import annotations

import torch

from .tree import tree_leaves


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return tree_leaves(tree)


def sync(tree) -> None:
    """Block until every tensor leaf of `tree` (a tensor, a record of the
    port, or a dict, list or tuple of them) is computed."""
    devices = {leaf.device for leaf in _leaves(tree) if leaf.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
