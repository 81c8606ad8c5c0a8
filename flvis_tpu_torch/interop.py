"""State carried between the JAX package and this port.

A record — TrackerState / LandmarkTable, WindowState, KeyframePacket,
Correction, StereoCamera, SE3, FrameOutput, of either package — converts
to a dict of numpy arrays keyed by field name (nested records become
nested dicts), and a dict converts back into a record shaped like a
template of the target package.  Both packages share field names, so a
test can start the JAX reference and the port from the same mid-sequence
state.  This module imports neither JAX nor anything of the JAX package:
it reads records by duck typing (dataclass fields, NamedTuple fields,
`np.asarray` on the leaves).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _fields(record):
    if dataclasses.is_dataclass(record) and not isinstance(record, type):
        return [f.name for f in dataclasses.fields(record)]
    if isinstance(record, tuple) and hasattr(record, "_fields"):
        return list(record._fields)
    return None


def to_numpy(record):
    """Record (JAX or torch) → nested dict of numpy arrays.  Plain Python
    values (a camera's width/height) are kept as they are."""
    names = _fields(record)
    if names is not None:
        return {n: to_numpy(getattr(record, n)) for n in names}
    if isinstance(record, torch.Tensor):
        return record.detach().cpu().numpy()
    if isinstance(record, (int, float, bool, str)) or record is None:
        return record
    return np.asarray(record)


def from_numpy(d, like, convert):
    """Nested dict → a record of the same type and structure as `like`,
    every array leaf passed through `convert` (e.g. jnp.asarray, or
    `to_torch(device)`).  Leaves keep the dtype of the dict's arrays; a
    template leaf may be a placeholder such as None (only plain Python
    values in the template — a camera's width — are kept as they are)."""
    names = _fields(like)
    if names is None:
        if isinstance(like, (int, float, bool, str)):
            return d
        return convert(np.asarray(d))
    return type(like)(**{n: from_numpy(d[n], getattr(like, n), convert) for n in names})


def to_torch(device):
    """The `convert` for from_numpy into this port: a tensor on `device`."""
    def convert(a):
        return torch.from_numpy(np.array(a)).to(device)

    return convert


def to_pose_graph(graph, device):
    """A pose graph of either package, or a dict of its node and edge
    arrays, → the port's loop.pose_graph.PoseGraph on `device`: poses and
    edge weights float32, edge indices int64, masks bool."""
    from .loop.pose_graph import PoseGraph

    d = graph if isinstance(graph, dict) else to_numpy(graph)
    kinds = {"edge_i": np.int64, "edge_j": np.int64, "node_valid": bool, "edge_valid": bool}
    return PoseGraph(**{f.name: torch.from_numpy(np.array(d[f.name], kinds.get(f.name, np.float32)))
                        .to(device) for f in dataclasses.fields(PoseGraph)})
