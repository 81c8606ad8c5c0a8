"""Checkpoint/resume for SLAM state (port of flvis_tpu/utils/checkpoint.py).

Any of the port's state records (TrackerState, WindowState, VioState,
Correction, ... — dataclasses and NamedTuples of tensors, in dicts, tuples
and lists) round-trips through a single .npz keyed by its flattened field
path joined by "/", with structure checked against a template on load.
The file format and key names are the JAX package's, so a checkpoint
written by either package loads into the other.  No pickle — files are
plain arrays.

What the port adds to a file, under keys the JAX package does not read:
the state of the random generators the port draws from (SlamSystem's
`generator`, MultiSeqSlam's `generators`; the JAX package folds its draws
from the frame id and carries no key).  A file without them leaves the
generators as they are.  The pending correction is not saved, as in the
JAX package: a resumed system starts from the null correction.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
import torch

from ..geometry.se3 import SE3
from .tree import tree_map

GENERATOR_KEY = "rng/generator"          # SlamSystem.generator.get_state()
GENERATORS_KEY = "rng/generators"        # MultiSeqSlam.generators, (S, n) stacked


def _children(tree):
    """(key, child) pairs of a record, dict, tuple or list; None for a leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)
                if f.init]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = ""):
    """[(key, tensor)] over the tensor leaves of `tree`; other leaves (a
    camera's width) are static and not saved."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    out = []
    for k, c in _children(tree) or []:
        out += _flatten(c, f"{prefix}/{k}" if prefix else str(k))
    return out


def _numpy_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_pytree(path: str, tree, extra: dict | None = None) -> None:
    """Write the tensor leaves of `tree` to `path` (.npz), plus `extra`
    arrays under their own keys."""
    arrays = {k: _host(t) for k, t in _flatten(tree)}
    arrays.update(extra or {})
    np.savez_compressed(path, **arrays)


def _unflatten(template, data, prefix: str = ""):
    if isinstance(template, torch.Tensor):
        if prefix not in data:
            raise KeyError(f"checkpoint missing leaf {prefix!r}")
        arr = data[prefix]
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"leaf {prefix!r}: shape {arr.shape} != template "
                             f"{tuple(template.shape)}")
        arr = np.array(arr, dtype=_numpy_dtype(template.dtype))    # 0-d stays 0-d
        return torch.from_numpy(arr).to(template.device)
    kids = _children(template)
    if kids is None:
        return template
    vals = {k: _unflatten(c, data, f"{prefix}/{k}" if prefix else str(k)) for k, c in kids}
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **vals)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(**vals)
    if isinstance(template, dict):
        return vals
    return type(template)(vals[str(i)] for i in range(len(template)))


def load_pytree(path: str, template):
    """Load a tree saved by save_pytree (by either package), using
    `template` for structure: each leaf must be in the file with the
    template's shape, is cast to the template's dtype and placed on its
    device; non-tensor leaves come from the template."""
    with np.load(path) as data:
        return _unflatten(template, {k: data[k] for k in data.files})


def _stack(records):
    return tree_map(lambda *a: torch.stack(a), *records)


def _split(stacked, n: int):
    return [tree_map(lambda a: a[s].clone(), stacked) for s in range(n)]


def _traj_rows(trajectory) -> np.ndarray:
    return np.asarray([[fid, t, *np.asarray(q), *np.asarray(tt)]
                       for (fid, t, q, tt) in trajectory], np.float64).reshape(-1, 9)


def _traj_list(rows) -> list:
    return [(int(r[0]), float(r[1]), r[2:6].astype(np.float32), r[6:9].astype(np.float32))
            for r in rows]


def _set_generator(g: torch.Generator, state) -> None:
    """Restore g from a saved state; a state of another kind of generator
    (saved on another device type) leaves g as it is, with a warning."""
    state = torch.from_numpy(np.ascontiguousarray(state, np.uint8))
    if state.numel() != g.get_state().numel():
        warnings.warn(f"checkpoint: a saved {state.numel()}-byte generator state does not fit "
                      f"this {g.device.type} generator; its draws continue from its own state")
        return
    g.set_state(state)


# ----------------------------------------------------------------- SlamSystem
def save_slam_system(path: str, slam) -> None:
    """Checkpoint a pipeline.runner.SlamSystem (frontend + backend + VIO
    state, the trajectory log and its generator's state; the loop node in
    `path + ".loop.npz"`).  A pipelined system drains its in-flight chunk
    and deferred loop batches first, so the snapshot is stream-consistent."""
    stage = slam.loop_stage
    if slam._inflight is not None or (stage is not None and (stage.gate is not None
                                                             or stage.verify is not None)):
        slam.flush()
    save_pytree(path, {"fe": slam.fe_state, "ba": slam.ba_state, "vio": slam.vio_state},
                extra={GENERATOR_KEY: _host(slam.generator.get_state())})
    np.save(path + ".traj.npy", _traj_rows(slam.trajectory))
    if slam.loop_closer is not None:
        save_loop_closer(path + ".loop.npz", slam.loop_closer)


def load_slam_system(path: str, slam) -> None:
    """Restore a SlamSystem checkpoint in place (slam provides templates).
    Assigning the state is enough for a system whose frame step is already
    captured: each chunk copies the state into the graph's buffers."""
    state = load_pytree(path, {"fe": slam.fe_state, "ba": slam.ba_state,
                               "vio": slam.vio_state})
    slam.fe_state, slam.ba_state, slam.vio_state = state["fe"], state["ba"], state["vio"]
    with np.load(path) as d:
        if GENERATOR_KEY in d.files:
            _set_generator(slam.generator, d[GENERATOR_KEY])
    slam.trajectory = _traj_list(np.load(path + ".traj.npy"))
    # Host mirror of fe_state.frame_id (one trajectory entry per frame).
    slam._frames_processed = len(slam.trajectory)
    if slam.loop_closer is not None and os.path.exists(path + ".loop.npz"):
        load_loop_closer(path + ".loop.npz", slam.loop_closer)


# ----------------------------------------------------------------- LoopCloser
def save_loop_closer(path: str, lc) -> None:
    """Checkpoint a loop.loop_closing.LoopCloser: keyframe database (BoW
    vectors, ORB features, keypoint 3D), node poses, accepted closures,
    drift transform, and the trained vocabulary.  Descriptors are written
    as uint32, the JAX package's dtype (the same bits).  A keyframe-sharded
    LoopCloser's database is gathered first: every rank calls this."""
    np.savez_compressed(path, **_loop_arrays(lc))


def _loop_arrays(lc) -> dict:
    """save_loop_closer's arrays."""
    n = lc.count
    arrays = {
        "bow_db": _host(lc._whole_db()[:n]),      # a sharded database gathered
        "kf_uv": _host(lc.kf_uv[:n]), "kf_desc": _host(lc.kf_desc[:n]).view(np.uint32),
        "kf_kp_valid": _host(lc.kf_kp_valid[:n]),
        "kf_pc": _host(lc.kf_pc[:n]),
        "kf_pc_valid": _host(lc.kf_pc_valid[:n]),
        "kf_frame_id": lc.kf_frame_id[:n],
        "T_wc_odom_q": _host(lc.kf_q_odom[:n]),
        "T_wc_odom_t": _host(lc.kf_t_odom[:n]),
        "T_wc_q": _host(lc.kf_q[:n]),
        "T_wc_t": _host(lc.kf_t[:n]),
        "closures": np.asarray(
            [[c.kf_i, c.kf_j, c.num_inliers, *_host(torch.as_tensor(c.T_ij.q)),
              *_host(torch.as_tensor(c.T_ij.t))] for c in lc.closures],
            np.float64).reshape(-1, 10),
        "T_map_odom_q": _host(lc.T_map_odom.q),
        "T_map_odom_t": _host(lc.T_map_odom.t),
    }
    if lc.vocab is not None:
        arrays["vocab_words"] = _host(lc.vocab.words_pm1)
        arrays["vocab_idf"] = _host(lc.vocab.idf)
    return arrays


def load_loop_closer(path: str, lc) -> None:
    """Restore a LoopCloser checkpoint in place (lc provides the device;
    its tables grow to the file's keyframe count).  The closures come back
    with host T_ij, as the live path makes them."""
    from ..loop import bow
    from ..loop.loop_closing import LoopClosure

    dev = lc.device

    def dev_t(a, dtype=None):
        return torch.from_numpy(np.array(a)).to(dev, dtype)

    with np.load(path) as f:
        d = {k: f[k] for k in f.files}
    n = len(d["kf_frame_id"])
    while n > lc.capacity:
        lc._grow()
    if "vocab_words" in d:
        lc.vocab = bow.Vocabulary(dev_t(d["vocab_words"], torch.float32),
                                  dev_t(d["vocab_idf"], torch.float32))
    lc.count = n
    db = dev_t(d["bow_db"], torch.float32)
    if lc.mesh is None:
        lc.bow_db[:n] = db
    else:
        # A keyframe-sharded database keeps its own rows only.
        from ..parallel import dist_loop

        own = dist_loop.row_range(lc.mesh, lc.bow_db)
        hi = min(own.stop, n)
        if own.start < hi:
            lc.bow_db[:hi - own.start] = db[own.start:hi]
    lc.kf_uv[:n] = dev_t(d["kf_uv"], torch.float32)
    lc.kf_desc[:n] = dev_t(np.asarray(d["kf_desc"]).view(np.int32))
    lc.kf_kp_valid[:n] = dev_t(d["kf_kp_valid"], torch.bool)
    lc.kf_pc[:n] = dev_t(d["kf_pc"], torch.float32)
    lc.kf_pc_valid[:n] = dev_t(d["kf_pc_valid"], torch.bool)
    lc.kf_frame_id[:n] = d["kf_frame_id"]
    lc.kf_q_odom[:n] = dev_t(d["T_wc_odom_q"], torch.float32)
    lc.kf_t_odom[:n] = dev_t(d["T_wc_odom_t"], torch.float32)
    lc.kf_q[:n] = dev_t(d["T_wc_q"], torch.float32)
    lc.kf_t[:n] = dev_t(d["T_wc_t"], torch.float32)
    lc.closures = [
        LoopClosure(int(r[0]), int(r[1]), int(r[2]),
                    SE3(torch.as_tensor(r[3:7], dtype=torch.float32),
                        torch.as_tensor(r[7:10], dtype=torch.float32)))
        for r in d["closures"]]
    lc.T_map_odom = SE3(dev_t(d["T_map_odom_q"], torch.float32),
                        dev_t(d["T_map_odom_t"], torch.float32))
    if lc._kf_imgs is not None:
        # The saved keyframes' images are not in the file: no match image
        # for a closure that reaches one of them.
        lc._kf_imgs = [None] * n


# --------------------------------------------------------------- MultiSeqSlam
def _multiseq_states(ms) -> dict:
    """MultiSeqSlam's per-sequence records, each stacked on a leading S
    axis: the JAX package's batched layout."""
    state = {"fe": _stack(ms.fe), "ba": _stack(ms.ba), "corr": _stack(ms.corr)}
    if ms.vio is not None:
        state["vio"] = _stack(ms.vio)
    return state


def save_multiseq(path: str, ms) -> None:
    """Checkpoint a parallel.multiseq_loop.MultiSeqSlam: the (tracker, BA,
    correction[, VIO]) states stacked over the S sequences, the generators'
    states, per-sequence trajectories, and each sequence's loop node.
    Drains the in-flight chunk and deferred loop batches first.  A system
    over a mesh (every rank calls this) gathers its ranks' blocks, and the
    primary writes the one file set of the whole system."""
    from ..parallel import mesh as mesh_m

    ms.flush()
    states = _multiseq_states(ms)
    gens = np.stack([_host(g.get_state()) for g in ms.generators])
    trajs = [_traj_rows(t) for t in ms.trajectories]
    loops = [_loop_arrays(lc) if lc is not None else None for lc in ms.loopers]
    if ms.mesh is not None:
        states = {k: tree_map(lambda a: mesh_m.all_gather(ms.mesh, a), v)
                  for k, v in states.items()}
        gens = np.concatenate(mesh_m.all_gather_object(ms.mesh, gens))
        trajs = sum(mesh_m.all_gather_object(ms.mesh, trajs), [])
        loops = sum(mesh_m.all_gather_object(ms.mesh, loops), [])
    if ms.mesh is None or ms.mesh.rank == 0:
        save_pytree(path, states, extra={GENERATORS_KEY: gens})
        for s in range(ms.S):
            np.save(f"{path}.traj{s}.npy", trajs[s])
            if loops[s] is not None:
                np.savez_compressed(f"{path}.loop{s}.npz", **loops[s])
    if ms.mesh is not None:
        mesh_m.barrier(ms.mesh)         # the files exist before any rank reads them


def load_multiseq(path: str, ms) -> None:
    """Restore a MultiSeqSlam checkpoint in place (ms provides templates,
    sequence count, and loop-node device): the stacked states are split
    into one record per sequence — over a mesh, each rank takes its own
    block's."""
    seqs = ms.seqs
    n = len(seqs)
    template = {k: tree_map(lambda a: a.new_empty((ms.S,) + tuple(a.shape[1:])), v)
                for k, v in _multiseq_states(ms).items()}
    state = {k: tree_map(lambda a: a[seqs.start:seqs.stop], v)
             for k, v in load_pytree(path, template).items()}
    ms.fe, ms.ba, ms.corr = (_split(state[k], n) for k in ("fe", "ba", "corr"))
    if ms.vio is not None:
        ms.vio = _split(state["vio"], n)
    with np.load(path) as d:
        if GENERATORS_KEY in d.files:
            for g, st in zip(ms.generators, d[GENERATORS_KEY][seqs.start:seqs.stop]):
                _set_generator(g, st)
    for i, s in enumerate(seqs):
        ms.trajectories[i] = _traj_list(np.load(f"{path}.traj{s}.npy"))
        lp = f"{path}.loop{s}.npz"
        if ms.loopers[i] is not None and os.path.exists(lp):
            load_loop_closer(lp, ms.loopers[i])
    ms._frames = len(ms.trajectories[0])
