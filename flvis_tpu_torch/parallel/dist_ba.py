"""Landmark-sharded sliding-window bundle adjustment over SPMD ranks (port
of flvis_tpu/parallel/dist_ba.py).

Each rank holds a contiguous block of the window's landmark slots (and of
its observation columns) and every pose.  It forms the Schur complement of
its own landmarks — the 3×3 landmark blocks and the back-substitution never
leave it — and only the (W, 6, ·) partial sums of the reduced pose system
cross between ranks, psum-reduced (parallel/mesh.psum: an all-gather and a
sum in rank order) inside backend/window_ba's plain step, as the reference
psums them inside its XLA step.  So the schur_step kernel is not used under
a mesh (window_ba.py:496): the reductions fall inside the step the kernel
runs whole.  Every rank reads the same reduced costs, so the LM loops take
the same steps on every rank.

`chunk_fused_sharded` is the reference's chunk with the sharded window
inside: the tracker replicated on every rank (the same frames, the same
draws), the window BA under the reset and keyframe conds, whose predicates
are the same on every rank, and each frame's Correction re-assembled from
the ranks' rows with one all-gather before the tracker applies it.  It runs
eagerly (each cond and LM predicate read once on the host); the sharded
programs are not captured into CUDA graphs.
"""

from __future__ import annotations

import dataclasses

import torch

from ..backend import window_ba
from ..backend.window_ba import Correction, WindowState
from ..config import BackendConfig
from ..frontend import tracker
from ..utils import control
from ..utils.tree import tree_map
from . import mesh as mesh_m

_LM_FIELDS = ("lm_pw", "lm_id", "lm_valid")             # landmark-major: (L, ...)
_OBS_FIELDS = ("obs_uv", "obs_ur", "obs_ur_valid", "obs_valid")   # (W, L, ...)
_CORR_FIELDS = ("lm_id", "lm_pw", "lm_mask", "outlier_id", "outlier_mask")


def make_lm_mesh(device=None) -> mesh_m.Mesh:
    """Every rank of the process group on the `lm` axis."""
    return mesh_m.make_mesh("lm", device)


def shard_window_state(mesh: mesh_m.Mesh, state: WindowState) -> WindowState:
    """The rank's share of a whole window: its contiguous L/n block of every
    landmark array and observation column (the reference's P("lm") and
    P(None, "lm")), the poses replicated; on the mesh's device."""
    sl = mesh_m.block(mesh, state.capacity)
    out = {}
    for f in dataclasses.fields(state):
        a = getattr(state, f.name)
        if f.name in _LM_FIELDS:
            a = a[sl]
        elif f.name in _OBS_FIELDS:
            a = a[:, sl]
        out[f.name] = a.to(mesh.device).clone()
    return WindowState(**out)


def shard_correction(mesh: mesh_m.Mesh, corr: Correction) -> Correction:
    """The rank's share of a Correction: its block of the landmark arrays."""
    sl = mesh_m.block(mesh, corr.lm_id.shape[0])
    return Correction(**{k: (v[sl] if k in _CORR_FIELDS else v).to(mesh.device).clone()
                         for k, v in corr._asdict().items()})


def gather_correction(mesh: mesh_m.Mesh, corr: Correction) -> Correction:
    """A whole Correction from the ranks' shares: the landmark rows packed
    into one (L/n, 7) float32 block (the int32 ids as their bits) and
    all-gathered once (the reference's tiled all_gather, dist_ba.py:311-315)."""
    f = torch.float32
    rows = torch.cat([corr.lm_pw.to(f), corr.lm_id[:, None].view(f), corr.lm_mask[:, None].to(f),
                      corr.outlier_id[:, None].view(f), corr.outlier_mask[:, None].to(f)], 1)
    g = mesh_m.all_gather(mesh, rows)
    return corr._replace(lm_pw=g[:, :3].to(corr.lm_pw.dtype),
                         lm_id=g[:, 3].contiguous().view(torch.int32), lm_mask=g[:, 4] > 0.5,
                         outlier_id=g[:, 5].contiguous().view(torch.int32),
                         outlier_mask=g[:, 6] > 0.5)


def optimize_sharded(cfg: BackendConfig, mesh: mesh_m.Mesh, cam, state: WindowState):
    """The two-phase windowed BA with the landmark axis sharded: `state` is
    the rank's share (shard_window_state); window_ba.optimize under the
    mesh.  Returns (poses SE3 (W,), the rank's lm_pw block (L/n, 3), cost)."""
    res = window_ba.optimize(cfg, cam, state, mesh=mesh)
    return res.state.poses(), res.state.lm_pw, res.cost


def chunk_fused_sharded(fcfg, bcfg: BackendConfig, mesh: mesh_m.Mesh, cam, fe_state,
                        ba_state: WindowState, corr: Correction, imgs0, imgs1, draws=None,
                        generator=None):
    """The fused stereo chunk (runner._fused_frame_step a frame) with the
    window BA landmark-sharded: fe_state whole on every rank, ba_state and
    corr the rank's shares (shard_window_state, shard_correction), imgs0 /
    imgs1 (T, H, W) the same on every rank.  Frame i's tracker draws are
    draws[i] (a sequence of tracker.Draws) or come from `generator`, which
    must start from the same seed on every rank.  Returns (fe_state,
    ba_state, corr, (FrameOutput stacked over T, BA costs (T,)))."""
    null = window_ba.null_correction_like(ba_state)
    dev = fe_state.status.device
    outs, costs = [], []
    for i in range(imgs0.shape[0]):
        fe = tracker.apply_correction(fe_state, gather_correction(mesh, corr))
        d = draws[i] if draws is not None else tracker.make_draws(fcfg, generator, dev)
        fe_state, out = tracker.track_frame(fcfg, cam, fe, imgs0[i], imgs1[i], draws=d)
        ba = control.cond(out.reset_backend, lambda b: window_ba.reset(bcfg, b),
                          lambda b: b, (ba_state,), name="reset")
        pkt = tracker.make_keyframe_packet(fe_state, out)

        def do_kf(b):
            res = window_ba.optimize(bcfg, cam, window_ba.add_keyframe(bcfg, b, pkt, mesh),
                                     mesh=mesh)
            return res.state, res.correction, res.cost

        def no_kf(b):
            return b, null, torch.zeros((), dtype=torch.float32, device=dev)

        ba_state, corr, cost = control.cond(out.is_keyframe, do_kf, no_kf, (ba,),
                                            name="keyframe")
        outs.append(out)
        costs.append(cost)
    return fe_state, ba_state, corr, (tree_map(lambda *a: torch.stack(a), *outs),
                                      torch.stack(costs))
