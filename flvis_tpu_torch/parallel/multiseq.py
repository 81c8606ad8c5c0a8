"""Multi-sequence replay: S independent SLAM runs through one chunk step
(port of flvis_tpu/parallel/multiseq.py).

The reference batches the S sequences with vmap into one device program
per chunk (scan over frames of the vmapped frame step).  Here the S
sequences keep their own states (lists of per-sequence records) and step
frame-major: for each frame, each sequence, through the single-sequence
frame functions of pipeline/runner (`_stereo_frame_core`,
`_vio_frame_core`, `_ba_tail`), so every kernel of the single-sequence
path runs on every sequence.  Batching the S sequences into one launch
per op (stacked states, device selects for the host branches) is the next
step on this path (ROADMAP).  The mesh and shard_map variants need more
than one device and are not ported (ROADMAP Queue 1 item 10).

Window-BA cadence (`ba_every`, multiseq.py:164-258):
  - 1: per keyframe, exactly the single-sequence step (runner's
    _fused_frame_step / _fused_vio_frame_step);
  - N > 1: keyframes enter each window every frame, and the window solve
    runs for every sequence on the chunk's frames t with t % N == N − 1;
    its Correction is applied on the next frame.
The reference turns its Pallas Schur step off for the batched windows
(`_batched_bcfg`), because that kernel takes one window; the port's
schur kernel (csrc/schur.cu) runs per window, so every solve here keeps
it.  The PnP rescue is off for batched runs, as in the reference
(`_batched_fcfg`).

Random draws: each sequence's tracker draws come from its own
torch.Generator (`generators`), or from the draws a test hands in.  The
steps run eagerly: each cond of the frame step reads the host once
(utils/control.cond), as the host branches it replaced did.
"""

from __future__ import annotations

import dataclasses

import torch

from ..backend import window_ba
from ..config import BackendConfig, FrontendConfig, VioConfig
from ..frontend import tracker
from ..pipeline import runner as runner_m
from ..utils.tree import tree_map
from ..vio import vimotion


def _batched_fcfg(fcfg: FrontendConfig) -> FrontendConfig:
    # The reference's vmapped PnP-rescue lax.cond lowers to a select that
    # every frame pays, so batched runs disable it (multiseq.py:135-142);
    # the port keeps that configuration so both compute the same thing.
    return dataclasses.replace(fcfg, pnp_fallback=False)


def _stack(outs):
    """[S][T] FrameOutputs → one FrameOutput with leading (S, T)."""
    return tree_map(lambda *a: torch.stack(a), *[
        tree_map(lambda *b: torch.stack(b), *row) for row in outs])


def init_states(cfg: FrontendConfig, num_seqs: int, *, device):
    """S fresh tracker states."""
    return [tracker.init_state(cfg, device=device) for _ in range(num_seqs)]


def init_system_states(fcfg: FrontendConfig, bcfg: BackendConfig, num_seqs: int, *, device,
                       vcfg: VioConfig | None = None):
    """Per-sequence (tracker states, BA windows, pending corrections[, VIO
    states]); the pending corrections start as the null correction
    (valid=False, applies nothing)."""
    out = (init_states(fcfg, num_seqs, device=device),
           [window_ba.empty(bcfg, device=device) for _ in range(num_seqs)],
           [window_ba.null_correction(bcfg, device=device)] * num_seqs)
    if vcfg is not None:
        out += ([vimotion.init_state(vcfg, device=device) for _ in range(num_seqs)],)
    return out


def track_frame_batch(cfg: FrontendConfig, cams, states, imgs0, imgs1, generators):
    """One tracking step for S sequences: imgs (S, H, W).  Returns (states,
    FrameOutput with a leading (S,))."""
    cfg = _batched_fcfg(cfg)
    new, outs = [], []
    for cam, st, a, b, g in zip(cams, states, imgs0, imgs1, generators):
        st, out = tracker.track_frame(cfg, cam, st, a, b, generator=g)
        new.append(st)
        outs.append(out)
    return new, tree_map(lambda *a: torch.stack(a), *outs)


def track_frames_scan_batch(cfg: FrontendConfig, cams, states, imgs0, imgs1, generators):
    """Tracking over a chunk for S sequences, frame-major: imgs (S, T, H,
    W).  Returns (states, FrameOutput with leading (S, T))."""
    cfg = _batched_fcfg(cfg)
    states = list(states)
    S, T = imgs0.shape[:2]
    outs = [[None] * T for _ in range(S)]
    for t in range(T):
        for s in range(S):
            states[s], outs[s][t] = tracker.track_frame(cfg, cams[s], states[s], imgs0[s, t],
                                                        imgs1[s, t], generator=generators[s])
    return states, _stack(outs)


def _chunk(bcfg, cams, bas, corrs, T: int, S: int, ba_every: int, frame):
    """The chunk loop shared by the stereo and VIO variants; frame(s, t,
    corr) runs sequence s's frame core on frame t and returns (fe, out).
    Returns (bas, corrs, outs [S][T], costs (S, T))."""
    bas, corrs = list(bas), list(corrs)
    null = window_ba.null_correction(bcfg, device=cams[0].fx.device)
    outs = [[None] * T for _ in range(S)]
    costs = [[None] * T for _ in range(S)]
    for t in range(T):
        for s in range(S):
            fe, out = frame(s, t, corrs[s])
            corrs[s] = null
            outs[s][t] = out
            if ba_every == 1:
                bas[s], _, corrs[s], costs[s][t] = runner_m._ba_tail(bcfg, cams[s], null,
                                                                     bas[s], fe, out)
                continue
            costs[s][t] = torch.zeros((), device=cams[s].fx.device)
            if bool(out.reset_backend):
                bas[s] = window_ba.reset(bcfg, bas[s])
            if bool(out.is_keyframe):
                bas[s] = window_ba.add_keyframe(bcfg, bas[s],
                                                tracker.make_keyframe_packet(fe, out))
        if ba_every > 1 and t % ba_every == ba_every - 1:
            for s in range(S):
                res = window_ba.optimize(bcfg, cams[s], bas[s])
                bas[s], corrs[s], costs[s][t] = res.state, res.correction, res.cost
    return bas, corrs, outs, torch.stack([torch.stack(c) for c in costs])


def system_chunk_batch(fcfg: FrontendConfig, bcfg: BackendConfig, cams, fe_states,
                       ba_states, corrs, imgs0, imgs1, generators, ba_every: int = 1):
    """Tracking + window BA + correction feedback over a chunk for S
    sequences: imgs (S, T, H, W).  Returns (fe_states, ba_states, corrs,
    FrameOutput (S, T), BA costs (S, T); 0 on frames without a solve)."""
    fcfg = _batched_fcfg(fcfg)
    fes = list(fe_states)
    S, T = imgs0.shape[:2]

    def frame(s, t, corr):
        draws = tracker.make_draws(fcfg, generators[s], imgs0.device)
        fes[s], out = runner_m._stereo_frame_core(fcfg, cams[s], fes[s], corr, imgs0[s, t],
                                                  imgs1[s, t], draws)
        return fes[s], out

    bas, corrs, outs, costs = _chunk(bcfg, cams, ba_states, corrs, T, S, ba_every, frame)
    return fes, bas, corrs, _stack(outs), costs


def system_chunk_batch_vio(fcfg: FrontendConfig, bcfg: BackendConfig, vcfg: VioConfig, cams,
                           T_i_cs, fe_states, ba_states, vio_states, corrs, imgs0, imgs1, ts,
                           acc, gyro, imu_t, imu_valid, generators, ba_every: int = 1):
    """system_chunk_batch with the VIO frame core: ts (S, T); acc/gyro
    (S, T, P, 3); imu_t/imu_valid (S, T, P) (runner.pack_imu_frames per
    sequence), all tensors on the states' device.  Returns (fe_states,
    ba_states, vio_states, corrs, FrameOutput (S, T), BA costs (S, T))."""
    fcfg = _batched_fcfg(fcfg)
    fes, vios = list(fe_states), list(vio_states)
    S, T = imgs0.shape[:2]

    def frame(s, t, corr):
        xs = (imgs0[s, t], imgs1[s, t], ts[s, t], acc[s, t], gyro[s, t], imu_t[s, t],
              imu_valid[s, t])
        draws = tracker.make_draws(fcfg, generators[s], imgs0.device)
        fes[s], vios[s], out = runner_m._vio_frame_core(fcfg, vcfg, cams[s], T_i_cs[s], fes[s],
                                                        vios[s], corr, xs, draws)
        return fes[s], out

    bas, corrs, outs, costs = _chunk(bcfg, cams, ba_states, corrs, T, S, ba_every, frame)
    return fes, bas, vios, corrs, _stack(outs), costs
