"""Multi-sequence replay: S independent SLAM runs through one frame step
(port of flvis_tpu/parallel/multiseq.py).

The reference batches the S sequences with vmap into one device program
per chunk (scan over frames of the vmapped frame step).  Here one step,
`frame_step`, runs each sequence's frame — the single-sequence frame
functions of pipeline/runner (`_stereo_frame_core`, `_vio_frame_core`,
`_ba_tail`, `_fused_*_frame_step`), so every kernel of the
single-sequence path runs on every sequence — as one
utils/control.branches item each.  On a CUDA device
parallel/multiseq_loop.MultiSeqSlam captures that step once into a CUDA
graph and replays it a frame: the S sequences are S independent branches
of the graph, each on its own stream with its own conditional-body
streams and schur ticket, which the card runs side by side; the conds are
IF nodes and window BA's LM loops WHILE nodes, so no host read decides
anything inside a chunk.  Eagerly (the CPU, `system_chunk_batch[_vio]`,
and MultiSeqSlam's comparison route) the same step runs frame by frame,
each cond reading the host once.  Stacking the S states into one tensor
a field, each op launched once for all S, is the next step (ROADMAP 10b).

Over several ranks (the reference's shard_map over P("seq"),
multiseq.py:351-415): `make_mesh` lays the ranks on a `seq` axis,
`shard_batch` keeps a rank's contiguous block of a batch, and that block
runs through `system_chunk_batch[_vio]` itself (the reference's
`system_chunk_batch[_vio]_sharded`) — zero collectives, as in the
reference, since the sequences are independent.

Window-BA cadence (`ba_every`, multiseq.py:164-258):
  - 1: per keyframe, exactly the single-sequence step (runner's
    _fused_frame_step / _fused_vio_frame_step);
  - N > 1: each frame the backend reset (a device select) and, on a
    keyframe, the insert (a cond); then the window solve under a cond on
    the frame-index predicate t % N == N − 1 (t the frame's index in its
    chunk), which the host hands in as an input each frame — the
    reference's scan-uniform real branch (multiseq.py:241-251); its
    Correction is applied on the next frame.
The reference turns its Pallas Schur step off for the batched windows
(`_batched_bcfg`), because that kernel takes one window; the port's
schur kernel (csrc/schur.cu) runs per window, so every solve here keeps
it.  The PnP rescue is off for batched runs, as in the reference
(`_batched_fcfg`).

Random draws: each sequence's tracker draws come from its own
torch.Generator (`generators`), outside any graph, into a stacked
(S, draws_size) input — or from the draws a test hands in.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..backend import window_ba
from ..config import BackendConfig, FrontendConfig, VioConfig
from ..frontend import tracker
from ..ops.kernels import schur
from ..pipeline import runner as runner_m
from ..utils import control
from ..utils.tree import tree_map
from ..vio import vimotion
from . import mesh as mesh_m


def _batched_fcfg(fcfg: FrontendConfig) -> FrontendConfig:
    # The reference's vmapped PnP-rescue lax.cond lowers to a select that
    # every frame pays, so batched runs disable it (multiseq.py:135-142);
    # the port keeps that configuration so both compute the same thing.
    return dataclasses.replace(fcfg, pnp_fallback=False)


def _stack(outs):
    """[S][T] FrameOutputs → one FrameOutput with leading (S, T)."""
    return tree_map(lambda *a: torch.stack(a), *[
        tree_map(lambda *b: torch.stack(b), *row) for row in outs])


def make_mesh(device=None, axis: str = "seq") -> mesh_m.Mesh:
    """Every rank of the process group on the `seq` axis."""
    return mesh_m.make_mesh(axis, device)


def shard_batch(mesh: mesh_m.Mesh, tree):
    """A rank's contiguous block of a batch on its device: every tensor (or
    host array) leaf of `tree` cut on its leading (S,) axis, a list of S
    per-sequence records cut to its block."""
    if isinstance(tree, list):
        return tree[mesh_m.block(mesh, len(tree))]
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return tuple(shard_batch(mesh, a) for a in tree)

    def cut(a):
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
        return a[mesh_m.block(mesh, a.shape[0])].to(mesh.device)

    if isinstance(tree, torch.Tensor) or not (hasattr(tree, "_fields")
                                              or dataclasses.is_dataclass(tree)):
        return cut(tree)
    return tree_map(cut, tree)


def _local(num_seqs: int, mesh, device):
    """(sequences this process builds, their device)."""
    if mesh is None:
        return num_seqs, device
    return len(range(num_seqs)[mesh_m.block(mesh, num_seqs)]), mesh.device


def init_states(cfg: FrontendConfig, num_seqs: int, mesh=None, *, device=None):
    """S fresh tracker states (with a mesh, the rank's block of them, on
    its device)."""
    n, device = _local(num_seqs, mesh, device)
    return [tracker.init_state(cfg, device=device) for _ in range(n)]


def init_system_states(fcfg: FrontendConfig, bcfg: BackendConfig, num_seqs: int, mesh=None,
                       *, device=None, vcfg: VioConfig | None = None):
    """Per-sequence (tracker states, BA windows, pending corrections[, VIO
    states]); the pending corrections start as the null correction
    (valid=False, applies nothing).  With a mesh, the rank's block."""
    num_seqs, device = _local(num_seqs, mesh, device)
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


def _seq_frame(fcfg, bcfg, vcfg, cam, T_i_c, null, ba_every: int, carry, x, draws, solve):
    """One sequence's frame of the S-sequence step: carry (fe, ba, corr) or,
    with vcfg, (fe, ba, vio, corr); x its frame inputs.  Returns (carry',
    its packed (14,) row: runner._pack_outputs with the BA cost and the
    correction's valid flag)."""
    if ba_every == 1:
        if vcfg is None:
            carry, ys = runner_m._fused_frame_step(fcfg, bcfg, cam, null, carry, x, draws)
        else:
            carry, ys = runner_m._fused_vio_frame_step(fcfg, bcfg, vcfg, cam, T_i_c, null,
                                                       carry, x, draws)
        return carry, runner_m._frame_row(ys)[0]
    if vcfg is None:
        fe, ba, corr = carry
        fe, out = runner_m._stereo_frame_core(fcfg, cam, fe, corr, *x, draws)
    else:
        fe, ba, vio, corr = carry
        fe, vio, out = runner_m._vio_frame_core(fcfg, vcfg, cam, T_i_c, fe, vio, corr, x, draws)
    ba = window_ba.reset_if(bcfg, ba, out.reset_backend)
    pkt = tracker.make_keyframe_packet(fe, out)
    ba = control.cond(out.is_keyframe, lambda b: window_ba.add_keyframe(bcfg, b, pkt),
                      lambda b: b, (ba,), name="keyframe_insert")

    def do_solve(b):
        res = window_ba.optimize(bcfg, cam, b)
        return res.state, res.correction, res.cost

    def no_solve(b):
        return b, null, torch.zeros((), dtype=torch.float32, device=out.status.device)

    ba, corr, cost = control.cond(solve, do_solve, no_solve, (ba,), name="window_solve")
    carry = (fe, ba, corr) if vcfg is None else (fe, ba, vio, corr)
    return carry, runner_m._frame_row((out, pkt, corr, cost))[0]


def frame_step(fcfg: FrontendConfig, bcfg: BackendConfig, cams, ba_every: int = 1, *,
               vcfg: VioConfig | None = None, T_i_cs=None, tickets=None):
    """The S-sequence frame step fn(carries, inputs) → (carries', rows):
    carries a tuple of S per-sequence carries ((fe, ba, corr), or (fe, ba,
    vio, corr) with vcfg); inputs = (imgs0 (S, H, W), imgs1[, ts (S,), acc
    (S, P, 3), gyro, imu_t (S, P), imu_valid], solve (0-d bool: the window
    solve's frame-index predicate, unused at ba_every 1), u (S,
    draws_size)); rows (S, 14) (runner._pack_outputs with the BA cost —
    0 on frames without a solve — and the correction's valid flag).  Each
    sequence is one control.branches item, with tickets[s] (a zeroed int32
    (1,) CUDA tensor) as its schur ticket when given.  The one function
    both devices run: captured on a CUDA device, eagerly on the CPU."""
    fcfg = _batched_fcfg(fcfg)
    null = window_ba.null_correction(bcfg, device=cams[0].fx.device)
    T_i_cs = T_i_cs if T_i_cs is not None else [None] * len(cams)

    def fn(carries, inputs):
        *frame, solve, u = inputs

        def one(s):
            own = (schur.use_ticket(tickets[s]) if tickets is not None
                   else contextlib.nullcontext())
            with own:
                return _seq_frame(fcfg, bcfg, vcfg, cams[s], T_i_cs[s], null, ba_every,
                                  carries[s], tuple(a[s] for a in frame),
                                  tracker.draws_of(fcfg, u[s]), solve)

        outs = control.branches(one, range(len(carries)), name="sequences")
        return tuple(c for c, _ in outs), torch.stack([r for _, r in outs])

    return fn


def solve_schedule(T: int, ba_every: int, device):
    """(T,) bool: the frames of a chunk whose window solve runs (t % N ==
    N − 1, t the index in the chunk, as the reference's scan index)."""
    return torch.arange(T, device=device) % ba_every == ba_every - 1


def make_draws(fcfg: FrontendConfig, generators, device, out=None):
    """One frame's draws of S sequences, (S, draws_size): row s from
    generators[s] (into `out` when given)."""
    if out is None:
        out = torch.empty((len(generators), tracker.draws_size(fcfg)), dtype=torch.float32,
                          device=device)
    for s, g in enumerate(generators):
        tracker.make_draws(fcfg, g, device, out=out[s])
    return out


def run_chunk_eager(step, carries, xs, draw):
    """step over a chunk, eagerly: xs frame-major (T, ...) inputs (the
    step's inputs less the draws), draw() a frame's (S, draws_size) draws.
    Returns (carries, rows (T, S, 14))."""
    rows = []
    for i in range(xs[0].shape[0]):
        carries, r = step(carries, tuple(x[i] for x in xs) + (draw(),))
        rows.append(r)
    return carries, torch.stack(rows)


def _run(fcfg, bcfg, cams, carries, seq_xs, generators, ba_every, vcfg=None, T_i_cs=None):
    """system_chunk_batch[_vio]'s eager chunk: seq_xs (S, T, ...) inputs."""
    dev = seq_xs[0].device
    step = frame_step(fcfg, bcfg, cams, ba_every, vcfg=vcfg, T_i_cs=T_i_cs)
    T = seq_xs[0].shape[1]
    xs = tuple(x.transpose(0, 1) for x in seq_xs) + (solve_schedule(T, ba_every, dev),)
    carries, rows = run_chunk_eager(step, tuple(carries), xs,
                                    lambda: make_draws(fcfg, generators, dev))
    r = rows.transpose(0, 1)            # (S, T, 14)
    return [list(c) for c in zip(*carries)], (runner_m._unpack_outputs(r), r[..., 12])


def system_chunk_batch(fcfg: FrontendConfig, bcfg: BackendConfig, cams, fe_states,
                       ba_states, corrs, imgs0, imgs1, generators, ba_every: int = 1):
    """Tracking + window BA + correction feedback over a chunk for S
    sequences, through frame_step eagerly: imgs (S, T, H, W).  Returns
    (fe_states, ba_states, corrs, FrameOutput (S, T), BA costs (S, T); 0
    on frames without a solve)."""
    (fes, bas, corrs), (outs, costs) = _run(
        fcfg, bcfg, cams, zip(fe_states, ba_states, corrs), (imgs0, imgs1), generators,
        ba_every)
    return fes, bas, corrs, outs, costs


def system_chunk_batch_vio(fcfg: FrontendConfig, bcfg: BackendConfig, vcfg: VioConfig, cams,
                           T_i_cs, fe_states, ba_states, vio_states, corrs, imgs0, imgs1, ts,
                           acc, gyro, imu_t, imu_valid, generators, ba_every: int = 1):
    """system_chunk_batch with the VIO frame core: ts (S, T); acc/gyro
    (S, T, P, 3); imu_t/imu_valid (S, T, P) (runner.pack_imu_frames per
    sequence), all tensors on the states' device.  Returns (fe_states,
    ba_states, vio_states, corrs, FrameOutput (S, T), BA costs (S, T))."""
    (fes, bas, vios, corrs), (outs, costs) = _run(
        fcfg, bcfg, cams, zip(fe_states, ba_states, vio_states, corrs),
        (imgs0, imgs1, ts, acc, gyro, imu_t, imu_valid), generators, ba_every, vcfg, T_i_cs)
    return fes, bas, vios, corrs, outs, costs

