"""Single-sequence SLAM pipeline: frontend tracking + keyframe window BA +
correction feedback, with optional IMU feedforward/feedback and the loop
node (port of flvis_tpu/pipeline/runner.py).

One stereo frame step (_fused_frame_step, the reference's
runner.py:104-113) = apply the pending Correction (a no-op unless it is
valid) → track_frame → the backend reset as a device select → on a
keyframe (a cond), add_keyframe + the 12+8 Schur LM optimize, whose
Correction is applied at the start of the next frame (the reference's
one-keyframe-late feedback); off keyframes the pending Correction is the
null one.  _fused_vio_frame_step (runner.py:205-212) adds the IMU packet,
the feedforward prior, the roll/pitch blend and the vision → IMU feedback
(a cond on TRACKING).  The reference runs a chunk of such steps as one
lax.scan device program; here, on a CUDA device, process_frames and
process_frames_vio capture the step once per system and path into one
CUDA graph (utils/control.CapturedStep: the conds become IF nodes and
window BA's LM loops WHILE nodes, taken on the device) and replay it a
frame, with no host read before the chunk's
end: the host copies the frame's images (and IMU packet) into the graph's
input buffers, draws the frame's uniforms into its draws buffer from the
system's generator — outside the graph, so the captured and the eager step
consume the same bits of one generator (a generator registered with the
graph would draw inside it, from philox offsets of its own) — replays, and
copies the frame's packed outputs and KeyframePacket out.  A capture
failure raises, naming the operation; nothing falls back to eager
execution.  On a CPU device the same step runs
eagerly (run_chunk_eager, whose conds read the host once each); the eager
composition is also what the tests and chip_smoke.py hold the captured
step to, bit for bit.

Three entry points, with the reference's semantics:
  - process_frame (stepwise): the IMU prior replaces the constant-velocity
    prediction only when the feedforward query is ok; the roll/pitch blend
    runs when the frame tracked; the vision → IMU feedback runs after BA.
    IMU samples arrive through feed_imu (padded to a multiple of 16).  The
    loop node runs stepwise on each keyframe (runner.py:375-380).
  - process_frames: the stereo step over a stack of frames (no IMU).
  - process_frames_vio: the reference's fused VIO chunk step
    (runner.py:172-212): per frame one padded IMU packet, the prior
    where(ff.ok, IMU pose, constant velocity) with use_prior, the blend when
    ff.ok and TRACKING, and the bias feedback BEFORE the backend tail.
The two chunk entries end the chunk as the reference's _finish_chunk does
(runner.py:469-556): the chunk's outputs are packed into one (T, 16) array
(the reference's 14 columns, then the frames' depth counts) and fetched
to the host once, together with the captured step's taken
counts and the loop node's pending gate rows and verification
statistics; then the chunk's keyframes go into the loop node as one batch
(add_keyframes_batch) and their candidate gate is
computed, to be decided at the next chunk's end, whose verification is
accepted at the end of the chunk after that (flush_loop resolves the
last ones).  LoopStage holds that deferred contract for one loop node;
parallel/multiseq_loop runs one per sequence.  With pipelined=True a
chunk's end runs when the next chunk has been stepped, so results return
one chunk late and flush() drains.  The loop node runs eagerly at the
chunk ends, outside the graph.

With output_sparse_map (the reference's YAML flag of that name) the
system accumulates the BA-corrected landmarks of every valid keyframe
correction into a viz.cloud.SparseMapRecorder (`sparse_map`): stepwise
from the correction at once; in a chunk the step also emits each frame's
correction landmarks (lm_id, lm_pw, lm_mask) into the chunk's output
buffers, read by the chunk end's one fetch — the flag off, the step and
its graph are what they are without it.

loop_device (the reference's SlamSystem(loop_device=), runner.py:274-286)
puts the whole loop node — store, ingest, gate, verification and PGO — on
a device of its own: the chunk end moves only the keyframes' images and
poses there, and its one fetch reads the gate rows and verification
statistics on the loop node's device beside the packed outputs on the
system's.  The captured frame step is the same whatever the loop node's
device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..backend import window_ba
from ..config import SystemConfig
from ..frontend import tracker
from ..geometry import se3 as se3m, so3
from ..geometry.camera import StereoCamera
from ..geometry.se3 import SE3
from ..loop.loop_closing import LoopCloser
from ..ops.kernels import schur
from ..utils import control, profiling
from ..utils.tree import tree_leaves, tree_map
from ..vio import vimotion
from ..viz.cloud import SparseMapRecorder


def _pack_outputs(outs, costs=None, corr_valids=None):
    """The stacked FrameOutput of a chunk (plus, when given, per-frame BA
    cost and correction-valid flag) as one (T, 12|14) float32 tensor:
    is_keyframe, reset_backend, status, num_inliers, mean_reproj_err,
    q (4), t (3)[, cost, valid]."""
    f = torch.float32
    cols = [outs.is_keyframe[:, None].to(f), outs.reset_backend[:, None].to(f),
            outs.status[:, None].to(f), outs.num_inliers[:, None].to(f),
            outs.mean_reproj_err[:, None].to(f), outs.T_c_w.q, outs.T_c_w.t]
    if costs is not None:
        cols += [costs[:, None].to(f), corr_valids[:, None].to(f)]
    return torch.cat(cols, dim=1)


def _unpack_outputs(packed) -> tracker.FrameOutput:
    """(..., ≥ 12) packed rows, a host array or a tensor → FrameOutput of
    the same kind, with the leading axes of `packed`."""
    if isinstance(packed, torch.Tensor):
        i32 = lambda a: a.to(torch.int32)
    else:
        i32 = lambda a: a.astype(np.int32)
    return tracker.FrameOutput(
        T_c_w=SE3(packed[..., 5:9], packed[..., 9:12]), is_keyframe=packed[..., 0] > 0.5,
        reset_backend=packed[..., 1] > 0.5, num_inliers=i32(packed[..., 3]),
        mean_reproj_err=packed[..., 4], status=i32(packed[..., 2]))


def fetch(*tensors):
    """One device → host copy for each device the tensors live on (None
    passes through), each a counted host read: returns float32 numpy arrays
    of the same shapes."""
    out = [None] * len(tensors)
    for dev in dict.fromkeys(t.device for t in tensors if t is not None):
        idx = [i for i, t in enumerate(tensors) if t is not None and t.device == dev]
        flat = profiling.host_read(
            torch.cat([tensors[i].reshape(-1).to(torch.float32) for i in idx]),
            site="runner.fetch")
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].reshape(tuple(tensors[i].shape))
            off += n
    return out


class LoopStage:
    """The chunked replay's deferred loop node over one LoopCloser (the
    reference's _finish_chunk, runner.py:487-556): a chunk's keyframes are
    ingested and gated at its end, the gate is decided and verified at the
    next chunk's end, and the verification is accepted (→ PGO) at the end
    of the chunk after that.  The caller fetches `pending()` with its chunk
    outputs in one host copy and hands the result to `resolve`.  Its spans
    (loop.resolve, loop.ingest, loop.gate, loop.flush) carry `seq`, the
    sequence of a MultiSeqSlam (None for a SlamSystem)."""

    def __init__(self, lc: LoopCloser, seq: Optional[int] = None):
        self.lc = lc
        self.seq = seq
        self.gate = None        # gate handle of the last chunk, decided at the next
        self.verify = None      # verification handle, accepted a chunk after that

    def pending(self):
        """The device tensors the next resolve needs: (gate rows,
        verification statistics), each None when nothing is pending."""
        return self.lc.pending_rows(self.gate), self.lc.pending_verify_arrays(self.verify)

    def resolve(self, rows, stats):
        """Accept the verified closures (→ PGO), then verify the candidates
        that the previous gate passes; rows/stats: `pending()` fetched."""
        gate, self.gate = self.gate, None
        verify, self.verify = self.verify, None
        with profiling.span("loop.resolve", seq=self.seq):
            if verify is not None and self.lc.resolve_verify(verify, stats):
                self.lc.optimize_graph()
            if gate is not None:
                handle = self.lc.dispatch_verify(gate, rows)
                if handle is not None and handle[0] == "done":
                    # A sharded database resolved its gate and verification now.
                    if handle[1]:
                        self.lc.optimize_graph()
                else:
                    self.verify = handle

    def ingest(self, imgs_l, imgs_r, kf_idx, q, t, frame_ids):
        """The chunk's keyframes into the loop node, and their gate.  On
        another device than the images' (loop_device), only the keyframes'
        images move there."""
        if kf_idx:
            with profiling.span("loop.ingest", seq=self.seq, keyframes=len(kf_idx)):
                sel = kf_idx
                src = imgs_l.device if torch.is_tensor(imgs_l) else torch.device("cpu")
                if src != self.lc.device:
                    def keyframes(imgs):
                        imgs = (imgs if torch.is_tensor(imgs)
                                else torch.as_tensor(np.asarray(imgs)))
                        return imgs[kf_idx].to(self.lc.device)

                    imgs_l, imgs_r = keyframes(imgs_l), keyframes(imgs_r)
                    sel = list(range(len(kf_idx)))
                ks = self.lc.add_keyframes_batch(imgs_l, imgs_r, sel, q, t, frame_ids)
            with profiling.span("loop.gate", seq=self.seq, queries=len(ks)):
                self.gate = self.lc.gate_candidates(ks)

    def flush(self):
        """Resolve the deferred verification and gate of the last chunks."""
        verify, self.verify = self.verify, None
        gate, self.gate = self.gate, None
        with profiling.span("loop.flush", seq=self.seq):
            if verify is not None and self.lc.resolve_verify(verify):
                self.lc.optimize_graph()
            if gate is not None and self.lc.decide_loops(gate):
                self.lc.optimize_graph()


def _ba_tail(bcfg, cam: StereoCamera, null, ba, fe, out):
    """The backend tail of a frame step (the reference's _ba_tail,
    runner.py:77-101): the reset as a device select, then the keyframe's
    add_keyframe + window BA under a cond.  Returns (ba, KeyframePacket,
    Correction — `null` off keyframes —, BA cost — 0 off keyframes)."""
    ba = window_ba.reset_if(bcfg, ba, out.reset_backend)
    pkt = tracker.make_keyframe_packet(fe, out)

    def do_kf(b):
        res = window_ba.optimize(bcfg, cam, window_ba.add_keyframe(bcfg, b, pkt))
        return res.state, res.correction, res.cost

    def no_kf(b):
        return b, null, torch.zeros((), dtype=torch.float32, device=out.status.device)

    ba, corr, cost = control.cond(out.is_keyframe, do_kf, no_kf, (ba,), name="keyframe")
    return ba, pkt, corr, cost


def _stereo_frame_core(fcfg, cam: StereoCamera, fe, corr, img0, img1, draws):
    """Apply the pending Correction (a no-op unless corr.valid) and track
    one stereo frame on `draws`.  Returns (fe, FrameOutput)."""
    fe = tracker.apply_correction(fe, corr)
    return tracker.track_frame(fcfg, cam, fe, img0, img1, draws=draws)


def _vio_frame_core(fcfg, vcfg, cam: StereoCamera, T_i_c: SE3, fe, vio, corr, xs, draws):
    """The VIO frame step minus the backend tail (the reference's
    _vio_frame_core): IMU packet → feedforward prior → apply the pending
    Correction → track → roll/pitch blend → vision → IMU bias feedback (a
    cond on TRACKING).  xs = (img0, img1, t_img, acc, gyro, imu_t,
    imu_valid).  Returns (fe, vio, FrameOutput)."""
    img0, img1, t_img, acc, gyro, it, iv = xs
    vio = vimotion.imu_feed_batch(vcfg, vio, acc, gyro, it, iv)
    ff = vimotion.get_frame_state(vio, t_img, T_i_c)
    fe = tracker.apply_correction(fe, corr)
    cv = se3m.compose(se3m.exp(fe.velocity), fe.T_prev)
    fe, out = tracker.track_frame(fcfg, cam, fe, img0, img1,
                                  prior_T=se3m.where(ff.ok, ff.T_c_w, cv), use_prior=True,
                                  draws=draws)
    T_blend = vimotion.rp_compensate_pose(vcfg, out.T_c_w, ff.q_w_i, T_i_c)
    do_blend = ff.ok & (out.status == tracker.STATUS_TRACKING)
    T_out = se3m.where(do_blend, T_blend, out.T_c_w)
    fe = tracker.rebase_pose(fe, fe.frame_id - 1, T_out, do_blend)
    out = out._replace(T_c_w=T_out)
    vio = control.cond(out.status == tracker.STATUS_TRACKING,
                       lambda v: vimotion.correction_from_vision(vcfg, v, t_img, T_out, T_i_c),
                       lambda v: v, (vio,), name="vio_feedback")
    return fe, vio, out


def _fused_frame_step(fcfg, bcfg, cam: StereoCamera, null, carry, xs, draws):
    """One frame of the fused stereo pipeline (the reference's
    _fused_frame_step, runner.py:104-113): apply the pending Correction,
    track, and the keyframe BA tail.  carry = (fe, ba, corr), xs = (img0,
    img1).  Returns (carry', (FrameOutput, KeyframePacket, Correction,
    cost)).  No host read decides anything on a CUDA device unless a cond
    runs eagerly; SlamSystem captures this step as one CUDA graph."""
    fe, ba, corr = carry
    fe, out = _stereo_frame_core(fcfg, cam, fe, corr, *xs, draws)
    ba, pkt, corr_new, cost = _ba_tail(bcfg, cam, null, ba, fe, out)
    return (fe, ba, corr_new), (out, pkt, corr_new, cost)


def _fused_vio_frame_step(fcfg, bcfg, vcfg, cam: StereoCamera, T_i_c: SE3, null, carry, xs,
                          draws):
    """One frame of the fused VIO pipeline (the reference's
    _fused_vio_frame_step, runner.py:205-212): carry = (fe, ba, vio, corr),
    xs = (img0, img1, t_img, acc, gyro, imu_t, imu_valid).  Returns as
    _fused_frame_step does."""
    fe, ba, vio, corr = carry
    fe, vio, out = _vio_frame_core(fcfg, vcfg, cam, T_i_c, fe, vio, corr, xs, draws)
    ba, pkt, corr_new, cost = _ba_tail(bcfg, cam, null, ba, fe, out)
    return (fe, ba, vio, corr_new), (out, pkt, corr_new, cost)


def _frame_row(ys, sparse_map: bool = False, fe=None):
    """A frame's outputs (FrameOutput, KeyframePacket, Correction, cost) as
    (its packed (14,) row, its KeyframePacket); with sparse_map the packet
    comes as (KeyframePacket, (Correction.lm_id, lm_pw, lm_mask)).  Given
    the tracker state the frame left, `fe`, the row takes two columns more
    (16,): its active slots and those whose stereo depth was accepted
    (`ur_ok`: the stereo LK's disparity in range)."""
    out, pkt, corr, cost = ys
    row = _pack_outputs(tree_map(lambda a: a[None], out), cost[None], corr.valid[None])[0]
    if fe is not None:
        row = torch.cat([row, depth_counts(fe)])
    return row, ((pkt, (corr.lm_id, corr.lm_pw, corr.lm_mask)) if sparse_map else pkt)


def depth_counts(fe):
    """(2,) float32: the tracker state's active slots and stereo-accepted
    slots."""
    t = fe.table
    return torch.stack([t.active.sum(), t.ur_ok.sum()]).to(torch.float32)


def run_chunk_eager(step, carry, xs, draws, sparse_map: bool = False):
    """step(carry, xs_i, draws_i) over a chunk, eagerly: xs a tuple of
    (T, ...) tensors, draws a callable i → Draws; carry[0] the tracker
    state.  Returns (carry, packed (T, 16) outputs — _frame_row's with the
    depth counts —, KeyframePacket stacked over T — with sparse_map, with
    the corrections' landmarks as _frame_row gives them)."""
    rows, pkts = [], []
    T = xs[0].shape[0]
    with profiling.span("step.run", replays=T):
        for i in range(T):
            with profiling.span("step.eager"):
                carry, ys = step(carry, tuple(x[i] for x in xs), draws(i))
            row, pkt = _frame_row(ys, sparse_map, carry[0])
            rows.append(row)
            pkts.append(pkt)
        return carry, torch.stack(rows), tree_map(lambda *a: torch.stack(a), *pkts)


def _upload(a, device):
    """A host array (or tensor) on `device` without a host sync (through
    pinned memory on a CUDA device); tensors already there pass through."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _Captured:
    """A captured frame step fn(carry, inputs + (u,)) → (carry', ys) over
    static carry, input and draws (`u`) buffers, replayed a frame: one
    SlamSystem's (stereo or VIO), or MultiSeqSlam's over S sequences as S
    branches (`branches`).  The capture happens here, at the first chunk;
    a failure raises.  fn brings the schur kernel's last-block ticket(s)
    (schur.use_ticket), one a branch.

    Each replay is a step.replay span (the host's enqueue, or its wait
    where the launch queue is full).  The chunk's stream time: CUDA events
    (timing on) recorded on the current stream before the first replay and
    after each replay, from two reused sets (a pipelined chunk's events are
    read after the next chunk's replays were enqueued); `settle_stream`,
    called once a host read has waited for the chunk, adds their elapsed
    time to the chunk's step.run span as `stream_ns`."""

    def __init__(self, fn, carry, xs, u, name, branches: int = 0, attrs: dict | None = None):
        self.xs, self.u = tuple(x.clone() for x in xs), u
        self.step = control.CapturedStep(fn, tree_map(torch.clone, carry), self.xs + (self.u,),
                                         name=name, branches=branches, attrs=attrs)
        self._events = ([], [])         # two sets of timing events, used in turns
        self._turn = 0
        self._unread = []               # (events, replays, step.run span) not yet read

    def _event_set(self, n: int) -> list:
        """The next set of at least n timing events; its unread chunk (if
        any) is dropped."""
        k, self._turn = self._turn, 1 - self._turn
        evs = self._events[k]
        self._unread = [u for u in self._unread if u[0] is not evs]
        while len(evs) < n:
            evs.append(torch.cuda.Event(enable_timing=True))
        return evs

    def run(self, carry, xs, draw):
        """The chunk: carry (a state tree, copied in), xs (T, ...) tensors,
        draw(u) writing a frame's draws into u.  Returns (carry (fresh
        tensors), the step's ys stacked over T)."""
        for dst, x in zip(self.xs, xs):
            if x.dtype != dst.dtype:
                raise TypeError(f"{self.step.name} was captured for {dst.dtype} inputs, not "
                                f"{x.dtype}")
        T = xs[0].shape[0]
        timed = profiling.enabled()
        evs = self._event_set(T + 1) if timed else None
        with profiling.span("step.run", replays=T) as sp:
            for dst, src in zip(tree_leaves(self.step.carry), tree_leaves(carry)):
                dst.copy_(src)
            outs = tree_map(lambda a: torch.empty((T,) + tuple(a.shape), dtype=a.dtype,
                                                  device=a.device), self.step.ys)
            out_leaves, ys = tree_leaves(outs), tree_leaves(self.step.ys)
            for i in range(T):
                for dst, x in zip(self.xs, xs):
                    dst.copy_(x[i])
                draw(self.u)
                if timed and i == 0:
                    evs[0].record()
                with profiling.span("step.replay"):
                    self.step.replay()
                if timed:
                    evs[i + 1].record()
                for dst, src in zip(out_leaves, ys):
                    dst[i].copy_(src)
            if timed:
                self._unread.append((evs, T, sp))
            return tree_map(torch.clone, self.step.carry), outs

    def settle_stream(self) -> None:
        """The oldest unread chunk's stream time (the sum of its replays'
        event intervals) into its step.run span; call after a host read that
        waited for that chunk's replays."""
        if self._unread:
            evs, T, sp = self._unread.pop(0)
            ms = sum(evs[i].elapsed_time(evs[i + 1]) for i in range(T))
            sp.set(stream_ns=int(ms * 1e6))


def pack_imu_frames(imu_accs, imu_gyros, imu_ts, pad: int = 16):
    """Per-frame IMU sample lists → fixed (T, pad, ·) numpy arrays with a
    validity mask.  Raises on a frame with more than `pad` samples (dropping
    IMU data would diverge from the stepwise path)."""
    T = len(imu_ts)
    acc = np.zeros((T, pad, 3), np.float32)
    gyro = np.zeros((T, pad, 3), np.float32)
    t = np.zeros((T, pad), np.float32)
    valid = np.zeros((T, pad), bool)
    for i in range(T):
        n = len(imu_ts[i])
        if n > pad:
            raise ValueError(
                f"frame {i} carries {n} IMU samples > imu_pad={pad}; raise imu_pad "
                f"(IMU-rate/frame-rate ratio exceeds the slot count)")
        acc[i, :n] = np.asarray(imu_accs[i], np.float32)
        gyro[i, :n] = np.asarray(imu_gyros[i], np.float32)
        t[i, :n] = np.asarray(imu_ts[i], np.float32)
        valid[i, :n] = True
    return acc, gyro, t, valid


class SlamSystem:
    """Stereo or RGB-D (+IMU)(+loop) SLAM engine instance for one sequence,
    on one device (default "cuda").  With cfg.frontend.depth_mode the second
    image of every frame is an aligned depth image (raw units, divided by
    cam.depth_factor; float32), in the tracker and the loop node alike."""

    def __init__(self, cfg: SystemConfig, cam: StereoCamera, *, device="cuda", seed: int = 0,
                 T_i_c: Optional[SE3] = None, use_imu: bool = False, use_loop: bool = False,
                 output_sparse_map: bool = False, loop_device=None, pipelined: bool = False):
        self.cfg = cfg
        self.cam = cam
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.fe_state = tracker.init_state(cfg.frontend, device=self.device)
        self.ba_state = window_ba.empty(cfg.backend, device=self.device)
        self.use_imu = use_imu
        if T_i_c is None:
            T_i_c = se3m.identity(device=self.device)
        self.T_i_c = SE3(T_i_c.q.to(self.device), T_i_c.t.to(self.device))
        self.vio_state = vimotion.init_state(cfg.vio, device=self.device)
        # loop_device: the whole loop node (and its PGO) on a device of its own.
        self.loop_device = torch.device(loop_device) if loop_device is not None else self.device
        self.loop_closer = (LoopCloser(cfg.loop, cam, device=self.loop_device,
                                       depth_mode=cfg.frontend.depth_mode,
                                       pgo_device=loop_device)
                            if use_loop else None)
        self.loop_stage = LoopStage(self.loop_closer) if use_loop else None
        # The reference's `output_sparse_map` YAML flag: BA-corrected
        # landmarks into a voxel-downsampled map cloud (vo_localmap.cpp:367-377).
        self.sparse_map = SparseMapRecorder(device=self.device) if output_sparse_map else None
        self._null = window_ba.null_correction(cfg.backend, device=self.device)
        self.pending_corr = self._null  # always a Correction; valid=False applies nothing
        self._frames_processed = 0
        self.keyframes: list = []       # KeyframePacket per keyframe
        self.trajectory: list = []      # (frame_id, t_img, q, t) numpy
        self.ba_costs: list = []        # float BA cost per keyframe
        self.n_valid_corrections = 0    # keyframes whose BA produced a valid Correction
        self.pipelined = pipelined
        self._inflight = None           # the chunk whose end is still to run
        self._captured = {}             # ("stereo" | "vio", input dtypes) -> _Captured (CUDA)
        # The tracker's stereo LK start on initialising frames, from the camera.
        self.depth_prior = tracker.depth_prior_route(cfg.frontend, cam)
        # The schur kernel's last-block ticket of this system's captured steps.
        self._ticket = (torch.zeros(1, dtype=torch.int32, device=self.device)
                        if self.device.type == "cuda" else None)

    # ------------------------------------------------------------------ IMU
    def feed_imu(self, acc, gyro, t):
        """Feed a batch of IMU samples ((B, 3), (B, 3), (B,)), padded to the
        next multiple of 16 with a validity mask."""
        b = len(t)
        if b == 0:
            return
        pad = (-b) % 16

        def padded(a, shape):
            return torch.as_tensor(np.concatenate([np.asarray(a, np.float32),
                                                   np.zeros(shape, np.float32)]),
                                   device=self.device)

        self.vio_state = vimotion.imu_feed_batch(
            self.cfg.vio, self.vio_state, padded(acc, (pad, 3)), padded(gyro, (pad, 3)),
            padded(t, (pad,)), torch.arange(b + pad, device=self.device) < b)

    # ---------------------------------------------------------------- steps
    def _stereo_step(self, carry, xs, draws):
        return _fused_frame_step(self.cfg.frontend, self.cfg.backend, self.cam, self._null,
                                 carry, xs, draws)

    def _vio_step(self, carry, xs, draws):
        return _fused_vio_frame_step(self.cfg.frontend, self.cfg.backend, self.cfg.vio,
                                     self.cam, self.T_i_c, self._null, carry, xs, draws)

    def _to_device(self, img):
        return _upload(img, self.device)

    # -------------------------------------------------------------- entries
    def process_frame(self, img0, img1, t_img: float = 0.0):
        """One frame (host arrays or tensors, uint8 or float32; in depth mode
        img1 a float32 depth image) at image time t_img; returns the FrameOutput (tensors on the system's device).
        The stepwise path runs eagerly (its conds read the host)."""
        if self._inflight is not None:
            # Keep the host logs stream-ordered: finish the chunk in flight.
            inflight, self._inflight = self._inflight, None
            self._finish_chunk(*inflight)
        img0, img1 = self._to_device(img0), self._to_device(img1)
        self.fe_state = tracker.apply_correction(self.fe_state, self.pending_corr)
        prior, use_prior, ff = None, False, None
        if self.use_imu:
            ff = vimotion.get_frame_state(self.vio_state, t_img, self.T_i_c)
            if bool(ff.ok):
                prior, use_prior = ff.T_c_w, True
        self.fe_state, out = tracker.track_frame(
            self.cfg.frontend, self.cam, self.fe_state, img0, img1, prior_T=prior,
            use_prior=use_prior, generator=self.generator)
        if use_prior and bool(out.status == tracker.STATUS_TRACKING):
            # Roll/pitch feedforward blend, rebasing the pose chain onto it.
            T_blend = vimotion.rp_compensate_pose(self.cfg.vio, out.T_c_w, ff.q_w_i,
                                                  self.T_i_c)
            self.fe_state = tracker.rebase_pose(
                self.fe_state,
                torch.tensor(self._frames_processed, dtype=torch.int32, device=self.device),
                T_blend, torch.tensor(True, device=self.device))
            out = out._replace(T_c_w=T_blend)
        self.ba_state, pkt, self.pending_corr, cost = _ba_tail(
            self.cfg.backend, self.cam, self._null, self.ba_state, self.fe_state, out)
        if bool(out.is_keyframe):
            self.keyframes.append(pkt)
            self.ba_costs.append(float(cost))
            self.n_valid_corrections += int(self.pending_corr.valid)
            if self.sparse_map is not None and bool(self.pending_corr.valid):
                c = self.pending_corr
                self.sparse_map.add_correction(c.lm_id, c.lm_pw, c.lm_mask)
            if self.loop_closer is not None:
                # The loop node ingests the same keyframe stream, stepwise.
                k = self.loop_closer.add_keyframe(img0, img1, out.T_c_w, int(pkt.frame_id))
                if self.loop_closer.detect_loop(k) is not None:
                    self.loop_closer.optimize_graph()
        if self.use_imu and bool(out.status == tracker.STATUS_TRACKING):
            self.vio_state = vimotion.correction_from_vision(
                self.cfg.vio, self.vio_state, t_img, out.T_c_w, self.T_i_c)
        self.trajectory.append((self._frames_processed, t_img,
                                out.T_c_w.q.detach().cpu().numpy(),
                                out.T_c_w.t.detach().cpu().numpy()))
        self._frames_processed += 1
        return out

    def _carry(self, vio: bool):
        return ((self.fe_state, self.ba_state, self.vio_state, self.pending_corr) if vio
                else (self.fe_state, self.ba_state, self.pending_corr))

    def _set_carry(self, vio: bool, carry):
        if vio:
            self.fe_state, self.ba_state, self.vio_state, self.pending_corr = carry
        else:
            self.fe_state, self.ba_state, self.pending_corr = carry

    def _run_chunk(self, kind: str, xs):
        """Step the chunk's frames (xs: (T, ...) tensors on the device) from
        the system's state: on a CUDA device one replay of the captured step
        a frame (captured at the first chunk), else the eager step.  Updates
        the state; returns the packed (T, 16) outputs (_frame_row with the
        depth counts) and the stacked KeyframePackets (on the device) and
        the captured step, or None."""
        if self.device.type != "cuda":
            return self._run_chunk_eager(kind, xs)
        vio = kind == "vio"
        cap = self._captured_step(kind, xs)
        fcfg = self.cfg.frontend
        carry, (packed, pkts) = cap.run(
            self._carry(vio), xs,
            lambda u: tracker.make_draws(fcfg, self.generator, self.device, out=u))
        self._set_carry(vio, carry)
        return packed, pkts, cap

    def _captured_step(self, kind: str, xs):
        """The system's captured `kind` step for inputs of xs's dtypes,
        captured now (from the system's state, on a frame of xs's shapes)
        unless it was before: a graph is never replayed on inputs of another
        dtype (uint8 stereo pairs, a float32 depth image)."""
        key = (kind,) + tuple(x.dtype for x in xs)
        cap = self._captured.get(key)
        if cap is None:
            vio = kind == "vio"
            step = self._vio_step if vio else self._stereo_step
            fcfg = self.cfg.frontend

            sparse_map = self.sparse_map is not None

            def fn(c, inputs):
                *frame, u = inputs
                with schur.use_ticket(self._ticket):
                    c, ys = step(c, tuple(frame), tracker.draws_of(fcfg, u))
                return c, _frame_row(ys, sparse_map, c[0])

            u = torch.zeros(tracker.draws_size(fcfg), dtype=torch.float32, device=self.device)
            cap = self._captured[key] = _Captured(
                fn, self._carry(vio), tuple(x[0] for x in xs), u, f"the {kind} frame step",
                attrs={"kind": "vio" if vio else "vo", "route": self.depth_prior})
        return cap

    def _run_chunk_eager(self, kind: str, xs):
        """_run_chunk through the eager composition (run_chunk_eager over
        the module-level fused step), on the same draws."""
        vio = kind == "vio"
        fcfg = self.cfg.frontend
        carry, packed, pkts = run_chunk_eager(
            self._vio_step if vio else self._stereo_step, self._carry(vio), xs,
            lambda i: tracker.make_draws(fcfg, self.generator, self.device),
            self.sparse_map is not None)
        self._set_carry(vio, carry)
        return packed, pkts, None

    def process_frames(self, imgs0, imgs1, ts=None):
        """Replay T stacked stereo frames (T, H, W).  Returns the chunk's
        FrameOutput as host numpy arrays — in pipelined mode the previous
        chunk's (None on the first call; flush() returns the last).  On a
        CUDA device each frame is one replay of the captured step (a capture
        failure raises), with no host read before the chunk's end."""
        cid = profiling.new_chunk()
        with profiling.span("chunk", chunk=cid, frames=len(imgs0), seqs=1):
            with profiling.span("chunk.upload"):
                imgs0, imgs1 = self._to_device(imgs0), self._to_device(imgs1)
            T = imgs0.shape[0]
            packed, pkts, cap = self._run_chunk("stereo", (imgs0, imgs1))
            return self._after_dispatch(packed, pkts, cap, imgs0, imgs1, ts, T, cid)

    def process_frames_vio(self, imgs0, imgs1, ts, imu_acc, imu_gyro, imu_t,
                           imu_pad: int = 16):
        """Replay T stacked stereo frames with their IMU: imu_acc/imu_gyro/
        imu_t are length-T lists of the samples since the previous frame.
        Returns as process_frames does."""
        cid = profiling.new_chunk()
        with profiling.span("chunk", chunk=cid, frames=len(imgs0), seqs=1):
            with profiling.span("chunk.upload"):
                imgs0, imgs1 = self._to_device(imgs0), self._to_device(imgs1)
                # The first frame may carry the whole pre-camera IMU history:
                # feed all but its newest imu_pad samples through the stepwise
                # path first.
                n0 = len(imu_t[0])
                if n0 > imu_pad:
                    k = n0 - imu_pad
                    self.feed_imu(np.asarray(imu_acc[0])[:k], np.asarray(imu_gyro[0])[:k],
                                  np.asarray(imu_t[0])[:k])
                    imu_acc = [np.asarray(imu_acc[0])[k:]] + list(imu_acc[1:])
                    imu_gyro = [np.asarray(imu_gyro[0])[k:]] + list(imu_gyro[1:])
                    imu_t = [np.asarray(imu_t[0])[k:]] + list(imu_t[1:])
                acc, gyro, it, iv = (_upload(a, self.device)
                                     for a in pack_imu_frames(imu_acc, imu_gyro, imu_t, imu_pad))
                ts32 = _upload(np.asarray(ts, np.float32), self.device)
            T = imgs0.shape[0]
            packed, pkts, cap = self._run_chunk("vio", (imgs0, imgs1, ts32, acc, gyro, it, iv))
            return self._after_dispatch(packed, pkts, cap, imgs0, imgs1, ts, T, cid)

    def _after_dispatch(self, *chunk):
        """Synchronous mode finishes the chunk now; pipelined mode keeps it
        in flight and finishes the previous one (None on the first call)."""
        if not self.pipelined:
            return self._finish_chunk(*chunk)
        prev, self._inflight = self._inflight, chunk
        return self._finish_chunk(*prev) if prev is not None else None

    def _finish_chunk(self, packed_dev, pkts, cap, imgs0, imgs1, ts, T, cid=None):
        """A chunk's end (the reference's _finish_chunk): ONE host fetch of
        the packed outputs with the captured step's taken counts and the
        loop stage's pending gate rows and verification statistics (the
        chunk.fetch span gets the chunk's sums of the depth counts, `active`
        and `stereo_ok`); resolve
        the loop stage; log the chunk; ingest its keyframes into the loop
        node and gate them; with the sparse map, the chunk's correction
        landmarks come in the same fetch (the ids' int32 bits as float32).
        Its spans carry the chunk's own id `cid`, also where a pipelined
        chunk's end runs inside the next chunk's call."""
        with profiling.span("chunk.end", chunk=cid, frames=T):
            return self._end_chunk(packed_dev, pkts, cap, imgs0, imgs1, ts, T)

    def _end_chunk(self, packed_dev, pkts, cap, imgs0, imgs1, ts, T):
        stage = self.loop_stage
        lm_dev = ()
        if self.sparse_map is not None:
            pkts, (lm_id, lm_pw, lm_mask) = pkts
            lm_dev = (lm_id.view(torch.float32), lm_pw, lm_mask)
        with profiling.span("chunk.fetch") as sp:
            packed, taken, rows, stats, *lm = fetch(
                packed_dev, cap.step.taken if cap is not None else None,
                *(stage.pending() if stage is not None else (None, None)), *lm_dev)
            if cap is not None:
                sp.set(**cap.step.settle(taken))
                cap.settle_stream()
            sp.set(active=int(packed[:, 14].sum()), stereo_ok=int(packed[:, 15].sum()))
        if stage is not None:
            stage.resolve(rows, stats)
        with profiling.span("chunk.log"):
            outs = _unpack_outputs(packed)
            first = self._frames_processed
            self._frames_processed += T
            kf_idx = [i for i in range(T) if outs.is_keyframe[i]]
            for i in kf_idx:
                self.keyframes.append(tree_map(lambda a: a[i], pkts))
                self.ba_costs.append(float(packed[i, 12]))
                self.n_valid_corrections += int(packed[i, 13] > 0.5)
                if lm and packed[i, 13] > 0.5:
                    self.sparse_map.add_correction(lm[0][i].view(np.int32), lm[1][i],
                                                   lm[2][i] > 0.5)
            for i in range(T):
                self.trajectory.append((first + i, float(ts[i]) if ts is not None else 0.0,
                                        outs.T_c_w.q[i], outs.T_c_w.t[i]))
        if stage is not None:
            stage.ingest(imgs0, imgs1, kf_idx, outs.T_c_w.q[kf_idx], outs.T_c_w.t[kf_idx],
                         [first + i for i in kf_idx])
        return outs

    def flush_loop(self):
        """Resolve the loop node's deferred verification and candidate gate
        of the last chunks; call once after a chunked replay."""
        if self.loop_stage is not None:
            self.loop_stage.flush()

    def flush(self):
        """Finish the chunk in flight (pipelined mode) and resolve the loop
        node's deferred batches.  Returns that chunk's FrameOutput, or
        None."""
        out = None
        if self._inflight is not None:
            inflight, self._inflight = self._inflight, None
            out = self._finish_chunk(*inflight)
        self.flush_loop()
        return out

    def trajectory_cam_centers(self, loop_corrected: bool = False):
        """(N, 3) camera centres C = −Rᵀ t in the world frame; with
        loop_corrected the loop node's map→odom drift is applied."""
        out = []
        for (_, _, q, t) in self.trajectory:
            q, t = torch.as_tensor(q), torch.as_tensor(t)
            if loop_corrected and self.loop_closer is not None:
                T = self.loop_closer.corrected_pose(SE3(q, t))
                q, t = T.q.cpu(), T.t.cpu()
            R = so3.to_matrix(q).numpy()
            out.append(-R.T @ t.numpy())
        return np.asarray(out)
