"""Single-sequence SLAM pipeline: frontend tracking + keyframe window BA +
correction feedback, with optional IMU feedforward/feedback and the loop
node (port of flvis_tpu/pipeline/runner.py).

One stereo frame step = apply the pending Correction → track_frame → on a
backend reset, wipe the window → on a keyframe, add_keyframe + the 12+8
Schur LM optimize, whose Correction is applied at the start of the next
frame (the reference's one-keyframe-late feedback).  The reference runs a
chunk of such steps as one lax.scan device program; here process_frames
and process_frames_vio are Python loops over the step.

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
(runner.py:469-556): the chunk's outputs are packed into one (T, 14) array
and fetched to the host once, together with the loop node's pending gate
rows and verification statistics; then the chunk's keyframes go into the
loop node as one batch (add_keyframes_batch) and their candidate gate is
computed, to be decided at the next chunk's end, whose verification is
accepted at the end of the chunk after that (flush_loop resolves the
last ones).  LoopStage holds that deferred contract for one loop node;
parallel/multiseq_loop runs one per sequence.  With pipelined=True a
chunk's end runs when the next chunk has been stepped, so results return
one chunk late and flush() drains;
the frame step reads the device at its host branches, so this keeps the
reference's return lag and dataflow without overlapping anything.

The lax.conds of the reference become host branches (backend reset,
keyframe, the IMU filter's initialisation, the feedback on TRACKING); with
the tracker's two host branches they keep the frame step from being
captured as one CUDA graph.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
the sparse-map recorder (output_sparse_map) and the loop node on its own
device (loop_device).
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
from ..utils.tree import tree_map
from ..vio import vimotion

_NOT_PORTED = {
    "loop_device": "ROADMAP Queue 1 item 10 (pipeline/overlap.py, SlamSystem(loop_device=))",
    "output_sparse_map": "ROADMAP Queue 1 item 11 (viz/cloud.py)",
}


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


def _unpack_outputs(packed: np.ndarray) -> tracker.FrameOutput:
    """(T, ≥ 12) packed host array → FrameOutput of numpy arrays."""
    return tracker.FrameOutput(
        T_c_w=SE3(packed[:, 5:9], packed[:, 9:12]), is_keyframe=packed[:, 0] > 0.5,
        reset_backend=packed[:, 1] > 0.5, num_inliers=packed[:, 3].astype(np.int32),
        mean_reproj_err=packed[:, 4], status=packed[:, 2].astype(np.int32))


def fetch(*tensors):
    """One device → host copy for several tensors of one device (None
    passes through): returns float32 numpy arrays of the same shapes."""
    live = [t for t in tensors if t is not None]
    if not live:
        return [None] * len(tensors)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in live]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        out.append(flat[off:off + t.numel()].reshape(tuple(t.shape)))
        off += t.numel()
    return out


class LoopStage:
    """The chunked replay's deferred loop node over one LoopCloser (the
    reference's _finish_chunk, runner.py:487-556): a chunk's keyframes are
    ingested and gated at its end, the gate is decided and verified at the
    next chunk's end, and the verification is accepted (→ PGO) at the end
    of the chunk after that.  The caller fetches `pending()` with its chunk
    outputs in one host copy and hands the result to `resolve`."""

    def __init__(self, lc: LoopCloser):
        self.lc = lc
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
        if verify is not None and self.lc.resolve_verify(verify, stats):
            self.lc.optimize_graph()
        if gate is not None:
            self.verify = self.lc.dispatch_verify(gate, rows)

    def ingest(self, imgs_l, imgs_r, kf_idx, q, t, frame_ids):
        """The chunk's keyframes into the loop node, and their gate."""
        if kf_idx:
            ks = self.lc.add_keyframes_batch(imgs_l, imgs_r, kf_idx, q, t, frame_ids)
            self.gate = self.lc.gate_candidates(ks)

    def flush(self):
        """Resolve the deferred verification and gate of the last chunks."""
        verify, self.verify = self.verify, None
        if verify is not None and self.lc.resolve_verify(verify):
            self.lc.optimize_graph()
        gate, self.gate = self.gate, None
        if gate is not None and self.lc.decide_loops(gate):
            self.lc.optimize_graph()


def _ba_tail(bcfg, cam: StereoCamera, ba, fe, out):
    """The backend tail of a frame step: reset → keyframe window BA.
    Returns (ba, BAResult, KeyframePacket) — the last two None off
    keyframes."""
    if bool(out.reset_backend):
        ba = window_ba.reset(bcfg, ba)
    if not bool(out.is_keyframe):
        return ba, None, None
    pkt = tracker.make_keyframe_packet(fe, out)
    ba = window_ba.add_keyframe(bcfg, ba, pkt)
    res = window_ba.optimize(bcfg, cam, ba)
    return res.state, res, pkt


def _stereo_frame_core(fcfg, cam: StereoCamera, fe, corr, img0, img1, generator):
    """Apply the pending Correction (None: none) and track one stereo frame.
    Returns (fe, FrameOutput)."""
    if corr is not None:
        fe = tracker.apply_correction(fe, corr)
    return tracker.track_frame(fcfg, cam, fe, img0, img1, generator=generator)


def _vio_frame_core(fcfg, vcfg, cam: StereoCamera, T_i_c: SE3, fe, vio, corr, xs, generator):
    """The VIO frame step minus the backend tail (the reference's
    _vio_frame_core): IMU packet → feedforward prior → apply the pending
    Correction → track → roll/pitch blend → vision → IMU bias feedback.
    xs = (img0, img1, t_img, acc, gyro, imu_t, imu_valid).  Returns (fe,
    vio, FrameOutput)."""
    img0, img1, t_img, acc, gyro, it, iv = xs
    vio = vimotion.imu_feed_batch(vcfg, vio, acc, gyro, it, iv)
    ff = vimotion.get_frame_state(vio, t_img, T_i_c)
    if corr is not None:
        fe = tracker.apply_correction(fe, corr)
    cv = se3m.compose(se3m.exp(fe.velocity), fe.T_prev)
    fe, out = tracker.track_frame(fcfg, cam, fe, img0, img1,
                                  prior_T=se3m.where(ff.ok, ff.T_c_w, cv), use_prior=True,
                                  generator=generator)
    T_blend = vimotion.rp_compensate_pose(vcfg, out.T_c_w, ff.q_w_i, T_i_c)
    do_blend = ff.ok & (out.status == tracker.STATUS_TRACKING)
    T_out = se3m.where(do_blend, T_blend, out.T_c_w)
    fe = tracker.rebase_pose(fe, fe.frame_id - 1, T_out, do_blend)
    out = out._replace(T_c_w=T_out)
    if bool(out.status == tracker.STATUS_TRACKING):
        vio = vimotion.correction_from_vision(vcfg, vio, t_img, T_out, T_i_c)
    return fe, vio, out


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
    """Stereo(+IMU)(+loop) SLAM engine instance for one sequence, on one
    device (default "cuda")."""

    def __init__(self, cfg: SystemConfig, cam: StereoCamera, *, device="cuda", seed: int = 0,
                 T_i_c: Optional[SE3] = None, use_imu: bool = False, use_loop: bool = False,
                 output_sparse_map: bool = False, loop_device=None, pipelined: bool = False):
        asked = {"loop_device": loop_device is not None,
                 "output_sparse_map": output_sparse_map}
        for name, on in asked.items():
            if on:
                raise NotImplementedError(f"SlamSystem({name}=...) is not ported yet: "
                                          f"{_NOT_PORTED[name]}")
        if cfg.frontend.depth_mode:
            raise NotImplementedError("SlamSystem runs the stereo path; depth mode is "
                                      "ported in frontend.tracker only (ROADMAP item 7b)")
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
        self.loop_closer = LoopCloser(cfg.loop, cam, device=self.device) if use_loop else None
        self.loop_stage = LoopStage(self.loop_closer) if use_loop else None
        self.pending_corr: Optional[window_ba.Correction] = None
        self._frames_processed = 0
        self.keyframes: list = []       # KeyframePacket per keyframe
        self.trajectory: list = []      # (frame_id, t_img, q, t) numpy
        self.ba_costs: list = []        # float BA cost per keyframe
        self.n_valid_corrections = 0    # keyframes whose BA produced a valid Correction
        self.pipelined = pipelined
        self._inflight = None           # the chunk whose end is still to run

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
    def _apply_pending(self):
        if self.pending_corr is not None:
            self.fe_state = tracker.apply_correction(self.fe_state, self.pending_corr)
            self.pending_corr = None

    def _tail(self, out):
        self.ba_state, res, pkt = _ba_tail(self.cfg.backend, self.cam, self.ba_state,
                                           self.fe_state, out)
        if res is not None:
            self.pending_corr = res.correction
        return out, res, pkt

    def _stereo_step(self, img0, img1):
        corr, self.pending_corr = self.pending_corr, None
        self.fe_state, out = _stereo_frame_core(self.cfg.frontend, self.cam, self.fe_state,
                                                corr, img0, img1, self.generator)
        return self._tail(out)

    def _vio_step(self, *xs):
        corr, self.pending_corr = self.pending_corr, None
        self.fe_state, self.vio_state, out = _vio_frame_core(
            self.cfg.frontend, self.cfg.vio, self.cam, self.T_i_c, self.fe_state,
            self.vio_state, corr, xs, self.generator)
        return self._tail(out)

    def _to_device(self, img):
        return torch.as_tensor(np.asarray(img)).to(self.device)

    # -------------------------------------------------------------- entries
    def process_frame(self, img0, img1, t_img: float = 0.0):
        """One frame (host arrays or tensors, uint8 or float32) at image time
        t_img; returns the FrameOutput (tensors on the system's device)."""
        if self._inflight is not None:
            # Keep the host logs stream-ordered: finish the chunk in flight.
            inflight, self._inflight = self._inflight, None
            self._finish_chunk(*inflight)
        img0, img1 = self._to_device(img0), self._to_device(img1)
        self._apply_pending()
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
        _, res, pkt = self._tail(out)
        if pkt is not None:
            self.keyframes.append(pkt)
            self.ba_costs.append(float(res.cost))
            self.n_valid_corrections += int(res.correction.valid)
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

    def _run_chunk(self, step, T: int, *xs):
        """Step T frames; returns the packed (T, 14) outputs (on the device)
        and the keyframes' packets (None on other frames)."""
        outs, pkts, costs, valids = [], [], [], []
        zero = torch.zeros((), device=self.device)
        for i in range(T):
            out, res, pkt = step(*(x[i] for x in xs))
            outs.append(out)
            pkts.append(pkt)
            costs.append(zero if res is None else res.cost)
            valids.append(zero if res is None else res.correction.valid.to(zero.dtype))
        stacked = tree_map(lambda *a: torch.stack(a), *outs)
        return _pack_outputs(stacked, torch.stack(costs), torch.stack(valids)), pkts

    def process_frames(self, imgs0, imgs1, ts=None):
        """Replay T stacked stereo frames (T, H, W).  Returns the chunk's
        FrameOutput as host numpy arrays — in pipelined mode the previous
        chunk's (None on the first call; flush() returns the last)."""
        imgs0, imgs1 = self._to_device(imgs0), self._to_device(imgs1)
        T = imgs0.shape[0]
        packed, pkts = self._run_chunk(self._stereo_step, T, imgs0, imgs1)
        return self._after_dispatch(packed, pkts, imgs0, imgs1, ts, T)

    def process_frames_vio(self, imgs0, imgs1, ts, imu_acc, imu_gyro, imu_t,
                           imu_pad: int = 16):
        """Replay T stacked stereo frames with their IMU: imu_acc/imu_gyro/
        imu_t are length-T lists of the samples since the previous frame.
        Returns as process_frames does."""
        imgs0, imgs1 = self._to_device(imgs0), self._to_device(imgs1)
        T = imgs0.shape[0]
        # The first frame may carry the whole pre-camera IMU history: feed
        # all but its newest imu_pad samples through the stepwise path first.
        n0 = len(imu_t[0])
        if n0 > imu_pad:
            k = n0 - imu_pad
            self.feed_imu(np.asarray(imu_acc[0])[:k], np.asarray(imu_gyro[0])[:k],
                          np.asarray(imu_t[0])[:k])
            imu_acc = [np.asarray(imu_acc[0])[k:]] + list(imu_acc[1:])
            imu_gyro = [np.asarray(imu_gyro[0])[k:]] + list(imu_gyro[1:])
            imu_t = [np.asarray(imu_t[0])[k:]] + list(imu_t[1:])
        acc, gyro, it, iv = (torch.as_tensor(a, device=self.device)
                             for a in pack_imu_frames(imu_acc, imu_gyro, imu_t, imu_pad))
        ts32 = torch.as_tensor(np.asarray(ts, np.float32), device=self.device)
        packed, pkts = self._run_chunk(self._vio_step, T, imgs0, imgs1, ts32, acc, gyro, it,
                                       iv)
        return self._after_dispatch(packed, pkts, imgs0, imgs1, ts, T)

    def _after_dispatch(self, packed, pkts, imgs0, imgs1, ts, T):
        """Synchronous mode finishes the chunk now; pipelined mode keeps it
        in flight and finishes the previous one (None on the first call)."""
        if not self.pipelined:
            return self._finish_chunk(packed, pkts, imgs0, imgs1, ts, T)
        prev, self._inflight = self._inflight, (packed, pkts, imgs0, imgs1, ts, T)
        return self._finish_chunk(*prev) if prev is not None else None

    def _finish_chunk(self, packed_dev, pkts, imgs0, imgs1, ts, T):
        """A chunk's end (the reference's _finish_chunk): ONE host fetch of
        the packed outputs with the loop stage's pending gate rows and
        verification statistics; resolve the loop stage; log the chunk;
        ingest its keyframes into the loop node and gate them."""
        stage = self.loop_stage
        packed, rows, stats = fetch(packed_dev,
                                    *(stage.pending() if stage is not None else (None, None)))
        if stage is not None:
            stage.resolve(rows, stats)
        outs = _unpack_outputs(packed)
        first = self._frames_processed
        self._frames_processed += T
        kf_idx = [i for i in range(T) if outs.is_keyframe[i]]
        for i in kf_idx:
            self.keyframes.append(pkts[i])
            self.ba_costs.append(float(packed[i, 12]))
            self.n_valid_corrections += int(packed[i, 13] > 0.5)
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
