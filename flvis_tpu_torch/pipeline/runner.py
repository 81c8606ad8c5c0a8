"""Single-sequence SLAM pipeline: frontend tracking + keyframe window BA +
correction feedback, with optional IMU feedforward/feedback and the loop
node (port of flvis_tpu/pipeline/runner.py).

One stereo frame step = apply the pending Correction → track_frame → on a
backend reset, wipe the window → on a keyframe, add_keyframe + the 12+8
Schur LM optimize, whose Correction is applied at the start of the next
frame (the reference's one-keyframe-late feedback) → with the loop node, on
the keyframe, LoopCloser.add_keyframe → detect_loop → optimize_graph.  The
reference runs a chunk of such steps as one lax.scan device program; here
process_frames and process_frames_vio are Python loops over the step.

Three entry points, with the reference's semantics:
  - process_frame (stepwise): the IMU prior replaces the constant-velocity
    prediction only when the feedforward query is ok; the roll/pitch blend
    runs when the frame tracked; the vision → IMU feedback runs after BA.
    IMU samples arrive through feed_imu (padded to a multiple of 16).
  - process_frames: the stereo step over a stack of frames (no IMU).
  - process_frames_vio: the reference's fused VIO chunk step
    (runner.py:172-212): per frame one padded IMU packet, the prior
    where(ff.ok, IMU pose, constant velocity) with use_prior, the blend when
    ff.ok and TRACKING, and the bias feedback BEFORE the backend tail.
In every entry point the loop node runs stepwise on each keyframe (the
reference's stepwise semantics, runner.py:375-380), so flush_loop has
nothing to resolve.

The lax.conds of the reference become host branches (backend reset,
keyframe, the IMU filter's initialisation, the feedback on TRACKING); with
the tracker's two host branches they keep the frame step from being
captured as one CUDA graph.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
the sparse-map recorder (output_sparse_map), the loop node on its own
device (loop_device) and double-buffered chunks (pipelined=True).
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
    "pipelined": "ROADMAP Queue 1 item 7b (pipelined=True double buffering)",
}


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
                 "output_sparse_map": output_sparse_map, "pipelined": pipelined}
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
        self.pending_corr: Optional[window_ba.Correction] = None
        self._frames_processed = 0
        self.keyframes: list = []       # KeyframePacket per keyframe
        self.trajectory: list = []      # (frame_id, t_img, q, t) numpy
        self.ba_costs: list = []        # float BA cost per keyframe
        self.n_valid_corrections = 0    # keyframes whose BA produced a valid Correction

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

    def _backend_tail(self, out, img0, img1):
        """Reset → keyframe BA → loop node.  Returns the keyframe's BAResult
        or None."""
        if bool(out.reset_backend):
            self.ba_state = window_ba.reset(self.cfg.backend, self.ba_state)
        if not bool(out.is_keyframe):
            return None
        pkt = tracker.make_keyframe_packet(self.fe_state, out)
        self.ba_state = window_ba.add_keyframe(self.cfg.backend, self.ba_state, pkt)
        res = window_ba.optimize(self.cfg.backend, self.cam, self.ba_state)
        self.ba_state = res.state
        self.pending_corr = res.correction
        self.keyframes.append(pkt)
        if self.loop_closer is not None:
            # The loop node ingests the same keyframe stream.
            k = self.loop_closer.add_keyframe(img0, img1, out.T_c_w, int(pkt.frame_id))
            if self.loop_closer.detect_loop(k) is not None:
                self.loop_closer.optimize_graph()
        return res

    def _stereo_step(self, img0, img1):
        self._apply_pending()
        self.fe_state, out = tracker.track_frame(
            self.cfg.frontend, self.cam, self.fe_state, img0, img1, generator=self.generator)
        return out, self._backend_tail(out, img0, img1)

    def _vio_step(self, img0, img1, t_img, acc, gyro, it, iv):
        """The reference's fused VIO frame step (_vio_frame_core + _ba_tail)."""
        vcfg = self.cfg.vio
        self.vio_state = vimotion.imu_feed_batch(vcfg, self.vio_state, acc, gyro, it, iv)
        ff = vimotion.get_frame_state(self.vio_state, t_img, self.T_i_c)
        self._apply_pending()
        fe = self.fe_state
        cv = se3m.compose(se3m.exp(fe.velocity), fe.T_prev)
        fe, out = tracker.track_frame(self.cfg.frontend, self.cam, fe, img0, img1,
                                      prior_T=se3m.where(ff.ok, ff.T_c_w, cv), use_prior=True,
                                      generator=self.generator)
        T_blend = vimotion.rp_compensate_pose(vcfg, out.T_c_w, ff.q_w_i, self.T_i_c)
        do_blend = ff.ok & (out.status == tracker.STATUS_TRACKING)
        T_out = se3m.where(do_blend, T_blend, out.T_c_w)
        self.fe_state = tracker.rebase_pose(fe, fe.frame_id - 1, T_out, do_blend)
        out = out._replace(T_c_w=T_out)
        if bool(out.status == tracker.STATUS_TRACKING):
            self.vio_state = vimotion.correction_from_vision(vcfg, self.vio_state, t_img,
                                                             T_out, self.T_i_c)
        return out, self._backend_tail(out, img0, img1)

    def _log(self, out, t_img, res):
        if res is not None:
            self.ba_costs.append(float(res.cost))
            self.n_valid_corrections += int(res.correction.valid)
        self.trajectory.append((self._frames_processed, t_img,
                                out.T_c_w.q.detach().cpu().numpy(),
                                out.T_c_w.t.detach().cpu().numpy()))
        self._frames_processed += 1

    def _to_device(self, img):
        return torch.as_tensor(np.asarray(img)).to(self.device)

    # -------------------------------------------------------------- entries
    def process_frame(self, img0, img1, t_img: float = 0.0):
        """One frame (host arrays or tensors, uint8 or float32) at image time
        t_img; returns the FrameOutput (tensors on the system's device)."""
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
        res = self._backend_tail(out, img0, img1)
        if self.use_imu and bool(out.status == tracker.STATUS_TRACKING):
            self.vio_state = vimotion.correction_from_vision(
                self.cfg.vio, self.vio_state, t_img, out.T_c_w, self.T_i_c)
        self._log(out, t_img, res)
        return out

    def process_frames(self, imgs0, imgs1, ts=None):
        """Replay T stacked stereo frames (T, H, W); returns the FrameOutput
        stacked over T as host numpy arrays."""
        imgs0, imgs1 = self._to_device(imgs0), self._to_device(imgs1)
        outs = []
        for i in range(imgs0.shape[0]):
            out, res = self._stereo_step(imgs0[i], imgs1[i])
            self._log(out, float(ts[i]) if ts is not None else 0.0, res)
            outs.append(out)
        return tree_map(lambda *xs: torch.stack(xs).cpu().numpy(), *outs)

    def process_frames_vio(self, imgs0, imgs1, ts, imu_acc, imu_gyro, imu_t,
                           imu_pad: int = 16):
        """Replay T stacked stereo frames with their IMU: imu_acc/imu_gyro/
        imu_t are length-T lists of the samples since the previous frame.
        Returns the FrameOutput stacked over T as host numpy arrays."""
        imgs0, imgs1 = self._to_device(imgs0), self._to_device(imgs1)
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
        outs = []
        for i in range(imgs0.shape[0]):
            out, res = self._vio_step(imgs0[i], imgs1[i], ts32[i], acc[i], gyro[i], it[i],
                                      iv[i])
            self._log(out, float(ts[i]), res)
            outs.append(out)
        return tree_map(lambda *xs: torch.stack(xs).cpu().numpy(), *outs)

    def flush(self):
        """Nothing is in flight without pipelining; kept for the reference's
        replay loop shape.  Returns None."""
        return None

    def flush_loop(self):
        """The loop node resolves every keyframe at once; kept for the
        reference's API shape."""
        return None

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
