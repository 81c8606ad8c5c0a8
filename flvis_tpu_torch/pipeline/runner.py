"""Single-sequence SLAM pipeline: frontend tracking + keyframe window BA +
correction feedback (port of the stereo path of flvis_tpu/pipeline/runner.py).

One frame step = apply the pending Correction → track_frame → on a backend
reset, wipe the window → on a keyframe, add_keyframe + the 12+8 Schur LM
optimize, whose Correction is applied at the start of the next frame (the
reference's one-keyframe-late feedback).  The reference runs a chunk of
such steps as one lax.scan device program; here process_frames is a Python
loop over the same step, so it and process_frame share every line.

The lax.conds of the reference's backend tail (runner.py:87,100) are host
branches on out.reset_backend / out.is_keyframe.  With the tracker's two
host branches they are what keeps the frame step from being captured as
one CUDA graph.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
IMU propagation (use_imu, T_i_c), the loop node (use_loop, loop_device),
the sparse-map recorder (output_sparse_map) and double-buffered chunks
(pipelined=True).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from flvis_tpu.config import SystemConfig

from ..backend import window_ba
from ..frontend import tracker
from ..geometry import so3
from ..geometry.camera import StereoCamera
from ..utils.tree import tree_map

_NOT_PORTED = {
    "use_imu": "ROADMAP Queue 1 item 8 (vio/vimotion.py, kernel imu_chain)",
    "T_i_c": "ROADMAP Queue 1 item 8 (vio/vimotion.py, kernel imu_chain)",
    "use_loop": "ROADMAP Queue 1 item 9 (the loop node)",
    "loop_device": "ROADMAP Queue 1 item 10 (pipeline/overlap.py, SlamSystem(loop_device=))",
    "output_sparse_map": "ROADMAP Queue 1 item 11 (viz/cloud.py)",
    "pipelined": "ROADMAP Queue 1 item 7 (pipelined=True double buffering)",
}


class SlamSystem:
    """Stereo SLAM engine instance for one sequence, on one device."""

    def __init__(self, cfg: SystemConfig, cam: StereoCamera, *, device, seed: int = 0,
                 T_i_c=None, use_imu: bool = False, use_loop: bool = False,
                 output_sparse_map: bool = False, loop_device=None,
                 pipelined: bool = False):
        asked = {"use_imu": use_imu, "T_i_c": T_i_c is not None, "use_loop": use_loop,
                 "loop_device": loop_device is not None,
                 "output_sparse_map": output_sparse_map, "pipelined": pipelined}
        for name, on in asked.items():
            if on:
                raise NotImplementedError(f"SlamSystem({name}=...) is not ported yet: "
                                          f"{_NOT_PORTED[name]}")
        if cfg.frontend.depth_mode:
            raise NotImplementedError("SlamSystem runs the stereo path; depth mode is "
                                      "ported in frontend.tracker only")
        self.cfg = cfg
        self.cam = cam
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.fe_state = tracker.init_state(cfg.frontend, device=self.device)
        self.ba_state = window_ba.empty(cfg.backend, device=self.device)
        self.pending_corr: Optional[window_ba.Correction] = None
        self._frames_processed = 0
        self.keyframes: list = []       # KeyframePacket per keyframe
        self.trajectory: list = []      # (frame_id, t_img, q, t) numpy
        self.ba_costs: list = []        # float BA cost per keyframe
        self.n_valid_corrections = 0    # keyframes whose BA produced a valid Correction

    def _frame_step(self, img0, img1):
        """Correction → track → backend tail.  Returns (FrameOutput, the
        keyframe's BAResult or None)."""
        if self.pending_corr is not None:
            self.fe_state = tracker.apply_correction(self.fe_state, self.pending_corr)
            self.pending_corr = None
        self.fe_state, out = tracker.track_frame(
            self.cfg.frontend, self.cam, self.fe_state, img0, img1,
            generator=self.generator)
        if bool(out.reset_backend):
            self.ba_state = window_ba.reset(self.cfg.backend, self.ba_state)
        if not bool(out.is_keyframe):
            return out, None
        pkt = tracker.make_keyframe_packet(self.fe_state, out)
        self.ba_state = window_ba.add_keyframe(self.cfg.backend, self.ba_state, pkt)
        res = window_ba.optimize(self.cfg.backend, self.cam, self.ba_state)
        self.ba_state = res.state
        self.pending_corr = res.correction
        self.keyframes.append(pkt)
        return out, res

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

    def process_frame(self, img0, img1, t_img: float = 0.0):
        """One frame (host arrays or tensors, uint8 or float32); returns the
        FrameOutput (tensors on the system's device)."""
        out, res = self._frame_step(self._to_device(img0), self._to_device(img1))
        self._log(out, t_img, res)
        return out

    def process_frames(self, imgs0, imgs1, ts=None):
        """Replay T stacked frames (T, H, W); returns the FrameOutput stacked
        over T as host numpy arrays."""
        imgs0 = self._to_device(imgs0)
        imgs1 = self._to_device(imgs1)
        outs = []
        for i in range(imgs0.shape[0]):
            out, res = self._frame_step(imgs0[i], imgs1[i])
            self._log(out, float(ts[i]) if ts is not None else 0.0, res)
            outs.append(out)
        return tree_map(lambda *xs: torch.stack(xs).cpu().numpy(), *outs)

    def flush(self):
        """Nothing is in flight without pipelining; kept for the reference's
        replay loop shape.  Returns None."""
        return None

    def trajectory_cam_centers(self):
        """(N, 3) camera centres C = −Rᵀ t in the world frame."""
        out = []
        for (_, _, q, t) in self.trajectory:
            R = so3.to_matrix(torch.as_tensor(q)).numpy()
            out.append(-R.T @ np.asarray(t))
        return np.asarray(out)
