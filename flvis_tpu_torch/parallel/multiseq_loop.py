"""Multi-sequence replay WITH the loop-closing stage (port of
flvis_tpu/parallel/multiseq_loop.py).

The reference's default launch runs tracking, local-map BA and loop
closing for every run, so "all runs at once" carries a loop node per
sequence.  The chunk step (tracking + window BA + feedback [+ VIO]) runs
for the S sequences through parallel/multiseq; the loop stage runs per
sequence over its own LoopCloser with the chunked replay's deferred
contract (pipeline/runner.LoopStage):

  chunk N   : ingest chunk N's keyframes (add_keyframes_batch); gate them
  chunk N+1 : the chunk's one host fetch carries the gate rows → host
              decision → verification (8-wide buckets)
  chunk N+2 : the fetch carries the verification statistics → accept gates
              → pose-graph optimisation

With pipelined=True a chunk's end runs after the next chunk has been
stepped: process_chunk* returns the previous chunk's packed outputs (None
on the first call) and flush() drains.  The frame step reads the device
at its host branches, so this keeps the reference's return lag and
dataflow without overlapping anything.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..geometry import se3 as se3m, so3
from ..geometry.camera import StereoCamera
from ..geometry.se3 import SE3
from ..loop.loop_closing import LoopCloser
from ..pipeline import runner as runner_m
from ..utils.tree import tree_map
from . import multiseq


class MultiSeqSlam:
    """S independent SLAM runs on one device (default "cuda"): one chunk
    step over the S sequences + S loop nodes.

    Args:
      cfg: SystemConfig shared by every sequence.
      cam: StereoCamera shared by every sequence (or `cams`, one each).
      num_seqs: S.
      use_imu: run the VIO frame step per sequence (process_chunk_vio).
      use_loop: a LoopCloser per sequence.
      mesh: not ported — the sharded variants need more than one device.
      ba_every: window-BA cadence (parallel/multiseq module note).
      T_i_c: IMU-from-camera extrinsic shared by every sequence.
      pipelined: results one chunk late, as SlamSystem(pipelined=True).
      seed: every sequence's torch.Generator starts from it, so sequences
        share their draws as the reference's frame-keyed draws are shared.
    """

    def __init__(self, cfg: SystemConfig, cam: StereoCamera, num_seqs: int,
                 use_imu: bool = False, use_loop: bool = True, mesh=None, ba_every: int = 1,
                 T_i_c: Optional[SE3] = None, cams=None, pipelined: bool = False, *,
                 device="cuda", seed: int = 0):
        if mesh is not None:
            raise NotImplementedError("MultiSeqSlam(mesh=...) is not ported yet: the "
                                      "sharded variants need more than one device "
                                      "(ROADMAP Queue 1 item 10)")
        self.cfg = cfg
        self.cam = cam
        self.S = num_seqs
        self.use_imu = use_imu
        self.ba_every = ba_every
        self.device = torch.device(device)
        self.cams = list(cams) if cams is not None else [cam] * num_seqs
        one_T = T_i_c if T_i_c is not None else se3m.identity(device=self.device)
        self.T_i_cs = [SE3(one_T.q.to(self.device), one_T.t.to(self.device))] * num_seqs
        states = multiseq.init_system_states(cfg.frontend, cfg.backend, num_seqs,
                                             device=self.device,
                                             vcfg=cfg.vio if use_imu else None)
        self.fe, self.ba, self.corr = states[:3]
        self.vio = states[3] if use_imu else None
        self.generators = [torch.Generator(device=self.device).manual_seed(seed)
                           for _ in range(num_seqs)]
        self.loopers: list = [LoopCloser(cfg.loop, c, device=self.device) if use_loop else None
                              for c in self.cams]
        self.stages = [runner_m.LoopStage(lc) if lc is not None else None
                       for lc in self.loopers]
        self._frames = 0
        self.trajectories: list = [[] for _ in range(num_seqs)]
        self.pipelined = pipelined
        self._inflight = None

    def _to_device(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

    # ---------------------------------------------------------------- chunks
    def process_chunk(self, imgs0, imgs1, ts=None):
        """One (S, T, H, W) chunk through the chunk step, then the
        per-sequence loop stage.  Returns the (S, T, 12) packed host outputs
        (columns as runner._pack_outputs)."""
        imgs0, imgs1 = self._to_device(imgs0), self._to_device(imgs1)
        self.fe, self.ba, self.corr, outs, _ = multiseq.system_chunk_batch(
            self.cfg.frontend, self.cfg.backend, self.cams, self.fe, self.ba, self.corr,
            imgs0, imgs1, self.generators, ba_every=self.ba_every)
        return self._after_dispatch(outs, imgs0, imgs1, ts)

    def process_chunk_vio(self, imgs0, imgs1, ts, acc, gyro, imu_t, imu_valid):
        """VIO variant: (S, T) image times plus (S, T, P, ·) packed per-frame
        IMU batches (runner.pack_imu_frames per sequence)."""
        imgs0, imgs1 = self._to_device(imgs0), self._to_device(imgs1)
        f = torch.float32
        (self.fe, self.ba, self.vio, self.corr, outs, _) = multiseq.system_chunk_batch_vio(
            self.cfg.frontend, self.cfg.backend, self.cfg.vio, self.cams, self.T_i_cs,
            self.fe, self.ba, self.vio, self.corr, imgs0, imgs1, self._to_device(ts, f),
            self._to_device(acc, f), self._to_device(gyro, f), self._to_device(imu_t, f),
            self._to_device(imu_valid, torch.bool), self.generators, ba_every=self.ba_every)
        return self._after_dispatch(outs, imgs0, imgs1, ts)

    def _after_dispatch(self, outs, imgs0, imgs1, ts):
        """Synchronous mode finishes the chunk now; pipelined mode keeps it
        in flight and finishes the previous one (None on the first call)."""
        packed = torch.stack([runner_m._pack_outputs(
            tree_map(lambda a: a[s], outs)) for s in range(self.S)])
        if not self.pipelined:
            return self._finish(packed, imgs0, imgs1, ts)
        prev, self._inflight = self._inflight, (packed, imgs0, imgs1, ts)
        return self._finish(*prev) if prev is not None else None

    # ----------------------------------------------------------- loop stage
    def _finish(self, packed_dev, imgs0, imgs1, ts):
        """A chunk's end: ONE host fetch of the packed outputs and every
        sequence's pending gate rows and verification statistics; then per
        sequence the loop stage's resolve, the trajectory log, and the
        chunk's keyframes into its loop node."""
        S, T = imgs0.shape[0], imgs0.shape[1]
        pending = [st.pending() if st is not None else (None, None) for st in self.stages]
        fetched = runner_m.fetch(packed_dev, *[a for p in pending for a in p])
        packed = fetched[0]
        for s, st in enumerate(self.stages):
            if st is not None:
                st.resolve(fetched[1 + 2 * s], fetched[2 + 2 * s])
        first = self._frames
        self._frames += T
        ts_np = None if ts is None else np.asarray(ts, np.float64)
        for s in range(S):
            for i in range(T):
                self.trajectories[s].append(
                    (first + i, float(ts_np[s, i]) if ts_np is not None else 0.0,
                     packed[s, i, 5:9].copy(), packed[s, i, 9:12].copy()))
            if self.stages[s] is not None:
                kf_idx = [i for i in range(T) if packed[s, i, 0] > 0.5]
                self.stages[s].ingest(imgs0[s], imgs1[s], kf_idx, packed[s, kf_idx, 5:9],
                                      packed[s, kf_idx, 9:12], [first + i for i in kf_idx])
        return packed

    def flush(self):
        """Finish the chunk in flight (pipelined mode) and resolve every
        sequence's deferred verification and candidate gate; call once after
        the replay.  Returns the last chunk's packed outputs, or None."""
        out = None
        if self._inflight is not None:
            inflight, self._inflight = self._inflight, None
            out = self._finish(*inflight)
        for st in self.stages:
            if st is not None:
                st.flush()
        return out

    # -------------------------------------------------------------- exports
    def trajectory_cam_centers(self, s: int, loop_corrected: bool = False):
        """(N, 3) camera centres of sequence s, optionally drift-corrected
        through its loop node."""
        lc = self.loopers[s]
        out = []
        for (_, _, q, t) in self.trajectories[s]:
            q, t = torch.as_tensor(q), torch.as_tensor(t)
            if loop_corrected and lc is not None:
                T = lc.corrected_pose(SE3(q, t))
                q, t = T.q.cpu(), T.t.cpu()
            out.append(-so3.to_matrix(q).numpy().T @ t.numpy())
        return np.asarray(out)
