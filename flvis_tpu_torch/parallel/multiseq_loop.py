"""Multi-sequence replay WITH the loop-closing stage (port of
flvis_tpu/parallel/multiseq_loop.py).

The reference's default launch runs tracking, local-map BA and loop
closing for every run, so "all runs at once" carries a loop node per
sequence.  The frame step (tracking + window BA + feedback [+ VIO]) runs
for the S sequences through parallel/multiseq.frame_step: on a CUDA
device captured once per kind (stereo, VIO) into one CUDA graph at the
first chunk — S independent branches, one a sequence — and replayed a
frame, with no host read inside a chunk (the host copies the frame's
stacked inputs in, draws each sequence's uniforms from its own generator
into the graph's (S, draws_size) buffer, replays, and copies the frame's
(S, 14) rows out); on the CPU eagerly, frame by frame.  A capture failure
raises, naming the operation; nothing falls back to the eager loop.  The
eager route on the card (`_run_chunk_eager`) is kept for comparisons.

The loop stage runs per sequence over its own LoopCloser, eagerly at the
chunk ends, with the chunked replay's deferred contract
(pipeline/runner.LoopStage):

  chunk N   : ingest chunk N's keyframes (add_keyframes_batch); gate them
  chunk N+1 : the chunk's one host fetch carries the gate rows → host
              decision → verification (8-wide buckets)
  chunk N+2 : the fetch carries the verification statistics → accept gates
              → pose-graph optimisation

With pipelined=True a chunk's end runs after the next chunk has been
stepped: process_chunk* returns the previous chunk's packed outputs (None
on the first call) and flush() drains, the reference's return lag.

mesh (a parallel/mesh.Mesh on the `seq` axis; the reference's shard_map
over P("seq"), multiseq.py:351-415): each rank holds its contiguous block
of the S sequences (multihost.host_sequence_slice) — their states,
generators, captured step (one graph of S/n branches on the card) and loop
nodes — and runs no collective in the frame loop.  process_chunk* take the
(S, …) inputs and upload only the rank's block, and return the block's
packed rows; trajectory_cam_centers gathers a sequence to every rank at the
caller's request (a collective: every rank calls it).  A sequence's
generator starts from `seed` wherever it lives, so its draws and results do
not depend on the rank that holds it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..frontend import tracker
from ..geometry import se3 as se3m, so3
from ..geometry.camera import StereoCamera
from ..geometry.se3 import SE3
from ..loop.loop_closing import LoopCloser
from ..pipeline import runner as runner_m
from ..utils import profiling
from ..utils.tree import tree_map
from . import multihost, multiseq


class MultiSeqSlam:
    """S independent SLAM runs on one device (default "cuda"): one chunk
    step over the S sequences + S loop nodes.

    Args:
      cfg: SystemConfig shared by every sequence.
      cam: StereoCamera shared by every sequence (or `cams`, one each).
      num_seqs: S.
      use_imu: run the VIO frame step per sequence (process_chunk_vio).
      use_loop: a LoopCloser per sequence.
      mesh: the sequences split over the ranks of a `seq` mesh (module
        note); the system then lives on the mesh's device.
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
        self.cfg = cfg
        self.cam = cam
        self.S = num_seqs
        self.mesh = mesh
        # The global indices of the sequences this process holds.
        self.seqs = (range(num_seqs) if mesh is None
                     else range(num_seqs)[multihost.host_sequence_slice(num_seqs, mesh)])
        n_local = len(self.seqs)
        self.use_imu = use_imu
        self.ba_every = ba_every
        self.device = torch.device(device) if mesh is None else mesh.device
        cams = list(cams) if cams is not None else [cam] * num_seqs
        self.cams = [tree_map(lambda a: a.to(self.device), cams[s]) for s in self.seqs]
        one_T = T_i_c if T_i_c is not None else se3m.identity(device=self.device)
        self.T_i_cs = [SE3(one_T.q.to(self.device), one_T.t.to(self.device))] * n_local
        states = multiseq.init_system_states(cfg.frontend, cfg.backend, n_local,
                                             device=self.device,
                                             vcfg=cfg.vio if use_imu else None)
        self.fe, self.ba, self.corr = states[:3]
        self.vio = states[3] if use_imu else None
        self.generators = [torch.Generator(device=self.device).manual_seed(seed)
                           for _ in range(n_local)]
        self.loopers: list = [LoopCloser(cfg.loop, c, device=self.device) if use_loop else None
                              for c in self.cams]
        self.stages = [runner_m.LoopStage(lc, seq=s) if lc is not None else None
                       for s, lc in zip(self.seqs, self.loopers)]
        self._frames = 0
        self.trajectories: list = [[] for _ in range(n_local)]    # a held sequence's frames
        self.ba_costs: list = [[] for _ in range(n_local)]   # a frame's window BA cost (0: none)
        self.pipelined = pipelined
        self._inflight = None
        self._captured = {}             # "stereo" / "vio" -> runner._Captured (CUDA devices)
        # Each sequence's schur last-block ticket: its branch's own.
        self._tickets = (torch.zeros((n_local, 1), dtype=torch.int32, device=self.device)
                         if self.device.type == "cuda" else None)

    def _to_device(self, a, dtype=None):
        """(S, …) inputs → this process's block on the device (inputs of
        the block's size pass as they are).  An upload from host memory
        waits for the device (a counted host sync)."""
        if len(a) == self.S and len(self.seqs) != self.S:
            a = a[self.seqs.start:self.seqs.stop]
        if isinstance(a, torch.Tensor) and a.device == self.device:
            return a.to(dtype=dtype)
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        with profiling.host_sync("multiseq.upload"):
            return t.to(self.device, dtype)

    # ---------------------------------------------------------------- steps
    def _carries(self, vio: bool):
        return tuple(zip(self.fe, self.ba, self.vio, self.corr) if vio
                     else zip(self.fe, self.ba, self.corr))

    def _set_carries(self, vio: bool, carries):
        cols = [list(c) for c in zip(*carries)]
        if vio:
            self.fe, self.ba, self.vio, self.corr = cols
        else:
            self.fe, self.ba, self.corr = cols

    def _step(self, kind: str, tickets=None):
        return multiseq.frame_step(self.cfg.frontend, self.cfg.backend, self.cams,
                                   self.ba_every, vcfg=self.cfg.vio if kind == "vio" else None,
                                   T_i_cs=self.T_i_cs, tickets=tickets)

    def _frame_major(self, seq_xs):
        """(S, T, ...) inputs → frame-major (T, S, ...) views, with the
        chunk's window-solve schedule (T,) last."""
        T = seq_xs[0].shape[1]
        return (tuple(x.transpose(0, 1) for x in seq_xs)
                + (multiseq.solve_schedule(T, self.ba_every, self.device),))

    def _draw(self, out=None):
        return multiseq.make_draws(self.cfg.frontend, self.generators, self.device, out=out)

    def _run_chunk(self, kind: str, seq_xs):
        """Step the chunk ((S, T, ...) inputs on the device) from the
        sequences' states: on a CUDA device one replay of the captured step
        a frame (captured at the first chunk), else the eager step.
        Updates the states; returns the packed (S, T, 14) rows and the
        captured step, or None."""
        if self.device.type != "cuda":
            return self._run_chunk_eager(kind, seq_xs)
        cap = self._captured_step(kind, seq_xs)
        carries, rows = cap.run(self._carries(kind == "vio"), self._frame_major(seq_xs),
                                self._draw)
        self._set_carries(kind == "vio", carries)
        return rows.transpose(0, 1), cap

    def _captured_step(self, kind: str, seq_xs):
        """The captured `kind` step, captured now (from the sequences'
        states, on a frame of seq_xs's shapes) unless it was before."""
        cap = self._captured.get(kind)
        if cap is None:
            xs = tuple(x[0] for x in self._frame_major(seq_xs))
            n = len(self.seqs)
            u = torch.zeros((n, tracker.draws_size(self.cfg.frontend)),
                            dtype=torch.float32, device=self.device)
            cap = self._captured[kind] = runner_m._Captured(
                self._step(kind, self._tickets), self._carries(kind == "vio"), xs, u,
                f"the {n}-sequence {kind} frame step", branches=n)
        return cap

    def _run_chunk_eager(self, kind: str, seq_xs):
        """_run_chunk through the eager loop over the same step, on the
        same draws."""
        with profiling.span("step.run", replays=seq_xs[0].shape[1]):
            carries, rows = multiseq.run_chunk_eager(self._step(kind),
                                                     self._carries(kind == "vio"),
                                                     self._frame_major(seq_xs), self._draw)
        self._set_carries(kind == "vio", carries)
        return rows.transpose(0, 1), None

    # ---------------------------------------------------------------- chunks
    def process_chunk(self, imgs0, imgs1, ts=None):
        """One (S, T, H, W) chunk through the frame step, then the
        per-sequence loop stage.  Returns the (S, T, 12) packed host outputs
        (columns as runner._pack_outputs) — with a mesh, the rank's block's
        rows, (S/n, T, 12)."""
        cid = profiling.new_chunk()
        with profiling.span("chunk", chunk=cid, frames=np.shape(imgs0)[1], seqs=len(self.seqs)):
            if ts is not None and len(ts) == self.S:
                ts = np.asarray(ts)[self.seqs.start:self.seqs.stop]
            with profiling.span("chunk.upload"):
                imgs0, imgs1 = self._to_device(imgs0), self._to_device(imgs1)
            rows, cap = self._run_chunk("stereo", (imgs0, imgs1))
            return self._after_dispatch(rows, cap, imgs0, imgs1, ts, cid)

    def process_chunk_vio(self, imgs0, imgs1, ts, acc, gyro, imu_t, imu_valid):
        """VIO variant: (S, T) image times plus (S, T, P, ·) packed per-frame
        IMU batches (runner.pack_imu_frames per sequence)."""
        cid = profiling.new_chunk()
        with profiling.span("chunk", chunk=cid, frames=np.shape(imgs0)[1], seqs=len(self.seqs)):
            if len(ts) == self.S:
                ts = np.asarray(ts)[self.seqs.start:self.seqs.stop]
            f = torch.float32
            with profiling.span("chunk.upload"):
                imgs0, imgs1 = self._to_device(imgs0), self._to_device(imgs1)
                xs = (imgs0, imgs1, self._to_device(ts, f), self._to_device(acc, f),
                      self._to_device(gyro, f), self._to_device(imu_t, f),
                      self._to_device(imu_valid, torch.bool))
            rows, cap = self._run_chunk("vio", xs)
            return self._after_dispatch(rows, cap, imgs0, imgs1, ts, cid)

    def _after_dispatch(self, *chunk):
        """Synchronous mode finishes the chunk now; pipelined mode keeps it
        in flight and finishes the previous one (None on the first call)."""
        if not self.pipelined:
            return self._finish(*chunk)
        prev, self._inflight = self._inflight, chunk
        return self._finish(*prev) if prev is not None else None

    # ----------------------------------------------------------- loop stage
    def _finish(self, rows_dev, cap, imgs0, imgs1, ts, cid=None):
        """A chunk's end: ONE host fetch of the packed rows, the captured
        step's taken counts and every sequence's pending gate rows and
        verification statistics; then per sequence the loop stage's
        resolve, the trajectory log, and the chunk's keyframes into its
        loop node.  Its spans carry the chunk's own id `cid`, also where a
        pipelined chunk's end runs inside the next chunk's call."""
        S, T = imgs0.shape[0], imgs0.shape[1]
        with profiling.span("chunk.end", chunk=cid, frames=T):
            with profiling.span("chunk.fetch") as sp:
                pending = [st.pending() if st is not None else (None, None)
                           for st in self.stages]
                fetched = runner_m.fetch(rows_dev, cap.step.taken if cap is not None else None,
                                         *[a for p in pending for a in p])
                if cap is not None:
                    sp.set(**cap.step.settle(fetched[1]))
                    cap.settle_stream()
            packed = np.ascontiguousarray(fetched[0][..., :12])
            for s, st in enumerate(self.stages):
                if st is not None:
                    st.resolve(fetched[2 + 2 * s], fetched[3 + 2 * s])
            first = self._frames
            self._frames += T
            ts_np = None if ts is None else np.asarray(ts, np.float64)
            for s in range(S):
                with profiling.span("chunk.log", seq=self.seqs[s]):
                    for i in range(T):
                        self.trajectories[s].append(
                            (first + i, float(ts_np[s, i]) if ts_np is not None else 0.0,
                             packed[s, i, 5:9].copy(), packed[s, i, 9:12].copy()))
                    self.ba_costs[s].extend(fetched[0][s, :, 12].tolist())
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
        """(N, 3) camera centres of sequence s (a global index), optionally
        drift-corrected through its loop node.  With a mesh, every rank's
        block is gathered to every rank (multihost.gather_to_host): a
        collective every rank calls, with the same arguments."""
        if self.mesh is not None:
            local = np.stack([self._cam_centers(i, loop_corrected)
                              for i in range(len(self.seqs))]).astype(np.float64)
            return multihost.gather_to_host(self.mesh, local)[s]
        return self._cam_centers(s, loop_corrected)

    def _cam_centers(self, i: int, loop_corrected: bool):
        """Camera centres of the process's i-th sequence."""
        lc = self.loopers[i]
        out = []
        for (_, _, q, t) in self.trajectories[i]:
            q, t = torch.as_tensor(q), torch.as_tensor(t)
            if loop_corrected and lc is not None:
                T = lc.corrected_pose(SE3(q, t))
                q, t = T.q.cpu(), T.t.cpu()
            out.append(-so3.to_matrix(q).numpy().T @ t.numpy())
        return np.asarray(out)
