"""Frontend and backend on devices of their own, overlapped (port of
flvis_tpu/pipeline/overlap.py).

The reference runs tracking and the sliding-window BA as separate nodelets
whose threads overlap: tracking never waits for the BA, and corrections
arrive one keyframe late.  Here the tracker state lives on the frontend's
device and the BA window on the backend's.  Each frame the host tracks on
the frontend, hands the keyframe packet with its keyframe and reset flags
to the backend, dispatches the backend step there — the reset cond and the
keyframe cond (add_keyframe + the 12+8 Schur optimize), dispatched every
frame so the keyframe decision never needs the host — and fetches the
frame's one packed (12,) row from the frontend.  The host does not wait on
the solve: the next frame applies the Correction it returns, one frame
late, as the stepwise SlamSystem.process_frame applies it — the same
numerics.

On a CUDA backend device the backend step is captured once into a CUDA
graph (utils/control.CapturedStep: its conds IF nodes, window BA's LM
loops WHILE nodes) and replayed a frame on a stream of its own, ordered
by events: packet → solve → correction.  So on one card (`ba_device` the
frontend's card) the solve runs beside the frontend's next work instead of
ahead of the frame's fetch on one stream.  On a CPU backend device the
step runs eagerly (its conds reading the host) on one worker thread, a
frame at a time in frame order: a card frontend hands it the packet
through pinned host buffers, copied without waiting (the worker waits on
the copy's event), so the frame's fetch does not wait on the solve.  The
next frame does: its Correction is made on the host and must be there
before it is uploaded, one host wait a frame (`backend_waits`), as the
reference's host-side transfer orders it.  The frontend is the eager
track_frame, as in process_frame.  Transfers from the host go through
pinned buffers, non-blocking.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional, Union

import numpy as np
import torch

from ..backend import window_ba
from ..config import SystemConfig
from ..frontend import tracker
from ..geometry.camera import StereoCamera
from ..geometry.se3 import SE3
from ..ops.kernels import schur
from ..utils import control
from ..utils.tree import tree_leaves, tree_map
from . import runner


def _backend_step(bcfg, cam, null, ba, pkt, is_kf, reset):
    """The backend's frame step: the window reset (a cond), then on a
    keyframe add_keyframe + optimize (a cond); off keyframes the null
    Correction and a 0 cost.  Returns (ba, Correction, cost)."""
    ba = control.cond(reset, lambda b: window_ba.reset(bcfg, b), lambda b: b, (ba,),
                      name="backend_reset")

    def do(b):
        res = window_ba.optimize(bcfg, cam, window_ba.add_keyframe(bcfg, b, pkt))
        return res.state, res.correction, res.cost

    def no(b):
        return b, null, torch.zeros((), dtype=torch.float32, device=reset.device)

    return control.cond(is_kf, do, no, (ba,), name="keyframe")


def _pack_row(out: tracker.FrameOutput):
    """The frame's (12,) row [is_kf, reset, status, n_inl, err, q, t]: the
    only tensor the host fetches a frame."""
    return runner._pack_outputs(tree_map(lambda a: a[None], out))[0]


def _second_card(fe: torch.device) -> torch.device:
    """JAX's devs[1 % len(devs)]: the next CUDA device after the frontend's,
    or the frontend's own when it is the only one (or the CPU)."""
    if fe.type == "cuda" and torch.cuda.device_count() > 1:
        return torch.device("cuda", ((fe.index or 0) + 1) % torch.cuda.device_count())
    return fe


class OverlappedPipeline:
    """Frontend/backend pipeline over two devices, stepwise (a frame a call).

    fe_device (default "cuda"); ba_device (default the next CUDA device,
    else the frontend's own).  Host synchronisation: one fetch a frame of
    results (the packed row, through `_fetch`; `fetch_count` counts them);
    with a CPU backend also one wait a frame for the previous frame's
    Correction (`backend_waits`), and behind a card frontend one
    non-blocking copy of the packet to the host (`handoff_count`); the BA
    costs stay on the backend until `ba_costs()`."""

    def __init__(self, cfg: SystemConfig, cam: StereoCamera, fe_device="cuda",
                 ba_device=None, *, seed: int = 0):
        self.cfg = cfg
        self.fe_dev = torch.device(fe_device)
        if self.fe_dev.type == "cuda" and self.fe_dev.index is None:
            self.fe_dev = torch.device("cuda", torch.cuda.current_device())
        self.ba_dev = torch.device(ba_device) if ba_device is not None else \
            _second_card(self.fe_dev)
        if self.ba_dev.type == "cuda" and self.ba_dev.index is None:
            self.ba_dev = torch.device("cuda", torch.cuda.current_device())
        self.cam_fe = tree_map(lambda a: a.to(self.fe_dev), cam)
        self.cam_ba = tree_map(lambda a: a.to(self.ba_dev), cam)
        self.generator = torch.Generator(device=self.fe_dev).manual_seed(seed)
        self.fe_state = tracker.init_state(cfg.frontend, device=self.fe_dev)
        self._null_fe = window_ba.null_correction(cfg.backend, device=self.fe_dev)
        self._null_ba = window_ba.null_correction(cfg.backend, device=self.ba_dev)
        # The backend's last Correction, on the backend (a Future of it while
        # a CPU backend's worker makes it).
        self.pending_corr: Optional[Union[window_ba.Correction, Future]] = None
        self.trajectory: list = []
        self._ba_cost_handles: list = []
        self._kf_flags: list = []
        self._frames = 0
        self.fetch_count = 0        # host fetches of results (test hook)
        self.backend_waits = 0      # host waits on a CPU backend's Correction (test hook)
        self.handoff_count = 0      # non-blocking packet copies to a CPU backend (test hook)
        self._captured = None       # the backend step's CapturedStep (CUDA backend)
        self._inputs = None         # its static inputs (packet, keyframe and reset flags)
        self._corr_ready = None     # event: the pending Correction is made (CUDA backend)
        self._ba_state = window_ba.empty(cfg.backend, device=self.ba_dev)
        if self.ba_dev.type == "cuda":
            self.ba_stream = torch.cuda.Stream(self.ba_dev)
            self._ticket = torch.zeros(1, dtype=torch.int32, device=self.ba_dev)
        else:
            self._worker = ThreadPoolExecutor(max_workers=1,
                                              thread_name_prefix="overlap-backend")

    @property
    def ba_state(self) -> window_ba.WindowState:
        """The backend's window (the captured step's buffers on the card)."""
        self._settle()
        return self._captured.carry[0] if self._captured is not None else self._ba_state

    def _settle(self) -> None:
        """Wait until the backend has finished the steps dispatched so far."""
        if isinstance(self.pending_corr, Future):
            self.pending_corr.result()
        elif self.ba_dev.type == "cuda":
            self.ba_stream.synchronize()

    def _fetch(self, x) -> np.ndarray:
        """The one funnel of the frame loop's host fetches."""
        self.fetch_count += 1
        return x.cpu().numpy()

    # -------------------------------------------------------------- backend
    def _backend_fn(self, carry, xs):
        pkt, is_kf, reset = xs
        with schur.use_ticket(self._ticket):
            ba, corr, cost = _backend_step(self.cfg.backend, self.cam_ba, self._null_ba,
                                           carry[0], pkt, is_kf, reset)
        return (ba,), (corr, cost)

    def _handoff(self, xs):
        """The packet and its flags for a CPU backend, and the event the
        worker waits on before it reads them (None when they are on the
        CPU already): from a card frontend, copied into pinned host buffers
        without waiting — the one funnel of those copies (`handoff_count`)."""
        src = tree_leaves(xs)
        if not src[0].is_cuda:
            return xs, None
        self.handoff_count += 1

        def to_host(a):
            h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            return h.copy_(a, non_blocking=True)

        xs = tree_map(to_host, xs)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(src[0].device))
        return xs, copied

    def _cpu_backend(self, slot: int, xs, copied):
        """A CPU backend's frame step, on the worker thread: its cost into
        `_ba_cost_handles[slot]`; returns the Correction."""
        if copied is not None:
            copied.synchronize()
        pkt, is_kf, reset = xs
        self._ba_state, corr, cost = _backend_step(self.cfg.backend, self.cam_ba, self._null_ba,
                                                   self._ba_state, pkt, is_kf, reset)
        self._ba_cost_handles[slot] = cost
        return corr

    def _dispatch_backend(self, pkt, is_kf, reset):
        """Hand the frame's packet and flags to the backend and dispatch its
        step; its BA cost joins `_ba_cost_handles`.  Returns the Correction
        on the backend's device (a Future of it on a CPU backend)."""
        if self.ba_dev.type != "cuda":
            self._ba_cost_handles.append(None)
            return self._worker.submit(self._cpu_backend, len(self._ba_cost_handles) - 1,
                                       *self._handoff((pkt, is_kf, reset)))
        src = tree_leaves((pkt, is_kf, reset))
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(src[0].device))
        with torch.cuda.device(self.ba_dev), torch.cuda.stream(self.ba_stream):
            self.ba_stream.wait_event(ready)
            xs = tuple(tree_map(lambda a: a.to(self.ba_dev, non_blocking=True),
                                (pkt, is_kf, reset)))
            for a in src:
                a.record_stream(self.ba_stream)
            if self._captured is None:
                self._inputs = tuple(tree_map(torch.clone, xs))
                self._captured = control.CapturedStep(
                    self._backend_fn, (self._ba_state,), self._inputs,
                    name="the overlapped backend step")
            for dst, a in zip(tree_leaves(self._inputs), tree_leaves(xs)):
                dst.copy_(a)
            self._captured.replay()
            corr, cost = tree_map(torch.clone, self._captured.ys)
            self._corr_ready = torch.cuda.Event()
            self._corr_ready.record(self.ba_stream)
        self._ba_cost_handles.append(cost)
        return corr

    # ---------------------------------------------------------------- frames
    def process_frame(self, img0, img1):
        """One frame (host arrays or tensors).  Returns its FrameOutput from
        the frame's one fetched row (host values)."""
        cfg = self.cfg
        fe_stream = (torch.cuda.current_stream(self.fe_dev) if self.fe_dev.type == "cuda"
                     else None)
        img0, img1 = runner._upload(img0, self.fe_dev), runner._upload(img1, self.fe_dev)
        corr = self._null_fe
        if self.pending_corr is not None:
            # The backend's Correction, one frame late.
            pending = self.pending_corr
            if isinstance(pending, Future):
                self.backend_waits += 1
                pending = pending.result()
            if self._corr_ready is not None and fe_stream is not None:
                fe_stream.wait_event(self._corr_ready)
            corr = tree_map(lambda a: a.to(self.fe_dev, non_blocking=True) if a.is_cuda
                            else runner._upload(a, self.fe_dev), pending)
            if fe_stream is not None:
                for a in tree_leaves(pending):
                    if a.is_cuda:
                        a.record_stream(fe_stream)
            self.pending_corr = None
        fe = tracker.apply_correction(self.fe_state, corr)
        self.fe_state, out = tracker.track_frame(
            cfg.frontend, self.cam_fe, fe, img0, img1, generator=self.generator)
        pkt = tracker.make_keyframe_packet(self.fe_state, out)
        self.pending_corr = self._dispatch_backend(pkt, out.is_keyframe, out.reset_backend)
        row = self._fetch(_pack_row(out))
        self._kf_flags.append(bool(row[0] > 0.5))
        self.trajectory.append((self._frames, row[5:9], row[9:12]))
        self._frames += 1
        return tracker.FrameOutput(
            T_c_w=SE3(row[5:9], row[9:12]), is_keyframe=row[0] > 0.5,
            reset_backend=row[1] > 0.5, num_inliers=int(row[3]), mean_reproj_err=row[4],
            status=int(row[2]))

    def ba_costs(self) -> list:
        """The BA costs of the keyframe frames, fetched here, off the frame
        loop (the frames without a solve drop out)."""
        self._settle()
        return [float(c) for c, k in zip(self._ba_cost_handles, self._kf_flags) if k]
