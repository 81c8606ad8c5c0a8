"""The system under test and the window that drives it.

The benchmark builds the program's entry from the cell's configuration
(SlamSystem for one sequence, MultiSeqSlam for several), warms it up on
the first frames of the cell's own stream (the capture of its frame step,
the loop node's first ingest, gate, verification and PGO), then measures
closed loop: the next chunk goes in when the last one's poses are on the
host.  What the program returns is kept for the reference, with the
points at which each loop node offered its closures to PGO.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

import synth


def system_config(c: dict):
    """The program's SystemConfig from a configuration file: the source's
    YAML keys mapped as the program's own YAML reader maps them (copied
    from flvis_tpu_torch/config.py load_yaml at commit 1a1c6dc), then the
    operating point's frontend keys."""
    from flvis_tpu_torch.config import (BackendConfig, FrontendConfig, LoopConfig,
                                        SystemConfig, VioConfig)

    fe = {"width": int(c["image_width"]), "height": int(c["image_height"])}
    for src, dst, typ in (("feature_para1", "per_cell", int),
                          ("feature_para3", "min_distance", float),
                          ("feature_para5", "quality_level", float),
                          ("dr_para1", "iir_ratio", float), ("dr_para2", "depth_max", float),
                          ("dr_para3", "dummy_depth", bool)):
        if src in c:
            fe[dst] = typ(c[src])
    for key in ("num_slots", "pyramid_levels", "lk_radius", "lk_iters", "margin"):
        if key in c:
            fe[key] = int(c[key])
    vio = {}
    for i, dst in enumerate(("madgwick_beta", "rp_blend", "acc_bias_gain", "gyro_bias_gain",
                             "acc_bias_sat", "gyro_bias_sat")):
        if f"vifusion_para{i + 1}" in c:
            vio[dst] = float(c[f"vifusion_para{i + 1}"])
    be = {}
    if "window_size" in c:
        be["window_size"] = max(3, min(100, int(c["window_size"])))
    lc = {"seq_edge_successors": int(c["pgo"]["seq_edge_successors"]),
          "pgo_max_loop_edges": int(c["pgo"]["max_loop_edges"])}
    for src, dst in (("lcKFStart", "kf_start"), ("lcKFDist", "kf_dist"),
                     ("lcKFMaxDist", "kf_max_dist"), ("lcNKFClosest", "nkf_closest"),
                     ("ratioMax", "ratio_max"), ("ratioRansac", "ratio_ransac"),
                     ("minPts", "min_pts"), ("minScore", "min_score")):
        if src in c:
            lc[dst] = type(LoopConfig.__dataclass_fields__[dst].default)(c[src])
    # Depth modes read the second image as a depth map; these cells are stereo.
    fe["depth_mode"] = int(c["type_of_vi"]) in (0, 2)
    # Keys no YAML key reaches, by group ({"frontend": {...}, "loop": {...}}).
    for group, keys in (("frontend", fe), ("vio", vio), ("backend", be), ("loop", lc)):
        keys.update(c.get("overrides", {}).get(group, {}))
    return SystemConfig(vi_type=int(c["type_of_vi"]), frontend=FrontendConfig(**fe),
                        vio=VioConfig(**vio), backend=BackendConfig(**be), loop=LoopConfig(**lc))


def camera(c: dict, device):
    from flvis_tpu_torch.geometry import camera as cam_m

    k = c["camera"]
    return cam_m.make(k["fx"], k["fy"], k["cx"], k["cy"], k["baseline"],
                      width=c["image_width"], height=c["image_height"], device=device)


def camera_dict(c: dict) -> dict:
    return dict(c["camera"], width=int(c["image_width"]), height=int(c["image_height"]))


class Single:
    """One SlamSystem over stream sequence 0: process_frames_vio (with an
    IMU) or process_frames, the frames handed over as host uint8 arrays."""

    def __init__(self, cfg, cam, device, seed: int, stream, use_imu: bool, traffic: dict):
        from flvis_tpu_torch.pipeline.runner import SlamSystem

        self.slam = SlamSystem(cfg, cam, device=device, seed=seed % (1 << 63),
                               use_imu=use_imu, use_loop=True)
        self.stream, self.use_imu = stream, use_imu
        self.next = 0
        self.rows = []                  # (frame ids, status, q, t) a chunk
        self.pgo_calls = [_record_pgo_calls(lc) for lc in self.closers()]
        self.at_window = [0]

    def chunk(self, T: int) -> int:
        """Stream frames next..next+T-1 through the program; returns the
        frames whose poses reached the host."""
        i0, st = self.next, self.stream
        left, right = st.images(i0, T)
        ts = st.times(i0, T)
        if self.use_imu:
            out = self.slam.process_frames_vio(left[0], right[0], ts, *st.imu_lists(i0, T))
        else:
            out = self.slam.process_frames(left[0], right[0], ts)
        self.next += T
        self.rows.append((np.arange(i0, i0 + T), np.asarray(out.status),
                          np.asarray(out.T_c_w.q), np.asarray(out.T_c_w.t)))
        return T

    def finish(self) -> int:
        self.slam.flush()
        return 0

    def captured(self) -> list:
        return list(self.slam._captured.values())

    def stages(self) -> list:
        return [self.slam.loop_stage]

    def closers(self) -> list:
        return [self.slam.loop_closer]

    def ba_states(self) -> list:
        return [self.slam.ba_state]

    def outputs(self, first: int) -> list:
        fid, status, q, t = (np.concatenate(c) for c in zip(*self.rows))
        return [_outputs(self.next, first, fid, status, q, t, self.slam.ba_state,
                         self.slam.loop_closer, self.pgo_calls[0], self.at_window[0])]


class Multi:
    """One MultiSeqSlam over the stream's S sequences (process_chunk_vio or
    process_chunk), the chunks handed over as host (S, T, ...) arrays."""

    def __init__(self, cfg, cam, device, seed: int, stream, use_imu: bool, traffic: dict):
        from flvis_tpu_torch.parallel.multiseq_loop import MultiSeqSlam

        self.ms = MultiSeqSlam(cfg, cam, num_seqs=stream.S, use_imu=use_imu, use_loop=True,
                               ba_every=int(traffic.get("ba_every", 1)),
                               pipelined=bool(traffic.get("pipelined", False)),
                               device=device, seed=seed % (1 << 63))
        self.stream, self.use_imu = stream, use_imu
        self.T = int(traffic["chunk"])
        # The lap's chunks as contiguous host arrays, made once in set-up.
        self.images = {a: tuple(np.ascontiguousarray(x) for x in stream.images(a, self.T))
                       for a in range(0, stream.frames, self.T)}
        self.next = 0
        self.inflight = []              # first frames of chunks whose rows are still due
        self.rows = []
        self.pgo_calls = [_record_pgo_calls(lc) for lc in self.closers()]
        self.at_window = [0] * stream.S

    def _take(self, packed) -> int:
        if packed is None:
            return 0
        i0 = self.inflight.pop(0)
        S, T = packed.shape[:2]
        self.rows.append((i0, packed.copy()))
        return S * T

    def chunk(self, T: int) -> int:
        i0, st = self.next, self.stream
        left, right = (self.images[i0 % st.frames] if T == self.T
                       else tuple(np.ascontiguousarray(x) for x in st.images(i0, T)))
        S = st.S
        ts = np.ascontiguousarray(np.broadcast_to(st.times(i0, T), (S, T)))
        self.inflight.append(i0)
        if self.use_imu:
            imu = tuple(np.ascontiguousarray(np.broadcast_to(a, (S,) + a.shape))
                        for a in st.imu_packed(i0, T))
            packed = self.ms.process_chunk_vio(left, right, ts, *imu)
        else:
            packed = self.ms.process_chunk(left, right, ts)
        self.next += T
        return self._take(packed)

    def finish(self) -> int:
        return self._take(self.ms.flush())

    def captured(self) -> list:
        return list(self.ms._captured.values())

    def stages(self) -> list:
        return [s for s in self.ms.stages if s is not None]

    def closers(self) -> list:
        return [lc for lc in self.ms.loopers if lc is not None]

    def ba_states(self) -> list:
        return list(self.ms.ba)

    def outputs(self, first: int) -> list:
        out = []
        for s in range(self.stream.S):
            fid = np.concatenate([i0 + np.arange(p.shape[1]) for i0, p in self.rows])
            rows = np.concatenate([p[s] for _, p in self.rows])
            out.append(_outputs(self.next, first, fid, rows[:, 2], rows[:, 5:9], rows[:, 9:12],
                                self.ms.ba[s], self.ms.loopers[s], self.pgo_calls[s],
                                self.at_window[s]))
        return out


def mark_window(sut) -> None:
    """Note the keyframes each loop node holds when the window opens."""
    sut.at_window = [lc.count for lc in sut.closers()]


def _record_pgo_calls(lc) -> list:
    """Wrap the loop node's optimize_graph so that each call notes (closures
    accepted, keyframes) on the host, with no device work; returns the list
    the calls append to."""
    calls = []
    real = lc.optimize_graph

    def optimize_graph(*a, **kw):
        calls.append((len(lc.closures), lc.count))
        return real(*a, **kw)

    lc.optimize_graph = optimize_graph
    return calls


def _outputs(frames, first, fid, status, q, t, ba, lc, calls, at_window) -> dict:
    """The program's outputs of one sequence as reference.sequence_numbers
    reads them (host arrays)."""
    keep = ba.kf_valid.cpu().numpy()
    rec = {"frames": frames, "first": first, "frame_id": fid, "status": status, "q": q, "t": t,
           "ba": (ba.kf_frame_id.cpu().numpy()[keep], ba.kf_q.cpu().numpy()[keep],
                  ba.kf_t.cpu().numpy()[keep]),
           "loop": None}
    if lc is not None:
        n = lc.count
        rec["loop"] = {
            "frame_id": lc.kf_frame_id[:n].copy(), "q": lc.kf_q[:n].cpu().numpy(),
            "t": lc.kf_t[:n].cpu().numpy(), "odom_q": lc.kf_q_odom[:n].cpu().numpy(),
            "odom_t": lc.kf_t_odom[:n].cpu().numpy(),
            "edges": [(c.kf_i, c.kf_j, c.num_inliers, c.T_ij.q.cpu().numpy(),
                       c.T_ij.t.cpu().numpy()) for c in lc.closures],
            "calls": list(calls), "at_window": at_window}
    return rec


@dataclasses.dataclass
class Record:
    """What one run measured; the metric readers read it."""
    setup_s: float = 0.0
    window_s: float = 0.0               # start to the last chunk's end
    frames: int = 0                     # sequence-frames whose poses reached the host
    trace: object = None                # instruments.Tracer of a traced run
    config: dict = None                 # the cell's configuration file


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(sut, traffic: dict, rec: Record, seconds: float, tracer=None) -> None:
    """The measured window, closed loop over chunks of traffic['chunk']
    frames until `seconds` have passed and the window has run whole laps
    (the same work in every run, however fast)."""
    T = int(traffic["chunk"])
    lap = int(traffic["lap"]["frames"])
    first = sut.next
    t0 = time.perf_counter()
    if tracer is not None:
        tracer.start_window(t0)
    end = t0
    while end - t0 < seconds or (sut.next - first) % lap:
        rec.frames += sut.chunk(T)
        end = time.perf_counter()
    rec.window_s = end - t0
    if tracer is not None:
        tracer.end_window(time.perf_counter())


def build(cell: dict, seed: int, device):
    """(the system under test, its stream): the stream rendered on the
    device from the seed, the system built from the configuration."""
    c, tr = cell["config"], cell["traffic"]
    use_imu = bool(c.get("use_imu", False))
    stream = synth.Stream(camera_dict(c), c["scene"], tr["lap"], int(tr.get("sequences", 1)),
                          seed, device, imu=use_imu, offset_m=float(tr.get("offset_m", 0.0)))
    cls = Multi if tr["system"] == "multi" else Single
    sut = cls(system_config(c), camera(c, device), device, seed, stream, use_imu, tr)
    return sut, stream
