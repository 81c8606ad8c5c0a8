"""Run many independent SLAM sequences at once on one device (port of
examples/run_multiseq.py).

The "all EuRoC runs at once" surface: S synthetic stereo sequences
(distinct scenes + trajectories, exact ground truth) through the full
pipeline — tracking + sliding-window BA + feedback, with optional
per-sequence IMU fusion and loop closing — with
parallel.multiseq_loop.MultiSeqSlam (on the card one captured CUDA graph a
frame, the S sequences its branches).  Reports per-sequence ATE and
aggregate frames/s.  Runs on the card unless --cpu.

Usage:
  python -m flvis_tpu_torch.run_multiseq --seqs 4 --frames 16
  python -m flvis_tpu_torch.run_multiseq --seqs 2 --frames 32 --loop
  python -m flvis_tpu_torch.run_multiseq --seqs 4 --frames 16 --imu --pipelined
  python -m flvis_tpu_torch.run_multiseq --cpu --seqs 2 --frames 16
  torchrun --nproc-per-node 2 -m flvis_tpu_torch.run_multiseq --seqs 4 --mesh

--mesh splits the sequences over the ranks of the process group the
environment describes (a torchrun launch; one process without one): each
rank renders, steps and loop-closes only its own block of sequences, and
the primary prints the per-sequence ATE lines, gathered at the end.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def _parser():
    ap = argparse.ArgumentParser(prog="python -m flvis_tpu_torch.run_multiseq")
    ap.add_argument("--seqs", type=int, default=4)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--imu", action="store_true", help="full VIO loop per sequence")
    ap.add_argument("--loop", action="store_true",
                    help="loop closing per sequence (out-and-back paths)")
    ap.add_argument("--pipelined", action="store_true", help="double-buffered chunk replay")
    ap.add_argument("--mesh", action="store_true",
                    help="split the sequences over the ranks of the launch's process group")
    ap.add_argument("--ba-every", type=int, default=1)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    import torch

    from .config import BackendConfig, FrontendConfig, LoopConfig, SystemConfig
    from .geometry import camera
    from .io.synthetic import PlanarScene, SceneConfig, imu_from_trajectory
    from .parallel import mesh as mesh_m, multihost, multiseq
    from .parallel.multiseq_loop import MultiSeqSlam
    from .pipeline.runner import pack_imu_frames

    device = torch.device("cpu" if args.cpu else "cuda")
    mesh = None
    if args.mesh:
        multihost.initialize(device_type=device.type)
        mesh = multiseq.make_mesh(device)
        device = mesh.device
    S, n = args.seqs, args.frames
    mine = range(S)[multihost.host_sequence_slice(S, mesh)] if mesh is not None else range(S)
    n -= n % args.chunk
    if n == 0:
        raise SystemExit("--frames must be >= --chunk")
    # Stereo geometry with observable depth at this resolution (disparity =
    # fx*b/z = 200*0.2/4 = 10 px).  The PASS bound adds a 1.5 cm absolute
    # floor: short demo paths sit at the tracker's absolute noise floor.
    scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0, cy=96.0,
                       baseline=0.2)
    cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                      width=scfg.width, height=scfg.height, device=device)
    cfg = SystemConfig(
        frontend=FrontendConfig(width=scfg.width, height=scfg.height, num_slots=128,
                                pyramid_levels=3, per_cell=8, min_distance=12.0, margin=22,
                                kf_min_trans=0.04),
        backend=BackendConfig(window_size=5, max_landmarks=256, iters1=8, iters2=4,
                              pallas_schur=False),
        loop=LoopConfig(max_keyframes=64, num_orb_features=128, vocab_words=128, kf_start=10,
                        kf_dist=8, kf_max_dist=64, nkf_closest=2, min_pts=12, min_score=0.03,
                        ratio_ransac=0.3, seq_edge_successors=3),
    )

    # Per-sequence scenes and trajectories (out-and-back when loop closing
    # is on so the tails revisit; straight pans otherwise).
    rng = np.random.default_rng(0)
    seq_frames, seq_poses = [], []
    for s in range(S):
        scene = PlanarScene(scfg, plane_depth=4.0, seed=10 + s)
        step = 0.03 + 0.005 * rng.random()
        if args.loop:
            half = n // 2
            xs = list(np.linspace(0, step * half, half)) + \
                list(np.linspace(step * half, 0.02, n - half))
        else:
            xs = [step * i for i in range(n)]
        poses = [(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]
        seq_poses.append(poses)
        # Each rank renders only its own sequences.
        seq_frames.append([scene.render(R, t) for (R, t) in poses] if s in mine else None)

    ms = MultiSeqSlam(cfg, cam, num_seqs=S, use_imu=args.imu, use_loop=args.loop,
                      ba_every=args.ba_every, pipelined=args.pipelined, device=device,
                      mesh=mesh)

    imu = None
    if args.imu:
        imu = []
        for s in mine:
            t_imu, gyro, acc, frame_t = imu_from_trajectory(seq_poses[s], fps=20.0)
            accs, gyros, imuts = [], [], []
            prev = -np.inf
            for ft in frame_t:
                m = (t_imu > prev) & (t_imu <= ft)
                accs.append(acc[m]); gyros.append(gyro[m]); imuts.append(t_imu[m])
                prev = ft
            imu.append((frame_t, accs, gyros, imuts))

    t0 = time.perf_counter()
    first_t = None
    n_timed = 0
    for c0 in range(0, n, args.chunk):
        sl = slice(c0, c0 + args.chunk)
        i0 = np.stack([np.stack([f[0] for f in seq_frames[s][sl]]) for s in mine])
        i1 = np.stack([np.stack([f[1] for f in seq_frames[s][sl]]) for s in mine])
        if args.imu:
            packs = [pack_imu_frames(im[1][sl], im[2][sl], im[3][sl], 16) for im in imu]
            ms.process_chunk_vio(i0, i1, np.stack([np.asarray(im[0][sl], np.float32)
                                                   for im in imu]),
                                 *(np.stack([p[k] for p in packs]) for k in range(4)))
        else:
            ms.process_chunk(i0, i1)
        if first_t is None:
            first_t = time.perf_counter() - t0
            t0 = time.perf_counter()
            n_timed = n - args.chunk
    ms.flush()
    if device.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    fps = S * n_timed / elapsed if n_timed else float("nan")

    capture = ", its capture included" if device.type == "cuda" else ""
    ranks = f" over {mesh.size} ranks" if mesh is not None else ""
    primary = multihost.is_primary()
    if primary:
        print(f"\n{S} sequences x {n} frames on {device}{ranks} (first chunk {first_t:.1f} s"
              f"{capture}; steady {fps:.1f} frames/s aggregate"
              f"{' on the primary' if ranks else ''})")
    loops_of = [len(lc.closures) if lc is not None else 0 for lc in ms.loopers]
    if mesh is not None:
        loops_of = sum(mesh_m.all_gather_object(mesh, loops_of), [])
    fail = False
    for s in range(S):
        C = ms.trajectory_cam_centers(s, loop_corrected=args.loop)      # every rank calls it
        C_gt = np.asarray([-R.T @ t for (R, t) in seq_poses[s]])
        ate = np.sqrt(np.mean(np.sum((C - C_gt) ** 2, axis=-1)))
        path = float(np.abs(np.diff(C_gt[:, 0])).sum())
        status = "ok" if ate < 0.02 * path + 0.015 else "HIGH"
        fail |= status != "ok"
        if primary:
            print(f"  seq {s}: ATE {100 * ate:6.2f} cm over {path:.2f} m "
                  f"({status}){f'  loops={loops_of[s]}' if args.loop else ''}")
    if primary:
        print("RESULT:", "FAIL" if fail else "PASS")
    if mesh is not None:
        multihost.shutdown()
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
