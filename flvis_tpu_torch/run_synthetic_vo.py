"""Run the stereo visual-odometry frontend on a synthetic scene (port of
examples/run_synthetic_vo.py).

The no-dataset-needed end-to-end demo: renders a textured-plane stereo
sequence with exact ground truth, runs the tracker over it (or, with
--backend / --loop, the whole SlamSystem stepwise), and reports per-frame
tracking stats plus the final ATE RMSE.  Runs on the card unless --cpu.

Usage:
  python -m flvis_tpu_torch.run_synthetic_vo [--frames 40] [--cpu] [--backend] [--loop]
      [--viz-dir DIR]

--viz-dir writes a debug overlay PNG a frame and a marker PLY a keyframe
there, and with --backend or --loop the sparse map (sparse_map.ply).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _parser():
    ap = argparse.ArgumentParser(prog="python -m flvis_tpu_torch.run_synthetic_vo")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--backend", action="store_true",
                    help="run the full pipeline with sliding-window BA feedback")
    ap.add_argument("--loop", action="store_true",
                    help="out-and-back trajectory with loop closing + PGO")
    ap.add_argument("--viz-dir", default=None,
                    help="write per-frame debug overlay PNGs, frame-marker PLYs and (with "
                         "--backend or --loop) a sparse-map PLY here")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    import torch

    from .config import BackendConfig, FrontendConfig, LoopConfig, SystemConfig
    from .frontend import tracker
    from .geometry import camera, se3, so3
    from .io.synthetic import PlanarScene, SceneConfig, orbit_trajectory

    device = torch.device("cpu" if args.cpu else "cuda")
    print(f"device: {device}")
    scfg = SceneConfig()
    scene = PlanarScene(scfg, plane_depth=8.0, seed=1)
    if args.loop:
        half = args.frames // 2
        xs = list(np.linspace(0, 0.03 * half, half))
        xs += list(np.linspace(0.03 * half, 0.01, args.frames - half))
        poses = [(np.eye(3), -np.array([x, 0.0, 0.0])) for x in xs]
    else:
        poses = orbit_trajectory(args.frames, step=0.03)
    cfg = FrontendConfig(width=scfg.width, height=scfg.height, num_slots=128,
                         pyramid_levels=3, per_cell=8, min_distance=12.0, margin=22)
    cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                      width=scfg.width, height=scfg.height, device=device)

    print("rendering frames on host...")
    frames = [scene.render(R, t) for (R, t) in poses]

    slam = None
    if args.backend or args.loop:
        from .pipeline.runner import SlamSystem

        syscfg = SystemConfig(
            frontend=cfg,
            backend=BackendConfig(window_size=5, max_landmarks=256),
            loop=LoopConfig(max_keyframes=128, num_orb_features=200, vocab_words=128,
                            kf_start=8, kf_dist=6, nkf_closest=2, min_pts=12,
                            min_score=0.03, ratio_ransac=0.3, seq_edge_successors=3),
        )
        slam = SlamSystem(syscfg, cam, device=device, use_loop=args.loop,
                          output_sparse_map=args.viz_dir is not None)

    state = tracker.init_state(cfg, device=device)
    generator = torch.Generator(device=device).manual_seed(0)
    errs = []
    t_start = None
    for i, ((R, t), (img_l, img_r, _)) in enumerate(zip(poses, frames)):
        if slam is not None:
            out = slam.process_frame(img_l, img_r)
        else:
            state, out = tracker.track_frame(
                cfg, cam, state, torch.as_tensor(img_l, device=device),
                torch.as_tensor(img_r, device=device), generator=generator)
        q, tt = out.T_c_w.q.cpu().numpy(), out.T_c_w.t.cpu().numpy()
        if i == 0:
            t_start = time.perf_counter()  # skip the first frame's set-up
        C_gt = -R.T @ t
        R_e = so3.to_matrix(torch.as_tensor(q)).numpy()
        err = np.linalg.norm(C_gt - (-R_e.T @ tt))
        errs.append(err)
        status = ["UNINIT", "TRACKING", "FAIL"][int(out.status)]
        kf = " KF" if bool(out.is_keyframe) else ""
        print(f"frame {i:3d}  {status:9s} inliers={int(out.num_inliers):3d} "
              f"reproj={float(out.mean_reproj_err):5.2f}px  pos_err={err * 100:6.2f}cm{kf}")
        if args.viz_dir:
            from .viz import cloud as vcloud, overlay

            os.makedirs(args.viz_dir, exist_ok=True)
            tbl = (slam.fe_state if slam is not None else state).table
            T = se3.SE3(out.T_c_w.q, out.T_c_w.t)
            z = se3.transform_points(T, tbl.p_w)[:, 2].cpu().numpy()
            live = (tbl.active & tbl.has_3d).cpu().numpy()
            vis = overlay.to_rgb(img_l)
            fps = i / max(time.perf_counter() - t_start, 1e-6) if i > 0 else 0.0
            overlay.draw_frame(vis, tbl.uv.cpu().numpy(), z, live, fps=fps,
                               reproj_err=float(out.mean_reproj_err), zmin=1.0, zmax=12.0)
            overlay.save_png(os.path.join(args.viz_dir, f"frame_{i:04d}.png"), vis)
            if bool(out.is_keyframe):
                vcloud.save_frame_marker_ply(os.path.join(args.viz_dir, f"marker_{i:04d}.ply"),
                                             T, tbl.p_w, live)
    elapsed = time.perf_counter() - t_start
    n_timed = len(frames) - 1
    if slam is not None and slam.loop_closer is not None:
        print(f"\nloop closures accepted: {len(slam.loop_closer.closures)}")
    if args.viz_dir and slam is not None and slam.sparse_map is not None:
        n_map = slam.sparse_map.save_ply(os.path.join(args.viz_dir, "sparse_map.ply"))
        print(f"sparse map: {n_map} voxel points -> {args.viz_dir}/sparse_map.ply")
    ate = float(np.sqrt(np.mean(np.square(errs))))
    path_len = 0.03 * len(poses)
    print(f"\nATE RMSE: {ate * 100:.2f} cm over a {path_len:.2f} m path "
          f"({100 * ate / path_len:.2f} %)")
    print(f"throughput: {n_timed / max(elapsed, 1e-9):.1f} frames/s (after the first frame)")
    ok = ate < 0.02 * path_len + 0.01
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
