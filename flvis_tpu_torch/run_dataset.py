"""Run the port's SLAM engine over an EuRoC or KITTI sequence or a D435i bag
(port of examples/run_dataset.py).

Reads the dataset directly (no ROS), runs the frontend + sliding-window BA
(+ optional IMU fusion and loop closing) on one device, writes the
trajectory (TUM format, or KITTI's 3×4 rows when --out ends in .kitti) and
reports ATE RMSE against ground truth when the dataset has it.

Usage:
  python -m flvis_tpu_torch.run_dataset euroc <seq_dir> [--frames N] [--imu] [--loop]
  python -m flvis_tpu_torch.run_dataset kitti <seq_dir> [--poses poses.txt] [--frames N] [--loop]
  python -m flvis_tpu_torch.run_dataset d435i <file.bag> --depth --imu \\
      [--img0 /camera/infra1/image_rect_raw] [--img1 /camera/aligned_depth_to_color/image_raw]

Common flags: --chunk N (N frames a process_frames[_vio] call: one replay
of the captured frame step a frame on the card), --pipelined, --yaml FILE,
--out FILE, --device (default cuda).  With d435i --depth the second image
is the aligned depth image and the system runs in depth mode, as the
reference's VI_TYPE_D435I_DEPTH.
"""

from __future__ import annotations

import argparse
import itertools
import time

import numpy as np


def _parser():
    ap = argparse.ArgumentParser(prog="python -m flvis_tpu_torch.run_dataset")
    ap.add_argument("dataset", choices=["euroc", "kitti", "d435i"])
    ap.add_argument("path")
    ap.add_argument("--img0", default="/camera/infra1/image_rect_raw")
    ap.add_argument("--img1", default="/camera/infra2/image_rect_raw")
    ap.add_argument("--depth", action="store_true",
                    help="d435i: img1 topic is an aligned depth image")
    ap.add_argument("--fx", type=float, default=382.6)
    ap.add_argument("--fy", type=float, default=382.6)
    ap.add_argument("--cx", type=float, default=320.0)
    ap.add_argument("--cy", type=float, default=240.0)
    ap.add_argument("--baseline", type=float, default=0.05)
    ap.add_argument("--width", type=int, default=640, help="d435i frame width")
    ap.add_argument("--height", type=int, default=480, help="d435i frame height")
    ap.add_argument("--poses", default=None, help="KITTI ground-truth poses file")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--imu", action="store_true", help="enable IMU fusion")
    ap.add_argument("--loop", action="store_true", help="enable loop closing + PGO")
    ap.add_argument("--pipelined", action="store_true",
                    help="with --chunk: results of a chunk return one chunk late")
    ap.add_argument("--loop-device", default=None,
                    help="a device for the loop node (not ported yet: raises)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="frames a process_frames[_vio] call (0: stepwise process_frame)")
    ap.add_argument("--yaml", default=None,
                    help="reference-style YAML config; the dataset reader keeps the geometry")
    ap.add_argument("--out", default="est_traj.tum")
    ap.add_argument("--device", default="cuda")
    return ap


class _BagDataset:
    """The frames of a D435i bag (io/rosbag.d435i_frames), up to `frames`."""

    def __init__(self, path, img0, img1, frames):
        from .io import rosbag

        self.gt_pos = None
        self._n = frames
        self._frames = rosbag.d435i_frames(path, img0, img1)

    def __len__(self):
        return self._n or 10 ** 9

    def frames(self, stop=None):
        return itertools.islice(self._frames, stop)


def _config(args, cam, depth_mode: bool):
    import dataclasses

    from .config import BackendConfig, FrontendConfig, SystemConfig, load_yaml

    if args.yaml:
        cfg = load_yaml(args.yaml)
        # The dataset reader owns the image geometry (it rectifies); the YAML
        # keeps the algorithm parameter surface.
        fe = dataclasses.replace(cfg.frontend, width=cam.width, height=cam.height,
                                 num_slots=256, depth_mode=depth_mode)
        return dataclasses.replace(cfg, frontend=fe)
    fe = FrontendConfig(width=cam.width, height=cam.height, num_slots=256, pyramid_levels=4,
                        per_cell=16, depth_mode=depth_mode)
    return SystemConfig(frontend=fe, backend=BackendConfig())


def _run(slam, ds, n: int, args) -> None:
    """Step the system over the dataset's first n frames: in chunks of
    args.chunk frames (the tail stepwise), or stepwise."""
    if args.chunk > 1:
        buf, done = [], 0
        for fr in ds.frames(stop=n):
            buf.append(fr)
            if len(buf) < args.chunk:
                continue
            imgs0, imgs1 = np.stack([f.img0 for f in buf]), np.stack([f.img1 for f in buf])
            ts = np.asarray([f.t for f in buf])
            if args.imu:
                outs = slam.process_frames_vio(imgs0, imgs1, ts=ts,
                                               imu_acc=[f.imu_acc for f in buf],
                                               imu_gyro=[f.imu_gyro for f in buf],
                                               imu_t=[f.imu_t for f in buf])
            else:
                outs = slam.process_frames(imgs0, imgs1, ts=ts)
            done += len(buf)
            if outs is not None:            # pipelined: one chunk late
                status = ["UNINIT", "TRACK", "FAIL"][int(outs.status[-1])]
                print(f"frame {done:5d}/{n}  {status}  inliers={int(outs.num_inliers[-1]):3d} "
                      f"kfs={len(slam.keyframes)}", flush=True)
            buf = []
        slam.flush()
        tail = buf
    else:
        tail = ds.frames(stop=n)
    for i, fr in enumerate(tail):
        if args.imu and getattr(fr, "imu_t", None) is not None and len(fr.imu_t):
            slam.feed_imu(fr.imu_acc, fr.imu_gyro, fr.imu_t)
        out = slam.process_frame(fr.img0, fr.img1, t_img=fr.t)
        if i % 20 == 0:
            status = ["UNINIT", "TRACK", "FAIL"][int(out.status)]
            print(f"frame {i:5d}/{n}  {status}  inliers={int(out.num_inliers):3d} "
                  f"kfs={len(slam.keyframes)}", flush=True)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from .geometry import camera as cam_m
    from .io import trajectory
    from .pipeline.runner import SlamSystem
    from .utils import evaluation

    if args.imu and args.dataset == "kitti":
        raise SystemExit("--imu: KITTI odometry sequences carry no IMU data")
    if args.dataset == "euroc":
        from .io.euroc import EurocDataset

        ds = EurocDataset(args.path, device=args.device)
        T_i_c, cam = ds.T_i_c, ds.camera
    elif args.dataset == "kitti":
        from .io.kitti import KittiDataset

        ds = KittiDataset(args.path, poses_file=args.poses, device=args.device)
        T_i_c, cam = None, ds.camera
    else:
        ds = _BagDataset(args.path, args.img0, args.img1, args.frames)
        T_i_c = None
        cam = cam_m.make(args.fx, args.fy, args.cx, args.cy,
                         baseline=0.0 if args.depth else args.baseline, depth_factor=1000.0,
                         width=args.width, height=args.height, device=args.device)
    depth_mode = args.dataset == "d435i" and args.depth
    cfg = _config(args, cam, depth_mode)
    slam = SlamSystem(cfg, cam, device=args.device, T_i_c=T_i_c, use_imu=args.imu,
                      use_loop=args.loop, loop_device=args.loop_device,
                      pipelined=args.pipelined and args.chunk > 1)

    n = min(args.frames or len(ds), len(ds))
    t0 = time.perf_counter()
    _run(slam, ds, n, args)
    slam.flush_loop()          # resolve the last chunk's deferred loop gate
    n_done = len(slam.trajectory)
    elapsed = time.perf_counter() - t0
    print(f"\nprocessed {n_done} frames in {elapsed:.1f} s ({n_done / elapsed:.1f} fps)")

    ts = np.asarray([t for (_, t, _, _) in slam.trajectory])
    C = slam.trajectory_cam_centers(loop_corrected=args.loop)
    qs = np.asarray([q for (_, _, q, _) in slam.trajectory])
    if args.out.endswith(".kitti"):
        trajectory.write_kitti(args.out, _poses_w_c(slam, args.loop))
    else:
        trajectory.write_tum(args.out, ts, C, qs)
    print(f"wrote {args.out}")

    if args.dataset == "euroc" and ds.gt_pos is not None:
        ia, ib = evaluation.associate(ts, ds.gt_t)
        if len(ia) > 10:
            rmse, _ = evaluation.ate_rmse(C[ia], ds.gt_pos[ib])
            print(f"ATE RMSE vs ground truth: {rmse * 100:.2f} cm over {len(ia)} poses")
    elif args.dataset == "kitti" and ds.gt_poses is not None:
        m = min(len(C), len(ds.gt_poses))
        rmse, _ = evaluation.ate_rmse(C[:m], ds.gt_poses[:m, :3, 3])
        print(f"ATE RMSE vs ground truth: {rmse:.3f} m over {m} poses")
    return 0


def _poses_w_c(slam, loop_corrected: bool):
    """(N, 4, 4) T_w_c of the system's trajectory (loop-corrected if asked)."""
    import torch

    from .geometry import se3 as se3m, so3
    from .geometry.se3 import SE3

    out = np.tile(np.eye(4), (len(slam.trajectory), 1, 1))
    for k, (_, _, q, t) in enumerate(slam.trajectory):
        T = SE3(torch.as_tensor(np.asarray(q)), torch.as_tensor(np.asarray(t)))
        if loop_corrected and slam.loop_closer is not None:
            T = slam.loop_closer.corrected_pose(T)
        T_wc = se3m.inverse(SE3(T.q.cpu(), T.t.cpu()))
        out[k, :3, :3] = so3.to_matrix(T_wc.q).numpy()
        out[k, :3, 3] = T_wc.t.numpy()
    return out


if __name__ == "__main__":
    raise SystemExit(main())
