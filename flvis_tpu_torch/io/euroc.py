"""EuRoC MAV dataset driver (ASL folder format) — port of
flvis_tpu/io/euroc.py over this package's geometry.

Replaces the reference's rosbag-replay ingestion for VI_TYPE_EUROC_MAV
(the reference: src/frontend/vo_tracking.cpp:142-147, 211-235: stereo
topics cam0/cam1 + imu0, T_imu_cam extrinsics from the YAML, and ENU axis
remap of the IMU at vo_tracking.cpp:331-357) with a pure array-in/array-out
reader over the ASL directory layout:

  <seq>/mav0/cam0/data.csv + data/<ts>.png      20 Hz stereo gray
  <seq>/mav0/cam1/...
  <seq>/mav0/imu0/data.csv                       200 Hz gyro+accel
  <seq>/mav0/state_groundtruth_estimate0/data.csv
  <seq>/mav0/cam*/sensor.yaml                    intrinsics/extrinsics

EuRoC cameras are UNRECTIFIED with radial-tangential distortion; this driver
precomputes cv2 stereo-rectification maps once (the reference calls
cv::stereoRectify in each nodelet's onInit, vo_tracking.cpp:174-264) and
yields rectified image pairs plus the rectified pinhole model, so the device
pipeline never sees distortion.  The rectified camera and the IMU-from-
camera extrinsic T_i_c are tensors on the device the caller names
(default "cuda"); the frames stay host numpy arrays.  PNG decoding and the
rectification maps use cv2, imported inside the functions that need it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np
import torch

from ..geometry import camera as cam_m, so3
from ..geometry.se3 import SE3


@dataclasses.dataclass
class EurocFrame:
    t: float
    img0: np.ndarray       # rectified left, float32 (H, W)
    img1: np.ndarray       # rectified right
    imu_t: np.ndarray      # (B,) IMU samples since previous frame
    imu_acc: np.ndarray    # (B, 3) m/s², body frame (ENU-remapped)
    imu_gyro: np.ndarray   # (B, 3) rad/s


def _load_sensor_yaml(path):
    import yaml

    with open(path) as f:
        y = yaml.safe_load(f)
    T = np.asarray(y["T_BS"]["data"], float).reshape(4, 4)
    intr = np.asarray(y.get("intrinsics", [0, 0, 0, 0]), float)
    dist = np.asarray(y.get("distortion_coefficients", [0, 0, 0, 0]), float)
    res = y.get("resolution", [752, 480])
    return T, intr, dist, (int(res[0]), int(res[1]))


class EurocDataset:
    def __init__(self, root: str, rectify: bool = True, device="cuda"):
        import cv2

        self.root = root
        mav = os.path.join(root, "mav0")
        self.T_B_c0, intr0, dist0, (w, h) = _load_sensor_yaml(
            os.path.join(mav, "cam0", "sensor.yaml"))
        self.T_B_c1, intr1, dist1, _ = _load_sensor_yaml(
            os.path.join(mav, "cam1", "sensor.yaml"))
        self.width, self.height = w, h

        K0 = np.array([[intr0[0], 0, intr0[2]], [0, intr0[1], intr0[3]], [0, 0, 1]])
        K1 = np.array([[intr1[0], 0, intr1[2]], [0, intr1[1], intr1[3]], [0, 0, 1]])
        # T_c1_c0 from body extrinsics.
        T_c1_c0 = np.linalg.inv(self.T_B_c1) @ self.T_B_c0
        R, t = T_c1_c0[:3, :3], T_c1_c0[:3, 3]

        if rectify:
            R0, R1, P0, P1, Q, _, _ = cv2.stereoRectify(
                K0, dist0, K1, dist1, (w, h),
                np.ascontiguousarray(R, np.float64),
                np.ascontiguousarray(t, np.float64).reshape(3, 1),
                flags=cv2.CALIB_ZERO_DISPARITY, alpha=0,
            )
            self.map0 = cv2.initUndistortRectifyMap(K0, dist0, R0, P0, (w, h), cv2.CV_32FC1)
            self.map1 = cv2.initUndistortRectifyMap(K1, dist1, R1, P1, (w, h), cv2.CV_32FC1)
            fx, fy, cx, cy = P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2]
            baseline = float(-P1[0, 3] / P1[0, 0])
            # Rectified-cam0-from-body: R0 rotates cam0 into the rectified frame.
            T_c0r_c0 = np.eye(4)
            T_c0r_c0[:3, :3] = R0
            self.T_B_cam = self.T_B_c0 @ np.linalg.inv(T_c0r_c0)
        else:
            self.map0 = self.map1 = None
            fx, fy, cx, cy = intr0
            baseline = float(np.linalg.norm(t))
            self.T_B_cam = self.T_B_c0

        self.camera = cam_m.make(fx, fy, cx, cy, baseline, width=w, height=h, device=device)
        # IMU-from-camera extrinsic for the VIO module (T_i_c).
        self.T_i_c = SE3(
            so3.from_matrix(torch.as_tensor(np.asarray(self.T_B_cam[:3, :3], np.float32),
                                            device=device)),
            torch.as_tensor(np.asarray(self.T_B_cam[:3, 3], np.float32), device=device),
        )

        def read_csv(p, cols):
            data = np.loadtxt(p, delimiter=",", skiprows=1, usecols=cols)
            return data if data.ndim > 1 else data[None]

        cam0_csv = np.loadtxt(os.path.join(mav, "cam0", "data.csv"), delimiter=",",
                              skiprows=1, usecols=0, dtype=np.int64)
        self.frame_ts = np.atleast_1d(cam0_csv) * 1e-9
        self.frame_files = [f"{int(ts)}.png" for ts in np.atleast_1d(cam0_csv)]

        imu = read_csv(os.path.join(mav, "imu0", "data.csv"), cols=range(7))
        self.imu_t = imu[:, 0] * 1e-9
        self.imu_gyro = imu[:, 1:4]
        self.imu_acc = imu[:, 4:7]

        gt_path = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
        if os.path.exists(gt_path):
            gt = read_csv(gt_path, cols=range(8))
            self.gt_t = gt[:, 0] * 1e-9
            self.gt_pos = gt[:, 1:4]
            self.gt_quat_wxyz = gt[:, 4:8]
        else:
            self.gt_t = self.gt_pos = self.gt_quat_wxyz = None

        # Rebase all timestamps to the sequence start: epoch-scale floats
        # (~1.4e9 s) have a float32 resolution of 128 s, which would zero
        # every IMU dt once timestamps reach the float32 device pipeline.
        t0 = min(self.imu_t[0] if len(self.imu_t) else np.inf,
                 self.frame_ts[0] if len(self.frame_ts) else np.inf)
        self.t_origin = float(t0)
        self.frame_ts = self.frame_ts - t0
        self.imu_t = self.imu_t - t0
        if self.gt_t is not None:
            self.gt_t = self.gt_t - t0

    def __len__(self):
        return len(self.frame_ts)

    def frames(self, start: int = 0, stop: Optional[int] = None) -> Iterator[EurocFrame]:
        import cv2

        stop = stop if stop is not None else len(self)
        prev_t = -np.inf
        for i in range(start, stop):
            t = self.frame_ts[i]
            f0 = os.path.join(self.root, "mav0", "cam0", "data", self.frame_files[i])
            f1 = os.path.join(self.root, "mav0", "cam1", "data", self.frame_files[i])
            img0 = cv2.imread(f0, cv2.IMREAD_GRAYSCALE)
            img1 = cv2.imread(f1, cv2.IMREAD_GRAYSCALE)
            if img0 is None or img1 is None:
                continue
            if self.map0 is not None:
                img0 = cv2.remap(img0, *self.map0, cv2.INTER_LINEAR)
                img1 = cv2.remap(img1, *self.map1, cv2.INTER_LINEAR)
            sel = (self.imu_t > prev_t) & (self.imu_t <= t)
            yield EurocFrame(
                t=float(t),
                img0=img0.astype(np.float32),
                img1=img1.astype(np.float32),
                imu_t=self.imu_t[sel].astype(np.float32),
                imu_acc=self.imu_acc[sel].astype(np.float32),
                imu_gyro=self.imu_gyro[sel].astype(np.float32),
            )
            prev_t = t
