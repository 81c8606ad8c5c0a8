"""KITTI odometry dataset driver — port of flvis_tpu/io/kitti.py.

Replaces the reference's kitti_publisher node
(the reference: src/independ_modules/kitti_publisher.cpp:24-141), which
reads `sequences/NN/image_0|image_1/*.png` at a fixed rate, publishes the
stereo pair, and republishes the ground-truth poses file with the
camera→world axis remap (lines 78-84).  Here it is a plain iterator; KITTI
images are already rectified, so the pinhole model comes straight from the
P0/P1 projection rows of calib.txt.  The camera is made on the device the
caller names (default "cuda"); frames are host numpy arrays, decoded by
the native prefetching loader (io/native_loader.py, the default) or, when
its library cannot be built, with cv2, imported inside the functions that
need it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np

from ..geometry import camera as cam_m


@dataclasses.dataclass
class KittiFrame:
    t: float
    img0: np.ndarray
    img1: np.ndarray


class KittiDataset:
    def __init__(self, sequence_dir: str, poses_file: Optional[str] = None, device="cuda"):
        self.dir = sequence_dir
        calib = {}
        with open(os.path.join(sequence_dir, "calib.txt")) as f:
            for line in f:
                if ":" in line:
                    k, v = line.split(":", 1)
                    calib[k.strip()] = np.asarray([float(x) for x in v.split()])
        P0 = calib["P0"].reshape(3, 4)
        P1 = calib["P1"].reshape(3, 4)
        fx, fy, cx, cy = P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2]
        baseline = float(-P1[0, 3] / P1[0, 0])

        self.times = np.loadtxt(os.path.join(sequence_dir, "times.txt"))
        self.times = np.atleast_1d(self.times)
        img_dir = os.path.join(sequence_dir, "image_0")
        self.files = sorted(f for f in os.listdir(img_dir) if f.endswith(".png"))
        # Probe resolution from the first image.
        import cv2

        first = cv2.imread(os.path.join(img_dir, self.files[0]), cv2.IMREAD_GRAYSCALE)
        h, w = first.shape
        self.camera = cam_m.make(fx, fy, cx, cy, baseline, width=w, height=h, device=device)

        self.gt_poses = None
        if poses_file and os.path.exists(poses_file):
            data = np.loadtxt(poses_file)
            n = data.shape[0]
            self.gt_poses = np.tile(np.eye(4), (n, 1, 1))
            self.gt_poses[:, :3, :4] = data.reshape(n, 3, 4)

    def __len__(self):
        return len(self.files)

    def frames(self, start: int = 0, stop: Optional[int] = None,
               use_native: bool = True) -> Iterator[KittiFrame]:
        stop = stop if stop is not None else len(self)

        if use_native:
            from . import native_loader

            if native_loader.available():
                p0 = [os.path.join(self.dir, "image_0", f) for f in self.files[start:stop]]
                p1 = [os.path.join(self.dir, "image_1", f) for f in self.files[start:stop]]
                pf = native_loader.StereoPrefetcher(
                    p0, p1, self.camera.width, self.camera.height)
                try:
                    for off, (img0, img1) in enumerate(pf):
                        i = start + off
                        t = float(self.times[i]) if i < len(self.times) else float(i) * 0.1
                        yield KittiFrame(t=t, img0=img0, img1=img1)
                finally:
                    pf.close()
                return

        import cv2

        for i in range(start, stop):
            img0 = cv2.imread(os.path.join(self.dir, "image_0", self.files[i]),
                              cv2.IMREAD_GRAYSCALE)
            img1 = cv2.imread(os.path.join(self.dir, "image_1", self.files[i]),
                              cv2.IMREAD_GRAYSCALE)
            if img0 is None or img1 is None:
                continue
            t = float(self.times[i]) if i < len(self.times) else float(i) * 0.1
            yield KittiFrame(t=t, img0=img0.astype(np.float32), img1=img1.astype(np.float32))
