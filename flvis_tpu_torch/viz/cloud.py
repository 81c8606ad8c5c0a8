"""Point-cloud outputs: voxel-grid sparse map, depth bands, PLY markers
(port of flvis_tpu/viz/cloud.py).

Covers the reference's point-cloud publication surfaces without ROS:

- `voxel_downsample` — the PCL VoxelGrid (0.08 m leaf) the local-map node
  applies before publishing the sparse map (the reference:
  src/backend/vo_localmap.cpp:367-377), as a fixed-shape op (mask in, mask
  out) on the points' device.
- `SparseMapRecorder` — accumulates BA-corrected landmark positions by id
  (the `map` cloud the reference grows from optimized keyframes) and exports
  a voxel-downsampled PLY.
- `depth_band_cloud` — the OctomapFeeder sampling pattern: rows around the
  image centre at a fixed pixel step, range-gated, back-projected
  (src/octofeeder/octomap_feeder.cpp:18-80).
- `camera_pyramid_segments` / `landmark_segments` — the RVIZFrame marker
  geometry (camera frustum pyramid + camera→landmark line list,
  src/visualization/rviz_frame.cpp:60-144) as world-frame line segments,
  exportable to PLY for any mesh viewer.

`voxel_downsample` orders the voxels as the reference does (a stable
lexicographic sort on the cell's (x, y, z), x first, invalid points in a
sentinel cell sorted last), and sums each voxel's members in a fixed order
(a segmented Hillis–Steele scan in float64 over the sorted points: no
atomics), so a cloud repeats bit for bit on the card.  `write_ply` and the
marker functions are host numpy, byte for byte the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import camera as cam_m, se3 as se3m
from ..geometry.camera import StereoCamera
from ..geometry.se3 import SE3


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# --------------------------------------------------------------------- voxel
_SENTINEL = 2 ** 24           # the reference's cell of invalid points, sorted last


def _segment_sums(x, start):
    """Per-row inclusive sums of x (n, c) over each row's segment
    [start[i], i], in a fixed order: log2(n) doubling steps of elementwise
    adds, each adding the partial sum `s` rows back while that row is still
    in the segment."""
    n = x.shape[0]
    idx = torch.arange(n, device=x.device)
    s = 1
    while s < n:
        take = (idx - s >= start)[:, None]
        prev = torch.cat([torch.zeros_like(x[:s]), x[:-s]])
        x = torch.where(take, x + prev, x)
        s *= 2
    return x


def voxel_downsample(points, mask, leaf: float = 0.08):
    """Voxel-grid downsample: one centroid per occupied leaf-sized voxel.

    points (N, 3) float32 + validity mask (N,) -> (points_out (N, 3),
    mask_out (N,)) on the points' device, where mask_out marks one
    representative per voxel (the centroid of its members) packed at the
    front, in the order of the voxels' (x, y, z) cells.  Fixed shapes — the
    PCL VoxelGrid<pcl::PointXYZ> setLeafSize(0.08) equivalent
    (vo_localmap.cpp:369-371)."""
    points = torch.as_tensor(points)
    mask = torch.as_tensor(mask, device=points.device).to(torch.bool)
    n = points.shape[0]
    cell = torch.floor(points / leaf).to(torch.int32)
    cell = torch.where(mask[:, None], cell, torch.full_like(cell, _SENTINEL))
    # Stable sorts on z, then y, then x: jnp.lexsort((z, y, x)).
    order = torch.arange(n, device=points.device)
    for axis in (2, 1, 0):
        order = order[torch.sort(cell[order, axis], stable=True).indices]
    cell_s, pts_s, mask_s = cell[order], points[order], mask[order]
    new_seg = torch.ones(n, dtype=torch.bool, device=points.device)
    new_seg[1:] = torch.any(cell_s[1:] != cell_s[:-1], dim=1)
    seg_id = torch.cumsum(new_seg.to(torch.int64), 0) - 1
    idx = torch.arange(n, device=points.device)
    start = torch.cummax(torch.where(new_seg, idx, 0), 0).values
    w = mask_s.to(torch.float64)
    sums = _segment_sums(torch.cat([pts_s.to(torch.float64) * w[:, None], w[:, None]], 1),
                         start)
    last = torch.ones(n, dtype=torch.bool, device=points.device)
    last[:-1] = new_seg[1:]
    # Each segment's total sits at its last row; gather them to the front.
    totals = torch.zeros((n, 4), dtype=torch.float64, device=points.device)
    totals[seg_id[last]] = sums[last]
    cnts = totals[:, 3]
    centroids = (totals[:, :3] / torch.clamp(cnts, min=1.0)[:, None]).to(points.dtype)
    return centroids, cnts > 0


# ----------------------------------------------------------------- PLY export
def write_ply(path: str, points, mask=None, colors=None,
              edges: np.ndarray | None = None) -> int:
    """ASCII PLY writer for points (+ optional uint8 colors and line edges).

    Replaces sensor_msgs::PointCloud2 publication as the inspectable output
    format.  Returns the number of vertices written."""
    pts = np.asarray(_np(points), np.float32).reshape(-1, 3)
    if mask is not None:
        m = np.asarray(_np(mask), bool).reshape(-1)
        pts = pts[m]
        if colors is not None:
            colors = np.asarray(colors).reshape(-1, 3)[m]
    n = len(pts)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        if edges is not None:
            f.write(f"element edge {len(edges)}\n")
            f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{pts[i, 0]:.4f} {pts[i, 1]:.4f} {pts[i, 2]:.4f}"
            if colors is not None:
                c = np.asarray(colors[i], np.int64)
                row += f" {c[0]} {c[1]} {c[2]}"
            f.write(row + "\n")
        if edges is not None:
            for a, b in np.asarray(edges, np.int64):
                f.write(f"{a} {b}\n")
    return n


# ------------------------------------------------------------- sparse map rec
class SparseMapRecorder:
    """Accumulates the latest BA-corrected world position per landmark id —
    the local-map node's growing `map` cloud (vo_localmap.cpp:320-377) —
    and exports it voxel-downsampled on `device` (default "cuda")."""

    def __init__(self, leaf: float = 0.08, device="cuda"):
        self.leaf = leaf
        self.device = torch.device(device)
        self._pts: dict[int, np.ndarray] = {}

    def add_correction(self, lm_id, lm_pw, mask) -> None:
        """A Correction's landmarks (host arrays or tensors): each valid
        id's position replaces the one recorded before."""
        ids = _np(lm_id).reshape(-1)
        pw = _np(lm_pw).reshape(-1, 3)
        m = np.asarray(_np(mask), bool).reshape(-1)
        for k in np.flatnonzero(m):
            self._pts[int(ids[k])] = pw[k]

    def __len__(self) -> int:
        return len(self._pts)

    def cloud(self) -> np.ndarray:
        """Voxel-downsampled (M, 3) world points."""
        if not self._pts:
            return np.zeros((0, 3), np.float32)
        pts = np.asarray(list(self._pts.values()), np.float32)
        # Padded to a power-of-2 bucket, as the reference pads for its jit.
        n = len(pts)
        n_pad = max(64, 1 << (n - 1).bit_length())
        padded = np.zeros((n_pad, 3), np.float32)
        padded[:n] = pts
        out, out_mask = voxel_downsample(torch.as_tensor(padded, device=self.device),
                                         torch.arange(n_pad, device=self.device) < n,
                                         leaf=self.leaf)
        out, out_mask = _np(out), _np(out_mask)
        return out[out_mask]

    def save_ply(self, path: str) -> int:
        return write_ply(path, self.cloud())


# ------------------------------------------------------------ octomap feeder
def depth_band_cloud(cam: StereoCamera, d_img, T_c_w: SE3,
                     step: int = 7, lines: int = 3,
                     z_min: float = 0.5, z_max: float = 6.5):
    """Band-sampled depth cloud for occupancy mapping, on the camera's device.

    Samples `2*lines` rows around the image centre at `step`-pixel strides,
    converts raw Z16 depth via cam.depth_factor, range-gates to
    [z_min, z_max], and returns camera-frame points, world-frame points and
    a validity mask (OctomapFeeder::pub, octomap_feeder.cpp:33-80)."""
    dev = cam.fx.device
    d_img = torch.as_tensor(np.asarray(_np(d_img), np.float32), device=dev)
    h, w = d_img.shape
    v0 = h // 2 - step * lines - 1
    vs = v0 + step * torch.arange(2 * lines, device=dev)
    us = step * torch.arange(w // step, device=dev)
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], -1).to(torch.float32)
    raw = d_img[vv.reshape(-1), uu.reshape(-1)]
    z = raw / cam.depth_factor
    ok = torch.isfinite(z) & (z >= z_min) & (z <= z_max)
    pts_c = cam_m.backproject(cam, uv, z)
    T = SE3(T_c_w.q.to(dev), T_c_w.t.to(dev))
    pts_w = se3m.transform_points(se3m.inverse(T), pts_c)
    return pts_c, pts_w, ok


# ------------------------------------------------------------- RViz markers
# Camera-frame frustum corners used by the reference's pose marker
# (rviz_frame.cpp:102-106).
_PYRAMID_C = np.asarray(
    [[0.1, 0.07, 0.07], [0.1, -0.07, 0.07], [-0.1, -0.07, 0.07],
     [-0.1, 0.07, 0.07]], np.float32)


def camera_pyramid_segments(T_c_w: SE3):
    """(P, E): world-frame frustum-pyramid vertices (5, 3) and edge index
    pairs — apex→corners + base ring (rviz_frame.cpp:100-123)."""
    T_w_c = se3m.inverse(T_c_w)
    corners = se3m.transform_points(T_w_c, torch.as_tensor(_PYRAMID_C, device=T_c_w.q.device))
    verts = _np(torch.cat([T_w_c.t[None, :], corners], dim=0))
    edges = np.asarray([[0, 1], [0, 2], [0, 3], [0, 4],
                        [1, 2], [2, 3], [3, 4], [4, 1]], np.int64)
    return verts, edges


def landmark_segments(T_c_w: SE3, lm_pw, mask):
    """Camera-centre→landmark line list (rviz_frame.cpp LINE_LIST marker):
    returns (verts (1+N, 3), edges (M, 2)) for valid landmarks."""
    c = _np(se3m.inverse(T_c_w).t).reshape(1, 3)
    pw = _np(lm_pw).reshape(-1, 3)
    m = np.asarray(_np(mask), bool).reshape(-1)
    verts = np.concatenate([c, pw], axis=0)
    idx = np.flatnonzero(m) + 1
    edges = np.stack([np.zeros_like(idx), idx], axis=-1)
    return verts, edges


def save_frame_marker_ply(path: str, T_c_w: SE3, lm_pw, mask) -> None:
    """One RVIZFrame-equivalent marker file: camera pyramid + landmark rays."""
    pv, pe = camera_pyramid_segments(T_c_w)
    lv, le = landmark_segments(T_c_w, lm_pw, mask)
    verts = np.concatenate([pv, lv], axis=0)
    edges = np.concatenate([pe, le + len(pv)], axis=0)
    write_ply(path, verts, edges=edges)
