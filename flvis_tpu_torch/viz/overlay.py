"""Copy of flvis_tpu/viz/overlay.py (the port keeps its own; it imports nothing of flvis_tpu).

Debug-image overlays: grid, depth-coloured landmarks, flow, FPS/error.

Host-side equivalent of the reference's cv_draw.h
(the reference: src/visualization/include/cv_draw.h:8-123): drawFPS,
drawRegion16 (the 4x4 feature-grid lines), drawKeyPts, drawOutlier,
drawFlow, drawFrame (depth-coloured landmark dots, blue=far / red=near,
clamped to [zmin, zmax]) and visualizeDepthImg (rainbow depth colormap with
invalid pixels painted white).  The reference draws these on the frontend's
debug topic image (vo_tracking.cpp:450-473); here they render into a numpy
RGB image that examples write as PNG frames.

Inputs follow this engine's fixed-shape idiom: point arrays come with a
validity mask instead of being variable-length vectors.
"""

from __future__ import annotations

import numpy as np

try:  # cv2 is available in the target image; keep a guard for minimal envs.
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def to_rgb(img) -> np.ndarray:
    """Grayscale float (H, W) in [0, 255] -> uint8 RGB (H, W, 3)."""
    g = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    if g.ndim == 2:
        return np.repeat(g[:, :, None], 3, axis=2).copy()
    return g.copy()


def draw_grid16(img: np.ndarray, color=(255, 255, 255)) -> np.ndarray:
    """4x4 region grid lines (drawRegion16, cv_draw.h:13-25)."""
    h, w = img.shape[:2]
    for i in range(1, 4):
        y = i * (h // 4)
        x = i * (w // 4)
        img[max(y - 1, 0):y + 1, :] = color
        img[:, max(x - 1, 0):x + 1] = color
    return img


def _put_text(img, text, org, color):
    if cv2 is not None:
        cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.8, color, 2)
    return img


def draw_fps(img: np.ndarray, fps: float) -> np.ndarray:
    """FPS text, top-left, green (drawFPS / drawFrame, cv_draw.h:8-11,60-66);
    suppressed outside the reference's sane range (0, 500)."""
    if 0 < fps < 500:
        _put_text(img, f"FPS:{int(fps)}", (0, 20), (0, 255, 0))
    return img


def draw_reproj_error(img: np.ndarray, err: float) -> np.ndarray:
    """Mean reprojection error, top-right (drawFrame, cv_draw.h:67-70)."""
    _put_text(img, f"ERR:{err:.2f}", (img.shape[1] - 150, 20), (0, 255, 0))
    return img


def _dots(img, uv, mask, color, radius):
    h, w = img.shape[:2]
    uv = np.asarray(uv)
    mask = np.asarray(mask, bool)
    for k in np.flatnonzero(mask):
        x, y = int(round(float(uv[k, 0]))), int(round(float(uv[k, 1])))
        if 0 <= x < w and 0 <= y < h:
            y0, y1 = max(y - radius, 0), min(y + radius + 1, h)
            x0, x1 = max(x - radius, 0), min(x + radius + 1, w)
            c = color[k] if isinstance(color, np.ndarray) else color
            img[y0:y1, x0:x1] = c
    return img


def draw_keypoints(img, uv, mask, color=(0, 0, 255), radius=2):
    """Plain keypoint dots (drawKeyPts, cv_draw.h:27-34; reference uses BGR
    blue — here RGB, blue by default)."""
    return _dots(img, uv, mask, color, radius)


def draw_outliers(img, uv, mask, color=(255, 255, 255), radius=2):
    """White dots for rejected points (drawOutlier, cv_draw.h:36-43)."""
    return _dots(img, uv, mask, color, radius)


def draw_flow(img, uv_from, uv_to, mask,
              pt_color=(0, 255, 0), line_color=(204, 204, 0)):
    """Optical-flow vectors: green start dot + line to the tracked position
    (drawFlow, cv_draw.h:45-55)."""
    uv_from = np.asarray(uv_from)
    uv_to = np.asarray(uv_to)
    mask = np.asarray(mask, bool)
    if cv2 is not None:
        for k in np.flatnonzero(mask):
            p0 = (int(round(float(uv_from[k, 0]))), int(round(float(uv_from[k, 1]))))
            p1 = (int(round(float(uv_to[k, 0]))), int(round(float(uv_to[k, 1]))))
            cv2.line(img, p0, p1, line_color, 1)
        _dots(img, uv_from, mask, pt_color, 1)
    else:  # dots only
        _dots(img, uv_from, mask, pt_color, 1)
        _dots(img, uv_to, mask, line_color, 1)
    return img


def draw_loop_match(img_i, img_j, uv_i, uv_j, match_j, good,
                    line_color=(0, 255, 0), pt_color=(0, 0, 255)):
    """Side-by-side loop-closure match image: keyframe i (left) | keyframe j
    (right) with a line per surviving descriptor match — the reference's
    matched-points debug publication for every accepted loop
    (vo_loopclosing.cpp:689-722, cv::drawMatches equivalent).

    uv_i: (F, 2) keypoints of KF i; uv_j: (F, 2) of KF j; match_j: (F,)
    index into uv_j per KF-i keypoint; good: (F,) bool match mask.
    Returns an (H, 2W, 3) uint8 RGB image."""
    left = to_rgb(img_i)
    right = to_rgb(img_j)
    h, w = left.shape[:2]
    canvas = np.concatenate([left, right], axis=1)
    uv_i = np.asarray(uv_i)
    uv_j = np.asarray(uv_j)
    match_j = np.asarray(match_j)
    good = np.asarray(good, bool)
    for k in np.flatnonzero(good):
        p0 = (int(round(float(uv_i[k, 0]))), int(round(float(uv_i[k, 1]))))
        p1 = (int(round(float(uv_j[match_j[k], 0]))) + w,
              int(round(float(uv_j[match_j[k], 1]))))
        if cv2 is not None:
            cv2.line(canvas, p0, p1, line_color, 1)
    _dots(canvas, uv_i, good, pt_color, 2)
    uv_j_m = uv_j[np.clip(match_j, 0, len(uv_j) - 1)] + np.asarray([w, 0])
    _dots(canvas, uv_j_m, good, pt_color, 2)
    return canvas


def depth_colors(z, zmin: float = 0.5, zmax: float = 10.0) -> np.ndarray:
    """Per-point RGB: near=red -> far=blue, the drawFrame colour ramp
    (cv_draw.h:71-84: b=(z-min)*250/(max-min), r=255-b)."""
    z = np.clip(np.asarray(z, np.float64), zmin, zmax)
    b = np.floor((z - zmin) * (250.0 / max(zmax - zmin, 1e-6)))
    r = 255.0 - b
    return np.stack([r, np.zeros_like(b), b], axis=-1).astype(np.uint8)


def draw_frame(img, uv, z, mask, fps: float = 0.0, reproj_err: float = 0.0,
               zmin: float = 0.5, zmax: float = 10.0) -> np.ndarray:
    """The full per-frame debug overlay (drawFrame, cv_draw.h:57-92):
    grid + FPS + reprojection error + depth-coloured landmark dots."""
    img = draw_grid16(img)
    img = draw_fps(img, fps)
    img = draw_reproj_error(img, reproj_err)
    colors = depth_colors(z, zmin, zmax)
    return _dots(img, uv, mask, colors, 3)


def visualize_depth(d_img, depth_factor: float = 1000.0,
                    min_raw: float = 200.0, max_raw: float = 10000.0) -> np.ndarray:
    """Rainbow-colormapped depth image with invalid pixels painted white
    (visualizeDepthImg, cv_draw.h:95-122): raw Z16 values outside
    [min_raw, max_raw] (or NaN) are invalid."""
    d = np.asarray(d_img, np.float64)
    invalid = ~np.isfinite(d) | (d < min_raw) | (d > max_raw)
    d = np.where(invalid, 0.0, d)
    scaled = np.clip(d * (255.0 / max_raw), 0, 255).astype(np.uint8)
    if cv2 is not None:
        rgb = cv2.applyColorMap(scaled, cv2.COLORMAP_RAINBOW)[:, :, ::-1].copy()
    else:  # simple HSV-ish fallback ramp
        t = scaled.astype(np.float64) / 255.0
        rgb = np.stack([255 * t, 255 * (1 - np.abs(2 * t - 1)), 255 * (1 - t)],
                       axis=-1).astype(np.uint8)
    rgb[invalid] = 255
    return rgb


def save_png(path: str, img: np.ndarray) -> None:
    if cv2 is not None:
        cv2.imwrite(path, np.asarray(img)[:, :, ::-1])  # RGB -> BGR
    else:  # pragma: no cover
        raise RuntimeError("cv2 unavailable; cannot write PNG")
