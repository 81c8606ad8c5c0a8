"""The card's peaks and the kernels' bytes and operations, counted from the
algorithm's shapes whatever implements it.

Copied from chip_smoke.py at commit 1a1c6dc (PEAK_BYTES, PEAK_F32,
bound(), PYR_BYTES_PER_PX and check_grad_blur's byte count, check_schur's
byte and operation counts; rows 1 and 2 of PERF.md §6's kernel table).
Peaks: NVIDIA H100 SXM data sheet, dense, at 700 W.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12                    # HBM3 bytes/s
PEAK_F32 = 67e12                        # float32 operations/s outside the tensor cores

# grad_blur's own bytes per pixel of a level: 4 in, gx and gy out (8), and
# the quarter-size next image (1 B/px) on every level but the last.
PYR_BYTES_IN_OUT = 12.0
PYR_BYTES_NEXT = 1.0
PYR_IMAGES = 3                          # the previous left, left and right images


def bound_s(nbytes: float, ops: float, peak_ops: float = PEAK_F32) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over their peak, seconds."""
    return max(nbytes / PEAK_BYTES, ops / peak_ops)


def pyramid_levels(h: int, w: int, levels: int):
    """The level shapes of build_grad_pyramid: each level the even pixels
    of the one before ([::2, ::2], so ceil(h / 2))."""
    out = [(h, w)]
    for _ in range(levels - 1):
        h, w = (h + 1) // 2, (w + 1) // 2
        out.append((h, w))
    return out


def grad_blur_build_s(h: int, w: int, levels: int) -> float:
    """Bound of one frame's pyramid, `levels` grad_blur launches over the
    3 stacked images (bytes bound)."""
    nbytes = 0.0
    shapes = pyramid_levels(h, w, levels)
    for lvl, (hh, ww) in enumerate(shapes):
        per_px = PYR_BYTES_IN_OUT + (PYR_BYTES_NEXT if lvl + 1 < len(shapes) else 0.0)
        nbytes += per_px * PYR_IMAGES * hh * ww
    ops = 0.0
    for lvl, (hh, ww) in enumerate(shapes):
        # gx 8 and gy 11 flops a pixel; the 5x5 blur's 49 at the even pixels.
        ops += (19.0 + (49.0 / 4 if lvl + 1 < len(shapes) else 0.0)) * PYR_IMAGES * hh * ww
    return bound_s(nbytes, ops)


def schur_step_s(W: int, L: int, n_obs: float, pair_terms: float) -> float:
    """Bound of one LM step of the Schur solve over a W x L window: bytes
    every input once and dp, dl out; operations ~380 a live observation,
    324 a pair of poses observing one live landmark (its Schur complement
    term: sum over landmarks of views squared), and the 6W dense
    elimination."""
    inputs = 9 * W + 3 * W + 3 * L + 3 * W * L + W * L + W * L + W + 5 + 1
    nbytes = 4.0 * (inputs + 6 * W + 3 * L)
    ops = 380.0 * n_obs + 324.0 * pair_terms + (6 * W) ** 3 * 2 / 3
    return bound_s(nbytes, ops)
