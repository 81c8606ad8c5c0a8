// Per-point window gather at clamped corners — the Hopper counterpart of
// the TPU kernel flvis_tpu/ops/pallas/gather.py:gather_windows.
//
// out[n, c, i, j] = img[c, clamp(cy[n] + i - pad, 0, H - 1),
//                          clamp(cx[n] + j - pad, 0, W - 1)]
// for an (C, H, W) float32 image and (N,) int32 corners given in the
// coordinates of the image edge-padded by `pad` (already clamped to
// [0, dim + 2 pad - s] by the wrapper).  Reading the unpadded image at
// clamped addresses is the edge-replicate border, so no padded copy is
// ever written; the result is the padded-image slice bit for bit.
//
// A pure copy, bound by its bytes: each output element is written once and
// the window rows are read once (overlapping windows hit L2).  One warp per
// point, WARPS points per block: the warp walks the point's C*s rows and its
// lanes copy a row through registers, so reads run along an image row and
// writes along the contiguous output — both coalesced.  No shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

__global__ void gather_kernel(const float* __restrict__ img, const int* __restrict__ cx,
                              const int* __restrict__ cy, float* __restrict__ out, int n,
                              int C, int H, int W, int s, int pad) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = blockIdx.x * WARPS + warp;
  if (p >= n) return;
  const int x0 = cx[p] - pad, y0 = cy[p] - pad;
  const size_t plane = static_cast<size_t>(H) * W;
  float* dst = out + static_cast<size_t>(p) * C * s * s;
  for (int row = 0; row < C * s; ++row) {
    const int c = row / s, i = row % s;
    const int y = min(max(y0 + i, 0), H - 1);
    const float* src = img + c * plane + static_cast<size_t>(y) * W;
    for (int j = lane; j < s; j += 32) {
      const int x = min(max(x0 + j, 0), W - 1);
      dst[row * s + j] = src[x];
    }
  }
}

}  // namespace

extern "C" int flvis_gather_windows(const float* img, const int* cx, const int* cy, float* out,
                                    int n, int C, int H, int W, int s, int pad,
                                    cudaStream_t stream) {
  if (n <= 0 || C <= 0 || H <= 0 || W <= 0 || s <= 0 || pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + WARPS - 1) / WARPS);
  gather_kernel<<<grid, WARPS * 32, 0, stream>>>(img, cx, cy, out, n, C, H, W, s, pad);
  return static_cast<int>(cudaGetLastError());
}
