// FAST-9 score + 3x3 keep-ties NMS + margin mask, and the 7-tap Gaussian
// blur, of one (H, W) float32 image — the Hopper counterpart of the TPU
// kernel flvis_tpu/ops/pallas/fastblur.py:fast_score_nms_blur_pallas.
//
// One block per TX x TY output tile.  The block stages the tile plus a
// 4-pixel halo in shared memory, reading the global image at CLAMPED
// coordinates (the edge-replicate border).  From that one staged tile:
//   1. the raw FAST score on the tile+1 ring (the NMS neighbourhood),
//      into shared memory;
//   2. per output pixel: keep = score >= max of its 3x3 neighbourhood,
//      zeroed outside the margin box;
//   3. the separable blur: x pass into shared memory, then y pass, taps in
//      ops/image._sep_filter's order.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 16;
constexpr int HALO = 4;
constexpr int SX = TX + 2 * HALO;
constexpr int SY = TY + 2 * HALO;
constexpr int EX = TX + 2;  // extended (NMS) region
constexpr int EY = TY + 2;

// Circle offsets (dx, dy), OpenCV order.
__constant__ int kCircle[16][2] = {
    {0, -3}, {1, -3}, {2, -2}, {3, -1}, {3, 0}, {3, 1}, {2, 2}, {1, 3},
    {0, 3}, {-1, 3}, {-2, 2}, {-3, 1}, {-3, 0}, {-3, -1}, {-2, -2}, {-1, -3}};

// Any run of >= 9 consecutive set bits on the 16-step circle.
__device__ __forceinline__ bool arc9(unsigned m) {
  unsigned d = m | (m << 16);
  unsigned r = d;
#pragma unroll
  for (int k = 1; k < 9; ++k) r &= d >> k;
  return (r & 0xFFFFu) != 0u;
}

__global__ void fastblur_kernel(const float* __restrict__ img, float* __restrict__ score_out,
                                float* __restrict__ blur_out, int H, int W, float thr,
                                int margin, float w0, float w1, float w2, float w3) {
  __shared__ float s[SY][SX + 1];
  __shared__ float e[EY][EX + 1];
  __shared__ float bx[TY + 6][TX + 1];
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int nth = TX * TY;
  for (int i = tid; i < SY * SX; i += nth) {
    const int r = i / SX, c = i % SX;
    const int gy = min(max(y0 - HALO + r, 0), H - 1);
    const int gx = min(max(x0 - HALO + c, 0), W - 1);
    s[r][c] = img[static_cast<size_t>(gy) * W + gx];
  }
  __syncthreads();

  // 1. Raw FAST score on the extended region: e[er][ec] is pixel
  //    (y0 - 1 + er, x0 - 1 + ec), centred at s[er + 3][ec + 3].
  for (int i = tid; i < EY * EX; i += nth) {
    const int er = i / EX, ec = i % EX;
    const float cv = s[er + 3][ec + 3];
    float sc = 0.0f;
    unsigned bright = 0u, dark = 0u;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float d = s[er + 3 + kCircle[k][1]][ec + 3 + kCircle[k][0]] - cv;
      const float ad = fabsf(d);
      sc += ad > thr ? ad - thr : 0.0f;
      bright |= (d > thr ? 1u : 0u) << k;
      dark |= (d < -thr ? 1u : 0u) << k;
    }
    e[er][ec] = (arc9(bright) || arc9(dark)) ? sc : 0.0f;
  }
  // 3a. Blur x pass: bx[j][c] is the x-blurred row y0 - 3 + j, column x0 + c.
  const float wk[7] = {w3, w2, w1, w0, w1, w2, w3};
  for (int i = tid; i < (TY + 6) * TX; i += nth) {
    const int j = i / TX, c = i % TX;
    const float* row = s[j + 1];
    float acc = row[c + 1] * wk[0];
#pragma unroll
    for (int k = 1; k < 7; ++k) acc += row[c + 1 + k] * wk[k];
    bx[j][c] = acc;
  }
  __syncthreads();

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = x0 + tx, y = y0 + ty;
  if (x >= W || y >= H) return;
  // 2. NMS (keep ties) + margin mask.
  float pooled = e[ty][tx];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) pooled = fmaxf(pooled, e[ty + dy][tx + dx]);
  const float cen = e[ty + 1][tx + 1];
  const bool ok = y >= margin && y < H - margin && x >= margin && x < W - margin;
  // 3b. Blur y pass.
  float vb = bx[ty][tx] * wk[0];
#pragma unroll
  for (int k = 1; k < 7; ++k) vb += bx[ty + k][tx] * wk[k];
  const size_t o = static_cast<size_t>(y) * W + x;
  score_out[o] = (ok && cen >= pooled) ? cen : 0.0f;
  blur_out[o] = vb;
}

}  // namespace

extern "C" int flvis_fast_score_nms_blur(const float* img, float* score, float* blur, int H,
                                         int W, float threshold, int margin, float sigma,
                                         cudaStream_t stream) {
  if (H <= 0 || W <= 0 || margin < 4 || sigma <= 0.0f)
    return static_cast<int>(cudaErrorInvalidValue);
  // Normalised 7-tap Gaussian, as ops/image.gaussian_blur computes it.
  float k[4];
  float sum = 0.0f;
  for (int i = 0; i < 4; ++i) {
    k[i] = expf(-0.5f * (i / sigma) * (i / sigma));
    sum += (i == 0 ? 1.0f : 2.0f) * k[i];
  }
  for (int i = 0; i < 4; ++i) k[i] /= sum;
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  fastblur_kernel<<<grid, block, 0, stream>>>(img, score, blur, H, W, threshold, margin,
                                              k[0], k[1], k[2], k[3]);
  return static_cast<int>(cudaGetLastError());
}
