// FAST-9 score + 3x3 keep-ties NMS + margin mask, and the 7-tap Gaussian
// blur, of one (H, W) float32 image — the Hopper counterpart of the TPU
// kernel flvis_tpu/ops/pallas/fastblur.py:fast_score_nms_blur_pallas.
//
// What bounds it: 12 B a pixel (one image in, two maps out) is 1.3 µs at
// 480x752, but the FAST ring test costs over a hundred instructions for
// each scored point, so the instruction stream is the floor to design for.
// The design cuts instructions a pixel and keeps the SMs evenly fed:
//   - A block of 128 threads owns TX = 126 output columns by TY = 11 rows.
//     Thread t owns image column X = x0 - 1 + t for the whole strip: its FAST
//     scores (t = 0 and 127 score the 1-px ring NMS needs) and, for t in
//     1..126, its blur and NMS outputs.  Both need the same 7 columns
//     X-3..X+3 of each image row, so the thread walks the TY + 8 staged rows
//     once, keeping the last 7 rows in registers (a fully unrolled sliding
//     window): each staged value is read from shared memory once per
//     thread, reused by the ring tests of 7 rows and the x-blur of its row;
//     the x-blurred rows slide through 7 more registers for the y pass.
//   - The ring test forms its masks from sign bits: with d = p - c and
//     m = thr - |d|, sign(m) (|d| > thr) and sign(d) shift into two masks
//     with one funnel shift each, bright = ext & ~neg and dark = ext & neg,
//     and the score term max(|d| - thr, 0) is max(-m, 0): 6 instructions a
//     circle point, exact against the plain version's compares (a zero d
//     never passes |d| > thr, so its sign does not count).  The arc-9 test
//     is a doubling chain on the duplicated mask (runs of 2, 4, 8, 9), ~10
//     instructions a mask.
//   - Staging: 16-byte loads where a row allows it, at clamped coordinates
//     (the edge-replicate border), every load issued before any store.
//   - 264 blocks at 480x752: two resident blocks on each of 132 SMs, so no
//     SM runs a third block while others idle (8-row tiles made 360 blocks,
//     three on most SMs and two on the rest).
//   - Two barriers, where the data needs them: after staging, and before
//     NMS reads its neighbours' scores.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TX = 126;             // output columns of a block
constexpr int NT = TX + 2;          // threads: one image column each
constexpr int TY = 11;              // output rows of a block
constexpr int SR = TY + 8;          // staged rows: y0-4 .. y0+TY+3
constexpr int SW = 136;             // staged columns (16-byte groups), >= TX + 10
constexpr int SG = SW / 4;
constexpr int EY = TY + 2;          // scored rows: y0-1 .. y0+TY

// Circle offsets, OpenCV order (ops/kernels/fastblur.CIRCLE):
// dx = 0 1 2 3 3 3 2 1 0 -1 -2 -3 -3 -3 -2 -1,
// dy = -3 -3 -2 -1 0 1 2 3 3 3 2 1 0 -1 -2 -3,
// as 4-bit fields of dx + 3 and dy + 3, point k in bits 4k..4k+3.
__host__ __device__ constexpr int circle_dx(int k) {
  return static_cast<int>((0x2100012345666543ull >> (4 * k)) & 15u) - 3;
}
__host__ __device__ constexpr int circle_dy(int k) {
  return static_cast<int>((0x0123456665432100ull >> (4 * k)) & 15u) - 3;
}

// Bits i (0..15) of the result: a run of >= 9 set bits of the circular
// 16-bit mask m starts at i.
__device__ __forceinline__ unsigned arc9_starts(unsigned m) {
  const unsigned d = __byte_perm(m, 0u, 0x1010);  // m | m << 16
  unsigned r = d & (d >> 1);                        // runs of 2
  r &= r >> 2;                                      // runs of 4
  r &= r >> 4;                                      // runs of 8
  return r & (d >> 8);                              // runs of 9
}

__global__ void __launch_bounds__(NT)
    fastblur_kernel(const float* __restrict__ img, float* __restrict__ score_out,
                    float* __restrict__ blur_out, int H, int W, int vec, float thr, int margin,
                    float w0, float w1, float w2, float w3) {
  __shared__ __align__(16) float s[SR][SW];
  __shared__ float e[EY][NT];
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int t = threadIdx.x;
  // Staged column 0 is global column xa, the 16-byte group at or below x0-4.
  const int xa = (x0 - 4) & ~3;
  const int off = x0 - 4 - xa;      // thread t's window starts at s[.][off + t]

  // --- Stage rows y0-4 .. y0+TY+3, columns xa .. xa+SW-1, clamped.
  {
    constexpr int N = SR * SG;
    constexpr int ITER = (N + NT - 1) / NT;
    float4 v[ITER];
#pragma unroll
    for (int k = 0; k < ITER; ++k) {
      const int i = t + k * NT;
      if (i < N) {
        const int r = i / SG, g = i - (i / SG) * SG;
        const int gy = min(max(y0 - 4 + r, 0), H - 1);
        const int gx = xa + 4 * g;
        const float* row = img + static_cast<size_t>(gy) * W;
        if (vec && gx >= 0 && gx + 3 < W) {
          v[k] = __ldg(reinterpret_cast<const float4*>(row + gx));
        } else {
          v[k].x = __ldg(row + min(max(gx, 0), W - 1));
          v[k].y = __ldg(row + min(max(gx + 1, 0), W - 1));
          v[k].z = __ldg(row + min(max(gx + 2, 0), W - 1));
          v[k].w = __ldg(row + min(max(gx + 3, 0), W - 1));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < ITER; ++k) {
      const int i = t + k * NT;
      if (i < N) {
        const int r = i / SG, g = i - (i / SG) * SG;
        *reinterpret_cast<float4*>(&s[r][4 * g]) = v[k];
      }
    }
  }
  __syncthreads();

  // --- Walk the staged rows: ring tests, x-blur, y-blur.
  const float wk[7] = {w3, w2, w1, w0, w1, w2, w3};
  const int X = x0 - 1 + t;
  const bool out_col = t >= 1 && t <= TX && X < W;
  float win[7][7];  // win[row % 7][dx + 3]: the last 7 staged rows
  float hb[7];      // x-blurred rows, by staged row % 7
#pragma unroll
  for (int i = 0; i < SR; ++i) {
#pragma unroll
    for (int c = 0; c < 7; ++c) win[i % 7][c] = s[i][off + t + c];
    if (i >= 1) {
      float acc = win[i % 7][0] * wk[0];
#pragma unroll
      for (int c = 1; c < 7; ++c) acc += win[i % 7][c] * wk[c];
      hb[i % 7] = acc;
    }
    if (i >= 6) {
      // Extended row er = i - 6 (image row y0 - 1 + er), centre staged row i - 3.
      const int cr = (i - 3) % 7;
      const float cv = win[cr][3];
      float sc = 0.0f;
      unsigned ext = 0u, neg = 0u;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float d = win[(i - 3 + circle_dy(k) + 7) % 7][3 + circle_dx(k)] - cv;
        const float m = thr - fabsf(d);  // < 0 iff |d| > thr
        sc += fmaxf(-m, 0.0f);           // max(|d| - thr, 0)
        ext = __funnelshift_l(__float_as_uint(m), ext, 1);
        neg = __funnelshift_l(__float_as_uint(d), neg, 1);
      }
      // bright: |d| > thr and d > 0; dark: |d| > thr and d < 0.
      const unsigned bright = ext & ~neg, dark = ext & neg;
      const bool corner = ((arc9_starts(bright) | arc9_starts(dark)) & 0xFFFFu) != 0u;
      e[i - 6][t] = corner ? sc : 0.0f;
    }
    if (i >= 7 && i <= TY + 6) {
      // Output row oy = i - 7: x-blurred staged rows i-6 .. i.
      float vb = hb[(i - 6) % 7] * wk[0];
#pragma unroll
      for (int k = 1; k < 7; ++k) vb += hb[(i - 6 + k) % 7] * wk[k];
      const int y = y0 + i - 7;
      if (out_col && y < H) blur_out[static_cast<size_t>(y) * W + X] = vb;
    }
  }
  __syncthreads();

  // --- NMS (keep ties) + margin mask, from the block's scores.
  if (!out_col) return;
  const bool col_ok = X >= margin && X < W - margin;
  float hm[EY];
#pragma unroll
  for (int r = 0; r < EY; ++r) hm[r] = fmaxf(fmaxf(e[r][t - 1], e[r][t]), e[r][t + 1]);
#pragma unroll
  for (int oy = 0; oy < TY; ++oy) {
    const int y = y0 + oy;
    if (y >= H) break;
    const float pooled = fmaxf(fmaxf(hm[oy], hm[oy + 1]), hm[oy + 2]);
    const float cen = e[oy + 1][t];
    const bool ok = col_ok && y >= margin && y < H - margin;
    score_out[static_cast<size_t>(y) * W + X] = (ok && cen >= pooled) ? cen : 0.0f;
  }
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
  // 16-byte loads need 16-byte aligned rows.
  const int vec = (W % 4 == 0) && (reinterpret_cast<uintptr_t>(img) % 16 == 0);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  fastblur_kernel<<<grid, NT, 0, stream>>>(img, score, blur, H, W, vec, threshold, margin,
                                           k[0], k[1], k[2], k[3]);
  return static_cast<int>(cudaGetLastError());
}
