// One pyramid level of a (B, H, W) float32 stack: Scharr gx, gy and the
// 5-tap binomial pyrDown blur — the Hopper counterpart of the TPU kernel
// flvis_tpu/ops/pallas/gradpyr.py:grad_blur_pallas.
//
// Three output modes, a template parameter:
//   full — gx, gy and the blur at every pixel (the TPU kernel's contract);
//   next — gx, gy and the blur only at even rows and columns, written
//          straight into a contiguous (B, ceil(H/2), ceil(W/2)) tensor: the
//          next pyramid level, with no full-size blur and no strided copy;
//   none — gx, gy only (the last level).
// build_grad_pyramid runs next, next, ..., none: one launch per level.
//
// Bound by bytes on the H100: 4 B in and 8 B out per pixel, plus 1 B per
// pixel for the quarter-size next level (13 B/px; 16 B/px in full mode),
// against ~30 flops per pixel.  The design keeps every access off the
// critical path that the bytes do not need:
//   - Staging.  A block stages a 64 x 16 output tile plus a 2-pixel halo
//     (20 rows of 72 floats, 5.6 KB) in shared memory.  Interior tiles read
//     their rows with 16-byte loads (W % 4 == 0 and an aligned base) and
//     clamp nothing; only border tiles clamp, which is the edge-replicate
//     border, so no padded copy exists.  Each thread issues all its loads
//     (5 float4 + 2, or 30 scalars in a border tile) before it stores any:
//     one DRAM round trip per block.  No integer division anywhere.
//   - Filtering.  Each lane owns two adjacent columns of one 8-row strip.
//     It walks down the strip's 12 staged rows; per row, three 8-byte
//     shared loads give the six pixels c-2..c+3, from which it forms the
//     horizontal passes of both columns once (the x difference, the Scharr
//     smoothing, the blur's 5-tap x pass) and keeps a sliding window of
//     them in registers for the vertical passes: ~2 shared loads per output
//     pixel instead of ~30.  Two columns per lane make gx and gy one 8-byte
//     store each, and in next mode each lane writes whole next-level pixels
//     (the even column of each even row), a warp 128 contiguous bytes.
//   - Grid and occupancy.  64-thread blocks (2 warps, one strip each):
//     level 0 at (3, 480, 752) is 12 x 30 x 3 = 1,080 blocks, level 1 270,
//     level 2 72.  ptxas gives 55-56 registers a thread, 0 spills, 5,760 B
//     of shared memory, so registers allow 18 blocks (36 warps) an SM,
//     2,376 on the card: every level is one wave with no tail, each block's
//     loads in flight from its start.
//   Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md): the
//   pyramid at (3, 480, 752), 3 levels, 0.0099 ms a frame against its
//   0.0055 ms of bytes; level 0 runs near the memory rate, levels 1 and 2
//   are too small to fill it and take about a launch's fixed cost each.
//
// Taps and order follow ops/image._sep_filter as the reference runs it:
//   gx = smooth_y(diff_x(img)),  gy = diff_y(smooth_x(img)),
//   blur5 = k5_y(k5_x(img)),  smooth = [3, 10, 3]/32, diff = [-1, 0, 1],
//   k5 = [1, 4, 6, 4, 1]/16, each pass summed left to right.  Staging a
//   pre-clamped tile equals pad-x / filter-x / pad-y / filter-y because
//   edge-replicated rows x-filter into edge-replicated rows.  nvcc's FMA
//   contraction moves results by ~1e-5 on [0, 255] inputs.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int WARPS = 2;              // strips per block, one warp each
constexpr int RS = 8;                 // output rows per strip
constexpr int TX = 64;                // output columns per tile (two per lane)
constexpr int TY = WARPS * RS;        // output rows per tile
constexpr int SR = TY + 4;            // staged rows
constexpr int SC = TX + 8;            // staged row stride: tile at 4..67, halo 2..3, 68..69
constexpr int NT = WARPS * 32;

constexpr int kFull = 0, kNext = 1, kNone = 2;
static_assert(SR * 16 % NT == 0 && SR * 4 <= 2 * NT && SR % WARPS == 0 && TX + 4 <= 96,
              "the staging loops cover the tile exactly");

template <int MODE>
__global__ void __launch_bounds__(NT) grad_blur_kernel(const float* __restrict__ img,
                                                       float* __restrict__ gx,
                                                       float* __restrict__ gy,
                                                       float* __restrict__ out, int H, int W,
                                                       int vec) {
  __shared__ __align__(16) float s[SR][SC];
  const int lane = threadIdx.x, warp = threadIdx.y, tid = warp * 32 + lane;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* src = img + blockIdx.z * plane;

  // Every load of the staging is issued before the first store to shared
  // memory, so a block waits for one DRAM round trip, not one per row.
  if (vec && x0 >= 2 && x0 + TX + 2 <= W && y0 >= 2 && y0 + TY + 2 <= H) {
    // Interior tile: 16 aligned float4 per staged row (5 a thread), then the
    // 4 halo columns (80 scalars).
    const float* base = src + static_cast<size_t>(y0 - 2) * W + x0;
    float4 v[SR * 16 / NT];
    float h[2];
#pragma unroll
    for (int k = 0; k < SR * 16 / NT; ++k) {
      const int i = tid + k * NT;
      v[k] = __ldg(reinterpret_cast<const float4*>(base + static_cast<size_t>(i >> 4) * W) +
                   (i & 15));
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = tid + k * NT, r = i >> 2, e = i & 3;
      const int c = e < 2 ? e - 2 : TX + e - 2;          // -2, -1, 64, 65
      if (i < SR * 4) h[k] = __ldg(base + static_cast<size_t>(r) * W + c);
    }
#pragma unroll
    for (int k = 0; k < SR * 16 / NT; ++k) {
      const int i = tid + k * NT;
      *reinterpret_cast<float4*>(&s[i >> 4][4 + 4 * (i & 15)]) = v[k];
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = tid + k * NT, e = i & 3;
      if (i < SR * 4) s[i >> 2][(e < 2 ? e - 2 : TX + e - 2) + 4] = h[k];
    }
  } else {
    // Border tile (or an unaligned row pitch): clamped scalar loads, warp w
    // taking rows w, w + 2, ... and 3 columns a lane (the third for lanes < 4).
    float v[SR / WARPS][3];
#pragma unroll
    for (int m = 0; m < SR / WARPS; ++m) {
      const int y = min(max(y0 - 2 + warp + m * WARPS, 0), H - 1);
      const float* row = src + static_cast<size_t>(y) * W;
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        const int c = lane + 32 * n;
        if (c < TX + 4) v[m][n] = __ldg(row + min(max(x0 - 2 + c, 0), W - 1));
      }
    }
#pragma unroll
    for (int m = 0; m < SR / WARPS; ++m)
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        const int c = lane + 32 * n;
        if (c < TX + 4) s[warp + m * WARPS][c + 2] = v[m][n];
      }
  }
  __syncthreads();

  const float s0 = 3.0f / 32.0f, s1 = 10.0f / 32.0f;
  const float k0 = 1.0f / 16.0f, k1 = 4.0f / 16.0f, k2 = 6.0f / 16.0f;
  const int c = x0 + 2 * lane;                       // this lane's even column
  const bool pair = (W & 1) == 0;                    // (c, c+1) is one aligned float2
  const int Wn = (W + 1) >> 1, Hn = (H + 1) >> 1;
  const float* sp = &s[warp * RS][2 * lane + 2];     // staged columns c-2 .. c+3
  float dx0[RS + 4], dx1[RS + 4], sm0[RS + 4], sm1[RS + 4], bx0[RS + 4], bx1[RS + 4];
#pragma unroll
  for (int j = 0; j < RS + 4; ++j) {
    const float2 pa = *reinterpret_cast<const float2*>(sp + j * SC);
    const float2 pb = *reinterpret_cast<const float2*>(sp + j * SC + 2);
    const float2 pc = *reinterpret_cast<const float2*>(sp + j * SC + 4);
    // pa.x .. pc.y = pixels c-2 .. c+3 of staged row j.
    dx0[j] = pb.y - pa.y;
    dx1[j] = pc.x - pb.x;
    sm0[j] = pa.y * s0 + pb.x * s1 + pb.y * s0;
    sm1[j] = pb.x * s0 + pb.y * s1 + pc.x * s0;
    if (MODE != kNone) bx0[j] = pa.x * k0 + pa.y * k1 + pb.x * k2 + pb.y * k1 + pc.x * k0;
    if (MODE == kFull) bx1[j] = pa.y * k0 + pb.x * k1 + pb.y * k2 + pc.x * k1 + pc.y * k0;
    if (j < 4) continue;
    // Output row i = j - 4, centred on staged row j - 2.
    const int i = j - 4;
    const int y = y0 + warp * RS + i;
    if (y >= H) continue;
    const float gx0 = dx0[j - 3] * s0 + dx0[j - 2] * s1 + dx0[j - 1] * s0;
    const float gx1 = dx1[j - 3] * s0 + dx1[j - 2] * s1 + dx1[j - 1] * s0;
    const float gy0 = sm0[j - 1] - sm0[j - 3];
    const float gy1 = sm1[j - 1] - sm1[j - 3];
    const size_t o = blockIdx.z * plane + static_cast<size_t>(y) * W + c;
    if (pair && c + 1 < W) {
      *reinterpret_cast<float2*>(gx + o) = make_float2(gx0, gx1);
      *reinterpret_cast<float2*>(gy + o) = make_float2(gy0, gy1);
    } else {
      if (c < W) gx[o] = gx0, gy[o] = gy0;
      if (c + 1 < W) gx[o + 1] = gx1, gy[o + 1] = gy1;
    }
    if (MODE == kFull) {
      const float b0 = bx0[j - 4] * k0 + bx0[j - 3] * k1 + bx0[j - 2] * k2 + bx0[j - 1] * k1 +
                       bx0[j] * k0;
      const float b1 = bx1[j - 4] * k0 + bx1[j - 3] * k1 + bx1[j - 2] * k2 + bx1[j - 1] * k1 +
                       bx1[j] * k0;
      if (pair && c + 1 < W) {
        *reinterpret_cast<float2*>(out + o) = make_float2(b0, b1);
      } else {
        if (c < W) out[o] = b0;
        if (c + 1 < W) out[o + 1] = b1;
      }
    }
    if (MODE == kNext && (i & 1) == 0 && c < W) {    // y is even (y0, RS are even)
      out[blockIdx.z * static_cast<size_t>(Hn) * Wn + static_cast<size_t>(y >> 1) * Wn +
          (c >> 1)] = bx0[j - 4] * k0 + bx0[j - 3] * k1 + bx0[j - 2] * k2 + bx0[j - 1] * k1 +
                      bx0[j] * k0;
    }
  }
}

}  // namespace

// mode: 0 full (out is (B, H, W)), 1 next (out is (B, ceil(H/2), ceil(W/2))),
// 2 none (out unused).
extern "C" int flvis_grad_blur(const float* img, float* gx, float* gy, float* out, int mode,
                               int B, int H, int W, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || mode < 0 || mode > 2 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (W % 4 == 0) && (reinterpret_cast<uintptr_t>(img) % 16 == 0);
  const dim3 block(32, WARPS);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  if (mode == kFull)
    grad_blur_kernel<kFull><<<grid, block, 0, stream>>>(img, gx, gy, out, H, W, vec);
  else if (mode == kNext)
    grad_blur_kernel<kNext><<<grid, block, 0, stream>>>(img, gx, gy, out, H, W, vec);
  else
    grad_blur_kernel<kNone><<<grid, block, 0, stream>>>(img, gx, gy, out, H, W, vec);
  return static_cast<int>(cudaGetLastError());
}
