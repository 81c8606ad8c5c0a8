// Per-point window gathers at clamped corners — the Hopper counterpart of
// the TPU kernel flvis_tpu/ops/pallas/gather.py:gather_windows, in two
// modes over one to four (H, W) float32 planes (separate base pointers, so
// a channel stack is never copied together):
//
//   windows: out[n, c, i, j] = plane_c[clamp(y0 + i, 0, H - 1),
//                                      clamp(x0 + j, 0, W - 1)]
//     with x0 = clamp(cx[n], 0, W + 2 pad - s) - pad (likewise y0), the
//     corners int64 as the callers hold them (any element stride);
//   patches: the bilinear (S, S) patch, S = 2 r + 1, around the float
//     centre (x, y) = centers[n]: x is clamped to [-1, W], its floor x0 and
//     fraction fx; the (S + 1)^2 block starts at clamp(x0 - r + pad, 0,
//     W + 2 pad - S - 1) - pad, pad = r + 2 (likewise y), and
//     out = P00 (1-fx)(1-fy) + P01 fx (1-fy) + P10 (1-fx) fy + P11 fx fy,
//     each product and sum rounded on its own in that order (no FMA
//     contraction), so it equals ops/image's plain composition bit for bit.
//
// Reading the unpadded planes at clamped addresses is the edge-replicate
// border: no padded copy is ever written.  A copy bound by its bytes (the
// output written once, the covered pixels read once) and, at the path's
// sizes (0.2-1.5 MB), by launch latency: the grid runs over the outputs,
// kVec consecutive outputs per thread with one vector store, so
// neighbouring threads write neighbouring addresses and N = 256 points of
// a (3, 21, 21) patch still fill the card.  Each thread recomputes its
// point's corner from the raw corners or centre (no host work before the
// launch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;

struct Planes {
  const float* p[4];
};

struct Point {  // top-left pixel of the point's block (may lie off the image) and weights
  int x0, y0;
  float fx, fy;
};

template <bool kBlend>
__device__ inline Point point_at(int n, const int64_t* cx, int64_t sx, const int64_t* cy,
                                 int64_t sy, const float* cen, int64_t sc0, int64_t sc1, int H,
                                 int W, int s, int pad) {
  Point pt;
  if constexpr (kBlend) {
    float x = cen[n * sc0], y = cen[n * sc0 + sc1];
    x = x != x ? x : fminf(fmaxf(x, -1.0f), static_cast<float>(W));  // NaN stays NaN
    y = y != y ? y : fminf(fmaxf(y, -1.0f), static_cast<float>(H));
    const float xf = floorf(x), yf = floorf(y);
    pt.fx = __fsub_rn(x, xf);
    pt.fy = __fsub_rn(y, yf);
    const int r = (s - 1) / 2, size = s + 1;
    const long long bx = (xf == xf ? static_cast<long long>(xf) : 0) - r + pad;
    const long long by = (yf == yf ? static_cast<long long>(yf) : 0) - r + pad;
    pt.x0 = static_cast<int>(min(max(bx, 0ll), static_cast<long long>(W + 2 * pad - size))) - pad;
    pt.y0 = static_cast<int>(min(max(by, 0ll), static_cast<long long>(H + 2 * pad - size))) - pad;
  } else {
    const long long bx = cx[n * sx], by = cy[n * sy];
    pt.x0 = static_cast<int>(min(max(bx, 0ll), static_cast<long long>(W + 2 * pad - s))) - pad;
    pt.y0 = static_cast<int>(min(max(by, 0ll), static_cast<long long>(H + 2 * pad - s))) - pad;
    pt.fx = pt.fy = 0.f;
  }
  return pt;
}

template <bool kBlend>
__device__ inline float value_at(const float* plane, const Point& pt, int i, int j, int H, int W) {
  const int y = min(max(pt.y0 + i, 0), H - 1), x = min(max(pt.x0 + j, 0), W - 1);
  if constexpr (!kBlend) {
    return plane[static_cast<size_t>(y) * W + x];
  } else {
    const int y1 = min(max(pt.y0 + i + 1, 0), H - 1), x1 = min(max(pt.x0 + j + 1, 0), W - 1);
    const float p00 = plane[static_cast<size_t>(y) * W + x];
    const float p01 = plane[static_cast<size_t>(y) * W + x1];
    const float p10 = plane[static_cast<size_t>(y1) * W + x];
    const float p11 = plane[static_cast<size_t>(y1) * W + x1];
    const float gx = __fsub_rn(1.0f, pt.fx), gy = __fsub_rn(1.0f, pt.fy);
    float acc = __fmul_rn(__fmul_rn(p00, gx), gy);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(p01, pt.fx), gy));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(p10, gx), pt.fy));
    return __fadd_rn(acc, __fmul_rn(__fmul_rn(p11, pt.fx), pt.fy));
  }
}

// s is the output side: the window side, or the patch side S.
template <bool kBlend>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(Planes planes, const int64_t* __restrict__ cx, int64_t sx,
                  const int64_t* __restrict__ cy, int64_t sy, const float* __restrict__ cen,
                  int64_t sc0, int64_t sc1, float* __restrict__ out, int n, int C, int H, int W,
                  int s, int pad) {
  const long long per_point = static_cast<long long>(C) * s * s;
  const long long total = per_point * n;
  const long long o0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (o0 >= total) return;
  // Decompose the first output, then step through the next kVec - 1.
  int p = static_cast<int>(o0 / per_point);
  int rem = static_cast<int>(o0 - p * per_point);
  int c = rem / (s * s);
  rem -= c * s * s;
  int i = rem / s, j = rem - i * s;
  Point pt = point_at<kBlend>(p, cx, sx, cy, sy, cen, sc0, sc1, H, W, s, pad);
  float v[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (o0 + k < total) v[k] = value_at<kBlend>(planes.p[c], pt, i, j, H, W);
    if (++j == s) {
      j = 0;
      if (++i == s) {
        i = 0;
        if (++c == C) {
          c = 0;
          if (++p < n) pt = point_at<kBlend>(p, cx, sx, cy, sy, cen, sc0, sc1, H, W, s, pad);
        }
      }
    }
  }
  if (o0 + kVec <= total) {
    *reinterpret_cast<float4*>(out + o0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int k = 0; o0 + k < total; ++k) out[o0 + k] = v[k];
  }
}

int launch(bool blend, const float* p0, const float* p1, const float* p2, const float* p3, int C,
           int H, int W, const int64_t* cx, int64_t sx, const int64_t* cy, int64_t sy,
           const float* cen, int64_t sc0, int64_t sc1, float* out, int n, int s, int pad,
           cudaStream_t stream) {
  if (n <= 0 || C <= 0 || C > 4 || H <= 0 || W <= 0 || s <= 0 || pad < 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Planes planes{{p0, p1, p2, p3}};
  const long long total = static_cast<long long>(n) * C * s * s;
  const long long threads = (total + kVec - 1) / kVec;
  const unsigned grid = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (blend)
    gather_kernel<true><<<grid, kThreads, 0, stream>>>(planes, cx, sx, cy, sy, cen, sc0, sc1, out,
                                                       n, C, H, W, s, pad);
  else
    gather_kernel<false><<<grid, kThreads, 0, stream>>>(planes, cx, sx, cy, sy, cen, sc0, sc1,
                                                        out, n, C, H, W, s, pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Windows mode: (n, C, s, s) from int64 corners cx, cy (element strides sx, sy).
extern "C" int flvis_gather_windows(const float* p0, const float* p1, const float* p2,
                                    const float* p3, int C, int H, int W, const int64_t* cx,
                                    int64_t sx, const int64_t* cy, int64_t sy, float* out, int n,
                                    int s, int pad, cudaStream_t stream) {
  return launch(false, p0, p1, p2, p3, C, H, W, cx, sx, cy, sy, nullptr, 0, 0, out, n, s, pad,
                stream);
}

// Patches mode: (n, C, S, S) bilinear patches, S = 2 radius + 1, around float
// centres (element strides sc0 between points, sc1 from x to y).
extern "C" int flvis_gather_patches(const float* p0, const float* p1, const float* p2,
                                    const float* p3, int C, int H, int W, const float* cen,
                                    int64_t sc0, int64_t sc1, float* out, int n, int radius,
                                    cudaStream_t stream) {
  return launch(true, p0, p1, p2, p3, C, H, W, nullptr, 0, nullptr, 0, cen, sc0, sc1, out, n,
                2 * radius + 1, radius + 2, stream);
}
