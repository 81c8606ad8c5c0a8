// Half-resolution plane-sweep stereo (SAD over 64 disparities, 9x9 box,
// argmin, parabolic subpixel, ambiguity margin) — the Hopper counterpart of
// the TPU kernel flvis_tpu/ops/pallas/sweep.py:sweep_maps_pallas.
//
// One block per TX x TY tile of the (Hh, Wh - 8) valid output.  The block
// stages its rows (+4 above and below, clamped: the edge padding) of L and
// of R, R over the columns every disparity reaches (R shifted right by d,
// clamped at column 0: the left edge padding).  For each d it forms the box
// cost of every pixel of the tile — the 9-tap sums factored as
// (a0 + a1 + a2) + (a3 + a4 + a5) + (a6 + a7 + a8), x first, then y, the
// plain version's add order — and keeps all 64 costs per pixel in shared
// memory, so the second-best search can run after the argmin without the
// cost volume ever reaching device memory.  Outputs are written at full
// width Wh with a 4-column invalid band on each side.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int D = 64;
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int NT = TX * TY;
constexpr int LY = TY + 8;          // staged rows
constexpr int LX = TX + 8;          // staged L columns
constexpr int RX = TX + 8 + D - 1;  // staged R columns

struct Smem {
  float cost[D][NT];
  float ls[LY][LX];
  float rs[LY][RX];
  float hs[LY][TX];
};

__device__ __forceinline__ float box9(const float* a) {
  const float t0 = (a[0] + a[1]) + a[2];
  const float t3 = (a[3] + a[4]) + a[5];
  const float t6 = (a[6] + a[7]) + a[8];
  return (t0 + t3) + t6;
}

__global__ void sweep_kernel(const float* __restrict__ L, const float* __restrict__ R,
                             float* __restrict__ disp, float* __restrict__ cbest,
                             uint8_t* __restrict__ ok, int Hh, int Wh) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int W2 = Wh - 8;
  const int x0 = blockIdx.x * TX;  // output column x2 (embedded at x2 + 4)
  const int y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;

  for (int i = tid; i < LY * LX; i += NT) {
    const int r = i / LX, c = i % LX;
    const int gy = min(max(y0 - 4 + r, 0), Hh - 1);
    const int gx = min(x0 + c, Wh - 1);
    sm.ls[r][c] = L[static_cast<size_t>(gy) * Wh + gx];
  }
  for (int i = tid; i < LY * RX; i += NT) {
    const int r = i / RX, c = i % RX;
    const int gy = min(max(y0 - 4 + r, 0), Hh - 1);
    const int gx = min(max(x0 - (D - 1) + c, 0), Wh - 1);
    sm.rs[r][c] = R[static_cast<size_t>(gy) * Wh + gx];
  }
  __syncthreads();

  const int tx = threadIdx.x, ty = threadIdx.y;
  float c_best = 0.0f;
  int best = 0;
  for (int d = 0; d < D; ++d) {
    // Horizontal 9-box of |L - R_d| on every staged row.
    for (int i = tid; i < LY * TX; i += NT) {
      const int r = i / TX, c = i % TX;
      float a[9];
#pragma unroll
      for (int k = 0; k < 9; ++k)
        a[k] = fabsf(sm.ls[r][c + k] - sm.rs[r][c + k + (D - 1) - d]);
      sm.hs[r][c] = box9(a);
    }
    __syncthreads();
    float a[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) a[k] = sm.hs[ty + k][tx];
    const float cst = box9(a);
    sm.cost[d][tid] = cst;
    if (d == 0 || cst < c_best) {  // first minimum wins
      c_best = cst;
      best = d;
    }
    __syncthreads();
  }

  const int x2 = x0 + tx, y = y0 + ty;
  if (blockIdx.x == 0 && tx < 8 && y < Hh) {  // the 4-column bands
    const int col = tx < 4 ? tx : Wh - 8 + tx;
    const size_t o = static_cast<size_t>(y) * Wh + col;
    disp[o] = 0.0f;
    cbest[o] = 0.0f;
    ok[o] = 0;
  }
  if (x2 >= W2 || y >= Hh) return;
  float cm = 0.0f, cp = 0.0f, c2 = 3.0e38f;
  for (int d = 0; d < D; ++d) {
    const float c = sm.cost[d][tid];
    if (d == best - 1) cm = c;
    if (d == best + 1) cp = c;
    if (abs(best - d) > 2 && c < c2) c2 = c;
  }
  const float denom = __fsub_rn(__fadd_rn(cm, cp), __fmul_rn(2.0f, c_best));
  float delta = denom > 1e-3f ? __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(cm, cp)), fmaxf(denom, 1e-3f))
                              : 0.0f;
  delta = fminf(fmaxf(delta, -0.5f), 0.5f);
  const size_t o = static_cast<size_t>(y) * Wh + x2 + 4;
  disp[o] = static_cast<float>(best) + delta;
  cbest[o] = c_best;
  ok[o] = (c2 > __fadd_rn(__fmul_rn(1.05f, c_best), 1e-3f) && best > 0 && best < D - 1) ? 1 : 0;
}

}  // namespace

extern "C" int flvis_sweep_maps(const float* L, const float* R, float* disp, float* cbest,
                                uint8_t* ok, int Hh, int Wh, cudaStream_t stream) {
  if (Hh <= 0 || Wh <= 8) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t e = cudaFuncSetAttribute(sweep_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 block(TX, TY);
  const dim3 grid((Wh - 8 + TX - 1) / TX, (Hh + TY - 1) / TY);
  sweep_kernel<<<grid, block, smem, stream>>>(L, R, disp, cbest, ok, Hh, Wh);
  return static_cast<int>(cudaGetLastError());
}
