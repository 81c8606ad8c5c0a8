// Half-resolution plane-sweep stereo (SAD over 64 disparities, 9x9 box,
// argmin, parabolic subpixel, ambiguity margin) — the Hopper counterpart of
// the TPU kernel flvis_tpu/ops/pallas/sweep.py:sweep_maps_pallas.
//
// What bounds it: ~40 float operations per pixel and disparity against
// 0.7 MB in and 1 MB out, so operations, not bytes; on the SM the limit is
// the shared-memory traffic that feeds those operations (32 words a clock
// against 128 float operations).  The design keeps that traffic near 8
// words per pixel and disparity and holds no cost volume anywhere:
//
// * One block of 128 threads per TX x TY = 32 x 8 tile of the (Hh, Wh - 8)
//   valid output; 360 blocks at 240 x 376, resident in one wave (43 KB of
//   shared memory a block).  The block stages its rows (+4 above and
//   below, clamped: the edge padding) of L and of R, R over the columns
//   every disparity reaches (R shifted right by d, clamped at column 0).
// * Disparities run in chunks of DC = 8 with one barrier a chunk (the
//   horizontal boxes are double-buffered).  Horizontal pass: a thread owns
//   one staged row, 8 output columns and DSUB = 4 disparities of the chunk;
//   it keeps its 16 L values in registers for the whole kernel and loads
//   19 R values a chunk, R sliding by one column per disparity, so each
//   |L - R| and each 3-tap sum is formed once and shared by the boxes
//   that need it.  Vertical pass: a thread owns one column and two output
//   rows, loads the 10 staged horizontal boxes of that column once a
//   disparity and forms each vertical 3-tap sum once for both rows.
// * Both passes add in the plain version's order — s_k = (a_k + a_k+1) +
//   a_k+2, box = (s_0 + s_3) + s_6, x first, then y — so every cost is
//   bit-equal to sweep_maps_plain's for any float input.
// * The per-pixel reduction runs online in registers over d: the first
//   strict minimum (best, c_best), the cost before it (cm), after it (cp),
//   the prefix minimum up to best - 3 (a 3-deep ring of running prefix
//   minima, read when best moves) and the minimum from best + 3 on (reset
//   when best moves).  Only minima and copies, so the maps equal the plain
//   version's bit for bit.  Outputs are written at full width Wh with a
//   4-column invalid band on each side.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int D = 64;
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int NT = 128;
constexpr int LY = TY + 8;          // staged rows
constexpr int DC = 8;               // disparities per barrier
constexpr int SEG = 8;              // output columns per horizontal thread
constexpr int DSUB = 4;             // disparities per horizontal thread and chunk
constexpr int LW = SEG + 8;         // L values a horizontal thread holds
constexpr int RW = LW + DSUB - 1;   // R values it loads a chunk
constexpr int LX = TX + 8 + 1;      // staged L columns, padded to an odd stride
constexpr int RX = TX + 8 + D - 1;  // staged R columns (103: odd stride)
constexpr int HX = TX + 1;          // horizontal-box row stride
constexpr float BIG = 3.0e38f;      // the plain version's "no candidate"

static_assert(LY * (TX / SEG) * (DC / DSUB) == NT, "one horizontal task per thread");
static_assert(TX * (TY / 2) == NT, "one column pair-row per thread");
static_assert(D % DC == 0, "whole chunks");

struct Smem {
  float hs[2][DC][LY][HX];
  float ls[LY][LX];
  float rs[LY][RX];
};

struct Best {                       // the online reduction of one pixel
  int best = 0;
  float cb = 0.0f, cm = 0.0f, cp = 0.0f, pre = BIG, post = BIG;
  float prev = 0.0f, p1 = BIG, p2 = BIG, p3 = BIG;

  __device__ __forceinline__ void add(float c, int d) {
    if (d == 0 || c < cb) {         // first strict minimum wins
      best = d;
      cb = c;
      cm = prev;
      cp = 0.0f;
      pre = p3;                     // min over 0 .. d - 3
      post = BIG;
    } else {
      if (d == best + 1) cp = c;
      if (d >= best + 3) post = fminf(post, c);
    }
    p3 = p2;
    p2 = p1;
    p1 = fminf(p1, c);
    prev = c;
  }
};

__device__ __forceinline__ void write_pixel(const Best& s, float* disp, float* cbest,
                                            uint8_t* ok, size_t o) {
  const float c2 = fminf(s.pre, s.post);
  const float denom = __fsub_rn(__fadd_rn(s.cm, s.cp), __fmul_rn(2.0f, s.cb));
  float delta = denom > 1e-3f
                    ? __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(s.cm, s.cp)), fmaxf(denom, 1e-3f))
                    : 0.0f;
  delta = fminf(fmaxf(delta, -0.5f), 0.5f);
  disp[o] = static_cast<float>(s.best) + delta;
  cbest[o] = s.cb;
  ok[o] = (c2 > __fadd_rn(__fmul_rn(1.05f, s.cb), 1e-3f) && s.best > 0 && s.best < D - 1) ? 1
                                                                                           : 0;
}

__global__ void __launch_bounds__(NT) sweep_kernel(const float* __restrict__ L,
                                                   const float* __restrict__ R,
                                                   float* __restrict__ disp,
                                                   float* __restrict__ cbest,
                                                   uint8_t* __restrict__ ok, int Hh, int Wh) {
  __shared__ Smem sm;
  const int W2 = Wh - 8;
  const int x0 = blockIdx.x * TX;  // output column x2 (embedded at x2 + 4)
  const int y0 = blockIdx.y * TY;
  const int tid = threadIdx.x;

  for (int i = tid; i < LY * (TX + 8); i += NT) {
    const int r = i / (TX + 8), c = i % (TX + 8);
    const int gy = min(max(y0 - 4 + r, 0), Hh - 1);
    sm.ls[r][c] = L[static_cast<size_t>(gy) * Wh + min(x0 + c, Wh - 1)];
  }
  for (int i = tid; i < LY * RX; i += NT) {
    const int r = i / RX, c = i % RX;
    const int gy = min(max(y0 - 4 + r, 0), Hh - 1);
    const int gx = min(max(x0 - (D - 1) + c, 0), Wh - 1);
    sm.rs[r][c] = R[static_cast<size_t>(gy) * Wh + gx];
  }
  __syncthreads();

  // Horizontal task: staged row hr, output columns c0 .. c0 + 7, the
  // disparities grp * DSUB .. + DSUB - 1 of each chunk.  A warp holds 8 rows
  // x 4 segments: with the odd strides its loads and stores hit 32 banks.
  const int hp = tid % (LY * (TX / SEG));
  const int hr = hp / (TX / SEG);
  const int c0 = (hp % (TX / SEG)) * SEG;
  const int grp = tid / (LY * (TX / SEG));
  float lw[LW];
#pragma unroll
  for (int j = 0; j < LW; ++j) lw[j] = sm.ls[hr][c0 + j];

  // Vertical task: output column vx, output rows 2 vp and 2 vp + 1.
  const int vx = tid % TX;
  const int vp = tid / TX;
  Best s0, s1;

  for (int ch = 0; ch < D / DC; ++ch) {
    const int buf = ch & 1;
    const int dg = ch * DC + grp * DSUB;
    // R column of L column c0 + j at disparity dg + e: base + j + DSUB - 1 - e.
    const int base = c0 + (D - 1) - dg - (DSUB - 1);
    float rw[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) rw[i] = sm.rs[hr][base + i];
#pragma unroll
    for (int e = 0; e < DSUB; ++e) {
      float a[LW];
#pragma unroll
      for (int j = 0; j < LW; ++j) a[j] = fabsf(lw[j] - rw[j + DSUB - 1 - e]);
      float t[LW - 2];
#pragma unroll
      for (int k = 0; k < LW - 2; ++k) t[k] = (a[k] + a[k + 1]) + a[k + 2];
      float* hrow = sm.hs[buf][grp * DSUB + e][hr];
#pragma unroll
      for (int m = 0; m < SEG; ++m) hrow[c0 + m] = (t[m] + t[m + 3]) + t[m + 6];
    }
    __syncthreads();  // double-buffered: the next chunk writes the other half

#pragma unroll
    for (int dd = 0; dd < DC; ++dd) {
      float h[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) h[k] = sm.hs[buf][dd][2 * vp + k][vx];
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = (h[k] + h[k + 1]) + h[k + 2];
      const int d = ch * DC + dd;
      s0.add((v[0] + v[3]) + v[6], d);
      s1.add((v[1] + v[4]) + v[7], d);
    }
  }

  if (blockIdx.x == 0 && tid < TY * 8) {  // the 4-column bands
    const int y = y0 + tid / 8, c = tid % 8;
    if (y < Hh) {
      const size_t o = static_cast<size_t>(y) * Wh + (c < 4 ? c : Wh - 8 + c);
      disp[o] = 0.0f;
      cbest[o] = 0.0f;
      ok[o] = 0;
    }
  }
  const int x2 = x0 + vx, y = y0 + 2 * vp;
  if (x2 >= W2) return;
  if (y < Hh) write_pixel(s0, disp, cbest, ok, static_cast<size_t>(y) * Wh + x2 + 4);
  if (y + 1 < Hh) write_pixel(s1, disp, cbest, ok, static_cast<size_t>(y + 1) * Wh + x2 + 4);
}

}  // namespace

extern "C" int flvis_sweep_maps(const float* L, const float* R, float* disp, float* cbest,
                                uint8_t* ok, int Hh, int Wh, cudaStream_t stream) {
  if (Hh <= 0 || Wh <= 8) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Wh - 8 + TX - 1) / TX, (Hh + TY - 1) / TY);
  sweep_kernel<<<grid, NT, 0, stream>>>(L, R, disp, cbest, ok, Hh, Wh);
  return static_cast<int>(cudaGetLastError());
}
