// One damped Schur-complement Levenberg-Marquardt step of the sliding-window
// BA — the Hopper counterpart of the TPU kernel
// flvis_tpu/ops/pallas/schur.py:schur_step_kernel, computing the XLA body
// of window_ba._schur_step (window_ba.py:373-431) in two launches on one
// stream:
//   (1) schur_reduce_solve — one block per tile of kTile landmarks, one
//       thread per (pose, landmark) pair of the tile: stereo residuals,
//       Huber weights, pose and landmark Jacobians; Hll / bl summed over
//       the poses in shared memory, the damped closed-form 3x3 inverse,
//       A = Hpl Hll^-1; then the tile's share of the reduced system (upper
//       block triangle of Hpp - A Hpl^T, the right side bp - A bl and the
//       Hpp diagonal for the damping) in shared memory.  Clusters of
//       kCluster blocks sum their tiles through distributed shared memory
//       in rank order and write one partial per cluster; the last block to
//       finish (an integer ticket) sums the cluster partials in cluster
//       order in double precision, adds the damping and the gauge identity
//       on fixed poses, and solves the 6W system by 6x6 block elimination
//       in double precision in shared memory (closed-form 6x6 block
//       inverses, as flvis_tpu/ops/linalg.py:block_spd_solve; a block whose
//       inverse does not exist — a non-positive or non-finite determinant —
//       is left out: its poses get dp = 0);
//   (2) schur_backsub — the same tiles recompute their Jacobians, Hll and
//       bl (the same code, so the same values) and write
//       dl = Hll^-1 (bl - Hpl^T dp).
// Every sum runs in a fixed order and no float atomics are used, so the
// results repeat bit for bit.  The ticket counter is the caller's: one
// zeroed int per stream, which the last block resets to 0, so calls on one
// stream follow each other and calls on two streams never share a counter.
//
// Inputs (float32, contiguous): R (W,9) row-major, t (W,3), pw (3,L),
// obs3 (3W,L), urv (W,L), wm (W,L), fixed (W,), cam (5,) [fx,fy,cx,cy,fx*b],
// lam (1,); delta by value; ticket (1,) uint32, 0 on entry and on exit.
// Outputs dp (W,6), dl (3,L).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxW = 16;
constexpr int kTile = 16;                 // landmarks per block
constexpr int kThreads = kMaxW * kTile;   // one thread per (pose, landmark) pair
constexpr int kCluster = 8;               // blocks per cluster
constexpr int kPose = 33;                 // per-pose tile sums: Hpp (21), bp (6), A bl (6)

struct Inputs {
  const float *R, *t, *pw, *obs3, *urv, *wm, *fixed, *cam, *lam;
  float delta;
  int W, L;
};

__host__ __device__ inline int sym6(int k, int m) {  // upper-triangle index, k <= m
  return k * 6 - k * (k - 1) / 2 + (m - k);
}

__host__ __device__ inline int num_pairs(int W) { return W * (W + 1) / 2; }

// Floats of one tile's (and one cluster's) partial: the upper block
// triangle's 6x6 blocks, the right side and the Hpp diagonal.
__host__ __device__ inline int partial_floats(int W) { return 36 * num_pairs(W) + 12 * W; }

__device__ inline void load_poses(const Inputs& in, float* sR, float* sT) {
  for (int i = threadIdx.x; i < in.W * 9; i += blockDim.x) sR[i] = in.R[i];
  for (int i = threadIdx.x; i < in.W * 3; i += blockDim.x) sT[i] = in.t[i];
}

// One observation (pose w, landmark l): hpl = (wgt Jp)^T Jl (6x3), hll the
// upper triangle of Jl^T wgt Jl and -Jl^T wgt r (6 + 3), and with kWithPose
// the upper triangle of (wgt Jp)^T Jp (21) and -Jp^T wgt r (6).  Zero where
// the pair is not live.
template <bool kWithPose>
__device__ inline void observe(const Inputs& in, const float* sR, const float* sT, bool fixw_on,
                               int w, int l, bool live, float* hpl, float* hll, float* hpp,
                               float* bp) {
  if (!live) {
#pragma unroll
    for (int i = 0; i < 18; ++i) hpl[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) hll[i] = 0.f;
    if constexpr (kWithPose) {
#pragma unroll
      for (int i = 0; i < 21; ++i) hpp[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) bp[i] = 0.f;
    }
    return;
  }
  const int L = in.L;
  const float fx = in.cam[0], fy = in.cam[1], cx = in.cam[2], cy = in.cam[3], fxb = in.cam[4];
  const float px = in.pw[l], py = in.pw[L + l], pz = in.pw[2 * L + l];
  const float* Rw = sR + 9 * w;
  const float x = Rw[0] * px + Rw[1] * py + Rw[2] * pz + sT[3 * w + 0];
  const float y = Rw[3] * px + Rw[4] * py + Rw[5] * pz + sT[3 * w + 1];
  const float zr = Rw[6] * px + Rw[7] * py + Rw[8] * pz + sT[3 * w + 2];
  const float z = fabsf(zr) < 1e-6f ? 1e-6f : zr;
  const float iz = 1.0f / z;
  const float iz2 = iz * iz;
  const size_t wl = static_cast<size_t>(w) * L + l;
  const float um = in.urv[wl];
  const float u = fx * x / z + cx;
  const float v = fy * y / z + cy;
  float r[3];
  r[0] = u - in.obs3[(3 * static_cast<size_t>(w)) * L + l];
  r[1] = v - in.obs3[(3 * static_cast<size_t>(w) + 1) * L + l];
  r[2] = um > 0.5f ? (u - fxb / z) - in.obs3[(3 * static_cast<size_t>(w) + 2) * L + l] : 0.f;
  const float rn = sqrtf(fmaxf(r[0] * r[0] + r[1] * r[1] + r[2] * r[2], 1e-12f));
  const float hub = rn <= in.delta ? 1.0f : in.delta / rn;
  const float wgt = in.wm[wl] > 0.5f ? hub : 0.0f;
  const float fixw = fixw_on ? 0.0f : 1.0f;

  const float duv[3][3] = {{fx * iz, 0.f, -fx * x * iz2},
                           {0.f, fy * iz, -fy * y * iz2},
                           {fx * iz * um, 0.f, (-fx * x * iz2 + fxb * iz2) * um}};
  float Jp[3][6], Jl[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float dx = duv[a][0], dy = duv[a][1], dz = duv[a][2];
    Jp[a][0] = dx * fixw;
    Jp[a][1] = dy * fixw;
    Jp[a][2] = dz * fixw;
    Jp[a][3] = (dy * -zr + dz * y) * fixw;
    Jp[a][4] = (dx * zr + dz * -x) * fixw;
    Jp[a][5] = (dx * -y + dy * x) * fixw;
#pragma unroll
    for (int b = 0; b < 3; ++b) Jl[a][b] = dx * Rw[b] + dy * Rw[3 + b] + dz * Rw[6 + b];
  }
  float wJl[3][3], wr[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    wr[a] = wgt * r[a];
#pragma unroll
    for (int b = 0; b < 3; ++b) wJl[a][b] = wgt * Jl[a][b];
  }
  int q = 0;
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int c = b; c < 3; ++c)
      hll[q++] = Jl[0][b] * wJl[0][c] + Jl[1][b] * wJl[1][c] + Jl[2][b] * wJl[2][c];
#pragma unroll
  for (int b = 0; b < 3; ++b) hll[6 + b] = -(Jl[0][b] * wr[0] + Jl[1][b] * wr[1] + Jl[2][b] * wr[2]);

  // Weights multiply a Jacobian factor FIRST (as the plain version's
  // Jp * wgt does): an unobserved entry behind the camera can carry a huge
  // Jacobian, and wgt = 0 must zero it before any product of two.
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float wj0 = wgt * Jp[0][k], wj1 = wgt * Jp[1][k], wj2 = wgt * Jp[2][k];
#pragma unroll
    for (int b = 0; b < 3; ++b) hpl[k * 3 + b] = wj0 * Jl[0][b] + wj1 * Jl[1][b] + wj2 * Jl[2][b];
    if constexpr (kWithPose) {
#pragma unroll
      for (int m = k; m < 6; ++m)
        hpp[sym6(k, m)] = wj0 * Jp[0][m] + wj1 * Jp[1][m] + wj2 * Jp[2][m];
      bp[k] = -(Jp[0][k] * wr[0] + Jp[1][k] * wr[1] + Jp[2][k] * wr[2]);
    }
  }
}

// Landmark j of the tile: Hll and bl summed over the W poses in pose order,
// then the damped closed-form inverse of the symmetric 3x3 block.
__device__ inline void landmark_inverse(const float* hll_s, int j, int W, float lam, float* hinv,
                                        float* bl) {
  float h[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) h[i] = 0.f;
  for (int w = 0; w < W; ++w)
#pragma unroll
    for (int i = 0; i < 9; ++i) h[i] += hll_s[(w * kTile + j) * 9 + i];
  const float damp = lam * fmaxf((h[0] + h[3] + h[5]) / 3.0f, 1e-6f) + 1e-8f;
  const float a = h[0] + damp, b = h[1], c = h[2], d = h[3] + damp, e = h[4], f = h[5] + damp;
  const float A00 = d * f - e * e, A01 = c * e - b * f, A02 = b * e - c * d;
  const float A11 = a * f - c * c, A12 = b * c - a * e, A22 = a * d - b * b;
  const float det = a * A00 + b * A01 + c * A02;
  const float idet = fabsf(det) > 1e-20f ? 1.0f / det : 0.0f;
  hinv[0] = A00 * idet;  // [00, 01, 02, 11, 12, 22]
  hinv[1] = A01 * idet;
  hinv[2] = A02 * idet;
  hinv[3] = A11 * idet;
  hinv[4] = A12 * idet;
  hinv[5] = A22 * idet;
  bl[0] = h[6];
  bl[1] = h[7];
  bl[2] = h[8];
}

__device__ inline float hinv_at(const float* hi, int r, int c) {
  const int idx[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
  return hi[idx[r][c]];
}

// Sum v over the 16 lanes of a half-warp (butterfly: fixed order).
__device__ inline float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Closed-form inverse of a symmetric 3x3 (row-major m), false if its
// determinant is not positive and finite.
__device__ inline bool sym3_inv_d(const double* m, double* out) {
  const double a = m[0], b = m[1], c = m[2], d = m[4], e = m[5], f = m[8];
  const double A00 = d * f - e * e, A01 = c * e - b * f, A02 = b * e - c * d;
  const double A11 = a * f - c * c, A12 = b * c - a * e, A22 = a * d - b * b;
  const double det = a * A00 + b * A01 + c * A02;
  if (!(det > 0.0) || !isfinite(det)) return false;
  const double id = 1.0 / det;
  out[0] = A00 * id; out[1] = A01 * id; out[2] = A02 * id;
  out[3] = A01 * id; out[4] = A11 * id; out[5] = A12 * id;
  out[6] = A02 * id; out[7] = A12 * id; out[8] = A22 * id;
  return true;
}

// Inverse of a symmetric positive-definite 6x6 block (rows of stride ld)
// by the 2x2-of-3x3 Schur complement (flvis_tpu/ops/linalg.py:spd6_inv);
// all zero where it does not exist.
__device__ void spd6_inv_d(const double* M, int ld, double* out) {
  double A[9], B[9], D[9], Ai[9], AiB[9], Sc[9], Si[9];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      A[r * 3 + c] = M[r * ld + c];
      B[r * 3 + c] = M[r * ld + 3 + c];
      D[r * 3 + c] = M[(3 + r) * ld + 3 + c];
    }
  bool ok = sym3_inv_d(A, Ai);
  if (ok) {
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        AiB[r * 3 + c] = Ai[r * 3] * B[c] + Ai[r * 3 + 1] * B[3 + c] + Ai[r * 3 + 2] * B[6 + c];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        Sc[r * 3 + c] = D[r * 3 + c] - (B[r] * AiB[c] + B[3 + r] * AiB[3 + c] +
                                        B[6 + r] * AiB[6 + c]);
    for (int r = 0; r < 3; ++r)
      for (int c = r + 1; c < 3; ++c) {
        const double s = 0.5 * (Sc[r * 3 + c] + Sc[c * 3 + r]);
        Sc[r * 3 + c] = s;
        Sc[c * 3 + r] = s;
      }
    ok = sym3_inv_d(Sc, Si);
  }
  if (!ok) {
    for (int i = 0; i < 36; ++i) out[i] = 0.0;
    return;
  }
  double TR[9];  // -AiB Si
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      TR[r * 3 + c] = -(AiB[r * 3] * Si[c] + AiB[r * 3 + 1] * Si[3 + c] + AiB[r * 3 + 2] * Si[6 + c]);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      // TL = Ai + AiB Si AiB^T = Ai - TR AiB^T
      const double tl = Ai[r * 3 + c] - (TR[r * 3] * AiB[c * 3] + TR[r * 3 + 1] * AiB[c * 3 + 1] +
                                         TR[r * 3 + 2] * AiB[c * 3 + 2]);
      out[r * 6 + c] = tl;
      out[r * 6 + 3 + c] = TR[r * 3 + c];
      out[(3 + c) * 6 + r] = TR[r * 3 + c];
      out[(3 + r) * 6 + 3 + c] = Si[r * 3 + c];
    }
}

// Rows r and r + 1 of the trailing update of block step j: their
// multipliers L = S[r][6j..6j+5] Dinv_j (every lane alike, in registers),
// then S[r][col] -= L S[6j..6j+5][col] for the columns col >= c0 and the
// right side (column N); lanes along the columns, four independent chains
// of three products per lane.
__device__ inline void trail_rows2(double* S, double* rb, const double* Dj, int N, int j, int c0,
                                   int r, int lane) {
  double l0[6], l1[6];
#pragma unroll
  for (int b = 0; b < 6; ++b) l0[b] = l1[b] = 0.0;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const double s0 = S[r * N + 6 * j + c], s1 = S[(r + 1) * N + 6 * j + c];
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      l0[b] += s0 * Dj[c * 6 + b];
      l1[b] += s1 * Dj[c * 6 + b];
    }
  }
  for (int col = c0 + lane; col <= N; col += 32) {
    double v[6];
#pragma unroll
    for (int b = 0; b < 6; ++b) v[b] = col < N ? S[(6 * j + b) * N + col] : rb[6 * j + b];
    const double s0 = (l0[0] * v[0] + l0[1] * v[1] + l0[2] * v[2]) +
                      (l0[3] * v[3] + l0[4] * v[4] + l0[5] * v[5]);
    const double s1 = (l1[0] * v[0] + l1[1] * v[1] + l1[2] * v[2]) +
                      (l1[3] * v[3] + l1[4] * v[4] + l1[5] * v[5]);
    double* t0 = col < N ? S + r * N + col : rb + r;
    double* t1 = col < N ? S + (r + 1) * N + col : rb + r + 1;
    *t0 -= s0;
    *t1 -= s1;
  }
}

// Solve S x = rb (N = 6W, S row-major in shared memory, both overwritten)
// by block Gaussian elimination over 6x6 blocks without pivoting — the
// damped, gauge-fixed reduced system is symmetric positive definite.  One
// block-wide barrier per block column: warp 0 updates the next block row
// first and inverts its diagonal block while the other warps update the
// rows below it.  Then a block back substitution; x lands in `x`.
__device__ void block_solve(double* S, double* rb, double* Dinv, double* x, int W) {
  const int N = 6 * W, tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const int warps = blockDim.x / 32;
  if (tid == 0) spd6_inv_d(S, N, Dinv);
  __syncthreads();
  for (int j = 0; j + 1 < W; ++j) {
    const int c0 = 6 * (j + 1);
    const double* Dj = Dinv + 36 * j;
    if (warp == 0) {
      for (int r = c0; r < c0 + 6; r += 2) trail_rows2(S, rb, Dj, N, j, c0, r, lane);
      __syncwarp();
      if (lane == 0) spd6_inv_d(S + c0 * N + c0, N, Dinv + 36 * (j + 1));
    } else {
      for (int r = c0 + 6 + 2 * (warp - 1); r < N; r += 2 * (warps - 1))
        trail_rows2(S, rb, Dj, N, j, c0, r, lane);
    }
    __syncthreads();
  }
  // Back substitution, block by block from the last: x_i = Dinv_i rb_i,
  // then rb_r -= S_ri x_i for the rows above.
  for (int i = W - 1; i >= 0; --i) {
    if (tid < 6) {
      double xi = 0.0;
#pragma unroll
      for (int b = 0; b < 6; ++b) xi += Dinv[36 * i + tid * 6 + b] * rb[6 * i + b];
      x[6 * i + tid] = xi;
    }
    __syncthreads();
    for (int r = tid; r < 6 * i; r += blockDim.x) {
      double s = 0.0;
#pragma unroll
      for (int b = 0; b < 6; ++b) s += S[r * N + 6 * i + b] * x[6 * i + b];
      rb[r] -= s;
    }
    __syncthreads();
  }
}

__host__ __device__ inline size_t tile_smem_floats(int W) {
  return static_cast<size_t>(W) * kTile * (18 + 18 + 9) + kTile * 9 + W * kPose +
         partial_floats(W);
}

__host__ __device__ inline size_t solve_smem_doubles(int W) {
  const int N = 6 * W;
  return static_cast<size_t>(N) * N + 36 * W + 2 * N + partial_floats(W);
}

__host__ inline size_t reduce_solve_smem_bytes(int W) {
  const size_t a = tile_smem_floats(W) * sizeof(float), b = solve_smem_doubles(W) * sizeof(double);
  return a > b ? a : b;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    schur_reduce_solve(Inputs in, float* __restrict__ part, unsigned int* __restrict__ ticket,
                       float* __restrict__ dp) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sR[kMaxW * 9], sT[kMaxW * 3], sFix[kMaxW];
  __shared__ int s_last;
  const int W = in.W, L = in.L, tid = threadIdx.x, P = num_pairs(W), E = partial_floats(W);
  const float lam = in.lam[0];
  float* hpl_s = reinterpret_cast<float*>(smem);        // [W][kTile][18]
  float* a_s = hpl_s + W * kTile * 18;                  // [W][kTile][18]
  float* hll_s = a_s + W * kTile * 18;                  // [W][kTile][9]
  float* hinv_s = hll_s + W * kTile * 9;                // [kTile][6]
  float* bl_s = hinv_s + kTile * 6;                     // [kTile][3]
  float* pose_s = bl_s + kTile * 3;                     // [W][kPose]
  float* tile_s = pose_s + W * kPose;                   // [E]
  load_poses(in, sR, sT);
  for (int i = tid; i < W; i += blockDim.x) sFix[i] = in.fixed[i];
  __syncthreads();

  // (a) one thread per (pose w, landmark j) pair of the tile.
  const int w = tid / kTile, j = tid % kTile;
  const int l = blockIdx.x * kTile + j;
  const bool live = w < W && l < L;
  {
    float hpl[18], hll[9], hpp[21], bp[6];
    observe<true>(in, sR, sT, live && sFix[w] > 0.5f, w, l, live, hpl, hll, hpp, bp);
    if (w < W) {
#pragma unroll
      for (int i = 0; i < 18; ++i) hpl_s[(w * kTile + j) * 18 + i] = hpl[i];
#pragma unroll
      for (int i = 0; i < 9; ++i) hll_s[(w * kTile + j) * 9 + i] = hll[i];
    }
    // Hpp and bp summed over the tile's landmarks: the half-warp of pose w.
#pragma unroll
    for (int i = 0; i < 21; ++i) {
      const float s = half_warp_sum(hpp[i]);
      if (j == 0 && w < W) pose_s[w * kPose + i] = s;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float s = half_warp_sum(bp[i]);
      if (j == 0 && w < W) pose_s[w * kPose + 21 + i] = s;
    }
  }
  __syncthreads();
  if (tid < kTile) landmark_inverse(hll_s, tid, W, lam, hinv_s + 6 * tid, bl_s + 3 * tid);
  __syncthreads();

  // (b) A = Hpl Hll^-1 per pair, and A bl summed over the tile.
  {
    float A[18], abl[6];
    const float* h = hpl_s + (w < W ? (w * kTile + j) * 18 : 0);
    const float* hi = hinv_s + 6 * j;
    const float* b = bl_s + 3 * j;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
#pragma unroll
      for (int n = 0; n < 3; ++n)
        A[k * 3 + n] = h[k * 3] * hinv_at(hi, 0, n) + h[k * 3 + 1] * hinv_at(hi, 1, n) +
                       h[k * 3 + 2] * hinv_at(hi, 2, n);
      abl[k] = live ? A[k * 3] * b[0] + A[k * 3 + 1] * b[1] + A[k * 3 + 2] * b[2] : 0.f;
    }
    if (w < W) {
#pragma unroll
      for (int i = 0; i < 18; ++i) a_s[(w * kTile + j) * 18 + i] = A[i];
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float s = half_warp_sum(abl[k]);
      if (j == 0 && w < W) pose_s[w * kPose + 27 + k] = s;
    }
  }
  __syncthreads();

  // (c) The tile's partial: for each pose pair w <= v (pair index p in
  // row-major upper order), Hpp[w] (on the diagonal) - sum_j A[w] Hpl[v]^T;
  // one thread per (pair, row k) computes the row's 6 entries.
  for (int task = tid; task < 6 * P; task += blockDim.x) {
    const int p = task / 6, k = task % 6;
    int pw = 0, rem = p;
    while (rem >= W - pw) { rem -= W - pw; ++pw; }
    const int pv = pw + rem;
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int jj = 0; jj < kTile; ++jj) {
      const float* a = a_s + (pw * kTile + jj) * 18 + k * 3;
      const float* h = hpl_s + (pv * kTile + jj) * 18;
      const float a0 = a[0], a1 = a[1], a2 = a[2];
#pragma unroll
      for (int m = 0; m < 6; ++m) acc[m] += a0 * h[m * 3] + a1 * h[m * 3 + 1] + a2 * h[m * 3 + 2];
    }
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      const float hpp = pw == pv ? pose_s[pw * kPose + (k <= m ? sym6(k, m) : sym6(m, k))] : 0.f;
      tile_s[p * 36 + k * 6 + m] = hpp - acc[m];
    }
  }
  if (tid < 6 * W) {
    const int pw = tid / 6, k = tid % 6;
    tile_s[36 * P + tid] = pose_s[pw * kPose + 21 + k] - pose_s[pw * kPose + 27 + k];
    tile_s[36 * P + 6 * W + tid] = pose_s[pw * kPose + sym6(k, k)];
  }

  // (d) The cluster sums its tiles in rank order through distributed shared
  // memory; block `rank` writes every kCluster-th slice of the partial.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  {
    const int rank = static_cast<int>(cluster.block_rank());
    float* out = part + static_cast<size_t>(blockIdx.x / kCluster) * E;
    for (int e = rank * blockDim.x + tid; e < E; e += kCluster * blockDim.x) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) s += cluster.map_shared_rank(tile_s, q)[e];
      out[e] = s;
    }
  }
  cluster.sync();

  // (e) The last block to finish sums the cluster partials and solves.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  if (tid == 0) *ticket = 0;
  const int N = 6 * W, nclusters = gridDim.x / kCluster;
  double* S = reinterpret_cast<double*>(smem);   // [N][N]
  double* Dinv = S + N * N;                      // [W][36]
  double* rb = Dinv + 36 * W;                    // [N]
  double* x = rb + N;                            // [N]
  double* tot = x + N;                           // [E]
  // kPer entries per thread, up to 8 clusters' values of each loaded
  // before any is summed (in cluster order), so the L2 reads overlap.
  constexpr int kPer = 9;
  for (int e0 = tid; e0 < E; e0 += kPer * blockDim.x) {
    double sum[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) sum[q] = 0.0;
    for (int c0 = 0; c0 < nclusters; c0 += 8) {
      float v[kPer][8];
#pragma unroll
      for (int q = 0; q < kPer; ++q)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int e = e0 + q * blockDim.x;
          v[q][c] = e < E && c0 + c < nclusters
                        ? __ldcg(part + static_cast<size_t>(c0 + c) * E + e) : 0.f;
        }
#pragma unroll
      for (int q = 0; q < kPer; ++q)
#pragma unroll
        for (int c = 0; c < 8; ++c) sum[q] += static_cast<double>(v[q][c]);
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (e0 + q * blockDim.x < E) tot[e0 + q * blockDim.x] = sum[q];
  }
  __syncthreads();
  // The Hpp damping of each pose, then the damped reduced system with the
  // gauge identity block: one warp per row, lanes along the columns.
  double* damp = x;  // [W], free until the back substitution
  if (tid < W) {
    double tr = 0.0;
#pragma unroll
    for (int i = 0; i < 6; ++i) tr += tot[36 * P + 6 * W + 6 * tid + i];
    damp[tid] = static_cast<double>(lam * fmaxf(static_cast<float>(tr) / 6.0f, 1e-6f));
  }
  __syncthreads();
  const int lane = tid & 31;
  for (int r = tid / 32; r < N; r += blockDim.x / 32) {
    const int bw = r / 6, k = r % 6;
    const bool fw = sFix[bw] > 0.5f;
    for (int c = lane; c < N; c += 32) {
      const int bv = c / 6, m = c % 6;
      const int lo = bw < bv ? bw : bv, hi = bw < bv ? bv : bw;
      const int p = lo * W - lo * (lo - 1) / 2 + (hi - lo);
      double val = tot[p * 36 + (bw <= bv ? k * 6 + m : m * 6 + k)];
      const bool diag = bw == bv && k == m;
      if (diag) val += damp[bw];
      if (fw || sFix[bv] > 0.5f) val = 0.0;
      if (diag) val += fw ? 1.0 : 1e-9;
      S[r * N + c] = val;
    }
  }
  for (int e = tid; e < N; e += blockDim.x) rb[e] = sFix[e / 6] > 0.5f ? 0.0 : tot[36 * P + e];
  __syncthreads();
  block_solve(S, rb, Dinv, x, W);
  for (int e = tid; e < N; e += blockDim.x) dp[e] = static_cast<float>(x[e]);
}

__global__ void __launch_bounds__(kThreads)
    schur_backsub(Inputs in, const float* __restrict__ dp, float* __restrict__ dl) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sR[kMaxW * 9], sT[kMaxW * 3], sdp[6 * kMaxW];
  const int W = in.W, L = in.L, tid = threadIdx.x;
  float* hll_s = reinterpret_cast<float*>(smem);  // [W][kTile][9]
  float* c_s = hll_s + W * kTile * 9;             // [W][kTile][3]
  load_poses(in, sR, sT);
  for (int i = tid; i < 6 * W; i += blockDim.x) sdp[i] = dp[i];
  __syncthreads();
  const int w = tid / kTile, j = tid % kTile;
  const int l = blockIdx.x * kTile + j;
  const bool live = w < W && l < L;
  float hpl[18];
  if (w < W) {
    float hll[9];
    observe<false>(in, sR, sT, live && in.fixed[w] > 0.5f, w, l, live, hpl, hll, nullptr,
                   nullptr);
#pragma unroll
    for (int i = 0; i < 9; ++i) hll_s[(w * kTile + j) * 9 + i] = hll[i];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) s += hpl[k * 3 + b] * sdp[6 * w + k];
      c_s[(w * kTile + j) * 3 + b] = s;
    }
  }
  __syncthreads();
  if (tid < kTile && blockIdx.x * kTile + tid < L) {
    float hi[6], bl[3];
    landmark_inverse(hll_s, tid, W, in.lam[0], hi, bl);
    float r[3] = {bl[0], bl[1], bl[2]};
    for (int v = 0; v < W; ++v)
#pragma unroll
      for (int b = 0; b < 3; ++b) r[b] -= c_s[(v * kTile + tid) * 3 + b];
    const int lt = blockIdx.x * kTile + tid;
#pragma unroll
    for (int b = 0; b < 3; ++b)
      dl[b * L + lt] = hinv_at(hi, b, 0) * r[0] + hinv_at(hi, b, 1) * r[1] + hinv_at(hi, b, 2) * r[2];
  }
}

}  // namespace

extern "C" int flvis_schur_scratch_floats(int W, int L) {
  const int tiles = (L + kTile - 1) / kTile;
  const int clusters = (tiles + kCluster - 1) / kCluster;
  return clusters * partial_floats(W);
}

extern "C" int flvis_schur_step(const float* R, const float* t, const float* pw,
                                const float* obs3, const float* urv, const float* wm,
                                const float* fixed, const float* cam, const float* lam,
                                float delta, int W, int L, float* scratch,
                                unsigned int* ticket, float* dp, float* dl,
                                cudaStream_t stream) {
  if (W < 1 || W > kMaxW || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  // The dynamic shared-memory limit is raised once per device, for the
  // largest window, at the first call.
  static unsigned long long ready = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(ready >> dev & 1ull)) {
    err = cudaFuncSetAttribute(schur_reduce_solve, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(reduce_solve_smem_bytes(kMaxW)));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready |= 1ull << dev;
  }
  const Inputs in{R, t, pw, obs3, urv, wm, fixed, cam, lam, delta, W, L};
  const int tiles = (L + kTile - 1) / kTile;
  const int grid = (tiles + kCluster - 1) / kCluster * kCluster;
  schur_reduce_solve<<<grid, kThreads, reduce_solve_smem_bytes(W), stream>>>(
      in, scratch, ticket, dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bs_smem = static_cast<size_t>(W) * kTile * (9 + 3) * sizeof(float);
  schur_backsub<<<tiles, kThreads, bs_smem, stream>>>(in, dp, dl);
  return static_cast<int>(cudaGetLastError());
}
