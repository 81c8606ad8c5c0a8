// One damped Schur-complement Levenberg-Marquardt step of the sliding-window
// BA — the Hopper counterpart of the TPU kernel
// flvis_tpu/ops/pallas/schur.py:schur_step_kernel, computing the XLA body
// of window_ba._schur_step (window_ba.py:373-431) in four passes on one
// stream:
//   (a) landmark pass — one thread per landmark l, looping over the W
//       poses: stereo residuals [u, v, u_r], Huber weights, pose and
//       landmark Jacobians, Hll / bl accumulation, the damped closed-form
//       3x3 inverse, and per-landmark Hpl (W,6,3), A = Hpl Hll^-1 and the
//       Hpp / bp partials, all written to scratch (landmark axis last, so
//       neighbouring threads touch neighbouring addresses);
//   (b) reduction pass — one block per pose pair (w, v): S_red[w,v] =
//       sum_l A[w] Hpl[v]^T, and on the diagonal Hpp, bp and A bl, summed
//       with a fixed-order warp-shuffle + shared-memory tree (no float
//       atomics: results repeat run to run); writes the damped reduced
//       6W x 6W system with the gauge identity block and its right side;
//   (c) solve pass — one block, Gaussian elimination with partial pivoting
//       in double precision in shared memory (N = 6W <= 96);
//   (d) back-substitution pass — one thread per landmark:
//       dl = Hll^-1 (bl - Hpl^T dp).
//
// Inputs (float32, contiguous): R (W,9) row-major, t (W,3), pw (3,L),
// obs3 (3W,L), urv (W,L), wm (W,L), fixed (W,), cam (5,) [fx,fy,cx,cy,fx*b],
// lam (1,); delta by value.  Outputs dp (W,6), dl (3,L).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxW = 16;
constexpr int kMaxN = 6 * kMaxW;
constexpr int kRedThreads = 256;
constexpr int kRedWarps = kRedThreads / 32;
constexpr int kNumVals = 36 + 21 + 6 + 6;  // S_red block, Hpp (upper), bp, A bl
constexpr int kSolveThreads = 256;

__host__ __device__ inline int sym6(int k, int m) {  // upper-triangle index, k <= m
  return k * 6 - k * (k - 1) / 2 + (m - k);
}

struct Scratch {
  float *Hpl, *A, *HppP, *bpP, *bl, *Hinv, *S, *rhs;
};

__host__ __device__ inline Scratch carve(float* base, int W, int L) {
  Scratch s;
  s.Hpl = base;
  s.A = s.Hpl + static_cast<size_t>(W) * 18 * L;
  s.HppP = s.A + static_cast<size_t>(W) * 18 * L;
  s.bpP = s.HppP + static_cast<size_t>(W) * 21 * L;
  s.bl = s.bpP + static_cast<size_t>(W) * 6 * L;
  s.Hinv = s.bl + 3 * static_cast<size_t>(L);
  s.S = s.Hinv + 6 * static_cast<size_t>(L);
  s.rhs = s.S + 36 * W * W;
  return s;
}

__global__ void landmark_pass(const float* __restrict__ R, const float* __restrict__ t,
                              const float* __restrict__ pw, const float* __restrict__ obs3,
                              const float* __restrict__ urv, const float* __restrict__ wm,
                              const float* __restrict__ fixed, const float* __restrict__ cam,
                              const float* __restrict__ lamp, float delta, int W, int L,
                              Scratch s) {
  __shared__ float sR[kMaxW * 9], sT[kMaxW * 3], sFix[kMaxW];
  for (int i = threadIdx.x; i < W * 9; i += blockDim.x) sR[i] = R[i];
  for (int i = threadIdx.x; i < W * 3; i += blockDim.x) sT[i] = t[i];
  for (int i = threadIdx.x; i < W; i += blockDim.x) sFix[i] = fixed[i];
  __syncthreads();
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const float fx = cam[0], fy = cam[1], cx = cam[2], cy = cam[3], fxb = cam[4];
  const float lam = lamp[0];
  const float px = pw[l], py = pw[L + l], pz = pw[2 * L + l];

  float H00 = 0.f, H01 = 0.f, H02 = 0.f, H11 = 0.f, H12 = 0.f, H22 = 0.f;
  float bl0 = 0.f, bl1 = 0.f, bl2 = 0.f;
  for (int w = 0; w < W; ++w) {
    const float* Rw = sR + 9 * w;
    const float x = Rw[0] * px + Rw[1] * py + Rw[2] * pz + sT[3 * w + 0];
    const float y = Rw[3] * px + Rw[4] * py + Rw[5] * pz + sT[3 * w + 1];
    const float zr = Rw[6] * px + Rw[7] * py + Rw[8] * pz + sT[3 * w + 2];
    const float z = fabsf(zr) < 1e-6f ? 1e-6f : zr;
    const float iz = 1.0f / z;
    const float iz2 = iz * iz;
    const size_t wl = static_cast<size_t>(w) * L + l;
    const float um = urv[wl];
    const float u = fx * x / z + cx;
    const float v = fy * y / z + cy;
    float r[3];
    r[0] = u - obs3[(3 * static_cast<size_t>(w)) * L + l];
    r[1] = v - obs3[(3 * static_cast<size_t>(w) + 1) * L + l];
    r[2] = um > 0.5f ? (u - fxb / z) - obs3[(3 * static_cast<size_t>(w) + 2) * L + l] : 0.f;
    const float rn = sqrtf(fmaxf(r[0] * r[0] + r[1] * r[1] + r[2] * r[2], 1e-12f));
    const float hub = rn <= delta ? 1.0f : delta / rn;
    const float wgt = wm[wl] > 0.5f ? hub : 0.0f;
    const float fixw = sFix[w] > 0.5f ? 0.0f : 1.0f;

    float duv[3][3] = {{fx * iz, 0.f, -fx * x * iz2},
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
    H00 += Jl[0][0] * wJl[0][0] + Jl[1][0] * wJl[1][0] + Jl[2][0] * wJl[2][0];
    H01 += Jl[0][0] * wJl[0][1] + Jl[1][0] * wJl[1][1] + Jl[2][0] * wJl[2][1];
    H02 += Jl[0][0] * wJl[0][2] + Jl[1][0] * wJl[1][2] + Jl[2][0] * wJl[2][2];
    H11 += Jl[0][1] * wJl[0][1] + Jl[1][1] * wJl[1][1] + Jl[2][1] * wJl[2][1];
    H12 += Jl[0][1] * wJl[0][2] + Jl[1][1] * wJl[1][2] + Jl[2][1] * wJl[2][2];
    H22 += Jl[0][2] * wJl[0][2] + Jl[1][2] * wJl[1][2] + Jl[2][2] * wJl[2][2];
    bl0 -= Jl[0][0] * wr[0] + Jl[1][0] * wr[1] + Jl[2][0] * wr[2];
    bl1 -= Jl[0][1] * wr[0] + Jl[1][1] * wr[1] + Jl[2][1] * wr[2];
    bl2 -= Jl[0][2] * wr[0] + Jl[1][2] * wr[1] + Jl[2][2] * wr[2];

    // Weights multiply a Jacobian factor FIRST (as the plain version's
    // Jp * wgt does): an unobserved entry behind the camera can carry a
    // huge Jacobian, and wgt = 0 must zero it before any product of two.
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float j0 = Jp[0][k], j1 = Jp[1][k], j2 = Jp[2][k];
      const float wj0 = wgt * j0, wj1 = wgt * j1, wj2 = wgt * j2;
#pragma unroll
      for (int b = 0; b < 3; ++b)
        s.Hpl[((static_cast<size_t>(w) * 6 + k) * 3 + b) * L + l] =
            wj0 * Jl[0][b] + wj1 * Jl[1][b] + wj2 * Jl[2][b];
#pragma unroll
      for (int m = k; m < 6; ++m)
        s.HppP[(static_cast<size_t>(w) * 21 + sym6(k, m)) * L + l] =
            wj0 * Jp[0][m] + wj1 * Jp[1][m] + wj2 * Jp[2][m];
      s.bpP[(static_cast<size_t>(w) * 6 + k) * L + l] = -(j0 * wr[0] + j1 * wr[1] + j2 * wr[2]);
    }
  }

  // Damped closed-form inverse of the symmetric landmark block.
  const float damp = lam * fmaxf((H00 + H11 + H22) / 3.0f, 1e-6f) + 1e-8f;
  const float a = H00 + damp, b = H01, c = H02, d = H11 + damp, e = H12, f = H22 + damp;
  const float A00 = d * f - e * e, A01 = c * e - b * f, A02 = b * e - c * d;
  const float A11 = a * f - c * c, A12 = b * c - a * e, A22 = a * d - b * b;
  const float det = a * A00 + b * A01 + c * A02;
  const float idet = fabsf(det) > 1e-20f ? 1.0f / det : 0.0f;
  const float Hi[3][3] = {{A00 * idet, A01 * idet, A02 * idet},
                          {A01 * idet, A11 * idet, A12 * idet},
                          {A02 * idet, A12 * idet, A22 * idet}};
  s.bl[l] = bl0;
  s.bl[L + l] = bl1;
  s.bl[2 * L + l] = bl2;
  s.Hinv[0 * L + l] = Hi[0][0];
  s.Hinv[1 * L + l] = Hi[0][1];
  s.Hinv[2 * L + l] = Hi[0][2];
  s.Hinv[3 * L + l] = Hi[1][1];
  s.Hinv[4 * L + l] = Hi[1][2];
  s.Hinv[5 * L + l] = Hi[2][2];
  for (int w = 0; w < W; ++w) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const size_t base = ((static_cast<size_t>(w) * 6 + k) * 3) * L + l;
      const float h0 = s.Hpl[base], h1 = s.Hpl[base + L], h2 = s.Hpl[base + 2 * L];
#pragma unroll
      for (int n = 0; n < 3; ++n)
        s.A[base + n * L] = h0 * Hi[0][n] + h1 * Hi[1][n] + h2 * Hi[2][n];
    }
  }
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void reduce_pass(const float* __restrict__ fixed, const float* __restrict__ lamp,
                            int W, int L, Scratch s) {
  const int w = blockIdx.y, v = blockIdx.x;
  const bool diag = (w == v);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float acc[kNumVals];
#pragma unroll
  for (int i = 0; i < kNumVals; ++i) acc[i] = 0.f;

  for (int l = tid; l < L; l += kRedThreads) {
    float a[6][3], h[6][3];
#pragma unroll
    for (int k = 0; k < 6; ++k)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        a[k][b] = s.A[((static_cast<size_t>(w) * 6 + k) * 3 + b) * L + l];
        h[k][b] = s.Hpl[((static_cast<size_t>(v) * 6 + k) * 3 + b) * L + l];
      }
#pragma unroll
    for (int k = 0; k < 6; ++k)
#pragma unroll
      for (int m = 0; m < 6; ++m)
        acc[k * 6 + m] += a[k][0] * h[m][0] + a[k][1] * h[m][1] + a[k][2] * h[m][2];
    if (diag) {
#pragma unroll
      for (int p = 0; p < 21; ++p) acc[36 + p] += s.HppP[(static_cast<size_t>(w) * 21 + p) * L + l];
      const float b0 = s.bl[l], b1 = s.bl[L + l], b2 = s.bl[2 * L + l];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        acc[57 + k] += s.bpP[(static_cast<size_t>(w) * 6 + k) * L + l];
        acc[63 + k] += a[k][0] * b0 + a[k][1] * b1 + a[k][2] * b2;
      }
    }
  }

  __shared__ float red[kRedWarps][kNumVals];
  __shared__ float tot[kNumVals];
#pragma unroll
  for (int i = 0; i < kNumVals; ++i) {
    const float r = warp_sum(acc[i]);
    if (lane == 0) red[warp][i] = r;
  }
  __syncthreads();
  if (tid < kNumVals) {
    float sum = 0.f;
    for (int i = 0; i < kRedWarps; ++i) sum += red[i][tid];
    tot[tid] = sum;
  }
  __syncthreads();

  const int N = 6 * W;
  const bool fw = fixed[w] > 0.5f, fv = fixed[v] > 0.5f;
  const float lam = lamp[0];
  if (tid < 36) {
    const int k = tid / 6, m = tid % 6;
    float val = -tot[tid];
    if (diag) {
      const float tr = tot[36 + sym6(0, 0)] + tot[36 + sym6(1, 1)] + tot[36 + sym6(2, 2)] +
                       tot[36 + sym6(3, 3)] + tot[36 + sym6(4, 4)] + tot[36 + sym6(5, 5)];
      const float hpp = tot[36 + (k <= m ? sym6(k, m) : sym6(m, k))];
      val = val + (k == m ? hpp + lam * fmaxf(tr / 6.0f, 1e-6f) : hpp);
    }
    if (fw || fv) val = 0.f;
    if (diag && k == m) val += fw ? 1.0f : 1e-9f;
    s.S[static_cast<size_t>(6 * w + k) * N + 6 * v + m] = val;
  }
  if (diag && tid < 6) s.rhs[6 * w + tid] = fw ? 0.f : tot[57 + tid] - tot[63 + tid];
}

__global__ void solve_pass(const float* __restrict__ S, const float* __restrict__ rhs, int N,
                           float* __restrict__ dp) {
  extern __shared__ double sm[];
  double* a = sm;            // N x N
  double* b = a + N * N;     // N
  double* f = b + N;         // N elimination factors / solution
  __shared__ int piv;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < N * N; i += blockDim.x) a[i] = S[i];
  for (int i = tid; i < N; i += blockDim.x) b[i] = rhs[i];
  __syncthreads();

  for (int k = 0; k < N; ++k) {
    if (tid < 32) {  // warp 0: partial-pivot search, lowest row index on ties
      double best = -1.0;
      int arg = k;
      for (int i = k + lane; i < N; i += 32) {
        const double m = fabs(a[i * N + k]);
        if (m > best) { best = m; arg = i; }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const double ob = __shfl_down_sync(0xffffffffu, best, o);
        const int oa = __shfl_down_sync(0xffffffffu, arg, o);
        if (ob > best || (ob == best && oa < arg)) { best = ob; arg = oa; }
      }
      if (lane == 0) piv = arg;
    }
    __syncthreads();
    const int p = piv;
    if (p != k) {
      for (int j = tid; j < N; j += blockDim.x) {
        const double tmp = a[k * N + j];
        a[k * N + j] = a[p * N + j];
        a[p * N + j] = tmp;
      }
      if (tid == 0) {
        const double tmp = b[k];
        b[k] = b[p];
        b[p] = tmp;
      }
    }
    __syncthreads();
    const double pv = a[k * N + k];
    for (int i = k + 1 + tid; i < N; i += blockDim.x) f[i] = pv != 0.0 ? a[i * N + k] / pv : 0.0;
    __syncthreads();
    const int cols = N - k;  // columns k..N-1 plus the right side
    for (int idx = tid; idx < (N - k - 1) * (cols + 1); idx += blockDim.x) {
      const int i = k + 1 + idx / (cols + 1);
      const int j = k + idx % (cols + 1);
      if (j < N) a[i * N + j] -= f[i] * a[k * N + j];
      else b[i] -= f[i] * b[k];
    }
    __syncthreads();
  }

  // Back substitution, one row at a time; warp 0 reduces each row's dot.
  if (tid < 32) {
    for (int i = N - 1; i >= 0; --i) {
      double acc = 0.0;
      for (int j = i + 1 + lane; j < N; j += 32) acc += a[i * N + j] * f[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
      if (lane == 0) {
        const double d = a[i * N + i];
        f[i] = d != 0.0 ? (b[i] - acc) / d : 0.0;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < N; i += blockDim.x) dp[i] = static_cast<float>(f[i]);
}

__global__ void backsub_pass(const float* __restrict__ dp, int W, int L, Scratch s,
                             float* __restrict__ dl) {
  __shared__ float sdp[kMaxN];
  for (int i = threadIdx.x; i < 6 * W; i += blockDim.x) sdp[i] = dp[i];
  __syncthreads();
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
  for (int w = 0; w < W; ++w)
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const size_t base = ((static_cast<size_t>(w) * 6 + k) * 3) * L + l;
      const float d = sdp[6 * w + k];
      c0 += s.Hpl[base] * d;
      c1 += s.Hpl[base + L] * d;
      c2 += s.Hpl[base + 2 * L] * d;
    }
  const float r0 = s.bl[l] - c0, r1 = s.bl[L + l] - c1, r2 = s.bl[2 * L + l] - c2;
  const float h00 = s.Hinv[l], h01 = s.Hinv[L + l], h02 = s.Hinv[2 * L + l];
  const float h11 = s.Hinv[3 * L + l], h12 = s.Hinv[4 * L + l], h22 = s.Hinv[5 * L + l];
  dl[l] = h00 * r0 + h01 * r1 + h02 * r2;
  dl[L + l] = h01 * r0 + h11 * r1 + h12 * r2;
  dl[2 * L + l] = h02 * r0 + h12 * r1 + h22 * r2;
}

}  // namespace

extern "C" int flvis_schur_scratch_floats(int W, int L) {
  return L * W * (18 + 18 + 21 + 6) + 9 * L + 36 * W * W + 6 * W;
}

extern "C" int flvis_schur_step(const float* R, const float* t, const float* pw,
                                const float* obs3, const float* urv, const float* wm,
                                const float* fixed, const float* cam, const float* lam,
                                float delta, int W, int L, float* scratch, float* dp,
                                float* dl, cudaStream_t stream) {
  if (W < 1 || W > kMaxW || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = carve(scratch, W, L);
  const int N = 6 * W;
  const int lm_threads = 128;
  const int lm_blocks = (L + lm_threads - 1) / lm_threads;
  landmark_pass<<<lm_blocks, lm_threads, 0, stream>>>(R, t, pw, obs3, urv, wm, fixed, cam,
                                                      lam, delta, W, L, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_pass<<<dim3(W, W), kRedThreads, 0, stream>>>(fixed, lam, W, L, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (static_cast<size_t>(N) * N + 2 * N) * sizeof(double);
  err = cudaFuncSetAttribute(solve_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  solve_pass<<<1, kSolveThreads, smem, stream>>>(s.S, s.rhs, N, dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  backsub_pass<<<lm_blocks, lm_threads, 0, stream>>>(dp, W, L, s, dl);
  return static_cast<int>(cudaGetLastError());
}
