// Sequential Madgwick attitude chain of an IMU packet — the Hopper
// counterpart of the TPU kernel
// flvis_tpu/ops/pallas/imu_chain.py:attitude_chain_pallas.
//
// One thread per chain (B chains, one per sequence); the P samples of a
// chain are a register loop, so a packet costs one launch.  Per sample:
//   q  <- q ⊗ G_k
//   ĝ  =  R(q)ᵀ ẑ
//   v  =  c_k · (a_k × ĝ)
//   q  <- normalize(q ⊗ [1 − θ²/8, ½(1 − θ²/24)·v]),  θ² = |v|²
// Layout: q0 (B,4), G (B,P,4), a (B,P,3), c (B,P) → out (B,P,4), float32,
// contiguous.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void quat_mul(float aw, float ax, float ay, float az, float bw,
                                         float bx, float by, float bz, float& ow, float& ox,
                                         float& oy, float& oz) {
  ow = aw * bw - ax * bx - ay * by - az * bz;
  ox = aw * bx + ax * bw + ay * bz - az * by;
  oy = aw * by - ax * bz + ay * bw + az * bx;
  oz = aw * bz + ax * by - ay * bx + az * bw;
}

__global__ void attitude_chain_kernel(const float* __restrict__ q0,
                                      const float* __restrict__ G,
                                      const float* __restrict__ a,
                                      const float* __restrict__ c,
                                      float* __restrict__ out, int B, int P) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float qw = q0[4 * b + 0], qx = q0[4 * b + 1], qy = q0[4 * b + 2], qz = q0[4 * b + 3];
  const float* g = G + static_cast<size_t>(b) * P * 4;
  const float* av = a + static_cast<size_t>(b) * P * 3;
  const float* cv = c + static_cast<size_t>(b) * P;
  float* o = out + static_cast<size_t>(b) * P * 4;
  for (int k = 0; k < P; ++k) {
    float pw, px, py, pz;
    quat_mul(qw, qx, qy, qz, g[4 * k + 0], g[4 * k + 1], g[4 * k + 2], g[4 * k + 3], pw, px,
             py, pz);
    const float gpx = 2.0f * (px * pz - pw * py);
    const float gpy = 2.0f * (py * pz + pw * px);
    const float gpz = 1.0f - 2.0f * (px * px + py * py);
    const float ax = av[3 * k + 0], ay = av[3 * k + 1], az = av[3 * k + 2];
    const float ck = cv[k];
    const float vx = ck * (ay * gpz - az * gpy);
    const float vy = ck * (az * gpx - ax * gpz);
    const float vz = ck * (ax * gpy - ay * gpx);
    const float th2 = vx * vx + vy * vy + vz * vz;
    const float cw = 1.0f - 0.125f * th2;
    const float s = 0.5f * (1.0f - th2 * (1.0f / 24.0f));
    quat_mul(pw, px, py, pz, cw, s * vx, s * vy, s * vz, qw, qx, qy, qz);
    const float inv = rsqrtf(qw * qw + qx * qx + qy * qy + qz * qz);
    qw *= inv;
    qx *= inv;
    qy *= inv;
    qz *= inv;
    o[4 * k + 0] = qw;
    o[4 * k + 1] = qx;
    o[4 * k + 2] = qy;
    o[4 * k + 3] = qz;
  }
}

}  // namespace

extern "C" int flvis_attitude_chain(const float* q0, const float* G, const float* a,
                                    const float* c, float* out, int B, int P,
                                    cudaStream_t stream) {
  if (B <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32;
  attitude_chain_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(q0, G, a, c,
                                                                             out, B, P);
  return static_cast<int>(cudaGetLastError());
}
