// The IMU packet on the card — the Hopper counterpart of the TPU kernel
// flvis_tpu/ops/pallas/imu_chain.py:attitude_chain_pallas, in two entries
// that share one recurrence (chain_step):
//
//   attitude_chain_kernel — the TPU kernel's own function: the sequential
//     Madgwick attitude chain of a packet, given its precomputed inputs.
//     Per sample:
//       q  <- q ⊗ G_k
//       ĝ  =  R(q)ᵀ ẑ
//       v  =  c_k · (a_k × ĝ)
//       q  <- normalize(q ⊗ [1 − θ²/8, ½(1 − θ²/24)·v]),  θ² = |v|²
//     Layout: q0 (B,4), G (B,P,4), a (B,P,3), c (B,P) → out (B,P,4).
//
//   imu_feed_kernel — the whole packet: vio/vimotion.imu_feed_batch from
//     one VioState to the next in one launch, both branches of the
//     reference's lax.cond on `initialized`, which the kernel reads on the
//     card (no host read).  Steady mode (initialised at the packet's start)
//     is the reference's _feed_prop_batch: dt from the running max of the
//     valid times, bias removal, G = exp(gm·dt), the trust weights, the
//     chain, acc_w = R(q)·am + g_w and the velocity and position sums left
//     to right.  Init mode is _feed_scan, sample by sample (the init sums,
//     the gravity attitude, the gyro-bias latch, the Madgwick step with
//     exact exps, the Euler step; the switch to propagation may fall
//     mid-packet).  Both append to the ring at head + the exclusive prefix
//     of valid, mod C (the last write wins where a packet holds more valid
//     samples than the ring), into fresh output tensors: the caller's state
//     is not touched.
//
// What bounds it: a 16-sample packet is ~0.5 KB of inputs and a ~27 KB
// ring, nothing for the card's bytes or operations; the time is the chain's
// dependent latency, what one lane issues around it, and memory round
// trips.  So warp 0 loads a chunk of 32 samples (one per lane) and the
// scalars in one round trip and the newest ring row in a second, forms
// everything that does not depend on q in parallel (dt by a warp max-scan,
// ring slots by a ballot prefix, G, a_unit and c) into shared memory, and
// only then runs the recurrence on one lane from shared memory.  That lane
// forms each sample's row (the rotated acceleration, the velocity and
// position sums, left to right) one step behind the chain: the row does not
// depend on the next step, so its work fills the chain's dependent latency.
// Meanwhile warps 1..7 copy the whole old ring into the new one, 16 bytes a
// lane with every load issued before any store (one round trip); one
// barrier later warp 0's rows overwrite their slots.  B chains (stacked
// states), one block each.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CH = 32;          // samples per staged chunk: one per lane of warp 0
constexpr int FEED_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void quat_mul(float aw, float ax, float ay, float az, float bw,
                                         float bx, float by, float bz, float& ow, float& ox,
                                         float& oy, float& oz) {
  ow = aw * bw - ax * bx - ay * by - az * bz;
  ox = aw * bx + ax * bw + ay * bz - az * by;
  oy = aw * by - ax * bz + ay * bw + az * bx;
  oz = aw * bz + ax * by - ay * bx + az * bw;
}

// rsqrtf's approximation (MUFU.RSQ) for a normal x, without the scaling
// rsqrtf adds for denormal inputs: the same result where x is normal.
__device__ __forceinline__ float rsqrt_normal(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// One step of the attitude chain, q in place (the TPU kernel's arithmetic,
// with its small-angle series for the correction exp).
__device__ __forceinline__ void chain_step(float& qw, float& qx, float& qy, float& qz,
                                           float gw, float gx, float gy, float gz, float ax,
                                           float ay, float az, float ck) {
  float pw, px, py, pz;
  quat_mul(qw, qx, qy, qz, gw, gx, gy, gz, pw, px, py, pz);
  const float gpx = 2.0f * (px * pz - pw * py);
  const float gpy = 2.0f * (py * pz + pw * px);
  const float gpz = 1.0f - 2.0f * (px * px + py * py);
  const float vx = ck * (ay * gpz - az * gpy);
  const float vy = ck * (az * gpx - ax * gpz);
  const float vz = ck * (ax * gpy - ay * gpx);
  const float th2 = vx * vx + vy * vy + vz * vz;
  const float cw = 1.0f - 0.125f * th2;
  const float s = 0.5f * (1.0f - th2 * (1.0f / 24.0f));
  quat_mul(pw, px, py, pz, cw, s * vx, s * vy, s * vz, qw, qx, qy, qz);
  const float inv = rsqrt_normal(qw * qw + qx * qx + qy * qy + qz * qz);
  qw *= inv;
  qx *= inv;
  qy *= inv;
  qz *= inv;
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
    chain_step(qw, qx, qy, qz, g[4 * k + 0], g[4 * k + 1], g[4 * k + 2], g[4 * k + 3],
               av[3 * k + 0], av[3 * k + 1], av[3 * k + 2], cv[k]);
    o[4 * k + 0] = qw;
    o[4 * k + 1] = qx;
    o[4 * k + 2] = qy;
    o[4 * k + 3] = qz;
  }
}

// ---------------------------------------------------------------- the feed

// Pointers of one launch, in the order of the C entry's pointer array:
// the VioState fields in, the packet, the VioState fields out.
struct FeedArgs {
  const float *t, *pos, *vel, *q, *acc, *gyro;
  const int *head, *count;
  const float *bias_acc, *bias_gyro;
  const uint8_t* initialized;
  const float *init_acc_sum, *init_gyro_sum;
  const int* init_count;
  const float *p_acc, *p_gyro, *p_t;
  const uint8_t* p_valid;  // null: every sample valid
  float *o_t, *o_pos, *o_vel, *o_q, *o_acc, *o_gyro;
  int *o_head, *o_count;
  float *o_bias_acc, *o_bias_gyro;
  uint8_t* o_initialized;
  float *o_init_acc_sum, *o_init_gyro_sum;
  int* o_init_count;
};
constexpr int kFeedPtrs = 32;

__device__ __forceinline__ void cross3(float ax, float ay, float az, float bx, float by,
                                       float bz, float& ox, float& oy, float& oz) {
  ox = ay * bz - az * by;
  oy = az * bx - ax * bz;
  oz = ax * by - ay * bx;
}

// v' = v + 2 (w (u × v) + u × (u × v)), u = q.xyz (geometry/so3.rotate).
__device__ __forceinline__ void rotate(float qw, float qx, float qy, float qz, float vx,
                                       float vy, float vz, float& ox, float& oy, float& oz) {
  float ux, uy, uz, wx, wy, wz;
  cross3(qx, qy, qz, vx, vy, vz, ux, uy, uz);
  cross3(qx, qy, qz, ux, uy, uz, wx, wy, wz);
  ox = vx + 2.0f * (qw * ux + wx);
  oy = vy + 2.0f * (qw * uy + wy);
  oz = vz + 2.0f * (qw * uz + wz);
}

// geometry/so3.exp with its small-angle branch (θ² < 1e-8).
__device__ __forceinline__ void so3_exp(float x, float y, float z, float& w, float& ox,
                                        float& oy, float& oz) {
  const float th2 = x * x + y * y + z * z;
  const float th = sqrtf(fmaxf(th2, 1e-16f));
  const bool small = th2 < 1e-8f;
  float sn, cs;
  sincosf(0.5f * th, &sn, &cs);
  const float k = small ? 0.5f - th2 / 48.0f : sn / th;
  w = small ? 1.0f - th2 / 8.0f : cs;
  ox = k * x;
  oy = k * y;
  oz = k * z;
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(x * x + y * y + z * z);
}

// vimotion._madgwick_step: gyro integration, then a pull of the predicted
// gravity direction toward the accelerometer, exact exps.
__device__ void madgwick_step(float& qw, float& qx, float& qy, float& qz, float gx, float gy,
                              float gz, float ax, float ay, float az, float beta10, float dt) {
  float ew, ex, ey, ez, pw, px, py, pz;
  so3_exp(gx * dt, gy * dt, gz * dt, ew, ex, ey, ez);
  quat_mul(qw, qx, qy, qz, ew, ex, ey, ez, pw, px, py, pz);
  const float an = norm3(ax, ay, az);
  const float inv = fmaxf(an, 1e-6f);
  const float ux = ax / inv, uy = ay / inv, uz = az / inv;
  float gpx, gpy, gpz;
  rotate(pw, -px, -py, -pz, 0.0f, 0.0f, 1.0f, gpx, gpy, gpz);
  float rx, ry, rz;
  cross3(ux, uy, uz, gpx, gpy, gpz, rx, ry, rz);
  const float trust = expf(-fabsf(an - 9.81f) / 9.81f * 5.0f);
  float cw, cx, cy, cz;
  so3_exp(rx * beta10 * trust * dt, ry * beta10 * trust * dt, rz * beta10 * trust * dt, cw,
          cx, cy, cz);
  quat_mul(pw, px, py, pz, cw, cx, cy, cz, qw, qx, qy, qz);
  const float n = sqrtf(qw * qw + qx * qx + qy * qy + qz * qz);
  qw /= n;
  qx /= n;
  qy /= n;
  qz /= n;
}

// vimotion._attitude_from_gravity: roll/pitch of the mean gravity, yaw 0.
__device__ void attitude_from_gravity(float ax, float ay, float az, float& qw, float& qx,
                                      float& qy, float& qz) {
  const float n = fmaxf(norm3(ax, ay, az), 1e-6f);
  const float x = ax / n, y = ay / n, z = az / n;
  const float r = 0.5f * atan2f(y, z);
  const float p = 0.5f * atan2f(-x, sqrtf(y * y + z * z));
  const float cr = cosf(r), sr = sinf(r), cp = cosf(p), sp = sinf(p);
  qw = cr * cp;
  qx = sr * cp;
  qy = cr * sp;
  qz = -(sr * sp);
}

// The six ring arrays of block b, old → new, as one index space of V (float
// or float4): t (C), pos, vel (3C), q (4C), acc, gyro (3C).  Each thread
// issues kU loads before its kU stores, so the ~27 KB take about one memory
// round trip.
template <typename V>
__device__ __forceinline__ void copy_ring(const FeedArgs& a, size_t r1, int C, int i0,
                                          int nt) {
  constexpr int w = sizeof(V) / sizeof(float);
  constexpr int kU = 8;
  const int n1 = C / w, n3 = 3 * C / w, n4 = 4 * C / w;
  const int e0 = n1, e1 = e0 + n3, e2 = e1 + n3, e3 = e2 + n4, e4 = e3 + n3, e5 = e4 + n3;
  auto at = [&](int g, const V*& src, V*& dst) {
    if (g < e0) {
      src = reinterpret_cast<const V*>(a.t + r1) + g;
      dst = reinterpret_cast<V*>(a.o_t + r1) + g;
    } else if (g < e1) {
      src = reinterpret_cast<const V*>(a.pos + 3 * r1) + (g - e0);
      dst = reinterpret_cast<V*>(a.o_pos + 3 * r1) + (g - e0);
    } else if (g < e2) {
      src = reinterpret_cast<const V*>(a.vel + 3 * r1) + (g - e1);
      dst = reinterpret_cast<V*>(a.o_vel + 3 * r1) + (g - e1);
    } else if (g < e3) {
      src = reinterpret_cast<const V*>(a.q + 4 * r1) + (g - e2);
      dst = reinterpret_cast<V*>(a.o_q + 4 * r1) + (g - e2);
    } else if (g < e4) {
      src = reinterpret_cast<const V*>(a.acc + 3 * r1) + (g - e3);
      dst = reinterpret_cast<V*>(a.o_acc + 3 * r1) + (g - e3);
    } else {
      src = reinterpret_cast<const V*>(a.gyro + 3 * r1) + (g - e4);
      dst = reinterpret_cast<V*>(a.o_gyro + 3 * r1) + (g - e4);
    }
  };
  for (int g0 = i0; g0 < e5; g0 += kU * nt) {
    V v[kU];
    V* dst[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int g = g0 + u * nt;
      const V* src = nullptr;
      dst[u] = nullptr;
      if (g < e5) {
        at(g, src, dst[u]);
        v[u] = __ldg(src);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (dst[u]) *dst[u] = v[u];
  }
}

__global__ void __launch_bounds__(FEED_THREADS)
    imu_feed_kernel(FeedArgs a, int C, int P, int init_samples, float gravity, float beta10) {
  __shared__ float4 s_G[CH], s_auc[CH], s_amd[CH], s_q[CH];  // G; a_unit, c; am, dt_v; q
  __shared__ float s_pv[CH][6];                              // pos, vel of each row
  __shared__ float s_acc[CH][3], s_gyro[CH][3], s_t[CH];     // init mode's samples
  __shared__ uint8_t s_ok[CH];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool warp0 = tid < 32;
  // Block b's chain: stacked states and packets.
  const size_t r1 = static_cast<size_t>(b) * C, pk = static_cast<size_t>(b) * P;
  const uint8_t* valid = a.p_valid ? a.p_valid + pk : nullptr;
  // 16-byte copies where every ring array allows them.
  const uintptr_t al =
      reinterpret_cast<uintptr_t>(a.t + r1) | reinterpret_cast<uintptr_t>(a.o_t + r1) |
      reinterpret_cast<uintptr_t>(a.pos + 3 * r1) | reinterpret_cast<uintptr_t>(a.o_pos + 3 * r1) |
      reinterpret_cast<uintptr_t>(a.vel + 3 * r1) | reinterpret_cast<uintptr_t>(a.o_vel + 3 * r1) |
      reinterpret_cast<uintptr_t>(a.q + 4 * r1) | reinterpret_cast<uintptr_t>(a.o_q + 4 * r1) |
      reinterpret_cast<uintptr_t>(a.acc + 3 * r1) | reinterpret_cast<uintptr_t>(a.o_acc + 3 * r1) |
      reinterpret_cast<uintptr_t>(a.gyro + 3 * r1) |
      reinterpret_cast<uintptr_t>(a.o_gyro + 3 * r1);
  const bool vec = C % 4 == 0 && (al & 15u) == 0;

  // Lane l's sample of the current chunk (sample k0 + l).
  float tk = 0.0f, ac[3] = {}, gy[3] = {};
  bool ok = false;
  auto load_sample = [&](int k) {
    const bool in = k < P;
    ok = in && (valid == nullptr || valid[k]);
    tk = 0.0f;
    if (in) {
      const size_t kk = pk + k;
      tk = __ldg(a.p_t + kk);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        ac[d] = __ldg(a.p_acc + 3 * kk + d);
        gy[d] = __ldg(a.p_gyro + 3 * kk + d);
      }
    }
  };

  // Warp 0 carries the packet.  Its first round trip: the first chunk, the
  // scalars (one broadcast load each); its second: the newest ring row.
  int head = 0, count = 0, n_ok = 0, n_init = 0;
  bool steady = false;
  float t_l = 0.0f, qw = 0.0f, qx = 0.0f, qy = 0.0f, qz = 0.0f;
  float p_l[3] = {}, v_l[3] = {}, ba[3] = {}, bg[3] = {}, as[3] = {}, gs[3] = {};
  if (warp0) {
    load_sample(lane);
    head = __ldg(a.head + b);
    count = __ldg(a.count + b);
    steady = __ldg(a.initialized + b) != 0;
    n_init = __ldg(a.init_count + b);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      ba[d] = __ldg(a.bias_acc + 3 * b + d);
      bg[d] = __ldg(a.bias_gyro + 3 * b + d);
      as[d] = __ldg(a.init_acc_sum + 3 * b + d);
      gs[d] = __ldg(a.init_gyro_sum + 3 * b + d);
    }
    n_ok = __popc(__ballot_sync(FULL, ok));
    for (int k0 = CH; k0 < P; k0 += CH) {
      const int k = k0 + lane;
      n_ok += __popc(__ballot_sync(FULL, k < P && (valid == nullptr || valid[k])));
    }
    const size_t j = r1 + (head - 1 + C) % C;  // the newest ring row
    t_l = __ldg(a.t + j);
    qw = __ldg(a.q + 4 * j);
    qx = __ldg(a.q + 4 * j + 1);
    qy = __ldg(a.q + 4 * j + 2);
    qz = __ldg(a.q + 4 * j + 3);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      p_l[d] = __ldg(a.pos + 3 * j + d);
      v_l[d] = __ldg(a.vel + 3 * j + d);
    }
  }
  bool inited = steady;
  // Steady mode's running sums: vel = v_l + Σ acc_w·dt_v, pos = p_l + Σ (…).
  float sv[3] = {0.0f, 0.0f, 0.0f}, sp[3] = {0.0f, 0.0f, 0.0f};
  float vprev[3] = {v_l[0], v_l[1], v_l[2]};
  float t_run = t_l;  // running max of the valid times (steady dt)
  int base = 0;       // valid samples before this chunk

  // One pass per chunk of CH samples, the same count for every thread.
  for (int k0 = 0; k0 < P; k0 += CH) {
    int slot = -1;
    if (warp0) {
      const bool in = k0 + lane < P;
      // Ring slot: head + rank among the valid samples, mod C; a sample that
      // a later one of the same packet overwrites is dropped.
      const unsigned ball = __ballot_sync(FULL, ok);
      const int rank = base + __popc(ball & ((1u << lane) - 1u));
      base += __popc(ball);
      if (ok && rank >= n_ok - C) slot = (head + rank) % C;
      const int n = min(CH, P - k0);
      if (steady) {
        // dt_k = clip(t_k − max(t_l, valid times before k), 1e-4, 0.05).
        float m = ok ? tk : __int_as_float(0xff800000);  // −inf
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(FULL, m, o);
          if (lane >= o) m = fmaxf(m, u);
        }
        float prev = __shfl_up_sync(FULL, m, 1);
        prev = lane == 0 ? t_run : fmaxf(t_run, prev);
        t_run = fmaxf(t_run, __shfl_sync(FULL, m, 31));
        const float dt = fminf(fmaxf(tk - prev, 1e-4f), 0.05f);
        const float vf = ok ? 1.0f : 0.0f;
        float am[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) am[d] = ac[d] - ba[d];
        if (in) {
          float gw = 1.0f, gxyz[3] = {0.0f, 0.0f, 0.0f};
          if (ok)
            so3_exp((gy[0] - bg[0]) * dt, (gy[1] - bg[1]) * dt, (gy[2] - bg[2]) * dt, gw,
                    gxyz[0], gxyz[1], gxyz[2]);
          const float an = norm3(am[0], am[1], am[2]);
          const float den = fmaxf(an, 1e-6f);
          const float trust = expf(-fabsf(an - 9.81f) / 9.81f * 5.0f);
          s_G[lane] = make_float4(gw, gxyz[0], gxyz[1], gxyz[2]);
          s_auc[lane] = make_float4(am[0] / den, am[1] / den, am[2] / den,
                                    beta10 * trust * dt * vf);
          s_amd[lane] = make_float4(am[0], am[1], am[2], dt * vf);
        }
        __syncwarp();
        if (lane == 0) {
          // Sample i's row from its attitude: acc_w = R(q)·am + g_w, then the
          // velocity and position sums, left to right.
          auto finish = [&](int i, float4 q, float4 md) {
            float aw[3];
            rotate(q.x, q.y, q.z, q.w, md.x, md.y, md.z, aw[0], aw[1], aw[2]);
            aw[2] += -gravity;
            const float dv = md.w;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              sv[d] += aw[d] * dv;
              const float vel = v_l[d] + sv[d];
              sp[d] += vprev[d] * dv + 0.5f * aw[d] * (dv * dv);
              vprev[d] = vel;
              s_pv[i][d] = p_l[d] + sp[d];
              s_pv[i][3 + d] = vel;
            }
            s_q[i] = q;
          };
          // The chain, one sample after another from shared memory, with the
          // previous sample's row in the same step: the two are independent,
          // so the row's work fills the chain's dependent latency.  The next
          // sample's operands are loaded a step ahead.
          float4 g = s_G[0], u = s_auc[0], md = s_amd[0];
          chain_step(qw, qx, qy, qz, g.x, g.y, g.z, g.w, u.x, u.y, u.z, u.w);
          for (int i = 1; i < n; ++i) {
            const float4 q_prev = make_float4(qw, qx, qy, qz), md_prev = md;
            g = s_G[i];
            u = s_auc[i];
            md = s_amd[i];
            chain_step(qw, qx, qy, qz, g.x, g.y, g.z, g.w, u.x, u.y, u.z, u.w);
            finish(i - 1, q_prev, md_prev);
          }
          finish(n - 1, make_float4(qw, qx, qy, qz), md);
        }
      } else {
        if (in) {
          s_t[lane] = tk;
          s_ok[lane] = ok;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            s_acc[lane][d] = ac[d];
            s_gyro[lane][d] = gy[d];
          }
        }
        __syncwarp();
        if (lane == 0) {
          for (int i = 0; i < n; ++i) {
            // Init mode, _feed_scan's sample step: the new carry of the
            // branch that `inited` selects, kept where the sample is valid.
            const float t = s_t[i];
            float nq[4], np[3], nv[3], nbg[3], nas[3], ngs[3];
            bool ninit = inited;
            int nn = n_init;
            if (inited) {
              const float dt = fminf(fmaxf(t - t_l, 1e-4f), 0.05f);
              float am[3], aw[3];
#pragma unroll
              for (int d = 0; d < 3; ++d) am[d] = s_acc[i][d] - ba[d];
              nq[0] = qw, nq[1] = qx, nq[2] = qy, nq[3] = qz;
              madgwick_step(nq[0], nq[1], nq[2], nq[3], s_gyro[i][0] - bg[0],
                            s_gyro[i][1] - bg[1], s_gyro[i][2] - bg[2], am[0], am[1], am[2],
                            beta10, dt);
              rotate(nq[0], nq[1], nq[2], nq[3], am[0], am[1], am[2], aw[0], aw[1], aw[2]);
              aw[2] += -gravity;
#pragma unroll
              for (int d = 0; d < 3; ++d) {
                np[d] = p_l[d] + v_l[d] * dt + 0.5f * aw[d] * dt * dt;
                nv[d] = v_l[d] + aw[d] * dt;
                nbg[d] = bg[d];
                nas[d] = as[d];
                ngs[d] = gs[d];
              }
            } else {
              nn = n_init + 1;
              const float fn = static_cast<float>(nn);
              const bool done = nn >= init_samples;
#pragma unroll
              for (int d = 0; d < 3; ++d) {
                nas[d] = as[d] + s_acc[i][d];
                ngs[d] = gs[d] + s_gyro[i][d];
                nbg[d] = done ? ngs[d] / fn : bg[d];
                np[d] = 0.0f;
                nv[d] = 0.0f;
              }
              attitude_from_gravity(nas[0] / fn, nas[1] / fn, nas[2] / fn, nq[0], nq[1],
                                    nq[2], nq[3]);
              ninit = done;
            }
            s_q[i] = make_float4(nq[0], nq[1], nq[2], nq[3]);
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              s_pv[i][d] = np[d];
              s_pv[i][3 + d] = nv[d];
            }
            if (s_ok[i]) {
              t_l = t;
              qw = nq[0], qx = nq[1], qy = nq[2], qz = nq[3];
#pragma unroll
              for (int d = 0; d < 3; ++d) {
                p_l[d] = np[d];
                v_l[d] = nv[d];
                bg[d] = nbg[d];
                as[d] = nas[d];
                gs[d] = ngs[d];
              }
              inited = ninit;
              n_init = nn;
            }
          }
        }
      }
      __syncwarp();
    } else if (k0 == 0) {
      // Warps 1..: the whole old ring into the new one, meanwhile.
      if (vec)
        copy_ring<float4>(a, r1, C, tid - 32, blockDim.x - 32);
      else
        copy_ring<float>(a, r1, C, tid - 32, blockDim.x - 32);
    }
    // The old ring is in place before the packet's rows overwrite its slots.
    __syncthreads();
    if (slot >= 0) {
      const size_t i = r1 + slot;
      const float4 q = s_q[lane];
      a.o_t[i] = tk;
      a.o_q[4 * i] = q.x;
      a.o_q[4 * i + 1] = q.y;
      a.o_q[4 * i + 2] = q.z;
      a.o_q[4 * i + 3] = q.w;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        a.o_pos[3 * i + d] = s_pv[lane][d];
        a.o_vel[3 * i + d] = s_pv[lane][3 + d];
        a.o_acc[3 * i + d] = ac[d];
        a.o_gyro[3 * i + d] = gy[d];
      }
    }
    if (warp0 && k0 + CH < P) load_sample(k0 + CH + lane);
    __syncwarp();
  }
  if (tid == 0) {
    a.o_head[b] = (head + n_ok) % C;
    a.o_count[b] = min(count + n_ok, C);
    a.o_initialized[b] = inited ? 1 : 0;
    a.o_init_count[b] = n_init;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      a.o_bias_acc[3 * b + d] = ba[d];
      a.o_bias_gyro[3 * b + d] = bg[d];
      a.o_init_acc_sum[3 * b + d] = as[d];
      a.o_init_gyro_sum[3 * b + d] = gs[d];
    }
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

// ptrs: kFeedPtrs device pointers in FeedArgs order (host array).  B stacked
// states of ring capacity C, packets of P samples.  beta10 = 10·madgwick_beta.
extern "C" int flvis_imu_feed(void* const* ptrs, int n_ptrs, int B, int C, int P,
                              int init_samples, float gravity, float beta10,
                              cudaStream_t stream) {
  if (n_ptrs != kFeedPtrs || B <= 0 || C <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static_assert(sizeof(FeedArgs) == kFeedPtrs * sizeof(void*), "FeedArgs holds pointers only");
  FeedArgs args;
  void** dst = reinterpret_cast<void**>(&args);
  for (int i = 0; i < kFeedPtrs; ++i) dst[i] = ptrs[i];
  imu_feed_kernel<<<B, FEED_THREADS, 0, stream>>>(args, C, P, init_samples, gravity, beta10);
  return static_cast<int>(cudaGetLastError());
}
