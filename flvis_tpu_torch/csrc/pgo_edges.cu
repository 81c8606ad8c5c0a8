// The pose graph's edge terms on the card: each edge's residual
//
//   r = log(T_ij⁻¹ · (T_i exp ξ_i)⁻¹ · (T_j exp ξ_j))   at ξ_i = ξ_j = 0,
//
// its exact Jacobians J_i = ∂r/∂ξ_i and J_j = ∂r/∂ξ_j (6×6 each), and its
// Cauchy weight, or its robust cost, for every edge of a graph in one
// launch (loop/pose_graph.py's `_edge_terms`, which both solvers share).
//
// What it replaces: no TPU kernel.  The JAX package leaves this to XLA,
// which fuses its jax.vmap(jax.jacfwd(_edge_residual)) into a few device
// ops (flvis_tpu/loop/pose_graph.py:71-75); the port's plain twin,
// torch.func's vmap(jacfwd) over the same formulas, dispatches ~3,000 aten
// ops a linearisation (~80-100 ms of host time whatever the graph's size),
// and its cost ~340, during which the card idles.
//
// Two modes behind one C entry:
//   linearize — one thread per (edge, tangent direction), 12 directions
//     (ξ_i's six, then ξ_j's): each thread gathers the edge's two node
//     poses, runs the residual's formulas in forward mode along its
//     direction (a value and one derivative per scalar) and writes its
//     column of J_i or J_j, and of J·w; the direction-0 thread writes r and
//     w.  w = edge_weight / (1 + |r|²/c²), zero on an invalid edge.
//   cost — one thread per edge, plain float: ρ·edge_weight with
//     ρ = c² log1p(|r|²/c²), zero on an invalid edge; the wrapper sums the
//     edges in a fixed order.
//
// Why forward mode and not a closed form: forward mode through the very
// formulas of geometry/se3.py and so3.py (the same torch.where branches:
// the exps' and the log's small-angle series, the log's sign flip towards
// w ≥ 0 near π, the clamps, the norm's zero) gives the derivative jacfwd
// gives, branch by branch, by construction; each elementary derivative is
// torch's own forward-mode rule (a clamp passes the tangent inside its
// bounds, inclusive; the norm's tangent is 0 at a zero norm; sqrt's is
// ẋ / 2√x).  A closed form would need its own derivation of every branch.
// The arithmetic is float32 throughout (no fast-math), so results differ
// from the CPU's only by rounding: nvcc's FMA contraction and the
// libraries' sin, cos, atan2, log1p within an ulp or two.
//
// What bounds it: an edge reads ~100 bytes (two poses, its measurement,
// indices, flags) and writes ≤ 0.6 KB (r, four 6×6 blocks, w) — ~0.8 MB
// at 1,344 edges (a dense window of 256 keyframes with 5 successors and 64
// loop edges), 0.24 µs of the card's memory rate; ~2 kflop a thread.  So
// the bound is one launch: 12 threads an edge put 16k-62k threads on the
// card at the solvers' sizes, each a few thousand dependent instructions.
// No atomics and no cross-thread sums: the results repeat bit for bit.
// Indices outside [0, K) (the plain twin's IndexError) give NaN rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDirs = 12;

// A value and its derivative along one tangent direction.
struct Dual {
  float v, d;
  __device__ Dual() {}
  __device__ Dual(float v_, float d_ = 0.f) : v(v_), d(d_) {}
};

__device__ inline Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ inline Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ inline Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ inline Dual operator*(Dual a, Dual b) { return {a.v * b.v, a.d * b.v + a.v * b.d}; }
__device__ inline Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
__device__ inline Dual operator+(Dual a, float s) { return {a.v + s, a.d}; }
__device__ inline Dual operator+(float s, Dual a) { return {s + a.v, a.d}; }
__device__ inline Dual operator-(Dual a, float s) { return {a.v - s, a.d}; }
__device__ inline Dual operator-(float s, Dual a) { return {s - a.v, -a.d}; }
__device__ inline Dual operator*(Dual a, float s) { return {a.v * s, a.d * s}; }
__device__ inline Dual operator*(float s, Dual a) { return {s * a.v, s * a.d}; }
__device__ inline Dual operator/(Dual a, float s) { return {a.v / s, a.d / s}; }
__device__ inline Dual operator/(float s, Dual b) {
  const float q = s / b.v;
  return {q, -q * b.d / b.v};
}

__device__ inline float val(float x) { return x; }
__device__ inline float val(Dual x) { return x.v; }

__device__ inline float sqrt_(float x) { return sqrtf(x); }
__device__ inline Dual sqrt_(Dual x) {
  const float s = sqrtf(x.v);
  return {s, x.d / (2.0f * s)};
}
__device__ inline float sin_(float x) { return sinf(x); }
__device__ inline Dual sin_(Dual x) { return {sinf(x.v), cosf(x.v) * x.d}; }
__device__ inline float cos_(float x) { return cosf(x); }
__device__ inline Dual cos_(Dual x) { return {cosf(x.v), -sinf(x.v) * x.d}; }
__device__ inline float atan2_(float y, float x) { return atan2f(y, x); }
__device__ inline Dual atan2_(Dual y, Dual x) {
  const float rec = 1.0f / (y.v * y.v + x.v * x.v);
  return {atan2f(y.v, x.v), y.d * x.v * rec - x.d * y.v * rec};
}
// torch.clamp: NaN stays NaN; the tangent passes inside the bounds, inclusive.
__device__ inline float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ inline Dual clamp_min(Dual x, float lo) {
  return {x.v < lo ? lo : x.v, x.v >= lo ? x.d : 0.f};
}
__device__ inline float clamp_(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ inline Dual clamp_(Dual x, float lo, float hi) {
  return {clamp_(x.v, lo, hi), (x.v >= lo && x.v <= hi) ? x.d : 0.f};
}
// torch.linalg.vector_norm of n values: its tangent is 0 at a zero norm.
template <int n>
__device__ inline float norm_(const float* x) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < n; ++k) s += x[k] * x[k];
  return sqrtf(s);
}
template <int n>
__device__ inline Dual norm_(const Dual* x) {
  float s = 0.f, t = 0.f;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    s += x[k].v * x[k].v;
    t += x[k].v * x[k].d;
  }
  const float v = sqrtf(s);
  return {v, v == 0.f ? 0.f : t / v};
}

template <class T>
struct Pose {
  T q[4];  // w, x, y, z
  T t[3];
};

constexpr float kEps = 1e-8f;  // geometry's _EPS
constexpr float kEps2 = 1e-16f;

template <class T>
__device__ inline void cross(const T* a, const T* b, T* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

template <class T>
__device__ inline void qmul(const T* a, const T* b, T* o) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// so3.rotate: v + 2 (w (u × v) + u × (u × v)), u = q.xyz.
template <class T>
__device__ inline void rotate(const T* q, const T* v, T* o) {
  T uv[3], uuv[3];
  cross(q + 1, v, uv);
  cross(q + 1, uv, uuv);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = v[k] + 2.0f * (q[0] * uv[k] + uuv[k]);
}

// se3.compose: (normalize(a.q ⊗ b.q), R(a.q) b.t + a.t).
template <class T>
__device__ inline Pose<T> compose(const Pose<T>& a, const Pose<T>& b) {
  Pose<T> o;
  T q[4];
  qmul(a.q, b.q, q);
  const T n = norm_<4>(q);
#pragma unroll
  for (int k = 0; k < 4; ++k) o.q[k] = q[k] / n;
  rotate(a.q, b.t, o.t);
#pragma unroll
  for (int k = 0; k < 3; ++k) o.t[k] = o.t[k] + a.t[k];
  return o;
}

template <class T>
__device__ inline Pose<T> inverse(const Pose<T>& a) {
  Pose<T> o;
  o.q[0] = a.q[0];
  o.q[1] = -a.q[1];
  o.q[2] = -a.q[2];
  o.q[3] = -a.q[3];
  T t[3];
  rotate(o.q, a.t, t);
#pragma unroll
  for (int k = 0; k < 3; ++k) o.t[k] = -t[k];
  return o;
}

template <class T>
__device__ inline T dot3(const T* a) {
  return a[0] * a[0] + a[1] * a[1] + a[2] * a[2];
}

// se3.exp of the twist [ρ, φ], with so3.exp inside.
template <class T>
__device__ inline Pose<T> se3_exp(const T* xi) {
  const T* rho = xi;
  const T* phi = xi + 3;
  const T theta2 = dot3(phi);
  const T theta = sqrt_(clamp_min(theta2, kEps2));
  const bool small = val(theta2) < kEps;
  Pose<T> o;
  const T half = 0.5f * theta;
  const T k = small ? 0.5f - theta2 / 48.0f : sin_(half) / theta;
  o.q[0] = small ? 1.0f - theta2 / 8.0f : cos_(half);
#pragma unroll
  for (int m = 0; m < 3; ++m) o.q[m + 1] = k * phi[m];
  const T a = small ? 0.5f - theta2 / 24.0f : (1.0f - cos_(theta)) / theta2;
  const T b = small ? (1.0f / 6.0f) - theta2 / 120.0f : (theta - sin_(theta)) / (theta2 * theta);
  T cr[3], pcr[3];
  cross(phi, rho, cr);
  cross(phi, cr, pcr);
#pragma unroll
  for (int m = 0; m < 3; ++m) o.t[m] = rho[m] + a * cr[m] + b * pcr[m];
  return o;
}

// so3.log: the rotation vector of q, flipped to w ≥ 0.
template <class T>
__device__ inline void so3_log(const T* q_in, T* phi) {
  const float s = val(q_in[0]) < 0.f ? -1.0f : 1.0f;
  T q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = q_in[k] * s;
  const T w = clamp_(q[0], -1.0f, 1.0f);
  const T n = norm_<3>(q + 1);
  const bool small = val(n) < kEps;
  const T n_safe = small ? T(1.0f) : n;
  const T theta = 2.0f * atan2_(n, w);
  const T k = small ? 2.0f / clamp_min(w, 0.5f) : theta / n_safe;
#pragma unroll
  for (int m = 0; m < 3; ++m) phi[m] = k * q[m + 1];
}

// se3.log: the twist [ρ, φ] of a pose.
template <class T>
__device__ inline void se3_log(const Pose<T>& p, T* r) {
  T* phi = r + 3;
  so3_log(p.q, phi);
  const T theta2 = dot3(phi);
  const T theta = sqrt_(clamp_min(theta2, kEps2));
  const bool small = val(theta2) < kEps;
  const T half = 0.5f * theta;
  const T cot = small ? (1.0f / 12.0f) + theta2 / 720.0f
                      : (1.0f - half * cos_(half) / clamp_min(sin_(half), kEps)) /
                            clamp_min(theta2, kEps2);
  T cr[3], pcr[3];
  cross(phi, p.t, cr);
  cross(phi, cr, pcr);
#pragma unroll
  for (int m = 0; m < 3; ++m) r[m] = p.t[m] - 0.5f * cr[m] + cot * pcr[m];
}

template <class T>
__device__ inline Pose<T> load_pose(const float* q, const float* t) {
  Pose<T> p;
#pragma unroll
  for (int k = 0; k < 4; ++k) p.q[k] = T(q[k]);
#pragma unroll
  for (int k = 0; k < 3; ++k) p.t[k] = T(t[k]);
  return p;
}

// pose_graph._edge_residual at the twists xi_i, xi_j.
template <class T>
__device__ inline void edge_residual(const T* xi_i, const T* xi_j, const Pose<T>& Ti,
                                     const Pose<T>& Tj, const Pose<T>& Tij, T* r) {
  const Pose<T> Ti_p = compose(Ti, se3_exp(xi_i));
  const Pose<T> Tj_p = compose(Tj, se3_exp(xi_j));
  const Pose<T> rel = compose(inverse(Ti_p), Tj_p);
  se3_log(compose(inverse(Tij), rel), r);
}

struct Edges {
  const float* node_q;  // (K, 4)
  const float* node_t;  // (K, 3)
  const int64_t* ei;    // (E,)
  const int64_t* ej;
  const float* eq;      // (E, 4)
  const float* et;      // (E, 3)
  const bool* ev;       // (E,)
  const float* ew;      // (E,)
  int K, E;
  float c2;             // c²
};

__device__ inline float nan_() { return __int_as_float(0x7fc00000); }

__global__ void __launch_bounds__(kThreads)
    pgo_linearize_kernel(Edges g, float* __restrict__ r_out, float* __restrict__ Ji,
                         float* __restrict__ Jj, float* __restrict__ JiW,
                         float* __restrict__ JjW, float* __restrict__ w_out) {
  const long long gid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (gid >= static_cast<long long>(g.E) * kDirs) return;
  const int e = static_cast<int>(gid / kDirs);
  const int dir = static_cast<int>(gid - static_cast<long long>(e) * kDirs);
  const int col = dir % 6;
  float* J = (dir < 6 ? Ji : Jj) + static_cast<size_t>(e) * 36 + col;
  float* JW = (dir < 6 ? JiW : JjW) + static_cast<size_t>(e) * 36 + col;
  float* re = r_out + static_cast<size_t>(e) * 6;
  const int64_t i = g.ei[e], j = g.ej[e];
  if (i < 0 || i >= g.K || j < 0 || j >= g.K) {
    for (int k = 0; k < 6; ++k) J[k * 6] = JW[k * 6] = nan_();
    if (dir == 0) {
      for (int k = 0; k < 6; ++k) re[k] = nan_();
      w_out[e] = nan_();
    }
    return;
  }
  const Pose<Dual> Ti = load_pose<Dual>(g.node_q + 4 * i, g.node_t + 3 * i);
  const Pose<Dual> Tj = load_pose<Dual>(g.node_q + 4 * j, g.node_t + 3 * j);
  const Pose<Dual> Tij = load_pose<Dual>(g.eq + 4 * e, g.et + 3 * e);
  Dual xi[6], xj[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    xi[k] = Dual(0.f, dir == k ? 1.f : 0.f);
    xj[k] = Dual(0.f, dir == k + 6 ? 1.f : 0.f);
  }
  Dual r[6];
  edge_residual(xi, xj, Ti, Tj, Tij, r);
  float r2 = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) r2 += r[k].v * r[k].v;
  const float w = g.ev[e] ? 1.0f / (1.0f + r2 / g.c2) * g.ew[e] : 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    J[k * 6] = r[k].d;
    JW[k * 6] = r[k].d * w;
  }
  if (dir == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) re[k] = r[k].v;
    w_out[e] = w;
  }
}

__global__ void __launch_bounds__(kThreads) pgo_cost_kernel(Edges g, float* __restrict__ cost) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= g.E) return;
  const int64_t i = g.ei[e], j = g.ej[e];
  if (i < 0 || i >= g.K || j < 0 || j >= g.K) {
    cost[e] = nan_();
    return;
  }
  const Pose<float> Ti = load_pose<float>(g.node_q + 4 * i, g.node_t + 3 * i);
  const Pose<float> Tj = load_pose<float>(g.node_q + 4 * j, g.node_t + 3 * j);
  const Pose<float> Tij = load_pose<float>(g.eq + 4 * e, g.et + 3 * e);
  const float z[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float r[6];
  edge_residual(z, z, Ti, Tj, Tij, r);
  float r2 = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) r2 += r[k] * r[k];
  const float rho = g.c2 * log1pf(r2 / g.c2);
  cost[e] = g.ev[e] ? rho * g.ew[e] : 0.f;
}

}  // namespace

// mode 0 (linearize): r (E, 6), Ji, Jj, JiW, JjW (E, 6, 6), w (E,);
// mode 1 (cost): cost (E,), ρ·edge_weight an edge.  Pointers a mode does not
// write may be null.
extern "C" int flvis_pgo_edges(const float* node_q, const float* node_t, int K,
                               const int64_t* ei, const int64_t* ej, const float* eq,
                               const float* et, const bool* ev, const float* ew, int E, float c2,
                               int mode, float* r, float* Ji, float* Jj, float* JiW, float* JjW,
                               float* w, float* cost, cudaStream_t stream) {
  if (K <= 0 || E <= 0 || E > (1 << 27) || !(c2 > 0.f) || mode < 0 || mode > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Edges g{node_q, node_t, ei, ej, eq, et, ev, ew, K, E, c2};
  if (mode == 0) {
    if (!r || !Ji || !Jj || !JiW || !JjW || !w) return static_cast<int>(cudaErrorInvalidValue);
    const long long threads = static_cast<long long>(E) * kDirs;
    const unsigned grid = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    pgo_linearize_kernel<<<grid, kThreads, 0, stream>>>(g, r, Ji, Jj, JiW, JjW, w);
  } else {
    if (!cost) return static_cast<int>(cudaErrorInvalidValue);
    pgo_cost_kernel<<<(E + kThreads - 1) / kThreads, kThreads, 0, stream>>>(g, cost);
  }
  return static_cast<int>(cudaGetLastError());
}
