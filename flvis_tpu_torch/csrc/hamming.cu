// Hamming distances between packed 256-bit ORB descriptors, and the
// loop node's mutual-ratio matcher over a bucket of candidate pairs — the
// Hopper counterpart of the TPU kernel
// flvis_tpu/ops/pallas/hamming.py:hamming_matrix_pallas and of its only
// caller, flvis_tpu/ops/orb.py:mutual_ratio_match.
//
// Descriptors are (N, 8) uint32 bit patterns (int32 tensors).  Both modes
// are integer and exact.
//
// The distances run on the tensor cores' binary path, the TPU kernel's own
// idea (a ±1 product on its matrix unit) in Hopper's terms: mma.sync
// m16n8k256 .b1 with .and.popc takes the packed words as they are, no
// unpacking, and popc(a & ~b) + popc(~a & b) = popc(a ^ b) is two mma into
// one accumulator.  On the H100 .and.popc issues at the int8 m16n8k32
// path's rate, 8x the bits a product, and .xor.popc is emulated, an order
// of magnitude slower (utils/mma_rates.py; PERF.md).  The XOR +
// __popc form would be held by the popcount pipe (16 a clock per SM: 8 per
// distance, ~1.9 µs at 1000 x 1000 on 132 SMs).  Each warp owns a 32 x 32
// tile of 2 x 4 fragments: its A rows' words (and complements) in
// registers, 16 mma a tile.
//
// Matrix mode (hamming_kernel): A (Na, 8) x B (Nb, 8) → (Na, Nb) int32, the
// TPU kernel's function.  Bound by its output: 1000² int32 distances are
// 4 MB to write (1.2 µs at 3.35 TB/s) against 64 KB of descriptors.  One
// block of 8 warps per 64 x 128 output tile, B's words straight from
// global memory (128 blocks at 1000 x 1000, one wave on 132 SMs); each
// store instruction of a warp writes 8 rows x 32 contiguous bytes.
//
// Match mode (hamming_match_kernel, one launch a bucket): B pairs (a, b)
// of keyframes, desc_a (B, Na, 8), desc_b (B, Nb, 8), validity (B, Na),
// (B, Nb).  Per pair, with d = 512 where either side is invalid:
//   best_ab, d1, d2  the two smallest of each row, lowest index first among
//                    ties (lax.top_k's order);
//   best_ba          the column argmin, first index among ties;
//   good             valid_a & best_ba[best_ab] == i & d1 <= max_distance
//                    & float(d1) < ratio · float(max(d2, 1)) in float32.
// The (B, Na, Nb) matrix never leaves the SMs.
//   - An invalid row enters as zero words with its accumulator started at
//     512, so it reads 512 against every column.
//   - Keys (d << 21) | index order (distance, then index), so a row's top 2
//     is a plain min/max network over its keys, exact and independent of
//     the order the columns come in; a column's argmin is the min of
//     (d << 21) | row.  A distance takes 10 bits (0..512), so the keys stay
//     below 2^31 and INT_MAX stays above every key; hence Na, Nb ≤
//     2,097,150 (21 bits; the all-ones index marks a padding row).
//   - One block of 16 warps (2 along the rows x 8 along the columns) owns
//     64 rows of one pair and walks all of its B, staged in shared memory
//     1024 columns at a time (all of B at 1000: one global round trip;
//     loading tile by tile left a round trip a tile exposed), two tiles of
//     256 columns at a time: 32 products in flight a warp before either
//     tile's epilogue.  The row top 2 stays in registers; each tile's
//     column minima over a warp's 32 rows leave through a 7-shuffle
//     butterfly, one integer atomicMin a lane into the pair's column keys
//     (INT_MAX on entry).
//   - The last of a pair's blocks to finish (an integer ticket a pair,
//     schur.cu's pattern) reads best_ba off the column keys, resets them to
//     INT_MAX, and forms good: one launch a bucket, no host read.  Tickets
//     and keys are the caller's scratch, left as they came.
//   Bound: B·Na·Nb·512 binary operations, counted as int8 work at the data
//   sheet's 1,979 TOP/s as for bowassign (2.1 µs for 8 pairs of 1000), the
//   bytes (0.7 MB) well below.  What holds it (PERF.md): the launch, row
//   loads and stores that any such kernel pays, the last block's tail
//   (fence, ticket, two round trips), and a tile loop that runs at about a
//   quarter of the binary path's rate.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int BM = 64;                   // A rows per block
constexpr int WM = 2;                    // warps along the rows (32 rows each)
constexpr int MX_WN = 4;                 // matrix mode: warps along the columns
constexpr int MT_WN = 8;                 // match mode: warps along the columns
constexpr int FAR = 512;                 // the distance of a pair with an invalid side
constexpr int IDX_BITS = 21;             // match mode: the index field of a key
constexpr int IDX_MASK = (1 << IDX_BITS) - 1;
constexpr int NO_ROW = IDX_MASK;         // the row index of a padding row

// d = c + popc(a & b) over 256 bits, and d += popc(a & b): A 16 x 256 (a0:
// row g, bits 32·tig..; a1: row g + 8; a2, a3: the same rows, bits
// 128 + 32·tig..), B 256 x 8 (b0: column g, bits 32·tig..; b1: bits
// 128 + 32·tig..), D 16 x 8 (d0, d1: row g, columns 2·tig, 2·tig + 1; d2,
// d3: row g + 8), with g = lane / 4, tig = lane % 4.
__device__ __forceinline__ void mma_and_popc(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1, int c01, int c23) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %11, %11};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(c01), "r"(c23));
}

__device__ __forceinline__ void mma_and_popc_acc(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                                 uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 32 rows as mma fragments, slot s = mi·2 + h holding row
// r0 + mi·16 + h·8 + g: the words as they are and their complements.  A
// row past na or invalid (valid given and 0) enters as zero words with its
// accumulator started at FAR, so it reads FAR against every column.
struct Rows {
  uint32_t a[2][4], an[2][4];
  int acc0[4], id[4];
};

__device__ __forceinline__ void load_rows(Rows& f, const uint32_t* __restrict__ desc,
                                          const uint8_t* __restrict__ valid, int na, int r0,
                                          int g, int tig) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = r0 + mi * 16 + h * 8 + g;
      // The three loads go out together; validity selects afterwards.
      uint32_t lo = i < na ? __ldg(desc + static_cast<size_t>(i) * 8 + tig) : 0u;
      uint32_t hi = i < na ? __ldg(desc + static_cast<size_t>(i) * 8 + 4 + tig) : 0u;
      const bool ok = i < na && (valid == nullptr || __ldg(valid + i));
      lo = ok ? lo : 0u, hi = ok ? hi : 0u;
      f.a[mi][h] = lo, f.a[mi][2 + h] = hi;
      f.an[mi][h] = ok ? ~lo : 0u, f.an[mi][2 + h] = ok ? ~hi : 0u;
      f.acc0[mi * 2 + h] = ok ? 0 : FAR;
      f.id[mi * 2 + h] = i < na ? i : NO_ROW;
    }
}

// A warp's 32 columns c0.. as mma fragments (words tig and tig + 4 of
// columns c0 + ni·8 + g; zero past n) and, in match mode, the validity
// bytes of the thread's accumulator columns c0 + ni·8 + 2·tig + q (0 past n).
struct Cols {
  uint32_t w[4][2];
  uint32_t v[4][2];
};

// Matrix mode: the words straight from global memory.
__device__ __forceinline__ void load_cols(Cols& f, const uint32_t* __restrict__ desc, int n,
                                          int c0, int g, int tig) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int c = c0 + ni * 8 + g;
    f.w[ni][0] = c < n ? __ldg(desc + static_cast<size_t>(c) * 8 + tig) : 0u;
    f.w[ni][1] = c < n ? __ldg(desc + static_cast<size_t>(c) * 8 + 4 + tig) : 0u;
  }
}

// Match mode: words and validity from the chunk staged in shared memory (n
// columns of it, local indices).
__device__ __forceinline__ void stage_cols(Cols& f, const uint32_t* sw, const uint8_t* sv, int n,
                                           int c0, int g, int tig) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int c = c0 + ni * 8 + g;
    f.w[ni][0] = c < n ? sw[c * 8 + tig] : 0u;
    f.w[ni][1] = c < n ? sw[c * 8 + 4 + tig] : 0u;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = c0 + ni * 8 + tig * 2 + q;
      f.v[ni][q] = e < n ? sv[e] : 0u;
    }
  }
}

// The warp's 32 x 32 distances: popc(a & ~b) + popc(~a & b) = popc(a ^ b),
// two mma into one accumulator (the binary path has .and.popc at the int8
// path's instruction rate; .xor.popc is not native on sm_90).
__device__ __forceinline__ void distances(int (&acc)[2][4][4], const Rows& A, const Cols& B) {
  // All eight first products, then the second ones: one mma latency a
  // tile, not eight.
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      mma_and_popc(acc[mi][ni], A.a[mi], ~B.w[ni][0], ~B.w[ni][1], A.acc0[mi * 2],
                   A.acc0[mi * 2 + 1]);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      mma_and_popc_acc(acc[mi][ni], A.an[mi], B.w[ni][0], B.w[ni][1]);
}

// ---------------------------------------------------------------- matrix mode
constexpr int MX_NT = WM * MX_WN * 32;
constexpr int MX_BN = MX_WN * 32;        // columns per block

__global__ void __launch_bounds__(MX_NT)
    hamming_kernel(const uint32_t* __restrict__ desc_a, const uint32_t* __restrict__ desc_b,
                   int* __restrict__ out, int na, int nb) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int wm = wid % WM, wn = wid / WM, g = lane >> 2, tig = lane & 3;
  const int r0 = blockIdx.y * BM + wm * 32, c0 = blockIdx.x * MX_BN + wn * 32;
  Rows A;
  Cols B;
  load_rows(A, desc_a, nullptr, na, r0, g, tig);
  load_cols(B, desc_b, nb, c0, g, tig);
  int acc[2][4][4];
  distances(acc, A, B);
  // Each store instruction of a warp writes 8 rows x 32 contiguous bytes.
  const bool pairs = (nb & 1) == 0;      // then (row, even column) is 8-byte aligned
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = r0 + mi * 16 + h * 8 + g;
      if (i >= na) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int j = c0 + ni * 8 + tig * 2;
        int* o = out + static_cast<size_t>(i) * nb + j;
        if (pairs && j + 1 < nb) {
          *reinterpret_cast<int2*>(o) = make_int2(acc[mi][ni][h * 2], acc[mi][ni][h * 2 + 1]);
        } else {
          if (j < nb) o[0] = acc[mi][ni][h * 2];
          if (j + 1 < nb) o[1] = acc[mi][ni][h * 2 + 1];
        }
      }
    }
}

// ----------------------------------------------------------------- match mode
constexpr int MT_NT = WM * MT_WN * 32;
constexpr int MT_BN = MT_WN * 32;        // columns per tile
constexpr int CH = 1024;                 // columns staged in shared memory at a time

// The two smallest of two sorted pairs (a1 <= a2, b1 <= b2; keys distinct).
__device__ __forceinline__ void merge2(int& a1, int& a2, int b1, int b2) {
  const int hi = max(a1, b1);
  a1 = min(a1, b1);
  a2 = min(hi, min(a2, b2));
}

// The distances acc of a warp's 32 columns from c0 against its rows: the
// row top 2 (m1, m2) updated, the column minima over the 32 rows folded
// into the pair's column keys CK with an integer atomicMin (order-free,
// exact).
__device__ __forceinline__ void match_tile(const int (&acc)[2][4][4], const Rows& A,
                                           const Cols& B, int c0, int nb, int (&m1)[4],
                                           int (&m2)[4], int* __restrict__ CK, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  // Keys (d << 21) | column, one multiply-add each: d = FAR for an invalid
  // column, INT_MAX past nb.  Column keys (d << 21) | row.
  int cmin[8];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = c0 + ni * 8 + tig * 2 + q;
      const bool ok = B.v[ni][q] != 0u;
      const int cm = ok ? 1 << IDX_BITS : 0;
      const int cc = col >= nb ? INT_MAX : (ok ? col : (FAR << IDX_BITS) | col);
      int cmk = INT_MAX;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = mi * 2 + h;
          const int key = acc[mi][ni][h * 2 + q] * cm + cc;
          m2[s] = min(m2[s], max(m1[s], key));
          m1[s] = min(m1[s], key);
          cmk = min(cmk, (key & ~IDX_MASK) | A.id[s]);
        }
      cmin[ni * 2 + q] = cmk;
    }
  // Column minima over the warp's 32 rows: the 8 lanes of one tig hold the
  // same 8 columns; a butterfly halves the columns a lane keeps at each of
  // 3 steps, leaving lane (g, tig) with column k = g.
  const bool b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
  int w4[4], w2[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int send = b4 ? cmin[k] : cmin[k + 4], keep = b4 ? cmin[k + 4] : cmin[k];
    w4[k] = min(keep, __shfl_xor_sync(0xffffffffu, send, 16));
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int send = b3 ? w4[k] : w4[k + 2], keep = b3 ? w4[k + 2] : w4[k];
    w2[k] = min(keep, __shfl_xor_sync(0xffffffffu, send, 8));
  }
  const int send = b2 ? w2[0] : w2[1], keep = b2 ? w2[1] : w2[0];
  const int v = min(keep, __shfl_xor_sync(0xffffffffu, send, 4));
  const int col = c0 + (g >> 1) * 8 + tig * 2 + (g & 1);
  if (col < nb) atomicMin(CK + col, v);
}

__global__ void __launch_bounds__(MT_NT)
    hamming_match_kernel(const uint32_t* __restrict__ desc_a, const uint32_t* __restrict__ desc_b,
                         const uint8_t* __restrict__ valid_a, const uint8_t* __restrict__ valid_b,
                         long long* __restrict__ best_ab, int* __restrict__ d1,
                         int* __restrict__ d2, long long* __restrict__ best_ba,
                         uint8_t* __restrict__ good, int* __restrict__ colkey,
                         unsigned int* __restrict__ tickets, int na, int nb, float ratio,
                         int max_distance) {
  __shared__ __align__(16) uint32_t sw[CH * 8];
  __shared__ uint8_t sv[CH];
  __shared__ int smerge[MT_WN][BM][2];
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int wm = wid % WM, wn = wid / WM, g = lane >> 2, tig = lane & 3;
  const int pair = blockIdx.y, i0 = blockIdx.x * BM;
  const uint32_t* Bd = desc_b + static_cast<size_t>(pair) * nb * 8;
  const uint8_t* VB = valid_b + static_cast<size_t>(pair) * nb;
  int* CK = colkey + static_cast<size_t>(pair) * nb;

  Rows A;
  load_rows(A, desc_a + static_cast<size_t>(pair) * na * 8,
            valid_a + static_cast<size_t>(pair) * na, na, i0 + wm * 32, g, tig);
  int m1[4], m2[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) m1[s] = m2[s] = INT_MAX;
  // B in chunks of CH columns staged in shared memory (one chunk at
  // Nb ≤ 1024: one global round trip for all of it), then its tiles.
  for (int k0 = 0; k0 < nb; k0 += CH) {
    const int len = min(CH, nb - k0);
    __syncthreads();                     // the last chunk's readers are done
    const uint4* src = reinterpret_cast<const uint4*>(Bd + static_cast<size_t>(k0) * 8);
#pragma unroll 4
    for (int p = tid; p < 2 * len; p += MT_NT) reinterpret_cast<uint4*>(sw)[p] = __ldg(src + p);
#pragma unroll 2
    for (int j = tid; j < len; j += MT_NT) sv[j] = VB[k0 + j];
    __syncthreads();
    // Two tiles at a time: 32 products in flight a warp before either
    // tile's epilogue.
    for (int t0 = wn * 32; t0 < len; t0 += 2 * MT_BN) {
      Cols c[2];
      int acc[2][2][4][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        stage_cols(c[u], sw, sv, len, t0 + u * MT_BN, g, tig);
        distances(acc[u], A, c[u]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
        match_tile(acc[u], A, c[u], k0 + t0 + u * MT_BN, nb, m1, m2, CK, lane);
    }
  }

  // The row top 2: across the 4 lanes of a row, then across the warps along
  // the columns.
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      merge2(m1[s], m2[s], __shfl_xor_sync(0xffffffffu, m1[s], off),
             __shfl_xor_sync(0xffffffffu, m2[s], off));
  if (tig == 0)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int r = wm * 32 + (s >> 1) * 16 + (s & 1) * 8 + g;
      smerge[wn][r][0] = m1[s];
      smerge[wn][r][1] = m2[s];
    }
  __syncthreads();
  if (tid < BM && i0 + tid < na) {
    int k1 = smerge[0][tid][0], k2 = smerge[0][tid][1];
#pragma unroll
    for (int w = 1; w < MT_WN; ++w) merge2(k1, k2, smerge[w][tid][0], smerge[w][tid][1]);
    const size_t o = static_cast<size_t>(pair) * na + i0 + tid;
    best_ab[o] = k1 & IDX_MASK;
    d1[o] = k1 >> IDX_BITS;
    d2[o] = k2 >> IDX_BITS;
  }

  // The pair's last block to finish (an integer ticket a pair, 0 on entry
  // and left 0) forms best_ba from the column keys, leaving them INT_MAX
  // again, then good from every block's rows.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(tickets + pair, 1u) == gridDim.x - 1;
    if (s_last) tickets[pair] = 0u;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // best_ba also goes to shared memory (the staged words' space, done
  // with) when it fits, for the rows' lookups.
  long long* BA = best_ba + static_cast<size_t>(pair) * nb;
  int* sba = reinterpret_cast<int*>(sw);
  const bool local = nb <= CH * 8;
#pragma unroll 2
  for (int j = tid; j < nb; j += MT_NT) {
    const int r = __ldcg(CK + j) & IDX_MASK;
    BA[j] = r;
    if (local) sba[j] = r;
    CK[j] = INT_MAX;
  }
  __syncthreads();
#pragma unroll 2
  for (int i = tid; i < na; i += MT_NT) {
    const size_t k = static_cast<size_t>(pair) * na + i;
    const int j = static_cast<int>(__ldcg(best_ab + k)), e1 = __ldcg(d1 + k), e2 = __ldcg(d2 + k);
    const int back = local ? sba[j] : static_cast<int>(BA[j]);
    good[k] = valid_a[k] && back == i && e1 <= max_distance &&
              static_cast<float>(e1) < __fmul_rn(ratio, static_cast<float>(max(e2, 1)));
  }
}

}  // namespace

extern "C" int flvis_hamming_matrix(const uint32_t* desc_a, const uint32_t* desc_b, int* out,
                                    int na, int nb, cudaStream_t stream) {
  if (na <= 0 || nb <= 0 || (na + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nb + MX_BN - 1) / MX_BN, (na + BM - 1) / BM);
  hamming_kernel<<<grid, MX_NT, 0, stream>>>(desc_a, desc_b, out, na, nb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flvis_hamming_match(const uint32_t* desc_a, const uint32_t* desc_b,
                                   const uint8_t* valid_a, const uint8_t* valid_b,
                                   long long* best_ab, int* d1, int* d2, long long* best_ba,
                                   uint8_t* good, int* colkey, unsigned int* tickets, int B, int na,
                                   int nb, float ratio, int max_distance, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || na <= 0 || na >= NO_ROW || nb < 2 || nb >= NO_ROW)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((na + BM - 1) / BM, B);
  hamming_match_kernel<<<grid, MT_NT, 0, stream>>>(desc_a, desc_b, valid_a, valid_b, best_ab, d1,
                                                  d2, best_ba, good, colkey, tickets, na, nb, ratio,
                                                  max_distance);
  return static_cast<int>(cudaGetLastError());
}
