// BoW word assignment + term-frequency histogram — the Hopper counterpart
// of the TPU kernel flvis_tpu/ops/pallas/bowassign.py:bow_tf_pallas.
//
// For each valid descriptor d of keyframe b: its nearest word (lowest index
// among ties) and tf[b, word] += 1.  Descriptors and words are ±1 vectors of
// 256 entries, so the nearest word is the argmax of the ±1 product, as the
// TPU kernel computes it on its matrix unit (bowassign.py:60-68).  Here the
// product runs on the int8 tensor cores, exact in int32 (|sim| <= 256).
//
// Bound by operations: 2·B·N·V·256 int8 operations (16.8 G at B=8, N=1000,
// V=4096: 0.0085 ms at the data sheet's 1,979 TOP/s dense int8), against
// ~1.3 MB of packed descriptors and int8 words.  (The XOR + __popc form it
// replaces was held by the popcount pipe, 16 per SM per clock on sm_90.)
//
// Design: an integer GEMM with an argmax epilogue.
//   - One block owns 64 descriptors.  It unpacks their (64, 8) packed words
//     into int8 rows of ±8 (256 B each; the scale is the epilogue's) in
//     shared memory, and each of its 8 warps (2 along the descriptors x 4
//     along the words) loads its 32 rows once into registers as mma
//     fragments (ldmatrix), 64 registers a thread, kept for the whole
//     vocabulary.
//   - The block walks all V words in tiles of 128 ((V, 256) int8 ±1, the
//     Vocabulary's words_i8) through a 3-stage ring in shared memory filled
//     by cp.async from L2 (zero-filled past V), one barrier a tile.  Rows
//     of 256 B are kept in 16-byte chunks swizzled by (row & 7), so the
//     ldmatrix reads of 8 rows hit 32 distinct banks.
//   - Per tile and k-step of 32 (8 of them) each warp issues 2 ldmatrix.x4
//     for its 4 word fragments and 8 mma.sync.m16n8k32.s8 into 32 int32
//     accumulators (its 32 x 32 corner of the 64 x 128 tile).
//   - Epilogue, exact and order-free.  A thread holds 8 columns per row in
//     a tile; its accumulators start at 7 − (the column's rank in word
//     order), so with descriptors at ±8 each one ends as 8·sim + 7 − rank,
//     and one integer max over the 8 gives the tile's first maximum.  A
//     running (max, arg) per row carries across tiles with strict >; at the
//     end lanes (shuffles) and the 4 warps along the words (shared memory)
//     merge on (higher similarity, then lower word index) — torch.argmax's
//     first index among ties.  Valid descriptors add 1 to tf with an
//     integer atomicAdd.
//   - Grid and occupancy: ceil(B·N / 64) blocks of 256 threads, ~114 KB
//     of dynamic shared memory and 135 registers a thread (0 spills): one
//     block per SM, 8 warps, 2 per scheduler.  At (8, 1000, 4096) that is
//     125 blocks, one wave on 132 SMs.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md): 0.034 ms at
// (8, 1000, 4096), 4x the int8 bound.  One block alone takes as long, so
// each SM's own pace holds it, not L2 (which serves each block the whole
// 1 MB of words): ~2,070 cycles a tile for 128 mma.sync per scheduler.  A
// fragment prefetch and 4 warps per scheduler did not move it; the card's
// dense int8 rate is reached by wgmma, later work.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int BM = 64;                   // descriptors per block
constexpr int BN = 128;                  // words per tile
constexpr int K = 256;                   // bytes per ±1 row
constexpr int WM = 2, WN = 4;            // warps along descriptors, along words
constexpr int NT = WM * WN * 32;
constexpr int STAGES = 3;                // word tiles in flight
constexpr int SMEM_A = BM * K;           // 16 KB
constexpr int SMEM_B = BN * K;           // 32 KB per stage
constexpr int SMEM = SMEM_A + STAGES * SMEM_B + 2 * WN * BM * 4;

// Byte offset of 16-byte chunk ch of row r in a swizzled [rows][256] tile.
__device__ __forceinline__ int swz(int r, int ch) { return r * K + ((ch ^ (r & 7)) << 4); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four bits → four bytes, +8 for a set bit and -8 (0xF8) for a clear one:
// the descriptors enter the product scaled by 8 (see the epilogue).
__device__ __forceinline__ uint32_t pm8_bytes(uint32_t n) {
  const uint32_t b = (n & 1u) | ((n & 2u) << 7) | ((n & 4u) << 14) | ((n & 8u) << 21);
  return 0xF8F8F8F8u ^ (b * 0xF0u);
}

// Words [t·BN, t·BN + BN) of the (V, 256) int8 vocabulary into one buffer;
// rows past V are zero-filled (and masked in the epilogue).
__device__ __forceinline__ void load_tile(const int8_t* __restrict__ words, int V, int t,
                                          uint8_t* buf, int tid) {
  for (int i = tid; i < BN * 16; i += NT) {
    const int r = i >> 4, ch = i & 15;
    const int w = t * BN + r;
    const int8_t* src = words + static_cast<size_t>(w < V ? w : V - 1) * K + ch * 16;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(buf + swz(r, ch))),
                 "l"(src), "r"(w < V ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ bool better(int s, int a, int bs, int ba) {
  return s > bs || (s == bs && a < ba);
}

__global__ void __launch_bounds__(NT, 1)
    bowassign_kernel(const uint32_t* __restrict__ desc, const uint8_t* __restrict__ valid,
                     const int8_t* __restrict__ words, int* __restrict__ tf, int total, int N,
                     int V) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sA = smem;
  uint8_t* sB = smem + SMEM_A;
  int* sbest = reinterpret_cast<int*>(smem + SMEM_A + STAGES * SMEM_B);   // [WN][BM]
  int* sarg = sbest + WN * BM;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int wm = wid & 1, wn = wid >> 1;
  const int g = lane >> 2, tig = lane & 3;
  const int d0 = blockIdx.x * BM;
  const int T = (V + BN - 1) / BN;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < T) load_tile(words, V, t, sB + t * SMEM_B, tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // The block's descriptors as ±8 int8 rows: one (row, packed word) a step,
  // 32 bits → two 16-byte chunks.  Rows past the end are all -8, never counted.
  for (int i = tid; i < BM * 8; i += NT) {
    const int r = i >> 3, w = i & 7;
    const uint32_t x = d0 + r < total ? desc[static_cast<size_t>(d0 + r) * 8 + w] : 0u;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t h = x >> (16 * q);
      *reinterpret_cast<uint4*>(sA + swz(r, 2 * w + q)) =
          make_uint4(pm8_bytes(h & 15u), pm8_bytes((h >> 4) & 15u), pm8_bytes((h >> 8) & 15u),
                     pm8_bytes((h >> 12) & 15u));
    }
  }
  __syncthreads();

  // A fragments of the warp's 32 rows, all 8 k-steps, kept in registers.
  uint32_t a[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int r = wm * 32 + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(smem_addr(sA + swz(r, 2 * ks + (lane >> 4))), a[mi][ks][0], a[mi][ks][1],
                  a[mi][ks][2], a[mi][ks][3]);
    }

  int best[4], arg[4];                  // rows wm*32 + mi*16 + h*8 + g, slot mi*2 + h
#pragma unroll
  for (int s = 0; s < 4; ++s) best[s] = INT_MIN, arg[s] = INT_MAX;

  for (int t = 0; t < T; ++t) {
    // Tile t has landed (at most STAGES - 2 younger groups pending) and every
    // warp is done with tile t - 1, whose stage the load of t + 2 reuses.
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    if (t + STAGES - 1 < T)
      load_tile(words, V, t + STAGES - 1, sB + ((t + STAGES - 1) % STAGES) * SMEM_B, tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const uint8_t* buf = sB + (t % STAGES) * SMEM_B;
    // Each thread holds 8 columns per row, of rank ni·2 + j in word order.
    // With descriptors at ±8 and the accumulator started at 7 − rank, the
    // product gives the key 8·sim + 7 − rank: its maximum is the highest
    // similarity, then the lowest rank — the first maximum — in one integer
    // max per column.
    int acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 7 - (ni * 2 + (e & 1));
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int r = wn * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(smem_addr(buf + swz(r, 2 * ks + ((lane >> 3) & 1))), b[2 * np][0],
                    b[2 * np][1], b[2 * np + 1][0], b[2 * np + 1][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi][ks], b[ni][0], b[ni][1]);
    }
    // The thread's words: wb + ni·8 + j.  Tiles come in increasing word
    // order and a later tile replaces the running best only on strict >.
    const int wb = t * BN + wn * 32 + tig * 2;
    const bool whole = (t + 1) * BN <= V;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = mi * 2 + h;
        if (whole) {
          int k = acc[mi][0][h * 2];
#pragma unroll
          for (int e = 1; e < 8; ++e) k = max(k, acc[mi][e >> 1][h * 2 + (e & 1)]);
          const int rank = 7 - (k & 7);
          if ((k >> 3) > best[s]) best[s] = k >> 3, arg[s] = wb + (rank >> 1) * 8 + (rank & 1);
        } else {                        // the last, partial tile: words >= V masked
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int col = wb + (e >> 1) * 8 + (e & 1), v = acc[mi][e >> 1][h * 2 + (e & 1)] >> 3;
            if (col < V && v > best[s]) best[s] = v, arg[s] = col;
          }
        }
      }
  }

  // Merge the 4 lanes of a row group, then the WN warps along the words.
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const int ob = __shfl_xor_sync(0xffffffffu, best[s], off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[s], off);
      if (better(ob, oa, best[s], arg[s])) best[s] = ob, arg[s] = oa;
    }
    if (tig == 0) {
      const int row = wm * 32 + (s >> 1) * 16 + (s & 1) * 8 + g;
      sbest[wn * BM + row] = best[s];
      sarg[wn * BM + row] = arg[s];
    }
  }
  __syncthreads();
  if (tid < BM && d0 + tid < total && valid[d0 + tid]) {
    int bs = sbest[tid], ba = sarg[tid];
#pragma unroll
    for (int w = 1; w < WN; ++w)
      if (better(sbest[w * BM + tid], sarg[w * BM + tid], bs, ba))
        bs = sbest[w * BM + tid], ba = sarg[w * BM + tid];
    const int d = d0 + tid;
    atomicAdd(&tf[static_cast<size_t>(d / N) * V + ba], 1);
  }
}

}  // namespace

extern "C" int flvis_bow_tf(const uint32_t* desc, const uint8_t* valid, const int8_t* words_i8,
                            int* tf, int B, int N, int V, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || V <= 0 || static_cast<long long>(B) * N > INT_MAX - BM)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      cudaFuncSetAttribute(bowassign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int total = B * N;
  bowassign_kernel<<<(total + BM - 1) / BM, NT, SMEM, stream>>>(desc, valid, words_i8, tf,
                                                                total, N, V);
  return static_cast<int>(cudaGetLastError());
}
