// BoW word assignment + term-frequency histogram — the Hopper counterpart
// of the TPU kernel flvis_tpu/ops/pallas/bowassign.py:bow_tf_pallas.
//
// For each valid descriptor d of keyframe b: its nearest word (lowest index
// among ties) and tf[b, word] += 1.  Words are ±1 centroids, so the TPU's
// "argmax of the ±1 product" equals "argmin of the Hamming distance"
// (similarity = 256 − 2·Hamming); the GPU form is XOR + __popc over the 8
// packed words, as csrc/hamming.cu.
//
// Bound by operations: B·N·V·8 XOR + POPC pairs (0.26 G at B=8, N=1000,
// V=4096) against ~1.3 MB of descriptors and words.  The whole packed
// vocabulary (V·32 B, 128 KB at V=4096) is staged once per block in opt-in
// dynamic shared memory, transposed to [8][V] so the 32 lanes of a warp
// read 32 consecutive words of one bit-slice without bank conflicts.  One
// warp per descriptor: each lane keeps a running (min, argmin) over words
// lane, lane+32, ... with strict <, then a warp shuffle reduction takes the
// smaller distance and, on ties, the lower index.  Blocks are persistent
// (at most one per SM) and walk the descriptors grid-stride.  The histogram
// is an integer atomicAdd into the (B, V) int32 counts, exact and
// independent of order.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int WARPS = 32;

__global__ void bowassign_kernel(const uint32_t* __restrict__ desc,
                                 const uint8_t* __restrict__ valid,
                                 const uint32_t* __restrict__ words, int* __restrict__ tf,
                                 int total, int N, int V) {
  extern __shared__ uint32_t sw[];  // [8][V]
  for (int i = threadIdx.x; i < 8 * V; i += blockDim.x) {
    const int w = i / 8, k = i % 8;
    sw[k * V + w] = words[i];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int d = blockIdx.x * WARPS + warp; d < total; d += gridDim.x * WARPS) {
    if (!valid[d]) continue;  // uniform across the warp
    const uint32_t mine = lane < 8 ? desc[static_cast<size_t>(d) * 8 + lane] : 0u;
    uint32_t q[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) q[k] = __shfl_sync(0xffffffffu, mine, k);
    int best = INT_MAX, arg = INT_MAX;
    for (int w = lane; w < V; w += 32) {
      int dist = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) dist += __popc(sw[k * V + w] ^ q[k]);
      if (dist < best) {
        best = dist;
        arg = w;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ob = __shfl_down_sync(0xffffffffu, best, off);
      const int oa = __shfl_down_sync(0xffffffffu, arg, off);
      if (ob < best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
    if (lane == 0) atomicAdd(&tf[static_cast<size_t>(d / N) * V + arg], 1);
  }
}

}  // namespace

extern "C" int flvis_bow_tf(const uint32_t* desc, const uint8_t* valid, const uint32_t* words,
                            int* tf, int B, int N, int V, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = V * 8 * static_cast<int>(sizeof(uint32_t));
  cudaError_t e = cudaFuncSetAttribute(bowassign_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  const int total = B * N;
  const int want = (total + WARPS - 1) / WARPS;
  const int blocks = want < sms ? want : sms;
  bowassign_kernel<<<blocks, WARPS * 32, smem, stream>>>(desc, valid, words, tf, total, N, V);
  return static_cast<int>(cudaGetLastError());
}
