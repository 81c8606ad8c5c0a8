// Pairwise Hamming distances between packed 256-bit descriptors — the
// Hopper counterpart of the TPU kernel
// flvis_tpu/ops/pallas/hamming.py:hamming_matrix_pallas.
//
// The TPU formulation is a ±1 matmul, (256 − a·b)/2, because its matrix
// unit is the fast path; on Hopper the direct form is XOR + __popc over the
// 8 words.  One block per T x T output tile: the T rows of A and of B (8
// words each) are staged in shared memory, and each thread produces one
// distance from 8 XOR/POPC pairs.  Writes are coalesced along B.
// A (Na, 8), B (Nb, 8) uint32 bit patterns (int32 tensors) → out (Na, Nb)
// int32.  The result is exact.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int T = 16;

__global__ void hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                               int* __restrict__ out, int na, int nb) {
  __shared__ uint32_t sa[T][9];
  __shared__ uint32_t sb[T][9];
  const int i0 = blockIdx.y * T, j0 = blockIdx.x * T;
  const int tid = threadIdx.y * T + threadIdx.x;
  for (int k = tid; k < T * 8; k += T * T) {
    const int r = k / 8, w = k % 8;
    sa[r][w] = (i0 + r < na) ? a[static_cast<size_t>(i0 + r) * 8 + w] : 0u;
    sb[r][w] = (j0 + r < nb) ? b[static_cast<size_t>(j0 + r) * 8 + w] : 0u;
  }
  __syncthreads();
  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  if (i >= na || j >= nb) return;
  int d = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) d += __popc(sa[threadIdx.y][w] ^ sb[threadIdx.x][w]);
  out[static_cast<size_t>(i) * nb + j] = d;
}

}  // namespace

extern "C" int flvis_hamming_matrix(const uint32_t* a, const uint32_t* b, int* out, int na,
                                    int nb, cudaStream_t stream) {
  if (na <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(T, T);
  const dim3 grid((nb + T - 1) / T, (na + T - 1) / T);
  hamming_kernel<<<grid, block, 0, stream>>>(a, b, out, na, nb);
  return static_cast<int>(cudaGetLastError());
}
