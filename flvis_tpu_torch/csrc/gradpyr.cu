// Fused Scharr gradients + 5-tap binomial pyrDown blur of a (B, H, W)
// float32 stack — the Hopper counterpart of the TPU kernel
// flvis_tpu/ops/pallas/gradpyr.py:grad_blur_pallas.
//
// One block per TX x TY output tile of one image (B on gridDim.z).  The
// block stages the tile plus a 2-pixel halo in shared memory, reading the
// global image at CLAMPED coordinates: that is the edge-replicate border,
// so no padded copy of the image is ever written.  Every thread then
// emits gx, gy and blur5 for its pixel from the staged tile.
//
// Taps and order follow ops/image._sep_filter as the reference runs it:
//   gx = smooth_y(diff_x(img)),  gy = diff_y(smooth_x(img)),
//   blur5 = k5_y(k5_x(img)),  smooth = [3, 10, 3]/32, diff = [-1, 0, 1],
//   k5 = [1, 4, 6, 4, 1]/16.
// Staging a pre-padded tile equals pad-x / filter-x / pad-y / filter-y
// because edge-replicated rows x-filter into edge-replicated rows.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 16;
constexpr int HALO = 2;
constexpr int SX = TX + 2 * HALO;
constexpr int SY = TY + 2 * HALO;

__global__ void grad_blur_kernel(const float* __restrict__ img, float* __restrict__ gx,
                                 float* __restrict__ gy, float* __restrict__ blur,
                                 int H, int W) {
  __shared__ float s[SY][SX + 1];
  const size_t plane = static_cast<size_t>(H) * W;
  const float* src = img + blockIdx.z * plane;
  const int x0 = blockIdx.x * TX - HALO;
  const int y0 = blockIdx.y * TY - HALO;
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int i = tid; i < SY * SX; i += TX * TY) {
    const int r = i / SX, c = i % SX;
    const int gyy = min(max(y0 + r, 0), H - 1);
    const int gxx = min(max(x0 + c, 0), W - 1);
    s[r][c] = src[static_cast<size_t>(gyy) * W + gxx];
  }
  __syncthreads();

  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int r = threadIdx.y + HALO;  // centre in tile coordinates
  const int c = threadIdx.x + HALO;

  const float s0 = 3.0f / 32.0f, s1 = 10.0f / 32.0f;
  // Scharr gx: x-difference, then y-smoothing.
  const float dxm = s[r - 1][c + 1] - s[r - 1][c - 1];
  const float dx0 = s[r][c + 1] - s[r][c - 1];
  const float dxp = s[r + 1][c + 1] - s[r + 1][c - 1];
  const float vgx = dxm * s0 + dx0 * s1 + dxp * s0;
  // Scharr gy: x-smoothing, then y-difference.
  const float smm = s[r - 1][c - 1] * s0 + s[r - 1][c] * s1 + s[r - 1][c + 1] * s0;
  const float smp = s[r + 1][c - 1] * s0 + s[r + 1][c] * s1 + s[r + 1][c + 1] * s0;
  const float vgy = smp - smm;
  // 5-tap binomial blur: x pass per row, then y pass.
  const float k[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f, 1.0f / 16.0f};
  float vb = 0.0f;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const float* row = s[r - 2 + j];
    const float bx = row[c - 2] * k[0] + row[c - 1] * k[1] + row[c] * k[2] +
                     row[c + 1] * k[3] + row[c + 2] * k[4];
    vb += bx * k[j];
  }
  const size_t o = blockIdx.z * plane + static_cast<size_t>(y) * W + x;
  gx[o] = vgx;
  gy[o] = vgy;
  blur[o] = vb;
}

}  // namespace

extern "C" int flvis_grad_blur(const float* img, float* gx, float* gy, float* blur,
                               int B, int H, int W, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  grad_blur_kernel<<<grid, block, 0, stream>>>(img, gx, gy, blur, H, W);
  return static_cast<int>(cudaGetLastError());
}
