// AdaCoF warp forward (K1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fmvfi_tpu/ops/adacof_pallas.py::_kernel
// (launched through _warp_pallas_planar / adacof_warp_pallas).  It computes,
// for every image b, channel c and output pixel (i, j):
//
//   out[b,c,i,j] = sum_{t < F*F} W[b,t,i,j] *
//                  bilinear(x[b,c], i + (t / F)*d + alpha[b,t,i,j],
//                                   j + (t % F)*d + beta[b,t,i,j])
//
// with the reference CUDA module's corner rule: alpha and beta are clamped to
// [-R, R] (R < 0: no clamp), the integer part is a truncation toward zero,
// the fraction is alpha - trunc(alpha) (so it lies in (-1, 1)), and each of
// the two corner rows / columns is clamped to the image separately.  The
// edge clamp is what the Pallas kernel's extra edge padding of R pixels
// amounts to.  x arrives pre-padded: H_in = H + (F-1)*d, W_in = W + (F-1)*d.
//
// Bound: device memory.  Per output pixel the kernel reads 3*F*F field values
// (W, alpha, beta) once and does ~4*C*F*F gathers that mostly hit L1/L2,
// since neighbouring pixels sample neighbouring source pixels.  The field
// tensors dominate: 3*F*F*H*W*4 bytes per image, about 2.5 GB for the
// 4-image launch at 1080p with F = 5.
//
// Design: one thread per output pixel (b, i, j) in 32x8 blocks, so the field
// reads of a warp are 32 consecutive floats along j (coalesced).  Each thread
// loops over the F*F taps and keeps the C channel sums in f32 registers (in
// chunks of CHUNK channels), then writes C outputs.  The image is shared by
// the C channels of an item: the corner indices and bilinear weights are
// computed once per tap and reused for every channel.  Offsets into the
// tensors are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kChunk = 4;  // channels accumulated in registers at a time

__global__ void __launch_bounds__(kBlockX * kBlockY)
adacof_warp_fwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ weight,
                       const float* __restrict__ alpha,
                       const float* __restrict__ beta,
                       float* __restrict__ out,
                       int F, int d, int R, int C, int H, int W,
                       int H_in, int W_in) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  const int b = blockIdx.z;
  if (i >= H || j >= W) return;

  const int F2 = F * F;
  const int64_t plane = (int64_t)H * W;
  const int64_t plane_in = (int64_t)H_in * W_in;
  const int64_t pix = (int64_t)i * W + j;
  const int64_t field0 = (int64_t)b * F2 * plane + pix;
  const float r = (float)R;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int nc = min(kChunk, C - c0);
    const float* xb = x + ((int64_t)b * C + c0) * plane_in;
    float acc[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) acc[c] = 0.f;

    for (int t = 0; t < F2; ++t) {
      const int64_t fo = field0 + (int64_t)t * plane;
      const float w = weight[fo];
      float a = alpha[fo];
      float be = beta[fo];
      if (R >= 0) {
        a = fminf(fmaxf(a, -r), r);
        be = fminf(fmaxf(be, -r), r);
      }
      const float ta = truncf(a);
      const float tb = truncf(be);
      const float fi = a - ta;
      const float fj = be - tb;
      // __float2int_rz saturates, so an unclamped huge offset stays finite
      const int64_t i0 = (int64_t)i + (t / F) * d + __float2int_rz(ta);
      const int64_t j0 = (int64_t)j + (t % F) * d + __float2int_rz(tb);
      const int64_t i0c = min(max(i0, (int64_t)0), (int64_t)H_in - 1);
      const int64_t i1c = min(max(i0 + 1, (int64_t)0), (int64_t)H_in - 1);
      const int64_t j0c = min(max(j0, (int64_t)0), (int64_t)W_in - 1);
      const int64_t j1c = min(max(j0 + 1, (int64_t)0), (int64_t)W_in - 1);
      const float w00 = (1.f - fi) * (1.f - fj);
      const float w10 = fi * (1.f - fj);
      const float w01 = (1.f - fi) * fj;
      const float w11 = fi * fj;
      const int64_t o00 = i0c * W_in + j0c;
      const int64_t o10 = i1c * W_in + j0c;
      const int64_t o01 = i0c * W_in + j1c;
      const int64_t o11 = i1c * W_in + j1c;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (c < nc) {
          const float* xc = xb + c * plane_in;
          const float s = __ldg(xc + o00) * w00 + __ldg(xc + o10) * w10 +
                          __ldg(xc + o01) * w01 + __ldg(xc + o11) * w11;
          acc[c] += w * s;
        }
      }
    }

    float* ob = out + ((int64_t)b * C + c0) * plane + pix;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (c < nc) ob[c * plane] = acc[c];
    }
  }
}

}  // namespace

// x (B, C, H_in, W_in), weight/alpha/beta (B, F*F, H, W), out (B, C, H, W):
// all f32, contiguous, on the device of `stream`.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int adacof_warp_fwd(void* x, void* weight, void* alpha, void* beta,
                               void* out, void* stream, int F, int d, int R,
                               int B, int C, int H, int W, int H_in,
                               int W_in) {
  if (B == 0 || C == 0 || H == 0 || W == 0) return 0;
  dim3 block(kBlockX, kBlockY, 1);
  dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, B);
  adacof_warp_fwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)weight, (const float*)alpha,
      (const float*)beta, (float*)out, F, d, R, C, H, W, H_in, W_in);
  return (int)cudaGetLastError();
}
