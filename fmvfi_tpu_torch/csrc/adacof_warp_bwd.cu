// AdaCoF warp backward (K2) for Hopper (sm_90a): the three field gradients.
//
// Replaces the Pallas TPU kernel fmvfi_tpu/ops/adacof_pallas.py::_bwd_kernel
// (launched through _warp_pallas_bwd_planar / adacof_warp_pallas_bwd), which
// fused the reference's three CUDA kernels updateGrad{Weight,Alpha,Beta}.
// For the forward of K1 (adacof_warp.cu) and an output cotangent g, for every
// image b, tap t and output pixel (i, j):
//
//   alpha, beta clamped to [-R, R] (R < 0: no clamp);
//   A = trunc(alpha), fi = alpha - A; B = trunc(beta), fj = beta - B;
//   corner rows i0 = i + (t / F)*d + A and i0 + 1, columns j0 = j + (t % F)*d
//   + B and j0 + 1, each clamped to the image separately; x00, x10, x01, x11
//   the four corners (row offset first);
//
//   dW[b,t,i,j] = sum_c g[b,c,i,j] * ((1-fi)(1-fj) x00 + fi(1-fj) x10
//                                     + (1-fi) fj x01 + fi fj x11)
//   dalpha      = W * sum_c g * ((1-fj)(x10 - x00) + fj (x11 - x01))
//   dbeta       = W * sum_c g * ((1-fi)(x01 - x00) + fi (x11 - x10))
//
// and, for R >= 0, dalpha = 0 where |alpha_raw| >= R and dbeta = 0 where
// |beta_raw| >= R: the true gradient of the clamped forward.  The differences
// are taken between the clamped corners, so at the image edge, where i0 + 1
// clamps onto i0, the derivative is 0, as autograd of the plain warp gives.
// The input gradient is not computed (the reference's module never did).
//
// Bound: device memory.  Per output pixel the kernel reads 3*F*F field values
// and C cotangent values once and writes 3*F*F gradients; the image gathers
// (4*C per tap) mostly hit L1/L2, since neighbouring pixels sample
// neighbouring source pixels.  About 327 MB at the training launch
// (x (8,3,260,260), fields (8,25,256,256)), ~0.10 ms at 3.35 TB/s.
//
// Design: one thread per output pixel (b, i, j) in 32x8 blocks, like K1, so
// the field and gradient rows of a warp are 32 consecutive floats along j
// (coalesced).  A thread loads its C cotangent values into registers (in
// chunks of kChunk channels), then loops over the F*F taps; per tap it reads
// W, alpha, beta, gathers the 4 corners per channel and writes dW, dalpha,
// dbeta.  Each output element has exactly one owner thread: no atomics and
// no reduction across threads.  With more than kChunk channels, the later
// chunks add to what the first wrote (the same thread, so no race).
// Accumulation in f32; offsets into the tensors are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kChunk = 4;  // cotangent channels held in registers at a time

__global__ void __launch_bounds__(kBlockX * kBlockY)
adacof_warp_bwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ weight,
                       const float* __restrict__ alpha,
                       const float* __restrict__ beta,
                       const float* __restrict__ g,
                       float* __restrict__ dweight,
                       float* __restrict__ dalpha,
                       float* __restrict__ dbeta,
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

  // at least one pass, so that C == 0 writes zero gradients
  int c0 = 0;
  do {
    const int nc = min(kChunk, C - c0);
    const float* xb = x + ((int64_t)b * C + c0) * plane_in;
    const float* gb = g + ((int64_t)b * C + c0) * plane + pix;
    float gc[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) gc[c] = c < nc ? gb[c * plane] : 0.f;

    for (int t = 0; t < F2; ++t) {
      const int64_t fo = field0 + (int64_t)t * plane;
      const float w = weight[fo];
      const float a_raw = alpha[fo];
      const float b_raw = beta[fo];
      float a = a_raw;
      float be = b_raw;
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
      float sw = 0.f, sa = 0.f, sb = 0.f;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (c < nc) {
          const float* xc = xb + c * plane_in;
          const float x00 = __ldg(xc + o00);
          const float x10 = __ldg(xc + o10);
          const float x01 = __ldg(xc + o01);
          const float x11 = __ldg(xc + o11);
          sw += gc[c] * (w00 * x00 + w10 * x10 + w01 * x01 + w11 * x11);
          sa += gc[c] * ((1.f - fj) * (x10 - x00) + fj * (x11 - x01));
          sb += gc[c] * ((1.f - fi) * (x01 - x00) + fi * (x11 - x10));
        }
      }
      float da = w * sa;
      float db = w * sb;
      if (R >= 0) {
        if (fabsf(a_raw) >= r) da = 0.f;
        if (fabsf(b_raw) >= r) db = 0.f;
      }
      if (c0 == 0) {
        dweight[fo] = sw;
        dalpha[fo] = da;
        dbeta[fo] = db;
      } else {
        dweight[fo] += sw;
        dalpha[fo] += da;
        dbeta[fo] += db;
      }
    }
    c0 += kChunk;
  } while (c0 < C);
}

}  // namespace

// x (B, C, H_in, W_in), weight/alpha/beta (B, F*F, H, W), g (B, C, H, W),
// dweight/dalpha/dbeta (B, F*F, H, W): all f32, contiguous, on the device of
// `stream`.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int adacof_warp_bwd(void* x, void* weight, void* alpha, void* beta,
                               void* g, void* dweight, void* dalpha,
                               void* dbeta, void* stream, int F, int d, int R,
                               int B, int C, int H, int W, int H_in,
                               int W_in) {
  if (B == 0 || H == 0 || W == 0) return 0;
  dim3 block(kBlockX, kBlockY, 1);
  dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, B);
  adacof_warp_bwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)weight, (const float*)alpha,
      (const float*)beta, (const float*)g, (float*)dweight, (float*)dalpha,
      (float*)dbeta, F, d, R, C, H, W, H_in, W_in);
  return (int)cudaGetLastError();
}
