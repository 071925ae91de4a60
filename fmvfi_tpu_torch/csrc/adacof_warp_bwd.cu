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
// and C cotangent values once and writes 3*F*F gradients; the corner gathers
// (4 per tap) mostly hit L1/L2, since neighbouring pixels sample
// neighbouring source pixels.  About 327 MB at the training launch
// (x (8,3,260,260), fields (8,25,256,256)), ~0.10 ms at 3.35 TB/s.
//
// Design: K1's (adacof_ring.cuh): 8 x 64 tiles, 2 pixels per consumer lane.
// The producer warp streams W, alpha, beta tap by tap through the 4-stage ring
// with bulk asynchronous copies (L2 evict-first); each consumer lane loads
// the C cotangent values of its pixels once, then per tap gathers the 4
// corners (with C = 3 and F 5 or 11 from the RGBX copy of x that K1 wrote
// in the forward) and writes dW, dalpha, dbeta
// with streaming stores.  Each output element has exactly one owner thread:
// no atomics and no reduction across threads.  In the run-time-C
// instantiation, with more than kChunk channels, the later passes add to
// what the first wrote (the same thread, so no race).  Accumulation in f32.

#include "adacof_ring.cuh"

namespace {

using namespace adacof;

template <int KF, int KC, bool RING>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
adacof_warp_bwd_kernel(const float* __restrict__ x,
                       const float4* __restrict__ x4,
                       const float* __restrict__ weight,
                       const float* __restrict__ alpha,
                       const float* __restrict__ beta,
                       const float* __restrict__ g,
                       float* __restrict__ dweight,
                       float* __restrict__ dalpha,
                       float* __restrict__ dbeta,
                       int F_rt, int d, int R, int C_rt, int H, int W,
                       int H_in, int W_in) {
  constexpr int CH = KC > 0 ? KC : kChunk;
  const int F = KF > 0 ? KF : F_rt;
  const int C = KC > 0 ? KC : C_rt;
  const int F2 = F * F;
  // at least one pass, so that C == 0 writes zero gradients
  const int nchunks = KC > 0 ? 1 : max((C + CH - 1) / CH, 1);
  const int b = blockIdx.z;
  const int ti0 = blockIdx.y * kTileH;
  const int tj0 = blockIdx.x * kTileW;
  const int rows = min(kTileH, H - ti0);
  const int cols = min(kTileW, W - tj0);
  const int plane = H * W;
  const int plane_in = H_in * W_in;
  // one 64-bit base per image; 32-bit offsets within it
  const size_t fimg = (size_t)b * F2 * plane;
  const float* wimg = weight + fimg;
  const float* aimg = alpha + fimg;
  const float* bimg = beta + fimg;
  float* dwimg = dweight + fimg;
  float* daimg = dalpha + fimg;
  float* dbimg = dbeta + fimg;
  const float* ximg = x + (size_t)b * C * plane_in;
  const float4* x4img = x4 + (size_t)b * plane_in;
  const float* gimg = g + (size_t)b * C * plane;

  extern __shared__ __align__(128) unsigned char smem[];
  const Ring ring(smem);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (RING) {
    if (threadIdx.x == 0) ring.init();
    __syncthreads();
    if (warp == kTileH) {
      ring.produce(wimg, aimg, bimg, nchunks * F2, F2, plane, W, ti0, tj0, rows, cols);
      return;
    }
  }

  // consumer: row `warp` of the tile, pixels lane + 32 p
  const int i = ti0 + warp;
  bool ok[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) ok[p] = warp < rows && lane + 32 * p < cols;
  const int pix = i * W + tj0 + lane;  // offset of pixel p = 0 in a plane
  const int fpix = kDiagForm == 2 ? warp * W + lane : pix;  // where its fields are read
  const bool clamp = R >= 0;
  const float r = (float)R;

  int n = 0;  // ring position
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    const int c0 = chunk * CH;
    const int nc = KC > 0 ? KC : min(CH, C - c0);
    float gc[kPix][CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float* src = gimg + (c0 + c) * plane + pix;
#pragma unroll
      for (int p = 0; p < kPix; ++p)
        gc[p][c] = (KC > 0 || c < nc) && ok[p] ? __ldcs(src + 32 * p) : 0.f;
    }

#pragma unroll
    for (int t = 0; t < F2; ++t, ++n) {
      float w[kPix], a[kPix], be[kPix];
      const int fo = t * plane + pix;
      if (RING) {
        ring.consume(n, warp, w, a, be);
      } else {
        const int fi = t * plane + fpix;
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          w[p] = ok[p] ? __ldcs(wimg + fi + 32 * p) : 0.f;
          a[p] = ok[p] ? __ldcs(aimg + fi + 32 * p) : 0.f;
          be[p] = ok[p] ? __ldcs(bimg + fi + 32 * p) : 0.f;
        }
      }
      const int ii = i + (t / F) * d;
      const int jj = tj0 + lane + (t % F) * d;
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        if (!ok[p]) continue;
        const Corners k = corners(a[p], be[p], ii, jj + 32 * p, H_in, W_in, clamp, r);
        const float w00 = (1.f - k.fi) * (1.f - k.fj);
        const float w10 = k.fi * (1.f - k.fj);
        const float w01 = (1.f - k.fi) * k.fj;
        const float w11 = k.fi * k.fj;
        float v[4][CH];
        gather<KC, CH>(ximg, x4img, c0, nc, plane_in, k, v);
        float sw = 0.f, sa = 0.f, sb = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const float x00 = v[0][c], x10 = v[1][c], x01 = v[2][c], x11 = v[3][c];
          sw += gc[p][c] * (w00 * x00 + w10 * x10 + w01 * x01 + w11 * x11);
          sa += gc[p][c] * ((1.f - k.fj) * (x10 - x00) + k.fj * (x11 - x01));
          sb += gc[p][c] * ((1.f - k.fi) * (x01 - x00) + k.fi * (x11 - x10));
        }
        float da = w[p] * sa;
        float db = w[p] * sb;
        if (clamp) {
          if (fabsf(a[p]) >= r) da = 0.f;
          if (fabsf(be[p]) >= r) db = 0.f;
        }
        const int o = fo + 32 * p;
        if (chunk > 0) {  // run-time C only: add to the earlier passes
          dwimg[o] += sw;
          daimg[o] += da;
          dbimg[o] += db;
        } else {
          __stcs(dwimg + o, sw);
          __stcs(daimg + o, da);
          __stcs(dbimg + o, db);
        }
      }
    }
  }
}

template <int KF, int KC, bool RING>
int launch(const float* x, const float4* x4, const float* w, const float* a, const float* b,
           const float* g, float* dw, float* da, float* db, cudaStream_t stream, int F, int d,
           int R, int B, int C, int H, int W, int H_in, int W_in) {
  auto kernel = adacof_warp_bwd_kernel<KF, KC, RING>;
  const size_t smem = RING ? kRingBytes : 0;  // under the 48 KB default limit
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  kernel<<<grid, RING ? kThreads : kConsumers, smem, stream>>>(x, x4, w, a, b, g, dw, da, db, F,
                                                               d, R, C, H, W, H_in, W_in);
  return (int)cudaGetLastError();
}

template <bool RING>
int dispatch(const float* x, float4* x4, const float* w, const float* a, const float* b,
             const float* g, float* dw, float* da, float* db, cudaStream_t stream, int F, int d,
             int R, int B, int C, int H, int W, int H_in, int W_in, int* path) {
  if (!uses_rgbx(F, C, x4)) {
    *path = path_code(0, RING);
    return launch<0, 0, RING>(x, x4, w, a, b, g, dw, da, db, stream, F, d, R, B, C, H, W, H_in,
                              W_in);
  }
  if (F == 5) {
    *path = path_code(1, RING);
    return launch<5, 3, RING>(x, x4, w, a, b, g, dw, da, db, stream, F, d, R, B, C, H, W, H_in,
                              W_in);
  }
  *path = path_code(2, RING);
  return launch<11, 3, RING>(x, x4, w, a, b, g, dw, da, db, stream, F, d, R, B, C, H, W, H_in,
                             W_in);
}

}  // namespace

// x (B, C, H_in, W_in), weight/alpha/beta (B, F*F, H, W), g (B, C, H, W),
// dweight/dalpha/dbeta (B, F*F, H, W): all f32, contiguous, on the device of
// `stream`; x4 (B, H_in, W_in, 4) f32, the RGBX copy of x that K1 wrote,
// from which K2 gathers when C == 3 and F is 5 or 11 (else unused, may be
// null); every per-image tensor has fewer than 2^31 elements and H_in, W_in
// < 2^30.  Writes to *path the instantiation
// launched (adacof_ring.cuh::path_code; kPathNone if nothing was launched)
// and returns cudaGetLastError() after the launches (0 on success).
extern "C" int adacof_warp_bwd(void* x, void* x4, void* weight, void* alpha, void* beta,
                               void* g, void* dweight, void* dalpha, void* dbeta,
                               void* stream, int* path, int F, int d, int R, int B, int C,
                               int H, int W, int H_in, int W_in) {
  *path = adacof::kPathNone;
  if (B == 0 || H == 0 || W == 0) return 0;
  const bool ring = W % 4 == 0 && adacof::aligned16(weight) && adacof::aligned16(alpha) &&
                    adacof::aligned16(beta);
  const auto fn = ring ? &dispatch<true> : &dispatch<false>;
  return fn((const float*)x, (float4*)x4, (const float*)weight, (const float*)alpha,
            (const float*)beta, (const float*)g, (float*)dweight, (float*)dalpha, (float*)dbeta,
            (cudaStream_t)stream, F, d, R, B, C, H, W, H_in, W_in, path);
}
