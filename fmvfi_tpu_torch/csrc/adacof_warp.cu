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
// with the reference CUDA module's corner rule (adacof_ring.cuh::corners):
// alpha and beta clamped to [-R, R] (R < 0: no clamp), truncation corners
// and an edge clamp of each corner row / column.  The edge clamp is what the
// Pallas kernel's extra edge padding of R pixels amounts to.  x arrives
// pre-padded: H_in = H + (F-1)*d, W_in = W + (F-1)*d.
//
// Bound: device memory.  Per output pixel the kernel reads 3*F*F field values
// (W, alpha, beta) once and does 4*F*F corner gathers that mostly hit L1/L2,
// since neighbouring pixels sample neighbouring source pixels.  The field
// tensors dominate: 3*F*F*H*W*4 bytes per image, about 2.5 GB for the
// 4-image launch at 1080p with F = 5.
//
// Design (adacof_ring.cuh): a block owns an 8 x 64 tile; a producer warp
// streams the fields tap by tap through a 4-stage shared-memory ring with
// bulk asynchronous copies (L2 evict-first), so that the field stream runs
// ahead of the gathers instead of waiting on them; 8 consumer warps, one
// per tile row, each lane owning 2 pixels, gather the 4 corners of each tap
// (with C = 3 from the RGBX copy of x, one 16-byte load per corner) and keep
// the C channel sums of its pixels in registers, then write them with
// streaming stores.  The tap loop is fully unrolled for the F that the
// repo's configurations use (5 and 11, C 3); one instantiation takes F and
// C at run time for every other F or C (planar x, C in passes of kChunk
// channels, each pass streaming the fields again).

#include "adacof_ring.cuh"

namespace {

using namespace adacof;

template <int KF, int KC, bool RING>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
adacof_warp_fwd_kernel(const float* __restrict__ x,
                       const float4* __restrict__ x4,
                       const float* __restrict__ weight,
                       const float* __restrict__ alpha,
                       const float* __restrict__ beta,
                       float* __restrict__ out,
                       int F_rt, int d, int R, int C_rt, int H, int W,
                       int H_in, int W_in) {
  constexpr int CH = KC > 0 ? KC : kChunk;
  const int F = KF > 0 ? KF : F_rt;
  const int C = KC > 0 ? KC : C_rt;
  const int F2 = F * F;
  const int nchunks = KC > 0 ? 1 : (C + CH - 1) / CH;
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
  const float* ximg = x + (size_t)b * C * plane_in;
  const float4* x4img = x4 + (size_t)b * plane_in;
  float* oimg = out + (size_t)b * C * plane;

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
    float acc[kPix][CH];
#pragma unroll
    for (int p = 0; p < kPix; ++p)
#pragma unroll
      for (int c = 0; c < CH; ++c) acc[p][c] = 0.f;

#pragma unroll
    for (int t = 0; t < F2; ++t, ++n) {
      float w[kPix], a[kPix], be[kPix];
      if (RING) {
        ring.consume(n, warp, w, a, be);
      } else {
        const int fo = t * plane + fpix;
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          w[p] = ok[p] ? __ldcs(wimg + fo + 32 * p) : 0.f;
          a[p] = ok[p] ? __ldcs(aimg + fo + 32 * p) : 0.f;
          be[p] = ok[p] ? __ldcs(bimg + fo + 32 * p) : 0.f;
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
#pragma unroll
        for (int c = 0; c < CH; ++c)
          acc[p][c] += w[p] * (v[0][c] * w00 + v[1][c] * w10 + v[2][c] * w01 + v[3][c] * w11);
      }
    }

#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (KC > 0 || c < nc) {
        float* oc = oimg + (c0 + c) * plane + pix;
#pragma unroll
        for (int p = 0; p < kPix; ++p)
          if (ok[p]) __stcs(oc + 32 * p, acc[p][c]);
      }
    }
  }
}

template <int KF, int KC, bool RING>
int launch(const float* x, const float4* x4, const float* w, const float* a, const float* b,
           float* out, cudaStream_t stream, int F, int d, int R, int B, int C, int H, int W,
           int H_in, int W_in) {
  auto kernel = adacof_warp_fwd_kernel<KF, KC, RING>;
  const size_t smem = RING ? kRingBytes : 0;  // under the 48 KB default limit
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  kernel<<<grid, RING ? kThreads : kConsumers, smem, stream>>>(x, x4, w, a, b, out, F, d, R, C,
                                                               H, W, H_in, W_in);
  return (int)cudaGetLastError();
}

template <bool RING>
int dispatch(const float* x, float4* x4, const float* w, const float* a, const float* b,
             float* out, cudaStream_t stream, int F, int d, int R, int B, int C, int H, int W,
             int H_in, int W_in, int* path) {
  if (!uses_rgbx(F, C, x4)) {
    *path = path_code(0, RING);
    return launch<0, 0, RING>(x, x4, w, a, b, out, stream, F, d, R, B, C, H, W, H_in, W_in);
  }
  const int err = launch_pack_rgbx(x, x4, B, H_in * W_in, stream);
  if (err != 0) return err;
  if (F == 5) {
    *path = path_code(1, RING);
    return launch<5, 3, RING>(x, x4, w, a, b, out, stream, F, d, R, B, C, H, W, H_in, W_in);
  }
  *path = path_code(2, RING);
  return launch<11, 3, RING>(x, x4, w, a, b, out, stream, F, d, R, B, C, H, W, H_in, W_in);
}

}  // namespace

// x (B, C, H_in, W_in), weight/alpha/beta (B, F*F, H, W), out (B, C, H, W):
// all f32, contiguous, on the device of `stream`; x4 scratch (B, H_in,
// W_in, 4) f32 into which K1 writes the RGBX copy of x and from which it
// gathers when C == 3 and F is 5 or 11 (else unused, may be null);
// every per-image tensor has fewer than 2^31 elements and H_in, W_in < 2^30.
// Writes to *path the instantiation launched (adacof_ring.cuh::path_code;
// kPathNone if nothing was launched) and returns cudaGetLastError() after
// the launches (0 on success).
extern "C" int adacof_warp_fwd(void* x, void* x4, void* weight, void* alpha, void* beta,
                               void* out, void* stream, int* path, int F, int d,
                               int R, int B, int C, int H, int W, int H_in,
                               int W_in) {
  *path = adacof::kPathNone;
  if (B == 0 || C == 0 || H == 0 || W == 0) return 0;
  const bool ring = W % 4 == 0 && adacof::aligned16(weight) && adacof::aligned16(alpha) &&
                    adacof::aligned16(beta);
  const auto fn = ring ? &dispatch<true> : &dispatch<false>;
  return fn((const float*)x, (float4*)x4, (const float*)weight, (const float*)alpha,
            (const float*)beta, (float*)out, (cudaStream_t)stream, F, d, R, B, C, H, W, H_in,
            W_in, path);
}
