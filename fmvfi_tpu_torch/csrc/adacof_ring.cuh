// Shared by K1 (adacof_warp.cu) and K2 (adacof_warp_bwd.cu): the tile shape,
// the asynchronous-copy field ring, the RGBX copy of x, and the per-tap
// corner geometry.
//
// A block owns a tile of kTileH rows x kTileW output pixels of one image
// (blockIdx.z is the image, so blocks run image by image and the part of x
// that the gathers reuse stays in L2).  In the ring instantiations, warp
// kTileH (the producer) streams the three fields W, alpha, beta of one tap
// for the whole tile into a stage of a kStages-deep ring in shared memory
// with 1-D bulk copies (cp.async.bulk, one per field row segment, L2
// evict-first, so that the 2.5 GB field stream does not push x out of L2),
// completing on the stage's `full` mbarrier; the kTileH consumer warps (one
// per tile row) read their pixels' fields from the stage, release it on its
// `empty` mbarrier and do the gathers.  The field stream then no longer
// waits on the gather chain.  A consumer lane owns kPix pixels of its row,
// lane + 32 p, so each warp-level gather, shared-memory read and store
// covers 32 neighbouring pixels.  kPix and the 3 blocks per SM asked of the
// compiler were chosen by timing on the card: wider tiles (4 pixels a lane)
// or 16-row tiles ran slower.
//
// Bulk copies need 16-byte aligned rows: W % 4 == 0 and 16-byte aligned
// field tensors.  Otherwise the same template runs without the ring
// (RING = false): consumers load their fields from device memory themselves.
//
// With C = 3 and F 5 or 11 the gathers read an RGBX copy of x, (B, H_in,
// W_in, 4), made by pack_rgbx: one 16-byte load per corner brings all three
// channels, 4 gathers per tap in place of 12.  The gathers, not the field
// stream, set the time of the planar design (PERF.md).  K1 writes the copy
// and K2 gathers from the forward's copy.
//
// ADACOF_DIAG_FORM selects a diagnostic form, for timing where a kernel's
// time goes (scripts/adacof_kernel_diagnostics.py builds them with
// -DADACOF_DIAG_FORM=n; the package builds form 0, the kernels as they are):
//   1  every corner gather gives 1 in place of x: the kernel only streams its
//      fields and writes its outputs;
//   2  every tile reads the fields of its image's first tile, which stay in
//      L2: the kernel only gathers (and writes).
//
// Offsets within an image are 32-bit (the wrapper checks that every
// per-image tensor has fewer than 2^31 elements and that H_in, W_in < 2^30);
// each image gets one 64-bit base pointer.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ADACOF_DIAG_FORM
#define ADACOF_DIAG_FORM 0
#endif

namespace adacof {

constexpr int kDiagForm = ADACOF_DIAG_FORM;
static_assert(kDiagForm >= 0 && kDiagForm <= 2, "ADACOF_DIAG_FORM is 0, 1 or 2");

constexpr int kTileH = 8;       // tile rows, one consumer warp each
constexpr int kPix = 2;         // pixels per consumer lane
constexpr int kTileW = 32 * kPix;
constexpr int kMinBlocks = 3;   // blocks per SM asked of the compiler (__launch_bounds__)
constexpr int kStages = 4;      // ring depth, one tap per stage
constexpr int kChunk = 4;       // channels per pass in the run-time-C instantiation
constexpr int kIntLimit = 1 << 29;  // |integer offset| cap, see corners()
constexpr int kConsumers = 32 * kTileH;
constexpr int kThreads = kConsumers + 32;  // + the producer warp

constexpr int kStageFloats = 3 * kTileH * kTileW;  // W, alpha, beta of one tap
constexpr size_t kRingBytes =
    (size_t)kStages * kStageFloats * sizeof(float) + 2 * kStages * sizeof(uint64_t);
static_assert(kRingBytes <= 48 * 1024, "above 48 KB the launch must raise the dynamic limit");

// ---- mbarrier and bulk-copy primitives (PTX, sm_90) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ uint64_t l2_evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from device
// memory to shared memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// ---- the ring ----

struct Ring {
  float* data;      // [kStages][3][kTileH][kTileW]
  uint64_t* full;   // [kStages], count 1 (the producer's arrive.expect_tx)
  uint64_t* empty;  // [kStages], count kTileH (one arrive per consumer warp)

  __device__ explicit Ring(unsigned char* smem)
      : data(reinterpret_cast<float*>(smem)),
        full(reinterpret_cast<uint64_t*>(smem + (size_t)kStages * kStageFloats * sizeof(float))),
        empty(full + kStages) {}

  __device__ float* field(int s, int f, int row) const {
    return data + ((s * 3 + f) * kTileH + row) * kTileW;
  }

  // One thread initializes the barriers; then every thread must pass a
  // __syncthreads() before using them.
  __device__ void init() const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTileH);
    }
    mbar_fence_init();
  }

  // The producer warp: for n = 0 .. total-1, stream tap n % F2 of the three
  // fields (per-image bases w, a, b) for the tile into stage n % kStages.
  __device__ void produce(const float* w, const float* a, const float* b, int total, int F2,
                          int plane, int W, int ti0, int tj0, int rows, int cols) const {
    const int lane = threadIdx.x % 32;
    const uint64_t policy = l2_evict_first_policy();
    const uint32_t row_bytes = cols * sizeof(float);
    for (int n = 0; n < total; ++n) {
      const int s = n % kStages;
      if (n >= kStages) mbar_wait(&empty[s], ((n / kStages) - 1) & 1);
      if (lane == 0) mbar_arrive_expect_tx(&full[s], 3 * rows * row_bytes);
      __syncwarp();
      const int t = n % F2;
      for (int q = lane; q < 3 * rows; q += 32) {  // one row segment of one field
        const int f = q / rows;
        const int r = q - f * rows;
        const float* src = f == 0 ? w : f == 1 ? a : b;
        const int at = kDiagForm == 2 ? r * W : (ti0 + r) * W + tj0;
        bulk_load(field(s, f, r), src + t * plane + at, row_bytes, &full[s], policy);
      }
    }
  }

  // A consumer lane's fields for ring position n: W, alpha, beta of its kPix
  // pixels in row `row`; then the warp releases the stage.
  __device__ void consume(int n, int row, float (&w)[kPix], float (&a)[kPix],
                          float (&b)[kPix]) const {
    const int lane = threadIdx.x % 32;
    const int s = n % kStages;
    mbar_wait(&full[s], (n / kStages) & 1);
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      w[p] = field(s, 0, row)[lane + 32 * p];
      a[p] = field(s, 1, row)[lane + 32 * p];
      b[p] = field(s, 2, row)[lane + 32 * p];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
};

// ---- the RGBX copy of x ----

// x (B, 3, H_in, W_in) -> x4 (B, H_in, W_in, 4), the fourth channel 0; one
// thread per pixel, grid (ceil(plane_in / 256), B).
static __global__ void __launch_bounds__(256)
pack_rgbx(const float* __restrict__ x, float4* __restrict__ x4, int plane_in) {
  const int p = blockIdx.x * 256 + threadIdx.x;
  if (p >= plane_in) return;
  const float* xb = x + (size_t)blockIdx.y * 3 * plane_in + p;
  x4[(size_t)blockIdx.y * plane_in + p] =
      make_float4(__ldcs(xb), __ldcs(xb + plane_in), __ldcs(xb + 2 * plane_in), 0.f);
}

inline int launch_pack_rgbx(const float* x, float4* x4, int B, int plane_in,
                            cudaStream_t stream) {
  const dim3 grid((plane_in + 255) / 256, B);
  pack_rgbx<<<grid, 256, 0, stream>>>(x, x4, plane_in);
  return (int)cudaGetLastError();
}

// ---- per-tap geometry ----

// The reference CUDA module's corner rule for one tap of one pixel: offsets
// clamped to [-r, r] when clamp is set, integer part by truncation toward
// zero, fraction offset - trunc(offset) in (-1, 1), and each of the two
// corner rows / columns clamped to the image separately.  The integer part
// is capped at +-kIntLimit so that 32-bit corner indices cannot overflow; a
// corner that far out clamps to the edge either way, and a float that large
// has no fraction.  __float2int_rz saturates, so a huge offset stays finite.
struct Corners {
  int o[4];  // offsets into an x plane of corners 00, 10, 01, 11 (row, column)
  float fi, fj;
};

__device__ __forceinline__ Corners corners(float a, float be, int i, int j, int H_in, int W_in,
                                           bool clamp, float r) {
  if (clamp) {
    a = fminf(fmaxf(a, -r), r);
    be = fminf(fmaxf(be, -r), r);
  }
  const float ta = truncf(a);
  const float tb = truncf(be);
  Corners k;
  k.fi = a - ta;
  k.fj = be - tb;
  const int i0 = i + min(max(__float2int_rz(ta), -kIntLimit), kIntLimit);
  const int j0 = j + min(max(__float2int_rz(tb), -kIntLimit), kIntLimit);
  const int i0c = min(max(i0, 0), H_in - 1);
  const int i1c = min(max(i0 + 1, 0), H_in - 1);
  const int j0c = min(max(j0, 0), W_in - 1);
  const int j1c = min(max(j0 + 1, 0), W_in - 1);
  k.o[0] = i0c * W_in + j0c;
  k.o[1] = i1c * W_in + j0c;
  k.o[2] = i0c * W_in + j1c;
  k.o[3] = i1c * W_in + j1c;
  return k;
}

// The 4 corners of channels c0 .. c0+CH-1 (those below nc; the rest 0):
// v[corner][c].  KC == 3 reads the RGBX copy (per-image base x4img), one
// 16-byte load per corner; KC == 0 reads the planar x (per-image base ximg).
template <int KC, int CH>
__device__ __forceinline__ void gather(const float* ximg, const float4* x4img, int c0, int nc,
                                       int plane_in, const Corners& k, float (&v)[4][CH]) {
  if constexpr (kDiagForm == 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < CH; ++c) v[q][c] = 1.f;
  } else if constexpr (KC == 3) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 x = __ldg(x4img + k.o[q]);
      v[q][0] = x.x;
      v[q][1] = x.y;
      v[q][2] = x.z;
    }
  } else {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float* xc = ximg + (c0 + c) * plane_in;
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q][c] = c < nc ? __ldg(xc + k.o[q]) : 0.f;
    }
  }
}

// ---- host side ----

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Instantiation codes reported to the wrapper: 2 * instantiation + ring,
// instantiation 0 = F and C at run time (planar x), 1 = (F 5, C 3),
// 2 = (F 11, C 3); the C 3 ones gather from x4.
constexpr int kPathNone = -1;
inline bool uses_rgbx(int F, int C, const void* x4) {
  return C == 3 && (F == 5 || F == 11) && x4 != nullptr;
}
inline int path_code(int inst, bool ring) { return 2 * inst + (ring ? 1 : 0); }

}  // namespace adacof
