// fmvfi_tpu_torch native host runtime: fused triplet augmentation + batch
// assembly (the port's copy of fmvfi_tpu/native/augment.cpp).
//
// The reference's input pipeline is a single-threaded torch Dataset doing
// PIL crops/flips + ToTensor per item (src/train/datareader.py:40-71 with
// num_workers=0 at src/train/train.py:74).  This library fuses
// crop + h/v flip + time reversal + uint8->float32 normalize + NHWC batch
// placement into one multithreaded pass over the decoded frames, feeding the
// device input queue at memory speed.
//
// Exposed C ABI (ctypes):
//   fmvfi_augment_batch(frames, H, W, B, crop, params, out0, out1, out2)
//     frames: B consecutive triplets, each 3 frames of H*W*3 uint8 (RGB),
//             laid out [b][t][h][w][c] contiguous.
//     params: B * 5 int32 = (y0, x0, hflip, vflip, tswap) per item.
//     outN:   (B, crop, crop, 3) float32 in [0,1]; out0/out2 swapped when
//             tswap (time reversal), matching datareader.py:65-69.

#include <cstdint>
#include <cstddef>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

void augment_one(const uint8_t* triplet, int H, int W, int crop,
                 const int32_t* p, float* o0, float* o1, float* o2) {
    const int y0 = p[0], x0 = p[1], hflip = p[2], vflip = p[3], tswap = p[4];
    const std::size_t frame_sz = static_cast<std::size_t>(H) * W * 3;
    const uint8_t* src[3] = {triplet, triplet + frame_sz, triplet + 2 * frame_sz};
    float* dst[3] = {tswap ? o2 : o0, o1, tswap ? o0 : o2};
    constexpr float kInv = 1.0f / 255.0f;

    for (int t = 0; t < 3; ++t) {
        const uint8_t* s = src[t];
        float* d = dst[t];
        for (int y = 0; y < crop; ++y) {
            const int sy = vflip ? (y0 + crop - 1 - y) : (y0 + y);
            const uint8_t* row = s + (static_cast<std::size_t>(sy) * W + x0) * 3;
            float* drow = d + static_cast<std::size_t>(y) * crop * 3;
            if (!hflip) {
                const int n = crop * 3;
                for (int i = 0; i < n; ++i) drow[i] = row[i] * kInv;
            } else {
                for (int x = 0; x < crop; ++x) {
                    const uint8_t* px = row + (crop - 1 - x) * 3;
                    drow[x * 3 + 0] = px[0] * kInv;
                    drow[x * 3 + 1] = px[1] * kInv;
                    drow[x * 3 + 2] = px[2] * kInv;
                }
            }
        }
    }
}

}  // namespace

extern "C" {

void fmvfi_augment_batch(const uint8_t* frames, int32_t H, int32_t W,
                         int32_t B, int32_t crop, const int32_t* params,
                         float* out0, float* out1, float* out2) {
    const std::size_t in_item = static_cast<std::size_t>(3) * H * W * 3;
    const std::size_t out_item = static_cast<std::size_t>(crop) * crop * 3;
    const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
    const int n_threads = static_cast<int>(std::min<unsigned>(hw, B));

    auto work = [&](int tid) {
        for (int b = tid; b < B; b += n_threads) {
            augment_one(frames + b * in_item, H, W, crop, params + b * 5,
                        out0 + b * out_item, out1 + b * out_item,
                        out2 + b * out_item);
        }
    };
    if (n_threads == 1) {
        work(0);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
}

// uint8 HWC -> float32 [0,1] conversion of a frame sequence (video ingest).
void fmvfi_u8_to_f32(const uint8_t* src, float* dst, int64_t n) {
    constexpr float kInv = 1.0f / 255.0f;
    const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
    const int n_threads = static_cast<int>(std::min<int64_t>(hw, 8));
    const int64_t chunk = (n + n_threads - 1) / n_threads;
    auto work = [&](int tid) {
        const int64_t lo = tid * chunk;
        const int64_t hi = std::min(n, lo + chunk);
        for (int64_t i = lo; i < hi; ++i) dst[i] = src[i] * kInv;
    };
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
}

}  // extern "C"
