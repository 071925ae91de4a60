// fmvfi_tpu_torch native host runtime: the PNG row filters of
// fmvfi_tpu_torch/utils/imageio.py (the PNG specification, section 9).
//
// A PNG stores each row of bytes behind a filter-type byte: 0 None, 1 Sub
// (minus the byte bpp to the left), 2 Up (minus the byte above), 3 Average
// (minus the floor mean of left and above), 4 Paeth (minus whichever of
// left, above and upper-left is nearest left + above - upper-left).  Average
// and Paeth are recurrences along the row, which numpy cannot vectorize, so
// both directions run here.  Bytes outside the image (left of the first
// pixel, above the first row) are 0.  bpp is max(1, bits per pixel / 8).
//
// Exposed C ABI (ctypes):
//   fmvfi_png_unfilter(src, rows, rowbytes, bpp, dst) -> int64
//     src: rows * (1 + rowbytes) bytes, each row its filter type and its
//          filtered bytes; dst: rows * rowbytes bytes, the image's bytes.
//     Returns -1, or the index of the first row whose filter type is not
//     0-4 (dst is then incomplete).
//   fmvfi_png_filter(src, rows, rowbytes, bpp, dst)
//     The inverse: src rows * rowbytes image bytes, dst rows * (1 +
//     rowbytes).  Each row takes the filter whose output has the least sum
//     of absolute values as signed bytes (libpng's heuristic).
//   fmvfi_png16_swscale(src, npx, spp, dst)
//     A 16-bit PNG's samples (npx pixels of spp native uint16: 1 or 2 grey,
//     3 or 4 RGB, alpha last and ignored) as cv2.VideoCapture hands them on:
//     FFmpeg's png decoder gives gray16be / ya16be / rgb48be / rgba64be,
//     which swscale converts to BGR24 through its full path (ffmpeg_common.h:
//     hScale16To15's one unscaled tap, then yuv2rgb_write_full).  Grey is
//     full-range luma, v >> 1 on 15 bits; RGB goes to limited-range BT.601
//     Y'CbCr first (input.c's rgb48ToY_c / rgb48ToUV_c with
//     fill_rgb2yuv_table's coefficients for the default table).  dst: npx
//     RGB bytes.

#include <cstdint>
#include <cstdlib>
#include <cstring>

#include "ffmpeg_common.h"

namespace {

inline int paeth(int a, int b, int c) {
    const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
    if (pa <= pb && pa <= pc) return a;
    return pb <= pc ? b : c;
}

// The predictor for filter T from the bytes left (a), above (b) and
// upper-left (c).  T is a template argument, and each row's first bpp
// bytes (a = c = 0) run in a loop of their own, so that each filter's loop
// compiles without a branch per byte.
template <int T>
inline int predict(int a, int b, int c) {
    if (T == 1) return a;
    if (T == 2) return b;
    if (T == 3) return (a + b) >> 1;
    if (T == 4) return paeth(a, b, c);
    return 0;
}

template <int T>
void unfilter_row(const uint8_t* in, uint8_t* cur, const uint8_t* prev, int64_t n, int bpp) {
    const int64_t head = n < bpp ? n : bpp;
    for (int64_t i = 0; i < head; ++i)
        cur[i] = static_cast<uint8_t>(in[i] + predict<T>(0, prev[i], 0));
    for (int64_t i = head; i < n; ++i)
        cur[i] = static_cast<uint8_t>(in[i] + predict<T>(cur[i - bpp], prev[i], prev[i - bpp]));
}

template <int T>
void filter_row(const uint8_t* cur, const uint8_t* prev, int64_t n, int bpp, uint8_t* out) {
    const int64_t head = n < bpp ? n : bpp;
    for (int64_t i = 0; i < head; ++i)
        out[i] = static_cast<uint8_t>(cur[i] - predict<T>(0, prev[i], 0));
    for (int64_t i = head; i < n; ++i)
        out[i] = static_cast<uint8_t>(cur[i] - predict<T>(cur[i - bpp], prev[i], prev[i - bpp]));
}

// libpng's heuristic: the sum of the filtered bytes' absolute values as
// signed bytes
int64_t cost(const uint8_t* out, int64_t n) {
    int64_t sum = 0;
    for (int64_t i = 0; i < n; ++i) sum += std::abs(static_cast<int8_t>(out[i]));
    return sum;
}

}  // namespace

extern "C" {

int64_t fmvfi_png_unfilter(const uint8_t* src, int64_t rows, int64_t rowbytes, int32_t bpp,
                           uint8_t* dst) {
    uint8_t* zeros = static_cast<uint8_t*>(std::calloc(rowbytes > 0 ? rowbytes : 1, 1));
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t* in = src + r * (rowbytes + 1);
        const int t = in[0];
        ++in;
        uint8_t* cur = dst + r * rowbytes;
        const uint8_t* prev = r ? cur - rowbytes : zeros;
        switch (t) {
            case 0: unfilter_row<0>(in, cur, prev, rowbytes, bpp); break;
            case 1: unfilter_row<1>(in, cur, prev, rowbytes, bpp); break;
            case 2: unfilter_row<2>(in, cur, prev, rowbytes, bpp); break;
            case 3: unfilter_row<3>(in, cur, prev, rowbytes, bpp); break;
            case 4: unfilter_row<4>(in, cur, prev, rowbytes, bpp); break;
            default: std::free(zeros); return r;
        }
    }
    std::free(zeros);
    return -1;
}

void fmvfi_png_filter(const uint8_t* src, int64_t rows, int64_t rowbytes, int32_t bpp,
                      uint8_t* dst) {
    uint8_t* zeros = static_cast<uint8_t*>(std::calloc(rowbytes > 0 ? rowbytes : 1, 1));
    uint8_t* trial = static_cast<uint8_t*>(std::malloc(rowbytes > 0 ? rowbytes : 1));
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t* cur = src + r * rowbytes;
        const uint8_t* prev = r ? cur - rowbytes : zeros;
        uint8_t* out = dst + r * (rowbytes + 1);
        // each filter into `trial`; the best so far stays in `out`
        int64_t best = -1;
        for (int t = 0; t < 5; ++t) {
            switch (t) {
                case 0: filter_row<0>(cur, prev, rowbytes, bpp, trial); break;
                case 1: filter_row<1>(cur, prev, rowbytes, bpp, trial); break;
                case 2: filter_row<2>(cur, prev, rowbytes, bpp, trial); break;
                case 3: filter_row<3>(cur, prev, rowbytes, bpp, trial); break;
                default: filter_row<4>(cur, prev, rowbytes, bpp, trial); break;
            }
            const int64_t c = cost(trial, rowbytes);
            if (best < 0 || c < best) {
                best = c;
                out[0] = static_cast<uint8_t>(t);
                std::memcpy(out + 1, trial, rowbytes);
            }
        }
    }
    std::free(trial);
    std::free(zeros);
}

void fmvfi_png16_swscale(const uint16_t* src, int64_t npx, int32_t spp, uint8_t* dst) {
    static const fmvfi_ff::Coeffs full = fmvfi_ff::coeffs(true), limited = fmvfi_ff::coeffs(false);
    // the default table's RGB -> Y'CbCr coefficients on 2^15 (utils.c)
    auto fix = [](double x) { return int64_t(x * (1 << 15) + 0.5); };
    static const int64_t ry = fix(0.299 * 219 / 255), gy = fix(0.587 * 219 / 255),
                         by = fix(0.114 * 219 / 255), ru = -fix(0.169 * 224 / 255),
                         gu = -fix(0.331 * 224 / 255), bu = fix(0.500 * 224 / 255),
                         rv = fix(0.500 * 224 / 255), gv = -fix(0.419 * 224 / 255),
                         bv = -fix(0.081 * 224 / 255);
    auto to15 = [](int64_t v16) {  // hScale16To15: one tap of 1 << 14, shift 15
        const int64_t v = ((v16 & 0xFFFF) << 14) >> 15;
        return v < (1 << 15) - 1 ? v : (1 << 15) - 1;
    };
    const int64_t mid = 128 << 7;  // zero chroma on 15 bits
    for (int64_t p = 0; p < npx; ++p) {
        const uint16_t* s = src + p * spp;
        if (spp <= 2) {
            fmvfi_ff::put_full(full, dst + 3 * p, to15(s[0]) * 4, 0, 0);
            continue;
        }
        const int64_t r = s[0], g = s[1], b = s[2];
        const int64_t y = to15((ry * r + gy * g + by * b + (int64_t(0x2001) << 14)) >> 15);
        const int64_t u = to15((ru * r + gu * g + bu * b + (int64_t(0x10001) << 14)) >> 15);
        const int64_t v = to15((rv * r + gv * g + bv * b + (int64_t(0x10001) << 14)) >> 15);
        fmvfi_ff::put_full(limited, dst + 3 * p, y * 4, (u - mid) * 4, (v - mid) * 4);
    }
}

}  // extern "C"
