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

#include <cstdint>
#include <cstdlib>
#include <cstring>

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

}  // extern "C"
