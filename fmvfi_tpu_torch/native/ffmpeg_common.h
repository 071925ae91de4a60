// fmvfi_tpu_torch native host runtime: what the FFmpeg decoders share
// (mjpeg.cpp, mpeg4.cpp, mpeg4_enc.cpp's reconstruction).
//   - FFmpeg's integer "simple" IDCT (simple_idct_template.c, 8-bit: rows
//     then columns, W1..W7 = cos(k pi / 16) sqrt(2) 2^14, shifts 11 and 20, a
//     row of zero ACs taken as 8 x DC), in its put form (clipped samples) and
//     its add form (the result added to a prediction, then clipped);
//   - swscale's BT.601 planar YUV -> packed RGB conversion at the same size
//     (sws_getContext(w, h, yuv, w, h, bgr24, SWS_BICUBIC), what OpenCV's
//     video reader calls), full range (yuvj*, Motion-JPEG) or limited range
//     (yuv420p, MPEG-4 Part 2).  Its route depends on the size, each route
//     with its own arithmetic:
//       * 4:2:0 and 4:2:2 of even height: the unscaled SIMD converter, each
//         chroma sample used for its 2x2 (2x1) pixels, the terms
//         (8 C - 1024) * k >> 16 (pmulhw) added to (8 Y - 8 oy) * ky >> 16
//         and saturated; k = the 2^13-scaled coefficients (full range 14516,
//         -2819, -5850, 11485, ky 8192; limited 16525, -3209, -6660, 13075,
//         ky 9539, oy 16);
//       * 4:4:4, and 4:2:0 / 4:2:2 of odd height and odd width: chroma
//         resampled to full size by swscale's bicubic filters (B = 0,
//         C = 0.6, chroma sited where the frame says; 14-bit horizontal and
//         12-bit vertical integer taps built as libswscale's initFilter
//         builds them, edges folded in; a 2-tap vertical row summing to
//         4096 without the rounding term, as yuv2rgb_full_1 sums it), then
//         yuv2rgb_write_full: ((Y - oy) 2^9 ky + 2^21 + the chroma terms on
//         2^9-scaled chroma) clipped to 30 bits, >> 22;
//       * 4:2:0 / 4:2:2 of odd height and even width: chroma filtered
//         vertically only, each sample used for two pixels; every row but
//         the last two takes the MMX vertical scaler (per-tap pmulhw sums
//         plus 4, or one line or the mean of two for a 2-tap row whose taps
//         sum to 4096) and the pmulhw terms above (luma 8 Y + 4 through the
//         general scaler, 8 Y through the one-line one), the last two the C
//         scaler (rounded 19-bit sums) and yuv2rgb.c's lookup tables (the
//         chroma terms C k' >> 16 - (k' >> 9), k' the coefficients over the
//         luma gain, added to Y before its table);
//       * grey: Y repeated to three channels.
//     Planes of 9 to 16 bits a sample (yuv4xxp10le / yuv4xxp12le: VP9's
//     profiles 2 and 3) never take the unscaled converter; they enter
//     swscale through hScale16To15 (a sample v of depth d becomes
//     v << (15 - d) on the 15-bit scale of the 8-bit v << 7, filtered taps
//     summed and shifted by d - 1 instead of 7), then take the same routes
//     as 8-bit planes of their size.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace fmvfi_ff {

// FFmpeg's simple_idct_template.c, 8-bit: rows in place (16-bit results),
// then columns, each output sample passed to `out(row, col, value)`.
const int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;
const int ROW_SHIFT = 11, COL_SHIFT = 20;

template <class Out>
inline void simple_idct(const int16_t* coef, Out out) {
    int16_t b[64];
    std::memcpy(b, coef, sizeof(b));
    for (int r = 0; r < 8; ++r) {
        int16_t* row = b + 8 * r;
        if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
            const int16_t v = static_cast<int16_t>(row[0] * 8);
            for (int c = 0; c < 8; ++c) row[c] = v;
            continue;
        }
        int64_t a0 = int64_t(W4) * row[0] + (1 << (ROW_SHIFT - 1)), a1 = a0, a2 = a0, a3 = a0;
        a0 += int64_t(W2) * row[2];
        a1 += int64_t(W6) * row[2];
        a2 -= int64_t(W6) * row[2];
        a3 -= int64_t(W2) * row[2];
        int64_t b0 = int64_t(W1) * row[1] + int64_t(W3) * row[3];
        int64_t b1 = int64_t(W3) * row[1] - int64_t(W7) * row[3];
        int64_t b2 = int64_t(W5) * row[1] - int64_t(W1) * row[3];
        int64_t b3 = int64_t(W7) * row[1] - int64_t(W5) * row[3];
        a0 += int64_t(W4) * row[4] + int64_t(W6) * row[6];
        a1 += -int64_t(W4) * row[4] - int64_t(W2) * row[6];
        a2 += -int64_t(W4) * row[4] + int64_t(W2) * row[6];
        a3 += int64_t(W4) * row[4] - int64_t(W6) * row[6];
        b0 += int64_t(W5) * row[5] + int64_t(W7) * row[7];
        b1 += -int64_t(W1) * row[5] - int64_t(W5) * row[7];
        b2 += int64_t(W7) * row[5] + int64_t(W3) * row[7];
        b3 += int64_t(W3) * row[5] - int64_t(W1) * row[7];
        row[0] = static_cast<int16_t>((a0 + b0) >> ROW_SHIFT);
        row[7] = static_cast<int16_t>((a0 - b0) >> ROW_SHIFT);
        row[1] = static_cast<int16_t>((a1 + b1) >> ROW_SHIFT);
        row[6] = static_cast<int16_t>((a1 - b1) >> ROW_SHIFT);
        row[2] = static_cast<int16_t>((a2 + b2) >> ROW_SHIFT);
        row[5] = static_cast<int16_t>((a2 - b2) >> ROW_SHIFT);
        row[3] = static_cast<int16_t>((a3 + b3) >> ROW_SHIFT);
        row[4] = static_cast<int16_t>((a3 - b3) >> ROW_SHIFT);
    }
    for (int c = 0; c < 8; ++c) {
        const int16_t* col = b + c;
        int64_t a0 = int64_t(W4) * (col[0] + ((1 << (COL_SHIFT - 1)) / W4)), a1 = a0, a2 = a0,
                a3 = a0;
        a0 += int64_t(W2) * col[16];
        a1 += int64_t(W6) * col[16];
        a2 -= int64_t(W6) * col[16];
        a3 -= int64_t(W2) * col[16];
        int64_t b0 = int64_t(W1) * col[8] + int64_t(W3) * col[24];
        int64_t b1 = int64_t(W3) * col[8] - int64_t(W7) * col[24];
        int64_t b2 = int64_t(W5) * col[8] - int64_t(W1) * col[24];
        int64_t b3 = int64_t(W7) * col[8] - int64_t(W5) * col[24];
        a0 += int64_t(W4) * col[32];
        a1 -= int64_t(W4) * col[32];
        a2 -= int64_t(W4) * col[32];
        a3 += int64_t(W4) * col[32];
        b0 += int64_t(W5) * col[40];
        b1 -= int64_t(W1) * col[40];
        b2 += int64_t(W7) * col[40];
        b3 += int64_t(W3) * col[40];
        a0 += int64_t(W6) * col[48];
        a1 -= int64_t(W2) * col[48];
        a2 += int64_t(W2) * col[48];
        a3 -= int64_t(W6) * col[48];
        b0 += int64_t(W7) * col[56];
        b1 -= int64_t(W5) * col[56];
        b2 += int64_t(W3) * col[56];
        b3 -= int64_t(W1) * col[56];
        out(0, c, static_cast<int>((a0 + b0) >> COL_SHIFT));
        out(1, c, static_cast<int>((a1 + b1) >> COL_SHIFT));
        out(2, c, static_cast<int>((a2 + b2) >> COL_SHIFT));
        out(3, c, static_cast<int>((a3 + b3) >> COL_SHIFT));
        out(4, c, static_cast<int>((a3 - b3) >> COL_SHIFT));
        out(5, c, static_cast<int>((a2 - b2) >> COL_SHIFT));
        out(6, c, static_cast<int>((a1 - b1) >> COL_SHIFT));
        out(7, c, static_cast<int>((a0 - b0) >> COL_SHIFT));
    }
}

inline uint8_t clip8(int64_t v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// idct_put: the block's samples, clipped
inline void simple_idct_put(const int16_t* coef, uint8_t* dst, size_t stride) {
    simple_idct(coef, [&](int r, int c, int v) { dst[r * stride + c] = clip8(v); });
}

// idct_add: the block's residual added to the prediction in dst, clipped
inline void simple_idct_add(const int16_t* coef, uint8_t* dst, size_t stride) {
    simple_idct(coef, [&](int r, int c, int v) {
        uint8_t& d = dst[r * stride + c];
        d = clip8(int(d) + v);
    });
}

// A component's samples as FFmpeg's frame holds them: w x h of a plane with
// `stride` samples a row (8 bits a sample, or up to 16 in PlaneT<uint16_t>).
template <class T>
struct PlaneT {
    std::vector<T> px;
    size_t stride = 0;
    int w = 0, h = 0;
    T at(int y, int x) const { return px[size_t(y) * stride + x]; }
};
using Plane = PlaneT<uint8_t>;
using Plane16 = PlaneT<uint16_t>;

// libswscale's integer filter for one axis: dst sample i is
// sum_j coef[i * size + j] * src[pos[i] + j].
struct Filter {
    int size = 1;
    std::vector<int32_t> pos;
    std::vector<int32_t> coef;
};

// utils.c's get_local_pos: a chroma position (swscale's src_h_chr_pos /
// src_v_chr_pos, in 1/256 of a luma sample; -513 its default, the centre
// of the chroma sample's luma samples) on the subsampled grid
inline int local_pos(int subsample, int pos = -513) {
    if (pos == -1 || pos <= -513) pos = (128 << subsample) - 128;
    return (pos + 128) >> subsample;
}

inline int64_t rounded_div(int64_t a, int64_t b) {
    return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b;
}

// utils.c's initFilter, SWS_BICUBIC (B = 0, C = 0.6), no source or
// destination filter; `align` is the filter size's multiple (4 for the
// horizontal scaler on x86, 2 for the vertical), `one` the taps' sum
inline Filter init_filter(int64_t inc, int src, int dst, int align, int one, int src_pos,
                          int dst_pos) {
    int log2 = 0;
    for (int q = src / dst; q > 1; q >>= 1) ++log2;
    const int64_t fone = int64_t(1) << (54 - std::min(log2, 8));
    int fs;
    std::vector<int64_t> f;
    std::vector<int32_t> pos(dst);
    if (std::llabs(inc - 0x10000) < 10 && src_pos == dst_pos) {  // unscaled
        fs = 1;
        f.assign(dst, fone);
        for (int i = 0; i < dst; ++i) pos[i] = i;
    } else {
        const int size_factor = 4;
        fs = inc <= (1 << 16) ? 1 + size_factor
                              : 1 + static_cast<int>((int64_t(size_factor) * src + dst - 1) / dst);
        fs = std::max(std::min(fs, src - 2), 1);
        f.assign(size_t(dst) * fs, 0);
        const int64_t B = 0, C = static_cast<int64_t>(0.6 * (1 << 24));
        int64_t x_dst_in_src = ((dst_pos * inc) >> 7) - ((src_pos * int64_t(0x10000)) >> 7);
        for (int i = 0; i < dst; ++i) {
            int64_t xx = (x_dst_in_src - (fs - 2) * (int64_t(1) << 16)) / (1 << 17);
            pos[i] = static_cast<int32_t>(xx);
            for (int j = 0; j < fs; ++j, ++xx) {
                int64_t d = std::llabs(xx * (1 << 17) - x_dst_in_src) << 13;
                if (inc > 1 << 16) d = d * dst / src;
                int64_t coeff;
                if (d >= int64_t(1) << 31) {
                    coeff = 0;
                } else {
                    const int64_t dd = (d * d) >> 30, ddd = (dd * d) >> 30;
                    if (d < int64_t(1) << 30)
                        coeff = (12 * (int64_t(1) << 24) - 9 * B - 6 * C) * ddd +
                                (-18 * (int64_t(1) << 24) + 12 * B + 6 * C) * dd +
                                (6 * (int64_t(1) << 24) - 2 * B) * (int64_t(1) << 30);
                    else
                        coeff = (-B - 6 * C) * ddd + (6 * B + 30 * C) * dd +
                                (-12 * B - 48 * C) * d + (8 * B + 24 * C) * (int64_t(1) << 30);
                    coeff /= (int64_t(1) << 54) / fone;
                }
                f[size_t(i) * fs + j] = coeff;
            }
            x_dst_in_src += 2 * inc;
        }
    }
    // drop near-zero taps: shift left, then count from the right
    const double cut_limit = 0.002 * double(fone);
    int min_size = 0;
    for (int i = dst - 1; i >= 0; --i) {
        int64_t* row = &f[size_t(i) * fs];
        int64_t cut = 0;
        for (int j = 0; j < fs; ++j) {
            cut += std::llabs(row[0]);
            if (double(cut) > cut_limit) break;
            if (i < dst - 1 && pos[i] >= pos[i + 1]) break;
            for (int k = 1; k < fs; ++k) row[k - 1] = row[k];
            row[fs - 1] = 0;
            ++pos[i];
        }
        int m = fs;
        cut = 0;
        for (int j = fs - 1; j > 0; --j) {
            cut += std::llabs(row[j]);
            if (double(cut) > cut_limit) break;
            --m;
        }
        min_size = std::max(min_size, m);
    }
    if (min_size == 1 && align == 2) align = 1;
    const int size = (min_size + align - 1) & ~(align - 1);
    std::vector<int64_t> g(size_t(dst) * size, 0);
    for (int i = 0; i < dst; ++i)
        for (int j = 0; j < size && j < fs; ++j) g[size_t(i) * size + j] = f[size_t(i) * fs + j];
    // fold taps that fall outside the source into the edge taps
    for (int i = 0; i < dst; ++i) {
        int64_t* row = &g[size_t(i) * size];
        if (pos[i] < 0) {
            for (int j = 1; j < size; ++j) {
                const int left = std::max(j + pos[i], 0);
                row[left] += row[j];
                row[j] = 0;
            }
            pos[i] = 0;
        }
        if (pos[i] + size > src) {
            const int shift = pos[i] + std::min(size - src, 0);
            int64_t acc = 0;
            for (int j = size - 1; j >= 0; --j)
                if (pos[i] + j >= src) {
                    acc += row[j];
                    row[j] = 0;
                }
            for (int j = size - 1; j >= 0; --j) row[j] = j < shift ? 0 : row[j - shift];
            pos[i] -= shift;
            row[src - 1 - pos[i]] += acc;
        }
    }
    // normalize to `one`, carrying each tap's rounding error into the next
    Filter out;
    out.size = size;
    out.pos = pos;
    out.coef.assign(size_t(dst) * size, 0);
    for (int i = 0; i < dst; ++i) {
        const int64_t* row = &g[size_t(i) * size];
        int64_t sum = 0;
        for (int j = 0; j < size; ++j) sum += row[j];
        sum = (sum + one / 2) / one;
        if (!sum) sum = 1;
        int64_t err = 0;
        for (int j = 0; j < size; ++j) {
            const int64_t v = row[j] + err;
            const int64_t iv = rounded_div(v, sum);
            out.coef[size_t(i) * size + j] = static_cast<int32_t>(static_cast<int16_t>(iv));
            err = v - iv * sum;
        }
    }
    return out;
}

// the chroma filter of one axis: src samples subsampled (1) or not (0), to
// dst samples at dst_sub; src_pos the source siting (local_pos)
inline Filter chroma_filter(int src, int dst, int subsampled, int align, int one,
                            int src_pos = -513, int dst_sub = 0) {
    const int64_t inc = ((int64_t(src) << 16) + (dst >> 1)) / dst;
    return init_filter(inc, src, dst, align, one, local_pos(subsampled, src_pos),
                       local_pos(dst_sub));
}

// sws_setColorspaceDetails' coefficients (a row of ff_yuv2rgb_coeffs: crv,
// cbu, cgu, cgv; BT.601 by default), contrast and saturation 1,
// brightness 0
struct Coeffs {
    // the SIMD and MMX converters: 2^13-scaled, used through pmulhw
    int y, oy8, vr, ug, vg, ub;
    // yuv2rgb_write_full: the luma offset and gain on the 2^9 scale
    int oy9;
    // yuv2rgb.c's tables: the luma gain and offset (2^16), the luma
    // table's origin, the chroma coefficients over the luma gain (2^16)
    int64_t cy, oy, yoffs, tvr, tug, tvg, tub;
};

inline int round_to_int16(int64_t f) {
    const int64_t r = (f + (1 << 15)) >> 16;
    return static_cast<int>(r < -0x7FFF ? -0x8000 : (r > 0x7FFF ? 0x7FFF : r));
}

// ff_yuv2rgb_coeffs' rows for the matrices swscale tells apart
const int32_t BT601[4] = {104597, 132201, 25675, 53279};
const int32_t BT709[4] = {117489, 138438, 13975, 34925};
const int32_t SMPTE240M[4] = {117579, 136230, 16907, 35559};
const int32_t BT2020[4] = {110013, 140363, 12277, 42626};

inline Coeffs coeffs(bool full_range, const int32_t* matrix = BT601) {
    int64_t crv = matrix[0], cbu = matrix[1], cgu = -int64_t(matrix[2]), cgv = -int64_t(matrix[3]);
    int64_t cy = 1 << 16, oy = 0;
    if (!full_range) {
        cy = cy * 255 / 219;
        oy = 16 << 16;
    } else {
        crv = crv * 224 / 255;
        cbu = cbu * 224 / 255;
        cgu = cgu * 224 / 255;
        cgv = cgv * 224 / 255;
    }
    Coeffs k;
    k.y = round_to_int16(cy * (1 << 13));
    k.oy8 = round_to_int16(oy * (1 << 3));
    k.vr = round_to_int16(crv * (1 << 13));
    k.ug = round_to_int16(cgu * (1 << 13));
    k.vg = round_to_int16(cgv * (1 << 13));
    k.ub = round_to_int16(cbu * (1 << 13));
    k.oy9 = round_to_int16(oy * (1 << 9));
    k.cy = cy;
    k.oy = oy;
    k.yoffs = full_range ? 384 : 326;
    k.tvr = (crv * (1 << 16) + 0x8000) / cy;
    k.tub = (cbu * (1 << 16) + 0x8000) / cy;
    k.tug = (cgu * (1 << 16) + 0x8000) / cy;
    k.tvg = (cgv * (1 << 16) + 0x8000) / cy;
    return k;
}

// the unscaled SIMD converter's (and the MMX vertical scaler's) arithmetic:
// luma y8 and chroma u8, v8 on the 8x scale
inline void put_pmulhw(const Coeffs& k, uint8_t* o, int y8, int u8, int v8) {
    const int y = ((y8 - k.oy8) * k.y) >> 16, u = u8 - 1024, v = v8 - 1024;
    o[0] = clip8(y + ((v * k.vr) >> 16));
    o[1] = clip8(y + ((u * k.ug) >> 16) + ((v * k.vg) >> 16));
    o[2] = clip8(y + ((u * k.ub) >> 16));
}

// yuv2rgb.c's lookup tables, for the C vertical scaler's rows
inline int64_t table_term(int c, int64_t k) { return ((c * k) >> 16) - (k >> 9); }

// the luma table: entry y of yb = (y + yoffs) cy - 384 2^16 - oy
inline uint8_t table_y(const Coeffs& k, int64_t y) {
    return clip8(((y + k.yoffs) * k.cy - (int64_t(384) << 16) - k.oy + 0x8000) >> 16);
}

inline void put_table(const Coeffs& k, uint8_t* o, int y, int u, int v) {
    o[0] = table_y(k, y + table_term(v, k.tvr));
    o[1] = table_y(k, y + table_term(u, k.tug) + table_term(v, k.tvg));
    o[2] = table_y(k, y + table_term(u, k.tub));
}

// output.c's yuv2rgb_write_full: Y, U, V on the full path's 2^9 scale,
// summed in 32-bit unsigned arithmetic and read back as int (a sum past
// 2^31 wraps negative and clips to 0, as there)
inline void put_full(const Coeffs& k, uint8_t* o, int64_t y, int64_t u, int64_t v) {
    const uint32_t yy = static_cast<uint32_t>((y - k.oy9) * k.y + (1 << 21));
    const int32_t r = static_cast<int32_t>(yy + uint32_t(v) * uint32_t(k.vr));
    const int32_t g = static_cast<int32_t>(yy + uint32_t(v) * uint32_t(k.vg) + uint32_t(u) * uint32_t(k.ug));
    const int32_t b = static_cast<int32_t>(yy + uint32_t(u) * uint32_t(k.ub));
    auto c = [](int32_t x) {
        x = x < 0 ? 0 : (x > (1 << 30) - 1 ? (1 << 30) - 1 : x);
        return static_cast<uint8_t>(x >> 22);
    };
    o[0] = c(r);
    o[1] = c(g);
    o[2] = c(b);
}

// The 15-bit chroma rows of the horizontal scaler (hScale8To15; for samples
// of `depth` > 8 bits hScale16To15, the sums shifted by depth - 1).
template <class T>
std::vector<int32_t> hscale(const PlaneT<T>& p, const Filter& f, int dst, int depth = 8) {
    std::vector<int32_t> out(size_t(p.h) * dst);
    for (int y = 0; y < p.h; ++y)
        for (int i = 0; i < dst; ++i) {
            int64_t s = 0;
            for (int j = 0; j < f.size; ++j) {
                const int x = std::min(f.pos[i] + j, p.w - 1);
                s += int64_t(f.coef[size_t(i) * f.size + j]) * p.at(y, x);
            }
            out[size_t(y) * dst + i] = static_cast<int32_t>(std::min<int64_t>(s >> (depth - 1), 32767));
        }
    return out;
}

// w x h pixels of planes pl (grey when ncomp is 1; else Y, U, V with the
// chroma subsampled by rx horizontally and ry vertically, 1 or 2) as
// packed RGB in out, as swscale converts them to BGR24 (channels reversed).
// chroma_h_pos: the chroma's horizontal siting as the frame reports it to
// swscale (-513: the centre, its default and Motion-JPEG's; 0: left, MPEG-4
// Part 2's AVCHROMA_LOC_LEFT), which only the filtering routes read.
// depth: the bits of a sample (8, or 10 / 12 in 16-bit planes).
template <class T>
void yuv_to_rgb(int w, int h, int ncomp, int rx, int ry, const PlaneT<T>* pl, bool full_range,
                uint8_t* out, int chroma_h_pos = -513, const int32_t* matrix = BT601,
                int depth = 8) {
    const PlaneT<T>& Y = pl[0];
    // a luma sample on the 15-bit scale (the unscaled horizontal scaler's one tap)
    auto y15 = [&](int y, int x) { return int64_t(Y.at(y, x)) << (15 - depth); };
    if (ncomp == 1) {
        for (int y = 0; y < h; ++y)
            for (int x = 0; x < w; ++x) {
                uint8_t* o = out + (size_t(y) * w + x) * 3;
                o[0] = o[1] = o[2] = Y.at(y, x);
            }
        return;
    }
    const Coeffs k = coeffs(full_range, matrix);
    const PlaneT<T> &U = pl[1], &V = pl[2];
    if (depth == 8 && rx == 2 && h % 2 == 0) {  // the unscaled SIMD converter
        for (int y = 0; y < h; ++y) {
            const T* yr = &Y.px[size_t(y) * Y.stride];
            const T* ur = &U.px[size_t(y / ry) * U.stride];
            const T* vr = &V.px[size_t(y / ry) * V.stride];
            uint8_t* o = out + size_t(y) * w * 3;
            for (int x = 0; x < w; ++x)
                put_pmulhw(k, o + 3 * x, yr[x] * 8, ur[x / 2] * 8, vr[x / 2] * 8);
        }
        return;
    }
    const Filter vf = chroma_filter(U.h, h, ry - 1, 2, 1 << 12);
    if ((rx == 1 && ry == 1) || w % 2 == 1) {  // full chroma: resampled to w x h, then write_full
        const Filter hf = chroma_filter(U.w, w, rx - 1, 4, 1 << 14, chroma_h_pos);
        const std::vector<int32_t> u15 = hscale(U, hf, w, depth), v15 = hscale(V, hf, w, depth);
        for (int y = 0; y < h; ++y) {
            const int32_t* c = &vf.coef[size_t(y) * vf.size];
            // a 2-tap row summing to 4096 takes yuv2rgb_full_1 (the taps as
            // uvalpha, no rounding term), any other yuv2rgb_full_X
            const bool one = vf.size == 2 && c[0] + c[1] == 4096 && c[1] >= 0 && c[1] <= 4096;
            for (int x = 0; x < w; ++x) {
                int64_t su = one ? -(int64_t(128) << 19) : (1 << 9) - (int64_t(128) << 19), sv = su;
                for (int j = 0; j < vf.size; ++j) {
                    const int r = std::min(vf.pos[y] + j, U.h - 1);
                    su += int64_t(c[j]) * u15[size_t(r) * w + x];
                    sv += int64_t(c[j]) * v15[size_t(r) * w + x];
                }
                put_full(k, out + (size_t(y) * w + x) * 3, y15(y, x) << 2, su >> 10, sv >> 10);
            }
        }
        return;
    }
    // chroma at half width (through the horizontal scaler: one tap, unless
    // the siting moves it; 4:4:0 chroma halved), filtered vertically: MMX
    // rows, then two C rows
    const int cw = (w + 1) >> 1;
    const Filter hf = chroma_filter(U.w, cw, rx - 1, 4, 1 << 14, chroma_h_pos, 1);
    const std::vector<int32_t> u15 = hscale(U, hf, cw, depth), v15 = hscale(V, hf, cw, depth);
    std::vector<int> uc(cw), vc(cw);
    for (int y = 0; y < h; ++y) {
        const int32_t* c = &vf.coef[size_t(y) * vf.size];
        const int r0 = vf.pos[y];
        auto line = [&](const PlaneT<T>& p, int j, int x) {  // the 15-bit rows
            return int64_t((&p == &U ? u15 : v15)[size_t(std::min(r0 + j, p.h - 1)) * cw + x]);
        };
        const bool mmx = y < h - 2;
        const bool one_line = vf.size == 1 || (mmx && vf.size == 2 && c[0] + c[1] == 4096 &&
                                               c[1] >= 0 && c[1] <= 4096);
        for (int x = 0; x < cw; ++x) {
            for (int ch = 0; ch < 2; ++ch) {
                const PlaneT<T>& p = ch ? V : U;
                int64_t s;
                if (mmx && one_line) {  // yuv2packed1: one line, or the mean of two
                    // (a 16-bit sum shifted logically, psrlw: a negative sum
                    // from an overshooting horizontal filter reads high)
                    s = (vf.size == 1 || c[1] < 2048)
                            ? line(p, 0, x) >> 4
                            : static_cast<uint16_t>(line(p, 0, x) + line(p, 1, x)) >> 5;
                } else if (mmx) {  // yuv2packedX: pmulhw per tap, plus the rounder
                    s = 4;
                    for (int j = 0; j < vf.size; ++j) s += (line(p, j, x) * c[j]) >> 16;
                    s = static_cast<int16_t>(s);
                } else {
                    s = int64_t(1) << 18;
                    for (int j = 0; j < vf.size; ++j) s += line(p, j, x) * c[j];
                    s = clip8(s >> 19);
                }
                (ch ? vc : uc)[x] = static_cast<int>(s);
            }
        }
        // luma through the same vertical scaler: its 15-bit value >> 4 (one
        // line) or >> 4 plus 4 (8 Y, 8 Y + 4 at 8 bits), or in the C rows
        // rounded to 8 bits (Y itself at 8 bits; up to 256 from deeper
        // samples, which the luma table's headroom takes unclipped)
        const int ly = mmx && !one_line ? 4 : 0;
        for (int x = 0; x < w; ++x) {
            uint8_t* o = out + (size_t(y) * w + x) * 3;
            if (mmx) put_pmulhw(k, o, int((y15(y, x) >> 4) + ly), uc[x / 2], vc[x / 2]);
            else put_table(k, o, int((y15(y, x) + 64) >> 7), uc[x / 2], vc[x / 2]);
        }
    }
}

}  // namespace fmvfi_ff
