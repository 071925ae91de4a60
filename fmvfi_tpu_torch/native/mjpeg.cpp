// fmvfi_tpu_torch native host runtime: Motion-JPEG frames decoded as
// cv2.VideoCapture decodes them, for fmvfi_tpu_torch/utils/avi.py.
//
// cv2's video backend is FFmpeg: its mjpeg decoder turns a frame into
// planar full-range samples (yuvj420p, yuvj422p, yuvj444p or gray), and
// OpenCV converts those to BGR24 with swscale at the same size
// (sws_getCachedContext(..., AV_PIX_FMT_BGR24, SWS_BICUBIC, ...)).  Neither
// stage is libjpeg's, so a frame differs from cv2.imdecode of the same bytes
// by up to tens of levels.  This file repeats both, bit for bit:
//   - the decoder: the entropy decoding of jpeg.cpp (Annex K.3's tables
//     when the frame has no DHT, the AVI1 convention), coefficients
//     dequantized into 16 bits with the DC offset by 1024 (FFmpeg's level
//     shift), and FFmpeg's integer "simple" IDCT (rows then columns,
//     W1..W7 = cos(k pi / 16) sqrt(2) 2^14, shifts 11 and 20, a row of
//     zero ACs taken as 8 x DC);
//   - swscale's BT.601 full-range conversion, whose route depends on the
//     size, each route with its own arithmetic:
//       * 4:2:0 and 4:2:2 of even height: the unscaled SIMD converter, each
//         chroma sample used for its 2x2 (2x1) pixels, the terms
//         (8 C - 1024) * k >> 16 (pmulhw) with k = 14516, -2819, -5850 and
//         11485, added to Y and saturated;
//       * 4:4:4, and 4:2:0 / 4:2:2 of odd height and odd width: chroma
//         resampled to full size by swscale's bicubic filters (B = 0,
//         C = 0.6, chroma sited at the centre of its 2x2 or 2x1 pixels;
//         14-bit horizontal and 12-bit vertical integer taps built as
//         libswscale's initFilter builds them, edges folded in), then
//         yuv2rgb_write_full: (Y 2^22 + 2^21 + terms 11485 V, -5850 V
//         - 2819 U, 14516 U on 2^9-scaled chroma) clipped to 30 bits,
//         >> 22;
//       * 4:2:0 / 4:2:2 of odd height and even width: chroma filtered
//         vertically only, each sample used for two pixels; every row but
//         the last two takes the MMX vertical scaler (per-tap pmulhw
//         sums plus 4, or one line or the mean of two for a 2-tap row
//         whose taps sum to 4096) and the pmulhw terms above, the last two
//         the C scaler (rounded 19-bit sums) and the 8-bit lookup tables
//         (C * k >> 16 - (k >> 9), k = 116129, -22552, -46800, 91881);
//       * grey: Y repeated to three channels.
// Progressive frames, and samplings other than 4:2:0, 4:2:2 and 4:4:4
// (after removing a factor common to all three components), are refused
// as unsupported.
//
// Exposed C ABI (ctypes):
//   fmvfi_mjpeg_decode(data, n, out, msg, msglen) -> int32
//     out: height * width * 3 bytes, RGB; returns 0, 1 (unsupported) or 2
//     (corrupt), msg saying why.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "jpeg_common.h"

namespace fmvfi_jpeg {

namespace {

// FFmpeg's simple_idct_template.c, 8-bit: rows in place (16-bit results),
// then columns put as clipped samples
const int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;
const int ROW_SHIFT = 11, COL_SHIFT = 20;

void simple_idct_put(const int16_t* coef, uint8_t* out, size_t stride) {
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
    auto put = [](int64_t v) {
        v >>= COL_SHIFT;
        return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
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
        uint8_t* o = out + c;
        o[0 * stride] = put(a0 + b0);
        o[1 * stride] = put(a1 + b1);
        o[2 * stride] = put(a2 + b2);
        o[3 * stride] = put(a3 + b3);
        o[4 * stride] = put(a3 - b3);
        o[5 * stride] = put(a2 - b2);
        o[6 * stride] = put(a1 - b1);
        o[7 * stride] = put(a0 - b0);
    }
}

// A component's samples as FFmpeg's frame holds them: w_real x h_real of a
// plane with `stride` bytes a row.
struct Plane {
    std::vector<uint8_t> px;
    size_t stride = 0;
    int w = 0, h = 0;
    uint8_t at(int y, int x) const { return px[size_t(y) * stride + x]; }
};

Plane idct_plane(const Component& c) {
    Plane p;
    p.stride = size_t(c.bw) * 8;
    p.w = c.w_real;
    p.h = c.h_real;
    p.px.assign(p.stride * size_t(c.bh) * 8, 0);
    for (int by = 0; by < c.hb; ++by)
        for (int bx = 0; bx < c.wb; ++bx)
            simple_idct_put(c.block(by, bx), p.px.data() + size_t(by) * 8 * p.stride + size_t(bx) * 8,
                            p.stride);
    return p;
}

// libswscale's integer filter for one axis: dst sample i is
// sum_j coef[i * size + j] * src[pos[i] + j].
struct Filter {
    int size = 1;
    std::vector<int32_t> pos;
    std::vector<int32_t> coef;
};

// utils.c's get_local_pos for a chroma position left at its default
int local_pos(int subsample) { return ((128 << subsample) - 128 + 128) >> subsample; }

int64_t rounded_div(int64_t a, int64_t b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

// utils.c's initFilter, SWS_BICUBIC (B = 0, C = 0.6), no source or
// destination filter; `align` is the filter size's multiple (4 for the
// horizontal scaler on x86, 2 for the vertical), `one` the taps' sum
Filter init_filter(int64_t inc, int src, int dst, int align, int one, int src_pos, int dst_pos) {
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

Filter chroma_filter(int src, int dst, int subsampled, int align, int one) {
    const int64_t inc = ((int64_t(src) << 16) + (dst >> 1)) / dst;
    return init_filter(inc, src, dst, align, one, local_pos(subsampled), local_pos(0));
}

inline uint8_t clip8(int64_t v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// the unscaled SIMD converter's (and the MMX vertical scaler's) arithmetic:
// chroma c8 = 8 x the 8-bit value
inline void put_pmulhw(uint8_t* o, int y, int u8, int v8) {
    const int u = u8 - 1024, v = v8 - 1024;
    o[0] = clip8(y + ((v * 11485) >> 16));
    o[1] = clip8(y + ((u * -2819) >> 16) + ((v * -5850) >> 16));
    o[2] = clip8(y + ((u * 14516) >> 16));
}

// yuv2rgb.c's lookup tables, for the C vertical scaler's rows
inline int table_term(int c, int k) { return ((c * k) >> 16) - (k >> 9); }

inline void put_table(uint8_t* o, int y, int u, int v) {
    o[0] = clip8(y + table_term(v, 91881));
    o[1] = clip8(y + table_term(u, -22552) + table_term(v, -46800));
    o[2] = clip8(y + table_term(u, 116129));
}

// output.c's yuv2rgb_write_full: Y, U, V on the full path's 2^9 scale
inline void put_full(uint8_t* o, int64_t y, int64_t u, int64_t v) {
    const int64_t yy = y * 8192 + (1 << 21);
    auto c = [](int64_t x) {
        x = x < 0 ? 0 : (x > (1 << 30) - 1 ? (1 << 30) - 1 : x);
        return static_cast<uint8_t>(x >> 22);
    };
    o[0] = c(yy + v * 11485);
    o[1] = c(yy + v * -5850 + u * -2819);
    o[2] = c(yy + u * 14516);
}

// The 15-bit chroma rows of the horizontal scaler (hScale8To15).
std::vector<int32_t> hscale(const Plane& p, const Filter& f, int dst) {
    std::vector<int32_t> out(size_t(p.h) * dst);
    for (int y = 0; y < p.h; ++y)
        for (int i = 0; i < dst; ++i) {
            int64_t s = 0;
            for (int j = 0; j < f.size; ++j) {
                const int x = std::min(f.pos[i] + j, p.w - 1);
                s += int64_t(f.coef[size_t(i) * f.size + j]) * p.at(y, x);
            }
            out[size_t(y) * dst + i] = static_cast<int32_t>(std::min<int64_t>(s >> 7, 32767));
        }
    return out;
}

void convert(const Image& img, const std::vector<Plane>& pl, uint8_t* out) {
    const int w = img.width, h = img.height;
    const Plane& Y = pl[0];
    if (img.ncomp == 1) {
        for (int y = 0; y < h; ++y)
            for (int x = 0; x < w; ++x) {
                uint8_t* o = out + (size_t(y) * w + x) * 3;
                o[0] = o[1] = o[2] = Y.at(y, x);
            }
        return;
    }
    const Plane &U = pl[1], &V = pl[2];
    const int rx = img.hmax / img.comps[1].h, ry = img.vmax / img.comps[1].v;
    if (rx == 2 && h % 2 == 0) {  // the unscaled SIMD converter
        for (int y = 0; y < h; ++y)
            for (int x = 0; x < w; ++x)
                put_pmulhw(out + (size_t(y) * w + x) * 3, Y.at(y, x), U.at(y / ry, x / 2) * 8,
                           V.at(y / ry, x / 2) * 8);
        return;
    }
    const Filter vf = chroma_filter(U.h, h, ry - 1, 2, 1 << 12);
    if (rx == 1 || w % 2 == 1) {  // full chroma: resampled to w x h, then write_full
        const Filter hf = chroma_filter(U.w, w, rx - 1, 4, 1 << 14);
        const std::vector<int32_t> u15 = hscale(U, hf, w), v15 = hscale(V, hf, w);
        for (int y = 0; y < h; ++y)
            for (int x = 0; x < w; ++x) {
                int64_t su = (1 << 9) - (int64_t(128) << 19), sv = su;
                for (int j = 0; j < vf.size; ++j) {
                    const int r = std::min(vf.pos[y] + j, U.h - 1);
                    const int64_t k = vf.coef[size_t(y) * vf.size + j];
                    su += k * u15[size_t(r) * w + x];
                    sv += k * v15[size_t(r) * w + x];
                }
                put_full(out + (size_t(y) * w + x) * 3, int64_t(Y.at(y, x)) << 9, su >> 10,
                         sv >> 10);
            }
        return;
    }
    // chroma at half width, filtered vertically: MMX rows, then two C rows
    const int cw = U.w;
    std::vector<int> uc(cw), vc(cw);
    for (int y = 0; y < h; ++y) {
        const int32_t* k = &vf.coef[size_t(y) * vf.size];
        const int r0 = vf.pos[y];
        auto line = [&](const Plane& p, int j, int x) {  // 15-bit: the 1-tap horizontal scaler
            return int64_t(p.at(std::min(r0 + j, p.h - 1), x)) << 7;
        };
        const bool mmx = y < h - 2;
        const bool one_line = vf.size == 1 || (mmx && vf.size == 2 && k[0] + k[1] == 4096 &&
                                               k[1] >= 0 && k[1] <= 4096);
        for (int x = 0; x < cw; ++x) {
            for (int c = 0; c < 2; ++c) {
                const Plane& p = c ? V : U;
                int64_t s;
                if (mmx && one_line) {  // yuv2packed1: one line, or the mean of two
                    s = (vf.size == 1 || k[1] < 2048) ? line(p, 0, x) >> 4
                                                     : (line(p, 0, x) + line(p, 1, x)) >> 5;
                } else if (mmx) {  // yuv2packedX: pmulhw per tap, plus the rounder
                    s = 4;
                    for (int j = 0; j < vf.size; ++j) s += (line(p, j, x) * k[j]) >> 16;
                    s = static_cast<int16_t>(s);
                } else {
                    s = int64_t(1) << 18;
                    for (int j = 0; j < vf.size; ++j) s += line(p, j, x) * k[j];
                    s = clip8(s >> 19);
                }
                (c ? vc : uc)[x] = static_cast<int>(s);
            }
        }
        for (int x = 0; x < w; ++x) {
            uint8_t* o = out + (size_t(y) * w + x) * 3;
            if (mmx) put_pmulhw(o, Y.at(y, x), uc[x / 2], vc[x / 2]);
            else put_table(o, Y.at(y, x), uc[x / 2], vc[x / 2]);
        }
    }
}

void decode_mjpeg(const uint8_t* d, size_t n, uint8_t* out) {
    Image img;
    read_header(d, n, img);
    if (img.progressive)
        fail(UNSUPPORTED, "a progressive (SOF2) Motion-JPEG frame; only sequential frames "
                          "(SOF0, SOF1) are decoded as FFmpeg decodes them");
    if (img.ncomp == 3) {
        const Component &l = img.comps[0], &cb = img.comps[1], &cr = img.comps[2];
        const bool ok = cb.h == cr.h && cb.v == cr.v && l.h % cb.h == 0 && l.v % cb.v == 0 &&
                        (l.h / cb.h == 1 || l.h / cb.h == 2) &&
                        (l.v / cb.v == 1 || (l.v / cb.v == 2 && l.h / cb.h == 2));
        if (!ok)
            fail(UNSUPPORTED, "a Motion-JPEG frame sampled other than 4:2:0, 4:2:2 or 4:4:4");
    }
    img = Image();
    decode_coefficients(d, n, img, Store::FFMPEG);
    std::vector<Plane> planes;
    for (const Component& c : img.comps) planes.push_back(idct_plane(c));
    convert(img, planes, out);
}

}  // namespace

}  // namespace fmvfi_jpeg

using namespace fmvfi_jpeg;

extern "C" {

int32_t fmvfi_mjpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, char* msg,
                           int32_t msglen) {
    try {
        decode_mjpeg(data, static_cast<size_t>(n), out);
        return OK;
    } catch (const Error& e) {
        return report(e, msg, msglen);
    } catch (const std::bad_alloc&) {
        return report(Error{CORRUPT, "out of memory"}, msg, msglen);
    }
}

}  // extern "C"
