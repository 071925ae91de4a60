// fmvfi_tpu_torch native host runtime: WebP pixels for
// fmvfi_tpu_torch/utils/webp.py, as libwebp (under cv2.imread) and FFmpeg
// (under cv2.VideoCapture) produce them.
//
// 1. libwebp's RGB output of a lossy (VP8) key frame: the Y, U and V planes
//    that vp8.cpp decodes (libwebp's VP8 decoder and FFmpeg's both follow
//    the spec to the bit), through libwebp's "fancy" upsampler
//    (UpsampleRgbLinePair: each output chroma sample is (9, 3, 3, 1) / 16 of
//    its four nearest, the first and the last row, and the last column of an
//    even width, from one chroma row or column) and its 14-bit fixed-point
//    VP8YUVToR / G / B (yuv.h: MultHi(y, 19077), YUV_FIX2 = 6).
// 2. A VP8L (lossless) decoder, after libwebp's vp8l_dec.c and the
//    specification (RFC 9649): prefix codes (simple and normal, the code
//    length code, the max_symbol field, repeat codes 16-18; a code of one
//    symbol reads no bits; an incomplete or over-full code is an error),
//    meta prefix codes (the entropy image), the colour cache, LZ77 backward
//    references with the 120-entry distance map, and the four transforms:
//    predictor (modes 0-13; 14 and 15 read as 0, as libwebp pads them),
//    cross-colour, subtract-green and colour indexing with pixel bundling.
//    The output is ARGB, as both libwebp and FFmpeg decode it.
// 3. A VP8L encoder for imwrite: subtract-green, the predictor transform
//    (16x16 tiles, each with the mode of least absolute residual), a colour
//    cache of 2^10 entries and one group of length-limited Huffman codes,
//    no LZ77.  Its bytes are not libwebp's (cv2.imwrite's); the pixels read
//    back are the ones written.
//
// Exposed C ABI (ctypes):
//   fmvfi_webp_yuv_rgb(y, u, v, ystride, uvstride, w, h, out)
//     out: h x w x 3 RGB, as libwebp's fancy upsampling gives it.
//   fmvfi_vp8l_decode(src, n, ffmpeg, out_argb, cap, info, msg, msglen) -> int32
//     as libwebp decodes it, or (ffmpeg) as FFmpeg's vp8l decoder does;
//     info: width, height, feature bits (VP8L_*); out_argb may be null to
//     read the header only (returns 0 with info[0..1] set); 0 or 2 (corrupt).
//   fmvfi_vp8l_decode_image(src, n, w, h, out_argb, msg, msglen) -> int32
//     a VP8L image stream without its header, of a size given (a lossy
//     WebP's VP8L-coded ALPH chunk: alpha in green); 0 or 2 (corrupt).
//   fmvfi_vp8l_encode(rgb, w, h, out, cap) -> int64
//     the VP8L bitstream's byte count, or -1 when it would pass cap.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <numeric>
#include <queue>
#include <string>
#include <vector>

#include "jpeg_common.h"

namespace {

using fmvfi_jpeg::CORRUPT;
using fmvfi_jpeg::Error;
using fmvfi_jpeg::fail;
using fmvfi_jpeg::OK;

// ---------------------------------------------------------------- lossy RGB

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }

inline uint8_t clip8(int v) {
    constexpr int MASK = (256 << 6) - 1;
    return uint8_t((v & ~MASK) == 0 ? (v >> 6) : (v < 0) ? 0 : 255);
}

inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
    rgb[0] = clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    rgb[1] = clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    rgb[2] = clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// UpsampleRgbLinePair: two output rows (bottom may be null) from the chroma
// rows above (top) and below (cur) them, u and v computed together as libwebp
// packs them (LOAD_UV), which equals computing each alone
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
    auto load = [](uint8_t u, uint8_t v) { return uint32_t(u) | (uint32_t(v) << 16); };
    const int last_pair = (len - 1) >> 1;
    uint32_t tl = load(top_u[0], top_v[0]), l = load(cur_u[0], cur_v[0]);
    {
        const uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
        yuv_to_rgb(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
    }
    if (bottom_y) {
        const uint32_t uv0 = (3 * l + tl + 0x00020002u) >> 2;
        yuv_to_rgb(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
    }
    for (int x = 1; x <= last_pair; ++x) {
        const uint32_t t = load(top_u[x], top_v[x]), uv = load(cur_u[x], cur_v[x]);
        const uint32_t avg = tl + t + l + uv + 0x00080008u;
        const uint32_t diag_12 = (avg + 2 * (t + l)) >> 3;
        const uint32_t diag_03 = (avg + 2 * (tl + uv)) >> 3;
        {
            const uint32_t uv0 = (diag_12 + tl) >> 1, uv1 = (diag_03 + t) >> 1;
            yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, top_dst + (2 * x - 1) * 3);
            yuv_to_rgb(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + (2 * x) * 3);
        }
        if (bottom_y) {
            const uint32_t uv0 = (diag_03 + l) >> 1, uv1 = (diag_12 + uv) >> 1;
            yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (2 * x - 1) * 3);
            yuv_to_rgb(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16, bottom_dst + (2 * x) * 3);
        }
        tl = t;
        l = uv;
    }
    if (!(len & 1)) {
        {
            const uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
            yuv_to_rgb(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * 3);
        }
        if (bottom_y) {
            const uint32_t uv0 = (3 * l + tl + 0x00020002u) >> 2;
            yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * 3);
        }
    }
}

// EmitFancyRGB over the whole picture: row 0 from chroma row 0 alone, rows
// 2k+1 and 2k+2 from chroma rows k and k+1, and the last row of an even
// height from the last chroma row alone
void fancy_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v, int64_t ystride,
               int64_t uvstride, int w, int h, uint8_t* out) {
    const int64_t ostride = int64_t(w) * 3;
    upsample_pair(y, nullptr, u, v, u, v, out, nullptr, w);
    int row = 0;
    for (; row + 2 < h; row += 2) {
        const int64_t k = row >> 1;
        upsample_pair(y + (row + 1) * ystride, y + (row + 2) * ystride, u + k * uvstride,
                      v + k * uvstride, u + (k + 1) * uvstride, v + (k + 1) * uvstride,
                      out + (row + 1) * ostride, out + (row + 2) * ostride, w);
    }
    if (!(h & 1) && h > 1) {
        const int64_t k = (h - 1) >> 1;
        upsample_pair(y + (h - 1) * ystride, nullptr, u + k * uvstride, v + k * uvstride,
                      u + k * uvstride, v + k * uvstride, out + (h - 1) * ostride, nullptr, w);
    }
}

// ---------------------------------------------------------------- VP8L

enum Feature {
    PREDICTOR = 1, CROSS_COLOR = 2, SUBTRACT_GREEN = 4, COLOR_INDEXING = 8, COLOR_CACHE = 16,
    META_CODES = 32, BACKWARD_REFS = 64, SIMPLE_CODE = 128, BUNDLED = 256
};

class BitReader {
  public:
    BitReader(const uint8_t* p, size_t n) : p_(p), n_(n) {}
    uint32_t read(int nbits) {
        if (nbits == 0) return 0;
        fill();
        if (bits_ < nbits) fail(CORRUPT, "the VP8L data ends early");
        const uint32_t v = uint32_t(val_ & ((uint64_t(1) << nbits) - 1));
        val_ >>= nbits;
        bits_ -= nbits;
        return v;
    }
    uint32_t peek(int nbits) {
        fill();
        return uint32_t(val_ & ((uint64_t(1) << nbits) - 1));
    }
    int available() {
        fill();
        return bits_;
    }
    void skip(int nbits) {
        val_ >>= nbits;
        bits_ -= nbits;
    }

  private:
    void fill() {
        while (bits_ <= 56 && pos_ < n_) {
            val_ |= uint64_t(p_[pos_++]) << bits_;
            bits_ += 8;
        }
    }
    const uint8_t* p_;
    size_t n_, pos_ = 0;
    uint64_t val_ = 0;
    int bits_ = 0;
};

constexpr int MAX_LEN = 15;
constexpr int ROOT_BITS = 10;

// a canonical prefix code: a ROOT_BITS-bit table of (symbol, length) for the
// short codes, the counts and sorted symbols for the long ones
struct Code {
    int single = -1;  // the one symbol of a code that reads no bits
    std::vector<uint32_t> table;  // symbol << 8 | length; length 0: a longer code
    int count[MAX_LEN + 1] = {};
    std::vector<int> sorted;

    void build(const std::vector<uint8_t>& lengths) {
        std::fill(count, count + MAX_LEN + 1, 0);
        int used = 0;
        for (size_t s = 0; s < lengths.size(); ++s) {
            if (lengths[s] > MAX_LEN) fail(CORRUPT, "a VP8L code length over 15");
            if (lengths[s]) {
                ++count[lengths[s]];
                ++used;
                single = int(s);
            }
        }
        if (used == 0) fail(CORRUPT, "a VP8L prefix code with no symbol");
        if (used == 1) return;  // libwebp: one symbol, zero bits, whatever its length
        single = -1;
        int64_t left = 1;
        for (int len = 1; len <= MAX_LEN; ++len) {
            left = 2 * left - count[len];
            if (left < 0) fail(CORRUPT, "an over-subscribed VP8L prefix code");
        }
        if (left != 0) fail(CORRUPT, "an incomplete VP8L prefix code");
        int offs[MAX_LEN + 2] = {};
        for (int len = 1; len <= MAX_LEN; ++len) offs[len + 1] = offs[len] + count[len];
        sorted.assign(size_t(used), 0);
        for (size_t s = 0; s < lengths.size(); ++s)
            if (lengths[s]) sorted[size_t(offs[lengths[s]]++)] = int(s);
        table.assign(size_t(1) << ROOT_BITS, 0);
        uint32_t code = 0;
        size_t k = 0;
        for (int len = 1; len <= MAX_LEN; ++len) {
            for (int i = 0; i < count[len]; ++i, ++k, ++code) {
                if (len > ROOT_BITS) continue;
                uint32_t rev = 0;
                for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1u) << (len - 1 - b);
                for (uint32_t r = rev; r < (1u << ROOT_BITS); r += 1u << len)
                    table[r] = (uint32_t(sorted[k]) << 8) | uint32_t(len);
            }
            code <<= 1;
        }
    }

    int read(BitReader& br) const {
        if (single >= 0) return single;
        const uint32_t e = table[br.peek(ROOT_BITS)];
        if (e & 0xff) {
            const int len = int(e & 0xff);
            if (br.available() < len) fail(CORRUPT, "the VP8L data ends early");
            br.skip(len);
            return int(e >> 8);
        }
        // a longer code: canonical decoding bit by bit
        int code = 0, first = 0, index = 0;
        for (int len = 1; len <= MAX_LEN; ++len) {
            code |= int(br.read(1));
            if (code - first < count[len]) return sorted[size_t(index + code - first)];
            index += count[len];
            first = (first + count[len]) << 1;
            code <<= 1;
        }
        fail(CORRUPT, "a VP8L code past the table");
    }
};

constexpr int NUM_LITERALS = 256, NUM_LENGTH_CODES = 24, NUM_DISTANCE_CODES = 40;
constexpr int CODE_LENGTH_CODES = 19;
const uint8_t CODE_LENGTH_ORDER[CODE_LENGTH_CODES] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                                      7, 8, 9, 10, 11, 12, 13, 14, 15};
// the distance map: (dy << 4) | (8 - dx) of the 120 short distance codes
const uint8_t CODE_TO_PLANE[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

struct Group {
    Code codes[5];  // green (with lengths and cache), red, blue, alpha, distance
};

struct Transform {
    int type = 0, bits = 0, xsize = 0;
    std::vector<uint32_t> data;
};

class Vp8lDecoder {
  public:
    // ffmpeg: decode as FFmpeg's vp8l decoder does where it departs from
    // libwebp (a pixel read from the colour cache is not put back in it; a
    // predictor mode is the whole green byte, and one past 13 is an error)
    Vp8lDecoder(const uint8_t* p, size_t n, bool ffmpeg = false) : ffmpeg_(ffmpeg), br_(p, n) {}

    void header(int& w, int& h) {
        if (br_.read(8) != 0x2f) fail(CORRUPT, "not a VP8L bitstream (signature)");
        w = int(br_.read(14)) + 1;
        h = int(br_.read(14)) + 1;
        br_.read(1);  // alpha_is_used: a hint
        if (br_.read(3) != 0) fail(CORRUPT, "a VP8L version other than 0");
    }

    void decode(int w, int h, uint32_t* out) {
        int xsize = w;
        unsigned seen = 0;
        while (br_.read(1)) {
            Transform t;
            t.type = int(br_.read(2));
            if (seen & (1u << t.type)) fail(CORRUPT, "a VP8L transform used twice");
            seen |= 1u << t.type;
            t.xsize = xsize;
            if (t.type == 0 || t.type == 1) {
                features |= t.type == 0 ? PREDICTOR : CROSS_COLOR;
                t.bits = int(br_.read(3)) + 2;
                t.data = image(sub(xsize, t.bits), sub(h, t.bits), false);
            } else if (t.type == 3) {
                features |= COLOR_INDEXING;
                const int colors = int(br_.read(8)) + 1;
                t.bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
                if (t.bits) features |= BUNDLED;
                std::vector<uint32_t> table = image(colors, 1, false);
                t.data.assign(size_t(1) << (8 >> t.bits), 0);
                uint8_t* dst = reinterpret_cast<uint8_t*>(t.data.data());
                const uint8_t* src = reinterpret_cast<const uint8_t*>(table.data());
                for (int i = 0; i < 4; ++i) dst[i] = src[i];
                for (int i = 4; i < 4 * colors; ++i) dst[i] = uint8_t(src[i] + dst[i - 4]);
                xsize = sub(xsize, t.bits);
            } else {
                features |= SUBTRACT_GREEN;
            }
            transforms_.push_back(std::move(t));
        }
        std::vector<uint32_t> px = image(xsize, h, true);
        for (auto it = transforms_.rbegin(); it != transforms_.rend(); ++it)
            px = inverse(*it, px, h);
        std::memcpy(out, px.data(), size_t(w) * size_t(h) * 4);
    }

    int features = 0;

  private:
    static int sub(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

    void read_code(Code& code, int alphabet) {
        std::vector<uint8_t> lengths(size_t(alphabet), 0);
        if (br_.read(1)) {  // simple
            features |= SIMPLE_CODE;
            const int num = int(br_.read(1)) + 1;
            const int first8 = int(br_.read(1));
            const int s0 = int(br_.read(first8 ? 8 : 1));
            if (s0 >= alphabet) fail(CORRUPT, "a VP8L simple code's symbol past its alphabet");
            lengths[size_t(s0)] = 1;
            if (num == 2) {
                const int s1 = int(br_.read(8));
                if (s1 >= alphabet) fail(CORRUPT, "a VP8L simple code's symbol past its alphabet");
                lengths[size_t(s1)] = 1;
            }
        } else {
            std::vector<uint8_t> cl(CODE_LENGTH_CODES, 0);
            const int num = int(br_.read(4)) + 4;
            for (int i = 0; i < num; ++i) cl[CODE_LENGTH_ORDER[i]] = uint8_t(br_.read(3));
            Code clc;
            clc.build(cl);
            int max_symbol = alphabet;
            if (br_.read(1)) {
                const int nbits = 2 + 2 * int(br_.read(3));
                max_symbol = 2 + int(br_.read(nbits));
                if (max_symbol > alphabet) fail(CORRUPT, "a VP8L max_symbol past its alphabet");
            }
            int symbol = 0, prev = 8;
            while (symbol < alphabet) {
                if (max_symbol-- == 0) break;
                const int len = clc.read(br_);
                if (len < 16) {
                    lengths[size_t(symbol++)] = uint8_t(len);
                    if (len) prev = len;
                } else {
                    static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
                    const int repeat = int(br_.read(extra[len - 16])) + offset[len - 16];
                    if (symbol + repeat > alphabet) fail(CORRUPT, "a VP8L code length repeat past its alphabet");
                    const uint8_t v = uint8_t(len == 16 ? prev : 0);
                    for (int i = 0; i < repeat; ++i) lengths[size_t(symbol++)] = v;
                }
            }
        }
        code.build(lengths);
    }

    // an entropy-coded image: the main one (level0: meta codes allowed) or a
    // transform's or the entropy image's
    std::vector<uint32_t> image(int xsize, int ysize, bool level0) {
        int cache_bits = 0;
        if (br_.read(1)) {
            cache_bits = int(br_.read(4));
            if (cache_bits < 1 || cache_bits > 11) fail(CORRUPT, "a VP8L colour cache of bad size");
            features |= COLOR_CACHE;
        }
        int meta_bits = 0, groups = 1;
        std::vector<uint32_t> meta;
        if (level0 && br_.read(1)) {
            features |= META_CODES;
            meta_bits = int(br_.read(3)) + 2;
            meta = image(sub(xsize, meta_bits), sub(ysize, meta_bits), false);
            for (uint32_t& m : meta) {
                m = (m >> 8) & 0xffff;
                groups = std::max(groups, int(m) + 1);
            }
        }
        const int cache_size = cache_bits ? 1 << cache_bits : 0;
        std::vector<Group> hg{size_t(groups)};
        const int alphabets[5] = {NUM_LITERALS + NUM_LENGTH_CODES + cache_size, 256, 256, 256,
                                  NUM_DISTANCE_CODES};
        for (Group& g : hg)
            for (int i = 0; i < 5; ++i) read_code(g.codes[i], alphabets[i]);

        const size_t total = size_t(xsize) * size_t(ysize);
        std::vector<uint32_t> px(total);
        std::vector<uint32_t> cache(size_t(cache_size), 0);
        const int shift = 32 - cache_bits;
        size_t pos = 0, cached = 0;
        int x = 0, y = 0;
        const int meta_w = meta_bits ? sub(xsize, meta_bits) : 0;
        auto group_at = [&](int gx, int gy) -> const Group& {
            return meta_bits ? hg[meta[size_t(gy >> meta_bits) * size_t(meta_w) + size_t(gx >> meta_bits)]]
                             : hg[0];
        };
        while (pos < total) {
            const Group& g = group_at(x, y);
            const int s = g.codes[0].read(br_);
            if (s < NUM_LITERALS) {
                const uint32_t r = uint32_t(g.codes[1].read(br_));
                const uint32_t b = uint32_t(g.codes[2].read(br_));
                const uint32_t a = uint32_t(g.codes[3].read(br_));
                px[pos++] = (a << 24) | (r << 16) | (uint32_t(s) << 8) | b;
                if (++x >= xsize) { x = 0; ++y; }
            } else if (s < NUM_LITERALS + NUM_LENGTH_CODES) {
                features |= BACKWARD_REFS;
                const int length = int(prefix_value(s - NUM_LITERALS));
                const int dsym = g.codes[4].read(br_);
                const int64_t dcode = prefix_value(dsym);
                int64_t dist;
                if (dcode > 120) {
                    dist = dcode - 120;
                } else {
                    const int p = CODE_TO_PLANE[dcode - 1];
                    dist = int64_t(p >> 4) * xsize + (8 - (p & 0xf));
                    if (dist < 1) dist = 1;
                }
                if (int64_t(pos) < dist || total - pos < size_t(length))
                    fail(CORRUPT, "a VP8L backward reference out of the image");
                for (int i = 0; i < length; ++i, ++pos) px[pos] = px[pos - size_t(dist)];
                x += length;
                while (x >= xsize) { x -= xsize; ++y; }
            } else {
                if (!cache_size) fail(CORRUPT, "a VP8L colour cache symbol without a cache");
                while (cached < pos) {
                    cache[(px[cached] * 0x1e35a7bdu) >> shift] = px[cached];
                    ++cached;
                }
                px[pos++] = cache[size_t(s - NUM_LITERALS - NUM_LENGTH_CODES)];
                if (ffmpeg_) cached = pos;
                if (++x >= xsize) { x = 0; ++y; }
            }
            if (cache_size)
                while (cached < pos) {
                    cache[(px[cached] * 0x1e35a7bdu) >> shift] = px[cached];
                    ++cached;
                }
        }
        return px;
    }

    int64_t prefix_value(int symbol) {
        if (symbol < 4) return symbol + 1;
        const int extra = (symbol - 2) >> 1;
        const int64_t offset = int64_t(2 + (symbol & 1)) << extra;
        return offset + br_.read(extra) + 1;
    }

    static uint32_t average2(uint32_t a, uint32_t b) {
        return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
    }
    static uint32_t add_pixels(uint32_t a, uint32_t b) {
        const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
        const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
        return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
    }
    static int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
    static uint32_t select(uint32_t t, uint32_t l, uint32_t tl) {
        int d = 0;
        for (int sh = 0; sh < 32; sh += 8) {
            const int a = int((t >> sh) & 0xff), b = int((l >> sh) & 0xff), c = int((tl >> sh) & 0xff);
            d += std::abs(b - c) - std::abs(a - c);
        }
        return d <= 0 ? t : l;
    }
    static uint32_t clamp_full(uint32_t a, uint32_t b, uint32_t c) {
        uint32_t out = 0;
        for (int sh = 0; sh < 32; sh += 8)
            out |= uint32_t(clip255(int((a >> sh) & 0xff) + int((b >> sh) & 0xff) - int((c >> sh) & 0xff))) << sh;
        return out;
    }
    static uint32_t clamp_half(uint32_t a, uint32_t b) {
        uint32_t out = 0;
        for (int sh = 0; sh < 32; sh += 8) {
            const int x = int((a >> sh) & 0xff), y = int((b >> sh) & 0xff);
            out |= uint32_t(clip255(x + (x - y) / 2)) << sh;
        }
        return out;
    }

  public:
    static uint32_t predict(int mode, uint32_t l, const uint32_t* top) {
        switch (mode) {
            case 1: return l;
            case 2: return top[0];
            case 3: return top[1];
            case 4: return top[-1];
            case 5: return average2(average2(l, top[1]), top[0]);
            case 6: return average2(l, top[-1]);
            case 7: return average2(l, top[0]);
            case 8: return average2(top[-1], top[0]);
            case 9: return average2(top[0], top[1]);
            case 10: return average2(average2(l, top[-1]), average2(top[0], top[1]));
            case 11: return select(top[0], l, top[-1]);
            case 12: return clamp_full(l, top[0], top[-1]);
            case 13: return clamp_half(average2(l, top[0]), top[-1]);
            default: return 0xff000000u;  // 0, and 14-15 as libwebp pads them
        }
    }

  private:
    std::vector<uint32_t> inverse(const Transform& t, std::vector<uint32_t>& in, int h) const {
        const int w = t.xsize;
        if (t.type == 2) {
            for (uint32_t& p : in) {
                const uint32_t g = (p >> 8) & 0xff;
                p = (p & 0xff00ff00u) | ((((p >> 16) + g) & 0xff) << 16) | ((p + g) & 0xff);
            }
            return std::move(in);
        }
        if (t.type == 1) {
            const int tw = sub(w, t.bits);
            for (int y = 0; y < h; ++y)
                for (int x = 0; x < w; ++x) {
                    const uint32_t m = t.data[size_t(y >> t.bits) * size_t(tw) + size_t(x >> t.bits)];
                    const int g2r = int8_t(m & 0xff), g2b = int8_t((m >> 8) & 0xff),
                              r2b = int8_t((m >> 16) & 0xff);
                    uint32_t& p = in[size_t(y) * size_t(w) + size_t(x)];
                    const int green = int8_t((p >> 8) & 0xff);
                    int r = int((p >> 16) & 0xff), b = int(p & 0xff);
                    r = (r + ((g2r * green) >> 5)) & 0xff;
                    b = (b + ((g2b * green) >> 5)) & 0xff;
                    b = (b + ((r2b * int8_t(r)) >> 5)) & 0xff;
                    p = (p & 0xff00ff00u) | (uint32_t(r) << 16) | uint32_t(b);
                }
            return std::move(in);
        }
        if (t.type == 0) {
            const int tw = sub(w, t.bits);
            uint32_t* px = in.data();
            for (int y = 0; y < h; ++y) {
                uint32_t* row = px + size_t(y) * size_t(w);
                for (int x = 0; x < w; ++x) {
                    uint32_t pred;
                    if (y == 0) pred = x == 0 ? 0xff000000u : row[x - 1];
                    else if (x == 0) pred = row[x - size_t(w)];
                    else {
                        int mode = int((t.data[size_t(y >> t.bits) * size_t(tw) + size_t(x >> t.bits)] >> 8) & 0xff);
                        if (ffmpeg_ && mode > 13) fail(CORRUPT, "a VP8L predictor mode past 13");
                        pred = predict(ffmpeg_ ? mode : mode & 0xf, row[x - 1], row + x - w);
                    }
                    row[x] = add_pixels(row[x], pred);
                }
            }
            return std::move(in);
        }
        // colour indexing: the packed indices in green, 8 >> bits bits each
        const int packed_w = sub(w, t.bits);
        std::vector<uint32_t> out(size_t(w) * size_t(h));
        const int bpp = 8 >> t.bits, per = 1 << t.bits, mask = (1 << bpp) - 1;
        for (int y = 0; y < h; ++y)
            for (int x = 0; x < w; ++x) {
                const uint32_t g = (in[size_t(y) * size_t(packed_w) + size_t(x >> t.bits)] >> 8) & 0xff;
                const uint32_t idx = (g >> (bpp * (x & (per - 1)))) & uint32_t(mask);
                out[size_t(y) * size_t(w) + size_t(x)] = t.data[idx];
            }
        return out;
    }

    bool ffmpeg_;
    BitReader br_;
    std::vector<Transform> transforms_;
};

// ---------------------------------------------------------------- encoder

class BitWriter {
  public:
    void put(uint32_t v, int n) {
        acc_ |= uint64_t(v) << bits_;
        bits_ += n;
        while (bits_ >= 8) {
            out.push_back(uint8_t(acc_));
            acc_ >>= 8;
            bits_ -= 8;
        }
    }
    void flush() {
        if (bits_) out.push_back(uint8_t(acc_));
        acc_ = 0;
        bits_ = 0;
    }
    std::vector<uint8_t> out;

  private:
    uint64_t acc_ = 0;
    int bits_ = 0;
};

// Huffman code lengths of a histogram, at most `limit` bits (counts halved,
// kept non-zero, until the tree fits)
std::vector<uint8_t> code_lengths(std::vector<uint64_t> counts, int limit) {
    const size_t n = counts.size();
    std::vector<uint8_t> len(n, 0);
    for (;;) {
        using Node = std::pair<uint64_t, int>;
        std::priority_queue<Node, std::vector<Node>, std::greater<Node>> q;
        std::vector<int> parent;
        for (size_t s = 0; s < n; ++s)
            if (counts[s]) {
                q.push({counts[s], int(parent.size())});
                parent.push_back(-1);
            }
        if (parent.size() < 2) {
            for (size_t s = 0; s < n; ++s) len[s] = counts[s] ? 1 : 0;
            return len;
        }
        while (q.size() > 1) {
            const Node a = q.top();
            q.pop();
            const Node b = q.top();
            q.pop();
            const int id = int(parent.size());
            parent.push_back(-1);
            parent[size_t(a.second)] = id;
            parent[size_t(b.second)] = id;
            q.push({a.first + b.first, id});
        }
        int maxlen = 0;
        size_t leaf = 0;
        for (size_t s = 0; s < n; ++s) {
            if (!counts[s]) continue;
            int d = 0;
            for (int p = int(leaf); parent[size_t(p)] >= 0; p = parent[size_t(p)]) ++d;
            len[s] = uint8_t(std::min(d, 255));
            maxlen = std::max(maxlen, d);
            ++leaf;
        }
        if (maxlen <= limit) return len;
        for (uint64_t& c : counts)
            if (c) c = (c + 1) >> 1;
    }
}

// canonical codes (bit-reversed for the LSB-first stream) of code lengths
std::vector<uint32_t> canonical(const std::vector<uint8_t>& len) {
    std::vector<uint32_t> codes(len.size(), 0);
    int count[MAX_LEN + 2] = {}, next[MAX_LEN + 2] = {};
    for (uint8_t l : len) ++count[l];
    count[0] = 0;
    int code = 0;
    for (int l = 1; l <= MAX_LEN; ++l) {
        code = (code + count[l - 1]) << 1;
        next[l] = code;
    }
    for (size_t s = 0; s < len.size(); ++s) {
        const int l = len[s];
        if (!l) continue;
        const uint32_t c = uint32_t(next[l]++);
        uint32_t rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((c >> b) & 1u) << (l - 1 - b);
        codes[s] = rev;
    }
    return codes;
}

// one prefix code written; returns (codes, lengths) to code symbols with
// (a code of one symbol writes no bits per symbol)
struct Written {
    std::vector<uint32_t> codes;
    std::vector<uint8_t> lens;
};

Written write_code(BitWriter& bw, const std::vector<uint64_t>& hist) {
    Written w;
    std::vector<int> used;
    for (size_t s = 0; s < hist.size(); ++s)
        if (hist[s]) used.push_back(int(s));
    if (used.size() <= 1 && (used.empty() || used[0] < 256)) {
        const int s = used.empty() ? 0 : used[0];
        bw.put(1, 1);  // simple
        bw.put(0, 1);  // one symbol
        bw.put(s > 1, 1);
        bw.put(uint32_t(s), s > 1 ? 8 : 1);
        w.codes.assign(hist.size(), 0);
        w.lens.assign(hist.size(), 0);
        return w;
    }
    w.lens = code_lengths(hist, MAX_LEN);
    if (used.size() == 1) {
        w.codes.assign(hist.size(), 0);
    } else {
        w.codes = canonical(w.lens);
    }
    std::vector<uint64_t> clh(CODE_LENGTH_CODES, 0);
    for (uint8_t l : w.lens) ++clh[l];
    std::vector<uint8_t> cll = code_lengths(clh, 7);
    std::vector<uint32_t> clc = canonical(cll);
    int nonzero = 0;
    for (uint8_t l : cll) nonzero += l != 0;
    bw.put(0, 1);  // normal
    bw.put(CODE_LENGTH_CODES - 4, 4);
    for (int i = 0; i < CODE_LENGTH_CODES; ++i) bw.put(cll[CODE_LENGTH_ORDER[i]], 3);
    bw.put(0, 1);  // max_symbol: the whole alphabet
    for (uint8_t l : w.lens)
        if (nonzero > 1) bw.put(clc[l], cll[l]);
    if (used.size() == 1) std::fill(w.lens.begin(), w.lens.end(), 0);
    return w;
}

std::vector<uint8_t> encode(const uint8_t* rgb, int w, int h) {
    const size_t n = size_t(w) * size_t(h);
    std::vector<uint32_t> argb(n);
    for (size_t i = 0; i < n; ++i) {
        const uint32_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
        // subtract-green applied with the pixel
        argb[i] = 0xff000000u | (((r - g) & 0xff) << 16) | (g << 8) | ((b - g) & 0xff);
    }
    constexpr int TILE_BITS = 4, CACHE_BITS = 10;
    const int tw = (w + (1 << TILE_BITS) - 1) >> TILE_BITS, th = (h + (1 << TILE_BITS) - 1) >> TILE_BITS;
    std::vector<uint32_t> modes(size_t(tw) * size_t(th), 0);
    auto residual = [&](size_t i, uint32_t pred) {
        const uint32_t p = argb[i];  // VP8LSubPixels
        const uint32_t ag = 0x00ff00ffu + (p & 0xff00ff00u) - (pred & 0xff00ff00u);
        const uint32_t rb = 0xff00ff00u + (p & 0x00ff00ffu) - (pred & 0x00ff00ffu);
        return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
    };
    auto cost = [](uint32_t r) {
        int c = 0;
        for (int sh = 0; sh < 24; sh += 8) c += std::abs(int(int8_t((r >> sh) & 0xff)));
        return c;
    };
    // each tile's mode: least absolute residual over the tile's inner
    // pixels (the first row and column predict as the decoder fixes them)
    for (int ty = 0; ty < th; ++ty)
        for (int tx = 0; tx < tw; ++tx) {
            int64_t best = -1;
            int best_mode = 11;
            for (int mode = 0; mode < 14; ++mode) {
                int64_t c = 0;
                for (int y = std::max(1, ty << TILE_BITS); y < std::min(h, (ty + 1) << TILE_BITS); ++y)
                    for (int x = std::max(1, tx << TILE_BITS); x < std::min(w, (tx + 1) << TILE_BITS); ++x) {
                        const size_t i = size_t(y) * size_t(w) + size_t(x);
                        c += cost(residual(i, Vp8lDecoder::predict(mode, argb[i - 1], &argb[i - size_t(w)])));
                    }
                if (best < 0 || c < best) {
                    best = c;
                    best_mode = mode;
                }
            }
            modes[size_t(ty) * size_t(tw) + size_t(tx)] = uint32_t(best_mode) << 8;
        }
    std::vector<uint32_t> res(n);
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            const size_t i = size_t(y) * size_t(w) + size_t(x);
            uint32_t pred;
            if (y == 0) pred = x == 0 ? 0xff000000u : argb[i - 1];
            else if (x == 0) pred = argb[i - size_t(w)];
            else pred = Vp8lDecoder::predict(int(modes[size_t(y >> TILE_BITS) * size_t(tw) + size_t(x >> TILE_BITS)] >> 8),
                                             argb[i - 1], &argb[i - size_t(w)]);
            res[i] = residual(i, pred);
        }

    BitWriter bw;
    bw.put(0x2f, 8);
    bw.put(uint32_t(w - 1), 14);
    bw.put(uint32_t(h - 1), 14);
    bw.put(0, 1);  // alpha unused
    bw.put(0, 3);
    bw.put(1, 1);
    bw.put(2, 2);  // subtract-green (inverted last)
    bw.put(1, 1);
    bw.put(0, 2);  // predictor
    bw.put(TILE_BITS - 2, 3);
    {  // the mode image: green literals only, no cache
        bw.put(0, 1);
        std::vector<uint64_t> g(NUM_LITERALS + NUM_LENGTH_CODES, 0), one(256, 0), dist(NUM_DISTANCE_CODES, 0);
        for (uint32_t m : modes) ++g[(m >> 8) & 0xff];
        const Written gc = write_code(bw, g);
        for (int i = 0; i < 3; ++i) write_code(bw, one);
        write_code(bw, dist);
        for (uint32_t m : modes) {
            const uint32_t s = (m >> 8) & 0xff;
            bw.put(gc.codes[s], gc.lens[s]);
        }
    }
    bw.put(0, 1);  // no more transforms
    bw.put(1, 1);
    bw.put(CACHE_BITS, 4);
    bw.put(0, 1);  // no meta codes
    const int cache_size = 1 << CACHE_BITS;
    std::vector<uint32_t> cache(size_t(cache_size), 0);
    std::vector<int32_t> sym(n);  // the green symbol: a literal's green, or the cache index + 280
    std::vector<uint64_t> hg(NUM_LITERALS + NUM_LENGTH_CODES + size_t(cache_size), 0),
        hr(256, 0), hb(256, 0), ha(256, 0), hd(NUM_DISTANCE_CODES, 0);
    for (size_t i = 0; i < n; ++i) {
        const uint32_t p = res[i];
        const uint32_t key = (p * 0x1e35a7bdu) >> (32 - CACHE_BITS);
        if (cache[key] == p) {
            sym[i] = NUM_LITERALS + NUM_LENGTH_CODES + int(key);
            ++hg[size_t(sym[i])];
        } else {
            sym[i] = int((p >> 8) & 0xff);
            ++hg[size_t(sym[i])];
            ++hr[(p >> 16) & 0xff];
            ++hb[p & 0xff];
            ++ha[p >> 24];
        }
        cache[key] = p;
    }
    const Written cg = write_code(bw, hg), cr = write_code(bw, hr), cb = write_code(bw, hb),
                  ca = write_code(bw, ha);
    write_code(bw, hd);
    for (size_t i = 0; i < n; ++i) {
        const int s = sym[i];
        bw.put(cg.codes[size_t(s)], cg.lens[size_t(s)]);
        if (s < NUM_LITERALS) {
            const uint32_t p = res[i];
            bw.put(cr.codes[(p >> 16) & 0xff], cr.lens[(p >> 16) & 0xff]);
            bw.put(cb.codes[p & 0xff], cb.lens[p & 0xff]);
            bw.put(ca.codes[p >> 24], ca.lens[p >> 24]);
        }
    }
    bw.flush();
    return std::move(bw.out);
}

}  // namespace

extern "C" {

void fmvfi_webp_yuv_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v, int64_t ystride,
                        int64_t uvstride, int32_t w, int32_t h, uint8_t* out) {
    fancy_rgb(y, u, v, ystride, uvstride, w, h, out);
}

int32_t fmvfi_vp8l_decode(const uint8_t* src, int64_t n, int32_t ffmpeg, uint32_t* out, int64_t cap,
                          int32_t* info, char* msg, int32_t msglen) {
    try {
        Vp8lDecoder dec(src, size_t(n), ffmpeg != 0);
        int w = 0, h = 0;
        dec.header(w, h);
        info[0] = w;
        info[1] = h;
        info[2] = 0;
        if (!out) return OK;
        if (int64_t(w) * h > cap) fail(CORRUPT, "the output buffer is too small");
        dec.decode(w, h, out);
        info[2] = dec.features;
        return OK;
    } catch (const Error& e) {
        return fmvfi_jpeg::report(e, msg, msglen);
    } catch (const std::bad_alloc&) {
        return fmvfi_jpeg::report(Error{CORRUPT, "out of memory"}, msg, msglen);
    }
}

int32_t fmvfi_vp8l_decode_image(const uint8_t* src, int64_t n, int32_t w, int32_t h, uint32_t* out,
                                char* msg, int32_t msglen) {
    try {
        Vp8lDecoder dec(src, size_t(n));
        dec.decode(w, h, out);
        return OK;
    } catch (const Error& e) {
        return fmvfi_jpeg::report(e, msg, msglen);
    } catch (const std::bad_alloc&) {
        return fmvfi_jpeg::report(Error{CORRUPT, "out of memory"}, msg, msglen);
    }
}

int64_t fmvfi_vp8l_encode(const uint8_t* rgb, int32_t w, int32_t h, uint8_t* out, int64_t cap) {
    try {
        const std::vector<uint8_t> data = encode(rgb, w, h);
        if (int64_t(data.size()) > cap) return -1;
        std::memcpy(out, data.data(), data.size());
        return int64_t(data.size());
    } catch (const std::bad_alloc&) {
        return -2;
    }
}

}  // extern "C"
