// fmvfi_tpu_torch native host runtime: what FFmpeg's H.263 family of
// decoders shares (its mpegvideo core), for mpeg4.cpp (MPEG-4 Part 2),
// h263.cpp (H.263 and Sorenson Spark) and msmpeg4.cpp (MS-MPEG4 v2 / v3).
// Each repeats FFmpeg's decoder of its own bitstream; under it they share,
// bit for bit:
//   - the bitstream reader (MSB first, zeros past the end) and code tables
//     as two-level lookups;
//   - H.263's MCBPC, CBPY and MVD codes, the MPEG-4 / H.263 TCOEF tables
//     and ff_rl_init's max_level / max_run;
//   - ff_h263_pred_motion (the median predictor; the first row of a slice
//     or GOB takes the left vector only) and ff_h263_decode_motion's MVD
//     (modulo wrapping, or Annex D's long vectors);
//   - ff_mpeg4_pred_ac's AC prediction rows and columns (with the quantiser
//     rescaling) and ff_clean_intra_table_entries;
//   - mpegvideo_motion.c over frames whose planes are whole macroblocks with
//     their edges repeated (unrestricted vectors): half-pel averages,
//     rounded or not, H.263 chroma vectors for 1MV (the luma vector's
//     half-pel bit kept), ff_h263_round_chroma's sixteenths for 4MV, and
//     hpel_motion's and chroma_4mv_motion's clipping of a block to 16 (8)
//     samples past the visible frame;
//   - H.263 dequantisation (dct_unquantize_h263_*: 2 q |l| + ((q - 1) | 1),
//     the DC times the DC scale) and FFmpeg's simple IDCT (ffmpeg_common.h).
#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <string>
#include <vector>

#include "ffmpeg_common.h"
#include "jpeg_common.h"

namespace fmvfi_h263 {

using fmvfi_jpeg::CORRUPT;
using fmvfi_jpeg::Error;
using fmvfi_jpeg::fail;
using fmvfi_jpeg::OK;
using fmvfi_jpeg::UNSUPPORTED;
// a packet on which FFmpeg's decoder fails and cv2.VideoCapture stops reading
inline constexpr int END_OF_STREAM = 3;

// A variable-length code as FFmpeg's tables hold it: {code, length}
struct Code {
    uint16_t code;
    uint8_t len;
};

// MCBPC for I pictures (B-6): index cbpc | 4 dquant; 8 is stuffing
inline constexpr Code kIntraMcbpc[9] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                        {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// MCBPC for P pictures (B-7): index cbpc | 4 intra | 8 dquant | 16 four MVs;
// 20 is stuffing, 21-23 unused
inline constexpr Code kInterMcbpc[28] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5},  {4, 8},  {3, 8},  {3, 7},  {3, 3},  {7, 7},
    {6, 7}, {5, 9}, {4, 6}, {4, 9}, {3, 9},  {2, 9},  {2, 3},  {5, 7},  {4, 7},  {5, 8},
    {1, 9}, {0, 0}, {0, 0}, {0, 0}, {2, 11}, {12, 13}, {14, 13}, {15, 13}};
// CBPY (B-8), intra MBs' pattern; inter MBs' is its complement
inline constexpr Code kCbpy[16] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5},  {7, 4},
                                   {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                                   {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// MVD magnitude (B-12), a sign bit after each nonzero one
inline constexpr Code kMvd[33] = {
    {1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},   {3, 7},   {11, 9},
    {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10}, {12, 10}, {11, 10},
    {10, 10}, {9, 10},  {8, 10},  {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},
    {5, 11},  {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};
// MPEG-4's intra DC size codes, luminance (B-13) and chrominance (B-14)
inline constexpr Code kDcLum[13] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},  {1, 4}, {1, 5},
                                    {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
inline constexpr Code kDcChrom[13] = {{3, 2}, {2, 2}, {1, 2}, {1, 3},  {1, 4},  {1, 5}, {1, 6},
                                      {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};
inline constexpr int kDquant[4] = {-1, -2, 1, 2};

// scan orders: scan index -> natural (row-major) index
inline constexpr const int* kZigzag = fmvfi_jpeg::kNatural;
inline constexpr int kAltHorizontal[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14, 13, 12, 19, 18, 24, 25,
    32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37,
    38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
inline constexpr int kAltVertical[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33, 26, 18, 3,  11,
    4,  12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44,
    52, 60, 37, 45, 53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};

// A run/level table (FFmpeg's RLTable): n codes of (last, run, level) and
// the escape after them; codes from `last` on have last = 1.
struct RlTable {
    int n, last;
    const Code* vlc;  // n + 1 codes
    const uint8_t* run;
    const uint8_t* level;
};

// TCOEF (B-16 intra, B-17 inter; MPEG-4's and H.263's): 102 codes and the
// escape, as FFmpeg's ff_mpeg4_intra_* and ff_inter_* tables hold them
struct RunLevelTable {
    Code vlc[103];
    uint8_t run[102];
    uint8_t level[102];
    int last;
    RlTable view() const { return {102, last, vlc, run, level}; }
};

inline const RunLevelTable kIntraTcoef = {
    {{2, 2},   {6, 3},   {15, 4},  {13, 5},  {12, 5},  {21, 6},  {19, 6},  {18, 6},  {23, 7},
     {31, 8},  {30, 8},  {29, 8},  {37, 9},  {36, 9},  {35, 9},  {33, 9},  {33, 10}, {32, 10},
     {15, 10}, {14, 10}, {7, 11},  {6, 11},  {32, 11}, {33, 11}, {80, 12}, {81, 12}, {82, 12},
     {14, 4},  {20, 6},  {22, 7},  {28, 8},  {32, 9},  {31, 9},  {13, 10}, {34, 11}, {83, 12},
     {85, 12}, {11, 5},  {21, 7},  {30, 9},  {12, 10}, {86, 12}, {17, 6},  {27, 8},  {29, 9},
     {11, 10}, {16, 6},  {34, 9},  {10, 10}, {13, 6},  {28, 9},  {8, 10},  {18, 7},  {27, 9},
     {84, 12}, {20, 7},  {26, 9},  {87, 12}, {25, 8},  {9, 10},  {24, 8},  {35, 11}, {23, 8},
     {25, 9},  {24, 9},  {7, 10},  {88, 12}, {7, 4},   {12, 6},  {22, 8},  {23, 9},  {6, 10},
     {5, 11},  {4, 11},  {89, 12}, {15, 6},  {22, 9},  {5, 10},  {14, 6},  {4, 10},  {17, 7},
     {36, 11}, {16, 7},  {37, 11}, {19, 7},  {90, 12}, {21, 8},  {91, 12}, {20, 8},  {19, 8},
     {26, 8},  {21, 9},  {20, 9},  {19, 9},  {18, 9},  {17, 9},  {38, 11}, {39, 11}, {92, 12},
     {93, 12}, {94, 12}, {95, 12}, {3, 7}},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,  0,  0, 0, 0, 0, 0, 0, 0,
     0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  2,  2,  2,  2,  2,  3,  3,  3,  3, 4, 4, 4, 5, 5, 5,
     6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10, 11, 12, 13, 14, 0, 0,  0,  0,  0, 0, 0, 0, 1, 1, 1,
     2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20},
    {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
     27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3,
     1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3,
     1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    67};

inline const RunLevelTable kInterTcoef = {
    {{2, 2},   {15, 4},  {21, 6},  {23, 7},  {31, 8},  {37, 9},  {36, 9},  {33, 10}, {32, 10},
     {7, 11},  {6, 11},  {32, 11}, {6, 3},   {20, 6},  {30, 8},  {15, 10}, {33, 11}, {80, 12},
     {14, 4},  {29, 8},  {14, 10}, {81, 12}, {13, 5},  {35, 9},  {13, 10}, {12, 5},  {34, 9},
     {82, 12}, {11, 5},  {12, 10}, {83, 12}, {19, 6},  {11, 10}, {84, 12}, {18, 6},  {10, 10},
     {17, 6},  {9, 10},  {16, 6},  {8, 10},  {22, 7},  {85, 12}, {21, 7},  {20, 7},  {28, 8},
     {27, 8},  {33, 9},  {32, 9},  {31, 9},  {30, 9},  {29, 9},  {28, 9},  {27, 9},  {26, 9},
     {34, 11}, {35, 11}, {86, 12}, {87, 12}, {7, 4},   {25, 9},  {5, 11},  {15, 6},  {4, 11},
     {14, 6},  {13, 6},  {12, 6},  {19, 7},  {18, 7},  {17, 7},  {16, 7},  {26, 8},  {25, 8},
     {24, 8},  {23, 8},  {22, 8},  {21, 8},  {20, 8},  {19, 8},  {24, 9},  {23, 9},  {22, 9},
     {21, 9},  {20, 9},  {19, 9},  {18, 9},  {17, 9},  {7, 10},  {6, 10},  {5, 10},  {4, 10},
     {36, 11}, {37, 11}, {38, 11}, {39, 11}, {88, 12}, {89, 12}, {90, 12}, {91, 12}, {92, 12},
     {93, 12}, {94, 12}, {95, 12}, {3, 7}},
    {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  2,  2,  2,
     2,  3,  3,  3,  4,  4,  4,  5,  5,  5,  6,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
     11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0,  0,  0,  1,  1,
     2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
     23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40},
    {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2, 3, 1,
     2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    58};

// escape modes 1 and 2: the largest level of each (last, run) and the
// largest run of each (last, level), as FFmpeg's ff_rl_init computes them
struct RunLevelLimits {
    uint8_t max_level[2][65];
    uint8_t max_run[2][65];
};

inline RunLevelLimits make_limits(const RlTable& t) {
    RunLevelLimits l{};
    for (int i = 0; i < t.n; ++i) {
        const int last = i >= t.last;
        const int run = std::min<int>(t.run[i], 64), level = std::min<int>(t.level[i], 64);
        l.max_level[last][run] = std::max<uint8_t>(l.max_level[last][run], t.level[i]);
        l.max_run[last][level] = std::max<uint8_t>(l.max_run[last][level], t.run[i]);
    }
    return l;
}

inline const RunLevelLimits& limits(const RunLevelTable& t) {
    static const RunLevelLimits intra = make_limits(kIntraTcoef.view()),
                                inter = make_limits(kInterTcoef.view());
    return &t == &kIntraTcoef ? intra : inter;
}

// The bitstream reader: MSB first, zeros past the end.
class Bits {
public:
    Bits(const uint8_t* d, size_t n) : d_(d), n_(n) {}
    uint32_t show(int k) const {  // k <= 32
        if (k == 0) return 0;
        uint64_t w = 0;
        const size_t byte = pos_ >> 3;
        for (int i = 0; i < 8; ++i) w = (w << 8) | (byte + i < n_ ? d_[byte + i] : 0);
        return static_cast<uint32_t>((w << (pos_ & 7)) >> (64 - k));
    }
    uint32_t get(int k) {
        const uint32_t v = show(k);
        pos_ += k;
        return v;
    }
    int get1() { return static_cast<int>(get(1)); }
    int sget(int k) {  // a two's-complement field
        const uint32_t v = get(k);
        return static_cast<int>(v << (32 - k)) >> (32 - k);
    }
    void skip(size_t k) { pos_ += k; }
    void seek(size_t pos) { pos_ = pos; }
    void align() { pos_ = (pos_ + 7) & ~size_t(7); }
    int64_t left() const { return int64_t(n_) * 8 - int64_t(pos_); }
    size_t pos() const { return pos_; }
    size_t size() const { return n_; }
    void marker(const char* what) {
        if (!get1()) fail(CORRUPT, std::string("a marker bit missing ") + what);
    }

private:
    const uint8_t* d_;
    size_t n_;
    size_t pos_ = 0;
};

// A code table of up to 32-bit codes with symbols, as a two-level lookup:
// `kBits` bits first, longer codes through a second table of their group.
class Vlc {
public:
    static constexpr int kBits = 10;
    // codes[i] = {code, length} of symbol syms[i] (i when syms is null)
    template <class C>
    Vlc(const C* codes, int n, const int* syms = nullptr) {
        primary_.assign(size_t(1) << kBits, Entry{});
        std::vector<int> groups(size_t(1) << kBits, 0);  // the longest code under each prefix
        for (int i = 0; i < n; ++i) {
            const int len = codes[i].len;
            if (len > kBits) {
                const uint32_t prefix = uint32_t(codes[i].code) >> (len - kBits);
                groups[prefix] = std::max(groups[prefix], len - kBits);
            }
        }
        for (size_t p = 0; p < groups.size(); ++p)
            if (groups[p]) {
                primary_[p] = Entry{static_cast<int32_t>(second_.size()), int8_t(-groups[p])};
                second_.resize(second_.size() + (size_t(1) << groups[p]));
            }
        for (int i = 0; i < n; ++i) {
            const int len = codes[i].len;
            if (len == 0) continue;
            const int sym = syms ? syms[i] : i;
            const uint32_t code = codes[i].code;
            if (len <= kBits) {
                const int pad = kBits - len;
                for (uint32_t j = 0; j < (1u << pad); ++j)
                    primary_[(code << pad) | j] = Entry{sym, int8_t(len)};
            } else {
                const Entry& g = primary_[code >> (len - kBits)];
                const int extra = -g.len, pad = extra - (len - kBits);
                const uint32_t low = code & ((1u << (len - kBits)) - 1);
                for (uint32_t j = 0; j < (1u << pad); ++j)
                    second_[size_t(g.sym) + ((low << pad) | j)] = Entry{sym, int8_t(len)};
            }
        }
    }
    int read(Bits& b, const char* what) const {
        const Entry& e = primary_[b.show(kBits)];
        if (e.len > 0) {
            b.skip(e.len);
            return e.sym;
        }
        if (e.len < 0) {
            const int extra = -e.len;
            const Entry& f = second_[size_t(e.sym) + (b.show(kBits + extra) & ((1u << extra) - 1))];
            if (f.len > 0) {
                b.skip(f.len);
                return f.sym;
            }
        }
        fail(CORRUPT, std::string("an invalid ") + what + " code");
    }

private:
    struct Entry {
        int32_t sym = 0;
        int8_t len = 0;  // > 0: the code's length; < 0: a second table of -len bits at sym
    };
    std::vector<Entry> primary_, second_;
};

// Codes as (code, length) from their lengths in code order (FFmpeg's
// ff_vlc_init_from_lengths: each code the next of its length)
struct Code32 {
    uint32_t code;
    uint8_t len;
};
inline std::vector<Code32> codes_from_lengths(const uint8_t* lens, int n) {
    std::vector<Code32> out(n);
    uint64_t acc = 0;
    for (int i = 0; i < n; ++i) {
        out[i] = {static_cast<uint32_t>(acc >> (32 - lens[i])), lens[i]};
        acc += uint64_t(1) << (32 - lens[i]);
    }
    return out;
}

inline const Vlc& lut_intra_mcbpc() { static const Vlc l(kIntraMcbpc, 9); return l; }
inline const Vlc& lut_inter_mcbpc() { static const Vlc l(kInterMcbpc, 28); return l; }
inline const Vlc& lut_cbpy() { static const Vlc l(kCbpy, 16); return l; }
inline const Vlc& lut_mvd() { static const Vlc l(kMvd, 33); return l; }

inline int mid_pred(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }

inline int rounded_div(int a, int b) { return (a > 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

inline int sign_extend(int v, int bits) {
    return static_cast<int>(uint32_t(v) << (32 - bits)) >> (32 - bits);
}

// ff_h263_decode_motion: one MVD component added to its prediction; the
// sum wrapped modulo 2^(5 + fcode), or with H.263 Annex D's long vectors
// (no wrap; past +-63 folded back when the prediction points that way)
inline int decode_mv(Bits& b, int pred, int fcode, bool long_vectors = false) {
    const int code = lut_mvd().read(b, "MVD");
    if (code == 0) return pred;
    const int sign = b.get1(), shift = fcode - 1;
    int val = code;
    if (shift) {
        val = (val - 1) << shift;
        val |= static_cast<int>(b.get(shift));
        ++val;
    }
    if (sign) val = -val;
    val += pred;
    if (!long_vectors) return sign_extend(val, 5 + fcode);
    if (pred < -31 && val < -63) val += 64;
    if (pred > 32 && val > 63) val -= 64;
    return val;
}

// The vectors of a picture's 8x8 luma blocks: (2 mbw + 2) x (2 mbh + 1)
// blocks of (x, y) with a border of one block left, right and above, 0.
struct MotionField {
    int mbw = 0, mbh = 0;
    std::vector<int16_t> v;
    void allocate(int w, int h) {
        mbw = w;
        mbh = h;
        v.assign(size_t(2 * mbw + 2) * (2 * mbh + 1) * 2, 0);
    }
    void clear() { std::fill(v.begin(), v.end(), 0); }
    int16_t* at(int bx, int by) { return &v[2 * ((size_t(by) + 1) * (2 * mbw + 2) + bx + 1)]; }
    const int16_t* at(int bx, int by) const {
        return &v[2 * ((size_t(by) + 1) * (2 * mbw + 2) + bx + 1)];
    }
    // the same vector in the four blocks of macroblock (mbx, mby)
    void set_mb(int mbx, int mby, int x, int y) {
        for (int k = 0; k < 4; ++k) {
            int16_t* p = at(2 * mbx + (k & 1), 2 * mby + (k >> 1));
            p[0] = static_cast<int16_t>(x);
            p[1] = static_cast<int16_t>(y);
        }
    }
    // ff_h263_pred_motion of block blk (0-3) of macroblock (mbx, mby), for
    // slices that start at a row's first macroblock: on a slice's first row
    // the left vector alone (none at the row's start), block 2 the median
    // with a zero left at the row's start
    void predict(int mbx, int mby, int blk, bool first_slice_line, int* px, int* py) const {
        static const int off[4] = {2, 1, 1, -1};
        const int bx = 2 * mbx + (blk & 1), by = 2 * mby + (blk >> 1);
        const int16_t* A = at(bx - 1, by);
        if (first_slice_line && blk < 3) {
            if (blk == 0 && mbx == 0) {
                *px = *py = 0;
            } else if (blk < 2) {
                *px = A[0];
                *py = A[1];
            } else {
                const int16_t *B = at(bx, by - 1), *C = at(bx + off[blk], by - 1);
                const int a0 = mbx == 0 ? 0 : A[0], a1 = mbx == 0 ? 0 : A[1];
                *px = mid_pred(a0, B[0], C[0]);
                *py = mid_pred(a1, B[1], C[1]);
            }
            return;
        }
        const int16_t *B = at(bx, by - 1), *C = at(bx + off[blk], by - 1);
        *px = mid_pred(A[0], B[0], C[0]);
        *py = mid_pred(A[1], B[1], C[1]);
    }
};

// The intra predictors of ff_mpeg4_pred_ac (and the DC values the codecs'
// own DC predictions read): per block, its DC (1024 where no intra block)
// and its first row and column, with a border of one block above and
// left; the quantiser of each macroblock for AC prediction's rescaling.
struct IntraPredictor {
    int mbw = 0, mbh = 0;
    std::vector<int16_t> dc[3];
    std::vector<int16_t> ac[3];
    std::vector<int8_t> mb_q;
    void allocate(int w, int h) {
        mbw = w;
        mbh = h;
        for (int c = 0; c < 3; ++c) {
            const size_t cells = size_t(stride(c)) * (c ? mbh + 1 : 2 * mbh + 1);
            dc[c].assign(cells, 1024);
            ac[c].assign(cells * 16, 0);
        }
        mb_q.assign(size_t(mbw) * mbh, 0);
    }
    int stride(int c) const { return c == 0 ? 2 * mbw + 1 : mbw + 1; }
    int index(int mbx, int mby, int n) const {
        if (n < 4) return (2 * mby + (n >> 1) + 1) * stride(0) + 2 * mbx + (n & 1) + 1;
        return (mby + 1) * stride(1) + mbx + 1;
    }
    // A, B, C of block n: the DC values left, above left and above
    void neighbours(int mbx, int mby, int n, int* a, int* b, int* c) const {
        const int comp = n < 4 ? 0 : n - 3, s = stride(comp), i = index(mbx, mby, n);
        const int16_t* d = dc[comp].data();
        *a = d[i - 1];
        *b = d[i - 1 - s];
        *c = d[i - s];
    }
    void set_dc(int mbx, int mby, int n, int v) {
        dc[n < 4 ? 0 : n - 3][index(mbx, mby, n)] = static_cast<int16_t>(v);
    }
    // the neighbour's first column (dir 0) or row (dir 1), rescaled from
    // its quantiser to q, into p's column or row
    void ac_prediction(int mbx, int mby, int n, int dir, int q, int16_t* p) const {
        const int comp = n < 4 ? 0 : n - 3, s = stride(comp), i = index(mbx, mby, n);
        const int16_t* a = &ac[comp][size_t(i) * 16];
        if (dir == 0) {
            const int16_t* left = a - 16;
            const int lq = mbx > 0 ? mb_q[size_t(mby) * mbw + mbx - 1] : q;
            const bool same = mbx == 0 || lq == q || n == 1 || n == 3;
            for (int k = 1; k < 8; ++k)
                p[k * 8] = static_cast<int16_t>(same ? left[k] : rounded_div(left[k] * lq, q));
        } else {
            const int16_t* top = a - size_t(16) * s;
            const int tq = mby > 0 ? mb_q[size_t(mby - 1) * mbw + mbx] : q;
            const bool same = mby == 0 || tq == q || n == 2 || n == 3;
            for (int k = 1; k < 8; ++k)
                p[k] = static_cast<int16_t>(same ? top[k + 8] : rounded_div(top[k + 8] * tq, q));
        }
    }
    void store_ac(int mbx, int mby, int n, const int16_t* block) {
        int16_t* a = &ac[n < 4 ? 0 : n - 3][size_t(index(mbx, mby, n)) * 16];
        for (int k = 1; k < 8; ++k) {
            a[k] = block[k * 8];
            a[8 + k] = block[k];
        }
    }
    // ff_mpeg4_pred_ac: the prediction added to the block when ac_pred, the
    // block's own row and column stored
    void predict_ac(int mbx, int mby, int n, int16_t* block, int dir, bool ac_pred, int q) {
        if (ac_pred) {
            int16_t p[64] = {};
            ac_prediction(mbx, mby, n, dir, q, p);
            for (int k = 1; k < 8; ++k) {
                block[k * 8] = static_cast<int16_t>(block[k * 8] + p[k * 8]);
                block[k] = static_cast<int16_t>(block[k] + p[k]);
            }
        }
        store_ac(mbx, mby, n, block);
    }
    // ff_clean_intra_table_entries: a macroblock that is not intra
    void clear_intra(int mbx, int mby) {
        for (int n = 0; n < 6; ++n) {
            const int c = n < 4 ? 0 : n - 3, i = index(mbx, mby, n);
            dc[c][i] = 1024;
            std::fill_n(&ac[c][size_t(i) * 16], 16, 0);
        }
    }
    // ff_mpeg4_clean_buffers at a slice starting at row mby's first
    // macroblock: the rows above reset
    void clean_rows_above(int mby) {
        for (int c = 0; c < 3; ++c) {
            const int row = c ? mby : 2 * mby;  // the border row above mby's blocks
            const size_t s = size_t(stride(c));
            std::fill_n(&dc[c][row * s], s, int16_t(1024));
            std::fill_n(&ac[c][row * s * 16], s * 16, int16_t(0));
        }
    }
};

// A half-pel prediction of an s x s block at integer position (sx, sy) of
// `ref`, whose samples are read with coordinates clamped to edge_w x edge_h
// (FFmpeg's emulated_edge_mc), into dst: put_pixels_tab (rounded) or
// put_no_rnd_pixels_tab.  The unrounded half-pel averages of 8-wide blocks
// are x86's (hpeldsp's mmxext put_no_rnd_pixels8_x2 / _y2, what FFmpeg
// takes unless asked to be bit-exact): pavgb with one operand less 1,
// saturated at 0, (max(a - 1, 0) + b + 1) >> 1, the left sample's, or the
// sample of the row odd within the block; a 0 there rounds up.  16-wide
// ones are exact.
inline void mc_block(const fmvfi_ff::Plane& ref, uint8_t* dst, size_t stride, int sx, int sy,
                     int dxy, int s, int edge_w, int edge_h, bool no_rounding) {
    const int r1 = no_rounding ? 0 : 1, r2 = no_rounding ? 1 : 2;
    const bool approx = no_rounding && s == 8;
    auto dec = [](int v) { return v > 0 ? v - 1 : 0; };
    const bool inside = sx >= 0 && sy >= 0 && sx + s + 1 <= edge_w && sy + s + 1 <= edge_h;
    auto px = [&](int y, int x) -> int {
        if (!inside) {
            x = x < 0 ? 0 : (x >= edge_w ? edge_w - 1 : x);
            y = y < 0 ? 0 : (y >= edge_h ? edge_h - 1 : y);
        }
        return ref.px[size_t(y) * ref.stride + x];
    };
    for (int y = 0; y < s; ++y) {
        uint8_t* o = dst + size_t(y) * stride;
        const int yy = sy + y;
        for (int x = 0; x < s; ++x) {
            const int xx = sx + x;
            int v;
            switch (dxy) {
                case 0: v = px(yy, xx); break;
                case 1:
                    v = approx ? (dec(px(yy, xx)) + px(yy, xx + 1) + 1) >> 1
                               : (px(yy, xx) + px(yy, xx + 1) + r1) >> 1;
                    break;
                case 2:
                    if (!approx) v = (px(yy, xx) + px(yy + 1, xx) + r1) >> 1;
                    else if (y & 1) v = (dec(px(yy, xx)) + px(yy + 1, xx) + 1) >> 1;
                    else v = (px(yy, xx) + dec(px(yy + 1, xx)) + 1) >> 1;
                    break;
                default:
                    v = (px(yy, xx) + px(yy, xx + 1) + px(yy + 1, xx) + px(yy + 1, xx + 1) + r2) >>
                        2;
            }
            o[x] = static_cast<uint8_t>(v);
        }
    }
}

// ff_h263_round_chroma: a sum of four luma vectors to one chroma vector
inline int round_chroma(int x) {
    static const int tab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
    return tab[x & 15] + ((x >> 3) & ~1);
}

// A picture as mpegvideo keeps it: yuv420p planes whose sizes are whole
// macroblocks (the visible w x h in their top left corner).
struct Frame {
    int w = 0, h = 0, mbw = 0, mbh = 0;
    fmvfi_ff::Plane p[3];
    void allocate(int width, int height) {
        w = width;
        h = height;
        mbw = (w + 15) / 16;
        mbh = (h + 15) / 16;
        for (int c = 0; c < 3; ++c) {
            const int s = c ? 8 : 16;
            p[c].stride = size_t(mbw) * s;
            p[c].px.assign(p[c].stride * size_t(mbh) * s, 0);
            p[c].w = c ? (w + 1) / 2 : w;
            p[c].h = c ? (h + 1) / 2 : h;
        }
    }
    uint8_t* block(int c, int x, int y) { return &p[c].px[size_t(y) * p[c].stride + x]; }
    // the top left sample of block n (0-5) of macroblock (mbx, mby)
    uint8_t* mb_block(int mbx, int mby, int n) {
        if (n < 4) return block(0, mbx * 16 + (n & 1) * 8, mby * 16 + (n >> 1) * 8);
        return block(n - 3, mbx * 8, mby * 8);
    }
    // the visible part as packed RGB (swscale's yuv420p route), the chroma
    // sited where the decoder reports it: AVCHROMA_LOC_LEFT (0) or the
    // centre (-513)
    void rgb(uint8_t* out, int chroma_h_pos) const {
        fmvfi_ff::yuv_to_rgb(w, h, 3, 2, 2, p, false, out, chroma_h_pos);
    }
};

// chroma_4mv_motion: both chroma blocks of macroblock (mbx, mby) from the
// sum of its four luma vectors
inline void chroma_4mv(const fmvfi_ff::Plane* ref, uint8_t* const* dst, const size_t* stride,
                       int mbx, int mby, int sumx, int sumy, bool no_rounding, int w, int h,
                       int mbw, int mbh) {
    int mx = round_chroma(sumx), my = round_chroma(sumy);
    int dxy = ((my & 1) << 1) | (mx & 1);
    mx >>= 1;
    my >>= 1;
    int sx = mbx * 8 + mx, sy = mby * 8 + my;
    sx = std::clamp(sx, -8, w >> 1);
    if (sx == (w >> 1)) dxy &= ~1;
    sy = std::clamp(sy, -8, h >> 1);
    if (sy == (h >> 1)) dxy &= ~2;
    for (int c = 1; c < 3; ++c)
        mc_block(ref[c], dst[c], stride[c], sx, sy, dxy, 8, mbw * 8, mbh * 8, no_rounding);
}

// hpel_motion: an 8x8 luma block at (x, y) of a w x h picture, its vector
// (mx, my) clipped to 16 samples past the visible frame
inline void hpel_block(const fmvfi_ff::Plane& ref, uint8_t* dst, size_t stride, int x, int y, int mx,
                       int my, bool no_rounding, int w, int h, int mbw, int mbh) {
    int sx = x + (mx >> 1), sy = y + (my >> 1);
    int dxy = 0;
    sx = std::clamp(sx, -16, w);
    if (sx != w) dxy |= mx & 1;
    sy = std::clamp(sy, -16, h);
    if (sy != h) dxy |= (my & 1) << 1;
    mc_block(ref, dst, stride, sx, sy, dxy, 8, mbw * 16, mbh * 16, no_rounding);
}

// The 16x16 (1MV) or four 8x8 (4MV) prediction of macroblock (mbx, mby)
// of a w x h picture from the planes `ref` into dst[c] (rows of
// stride[c]), as mpegvideo_motion.c's FMT_H263 paths predict it: the edge
// at the macroblock-aligned size, hpel_motion's and chroma_4mv_motion's
// clips at the visible size.
inline void motion(const fmvfi_ff::Plane* ref, uint8_t* const* dst, const size_t* stride, int mbx,
                   int mby, const int (*mv)[2], bool four, bool no_rounding, int w, int h,
                   int mbw, int mbh) {
    const int ew = mbw * 16, eh = mbh * 16;  // h_edge_pos, v_edge_pos
    if (!four) {  // mpeg_motion_internal, FMT_H263
        const int mx = mv[0][0], my = mv[0][1];
        const int dxy = ((my & 1) << 1) | (mx & 1);
        const int sx = mbx * 16 + (mx >> 1), sy = mby * 16 + (my >> 1);
        mc_block(ref[0], dst[0], stride[0], sx, sy, dxy, 16, ew, eh, no_rounding);
        const int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
        for (int c = 1; c < 3; ++c)
            mc_block(ref[c], dst[c], stride[c], sx >> 1, sy >> 1, uvdxy, 8, ew >> 1, eh >> 1,
                     no_rounding);
        return;
    }
    int sumx = 0, sumy = 0;
    for (int i = 0; i < 4; ++i) {
        hpel_block(ref[0], dst[0] + (i >> 1) * 8 * stride[0] + (i & 1) * 8, stride[0],
                   mbx * 16 + (i & 1) * 8, mby * 16 + (i >> 1) * 8, mv[i][0], mv[i][1], no_rounding,
                   w, h, mbw, mbh);
        sumx += mv[i][0];
        sumy += mv[i][1];
    }
    chroma_4mv(ref, dst, stride, mbx, mby, sumx, sumy, no_rounding, w, h, mbw, mbh);
}

// dct_unquantize_h263_intra (the DC times its scale) and _inter, on a
// block of levels in natural order
inline void dequant_intra(int16_t* blk, int q, int dc_scale) {
    const int qmul = q << 1, qadd = (q - 1) | 1;
    blk[0] = static_cast<int16_t>(blk[0] * dc_scale);
    for (int j = 1; j < 64; ++j)
        if (blk[j]) blk[j] = static_cast<int16_t>(blk[j] < 0 ? blk[j] * qmul - qadd : blk[j] * qmul + qadd);
}
inline void dequant_inter(int16_t* blk, int q) {
    const int qmul = q << 1, qadd = (q - 1) | 1;
    for (int j = 0; j < 64; ++j)
        if (blk[j]) blk[j] = static_cast<int16_t>(blk[j] < 0 ? blk[j] * qmul - qadd : blk[j] * qmul + qadd);
}

// The C ABI's decode call of h263.cpp's and msmpeg4.cpp's decoders: one
// packet; info = {width, height, frame out (0/1), picture type, features}
template <class Decoder>
int32_t decode_packet(Decoder* dec, const uint8_t* data, int64_t n, int32_t* info, char* msg,
                      int32_t msglen) {
    try {
        const bool got = dec->decode(data, static_cast<size_t>(n));
        info[0] = dec->width();
        info[1] = dec->height();
        info[2] = got;
        info[3] = got ? dec->last_type() : 0;
        info[4] = static_cast<int32_t>(dec->features());
        return OK;
    } catch (const Error& e) {
        return fmvfi_jpeg::report(e, msg, msglen);
    } catch (const std::bad_alloc&) {
        return fmvfi_jpeg::report(Error{CORRUPT, "out of memory"}, msg, msglen);
    }
}

}  // namespace fmvfi_h263
