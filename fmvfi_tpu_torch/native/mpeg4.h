// fmvfi_tpu_torch native host runtime: MPEG-4 Part 2 (ISO/IEC 14496-2)
// Simple Profile, as FFmpeg's mpeg4 decoder decodes it.  The decoder lives
// in mpeg4.cpp; mpeg4_enc.cpp's encoder codes with the same tables and
// reconstructs its references by running this decoder on its own output.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

#include "ffmpeg_common.h"
#include "jpeg_common.h"

namespace fmvfi_mpeg4 {

using fmvfi_jpeg::CORRUPT;
using fmvfi_jpeg::Error;
using fmvfi_jpeg::fail;
using fmvfi_jpeg::OK;
using fmvfi_jpeg::UNSUPPORTED;

// Annex B's variable-length codes as FFmpeg's tables hold them: {code, length}
struct Code {
    uint16_t code;
    uint8_t len;
};

// MCBPC for I-VOPs (B-6): index cbpc | 4 dquant; 8 is stuffing
inline constexpr Code kIntraMcbpc[9] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                        {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// MCBPC for P-VOPs (B-7): index cbpc | 4 intra | 8 dquant | 16 four MVs;
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
// intra DC size, luminance (B-13) and chrominance (B-14)
inline constexpr Code kDcLum[13] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},  {1, 4}, {1, 5},
                                    {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
inline constexpr Code kDcChrom[13] = {{3, 2}, {2, 2}, {1, 2}, {1, 3},  {1, 4},  {1, 5}, {1, 6},
                                      {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

// TCOEF (B-16 intra, B-17 inter): 102 (last, run, level) codes, then the
// escape; entries from `last` on have last = 1
struct RunLevelTable {
    Code vlc[103];
    uint8_t run[102];
    uint8_t level[102];
    int last;
};
extern const RunLevelTable kIntraTcoef, kInterTcoef;

// escape modes 1 and 2: the largest level of each (last, run) and the
// largest run of each (last, level), as FFmpeg's ff_rl_init computes them
struct RunLevelLimits {
    uint8_t max_level[2][65];
    uint8_t max_run[2][65];
};
const RunLevelLimits& limits(const RunLevelTable& t);

inline constexpr int kYDcScale[32] = {0,  8,  8,  8,  8,  10, 12, 14, 16, 17, 18,
                                      19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                                      30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
inline constexpr int kCDcScale[32] = {0,  8,  8,  8,  8,  9,  9,  10, 10, 11, 11,
                                      12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17,
                                      17, 18, 18, 19, 20, 21, 22, 23, 24, 25};
inline constexpr int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
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

inline constexpr uint32_t VOS_START = 0x1B0, USER_DATA_START = 0x1B2, VO_START = 0x1B5,
                          VOP_START = 0x1B6;

// The video object layer's fields the decoder keeps.
struct Vol {
    bool seen = false;
    int width = 0, height = 0;
    int time_increment_resolution = 0, time_increment_bits = 1;
    int vo_type = 0;
    bool vol_control_parameters = false;
};

// The decoder.  Frames are kept as yuv420p planes whose sizes are whole
// macroblocks; `frame_rgb` crops and converts the last one.
class Decoder {
public:
    // fourcc: the container's codec tag (0 when it has none); FFmpeg
    // picks its Xvid / DivX behaviour from it when no user data names the
    // encoder
    explicit Decoder(uint32_t fourcc = 0) : fourcc_(fourcc) {}

    // Headers only (an esds DecoderSpecificInfo): VOS, VO, VOL, user data.
    void configure(const uint8_t* d, size_t n);
    // One packet: headers, then at most one VOP.  Returns whether a frame
    // came out (not for a packet of headers alone or a not-coded VOP).
    bool decode(const uint8_t* d, size_t n);

    int width() const { return vol_.width; }
    int height() const { return vol_.height; }
    // the last frame, cropped to width x height, as packed RGB
    void frame_rgb(uint8_t* out) const;
    char last_vop_type() const { return vop_type_; }
    int last_rounding() const { return no_rounding_; }  // vop_rounding_type

    // the last frame's macroblock-aligned planes (the next P-VOP's reference)
    const fmvfi_ff::Plane* reference() const { return cur_; }

private:
    friend class Encoder;
    uint32_t fourcc_;
    Vol vol_;
    std::string encoder_;  // the user data that named the encoder, if any
    int lavc_build_ = -1;
    bool checked_encoder_ = false;
    int mbw_ = 0, mbh_ = 0;
    fmvfi_ff::Plane cur_[3], ref_[3];
    bool have_ref_ = false;
    char vop_type_ = 0;

    // per-VOP state
    int qscale_ = 1, fcode_ = 1, dc_threshold_ = 99;
    bool no_rounding_ = false;
    // per-macroblock state of the VOP being decoded
    std::vector<int8_t> mb_q_;  // qscale of each MB (AC prediction's rescaling)
    // DC values (1024 where no intra block) and AC prediction rows/columns,
    // with a border of one block above and left
    std::vector<int16_t> dc_[3];
    std::vector<int16_t> ac_[3];
    std::vector<int16_t> mv_;  // (2 mbw + 2) x (2 mbh + 1) blocks of (x, y), border 0

    void headers(const uint8_t* d, size_t n, size_t* vop_at);
    void parse_vol(const uint8_t* d, size_t n);
    void parse_vo(const uint8_t* d, size_t n);
    void parse_user_data(const uint8_t* d, size_t n);
    void check_encoder();
    void allocate();
    bool decode_vop(const uint8_t* d, size_t n);

public:
    // shared with the encoder: prediction state and reconstruction
    int dc_stride(int c) const { return c == 0 ? 2 * mbw_ + 1 : mbw_ + 1; }
    int dc_index(int mbx, int mby, int n) const;
    // FFmpeg's ff_mpeg4_pred_dc: the DC prediction of block n (in DC units of
    // the current quantiser) and its direction; predict_dc adds it to level
    // and stores the block's DC, returning the sum
    int dc_prediction(int mbx, int mby, int n, int* dir) const;
    void store_dc(int mbx, int mby, int n, int level);
    int predict_dc(int mbx, int mby, int n, int level, int* dir) {
        level += dc_prediction(mbx, mby, n, dir);
        store_dc(mbx, mby, n, level);
        return level;
    }
    // ff_mpeg4_pred_ac: the neighbour's first column (dir 0) or row (dir 1),
    // rescaled to this quantiser, into p's column or row; predict_ac adds
    // it to the block when ac_pred and stores the block's own
    void ac_prediction(int mbx, int mby, int n, int dir, int16_t* p) const;
    void store_ac(int mbx, int mby, int n, const int16_t* block);
    void predict_ac(int mbx, int mby, int n, int16_t* block, int dir, bool ac_pred) {
        if (ac_pred) {
            int16_t p[64] = {};
            ac_prediction(mbx, mby, n, dir, p);
            for (int k = 1; k < 8; ++k) {
                block[k * 8] = static_cast<int16_t>(block[k * 8] + p[k * 8]);
                block[k] = static_cast<int16_t>(block[k] + p[k]);
            }
        }
        store_ac(mbx, mby, n, block);
    }
    void clear_intra(int mbx, int mby);
    int16_t* mv_at(int bx, int by) { return &mv_[2 * ((size_t(by) + 1) * (2 * mbw_ + 2) + bx + 1)]; }
    void predict_mv(int mbx, int mby, int blk, int* px, int* py);
    // the prediction of macroblock (mbx, mby) from the reference planes
    // `ref` into dst[c] (rows of stride[c]: 16x16 luma, 8x8 chroma)
    void motion(const fmvfi_ff::Plane* ref, uint8_t* const* dst, const size_t* stride, int mbx,
                int mby, const int (*mv)[2], bool four, bool no_rounding) const;
    void set_qscale(int q) { qscale_ = q < 1 ? 1 : (q > 31 ? 31 : q); }
};

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
    int64_t left() const { return int64_t(n_) * 8 - int64_t(pos_); }
    size_t pos() const { return pos_; }
    void marker(const char* what) {
        if (!get1()) fail(CORRUPT, std::string("a marker bit missing ") + what);
    }

private:
    const uint8_t* d_;
    size_t n_;
    size_t pos_ = 0;
};

// The bitstream writer.
class BitWriter {
public:
    void put(uint32_t v, int k) {
        for (int i = k - 1; i >= 0; --i) {
            acc_ = (acc_ << 1) | ((v >> i) & 1);
            if (++nacc_ == 8) {
                out.push_back(static_cast<uint8_t>(acc_));
                acc_ = 0;
                nacc_ = 0;
            }
        }
    }
    void put(const Code& c) { put(c.code, c.len); }
    // MPEG-4 stuffing: a 0, then 1s to the byte boundary (a whole 0x7F
    // when already aligned)
    void stuff() {
        put(0, 1);
        while (nacc_) put(1, 1);
    }
    void start_code(uint32_t code) {
        put(0, 16);
        put(code, 16);
    }
    std::vector<uint8_t> out;

private:
    uint32_t acc_ = 0;
    int nacc_ = 0;
};

}  // namespace fmvfi_mpeg4
