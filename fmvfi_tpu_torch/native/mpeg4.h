// fmvfi_tpu_torch native host runtime: MPEG-4 Part 2 (ISO/IEC 14496-2)
// Simple Profile, as FFmpeg's mpeg4 decoder decodes it.  The decoder lives
// in mpeg4.cpp; mpeg4_enc.cpp's encoder codes with the same tables and
// reconstructs its references by running this decoder on its own output.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

#include "h263_common.h"

namespace fmvfi_mpeg4 {

using namespace fmvfi_h263;

inline constexpr int kYDcScale[32] = {0,  8,  8,  8,  8,  10, 12, 14, 16, 17, 18,
                                      19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                                      30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
inline constexpr int kCDcScale[32] = {0,  8,  8,  8,  8,  9,  9,  10, 10, 11, 11,
                                      12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17,
                                      17, 18, 18, 19, 20, 21, 22, 23, 24, 25};
inline constexpr int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};

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
    // per-macroblock state of the VOP being decoded: the intra predictors
    // (with each MB's qscale) and the luma blocks' vectors
    IntraPredictor ip_;
    MotionField mv_;

    void headers(const uint8_t* d, size_t n, size_t* vop_at);
    void parse_vol(const uint8_t* d, size_t n);
    void parse_vo(const uint8_t* d, size_t n);
    void parse_user_data(const uint8_t* d, size_t n);
    void check_encoder();
    void allocate();
    bool decode_vop(const uint8_t* d, size_t n);

public:
    // shared with the encoder: prediction state and reconstruction
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
    void ac_prediction(int mbx, int mby, int n, int dir, int16_t* p) const {
        ip_.ac_prediction(mbx, mby, n, dir, qscale_, p);
    }
    void store_ac(int mbx, int mby, int n, const int16_t* block) { ip_.store_ac(mbx, mby, n, block); }
    void predict_ac(int mbx, int mby, int n, int16_t* block, int dir, bool ac_pred) {
        ip_.predict_ac(mbx, mby, n, block, dir, ac_pred, qscale_);
    }
    void clear_intra(int mbx, int mby) { ip_.clear_intra(mbx, mby); }
    int16_t* mv_at(int bx, int by) { return mv_.at(bx, by); }
    void predict_mv(int mbx, int mby, int blk, int* px, int* py) const {
        mv_.predict(mbx, mby, blk, mby == 0, px, py);
    }
    // the prediction of macroblock (mbx, mby) from the reference planes
    // `ref` into dst[c] (rows of stride[c]: 16x16 luma, 8x8 chroma)
    void motion(const fmvfi_ff::Plane* ref, uint8_t* const* dst, const size_t* stride, int mbx,
                int mby, const int (*mv)[2], bool four, bool no_rounding) const {
        fmvfi_h263::motion(ref, dst, stride, mbx, mby, mv, four, no_rounding, vol_.width,
                           vol_.height, mbw_, mbh_);
    }
    void set_qscale(int q) { qscale_ = q < 1 ? 1 : (q > 31 ? 31 : q); }
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
