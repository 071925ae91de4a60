// fmvfi_tpu_torch native host runtime: the boolean decoder of VP8 and VP9
// (vp8.cpp, vp9.cpp).
#pragma once

#include <cstdint>

#include "jpeg_common.h"

namespace fmvfi_vpx {

using fmvfi_jpeg::CORRUPT;
using fmvfi_jpeg::fail;

// FFmpeg's VPXRangeCoder (vpx_rac.h): a 24-bit window refilled 16 bits at
// a time; the data is padded with zeros, which is what it reads past the end.
// past_end() is libwebp's VP8BitReader eof_ on the same data: its decisions
// are this coder's, but it sets eof_ once a decision needs a bit past the
// partition's end (the shifts so far exceed 8 size - 8), or at once for an
// empty partition
class RangeCoder {
  public:
    void init(const uint8_t* buf, int size, bool allow_empty = false) {
        if (size < 1 && !allow_empty) fail(CORRUPT, "an empty partition");
        size_ = size;
        shifted_ = 0;
        end_ = buf + size;
        high_ = 255;
        bits_ = -16;
        code_ = uint32_t(buf[0]) << 16 | uint32_t(buf[1]) << 8 | buf[2];
        buf_ = buf + 3;
        end_reached_ = 0;
    }
    int get(int prob) {
        const int shift = __builtin_clz(uint32_t(high_)) - 24;
        high_ <<= shift;
        code_ <<= shift;
        bits_ += shift;
        shifted_ += shift;
        if (bits_ >= 0 && buf_ < end_) {
            code_ |= (uint32_t(buf_[0]) << 8 | buf_[1]) << bits_;
            buf_ += 2;
            bits_ -= 16;
        }
        const uint32_t low = 1 + (((high_ - 1) * uint32_t(prob)) >> 8);
        const uint32_t low_shift = low << 16;
        const int bit = code_ >= low_shift;
        if (bit) {
            high_ -= low;
            code_ -= low_shift;
        } else {
            high_ = low;
        }
        return bit;
    }
    int bit() { return get(128); }
    int uint(int n) {
        int v = 0;
        while (n--) v = (v << 1) | bit();
        return v;
    }
    int sint(int n) {  // vp8_rac_get_sint: a flag, the magnitude, the sign
        if (!bit()) return 0;
        const int v = uint(n);
        return bit() ? -v : v;
    }
    // a value coded by a tree (libvpx's vpx_tree_index: a leaf is -value,
    // an inner node the index of its pair; node i reads probability i >> 1)
    int tree(const int8_t* t, const uint8_t* probs) {
        int i = 0;
        while ((i = t[i + get(probs[i >> 1])]) > 0) {
        }
        return -i;
    }
    // vpx_rac_is_end: true once the end was seen at more than ten checks
    bool past_end() const { return shifted_ > 8 * int64_t(size_) - 8; }
    bool is_end() {
        if (end_ <= buf_ && bits_ >= 0) ++end_reached_;
        return end_reached_ > 10;
    }

  private:
    const uint8_t* buf_ = nullptr;
    const uint8_t* end_ = nullptr;
    uint32_t high_ = 255, code_ = 0;
    int bits_ = 0, end_reached_ = 0, size_ = 0;
    int64_t shifted_ = 0;
};

}  // namespace fmvfi_vpx
