// fmvfi_tpu_torch native host runtime: H.263 and Sorenson Spark (FLV1)
// video decoded as cv2.VideoCapture decodes it, for utils/avi.py,
// utils/mp4.py and utils/flv.py.
//
// cv2's video backend is FFmpeg: its h263 and flv decoders (h263dec.c,
// ituh263dec.c, flvdec.c) turn each picture into a yuv420p frame whose
// planes are whole macroblocks, and OpenCV converts the visible part with
// swscale (h263_common.h's Frame::rgb).  This file repeats them, bit for bit,
// on the mpegvideo core of h263_common.h:
//   - H.263's baseline picture header (ff_h263_decode_picture_header: the
//     picture start code found at a byte boundary, the five source formats
//     sub-QCIF to 16CIF, Annex D's unrestricted vectors, Annex F's advanced
//     prediction, PEI) and GOB headers (a new slice at the GOB's row, its
//     GQUANT);
//   - Sorenson's picture header (ff_flv_decode_picture_header: format 0 or 1
//     picking the escape, sizes of 8 or 16 bits or one of five fixed ones,
//     picture types I, P and the disposable P that no later picture
//     predicts from, skipped with no frame before the stream's second
//     decoded picture, as h263dec.c skips it);
//   - I and P macroblocks (ff_h263_decode_mb): COD, MCBPC with DQUANT, CBPY,
//     1MV and 4MV with ff_h263_pred_motion, intra macroblocks in P pictures,
//     the 8-bit intra DC (255 meaning 128), TCOEF with H.263's escape (last,
//     run, an 8-bit level; -128 announcing an 11-bit one) or Sorenson's
//     (7- or 11-bit levels), the end of a slice at 16 zero bits;
//   - Annex F's overlapped block motion compensation (mpegvideo_motion.c's
//     apply_obmc and put_obmc, with FFmpeg's preview_obmc: the vectors of the
//     macroblock to the right read ahead, predicted while the current 1MV
//     macroblock's own vector is not stored yet, as FFmpeg predicts them);
//   - dct_unquantize_h263_*, the simple IDCT and the motion compensation of
//     h263_common.h.
// What FFmpeg decodes otherwise is refused as unsupported (the caller names
// ROADMAP item 18.4i): H.263+ (PLUSPTYPE: custom sizes, AIC, the loop
// filter, slice structure, modified quantisation...), PB frames, a size
// that changes, a P picture before any I picture.
//
// Exposed C ABI (ctypes):
//   fmvfi_h263_open(variant, msg, msglen, code) -> handle  (0 H.263, 1 Sorenson)
//   fmvfi_h263_decode(handle, data, n, info, msg, msglen) -> int32
//     one picture; info = {width, height, frame out (0/1), picture type
//     ('I', 'P', 'D' disposable), features}
//   fmvfi_h263_frame(handle, out): the last frame, height * width * 3 RGB
//   fmvfi_h263_close(handle)
// Codes: 0, 1 (unsupported) or 2 (corrupt), msg saying why.

#include <algorithm>
#include <cstring>

#include "h263_common.h"

namespace fmvfi_h263dec {

using namespace fmvfi_h263;

enum Variant { H263 = 0, SORENSON = 1 };

// the features a picture used (the info's bit field)
enum Feature : uint32_t {
    F_P_PICTURE = 1,
    F_SKIPPED = 2,
    F_INTRA_IN_P = 4,
    F_DQUANT = 8,
    F_FOUR_MV = 16,
    F_OBMC = 32,
    F_LONG_VECTORS = 64,
    F_GOB = 128,
    F_ESCAPE = 256,          // H.263's escape, or Sorenson format 0's
    F_ESCAPE_LONG = 512,     // H.263's -128 and an 11-bit level
    F_SORENSON_ESC7 = 1024,  // Sorenson format 1: a 7-bit level
    F_SORENSON_ESC11 = 2048, // Sorenson format 1: an 11-bit level
    F_DISPOSABLE = 4096,
    F_PEI = 8192,
};

// H.263's source formats (ff_h263_format)
const int kFormats[8][2] = {{0, 0},     {128, 96},   {176, 144}, {352, 288},
                            {704, 576}, {1408, 1152}, {0, 0},     {0, 0}};

// Annex F's weights (H.263 figures 12-14): the current vector, the one
// above or below (rows 0-3 above, 4-7 below), left or right (columns 0-3
// left, 4-7 right)
const uint8_t kObmcMid[64] = {4, 5, 5, 5, 5, 5, 5, 4, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6,
                              5, 5, 5, 5, 6, 6, 6, 6, 5, 5, 5, 5, 6, 6, 6, 6, 5, 5, 5, 5, 6, 6,
                              6, 6, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 4, 5, 5, 5, 5, 5, 5, 4};
const uint8_t kObmcVert[64] = {2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1,
                               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                               1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2};
const uint8_t kObmcHorz[64] = {2, 1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 2, 2, 2, 2, 1, 1, 1, 1,
                               2, 2, 2, 2, 1, 1, 1, 1, 2, 2, 2, 2, 1, 1, 1, 1, 2, 2, 2, 2, 1, 1,
                               1, 1, 2, 2, 2, 2, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 2};

const Vlc& lut_tcoef() { static const Vlc l(kInterTcoef.vlc, 103); return l; }

enum MbType : uint8_t { MB_NONE = 0, MB_INTRA, MB_INTER };

class Decoder {
public:
    explicit Decoder(int variant) : variant_(variant) {}

    bool decode(const uint8_t* d, size_t n);
    int width() const { return w_; }
    int height() const { return h_; }
    char last_type() const { return type_; }
    uint32_t features() const { return features_; }
    void frame_rgb(uint8_t* out) const { out_->rgb(out, -513); }

private:
    int variant_;
    int w_ = 0, h_ = 0, mbw_ = 0, mbh_ = 0;
    Frame cur_, ref_;
    const Frame* out_ = &ref_;
    bool have_ref_ = false;
    int decoded_ = 0;  // pictures decoded
    char type_ = 0;
    uint32_t features_ = 0;
    // per picture
    bool p_pic_ = false, long_vectors_ = false, obmc_ = false;
    int flv_ = 0;  // Sorenson's escape format + 1 (0: H.263)
    int qscale_ = 1;
    bool first_slice_line_ = true;
    int resync_y_ = 0;
    MotionField mv_;
    std::vector<uint8_t> mb_type_;

    void h263_header(Bits& b);
    void sorenson_header(Bits& b);
    void set_size(int w, int h);
    bool gob_header(Bits& b, int* mby);
    void macroblock(Bits& b, int mbx, int mby);
    void block(Bits& b, int16_t* blk, bool intra, bool coded);
    void preview(Bits b, int mbx, int mby);
    void obmc(int mbx, int mby);
};

void Decoder::set_size(int w, int h) {
    if (w <= 0 || h <= 0) fail(CORRUPT, "a picture of size 0");
    if (w_ && (w != w_ || h != h_))
        fail(UNSUPPORTED, "an H.263 stream whose picture size changes (" + std::to_string(w_) + "x" +
                              std::to_string(h_) + " to " + std::to_string(w) + "x" +
                              std::to_string(h) + ")");
    if (w_) return;
    if (int64_t(w) * h > (int64_t(1) << 28)) fail(CORRUPT, "a picture too large");
    w_ = w;
    h_ = h;
    cur_.allocate(w, h);
    ref_.allocate(w, h);
    mbw_ = cur_.mbw;
    mbh_ = cur_.mbh;
    mv_.allocate(mbw_, mbh_);
    mb_type_.assign(size_t(mbw_) * mbh_, MB_NONE);
}

// skip_1stop_8data_bits: PEI and PSPARE
void skip_pei(Bits& b, uint32_t* features) {
    while (b.get1()) {
        *features |= F_PEI;
        b.skip(8);
        if (b.left() < 0) fail(CORRUPT, "a picture header cut short");
    }
}

void Decoder::h263_header(Bits& b) {
    // the picture start code (22 bits, 0x20) at a byte boundary
    uint32_t code = b.get(14);
    for (int64_t left = b.left(); left > 24; left -= 8) {
        code = ((code << 8) | b.get(8)) & 0x3FFFFF;
        if (code == 0x20) break;
    }
    if (code != 0x20) fail(CORRUPT, "no H.263 picture start code");
    b.skip(8);  // temporal reference
    if (!b.get1()) fail(CORRUPT, "a PTYPE marker bit missing");
    if (b.get1()) fail(CORRUPT, "an H.263 PTYPE whose H.261 distinction bit is set");
    b.skip(3);  // split screen, document camera, freeze release
    const int format = b.get(3);
    if (format == 7 || format == 6)
        fail(UNSUPPORTED, "an H.263+ picture (PLUSPTYPE: custom sizes, advanced intra coding, "
                          "the deblocking filter, slices, modified quantisation)");
    if (!kFormats[format][0]) fail(CORRUPT, "an H.263 picture of the forbidden source format 0");
    set_size(kFormats[format][0], kFormats[format][1]);
    p_pic_ = b.get1();
    long_vectors_ = b.get1();
    if (b.get1()) fail(CORRUPT, "an H.263 picture with syntax-based arithmetic coding");
    obmc_ = b.get1();
    if (b.get1()) fail(UNSUPPORTED, "an H.263 PB frame");
    qscale_ = b.get(5);
    b.skip(1);  // continuous presence multipoint
    skip_pei(b, &features_);
    if (long_vectors_) features_ |= F_LONG_VECTORS;
    if (obmc_) features_ |= F_OBMC;
}

void Decoder::sorenson_header(Bits& b) {
    if (b.get(17) != 1) fail(CORRUPT, "no Sorenson picture start code");
    const int format = b.get(5);
    if (format > 1) fail(CORRUPT, "a Sorenson picture of format " + std::to_string(format));
    flv_ = format + 1;
    b.skip(8);  // temporal reference
    int w = 0, h = 0;
    switch (b.get(3)) {
        case 0: w = b.get(8); h = b.get(8); break;
        case 1: w = b.get(16); h = b.get(16); break;
        case 2: w = 352; h = 288; break;
        case 3: w = 176; h = 144; break;
        case 4: w = 128; h = 96; break;
        case 5: w = 320; h = 240; break;
        case 6: w = 160; h = 120; break;
        default: break;
    }
    set_size(w, h);
    const int type = b.get(2);
    p_pic_ = type > 0;
    if (type > 1) features_ |= F_DISPOSABLE;
    type_ = type == 0 ? 'I' : (type == 1 ? 'P' : 'D');
    b.skip(1);  // deblocking flag (FFmpeg ignores it)
    qscale_ = b.get(5);
    long_vectors_ = false;
    obmc_ = false;
    skip_pei(b, &features_);
}

// h263_decode_gob_header: GBSC (16 zeros, stuffing zeros, a 1), GN, GFID,
// GQUANT; false where no GOB header starts here
bool Decoder::gob_header(Bits& b, int* mby) {
    if (b.show(16) != 0) return false;
    b.skip(16);
    int64_t left = std::min<int64_t>(b.left(), 32);
    for (; left > 13; --left)
        if (b.get1()) break;
    if (left <= 13) return false;
    const int gob_index = h_ <= 400 ? 1 : (h_ <= 800 ? 2 : 4);
    const int gn = b.get(5);
    b.skip(2);  // GFID
    const int q = b.get(5);
    *mby = gob_index * gn;
    if (*mby >= mbh_ || q == 0) return false;
    qscale_ = q;
    features_ |= F_GOB;
    return true;
}

// h263_decode_block: an intra block's 8-bit DC, then TCOEF (H.263's
// inter table for every block) in zigzag order, raw levels
void Decoder::block(Bits& b, int16_t* blk, bool intra, bool coded) {
    int pos = -1;
    if (intra) {
        int level = b.get(8);
        if (level == 255) level = 128;
        blk[0] = static_cast<int16_t>(level);
        pos = 0;
    }
    if (!coded) return;
    const RunLevelTable& t = kInterTcoef;
    for (;;) {
        const int idx = lut_tcoef().read(b, "TCOEF");
        int run, level, last;
        if (idx == 102) {  // escape
            if (flv_ > 1) {  // Sorenson format 1
                const int is11 = b.get1();
                last = b.get1();
                run = b.get(6);
                level = b.sget(is11 ? 11 : 7);
                features_ |= is11 ? F_SORENSON_ESC11 : F_SORENSON_ESC7;
            } else {
                last = b.get1();
                run = b.get(6);
                level = static_cast<int8_t>(b.get(8));
                features_ |= F_ESCAPE;
                if (level == -128) {
                    const int lo = b.get(5);
                    level = lo | (b.sget(6) * 32);
                    features_ |= F_ESCAPE_LONG;
                }
            }
        } else {
            last = idx >= t.last;
            run = t.run[idx];
            level = t.level[idx];
            if (b.get1()) level = -level;
        }
        pos += run + 1;
        if (pos > 63) fail(CORRUPT, "a block's coefficients run past 64");
        blk[kZigzag[pos]] = static_cast<int16_t>(level);
        if (last) return;
        if (b.left() < 0) fail(CORRUPT, "a picture cut short");
    }
}

// preview_obmc: the next macroblock's type and vectors read ahead (into the
// motion field, as FFmpeg stores them before the current macroblock's own
// 1MV vector), for the current macroblock's overlapped prediction
void Decoder::preview(Bits b, int mbx, int mby) {
    const int x = mbx + 1;
    const size_t mb = size_t(mby) * mbw_ + x;
    int cbpc;
    do {
        if (b.get1()) {
            mv_.set_mb(x, mby, 0, 0);
            mb_type_[mb] = MB_INTER;
            return;
        }
        cbpc = lut_inter_mcbpc().read(b, "MCBPC");
    } while (cbpc == 20);
    if (cbpc & 4) {
        mb_type_[mb] = MB_INTRA;
        return;
    }
    mb_type_[mb] = MB_INTER;
    lut_cbpy().read(b, "CBPY");
    if (cbpc & 8) b.skip(2);
    if (!(cbpc & 16)) {
        int px, py;
        mv_.predict(x, mby, 0, first_slice_line_, &px, &py);
        const int mx = decode_mv(b, px, 1, long_vectors_), my = decode_mv(b, py, 1, long_vectors_);
        mv_.set_mb(x, mby, mx, my);
        return;
    }
    for (int k = 0; k < 4; ++k) {
        int px, py;
        mv_.predict(x, mby, k, first_slice_line_, &px, &py);
        int16_t* v = mv_.at(2 * x + (k & 1), 2 * mby + (k >> 1));
        v[0] = static_cast<int16_t>(decode_mv(b, px, 1, long_vectors_));
        v[1] = static_cast<int16_t>(decode_mv(b, py, 1, long_vectors_));
    }
}

// apply_obmc: each luma block the weighted sum of five predictions (its
// own vector, those above, left, right and below; a neighbour that is
// intra, or past the picture, lends the block's own), chroma from the sum
// of the four own vectors
void Decoder::obmc(int mbx, int mby) {
    int cache[4][4][2];  // rows: above, the MB's two, below; columns: left, two, right
    for (int r = 1; r <= 2; ++r)
        for (int c = 1; c <= 2; ++c) {
            const int16_t* v = mv_.at(2 * mbx + c - 1, 2 * mby + r - 1);
            cache[r][c][0] = v[0];
            cache[r][c][1] = v[1];
        }
    for (int c = 1; c <= 2; ++c)
        for (int k = 0; k < 2; ++k) cache[3][c][k] = cache[2][c][k];
    const auto type = [&](int x, int y) { return mb_type_[size_t(y) * mbw_ + x]; };
    for (int c = 1; c <= 2; ++c) {
        const bool own = mby == 0 || type(mbx, mby - 1) == MB_INTRA;
        const int16_t* v = mv_.at(2 * mbx + c - 1, 2 * mby - 1);
        for (int k = 0; k < 2; ++k) cache[0][c][k] = own ? cache[1][c][k] : v[k];
    }
    for (int r = 1; r <= 2; ++r) {
        const bool left_own = mbx == 0 || type(mbx - 1, mby) == MB_INTRA;
        const bool right_own = mbx + 1 >= mbw_ || type(mbx + 1, mby) == MB_INTRA;
        const int16_t* l = mv_.at(2 * mbx - 1, 2 * mby + r - 1);
        const int16_t* rr = mv_.at(2 * mbx + 2, 2 * mby + r - 1);
        for (int k = 0; k < 2; ++k) {
            cache[r][0][k] = left_own ? cache[r][1][k] : l[k];
            cache[r][3][k] = right_own ? cache[r][2][k] : rr[k];
        }
    }
    const fmvfi_ff::Plane& ref = ref_.p[0];
    uint8_t pred[5][64];
    int sumx = 0, sumy = 0;
    for (int i = 0; i < 4; ++i) {
        const int x = (i & 1) + 1, y = (i >> 1) + 1;
        const int* vs[5] = {cache[y][x], cache[y - 1][x], cache[y][x - 1], cache[y][x + 1],
                            cache[y + 1][x]};
        for (int j = 0; j < 5; ++j)
            hpel_block(ref, pred[j], 8, mbx * 16 + (i & 1) * 8, mby * 16 + (i >> 1) * 8, vs[j][0],
                       vs[j][1], false, w_, h_, mbw_, mbh_);
        uint8_t* dst = cur_.mb_block(mbx, mby, i);
        for (int r = 0; r < 8; ++r)
            for (int c = 0; c < 8; ++c) {
                const int k = r * 8 + c;
                const int vert = r < 4 ? pred[1][k] : pred[4][k];
                const int horz = c < 4 ? pred[2][k] : pred[3][k];
                dst[size_t(r) * cur_.p[0].stride + c] = static_cast<uint8_t>(
                    (kObmcMid[k] * pred[0][k] + kObmcVert[k] * vert + kObmcHorz[k] * horz + 4) >> 3);
            }
        sumx += vs[0][0];
        sumy += vs[0][1];
    }
    uint8_t* dst[3] = {nullptr, cur_.mb_block(mbx, mby, 4), cur_.mb_block(mbx, mby, 5)};
    const size_t stride[3] = {cur_.p[0].stride, cur_.p[1].stride, cur_.p[2].stride};
    chroma_4mv(ref_.p, dst, stride, mbx, mby, sumx, sumy, false, w_, h_, mbw_, mbh_);
}

void Decoder::macroblock(Bits& b, int mbx, int mby) {
    const size_t mb = size_t(mby) * mbw_ + mbx;
    int cbpc = 0;
    bool intra = !p_pic_, skipped = false;
    if (p_pic_) {
        do {
            if (b.get1()) {
                skipped = true;
                break;
            }
            cbpc = lut_inter_mcbpc().read(b, "MCBPC");
        } while (cbpc == 20);
        intra = !skipped && (cbpc & 4);
    } else {
        do cbpc = lut_intra_mcbpc().read(b, "MCBPC");
        while (cbpc == 8);
    }
    uint8_t* dst[3] = {cur_.mb_block(mbx, mby, 0), cur_.mb_block(mbx, mby, 4),
                       cur_.mb_block(mbx, mby, 5)};
    const size_t stride[3] = {cur_.p[0].stride, cur_.p[1].stride, cur_.p[2].stride};
    if (skipped) {
        features_ |= F_SKIPPED;
        mb_type_[mb] = MB_INTER;
        mv_.set_mb(mbx, mby, 0, 0);
        if (obmc_) {
            obmc(mbx, mby);
        } else {
            const int zero[1][2] = {{0, 0}};
            motion(ref_.p, dst, stride, mbx, mby, zero, false, false, w_, h_, mbw_, mbh_);
        }
        return;
    }
    alignas(16) int16_t blocks[6][64];
    std::memset(blocks, 0, sizeof(blocks));
    const bool dquant = p_pic_ ? (cbpc & 8) : (cbpc & 4);
    if (intra) {
        if (p_pic_) features_ |= F_INTRA_IN_P;
        mb_type_[mb] = MB_INTRA;
        const int cbp = (cbpc & 3) | (lut_cbpy().read(b, "CBPY") << 2);
        if (dquant) {
            qscale_ = std::clamp(qscale_ + kDquant[b.get(2)], 1, 31);
            features_ |= F_DQUANT;
        }
        for (int k = 0; k < 6; ++k) block(b, blocks[k], true, cbp & (32 >> k));
        if (b.left() < 0) fail(CORRUPT, "a picture cut short");
        for (int k = 0; k < 6; ++k) {
            dequant_intra(blocks[k], qscale_, 8);
            fmvfi_ff::simple_idct_put(blocks[k], cur_.mb_block(mbx, mby, k),
                                      cur_.p[k < 4 ? 0 : k - 3].stride);
        }
        mv_.set_mb(mbx, mby, 0, 0);
        return;
    }
    mb_type_[mb] = MB_INTER;
    const bool four = cbpc & 16;
    const int cbp = (cbpc & 3) | ((lut_cbpy().read(b, "CBPY") ^ 15) << 2);
    if (dquant) {
        qscale_ = std::clamp(qscale_ + kDquant[b.get(2)], 1, 31);
        features_ |= F_DQUANT;
    }
    int mv[4][2];
    if (!four) {
        int px, py;
        mv_.predict(mbx, mby, 0, first_slice_line_, &px, &py);
        mv[0][0] = decode_mv(b, px, 1, long_vectors_);
        mv[0][1] = decode_mv(b, py, 1, long_vectors_);
    } else {
        features_ |= F_FOUR_MV;
        for (int k = 0; k < 4; ++k) {
            int px, py;
            mv_.predict(mbx, mby, k, first_slice_line_, &px, &py);
            mv[k][0] = decode_mv(b, px, 1, long_vectors_);
            mv[k][1] = decode_mv(b, py, 1, long_vectors_);
            int16_t* v = mv_.at(2 * mbx + (k & 1), 2 * mby + (k >> 1));
            v[0] = static_cast<int16_t>(mv[k][0]);
            v[1] = static_cast<int16_t>(mv[k][1]);
        }
    }
    for (int k = 0; k < 6; ++k) block(b, blocks[k], false, cbp & (32 >> k));
    if (b.left() < 0) fail(CORRUPT, "a picture cut short");
    if (obmc_ && mbx + 1 < mbw_) preview(b, mbx, mby);
    if (!four) mv_.set_mb(mbx, mby, mv[0][0], mv[0][1]);
    if (obmc_)
        obmc(mbx, mby);
    else
        motion(ref_.p, dst, stride, mbx, mby, mv, four, false, w_, h_, mbw_, mbh_);
    for (int k = 0; k < 6; ++k) {
        if (!(cbp & (32 >> k))) continue;
        dequant_inter(blocks[k], qscale_);
        fmvfi_ff::simple_idct_add(blocks[k], cur_.mb_block(mbx, mby, k),
                                  cur_.p[k < 4 ? 0 : k - 3].stride);
    }
}

bool Decoder::decode(const uint8_t* d, size_t n) {
    if (n == 0) return false;
    Bits b(d, n);
    features_ = 0;
    if (variant_ == SORENSON) {
        sorenson_header(b);
    } else {
        h263_header(b);
        type_ = p_pic_ ? 'P' : 'I';
    }
    if (qscale_ == 0) fail(CORRUPT, "a picture whose quantiser is 0");
    if (p_pic_) {
        features_ |= F_P_PICTURE;
        if (!have_ref_)
            fail(UNSUPPORTED, "a P picture before any I picture (FFmpeg predicts it from a grey "
                              "frame)");
    }
    // a disposable picture before FFmpeg has a last picture (its second
    // decoded one) is skipped, as h263dec.c skips it: no frame comes out
    if (type_ == 'D' && decoded_ < 2) return false;
    ++decoded_;
    mv_.clear();  // FFmpeg zeroes each picture's motion vectors
    std::fill(mb_type_.begin(), mb_type_.end(), MB_NONE);
    first_slice_line_ = true;
    resync_y_ = 0;
    int mbx = 0, mby = 0;
    while (mby < mbh_) {
        if (mby == resync_y_ + 1 && mbx == 0) first_slice_line_ = false;
        macroblock(b, mbx, mby);
        if (++mbx == mbw_) {
            mbx = 0;
            ++mby;
        }
        // the end of a slice: 16 zero bits (fewer at the packet's end)
        const int64_t left = b.left();
        uint32_t v = b.show(16);
        if (left < 16) v = left <= 0 ? 0 : v >> (16 - left);
        if (mby >= mbh_) {
            // more data after the last macroblock: FFmpeg reports "slice end
            // not reached but screenspace end" and conceals the picture
            if (v != 0) fail(CORRUPT, "data past a picture's last macroblock");
            break;
        }
        if (v != 0) continue;
        int gob_y;
        if (variant_ != H263 || !gob_header(b, &gob_y))
            fail(CORRUPT, "a picture whose macroblocks end at row " + std::to_string(mby) +
                              ", column " + std::to_string(mbx));
        if (mbx != 0 || gob_y != mby)
            fail(CORRUPT, "a GOB header at row " + std::to_string(gob_y) + " where row " +
                              std::to_string(mby) + " follows");
        first_slice_line_ = true;
        resync_y_ = mby;
    }
    if (type_ == 'D') {
        out_ = &cur_;  // decoded, shown, and never a reference
    } else {
        std::swap(cur_, ref_);
        out_ = &ref_;
        have_ref_ = true;
    }
    return true;
}

}  // namespace fmvfi_h263dec

using fmvfi_h263dec::Decoder;

extern "C" {

void* fmvfi_h263_open(int32_t variant, char* msg, int32_t msglen, int32_t* code) {
    if (variant != 0 && variant != 1) {
        *code = fmvfi_jpeg::report(fmvfi_jpeg::Error{fmvfi_jpeg::CORRUPT, "no such H.263 variant"},
                                   msg, msglen);
        return nullptr;
    }
    *code = fmvfi_jpeg::OK;
    return new Decoder(variant);
}

int32_t fmvfi_h263_decode(void* handle, const uint8_t* data, int64_t n, int32_t* info, char* msg,
                          int32_t msglen) {
    return fmvfi_h263::decode_packet(static_cast<Decoder*>(handle), data, n, info, msg, msglen);
}

void fmvfi_h263_frame(void* handle, uint8_t* out) { static_cast<Decoder*>(handle)->frame_rgb(out); }

void fmvfi_h263_close(void* handle) { delete static_cast<Decoder*>(handle); }

}  // extern "C"
