// fmvfi_tpu_torch native host runtime: an MPEG-4 Part 2 Simple Profile
// encoder, for utils/datasets.py's images_to_video (JAX writes such files
// through cv2.VideoWriter(fourcc "mp4v")).
//
// What it writes:
//   - the VOS, VO and VOL headers FFmpeg's encoder writes (Simple Profile
//     level 1, vol_control_parameters with low_delay, rectangular, not
//     interlaced, H.263 quantisation, no resync markers, no data
//     partitioning), with vop_time_increment_resolution and the frame
//     increment from the frame rate, and no user data;
//   - an I-VOP every `gop` frames (cv2's GOP is 12), P-VOPs between, the
//     rounding type alternating on P-VOPs as FFmpeg's flips it;
//   - a fixed vop_quant (no rate control): intra DC with the intra DC VLCs
//     and DC prediction, intra and inter coefficients quantised to their
//     nearest H.263 reconstruction level, coded with the TCOEF VLCs and the
//     three escapes;
//   - P-VOPs: an exhaustive full-pel search of the 16x16 luma over
//     vop_fcode_forward 1's range (-16..15) against the edge-repeated
//     reference, refined to half-pel; a macroblock without residual at
//     vector 0 is not coded; one whose best inter SAD exceeds its intra
//     activity is coded intra.
// `options` adds what the test suite needs to drive the decoder's other
// paths through cv2: 4MV macroblocks, DQUANT, AC prediction and an
// intra_dc_vlc_thr that codes intra DCs as TCOEFs.
// The references are the decoder's (mpeg4.cpp): each coded frame is decoded
// from its own bytes, so any decoder reading the file reconstructs what the
// encoder predicts from.
//
// Exposed C ABI (ctypes):
//   fmvfi_mpeg4_enc_open(width, height, resolution, increment, quant, gop,
//                        in_band, options, msg, msglen, code) -> handle
//     in_band: VOS/VO/VOL before each I-VOP (AVI) or only in the
//     configuration (MP4's esds)
//   fmvfi_mpeg4_enc_config(handle, out, cap) -> bytes of the VOS/VO/VOL
//   fmvfi_mpeg4_enc_frame(handle, rgb, msg, msglen) -> the packet's bytes
//     (< 0: an error), rgb: height * width * 3
//   fmvfi_mpeg4_enc_take(handle, out): the packet
//   fmvfi_mpeg4_enc_recon(handle, out): the decoded frame, height * width * 3 RGB
//   fmvfi_mpeg4_enc_close(handle)

#include <algorithm>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <map>

#include "mpeg4.h"

namespace fmvfi_mpeg4 {

enum Options { FOUR_MV = 1, DQUANT = 2, AC_PRED = 4, DC_AS_AC = 8 };

namespace {

const int kSearch = 16;  // full-pel range of vop_fcode_forward 1: -16..15
const int kPad = kSearch + 3;  // a search block's reach past its macroblock, half-pel included

// an edge-repeated copy of a macroblock-aligned plane, pad samples each side
struct Padded {
    int w = 0, h = 0, pad = 0;
    std::vector<uint8_t> px;
    void build(const fmvfi_ff::Plane& p, int pw, int ph, int pd) {
        w = pw;
        h = ph;
        pad = pd;
        const int sw = w + 2 * pad;
        px.resize(size_t(sw) * (h + 2 * pad));
        for (int y = -pad; y < h + pad; ++y) {
            const uint8_t* src = &p.px[size_t(std::clamp(y, 0, h - 1)) * p.stride];
            uint8_t* dst = &px[size_t(y + pad) * sw];
            for (int x = -pad; x < w + pad; ++x) dst[x + pad] = src[std::clamp(x, 0, w - 1)];
        }
    }
    int stride() const { return w + 2 * pad; }
    const uint8_t* at(int y, int x) const { return &px[size_t(y + pad) * stride() + x + pad]; }
};

// SAD of an s x s source block against the reference at half-pel vector
// (mx, my) from (x, y), averaged as the decoder averages
int sad_hpel(const uint8_t* src, int sstride, const Padded& ref, int x, int y, int mx, int my, int s,
             bool no_rounding, int limit) {
    const uint8_t* r = ref.at(y + (my >> 1), x + (mx >> 1));
    const int rs = ref.stride(), dx = mx & 1, dy = my & 1;
    const int r1 = no_rounding ? 0 : 1, r2 = no_rounding ? 1 : 2;
    int sad = 0;
    for (int j = 0; j < s; ++j) {
        const uint8_t* a = r + size_t(j) * rs;
        const uint8_t* b = a + rs;
        const uint8_t* o = src + size_t(j) * sstride;
        for (int i = 0; i < s; ++i) {
            int v;
            if (!dx && !dy) v = a[i];
            else if (dx && !dy) v = (a[i] + a[i + 1] + r1) >> 1;
            else if (!dx) v = (a[i] + b[i] + r1) >> 1;
            else v = (a[i] + a[i + 1] + b[i] + b[i + 1] + r2) >> 2;
            sad += std::abs(o[i] - v);
        }
        if (sad >= limit) return sad;
    }
    return sad;
}

// the best vector of an s x s block: a full-pel search of radius r about
// (cx, cy) within -16..15, then half-pel refinement; vectors in half-pels
int search(const uint8_t* src, int sstride, const Padded& ref, int x, int y, int s, int cx, int cy,
           int r, bool no_rounding, int* bmx, int* bmy) {
    int best = 1 << 30, bx = 0, by = 0;
    for (int vy = std::max(cy - r, -kSearch); vy <= std::min(cy + r, kSearch - 1); ++vy)
        for (int vx = std::max(cx - r, -kSearch); vx <= std::min(cx + r, kSearch - 1); ++vx) {
            const int sad = sad_hpel(src, sstride, ref, x, y, 2 * vx, 2 * vy, s, no_rounding, best);
            if (sad < best) {
                best = sad;
                bx = 2 * vx;
                by = 2 * vy;
            }
        }
    const int fx = bx, fy = by;
    for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
            const int mx = fx + dx, my = fy + dy;
            if ((!dx && !dy) || mx < -32 || mx > 31 || my < -32 || my > 31) continue;
            const int sad = sad_hpel(src, sstride, ref, x, y, mx, my, s, no_rounding, best);
            if (sad < best) {
                best = sad;
                bx = mx;
                by = my;
            }
        }
    *bmx = bx;
    *bmy = by;
    return best;
}

struct DctBasis {
    double c[8][8];
    DctBasis() {
        for (int k = 0; k < 8; ++k)
            for (int n = 0; n < 8; ++n)
                c[k][n] = (k ? 0.5 : std::sqrt(0.125)) * std::cos((2 * n + 1) * k * M_PI / 16);
    }
};

// the orthonormal 8x8 DCT, FFmpeg's scale (DC = 8 x the mean)
void fdct(const int* in, double* out) {
    static const DctBasis basis;
    const auto& c = basis.c;
    double t[64];
    for (int y = 0; y < 8; ++y)
        for (int k = 0; k < 8; ++k) {
            double s = 0;
            for (int n = 0; n < 8; ++n) s += c[k][n] * in[y * 8 + n];
            t[y * 8 + k] = s;
        }
    for (int k = 0; k < 8; ++k)
        for (int x = 0; x < 8; ++x) {
            double s = 0;
            for (int n = 0; n < 8; ++n) s += c[k][n] * t[n * 8 + x];
            out[k * 8 + x] = s;
        }
}

// the H.263 level whose reconstruction 2 q |l| + ((q - 1) | 1) is nearest
int quantise(double c, int q) {
    const double a = std::fabs(c);
    const int qadd = (q - 1) | 1;
    int l = static_cast<int>(std::floor((a - qadd) / (2 * q)));
    l = std::max(l, 0);
    auto err = [&](int v) { return std::fabs(a - (v ? 2.0 * q * v + qadd : 0.0)); };
    int best = 0;
    for (int v : {l, l + 1})
        if (err(v) < err(best)) best = v;
    best = std::min(best, 2047);
    return c < 0 ? -best : best;
}

struct RunLevelCoder {
    const RunLevelTable& t;
    std::map<int, int> index;  // (last << 16 | run << 8 | level) -> code index
    explicit RunLevelCoder(const RunLevelTable& table) : t(table) {
        for (int i = 0; i < 102; ++i) index[(i >= t.last) << 16 | t.run[i] << 8 | t.level[i]] = i;
    }
    int find(int last, int run, int level) const {
        if (run > 63 || level > 255) return -1;
        auto it = index.find(last << 16 | run << 8 | level);
        return it == index.end() ? -1 : it->second;
    }
    // one (last, run, level) event
    void put(BitWriter& w, int last, int run, int level) const {
        const int a = std::abs(level), sign = level < 0;
        const RunLevelLimits& lim = limits(t);
        int i = find(last, run, a);
        if (i >= 0) {
            w.put(t.vlc[i]);
            w.put(sign, 1);
            return;
        }
        const Code& esc = t.vlc[102];
        const int ml = lim.max_level[last][std::min(run, 64)];
        if (ml && a > ml && (i = find(last, run, a - ml)) >= 0) {  // escape mode 1
            w.put(esc);
            w.put(0, 1);
            w.put(t.vlc[i]);
            w.put(sign, 1);
            return;
        }
        if (a <= 64) {
            const int mr = lim.max_run[last][a];
            if (run > mr && (i = find(last, run - mr - 1, a)) >= 0) {
                w.put(esc);  // escape mode 2
                w.put(2, 2);
                w.put(t.vlc[i]);
                w.put(sign, 1);
                return;
            }
        }
        w.put(esc);  // escape mode 3
        w.put(3, 2);
        w.put(last, 1);
        w.put(run, 6);
        w.put(1, 1);
        w.put(static_cast<uint32_t>(level) & 0xFFF, 12);
        w.put(1, 1);
    }
    // the coefficients block[scan[first..63]], in order
    void put_block(BitWriter& w, const int16_t* block, const int* scan, int first) const {
        int lastpos = -1;
        for (int p = first; p < 64; ++p)
            if (block[scan[p]]) lastpos = p;
        int run = 0;
        for (int p = first; p <= lastpos; ++p) {
            const int v = block[scan[p]];
            if (!v) {
                ++run;
                continue;
            }
            put(w, p == lastpos, run, v);
            run = 0;
        }
    }
};

const RunLevelCoder& intra_coder() { static const RunLevelCoder c(kIntraTcoef); return c; }
const RunLevelCoder& inter_coder() { static const RunLevelCoder c(kInterTcoef); return c; }

void put_dc(BitWriter& w, int diff, bool chroma) {
    int size = 0;
    for (int a = std::abs(diff); a; a >>= 1) ++size;
    w.put((chroma ? kDcChrom : kDcLum)[size]);
    if (size) {
        w.put(static_cast<uint32_t>(diff > 0 ? diff : diff + (1 << size) - 1), size);
        if (size > 8) w.put(1, 1);  // marker
    }
}

void put_mvd(BitWriter& w, int mv, int pred) {
    int d = mv - pred;
    d = (d + 32) & 63;  // vop_fcode_forward 1: the difference modulo 64 in -32..31
    d -= 32;
    w.put(kMvd[std::abs(d)]);
    if (d) w.put(d < 0, 1);
}

}  // namespace

class Encoder {
public:
    Encoder(int w, int h, int resolution, int increment, int quant, int gop, bool in_band, int options)
        : w_(w), h_(h), res_(resolution), inc_(increment), q_(quant), gop_(gop), in_band_(in_band),
          options_(options) {
        if (w < 1 || h < 1 || w > 8191 || h > 8191) fail(CORRUPT, "an MPEG-4 VOL is 1-8191 a side");
        if (resolution < 1 || resolution > 65535 || increment < 1 || increment > resolution * 64)
            fail(CORRUPT, "a frame rate the VOL cannot carry");
        if (quant < 1 || quant > 31) fail(CORRUPT, "vop_quant is 1-31");
        if (gop < 1) fail(CORRUPT, "a GOP of at least one frame");
        mbw_ = (w + 15) / 16;
        mbh_ = (h + 15) / 16;
        tbits_ = 1;
        for (int r = res_ - 1; r >> tbits_;) ++tbits_;
        config_ = headers();
        dec_.configure(config_.data(), config_.size());
        pred_.configure(config_.data(), config_.size());
    }

    const std::vector<uint8_t>& config() const { return config_; }
    const std::vector<uint8_t>& packet() const { return packet_; }
    const Decoder& decoder() const { return dec_; }

    void encode(const uint8_t* rgb) {
        to_yuv(rgb);
        const bool intra = frame_ % gop_ == 0;
        BitWriter w;
        if (intra && in_band_) w.out = config_;
        // the VOP header
        const int64_t t = int64_t(frame_) * inc_, seconds = t / res_;
        w.start_code(VOP_START);
        w.put(intra ? 0 : 1, 2);
        for (int64_t s = last_seconds_; s < seconds; ++s) w.put(1, 1);
        w.put(0, 1);
        last_seconds_ = seconds;
        w.put(1, 1);
        w.put(static_cast<uint32_t>(t % res_), tbits_);
        w.put(1, 1);
        w.put(1, 1);  // vop_coded
        if (!intra) {
            no_rounding_ = !no_rounding_;
            w.put(no_rounding_, 1);
        }
        w.put(options_ & DC_AS_AC ? 7 : 0, 3);  // intra_dc_vlc_thr
        w.put(q_, 5);
        if (!intra) w.put(1, 3);  // vop_fcode_forward
        pred_.qscale_ = q_;
        pred_.mv_.clear();
        if (!intra) ref_.build(dec_.reference()[0], mbw_ * 16, mbh_ * 16, kPad);
        for (int mby = 0; mby < mbh_; ++mby)
            for (int mbx = 0; mbx < mbw_; ++mbx) macroblock(w, mbx, mby, intra);
        w.stuff();
        packet_ = std::move(w.out);
        if (!dec_.decode(packet_.data(), packet_.size()))
            fail(CORRUPT, "the encoder's VOP did not decode");
        ++frame_;
    }

private:
    int w_, h_, res_, inc_, q_, gop_;
    bool in_band_;
    int options_;
    int mbw_, mbh_, tbits_;
    int frame_ = 0;
    int64_t last_seconds_ = 0;
    bool no_rounding_ = true;  // flipped before each P-VOP: the first has 0
    std::vector<uint8_t> config_, packet_;
    Decoder dec_;   // reconstruction: the frames any decoder of the file sees
    Decoder pred_;  // the prediction state (DC, AC, vectors) of the VOP being coded
    std::vector<uint8_t> src_[3];  // the frame being coded, macroblock-aligned
    Padded ref_;                   // the reference's luma, edges repeated, for the search

    std::vector<uint8_t> headers() const {
        BitWriter w;
        w.start_code(VOS_START);
        w.put(1, 8);  // Simple Profile, level 1
        w.start_code(VO_START);
        w.put(1, 1);  // is_visual_object_identifier
        w.put(1, 4);  // visual_object_verid
        w.put(1, 3);  // priority
        w.put(1, 4);  // video
        w.put(0, 1);  // no video_signal_type
        w.stuff();
        w.start_code(0x100);
        w.start_code(0x120);
        w.put(0, 1);   // random_accessible_vol
        w.put(1, 8);   // video_object_type_indication: Simple
        w.put(1, 1);   // is_object_layer_identifier
        w.put(1, 4);   // verid
        w.put(1, 3);   // priority
        w.put(1, 4);   // aspect_ratio_info: square
        w.put(1, 1);   // vol_control_parameters
        w.put(1, 2);   // 4:2:0
        w.put(1, 1);   // low_delay
        w.put(0, 1);   // no vbv_parameters
        w.put(0, 2);   // rectangular
        w.put(1, 1);
        w.put(res_, 16);
        w.put(1, 1);
        w.put(0, 1);   // fixed_vop_rate
        w.put(1, 1);
        w.put(w_, 13);
        w.put(1, 1);
        w.put(h_, 13);
        w.put(1, 1);
        w.put(0, 1);   // not interlaced
        w.put(1, 1);   // obmc_disable
        w.put(0, 1);   // no sprites
        w.put(0, 1);   // 8 bits
        w.put(0, 1);   // H.263 quantisation
        w.put(1, 1);   // complexity_estimation_disable
        w.put(1, 1);   // resync_marker_disable
        w.put(0, 1);   // no data partitioning
        w.put(0, 1);   // not scalable
        w.stuff();
        return w.out;
    }

    // BT.601 limited range, chroma the mean of each 2x2, edges repeated to
    // whole macroblocks
    void to_yuv(const uint8_t* rgb) {
        const int pw = mbw_ * 16, ph = mbh_ * 16;
        src_[0].resize(size_t(pw) * ph);
        for (int y = 0; y < ph; ++y)
            for (int x = 0; x < pw; ++x) {
                const uint8_t* p = rgb + (size_t(std::min(y, h_ - 1)) * w_ + std::min(x, w_ - 1)) * 3;
                src_[0][size_t(y) * pw + x] = fmvfi_ff::clip8(
                    std::lround(16 + (65.481 * p[0] + 128.553 * p[1] + 24.966 * p[2]) / 255));
            }
        for (int c = 1; c < 3; ++c) src_[c].resize(size_t(pw / 2) * (ph / 2));
        for (int y = 0; y < ph / 2; ++y)
            for (int x = 0; x < pw / 2; ++x) {
                double cb = 0, cr = 0;
                for (int j = 0; j < 2; ++j)
                    for (int i = 0; i < 2; ++i) {
                        const uint8_t* p =
                            rgb + (size_t(std::min(2 * y + j, h_ - 1)) * w_ + std::min(2 * x + i, w_ - 1)) * 3;
                        cb += -37.797 * p[0] - 74.203 * p[1] + 112.0 * p[2];
                        cr += 112.0 * p[0] - 93.786 * p[1] - 18.214 * p[2];
                    }
                src_[1][size_t(y) * (pw / 2) + x] = fmvfi_ff::clip8(std::lround(128 + cb / (4 * 255)));
                src_[2][size_t(y) * (pw / 2) + x] = fmvfi_ff::clip8(std::lround(128 + cr / (4 * 255)));
            }
    }

    const uint8_t* src_block(int k, int mbx, int mby, int* stride) const {
        const int c = k < 4 ? 0 : k - 3;
        const int pw = c ? mbw_ * 8 : mbw_ * 16;
        *stride = pw;
        const size_t x = c ? size_t(mbx) * 8 : size_t(mbx) * 16 + (k & 1) * 8;
        const size_t y = c ? size_t(mby) * 8 : size_t(mby) * 16 + (k >> 1) * 8;
        return &src_[c][y * pw + x];
    }

    // the intra blocks' quantised levels (natural order; DC in DC-scale units)
    void intra_levels(int mbx, int mby, int16_t (*lv)[64]) const {
        for (int k = 0; k < 6; ++k) {
            int stride;
            const uint8_t* s = src_block(k, mbx, mby, &stride);
            int in[64];
            double co[64];
            for (int j = 0; j < 64; ++j) in[j] = s[(j >> 3) * stride + (j & 7)];
            fdct(in, co);
            const int scale = k < 4 ? kYDcScale[pred_.qscale_] : kCDcScale[pred_.qscale_];
            lv[k][0] = static_cast<int16_t>(std::clamp<long>(std::lround(co[0] / scale), 1, 254));
            for (int j = 1; j < 64; ++j) lv[k][j] = static_cast<int16_t>(quantise(co[j], pred_.qscale_));
        }
    }

    // The levels an intra macroblock codes: the DC's difference from its
    // prediction and, with AC prediction, the first row or column's; each
    // block's own levels are stored as the decoder stores them, in order
    // (a block predicts from the blocks before it in the macroblock).
    void intra_coded(int mbx, int mby, int16_t (*lv)[64], bool ac_pred, int16_t (*coded)[64],
                     int* dirs) {
        for (int k = 0; k < 6; ++k) {
            const int pred = pred_.dc_prediction(mbx, mby, k, &dirs[k]);
            std::memcpy(coded[k], lv[k], sizeof(coded[k]));
            coded[k][0] = static_cast<int16_t>(lv[k][0] - pred);
            if (ac_pred) {
                int16_t p[64] = {};
                pred_.ac_prediction(mbx, mby, k, dirs[k], p);
                for (int j = 1; j < 8; ++j) {
                    coded[k][j * 8] = static_cast<int16_t>(coded[k][j * 8] - p[j * 8]);
                    coded[k][j] = static_cast<int16_t>(coded[k][j] - p[j]);
                }
            }
            pred_.store_dc(mbx, mby, k, lv[k][0]);
            pred_.store_ac(mbx, mby, k, lv[k]);
        }
    }

    bool dc_vlc() const { return !(options_ & DC_AS_AC); }

    int intra_cbp(int16_t (*coded)[64]) const {
        int cbp = 0;
        for (int k = 0; k < 6; ++k)
            for (int j = dc_vlc() ? 1 : 0; j < 64; ++j)
                if (coded[k][j]) {
                    cbp |= 32 >> k;
                    break;
                }
        return cbp;
    }

    // options & DQUANT: every third macroblock steps the quantiser by a
    // seeded -2..2 that keeps it in 1..31
    int dquant_step(int mbx, int mby) const {
        if (!(options_ & DQUANT) || (mbx + mby + frame_) % 3) return 0;
        static const int steps[4] = {-1, -2, 1, 2};
        const int step = steps[(mbx * 7 + mby * 13 + frame_ * 5) & 3];
        return pred_.qscale_ + step < 1 || pred_.qscale_ + step > 31 ? 0 : step;
    }

    void macroblock(BitWriter& w, int mbx, int mby, bool intra_vop) {
        const size_t mb = size_t(mby) * mbw_ + mbx;
        const int step = dquant_step(mbx, mby);
        if (!intra_vop) {
            int sstride;
            const uint8_t* s = src_block(0, mbx, mby, &sstride);
            const int x = mbx * 16, y = mby * 16;
            int mx, my;
            int best = search(s, sstride, ref_, x, y, 16, 0, 0, kSearch, no_rounding_, &mx, &my);
            if (sad_hpel(s, sstride, ref_, x, y, 0, 0, 16, no_rounding_, 1 << 30) <= best + 64) {
                mx = my = 0;
            }
            int four[4][2];
            bool use4 = false;
            if (options_ & FOUR_MV) {
                int sum = 0;
                for (int k = 0; k < 4; ++k)
                    sum += search(s + (k >> 1) * 8 * sstride + (k & 1) * 8, sstride, ref_,
                                  x + (k & 1) * 8, y + (k >> 1) * 8, 8, mx >> 1, my >> 1, 2,
                                  no_rounding_, &four[k][0], &four[k][1]);
                use4 = sum + 128 < best;
                if (use4) best = sum;
            }
            int mean = 0, act = 0;
            for (int j = 0; j < 16; ++j)
                for (int i = 0; i < 16; ++i) mean += s[j * sstride + i];
            mean = (mean + 128) >> 8;
            for (int j = 0; j < 16; ++j)
                for (int i = 0; i < 16; ++i) act += std::abs(s[j * sstride + i] - mean);
            if (best <= act + 512) {
                inter_mb(w, mbx, mby, use4 ? four : nullptr, mx, my, step);
                pred_.clear_intra(mbx, mby);
                pred_.ip_.mb_q[mb] = static_cast<int8_t>(pred_.qscale_);
                return;
            }
        }
        // intra
        const bool ac_pred = options_ & AC_PRED;
        if (!intra_vop) w.put(0, 1);  // coded
        pred_.set_qscale(pred_.qscale_ + step);
        int16_t lv[6][64], coded[6][64];
        int dirs[6];
        intra_levels(mbx, mby, lv);
        intra_coded(mbx, mby, lv, ac_pred, coded, dirs);
        const int cbp = intra_cbp(coded);
        if (intra_vop) w.put(kIntraMcbpc[(cbp & 3) | (step ? 4 : 0)]);
        else w.put(kInterMcbpc[(cbp & 3) | 4 | (step ? 8 : 0)]);
        w.put(ac_pred, 1);
        w.put(kCbpy[cbp >> 2]);
        if (step) w.put(dquant_code(step), 2);
        for (int k = 0; k < 6; ++k) {
            const int* scan = !ac_pred ? kZigzag : (dirs[k] == 0 ? kAltVertical : kAltHorizontal);
            if (dc_vlc()) put_dc(w, coded[k][0], k >= 4);
            if (cbp & (32 >> k)) intra_coder().put_block(w, coded[k], scan, dc_vlc() ? 1 : 0);
        }
        for (int k = 0; k < 4; ++k) {
            int16_t* v = pred_.mv_at(2 * mbx + (k & 1), 2 * mby + (k >> 1));
            v[0] = v[1] = 0;
        }
        pred_.ip_.mb_q[mb] = static_cast<int8_t>(pred_.qscale_);
    }

    static int dquant_code(int step) { return step == -1 ? 0 : step == -2 ? 1 : step == 1 ? 2 : 3; }

    // An inter macroblock: the residual against the prediction the decoder
    // forms (its own motion compensation on its reference), quantised, and
    // its bits; not coded when it has neither vector nor residual.
    void inter_mb(BitWriter& w, int mbx, int mby, int (*four)[2], int mx, int my, int step) {
        int mv[4][2];
        for (int k = 0; k < 4; ++k) {
            mv[k][0] = four ? four[k][0] : mx;
            mv[k][1] = four ? four[k][1] : my;
        }
        uint8_t py[256], pu[64], pv[64];
        uint8_t* dst[3] = {py, pu, pv};
        const size_t stride[3] = {16, 8, 8};
        dec_.motion(dec_.reference(), dst, stride, mbx, mby, mv, four != nullptr, no_rounding_);
        const int q = pred_.qscale_ + step;
        int16_t lv[6][64];
        int cbp = 0;
        for (int k = 0; k < 6; ++k) {
            int sstride;
            const uint8_t* s = src_block(k, mbx, mby, &sstride);
            const uint8_t* p = k < 4 ? py + (k >> 1) * 128 + (k & 1) * 8 : dst[k - 3];
            const int ps = k < 4 ? 16 : 8;
            int in[64];
            double co[64];
            for (int j = 0; j < 64; ++j)
                in[j] = s[(j >> 3) * sstride + (j & 7)] - p[(j >> 3) * ps + (j & 7)];
            fdct(in, co);
            for (int j = 0; j < 64; ++j) {
                lv[k][j] = static_cast<int16_t>(quantise(co[j], q));
                if (lv[k][j]) cbp |= 32 >> k;
            }
        }
        if (!four && !mx && !my && !cbp && !step) {
            w.put(1, 1);  // not coded
            return;
        }
        w.put(0, 1);
        w.put(kInterMcbpc[(cbp & 3) | (step ? 8 : 0) | (four ? 16 : 0)]);
        w.put(kCbpy[(cbp >> 2) ^ 15]);
        if (step) {
            w.put(dquant_code(step), 2);
            pred_.set_qscale(q);
        }
        for (int k = 0; k < (four ? 4 : 1); ++k) {
            int px, pyd;
            pred_.predict_mv(mbx, mby, k, &px, &pyd);
            put_mvd(w, mv[k][0], px);
            put_mvd(w, mv[k][1], pyd);
            if (four) {
                int16_t* v = pred_.mv_at(2 * mbx + (k & 1), 2 * mby + (k >> 1));
                v[0] = static_cast<int16_t>(mv[k][0]);
                v[1] = static_cast<int16_t>(mv[k][1]);
            }
        }
        if (!four)
            for (int k = 0; k < 4; ++k) {
                int16_t* v = pred_.mv_at(2 * mbx + (k & 1), 2 * mby + (k >> 1));
                v[0] = static_cast<int16_t>(mx);
                v[1] = static_cast<int16_t>(my);
            }
        for (int k = 0; k < 6; ++k)
            if (cbp & (32 >> k)) inter_coder().put_block(w, lv[k], kZigzag, 0);
    }
};

}  // namespace fmvfi_mpeg4

using namespace fmvfi_mpeg4;

extern "C" {

void* fmvfi_mpeg4_enc_open(int32_t width, int32_t height, int32_t resolution, int32_t increment,
                           int32_t quant, int32_t gop, int32_t in_band, int32_t options, char* msg,
                           int32_t msglen, int32_t* code) {
    try {
        Encoder* e = new Encoder(width, height, resolution, increment, quant, gop, in_band, options);
        *code = OK;
        return e;
    } catch (const Error& e) {
        *code = fmvfi_jpeg::report(e, msg, msglen);
    } catch (const std::bad_alloc&) {
        *code = fmvfi_jpeg::report(Error{CORRUPT, "out of memory"}, msg, msglen);
    }
    return nullptr;
}

int64_t fmvfi_mpeg4_enc_config(void* handle, uint8_t* out, int64_t cap) {
    const std::vector<uint8_t>& c = static_cast<Encoder*>(handle)->config();
    if (out && cap >= int64_t(c.size())) std::memcpy(out, c.data(), c.size());
    return static_cast<int64_t>(c.size());
}

int64_t fmvfi_mpeg4_enc_frame(void* handle, const uint8_t* rgb, char* msg, int32_t msglen) {
    try {
        Encoder* e = static_cast<Encoder*>(handle);
        e->encode(rgb);
        return static_cast<int64_t>(e->packet().size());
    } catch (const Error& e) {
        return -fmvfi_jpeg::report(e, msg, msglen);
    } catch (const std::bad_alloc&) {
        return -fmvfi_jpeg::report(Error{CORRUPT, "out of memory"}, msg, msglen);
    }
}

void fmvfi_mpeg4_enc_take(void* handle, uint8_t* out) {
    const std::vector<uint8_t>& p = static_cast<Encoder*>(handle)->packet();
    std::memcpy(out, p.data(), p.size());
}

void fmvfi_mpeg4_enc_recon(void* handle, uint8_t* out) {
    static_cast<Encoder*>(handle)->decoder().frame_rgb(out);
}

void fmvfi_mpeg4_enc_close(void* handle) { delete static_cast<Encoder*>(handle); }

}  // extern "C"
