// fmvfi_tpu_torch native host runtime: MPEG-4 Part 2 video decoded as
// cv2.VideoCapture decodes it, for fmvfi_tpu_torch/utils/mp4.py and
// utils/avi.py.
//
// cv2's video backend is FFmpeg: its mpeg4 decoder turns each VOP into a
// yuv420p frame whose planes are whole macroblocks (1080 rows are coded as
// 1088), and OpenCV converts the frame's visible part to BGR24 with swscale
// (limited range, BT.601; ffmpeg_common.h's yuv_to_rgb).  This file repeats
// the decoder, bit for bit, for what FFmpeg's encoder (and so cv2's "mp4v"
// writer) produces:
//   - VOS, VO and VOL headers, in the packet or out of band (an MP4 file's
//     esds), VOP headers (a not-coded VOP yields no frame, as in FFmpeg; a
//     packet without a VOP, a short video header picture among them, ends
//     the stream: FFmpeg fails it and cv2 stops reading, code 3);
//   - I-VOPs: intra DC VLCs or, past intra_dc_vlc_thr, the DC as a TCOEF;
//     DC prediction with FFmpeg's dc_val arithmetic (the prediction rounded
//     to the scale, the stored DC clipped to 0..2047); AC prediction with
//     the quantiser rescaling (ROUNDED_DIV) and the alternate scans; the
//     three TCOEF escape modes with ff_rl_init's max_level / max_run;
//   - P-VOPs: not-coded macroblocks, DQUANT, 1MV and 4MV with the median
//     predictor (ff_h263_pred_motion: the first row takes the left vector
//     only), MVD with vop_fcode_forward 1-7 and modulo wrapping, intra
//     macroblocks among inter ones;
//   - motion compensation: FFmpeg's mpegvideo_motion.c over the reference's
//     macroblock-aligned planes with their edges repeated (unrestricted
//     MVs), half-pel averages rounded or not (vop_rounding_type), H.263
//     chroma vectors for 1MV (the luma vector's half-pel bit kept) and
//     ff_h263_round_chroma's sixteenths for 4MV, and hpel_motion's and
//     chroma_4mv_motion's clipping of a 4MV block to 16 (8) samples past
//     the visible frame;
//   - H.263 dequantisation (dct_unquantize_h263_*: 2 q |l| + ((q - 1) | 1),
//     the DC times the DC scale), FFmpeg's simple IDCT, put for intra
//     blocks and added to the prediction for inter ones.
// What FFmpeg decodes otherwise, or with workarounds, is refused as
// unsupported (the caller names ROADMAP item 18.4): B-VOPs, S-VOPs (GMC,
// sprites), interlaced VOLs, quarter-pel, MPEG quantisation, data
// partitioning, resync markers, reduced resolution, newpred, scalability,
// complexity estimation, shapes other than rectangular, more than 8 bits,
// streams that FFmpeg identifies as Xvid or DivX
// (from the user data, or from the FourCC when none names the encoder),
// old FFmpeg builds with bug workarounds, and a packet holding more than
// one VOP (DivX's packed bitstream).
//
// Exposed C ABI (ctypes):
//   fmvfi_mpeg4_open(fourcc, config, n, msg, msglen, code) -> handle
//     config: the esds DecoderSpecificInfo (n = 0 for none)
//   fmvfi_mpeg4_decode(handle, data, n, info, msg, msglen) -> int32
//     one packet; info = {width, height, frame out (0/1), VOP type, rounding type}
//   fmvfi_mpeg4_frame(handle, out): the last frame, height * width * 3 RGB
//   fmvfi_mpeg4_close(handle)
// Codes: 0, 1 (unsupported), 2 (corrupt) or 3 (the end of what cv2 reads),
// msg saying why.

#include "mpeg4.h"

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace fmvfi_mpeg4 {

namespace {

const Vlc& lut_dc(int chroma) {
    static const Vlc lum(kDcLum, 13), chrom(kDcChrom, 13);
    return chroma ? chrom : lum;
}
const Vlc& lut_tcoef(bool intra) {
    static const Vlc in(kIntraTcoef.vlc, 103), inter(kInterTcoef.vlc, 103);
    return intra ? in : inter;
}

// the start codes of a packet: offsets of the byte after each 00 00 01
std::vector<size_t> start_codes(const uint8_t* d, size_t n) {
    std::vector<size_t> at;
    for (size_t i = 0; i + 3 < n; ++i)
        if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1) {
            at.push_back(i + 3);
            i += 2;
        }
    return at;
}

}  // namespace

void Decoder::configure(const uint8_t* d, size_t n) {
    size_t vop_at = n;
    headers(d, n, &vop_at);
    if (vop_at != n) fail(CORRUPT, "a VOP in the decoder configuration");
}

void Decoder::headers(const uint8_t* d, size_t n, size_t* vop_at) {
    const std::vector<size_t> at = start_codes(d, n);
    bool vol_here = false;
    for (size_t k = 0; k < at.size(); ++k) {
        const size_t p = at[k];
        if (p >= n) break;
        const uint32_t code = 0x100 | d[p];
        const size_t end = k + 1 < at.size() ? at[k + 1] - 3 : n;
        const uint8_t* body = d + p + 1;
        const size_t len = end - (p + 1);
        if (code >= 0x120 && code <= 0x12F) {
            if (!vol_here) parse_vol(body, len);  // FFmpeg ignores a second VOL in a packet
            vol_here = true;
        } else if (code == USER_DATA_START) {
            parse_user_data(body, len);
        } else if (code == VO_START) {
            parse_vo(body, len);
        } else if (code == VOP_START) {
            *vop_at = p + 1;
            for (size_t j = k + 1; j < at.size(); ++j)
                if (at[j] < n && d[at[j]] == 0xB6)
                    fail(UNSUPPORTED, "a packet holding more than one VOP (a DivX packed "
                                      "bitstream)");
            return;
        }
        // VOS (profile and level), GOP (time code), VO starts and the rest:
        // nothing kept
    }
}

// The VO header's video_signal_type: OpenCV hands FFmpeg's frame colour
// properties to swscale, which converts full range, BT.709 matrices and
// wide-gamut primaries otherwise; the port converts what cv2 converts as
// BT.601 limited range (matrices BT.470BG, SMPTE 170M or unspecified;
// primaries and transfer BT.709, BT.601 or unspecified; checked with cv2).
void Decoder::parse_vo(const uint8_t* d, size_t n) {
    Bits b(d, n);
    if (b.get1()) b.skip(7);  // verid, priority
    const int type = b.get(4);
    if ((type != 1 && type != 2) || !b.get1()) return;  // video / still texture signal type
    b.skip(3);  // video_format
    if (b.get1()) fail(UNSUPPORTED, "a full-range video signal type in the VO header");
    if (!b.get1()) return;
    const int primaries = b.get(8), transfer = b.get(8), matrix = b.get(8);
    const bool bt601 = (primaries == 1 || primaries == 2 || primaries == 5 || primaries == 6) &&
                       (transfer == 1 || transfer == 2 || transfer == 6) &&
                       (matrix == 2 || matrix == 5 || matrix == 6);
    if (!bt601)
        fail(UNSUPPORTED, "a VO header whose colour description (primaries " +
                              std::to_string(primaries) + ", transfer " + std::to_string(transfer) +
                              ", matrix " + std::to_string(matrix) + ") swscale converts otherwise");
}

void Decoder::parse_user_data(const uint8_t* d, size_t n) {
    // FFmpeg reads at most 255 bytes, up to 23 zero bits
    std::string s;
    for (size_t i = 0; i < n && i < 255; ++i) {
        if (d[i] == 0 && (i + 1 >= n || d[i + 1] == 0 || (d[i + 1] >> 1) == 0)) break;
        s.push_back(static_cast<char>(d[i]));
    }
    int ver = 0, ver2 = 0, ver3 = 0, build = 0;
    char c = 0;
    if (std::sscanf(s.c_str(), "DivX%dBuild%d%c", &ver, &build, &c) >= 2 ||
        std::sscanf(s.c_str(), "DivX%db%d%c", &ver, &build, &c) >= 2) {
        encoder_ = "DivX";
    } else if (std::sscanf(s.c_str(), "XviD%d", &build) == 1) {
        encoder_ = "Xvid";
    } else if (std::sscanf(s.c_str(), "Lavc%d.%d.%d", &ver, &ver2, &ver3) == 3) {
        if (ver <= 0xFF && ver2 <= 0xFF && ver3 <= 0xFF) lavc_build_ = (ver << 16) + (ver2 << 8) + ver3;
        encoder_ = "Lavc";
    } else if (std::sscanf(s.c_str(), "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &ver2, &ver3,
                           &build) == 4 ||
               std::sscanf(s.c_str(), "FFmpe%*[^b]b%d", &build) == 1) {
        lavc_build_ = build;
        encoder_ = "Lavc";
    } else if (s == "ffmpeg") {
        lavc_build_ = 4600;
        encoder_ = "Lavc";
    }
}

void Decoder::check_encoder() {
    if (checked_encoder_) return;
    checked_encoder_ = true;
    auto tag = [](const char* t) { return uint32_t(t[0]) | uint32_t(t[1]) << 8 |
                                          uint32_t(t[2]) << 16 | uint32_t(t[3]) << 24; };
    if (encoder_ == "Xvid" || encoder_ == "DivX")
        fail(UNSUPPORTED, "an MPEG-4 stream whose user data names " + encoder_ +
                              " (FFmpeg then switches to its Xvid IDCT and bug workarounds)");
    if (encoder_.empty()) {
        for (const char* t : {"XVID", "XVIX", "RMP4", "ZMP4", "SIPP"})
            if (fourcc_ == tag(t))
                fail(UNSUPPORTED, std::string("an MPEG-4 stream tagged ") + t +
                                      " with no user data naming its encoder (FFmpeg decodes it "
                                      "as Xvid's, with its IDCT)");
        if (fourcc_ == tag("DIVX") && vol_.vo_type == 0 && !vol_.vol_control_parameters)
            fail(UNSUPPORTED, "an MPEG-4 stream tagged DIVX that FFmpeg decodes as DivX 4's");
        if (fourcc_ == tag("UMP4"))
            fail(UNSUPPORTED, "an MPEG-4 stream tagged UMP4 (FFmpeg's UMP4 workaround)");
    }
    if (lavc_build_ >= 0) {
        const int b = lavc_build_;
        if (b <= 4712)
            fail(UNSUPPORTED, "an MPEG-4 stream from an FFmpeg build before 4713 (its bug "
                              "workarounds)");
        if ((b & 0xFF) >= 100 && b > 3621476 && b < 3752552 && (b < 3752037 || b > 3752191))
            fail(UNSUPPORTED, "an MPEG-4 stream from an FFmpeg build with the IEDGE bug");
    }
}

void Decoder::parse_vol(const uint8_t* d, size_t n) {
    Bits b(d, n);
    Vol v;
    b.skip(1);  // random_accessible_vol
    v.vo_type = b.get(8);
    int verid = 1;
    if (b.get1()) {
        verid = b.get(4);
        b.skip(3);
    }
    if (b.get(4) == 15) b.skip(16);  // aspect_ratio_info, extended PAR
    if ((v.vol_control_parameters = b.get1())) {
        if (b.get(2) != 1) fail(UNSUPPORTED, "an MPEG-4 VOL whose chroma format is not 4:2:0");
        b.skip(1);  // low_delay
        if (b.get1()) {  // vbv_parameters
            b.skip(15); b.marker("in the VOL");
            b.skip(15); b.marker("in the VOL");
            b.skip(15); b.marker("in the VOL");
            b.skip(3);
            b.skip(11); b.marker("in the VOL");
            b.skip(15); b.marker("in the VOL");
        }
    }
    if (b.get(2) != 0) fail(UNSUPPORTED, "an MPEG-4 VOL whose shape is not rectangular");
    b.marker("before vop_time_increment_resolution");
    v.time_increment_resolution = b.get(16);
    if (v.time_increment_resolution == 0) fail(CORRUPT, "a VOL whose time resolution is 0");
    v.time_increment_bits = 1;
    for (int r = v.time_increment_resolution - 1; r >> v.time_increment_bits;) ++v.time_increment_bits;
    b.marker("before fixed_vop_rate");
    if (b.get1()) b.skip(v.time_increment_bits);
    b.marker("before the width");
    v.width = b.get(13);
    b.marker("before the height");
    v.height = b.get(13);
    b.marker("after the height");
    if (v.width == 0 || v.height == 0) fail(CORRUPT, "a VOL of size 0");
    if (b.get1()) fail(UNSUPPORTED, "an interlaced MPEG-4 VOL");
    b.skip(1);  // obmc_disable (FFmpeg decodes without OBMC either way)
    if (b.get(verid == 1 ? 1 : 2)) fail(UNSUPPORTED, "an MPEG-4 VOL with sprites or GMC");
    if (b.get1()) fail(UNSUPPORTED, "an MPEG-4 VOL of more than 8 bits");
    if (b.get1()) fail(UNSUPPORTED, "an MPEG-4 VOL with MPEG quantisation (quant_type 1)");
    if (verid != 1 && b.get1()) fail(UNSUPPORTED, "an MPEG-4 VOL with quarter-pel motion");
    if (!b.get1()) fail(UNSUPPORTED, "an MPEG-4 VOL with complexity estimation");
    if (!b.get1()) fail(UNSUPPORTED, "an MPEG-4 VOL with resync markers");
    if (b.get1()) fail(UNSUPPORTED, "an MPEG-4 VOL with data partitioning");
    if (verid != 1) {
        if (b.get1()) fail(UNSUPPORTED, "an MPEG-4 VOL with newpred");
        if (b.get1()) fail(UNSUPPORTED, "an MPEG-4 VOL with reduced-resolution VOPs");
    }
    if (b.get1()) fail(UNSUPPORTED, "a scalable MPEG-4 VOL");
    if (vol_.seen && (v.width != vol_.width || v.height != vol_.height))
        fail(UNSUPPORTED, "an MPEG-4 stream whose size changes");
    v.seen = true;
    vol_ = v;
    if (mbw_ == 0) allocate();
}

void Decoder::allocate() {
    mbw_ = (vol_.width + 15) / 16;
    mbh_ = (vol_.height + 15) / 16;
    for (fmvfi_ff::Plane* set : {cur_, ref_})
        for (int c = 0; c < 3; ++c) {
            fmvfi_ff::Plane& p = set[c];
            const int s = c ? 8 : 16;
            p.stride = size_t(mbw_) * s;
            p.px.assign(p.stride * size_t(mbh_) * s, 0);
            p.w = c ? (vol_.width + 1) / 2 : vol_.width;
            p.h = c ? (vol_.height + 1) / 2 : vol_.height;
        }
    ip_.allocate(mbw_, mbh_);
    mv_.allocate(mbw_, mbh_);
}

bool Decoder::decode(const uint8_t* d, size_t n) {
    size_t vop_at = n;
    headers(d, n, &vop_at);
    // FFmpeg's mpeg4 decoder looks for a VOP start code and fails a packet
    // without one: headers alone, or a short video header (H.263) picture,
    // which FFmpeg 8's decoder no longer reads; cv2 stops reading there
    if (vop_at == n)
        fail(END_OF_STREAM, n >= 3 && ((uint32_t(d[0]) << 16 | uint32_t(d[1]) << 8 | d[2]) >> 2) == 0x20
                                ? "a short video header (H.263) picture, which FFmpeg's mpeg4 "
                                  "decoder fails"
                                : "a packet without a VOP, which FFmpeg's mpeg4 decoder fails");
    if (!vol_.seen) fail(CORRUPT, "a VOP before any VOL header");
    check_encoder();
    return decode_vop(d + vop_at, n - vop_at);
}

int Decoder::dc_prediction(int mbx, int mby, int n, int* dir) const {
    int a, b, c;
    ip_.neighbours(mbx, mby, n, &a, &b, &c);
    int pred;
    if (std::abs(a - b) < std::abs(b - c)) {
        pred = c;
        *dir = 1;  // from the block above
    } else {
        pred = a;
        *dir = 0;  // from the block to the left
    }
    const int scale = n < 4 ? kYDcScale[qscale_] : kCDcScale[qscale_];
    return (pred + (scale >> 1)) / scale;
}

void Decoder::store_dc(int mbx, int mby, int n, int level) {
    const int scale = n < 4 ? kYDcScale[qscale_] : kCDcScale[qscale_];
    int v = level * scale;
    if (v & ~2047) v = v < 0 ? 0 : 2047;
    ip_.set_dc(mbx, mby, n, v);
}

namespace {

// The TCOEF run of one block into block[] (natural order), dequantised as
// FFmpeg's VLC tables dequantise (level * qmul + qadd; intra: qmul 1, qadd
// 0), starting after position `pos`.  Returns the last position.
int decode_coefficients(Bits& b, int16_t* block, bool intra, const int* scan, int pos, int qmul,
                        int qadd) {
    const RunLevelTable& t = intra ? kIntraTcoef : kInterTcoef;
    const RunLevelLimits& lim = limits(t);
    const Vlc& lut = lut_tcoef(intra);
    for (;;) {
        int idx = lut.read(b, "TCOEF");
        int run, level, last;
        if (idx == 102) {  // escape
            if (b.show(1) == 0) {  // mode 1: the level beyond max_level
                b.skip(1);
                idx = lut.read(b, "TCOEF");
                if (idx == 102) fail(CORRUPT, "an escape after a type 1 escape");
                last = idx >= t.last;
                run = t.run[idx];
                level = (t.level[idx] + lim.max_level[last][run]) * qmul + qadd;
                if (b.get1()) level = -level;
            } else if (b.show(2) == 2) {  // mode 2: the run beyond max_run
                b.skip(2);
                idx = lut.read(b, "TCOEF");
                if (idx == 102) fail(CORRUPT, "an escape after a type 2 escape");
                last = idx >= t.last;
                run = t.run[idx] + lim.max_run[last][t.level[idx]] + 1;
                level = t.level[idx] * qmul + qadd;
                if (b.get1()) level = -level;
            } else {  // mode 3: fixed length
                b.skip(2);
                last = b.get1();
                run = b.get(6);
                b.marker("in a type 3 escape");
                level = b.sget(12);
                b.marker("in a type 3 escape");
                level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
                if (unsigned(level + 2048) > 4095) level = level < 0 ? -2048 : 2047;
            }
        } else {
            last = idx >= t.last;
            run = t.run[idx];
            level = t.level[idx] * qmul + qadd;
            if (b.get1()) level = -level;
        }
        pos += run + 1;
        if (pos > 63 || (!last && pos > 62)) fail(CORRUPT, "a block's coefficients run past 64");
        block[scan[pos]] = static_cast<int16_t>(level);
        if (last) return pos;
    }
}

}  // namespace

bool Decoder::decode_vop(const uint8_t* d, size_t n) {
    Bits b(d, n);
    const int type = b.get(2);
    if (type == 2) fail(UNSUPPORTED, "a B-VOP (bidirectional prediction)");
    if (type == 3) fail(UNSUPPORTED, "an S-VOP (sprites or GMC)");
    while (b.get1()) {
        if (b.left() <= 0) fail(CORRUPT, "a VOP header cut short");
    }
    b.marker("before vop_time_increment");
    b.skip(vol_.time_increment_bits);
    b.marker("after vop_time_increment");
    if (!b.get1()) return false;  // vop_coded 0: FFmpeg skips the VOP, no frame comes out
    const bool p_vop = type == 1;
    if (p_vop && !have_ref_)
        fail(UNSUPPORTED, "a P-VOP before any I-VOP (FFmpeg predicts it from a grey frame)");
    no_rounding_ = p_vop ? b.get1() : false;
    dc_threshold_ = kDcThreshold[b.get(3)];
    qscale_ = b.get(5);  // quant_precision: 5 in an 8-bit VOL
    if (qscale_ == 0) fail(CORRUPT, "a VOP whose quantiser is 0");
    if (p_vop) {
        fcode_ = b.get(3);
        if (fcode_ == 0) fail(CORRUPT, "a P-VOP whose vop_fcode_forward is 0");
    }
    vop_type_ = p_vop ? 'P' : 'I';
    for (int c = 0; c < 3; ++c) std::swap(cur_[c], ref_[c]);
    mv_.clear();

    alignas(16) int16_t block[6][64];
    for (int mby = 0; mby < mbh_; ++mby) {
        for (int mbx = 0; mbx < mbw_; ++mbx) {
            const size_t mb = size_t(mby) * mbw_ + mbx;
            int cbpc;
            bool skipped = false;
            if (p_vop) {
                for (;;) {
                    if (b.get1()) {
                        skipped = true;
                        break;
                    }
                    cbpc = lut_inter_mcbpc().read(b, "MCBPC");
                    if (cbpc != 20) break;
                }
            } else {
                do cbpc = lut_intra_mcbpc().read(b, "MCBPC");
                while (cbpc == 8);
            }
            if (b.left() < 0) fail(CORRUPT, "a VOP cut short");
            uint8_t* dst[3] = {&cur_[0].px[size_t(mby) * 16 * cur_[0].stride + size_t(mbx) * 16],
                               &cur_[1].px[size_t(mby) * 8 * cur_[1].stride + size_t(mbx) * 8],
                               &cur_[2].px[size_t(mby) * 8 * cur_[2].stride + size_t(mbx) * 8]};
            const size_t stride[3] = {cur_[0].stride, cur_[1].stride, cur_[2].stride};
            if (skipped) {  // not coded: the reference's macroblock
                const int zero[1][2] = {{0, 0}};
                motion(ref_, dst, stride, mbx, mby, zero, false, no_rounding_);
                clear_intra(mbx, mby);
                ip_.mb_q[mb] = static_cast<int8_t>(qscale_);
                continue;
            }
            const bool intra = !p_vop || (cbpc & 4);
            const bool dquant = p_vop ? (cbpc & 8) : (cbpc & 4);
            std::memset(block, 0, sizeof(block));
            if (intra) {
                const bool ac_pred = b.get1();
                const int cbp = (cbpc & 3) | (lut_cbpy().read(b, "CBPY") << 2);
                const bool dc_vlc = qscale_ < dc_threshold_;
                if (dquant) set_qscale(qscale_ + kDquant[b.get(2)]);
                for (int k = 0; k < 6; ++k) {
                    int16_t* blk = block[k];
                    int dir = 0, pos;
                    if (dc_vlc) {
                        const int size = lut_dc(k >= 4).read(b, "DC size");
                        int level = 0;
                        if (size) {
                            const uint32_t v = b.get(size);
                            level = (v >> (size - 1)) ? int(v) : int(v) - ((1 << size) - 1);
                            if (size > 8) b.skip(1);  // marker
                        }
                        level = predict_dc(mbx, mby, k, level, &dir);
                        if (level < 0)  // FFmpeg's mpeg4_decode_dc fails the macroblock
                            fail(CORRUPT, "a negative intra DC level");
                        blk[0] = static_cast<int16_t>(level);
                        pos = 0;
                    } else {
                        dc_prediction(mbx, mby, k, &dir);  // the direction; the DC comes as a TCOEF
                        pos = -1;
                    }
                    if (cbp & (32 >> k)) {
                        const int* scan = !ac_pred ? kZigzag : (dir == 0 ? kAltVertical : kAltHorizontal);
                        decode_coefficients(b, blk, true, scan, pos, 1, 0);
                    }
                    if (!dc_vlc) blk[0] = static_cast<int16_t>(predict_dc(mbx, mby, k, blk[0], &dir));
                    predict_ac(mbx, mby, k, blk, dir, ac_pred);
                    // dct_unquantize_h263_intra, then idct_put
                    dequant_intra(blk, qscale_, k < 4 ? kYDcScale[qscale_] : kCDcScale[qscale_]);
                }
                for (int k = 0; k < 6; ++k) {
                    fmvfi_ff::Plane& p = cur_[k < 4 ? 0 : k - 3];
                    const size_t x = k < 4 ? size_t(mbx) * 16 + (k & 1) * 8 : size_t(mbx) * 8;
                    const size_t y = k < 4 ? size_t(mby) * 16 + (k >> 1) * 8 : size_t(mby) * 8;
                    fmvfi_ff::simple_idct_put(block[k], &p.px[y * p.stride + x], p.stride);
                }
                for (int k = 0; k < 4; ++k) {
                    int16_t* v = mv_at(2 * mbx + (k & 1), 2 * mby + (k >> 1));
                    v[0] = v[1] = 0;
                }
                ip_.mb_q[mb] = static_cast<int8_t>(qscale_);
                continue;
            }
            const bool four = cbpc & 16;
            const int cbp = (cbpc & 3) | ((lut_cbpy().read(b, "CBPY") ^ 15) << 2);
            if (dquant) set_qscale(qscale_ + kDquant[b.get(2)]);
            int mv[4][2];
            for (int k = 0; k < (four ? 4 : 1); ++k) {
                int px, py;
                predict_mv(mbx, mby, k, &px, &py);
                mv[k][0] = decode_mv(b, px, fcode_);
                mv[k][1] = decode_mv(b, py, fcode_);
                if (four) {
                    int16_t* v = mv_at(2 * mbx + (k & 1), 2 * mby + (k >> 1));
                    v[0] = static_cast<int16_t>(mv[k][0]);
                    v[1] = static_cast<int16_t>(mv[k][1]);
                }
            }
            if (!four)
                for (int k = 0; k < 4; ++k) {
                    int16_t* v = mv_at(2 * mbx + (k & 1), 2 * mby + (k >> 1));
                    v[0] = static_cast<int16_t>(mv[0][0]);
                    v[1] = static_cast<int16_t>(mv[0][1]);
                }
            const int qmul = qscale_ << 1, qadd = (qscale_ - 1) | 1;
            bool coded[6];
            for (int k = 0; k < 6; ++k) {
                coded[k] = cbp & (32 >> k);
                if (coded[k]) decode_coefficients(b, block[k], false, kZigzag, -1, qmul, qadd);
            }
            if (b.left() < 0) fail(CORRUPT, "a VOP cut short");
            motion(ref_, dst, stride, mbx, mby, mv, four, no_rounding_);
            for (int k = 0; k < 6; ++k) {
                if (!coded[k]) continue;
                fmvfi_ff::Plane& p = cur_[k < 4 ? 0 : k - 3];
                const size_t x = k < 4 ? size_t(mbx) * 16 + (k & 1) * 8 : size_t(mbx) * 8;
                const size_t y = k < 4 ? size_t(mby) * 16 + (k >> 1) * 8 : size_t(mby) * 8;
                fmvfi_ff::simple_idct_add(block[k], &p.px[y * p.stride + x], p.stride);
            }
            clear_intra(mbx, mby);
            ip_.mb_q[mb] = static_cast<int8_t>(qscale_);
        }
    }
    if (b.left() < 0) fail(CORRUPT, "a VOP cut short");
    have_ref_ = true;
    return true;
}

void Decoder::frame_rgb(uint8_t* out) const {
    // FFmpeg's mpeg4 decoder reports AVCHROMA_LOC_LEFT, which OpenCV hands to swscale
    fmvfi_ff::yuv_to_rgb(vol_.width, vol_.height, 3, 2, 2, cur_, false, out, 0);
}

}  // namespace fmvfi_mpeg4

using namespace fmvfi_mpeg4;

extern "C" {

void* fmvfi_mpeg4_open(uint32_t fourcc, const uint8_t* config, int64_t n, char* msg,
                       int32_t msglen, int32_t* code) {
    Decoder* dec = nullptr;
    try {
        dec = new Decoder(fourcc);
        if (n > 0) dec->configure(config, static_cast<size_t>(n));
        *code = OK;
        return dec;
    } catch (const Error& e) {
        delete dec;
        *code = fmvfi_jpeg::report(e, msg, msglen);
    } catch (const std::bad_alloc&) {
        delete dec;
        *code = fmvfi_jpeg::report(Error{CORRUPT, "out of memory"}, msg, msglen);
    }
    return nullptr;
}

int32_t fmvfi_mpeg4_decode(void* handle, const uint8_t* data, int64_t n, int32_t* info, char* msg,
                           int32_t msglen) {
    Decoder* dec = static_cast<Decoder*>(handle);
    try {
        const bool got = dec->decode(data, static_cast<size_t>(n));
        info[0] = dec->width();
        info[1] = dec->height();
        info[2] = got;
        info[3] = got ? dec->last_vop_type() : 0;
        info[4] = got ? dec->last_rounding() : 0;
        return OK;
    } catch (const Error& e) {
        return fmvfi_jpeg::report(e, msg, msglen);
    } catch (const std::bad_alloc&) {
        return fmvfi_jpeg::report(Error{CORRUPT, "out of memory"}, msg, msglen);
    }
}

void fmvfi_mpeg4_frame(void* handle, uint8_t* out) {
    static_cast<Decoder*>(handle)->frame_rgb(out);
}

void fmvfi_mpeg4_close(void* handle) { delete static_cast<Decoder*>(handle); }

}  // extern "C"
