// fmvfi_tpu_torch native host runtime: MPEG-1 and MPEG-2 video decoded as
// cv2.VideoCapture decodes it, for fmvfi_tpu_torch/utils/mpegts.py (program,
// transport and raw streams), utils/avi.py, utils/mkv.py and utils/mp4.py.
//
// cv2's video backend is FFmpeg: its mpeg1video / mpeg2video decoder turns
// each picture into a yuv420p frame whose planes are whole macroblocks, and
// OpenCV converts the frame's visible part to BGR24 with swscale (limited
// range; BT.601 unless a sequence display extension names BT.709; MPEG-2's
// chroma sited left, MPEG-1's centred; ffmpeg_common.h's yuv_to_rgb).  This
// file repeats the decoder, bit for bit, for 4:2:0 8-bit frame pictures:
//   - sequence headers and their extension, sequence display and quant
//     matrix extensions (matrices loaded in zigzag order, an intra matrix's
//     first entry forced to 8), GOP headers, picture headers and picture
//     coding extensions, slices (MPEG-1's may span rows);
//   - I, P and B macroblocks: the macroblock address increment with escape
//     and stuffing, skipped macroblocks (zero vector in P pictures; the
//     previous macroblock's vectors and directions in B pictures), quantiser
//     changes (linear, or MPEG-2's non-linear q_scale_type), coded block
//     patterns, intra macroblocks among inter ones;
//   - motion vectors with f_code and modulo wrapping, predicted from the
//     previous macroblock's (reset at slice starts, intra macroblocks and P
//     macroblocks without motion), frame and field motion in frame pictures;
//     FFmpeg's mpeg_motion: half-pel put / average (rounding up), chroma
//     vectors halved towards zero, a vector reading past the macroblock-
//     aligned picture refused (FFmpeg leaves such a block unpredicted);
//   - DCT coefficients from table B.14 or B.15 (intra_vlc_format), zigzag or
//     alternate scan, MPEG-1 escapes (8 or 16 bits) and MPEG-2's (12 bits);
//     MPEG-1 dequantisation with oddification, MPEG-2's with mismatch
//     control, intra_dc_precision 8-11; frame or field DCT; FFmpeg's simple
//     IDCT, put for intra blocks and added to the prediction for inter ones;
//   - display order: B pictures come out at once, I and P pictures when the
//     next one arrives (none with low_delay), the last at the flush.
// What FFmpeg decodes otherwise is refused as unsupported (the caller names
// ROADMAP item 18.4h): field pictures, dual-prime motion, 4:2:2 and 4:4:4
// chroma, scalable extensions, concealment motion vectors, MPEG-1 D
// pictures, full-pel vectors, a P or
// B picture without its references (FFmpeg predicts from grey frames), a
// change of size within the stream, more than one picture in a packet,
// matrix coefficients other than BT.601's and BT.709's, and an interlaced
// picture (progressive_frame 0 in an interlaced sequence): FFmpeg decodes
// it, but cv2's conversion refuses an interlaced frame and returns a buffer
// it never wrote.  Field DCT and field motion in a picture marked
// progressive are decoded.  Malformed data
// (an invalid code, a block past 64 coefficients, a slice that does not end
// where the picture does, a picture not every macroblock of which is
// coded) is refused as corrupt: FFmpeg conceals it.
//
// Exposed C ABI (ctypes):
//   fmvfi_mpeg12_open(config, n, msg, msglen, code) -> handle
//     config: headers decoded before the first packet (a container's
//     sequence header; n = 0 for none)
//   fmvfi_mpeg12_decode(handle, data, n, info, msg, msglen) -> int32
//     one packet (one picture and the headers before it); info = {frame
//     ready (0/1), width, height, the decoded picture's type ('I', 'P', 'B'
//     or 0), MPEG-2 (0/1), feature bits, intra_dc_precision + 8}
//   fmvfi_mpeg12_flush(handle, info) -> int32: the end of the stream (info
//     as above)
//   fmvfi_mpeg12_frame(handle, out): the ready frame, height * width * 3 RGB
//   fmvfi_mpeg12_close(handle)
// Codes: 0, 1 (unsupported) or 2 (corrupt), msg saying why.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "ffmpeg_common.h"
#include "mpeg4.h"

namespace fmvfi_mpeg12 {

using fmvfi_jpeg::CORRUPT;
using fmvfi_jpeg::Error;
using fmvfi_jpeg::fail;
using fmvfi_jpeg::OK;
using fmvfi_jpeg::UNSUPPORTED;
using fmvfi_mpeg4::Bits;
using fmvfi_mpeg4::Code;
using fmvfi_ff::Plane;

// feature bits (native.MPEG12_FEATURES): what a packet's picture uses
enum Feature : uint32_t {
    F_B_PICTURE = 1, F_SKIPPED = 2, F_INTRA_IN_INTER = 4, F_FIELD_DCT = 8, F_FIELD_MOTION = 16,
    F_ALTERNATE_SCAN = 32, F_INTRA_VLC = 64, F_NONLINEAR_Q = 128, F_QUANT_CHANGE = 256,
    F_CUSTOM_INTRA = 1024, F_CUSTOM_INTER = 2048, F_QUANT_EXT = 4096,
    F_BT709 = 8192, F_ESCAPE = 16384, F_BIDIRECTIONAL = 32768, F_HALF_PEL = 65536,
    F_INTERLACED_SEQ = 1 << 17, F_MULTI_ROW_SLICE = 1 << 18, F_MBA_ESCAPE = 1 << 19,
    F_BACKWARD = 1 << 20, F_ZERO_MV = 1 << 21,
};

// table B.14 (ff_mpeg1_vlc_table) and B.15 (ff_mpeg2_vlc_table): 111
// (run, level) codes, run-major as kRunCount says, then escape and end of
// block (the sign bit not included)
const Code kDctB14[113] = {
    {3, 2},   {4, 4},   {5, 5},   {6, 7},   {38, 8},  {33, 8},  {10, 10}, {29, 12}, {24, 12},
    {19, 12}, {16, 12}, {26, 13}, {25, 13}, {24, 13}, {23, 13}, {31, 14}, {30, 14}, {29, 14},
    {28, 14}, {27, 14}, {26, 14}, {25, 14}, {24, 14}, {23, 14}, {22, 14}, {21, 14}, {20, 14},
    {19, 14}, {18, 14}, {17, 14}, {16, 14}, {24, 15}, {23, 15}, {22, 15}, {21, 15}, {20, 15},
    {19, 15}, {18, 15}, {17, 15}, {16, 15}, {3, 3},   {6, 6},   {37, 8},  {12, 10}, {27, 12},
    {22, 13}, {21, 13}, {31, 15}, {30, 15}, {29, 15}, {28, 15}, {27, 15}, {26, 15}, {25, 15},
    {19, 16}, {18, 16}, {17, 16}, {16, 16}, {5, 4},   {4, 7},   {11, 10}, {20, 12}, {20, 13},
    {7, 5},   {36, 8},  {28, 12}, {19, 13}, {6, 5},   {15, 10}, {18, 12}, {7, 6},   {9, 10},
    {18, 13}, {5, 6},   {30, 12}, {20, 16}, {4, 6},   {21, 12}, {7, 7},   {17, 12}, {5, 7},
    {17, 13}, {39, 8},  {16, 13}, {35, 8},  {26, 16}, {34, 8},  {25, 16}, {32, 8},  {24, 16},
    {14, 10}, {23, 16}, {13, 10}, {22, 16}, {8, 10},  {21, 16}, {31, 12}, {26, 12}, {25, 12},
    {23, 12}, {22, 12}, {31, 13}, {30, 13}, {29, 13}, {28, 13}, {27, 13}, {31, 16}, {30, 16},
    {29, 16}, {28, 16}, {27, 16}, {1, 6},   {2, 2}};
const Code kDctB15[113] = {
    {2, 2},   {6, 3},   {7, 4},   {28, 5},  {29, 5},  {5, 6},   {4, 6},   {123, 7}, {124, 7},
    {35, 8},  {34, 8},  {250, 8}, {251, 8}, {254, 8}, {255, 8}, {31, 14}, {30, 14}, {29, 14},
    {28, 14}, {27, 14}, {26, 14}, {25, 14}, {24, 14}, {23, 14}, {22, 14}, {21, 14}, {20, 14},
    {19, 14}, {18, 14}, {17, 14}, {16, 14}, {24, 15}, {23, 15}, {22, 15}, {21, 15}, {20, 15},
    {19, 15}, {18, 15}, {17, 15}, {16, 15}, {2, 3},   {6, 5},   {121, 7}, {39, 8},  {32, 8},
    {22, 13}, {21, 13}, {31, 15}, {30, 15}, {29, 15}, {28, 15}, {27, 15}, {26, 15}, {25, 15},
    {19, 16}, {18, 16}, {17, 16}, {16, 16}, {5, 5},   {7, 7},   {252, 8}, {12, 10}, {20, 13},
    {7, 5},   {38, 8},  {28, 12}, {19, 13}, {6, 6},   {253, 8}, {18, 12}, {7, 6},   {4, 9},
    {18, 13}, {6, 7},   {30, 12}, {20, 16}, {4, 7},   {21, 12}, {5, 7},   {17, 12}, {120, 7},
    {17, 13}, {122, 7}, {16, 13}, {33, 8},  {26, 16}, {37, 8},  {25, 16}, {36, 8},  {24, 16},
    {5, 9},   {23, 16}, {7, 9},   {22, 16}, {13, 10}, {21, 16}, {31, 12}, {26, 12}, {25, 12},
    {23, 12}, {22, 12}, {31, 13}, {30, 13}, {29, 13}, {28, 13}, {27, 13}, {31, 16}, {30, 16},
    {29, 16}, {28, 16}, {27, 16}, {1, 6},   {6, 4}};
constexpr int kEscape = 111, kEob = 112;
// the number of levels of each run, runs 0-31, in the tables' order
constexpr int kRunCount[32] = {40, 18, 5, 4, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                               2,  1,  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};

// B.1 macroblock_address_increment: increments 1-33, escape, stuffing and
// eight zero bits (the end of a slice)
const Code kMbaIncr[36] = {
    {1, 1},   {3, 3},   {2, 3},   {3, 4},   {2, 4},   {3, 5},   {2, 5},   {7, 7},   {6, 7},
    {11, 8},  {10, 8},  {9, 8},   {8, 8},   {7, 8},   {6, 8},   {23, 10}, {22, 10}, {21, 10},
    {20, 10}, {19, 10}, {18, 10}, {35, 11}, {34, 11}, {33, 11}, {32, 11}, {31, 11}, {30, 11},
    {29, 11}, {28, 11}, {27, 11}, {26, 11}, {25, 11}, {24, 11}, {8, 11},  {15, 11}, {0, 8}};
// B.3 / B.4 macroblock_type, FFmpeg's order (ptype2mb_type, btype2mb_type)
const Code kPType[7] = {{3, 5}, {1, 2}, {1, 3}, {1, 1}, {1, 6}, {1, 5}, {2, 5}};
const Code kBType[11] = {{3, 5}, {2, 3}, {3, 3}, {2, 4}, {3, 4}, {2, 2},
                         {3, 2}, {1, 6}, {2, 6}, {3, 6}, {2, 5}};
// B.9 coded_block_pattern (index: the pattern; 0 is MPEG-2's, which FFmpeg refuses)
const Code kCbp[64] = {
    {1, 9},  {11, 5}, {9, 5},  {13, 6}, {13, 4}, {23, 7}, {19, 7}, {31, 8}, {12, 4}, {22, 7},
    {18, 7}, {30, 8}, {19, 5}, {27, 8}, {23, 8}, {19, 8}, {11, 4}, {21, 7}, {17, 7}, {29, 8},
    {17, 5}, {25, 8}, {21, 8}, {17, 8}, {15, 6}, {15, 8}, {13, 8}, {3, 9},  {15, 5}, {11, 8},
    {7, 8},  {7, 9},  {10, 4}, {20, 7}, {16, 7}, {28, 8}, {14, 6}, {14, 8}, {12, 8}, {2, 9},
    {16, 5}, {24, 8}, {20, 8}, {16, 8}, {14, 5}, {10, 8}, {6, 8},  {6, 9},  {18, 5}, {26, 8},
    {22, 8}, {18, 8}, {13, 5}, {9, 8},  {5, 8},  {5, 9},  {12, 5}, {8, 8},  {4, 8},  {4, 9},
    {7, 3},  {10, 5}, {8, 5},  {12, 6}};
// B.10 motion_code magnitudes 0-16 (a sign bit after each nonzero one)
const Code kMotion[17] = {{1, 1},  {1, 2},  {1, 3},   {1, 4},   {3, 6},   {5, 7},
                          {4, 7},  {3, 7},  {11, 9},  {10, 9},  {9, 9},   {17, 10},
                          {16, 10}, {15, 10}, {14, 10}, {13, 10}, {12, 10}};
// B.12 / B.13 dct_dc_size, luminance and chrominance
const Code kDcLum[12] = {{4, 3}, {0, 2}, {1, 2}, {5, 3}, {6, 3}, {14, 4},
                         {30, 5}, {62, 6}, {126, 7}, {254, 8}, {510, 9}, {511, 9}};
const Code kDcChrom[12] = {{0, 2}, {1, 2}, {2, 2}, {6, 3}, {14, 4}, {30, 5},
                           {62, 6}, {126, 7}, {254, 8}, {510, 9}, {1022, 10}, {1023, 10}};

constexpr uint16_t kDefaultIntra[64] = {
    8,  16, 19, 22, 26, 27, 29, 34, 16, 16, 22, 24, 27, 29, 34, 37, 19, 22, 26, 27, 29, 34,
    34, 38, 22, 22, 26, 27, 29, 34, 37, 40, 22, 26, 27, 29, 32, 35, 40, 48, 26, 27, 29, 32,
    35, 40, 48, 58, 26, 27, 29, 34, 38, 46, 56, 69, 27, 29, 35, 38, 46, 56, 69, 83};
constexpr int kNonLinearQ[32] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  10, 12,
                                 14, 16, 18, 20, 22, 24, 28, 32, 36, 40, 44,
                                 48, 52, 56, 64, 72, 80, 88, 96, 104, 112};
constexpr const int* kZigzag = fmvfi_jpeg::kNatural;
constexpr const int* kAlternate = fmvfi_mpeg4::kAltVertical;

enum { PIC_I = 1, PIC_P = 2, PIC_B = 3 };
enum { MB_INTRA = 1, MB_QUANT = 2, MB_FWD = 4, MB_BWD = 8, MB_CBP = 16, MB_ZERO_MV = 32 };
constexpr int kPTypes[7] = {MB_INTRA, MB_FWD | MB_CBP | MB_ZERO_MV, MB_FWD, MB_FWD | MB_CBP,
                            MB_QUANT | MB_INTRA, MB_QUANT | MB_FWD | MB_CBP | MB_ZERO_MV,
                            MB_QUANT | MB_FWD | MB_CBP};
constexpr int kBTypes[11] = {MB_INTRA,
                             MB_BWD,
                             MB_BWD | MB_CBP,
                             MB_FWD,
                             MB_FWD | MB_CBP,
                             MB_FWD | MB_BWD,
                             MB_FWD | MB_BWD | MB_CBP,
                             MB_QUANT | MB_INTRA,
                             MB_QUANT | MB_BWD | MB_CBP,
                             MB_QUANT | MB_FWD | MB_CBP,
                             MB_QUANT | MB_FWD | MB_BWD | MB_CBP};

// A code table as a lookup of its longest code's bits: symbol and length
// (-1 and 0 where no code starts).
struct Lut {
    int bits = 0;
    std::vector<int16_t> sym;
    std::vector<uint8_t> len;
    Lut(const Code* codes, int n) {
        for (int i = 0; i < n; ++i) bits = std::max<int>(bits, codes[i].len);
        sym.assign(size_t(1) << bits, -1);
        len.assign(size_t(1) << bits, 0);
        for (int i = 0; i < n; ++i) {
            const int pad = bits - codes[i].len;
            const size_t first = size_t(codes[i].code) << pad;
            for (size_t j = 0; j < (size_t(1) << pad); ++j) {
                sym[first + j] = static_cast<int16_t>(i);
                len[first + j] = codes[i].len;
            }
        }
    }
    int read(Bits& b, const char* what) const {
        const uint32_t v = b.show(bits);
        if (sym[v] < 0) fail(CORRUPT, std::string("an invalid ") + what + " code");
        b.skip(len[v]);
        return sym[v];
    }
};

const Lut& lut_b14() { static const Lut l(kDctB14, 113); return l; }
const Lut& lut_b15() { static const Lut l(kDctB15, 113); return l; }
const Lut& lut_incr() { static const Lut l(kMbaIncr, 36); return l; }
const Lut& lut_ptype() { static const Lut l(kPType, 7); return l; }
const Lut& lut_btype() { static const Lut l(kBType, 11); return l; }
const Lut& lut_cbp() { static const Lut l(kCbp, 64); return l; }
const Lut& lut_motion() { static const Lut l(kMotion, 17); return l; }
const Lut& lut_dc(int chroma) {
    static const Lut lum(kDcLum, 12), chrom(kDcChrom, 12);
    return chroma ? chrom : lum;
}

struct RunLevel {
    uint8_t run[111], level[111];
    RunLevel() {
        int k = 0;
        for (int r = 0; r < 32; ++r)
            for (int l = 1; l <= kRunCount[r]; ++l, ++k) {
                run[k] = static_cast<uint8_t>(r);
                level[k] = static_cast<uint8_t>(l);
            }
    }
};
const RunLevel& run_level() { static const RunLevel t; return t; }

int sign_extend(int v, int bits) { return static_cast<int>(uint32_t(v) << (32 - bits)) >> (32 - bits); }

// get_xbits: an n-bit field, negative when its first bit is 0
int xbits(Bits& b, int n) {
    const int v = static_cast<int>(b.get(n));
    return (v >> (n - 1)) ? v : v - ((1 << n) - 1);
}

using Frame = std::array<Plane, 3>;

class Decoder {
public:
    void configure(const uint8_t* d, size_t n) {
        if (chunks(d, n, true)) fail(CORRUPT, "a picture in the decoder configuration");
    }
    // one packet; returns whether a frame is ready for display
    bool decode(const uint8_t* d, size_t n) {
        features_ = 0;
        decoded_type_ = 0;
        ready_.reset();
        chunks(d, n, false);
        return ready_ != nullptr;
    }
    // the end of the stream: FFmpeg's last reference, unless low_delay
    bool flush() {
        features_ = 0;
        decoded_type_ = 0;
        ready_.reset();
        if (!low_delay_ && next_) ready_ = next_;
        next_.reset();
        return ready_ != nullptr;
    }
    int width() const { return width_; }
    int height() const { return height_; }
    int decoded_type() const { return decoded_type_; }
    bool mpeg2() const { return mpeg2_; }
    uint32_t features() const { return features_; }
    int dc_precision() const { return dc_prec_; }
    void frame_rgb(uint8_t* out) const {
        const Frame& f = *ready_;
        // MPEG-2's 4:2:0 chroma is sited left (AVCHROMA_LOC_LEFT), MPEG-1's
        // centred (swscale's default)
        fmvfi_ff::yuv_to_rgb(width_, height_, 3, 2, 2, f.data(), false, out,
                             ready_mpeg2_ ? 0 : -513,
                             matrix_ == 1 ? fmvfi_ff::BT709 : fmvfi_ff::BT601);
    }

private:
    // the sequence
    bool seq_seen_ = false, mpeg2_ = false, ready_mpeg2_ = false;
    int width_ = 0, height_ = 0, mbw_ = 0, mbh_ = 0;
    int coded_w_ = 0, coded_h_ = 0;  // the size the planes were made for
    bool progressive_seq_ = true, low_delay_ = false, closed_gop_ = false;
    int matrix_ = 2;  // matrix_coefficients (2: unspecified)
    uint16_t intra_q_[64], inter_q_[64], chroma_intra_q_[64], chroma_inter_q_[64];
    bool custom_intra_ = false, custom_inter_ = false, quant_ext_ = false;
    // the picture
    int pict_type_ = 0, f_code_[2][2] = {{1, 1}, {1, 1}}, full_pel_[2] = {0, 0};
    int dc_prec_ = 0, pic_struct_ = 3, fpfd_ = 1, qst_ = 0, ivf_ = 0, alt_ = 0;
    int mbs_coded_ = 0;
    bool picture_open_ = false, interlaced_frame_ = false;
    // frames: the reference pair (FFmpeg's last_pic and next_pic), the
    // picture being decoded, the frame ready for display
    std::shared_ptr<Frame> last_, next_, cur_, ready_;
    uint32_t features_ = 0;
    int decoded_type_ = 0;
    // the slice and macroblock state
    int qscale_ = 0, last_dc_[3] = {0, 0, 0};
    int last_mv_[2][2][2], mv_[2][2][2], field_select_[2][2];
    int mv_dir_ = 0, mv_field_ = 0, interlaced_dct_ = 0, mb_skip_run_ = 0;
    bool prev_intra_ = false;
    int mb_x_ = 0, mb_y_ = 0;

    bool chunks(const uint8_t* d, size_t n, bool config);
    void sequence_header(Bits& b);
    void extension(Bits& b, int last_code);
    void picture_header(Bits& b);
    void start_picture();
    void end_picture();
    void load_matrix(Bits& b, uint16_t* m0, uint16_t* m1, bool intra);
    void slice(const uint8_t* d, size_t n, int mb_y);
    void macroblock(Bits& b);
    int motion(Bits& b, int fcode, int pred);
    int qscale(Bits& b) {
        const int code = static_cast<int>(b.get(5));
        return qst_ ? kNonLinearQ[code] : code << 1;
    }
    void block_intra(Bits& b, int16_t* blk, int n);
    void block_inter(Bits& b, int16_t* blk, int n);
    void reconstruct(int16_t (*blocks)[64], const bool* coded, bool intra);
    void predict(const Frame& ref, int field_based, int bottom, int select, int mx, int my,
                 bool avg);
};

// decode_chunks: each start code's payload in turn; returns whether a
// picture was decoded
bool Decoder::chunks(const uint8_t* d, size_t n, bool config) {
    std::vector<size_t> at;
    for (size_t i = 0; i + 3 < n; ++i)
        if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1) {
            at.push_back(i + 3);
            i += 2;
        }
    int last_code = 0;
    bool picture_seen = false, skip = false;
    for (size_t k = 0; k < at.size(); ++k) {
        const size_t p = at[k];
        const int code = d[p];
        const size_t end = n;  // FFmpeg hands each start code the rest of the packet
        const uint8_t* body = d + p + 1;
        const size_t len = end - (p + 1);
        Bits b(body, len);
        if (code == 0xB3) {
            if (last_code == 0) sequence_header(b);
        } else if (code == 0xB5) {
            extension(b, last_code);
        } else if (code == 0xB8) {
            if (last_code == 0) {
                b.skip(25);  // time code
                closed_gop_ = b.get1();
            }
        } else if (code == 0x00) {
            if (config) return true;
            if (picture_seen)
                fail(UNSUPPORTED, "a packet holding more than one picture (FFmpeg decodes the "
                                  "first alone)");
            picture_seen = true;
            if (!seq_seen_) fail(CORRUPT, "a picture before any sequence header");
            picture_header(b);
            last_code = 0x100;
            skip = false;
        } else if (code >= 0x01 && code <= 0xAF && last_code != 0) {
            if (last_code == 0x100) {  // the picture's first slice
                if (pic_struct_ != 3)
                    fail(UNSUPPORTED, "an MPEG-2 field picture (picture_structure " +
                                          std::to_string(pic_struct_) + ")");
                if (pict_type_ == PIC_B && !last_) {
                    if (!closed_gop_) skip = true;  // FFmpeg drops it
                    else fail(UNSUPPORTED, "a B picture of a closed GOP without a forward "
                                           "reference (FFmpeg predicts it from a grey frame)");
                }
                if (pict_type_ == PIC_P && !next_)
                    fail(UNSUPPORTED, "a P picture before any I picture (FFmpeg predicts it "
                                      "from a grey frame)");
                if (!skip) start_picture();
            }
            last_code = 0x101;
            if (skip) continue;
            int mb_y = code - 1;
            if (mpeg2_ && mbh_ > 2800 / 16) mb_y += (body[0] & 0xE0) << 2;
            if (mb_y >= mbh_) fail(CORRUPT, "a slice below the picture");
            slice(body, len, mb_y);
        }  // sequence end, user data and system start codes: nothing kept
    }
    if (picture_open_) end_picture();
    return picture_seen;
}

void Decoder::load_matrix(Bits& b, uint16_t* m0, uint16_t* m1, bool intra) {
    for (int i = 0; i < 64; ++i) {
        int v = static_cast<int>(b.get(8));
        if (v == 0) fail(CORRUPT, "a quantiser matrix with a zero entry");
        if (intra && i == 0) v = 8;  // FFmpeg's: the DC entry is always 8
        m0[kZigzag[i]] = static_cast<uint16_t>(v);
        if (m1) m1[kZigzag[i]] = static_cast<uint16_t>(v);
    }
}

void Decoder::sequence_header(Bits& b) {
    const int w = static_cast<int>(b.get(12)), h = static_cast<int>(b.get(12));
    b.skip(4);  // aspect ratio
    b.skip(4);  // frame rate
    b.skip(18);  // bit rate
    if (!b.get1()) fail(CORRUPT, "a marker bit missing in the sequence header");
    b.skip(10 + 1);  // vbv buffer size, constrained parameters
    custom_intra_ = custom_inter_ = false;
    if (b.get1()) {
        load_matrix(b, chroma_intra_q_, intra_q_, true);
        custom_intra_ = true;
    } else {
        std::copy(kDefaultIntra, kDefaultIntra + 64, intra_q_);
        std::copy(kDefaultIntra, kDefaultIntra + 64, chroma_intra_q_);
    }
    if (b.get1()) {
        load_matrix(b, chroma_inter_q_, inter_q_, false);
        custom_inter_ = true;
    } else {
        std::fill(inter_q_, inter_q_ + 64, 16);
        std::fill(chroma_inter_q_, chroma_inter_q_ + 64, 16);
    }
    if (b.show(23) != 0) fail(CORRUPT, "a damaged sequence header");
    if (w == 0 || h == 0) fail(CORRUPT, "a sequence header of size 0");
    if (seq_seen_ && ((w & 0xFFF) != (width_ & 0xFFF) || (h & 0xFFF) != (height_ & 0xFFF)))
        fail(UNSUPPORTED, "an MPEG video stream whose size changes");
    // MPEG-1 until a sequence extension says otherwise
    width_ = w;
    height_ = h;
    mpeg2_ = false;
    progressive_seq_ = true;
    pic_struct_ = 3;
    fpfd_ = 1;
    seq_seen_ = true;
    quant_ext_ = false;
}

void Decoder::extension(Bits& b, int last_code) {
    const int id = static_cast<int>(b.get(4));
    if (id == 1) {  // sequence extension
        if (last_code != 0) return;
        b.skip(1 + 3 + 4);  // profile and level
        progressive_seq_ = b.get1();
        const int chroma = static_cast<int>(b.get(2));
        if (chroma == 2 || chroma == 3)
            fail(UNSUPPORTED, std::string("MPEG-2 ") + (chroma == 2 ? "4:2:2" : "4:4:4") +
                                  " chroma");
        width_ |= static_cast<int>(b.get(2)) << 12;
        height_ |= static_cast<int>(b.get(2)) << 12;
        b.skip(12 + 1 + 8);  // bit rate extension, marker, vbv extension
        low_delay_ = b.get1();
        mpeg2_ = true;
    } else if (id == 2) {  // sequence display extension
        b.skip(3);
        if (b.get1()) {
            b.skip(16);  // primaries, transfer
            const int m = static_cast<int>(b.get(8));
            if (m != 1 && m != 2 && m != 5 && m != 6)
                fail(UNSUPPORTED, "a sequence display extension whose matrix_coefficients (" +
                                      std::to_string(m) + ") swscale converts otherwise");
            matrix_ = m;
        }
    } else if (id == 3) {  // quant matrix extension
        quant_ext_ = true;
        if (b.get1()) load_matrix(b, chroma_intra_q_, intra_q_, true);
        if (b.get1()) load_matrix(b, chroma_inter_q_, inter_q_, false);
        if (b.get1()) load_matrix(b, chroma_intra_q_, nullptr, true);
        if (b.get1()) load_matrix(b, chroma_inter_q_, nullptr, false);
    } else if (id == 8) {  // picture coding extension
        if (last_code != 0x100) return;
        full_pel_[0] = full_pel_[1] = 0;
        for (int i = 0; i < 2; ++i)
            for (int j = 0; j < 2; ++j) {
                const int f = static_cast<int>(b.get(4));
                f_code_[i][j] = f + !f;
            }
        dc_prec_ = static_cast<int>(b.get(2));
        pic_struct_ = static_cast<int>(b.get(2));
        b.skip(1);  // top_field_first
        fpfd_ = b.get1();
        if (b.get1())
            fail(UNSUPPORTED, "MPEG-2 concealment motion vectors (no encoder at hand writes "
                              "them: not checked against FFmpeg)");
        qst_ = b.get1();
        ivf_ = b.get1();
        alt_ = b.get1();
        b.skip(1);  // repeat_first_field
        b.skip(1);  // chroma_420_type
        const int progressive_frame = b.get1();
        // FFmpeg takes a progressive sequence's pictures as progressive
        interlaced_frame_ = !progressive_frame && !progressive_seq_;
        if (pic_struct_ == 0 || (progressive_frame && pic_struct_ != 3))
            fail(UNSUPPORTED, "a picture coding extension with picture_structure " +
                                  std::to_string(pic_struct_) + " (FFmpeg repairs it)");
    } else if (id == 5 || id == 9 || id == 10) {
        fail(UNSUPPORTED, "an MPEG-2 scalable extension (FFmpeg decodes the base layer alone)");
    }
}

void Decoder::picture_header(Bits& b) {
    b.skip(10);  // temporal reference
    pict_type_ = static_cast<int>(b.get(3));
    if (pict_type_ == 4) fail(UNSUPPORTED, "an MPEG-1 D picture");
    if (pict_type_ == 0 || pict_type_ > 4) fail(CORRUPT, "an invalid picture coding type");
    b.skip(16);  // vbv delay
    for (int i = 0; i < (pict_type_ == PIC_B ? 2 : pict_type_ == PIC_P ? 1 : 0); ++i) {
        full_pel_[i] = b.get1();  // forward, then backward
        const int f = static_cast<int>(b.get(3));
        f_code_[i][0] = f_code_[i][1] = f + !f;
    }
    if (!mpeg2_) {  // MPEG-1 leaves the MPEG-2 picture fields at their defaults
        dc_prec_ = 0;
        pic_struct_ = 3;
        fpfd_ = 1;
        qst_ = ivf_ = alt_ = 0;
        interlaced_frame_ = false;
    }
}

void Decoder::start_picture() {
    if (full_pel_[0] || full_pel_[1]) fail(UNSUPPORTED, "MPEG-1 full-pel motion vectors");
    if (interlaced_frame_)
        fail(UNSUPPORTED, "an interlaced MPEG-2 picture (progressive_frame 0): cv2's conversion "
                          "refuses an interlaced frame (\"Cannot convert interlaced to "
                          "progressive frames\") and returns a buffer it never wrote");
    mbw_ = (width_ + 15) / 16;
    mbh_ = mpeg2_ && !progressive_seq_ ? 2 * ((height_ + 31) / 32) : (height_ + 15) / 16;
    if (coded_w_ && (coded_w_ != mbw_ * 16 || coded_h_ != mbh_ * 16))
        fail(UNSUPPORTED, "an MPEG video stream whose size changes");
    coded_w_ = mbw_ * 16;
    coded_h_ = mbh_ * 16;
    cur_ = std::make_shared<Frame>();
    for (int c = 0; c < 3; ++c) {
        Plane& p = (*cur_)[c];
        p.stride = size_t(c ? coded_w_ / 2 : coded_w_);
        p.px.assign(p.stride * size_t(c ? coded_h_ / 2 : coded_h_), 0);
        p.w = c ? (width_ + 1) / 2 : width_;
        p.h = c ? (height_ + 1) / 2 : height_;
    }
    if (pict_type_ != PIC_B) {  // ff_mpv_frame_start
        last_ = next_;
        next_ = cur_;
    }
    picture_open_ = true;
    mbs_coded_ = 0;
    decoded_type_ = " IPB"[pict_type_];
    if (pict_type_ == PIC_B) features_ |= F_B_PICTURE;
    if (alt_) features_ |= F_ALTERNATE_SCAN;
    if (ivf_) features_ |= F_INTRA_VLC;
    if (qst_) features_ |= F_NONLINEAR_Q;
    if (custom_intra_) features_ |= F_CUSTOM_INTRA;
    if (custom_inter_) features_ |= F_CUSTOM_INTER;
    if (quant_ext_) features_ |= F_QUANT_EXT;
    if (matrix_ == 1) features_ |= F_BT709;
    if (!progressive_seq_) features_ |= F_INTERLACED_SEQ;
}

void Decoder::end_picture() {
    picture_open_ = false;
    if (mbs_coded_ != mbw_ * mbh_)
        fail(CORRUPT, "a picture of which " + std::to_string(mbw_ * mbh_ - mbs_coded_) +
                          " macroblocks are not coded (FFmpeg conceals them)");
    if (pict_type_ == PIC_B || low_delay_) ready_ = cur_;
    else if (last_) ready_ = last_;  // a latency of one picture for I and P
    ready_mpeg2_ = mpeg2_;
    cur_.reset();
}

int Decoder::motion(Bits& b, int fcode, int pred) {
    const int code = lut_motion().read(b, "motion_code");
    if (code == 0) return pred;
    const int sign = b.get1(), shift = fcode - 1;
    int val = code;
    if (shift) {
        val = (val - 1) << shift;
        val |= static_cast<int>(b.get(shift));
        ++val;
    }
    if (sign) val = -val;
    return sign_extend(val + pred, 5 + shift);
}

void Decoder::slice(const uint8_t* d, size_t n, int mb_y) {
    Bits b(d, n);
    if (mpeg2_ && mbh_ > 2800 / 16) b.skip(3);
    last_dc_[0] = last_dc_[1] = last_dc_[2] = 1 << (7 + dc_prec_);  // ff_mpeg1_clean_buffers
    std::memset(last_mv_, 0, sizeof(last_mv_));
    interlaced_dct_ = 0;
    qscale_ = qscale(b);
    if (qscale_ == 0) fail(CORRUPT, "a slice whose quantiser is 0");
    while (b.get1()) b.skip(8);  // extra slice information
    int mb_x = 0;
    for (;;) {
        if (b.left() <= 0) fail(CORRUPT, "a slice cut short");
        const int code = lut_incr().read(b, "macroblock_address_increment");
        if (code >= 33) {
            if (code == 33) {
                mb_x += 33;
                features_ |= F_MBA_ESCAPE;
            }
        } else {
            mb_x += code;
            break;
        }
    }
    if (mb_x >= mbw_) fail(CORRUPT, "a slice starting past the picture's width");
    mb_x_ = mb_x;
    mb_y_ = mb_y;
    mb_skip_run_ = 0;
    const int first_row = mb_y;
    for (;;) {
        if (mb_y_ != first_row) features_ |= F_MULTI_ROW_SLICE;
        macroblock(b);
        ++mbs_coded_;
        if (++mb_x_ >= mbw_) {
            mb_x_ = 0;
            ++mb_y_;
            if (mb_y_ >= mbh_) {
                const int64_t left = b.left();
                if (left < 0 || (left && b.show(int(std::min<int64_t>(left, 23)))))
                    fail(CORRUPT, "data past the picture's last macroblock");
                break;
            }
            const int64_t left = b.left();
            if (mb_y_ >= ((height_ + 15) >> 4) && !progressive_seq_ && left <= 25 && left >= 0 &&
                mb_skip_run_ == -1 && (!left || b.show(int(left)) == 0))
                break;  // a missing last slice outside the visible picture
        }
        if (mb_skip_run_ == -1) {  // the next increment
            mb_skip_run_ = 0;
            bool end = false;
            for (;;) {
                const int code = lut_incr().read(b, "macroblock_address_increment");
                if (code >= 33) {
                    if (code == 33) {
                        mb_skip_run_ += 33;
                        features_ |= F_MBA_ESCAPE;
                    } else if (code == 35) {
                        if (mb_skip_run_ != 0 || b.show(15) != 0)
                            fail(CORRUPT, "a slice that ends amid its macroblocks");
                        end = true;
                        break;
                    }
                } else {
                    mb_skip_run_ += code;
                    break;
                }
            }
            if (end) break;
            if (mb_skip_run_) {
                if (pict_type_ == PIC_I) fail(CORRUPT, "a skipped macroblock in an I picture");
                features_ |= F_SKIPPED;
                last_dc_[0] = last_dc_[1] = last_dc_[2] = 128 << dc_prec_;
                mv_field_ = 0;
                if (pict_type_ == PIC_P) {
                    mv_dir_ = MB_FWD;
                    mv_[0][0][0] = mv_[0][0][1] = 0;
                    std::memset(last_mv_[0], 0, sizeof(last_mv_[0]));
                    field_select_[0][0] = 0;
                } else {  // the previous vectors and directions
                    mv_[0][0][0] = last_mv_[0][0][0];
                    mv_[0][0][1] = last_mv_[0][0][1];
                    mv_[1][0][0] = last_mv_[1][0][0];
                    mv_[1][0][1] = last_mv_[1][0][1];
                    field_select_[0][0] = field_select_[1][0] = 0;
                }
            }
        }
    }
}

void Decoder::macroblock(Bits& b) {
    alignas(16) int16_t blocks[6][64];
    bool coded[6] = {false, false, false, false, false, false};
    if (mb_skip_run_-- != 0) {  // a skipped macroblock
        if (pict_type_ == PIC_B && prev_intra_)
            fail(CORRUPT, "a skipped macroblock after an intra one in a B picture");
        reconstruct(blocks, coded, false);
        return;
    }
    int type;
    if (pict_type_ == PIC_I) {
        if (b.get1()) {
            type = MB_INTRA;
        } else {
            if (!b.get1()) fail(CORRUPT, "an invalid macroblock type in an I picture");
            type = MB_INTRA | MB_QUANT;
        }
    } else if (pict_type_ == PIC_P) {
        type = kPTypes[lut_ptype().read(b, "macroblock_type")];
    } else {
        type = kBTypes[lut_btype().read(b, "macroblock_type")];
    }
    if (type & MB_QUANT) features_ |= F_QUANT_CHANGE;
    if (type & MB_INTRA) {
        if (pict_type_ != PIC_I) features_ |= F_INTRA_IN_INTER;
        std::memset(blocks, 0, sizeof(blocks));
        if (!fpfd_) interlaced_dct_ = b.get1();
        if (type & MB_QUANT) qscale_ = qscale(b);
        std::memset(last_mv_, 0, sizeof(last_mv_));
        for (int i = 0; i < 6; ++i) {
            block_intra(b, blocks[i], i);
            coded[i] = true;
        }
        prev_intra_ = true;
        if (interlaced_dct_) features_ |= F_FIELD_DCT;
        reconstruct(blocks, coded, true);
        return;
    }
    prev_intra_ = false;
    if (type & MB_ZERO_MV) {
        features_ |= F_ZERO_MV;
        mv_dir_ = MB_FWD;
        mv_field_ = 0;
        if (!fpfd_) interlaced_dct_ = b.get1();
        if (type & MB_QUANT) qscale_ = qscale(b);
        std::memset(last_mv_[0], 0, sizeof(last_mv_[0]));
        mv_[0][0][0] = mv_[0][0][1] = 0;
    } else {
        int motion_type = 2;  // frame
        if (!fpfd_) {
            motion_type = static_cast<int>(b.get(2));
            if (type & MB_CBP) interlaced_dct_ = b.get1();
        }
        if (type & MB_QUANT) qscale_ = qscale(b);
        mv_dir_ = type & (MB_FWD | MB_BWD);
        if ((mv_dir_ & MB_FWD) && (mv_dir_ & MB_BWD)) features_ |= F_BIDIRECTIONAL;
        else if (mv_dir_ & MB_BWD) features_ |= F_BACKWARD;
        if (motion_type == 2) {
            mv_field_ = 0;
            for (int i = 0; i < 2; ++i) {
                if (!(mv_dir_ & (MB_FWD << i))) continue;
                const int x = motion(b, f_code_[i][0], last_mv_[i][0][0]);
                mv_[i][0][0] = last_mv_[i][0][0] = last_mv_[i][1][0] = x;
                const int y = motion(b, f_code_[i][1], last_mv_[i][0][1]);
                mv_[i][0][1] = last_mv_[i][0][1] = last_mv_[i][1][1] = y;
            }
        } else if (motion_type == 1) {
            features_ |= F_FIELD_MOTION;
            mv_field_ = 1;
            for (int i = 0; i < 2; ++i) {
                if (!(mv_dir_ & (MB_FWD << i))) continue;
                for (int j = 0; j < 2; ++j) {
                    field_select_[i][j] = b.get1();
                    const int x = motion(b, f_code_[i][0], last_mv_[i][j][0]);
                    last_mv_[i][j][0] = mv_[i][j][0] = x;
                    const int y = motion(b, f_code_[i][1], last_mv_[i][j][1] >> 1);
                    last_mv_[i][j][1] = 2 * y;
                    mv_[i][j][1] = y;
                }
            }
        } else if (motion_type == 3) {
            if (progressive_seq_) fail(CORRUPT, "dual-prime motion in a progressive sequence");
            fail(UNSUPPORTED, "MPEG-2 dual-prime motion");
        } else {
            fail(CORRUPT, "a motion_type of 0");
        }
    }
    if (type & MB_CBP) {
        int cbp = lut_cbp().read(b, "coded_block_pattern");
        if (cbp <= 0) fail(CORRUPT, "a coded_block_pattern of 0");
        std::memset(blocks, 0, sizeof(blocks));
        for (int i = 0; i < 6; ++i) {
            if (cbp & 32) {
                block_inter(b, blocks[i], i);
                coded[i] = true;
            }
            cbp += cbp;
        }
        if (interlaced_dct_) features_ |= F_FIELD_DCT;
    }
    reconstruct(blocks, coded, false);
}

void Decoder::block_intra(Bits& b, int16_t* blk, int n) {
    const int component = n < 4 ? 0 : n - 3;
    const Lut& dc_lut = lut_dc(component);
    const int size = dc_lut.read(b, "dct_dc_size");
    const int diff = size ? xbits(b, size) : 0;
    last_dc_[component] += diff;
    const int* scan = alt_ ? kAlternate : kZigzag;
    const RunLevel& rl = run_level();
    if (!mpeg2_) {  // ff_mpeg1_decode_block_intra
        const uint16_t* qm = intra_q_;
        blk[0] = static_cast<int16_t>(last_dc_[component] * qm[0]);
        int i = 0;
        if (b.show(2) == 2) {
            b.skip(2);
            return;
        }
        for (;;) {
            const int sym = lut_b14().read(b, "DCT coefficient");
            int level, run;
            if (sym == kEscape) {
                run = static_cast<int>(b.get(6)) + 1;
                level = b.sget(8);
                if (level == -128) level = static_cast<int>(b.get(8)) - 256;
                else if (level == 0) level = static_cast<int>(b.get(8));
                features_ |= F_ESCAPE;
                i += run;
                if (i > 63) fail(CORRUPT, "a block's coefficients run past 64");
                const int j = scan[i];
                if (level < 0) {
                    level = (-level * qscale_ * qm[j]) >> 4;
                    level = -((level - 1) | 1);
                } else {
                    level = (level * qscale_ * qm[j]) >> 4;
                    level = (level - 1) | 1;
                }
                blk[j] = static_cast<int16_t>(level);
            } else {
                if (sym == kEob) fail(CORRUPT, "an end of block where a coefficient belongs");
                run = rl.run[sym] + 1;
                i += run;
                if (i > 63) fail(CORRUPT, "a block's coefficients run past 64");
                const int j = scan[i];
                level = (rl.level[sym] * qscale_ * qm[j]) >> 4;
                level = (level - 1) | 1;
                if (b.get1()) level = -level;
                blk[j] = static_cast<int16_t>(level);
            }
            if (b.show(2) == 2) break;
        }
        b.skip(2);
        return;
    }
    // mpeg2_decode_block_intra
    const uint16_t* qm = n < 4 ? intra_q_ : chroma_intra_q_;
    blk[0] = static_cast<int16_t>(last_dc_[component] * (1 << (3 - dc_prec_)));
    int mismatch = blk[0] ^ 1;
    const Lut& lut = ivf_ ? lut_b15() : lut_b14();
    int i = 0;
    for (;;) {
        const int sym = lut.read(b, "DCT coefficient");
        if (sym == kEob) break;
        int level;
        if (sym == kEscape) {
            i += static_cast<int>(b.get(6)) + 1;
            level = b.sget(12);
            features_ |= F_ESCAPE;
            if (i > 63) fail(CORRUPT, "a block's coefficients run past 64");
            const int j = scan[i];
            level = level < 0 ? -((-level * qscale_ * qm[j]) >> 4) : (level * qscale_ * qm[j]) >> 4;
            mismatch ^= level;
            blk[j] = static_cast<int16_t>(level);
        } else {
            i += rl.run[sym] + 1;
            if (i > 63) fail(CORRUPT, "a block's coefficients run past 64");
            const int j = scan[i];
            level = (rl.level[sym] * qscale_ * qm[j]) >> 4;
            if (b.get1()) level = -level;
            mismatch ^= level;
            blk[j] = static_cast<int16_t>(level);
        }
    }
    blk[63] = static_cast<int16_t>(blk[63] ^ (mismatch & 1));
}

void Decoder::block_inter(Bits& b, int16_t* blk, int n) {
    const uint16_t* qm = (mpeg2_ && n >= 4) ? chroma_inter_q_ : inter_q_;
    const int* scan = alt_ ? kAlternate : kZigzag;
    const RunLevel& rl = run_level();
    int i = -1, mismatch = 1;
    if (b.show(1)) {  // the first coefficient's short code, '1s': run 0, level 1
        int level = (3 * qscale_ * qm[0]) >> 5;
        if (!mpeg2_) level = (level - 1) | 1;
        if (b.show(2) & 1) level = -level;
        blk[0] = static_cast<int16_t>(level);
        mismatch ^= level;
        i = 0;
        b.skip(2);
        if (b.show(2) == 2) {
            b.skip(2);
            if (mpeg2_) blk[63] = static_cast<int16_t>(blk[63] ^ (mismatch & 1));
            return;
        }
    }
    for (;;) {
        const int sym = lut_b14().read(b, "DCT coefficient");
        int level;
        if (sym == kEscape) {
            i += static_cast<int>(b.get(6)) + 1;
            features_ |= F_ESCAPE;
            if (mpeg2_) {
                level = b.sget(12);
            } else {
                level = b.sget(8);
                if (level == -128) level = static_cast<int>(b.get(8)) - 256;
                else if (level == 0) level = static_cast<int>(b.get(8));
            }
            if (i > 63) fail(CORRUPT, "a block's coefficients run past 64");
            const int j = scan[i];
            const int mag = level < 0 ? -level : level;
            int v = ((mag * 2 + 1) * qscale_ * qm[j]) >> 5;
            if (!mpeg2_) v = (v - 1) | 1;
            level = level < 0 ? -v : v;
        } else {
            if (sym == kEob) fail(CORRUPT, "an end of block where a coefficient belongs");
            i += rl.run[sym] + 1;
            if (i > 63) fail(CORRUPT, "a block's coefficients run past 64");
            const int j = scan[i];
            level = ((rl.level[sym] * 2 + 1) * qscale_ * qm[j]) >> 5;
            if (!mpeg2_) level = (level - 1) | 1;
            if (b.get1()) level = -level;
        }
        mismatch ^= level;
        blk[scan[i]] = static_cast<int16_t>(level);
        if (b.show(2) == 2) break;
    }
    b.skip(2);
    if (mpeg2_) blk[63] = static_cast<int16_t>(blk[63] ^ (mismatch & 1));
}

// put_pixels_tab / avg_pixels_tab: a w x h half-pel block, rounded up, put
// or averaged into dst (rounded up)
void hpel(const uint8_t* src, size_t sstride, uint8_t* dst, size_t dstride, int w, int h, int dxy,
          bool avg) {
    for (int y = 0; y < h; ++y) {
        const uint8_t* s0 = src + y * sstride;
        const uint8_t* s1 = s0 + sstride;
        uint8_t* o = dst + y * dstride;
        for (int x = 0; x < w; ++x) {
            int v;
            switch (dxy) {
                case 0: v = s0[x]; break;
                case 1: v = (s0[x] + s0[x + 1] + 1) >> 1; break;
                case 2: v = (s0[x] + s1[x] + 1) >> 1; break;
                default: v = (s0[x] + s0[x + 1] + s1[x] + s1[x + 1] + 2) >> 2;
            }
            o[x] = static_cast<uint8_t>(avg ? (o[x] + v + 1) >> 1 : v);
        }
    }
}

// mpeg_motion_internal (is_mpeg12): frame motion (field_based 0, 16 rows)
// or one field of field motion in a frame picture (8 rows of every other
// line, `bottom` the field written, `select` the field read)
void Decoder::predict(const Frame& ref, int field_based, int bottom, int select, int mx, int my,
                      bool avg) {
    const int h = 16 >> field_based;
    const int h_edge = mbw_ * 16, v_edge = (mbh_ * 16) >> field_based;
    const int dxy = ((my & 1) << 1) | (mx & 1);
    const int src_x = mb_x_ * 16 + (mx >> 1);
    const int src_y = (mb_y_ << (4 - field_based)) + (my >> 1);
    const int cmx = mx / 2, cmy = my / 2;
    const int uvdxy = ((cmy & 1) << 1) | (cmx & 1);
    const int uvsrc_x = mb_x_ * 8 + (cmx >> 1);
    const int uvsrc_y = (mb_y_ << (3 - field_based)) + (cmy >> 1);
    if (unsigned(src_x) >= unsigned(std::max(h_edge - (mx & 1) - 15, 0)) ||
        unsigned(src_y) >= unsigned(std::max(v_edge - (my & 1) - h + 1, 0)))
        fail(CORRUPT, "a motion vector reading past the picture (FFmpeg leaves the block "
                      "unpredicted)");
    // the chroma block stays inside too (it follows from the luma bounds;
    // checked so that no read can leave the planes)
    if (uvsrc_x < 0 || uvsrc_y < 0 || uvsrc_x + 8 + (cmx & 1) > h_edge / 2 ||
        uvsrc_y + (h >> 1) + (cmy & 1) > v_edge / 2)
        fail(CORRUPT, "a chroma motion vector reading past the picture");
    if (dxy) features_ |= F_HALF_PEL;
    Frame& cur = *cur_;
    const size_t ls = ref[0].stride, uvls = ref[1].stride;
    const size_t lsf = ls << field_based, uvlsf = uvls << field_based;
    const uint8_t* py = &ref[0].px[size_t(src_y) * lsf + size_t(src_x) + (select ? ls : 0)];
    uint8_t* dy = &cur[0].px[size_t(mb_y_) * 16 * ls + size_t(mb_x_) * 16 + (bottom ? ls : 0)];
    hpel(py, lsf, dy, lsf, 16, h, dxy, avg);
    for (int c = 1; c < 3; ++c) {
        const uint8_t* pc =
            &ref[c].px[size_t(uvsrc_y) * uvlsf + size_t(uvsrc_x) + (select ? uvls : 0)];
        uint8_t* dc = &cur[c].px[size_t(mb_y_) * 8 * uvls + size_t(mb_x_) * 8 + (bottom ? uvls : 0)];
        hpel(pc, uvlsf, dc, uvlsf, 8, h >> 1, uvdxy, avg);
    }
}

void Decoder::reconstruct(int16_t (*blocks)[64], const bool* coded, bool intra) {
    Frame& cur = *cur_;
    const size_t ls = cur[0].stride, uvls = cur[1].stride;
    uint8_t* dy = &cur[0].px[size_t(mb_y_) * 16 * ls + size_t(mb_x_) * 16];
    uint8_t* dcb = &cur[1].px[size_t(mb_y_) * 8 * uvls + size_t(mb_x_) * 8];
    uint8_t* dcr = &cur[2].px[size_t(mb_y_) * 8 * uvls + size_t(mb_x_) * 8];
    const size_t dct_ls = ls << interlaced_dct_;
    const size_t dct_off = interlaced_dct_ ? ls : ls * 8;
    uint8_t* dst[6] = {dy, dy + 8, dy + dct_off, dy + dct_off + 8, dcb, dcr};
    const size_t stride[6] = {dct_ls, dct_ls, dct_ls, dct_ls, uvls, uvls};
    if (intra) {
        for (int i = 0; i < 6; ++i) fmvfi_ff::simple_idct_put(blocks[i], dst[i], stride[i]);
        return;
    }
    bool avg = false;
    for (int dir = 0; dir < 2; ++dir) {
        if (!(mv_dir_ & (MB_FWD << dir))) continue;
        const Frame& ref = dir == 0 ? *last_ : *next_;
        if (mv_field_) {
            predict(ref, 1, 0, field_select_[dir][0], mv_[dir][0][0], mv_[dir][0][1], avg);
            predict(ref, 1, 1, field_select_[dir][1], mv_[dir][1][0], mv_[dir][1][1], avg);
        } else {
            predict(ref, 0, 0, 0, mv_[dir][0][0], mv_[dir][0][1], avg);
        }
        avg = true;
    }
    for (int i = 0; i < 6; ++i)
        if (coded[i]) fmvfi_ff::simple_idct_add(blocks[i], dst[i], stride[i]);
    last_dc_[0] = last_dc_[1] = last_dc_[2] = 128 << dc_prec_;
}

}  // namespace fmvfi_mpeg12

using namespace fmvfi_mpeg12;

namespace {

void fill_info(const Decoder* dec, bool ready, int32_t* info) {
    info[0] = ready;
    info[1] = dec->width();
    info[2] = dec->height();
    info[3] = dec->decoded_type();
    info[4] = dec->mpeg2();
    info[5] = static_cast<int32_t>(dec->features());
    info[6] = dec->dc_precision() + 8;
}

}  // namespace

extern "C" {

void* fmvfi_mpeg12_open(const uint8_t* config, int64_t n, char* msg, int32_t msglen,
                        int32_t* code) {
    Decoder* dec = nullptr;
    try {
        dec = new Decoder();
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

int32_t fmvfi_mpeg12_decode(void* handle, const uint8_t* data, int64_t n, int32_t* info, char* msg,
                            int32_t msglen) {
    Decoder* dec = static_cast<Decoder*>(handle);
    try {
        fill_info(dec, dec->decode(data, static_cast<size_t>(n)), info);
        return OK;
    } catch (const Error& e) {
        return fmvfi_jpeg::report(e, msg, msglen);
    } catch (const std::bad_alloc&) {
        return fmvfi_jpeg::report(Error{CORRUPT, "out of memory"}, msg, msglen);
    }
}

int32_t fmvfi_mpeg12_flush(void* handle, int32_t* info) {
    Decoder* dec = static_cast<Decoder*>(handle);
    fill_info(dec, dec->flush(), info);
    return OK;
}

void fmvfi_mpeg12_frame(void* handle, uint8_t* out) {
    static_cast<Decoder*>(handle)->frame_rgb(out);
}

void fmvfi_mpeg12_close(void* handle) { delete static_cast<Decoder*>(handle); }

}  // extern "C"
