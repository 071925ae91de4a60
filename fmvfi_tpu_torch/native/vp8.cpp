// fmvfi_tpu_torch native host runtime: VP8 video decoded as cv2.VideoCapture
// decodes it, for fmvfi_tpu_torch/utils/mkv.py (Matroska and WebM files).
//
// cv2's video backend is FFmpeg: its vp8 decoder (bit-exact to libvpx, the
// RFC 6386 reference) turns each frame into a yuv420p picture whose planes
// are whole macroblocks, and OpenCV converts the frame's visible part to
// BGR24 with swscale (limited range, BT.601; ffmpeg_common.h's yuv_to_rgb).
// This file repeats the decoder, bit for bit:
//   - the frame tag and key frame header (the scale bits are ignored and the
//     frame decoded at its coded size, as FFmpeg does; a frame with
//     show_frame 0 is decoded into the references and yields no picture);
//   - FFmpeg's range decoder (vpx_rac: 16-bit refills, zeros past the end,
//     a partition read more than ten macroblocks past its end is an error);
//   - the first partition: segmentation (map and feature data, absolute or
//     delta), the normal or simple loop filter with its level, sharpness and
//     reference / mode deltas, 1, 2, 4 or 8 token partitions, the quantiser
//     indices and deltas, golden and alt-ref refresh, copy and sign bias,
//     refresh_entropy_probs (the probabilities restored after a frame that
//     clears it), the token, intra mode and MV probability updates;
//   - per macroblock: the segment id (kept from the previous frame when the
//     map is not updated), the skip flag, key frame modes with the
//     contextual sub-block probabilities, inter frame intra modes, reference
//     frame, the near / nearest / best MV search with sign bias and FFmpeg's
//     clamping, NEWMV, and split MVs (16x8, 8x16, 8x8, 4x4) with their
//     left / above contexts;
//   - tokens in each partition with the band / context probabilities, the
//     DCT extra bits, dequantisation (FFmpeg's qmat: Y2 AC * 155 / 100 at
//     least 8, UV DC at most 132) stored in 16 bits, the inverse WHT and
//     the 4x4 inverse DCT;
//   - intra prediction from the unfiltered reconstruction with VP8's edges
//     (127 above the frame, 129 left of it, the above-right of a sub-block
//     on the macroblock's right column taken from the macroblock row above,
//     repeated at the frame's right edge);
//   - inter prediction: six-tap (version 0) or bilinear (versions 1-3, and
//     FFmpeg's reading of the undefined 4-7) filters, full-pixel chroma
//     (version 3), over the reference's
//     macroblock-aligned planes with their edges repeated; split chroma
//     vectors rounded as FFmpeg rounds them;
//   - the loop filter after the frame, macroblock by macroblock: normal
//     (luma and chroma, macroblock edges with the 6-tap adjustment, inner
//     edges unless the macroblock has no coefficients and is neither B_PRED
//     nor split) or simple (luma only), with FFmpeg's clamps and HEV
//     thresholds;
//   - the reference update: golden and alt-ref copies from the frames
//     before this one, then refreshes, then last.
// In libwebp's mode (cv2.imread's lossy WebP, set_libwebp) the key frame's
// planes follow libwebp's VP8 decoder at the data's ends instead: the last
// token partition runs to the end of the data libwebp is given (the file
// past the chunk), the first partition and the others end at their sizes
// (a size past the data cut to it), and a decision that needs a bit past a
// partition's end (VP8LoadFinalBytes: one byte of zeros, then eof_) fails
// the frame, as "Premature end-of-file encountered" (a token partition) or
// "Premature end-of-partition0 encountered" fail it there; so do an inter
// or hidden frame, a version past 3, a first partition as long as the
// chunk or past the data, and the partition sizes of ParsePartitions (their
// table past the data, an empty last partition).
// The colour space bit (reserved) and the clamping type bit set are refused
// as unsupported (the caller names ROADMAP item 18.4): no stream from a
// VP8 encoder cv2 can read here sets them, so no fixture pins FFmpeg's
// output for them.  Malformed data is an error (CORRUPT).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <new>
#include <string>
#include <vector>

#include "ffmpeg_common.h"
#include "jpeg_common.h"
#include "vpx_rac.h"

namespace {

using fmvfi_jpeg::CORRUPT;
using fmvfi_jpeg::Error;
using fmvfi_jpeg::fail;
using fmvfi_jpeg::OK;
using fmvfi_jpeg::UNSUPPORTED;
using fmvfi_vpx::RangeCoder;

// The probability tables, copied from libvpx (cv2's bundled libvpx, found by
// byte search: vp8_kf_bmode_prob, vp8_default_coef_probs,
// vp8_coef_update_probs, vp8_default_mv_context, vp8_mv_update_probs,
// dc_qlookup, ac_qlookup, vp8_mode_contexts), in libvpx's sub-block mode
// order (B_DC, B_TM, B_VE, B_HE, B_LD, B_RD, B_VR, B_VL, B_HD, B_HU).
static const uint8_t KF_BMODE_PROBS[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};
static const uint8_t DEFAULT_COEF_PROBS[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
static const uint8_t COEF_UPDATE_PROBS[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
static const uint8_t DEFAULT_MV_PROBS[2][19] = {
    162, 128, 225, 146, 172, 147, 214, 39, 156, 128, 129, 132, 75, 145, 178, 206, 239, 254, 254,
    164, 128, 204, 170, 119, 235, 140, 230, 228, 128, 130, 130, 74, 148, 180, 203, 236, 254, 254,
};
static const uint8_t MV_UPDATE_PROBS[2][19] = {
    237, 246, 253, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 250, 250, 252, 254, 254,
    231, 243, 245, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 251, 251, 254, 254, 254,
};
static const int16_t DC_QLOOKUP[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
static const int16_t AC_QLOOKUP[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
static const uint8_t MODE_CONTEXTS[6][4] = {
    7, 1, 1, 143,
    14, 18, 14, 107,
    135, 64, 57, 68,
    60, 56, 128, 65,
    159, 134, 128, 34,
    234, 188, 128, 28,
};

const uint8_t COEF_BANDS[16] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7};
const uint8_t ZIGZAG[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t CAT3_PROBS[] = {173, 148, 140, 0};
const uint8_t CAT4_PROBS[] = {176, 155, 140, 135, 0};
const uint8_t CAT5_PROBS[] = {180, 157, 141, 134, 130, 0};
const uint8_t CAT6_PROBS[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const CAT_PROBS[4] = {CAT3_PROBS, CAT4_PROBS, CAT5_PROBS, CAT6_PROBS};

const uint8_t KF_YMODE_PROBS[4] = {145, 156, 163, 128};
const uint8_t KF_UV_MODE_PROBS[3] = {142, 114, 183};
const uint8_t YMODE_PROBS[4] = {112, 86, 140, 37};
const uint8_t UV_MODE_PROBS[3] = {162, 101, 204};
const uint8_t BMODE_PROBS[9] = {120, 90, 79, 133, 87, 85, 80, 111, 151};
const uint8_t SUBMV_PROBS[5][3] = {
    {147, 136, 18}, {106, 145, 1}, {179, 121, 1}, {223, 1, 34}, {208, 1, 1}};
const uint8_t MBSPLIT_PROBS[3] = {110, 111, 150};
// the partition of each sub-block under 16x8, 8x16, 8x8 and 4x4 splits
const uint8_t MBSPLITS[4][16] = {
    {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1},
    {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1},
    {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}};
const uint8_t MBSPLIT_COUNT[4] = {2, 2, 4, 16};
const int16_t SUBPEL_FILTERS[8][6] = {
    {0, 0, 128, 0, 0, 0},      {0, -6, 123, 12, -1, 0}, {2, -11, 108, 36, -8, 1},
    {0, -9, 93, 50, -6, 0},    {3, -16, 77, 77, -16, 3}, {0, -6, 50, 93, -9, 0},
    {1, -8, 36, 108, -11, 2},  {0, -1, 12, 123, -6, 0}};

enum Mode { DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED, ZEROMV, NEARESTMV, NEARMV, NEWMV, SPLITMV };
enum BMode { B_DC, B_TM, B_VE, B_HE, B_LD, B_RD, B_VR, B_VL, B_HD, B_HU };
enum Ref { INTRA = 0, LAST = 1, GOLDEN = 2, ALTREF = 3 };
enum Split { SPLIT_16x8, SPLIT_8x16, SPLIT_8x8, SPLIT_4x4, SPLIT_NONE };

// the feature bits fmvfi_vp8_decode reports, so that tests can show which
// parts of the decoder a stream reaches
enum Feature {
    F_SEGMENTATION = 1, F_SEGMENT_MAP = 2, F_KEEP_PROBS = 4, F_GOLDEN = 8, F_ALTREF = 16,
    F_SIGN_BIAS = 32, F_SPLITMV = 64, F_LF_DELTAS = 128, F_SIMPLE_FILTER = 256,
    F_INTRA_IN_INTER = 512, F_BPRED_IN_INTER = 1024, F_GOLDEN_ALTREF_REFS = 2048,
};

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }
inline int clip_int8(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }
inline int clip_uint7(int v) { return v < 0 ? 0 : (v > 127 ? 127 : v); }
inline int clip_uint6(int v) { return v < 0 ? 0 : (v > 63 ? 63 : v); }

struct Probs {
    uint8_t segment[3] = {255, 255, 255};
    uint8_t ymode[4], uvmode[3];
    uint8_t token[4][8][3][11];
    uint8_t mv[2][19];
};

struct MV {
    int16_t y = 0, x = 0;
    bool operator==(const MV& o) const { return y == o.y && x == o.x; }
    bool operator!=(const MV& o) const { return !(*this == o); }
    bool zero() const { return !y && !x; }
};

struct MB {
    uint8_t mode = DC_PRED, uvmode = DC_PRED, ref = INTRA, split = SPLIT_NONE, segment = 0, skip = 0;
    uint8_t bmodes[16] = {};  // B_DC everywhere outside the frame
    MV mv;
    MV bmv[16];  // each sub-block's vector (all mv when not split)
    // the loop filter's parameters
    uint8_t filter_level = 0, inner_limit = 0, inner_filter = 0;
};

// a picture's planes: whole macroblocks, fmvfi_ff::Plane's w and h the
// visible size
struct Picture {
    fmvfi_ff::Plane p[3];
};

class Decoder {
  public:
    bool decode(const uint8_t* data, size_t n, const uint8_t* after = nullptr, size_t n_after = 0);
    void set_libwebp(bool on) { libwebp_ = on; }
    int width() const { return width_; }
    int height() const { return height_; }
    int keyframe() const { return keyframe_; }
    int version() const { return version_; }
    int partitions() const { return num_partitions_; }
    int features() const { return features_; }
    void frame_rgb(uint8_t* out) const;
    void frame_planes(uint8_t* y, uint8_t* u, uint8_t* v) const;

  private:
    void parse_header(const uint8_t* buf, size_t n, size_t n_data);
    void setup_dimensions(int w, int h);
    void compute_quants();
    void decode_modes(MB& mb, int mx, int my);
    void decode_mvs(MB& mb, int mx, int my);
    void decode_splitmvs(MB& mb, int mx, int my);
    int read_mv_component(const uint8_t* p);
    void clamp_mv(MV& dst, const MV& src, int mx, int my) const;
    void decode_coeffs(MB& mb, RangeCoder& c, uint8_t* t_nnz, uint8_t* l_nnz);
    void intra_predict(const MB& mb, int mx, int my);
    void inter_predict(const MB& mb, int mx, int my);
    void mc(uint8_t* dst, int dstride, const fmvfi_ff::Plane& ref, int pw, int ph, int x, int y,
            int fx, int fy, int bw, int bh) const;
    void add_residual(const MB& mb, int mx, int my, bool luma);
    void filter_params(MB& mb) const;
    void loop_filter();
    MB& mb_at(int mx, int my) { return mbs_[size_t(my + 1) * (mbw_ + 1) + mx + 1]; }

    std::vector<uint8_t> data_;  // the packet, zero-padded
    bool libwebp_ = false;
    RangeCoder c_;
    RangeCoder parts_[8];
    int num_partitions_ = 1;
    bool have_key_ = false;
    int width_ = 0, height_ = 0, mbw_ = 0, mbh_ = 0;
    int keyframe_ = 0, version_ = 0, show_ = 1, features_ = 0;

    Probs prob_, saved_;
    bool keep_probs_ = false;  // refresh_entropy_probs 0
    int prob_skip_ = 0, prob_intra_ = 0, prob_last_ = 0, prob_golden_ = 0;
    bool skip_enabled_ = false;

    // segmentation
    bool seg_enabled_ = false, seg_update_map_ = false, seg_absolute_ = false;
    int seg_quant_[4] = {}, seg_filter_[4] = {};
    std::vector<uint8_t> seg_map_;

    // loop filter
    bool simple_ = false;
    int filter_level_ = 0, sharpness_ = 0;
    bool lf_delta_enabled_ = false;
    int lf_ref_[4] = {}, lf_mode_[4] = {};

    // quantisers
    int yac_qi_ = 0, ydc_delta_ = 0, y2dc_delta_ = 0, y2ac_delta_ = 0, uvdc_delta_ = 0,
        uvac_delta_ = 0;
    int16_t qmul_[4][3][2] = {};  // segment, (Y, Y2, UV), (DC, AC)

    // references: the update each buffer takes (-1: none, else the Ref
    // whose picture it copies, INTRA meaning the new one)
    int update_golden_ = -1, update_altref_ = -1;
    bool update_last_ = true;
    int sign_bias_[4] = {};
    std::shared_ptr<Picture> ref_[4];  // [LAST..ALTREF]; [INTRA] unused
    std::shared_ptr<Picture> cur_;

    std::vector<MB> mbs_;  // (mbh + 1) x (mbw + 1), the first row and column outside the frame
    std::vector<uint8_t> top_nnz_;  // 9 per macroblock column
    int16_t coef_[25][16];
};

void Decoder::setup_dimensions(int w, int h) {
    if (w <= 0 || h <= 0) fail(CORRUPT, "a key frame of " + std::to_string(w) + "x" +
                                            std::to_string(h));
    width_ = w;
    height_ = h;
    mbw_ = (w + 15) / 16;
    mbh_ = (h + 15) / 16;
    mbs_.assign(size_t(mbw_ + 1) * (mbh_ + 1), MB());
    seg_map_.assign(size_t(mbw_) * mbh_, 0);
    for (auto& r : ref_) r.reset();
}

void Decoder::compute_quants() {
    for (int i = 0; i < 4; ++i) {
        int base = yac_qi_;
        if (seg_enabled_) {
            base = seg_quant_[i];
            if (!seg_absolute_) base += yac_qi_;
        }
        int16_t(*q)[2] = qmul_[i];
        q[0][0] = DC_QLOOKUP[clip_uint7(base + ydc_delta_)];
        q[0][1] = AC_QLOOKUP[clip_uint7(base)];
        q[1][0] = static_cast<int16_t>(DC_QLOOKUP[clip_uint7(base + y2dc_delta_)] * 2);
        q[1][1] = static_cast<int16_t>(
            std::max(AC_QLOOKUP[clip_uint7(base + y2ac_delta_)] * 101581 >> 16, 8));
        q[2][0] = static_cast<int16_t>(std::min<int>(DC_QLOOKUP[clip_uint7(base + uvdc_delta_)], 132));
        q[2][1] = AC_QLOOKUP[clip_uint7(base + uvac_delta_)];
    }
}

// n: the frame's bytes; n_data: the bytes the last token partition may run
// to (n, or in libwebp's mode the data after the chunk too)
void Decoder::parse_header(const uint8_t* buf, size_t n, size_t n_data) {
    if (n < 3) fail(CORRUPT, "a VP8 frame of " + std::to_string(n) + " bytes");
    keyframe_ = !(buf[0] & 1);
    version_ = (buf[0] >> 1) & 7;
    show_ = (buf[0] >> 4) & 1;
    const size_t header_size = (buf[0] | buf[1] << 8 | size_t(buf[2]) << 16) >> 5;
    if (libwebp_) {  // VP8GetInfo's and VP8GetHeaders' checks
        if (!keyframe_) fail(CORRUPT, "libwebp decodes key frames only");
        if (version_ > 3) fail(CORRUPT, "a VP8 version past 3 (libwebp: incorrect keyframe parameters)");
        if (!show_) fail(CORRUPT, "a hidden VP8 frame (libwebp: frame not displayable)");
        if (header_size >= n) fail(CORRUPT, "a first partition as long as its VP8 chunk");
        if (n < 10 || header_size > n_data - 10) fail(CORRUPT, "a first partition past the data");
        n = n_data;  // the partitions read on to the data's end
    }
    buf += 3;
    n -= 3;
    features_ = 0;
    if (header_size + (keyframe_ ? 7 : 0) > n) fail(CORRUPT, "a frame header larger than its data");
    if (keyframe_) {
        if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a)
            fail(CORRUPT, "a key frame without its start code");
        const int w = (buf[3] | buf[4] << 8) & 0x3fff, h = (buf[5] | buf[6] << 8) & 0x3fff;
        buf += 7;
        n -= 7;
        have_key_ = false;  // until this key frame has decoded: its references replace all
        if (w != width_ || h != height_ || mbs_.empty()) setup_dimensions(w, h);
        update_golden_ = update_altref_ = INTRA;
        std::memcpy(prob_.token, DEFAULT_COEF_PROBS, sizeof(prob_.token));
        std::memcpy(prob_.ymode, YMODE_PROBS, sizeof(prob_.ymode));
        std::memcpy(prob_.uvmode, UV_MODE_PROBS, sizeof(prob_.uvmode));
        std::memcpy(prob_.mv, DEFAULT_MV_PROBS, sizeof(prob_.mv));
        seg_enabled_ = seg_update_map_ = seg_absolute_ = false;
        std::fill(seg_quant_, seg_quant_ + 4, 0);
        std::fill(seg_filter_, seg_filter_ + 4, 0);
        lf_delta_enabled_ = false;
        std::fill(lf_ref_, lf_ref_ + 4, 0);
        std::fill(lf_mode_, lf_mode_ + 4, 0);
    } else if (!have_key_) {
        fail(CORRUPT, "an inter frame without a decoded key frame before it");
    }
    c_.init(buf, static_cast<int>(header_size), libwebp_);
    const uint8_t* parts = buf + header_size;
    size_t left = n - header_size;

    if (keyframe_) {
        if (c_.bit()) fail(UNSUPPORTED, "a VP8 key frame with the reserved colour space bit set");
        if (c_.bit()) fail(UNSUPPORTED, "a VP8 key frame with clamping_type 1 (no clamping)");
    }
    seg_enabled_ = c_.bit();
    if (seg_enabled_) {
        features_ |= F_SEGMENTATION;
        seg_update_map_ = c_.bit();
        const bool update_data = c_.bit();
        if (update_data) {
            seg_absolute_ = c_.bit();
            for (int i = 0; i < 4; ++i) seg_quant_[i] = c_.sint(7);
            for (int i = 0; i < 4; ++i) seg_filter_[i] = c_.sint(6);
        }
        if (seg_update_map_) {
            features_ |= F_SEGMENT_MAP;
            for (int i = 0; i < 3; ++i) prob_.segment[i] = c_.bit() ? c_.uint(8) : 255;
        }
    } else {
        seg_update_map_ = false;
    }
    if (libwebp_ && c_.past_end()) fail(CORRUPT, "the segment header past the first partition");
    simple_ = c_.bit();
    if (simple_) features_ |= F_SIMPLE_FILTER;
    filter_level_ = c_.uint(6);
    sharpness_ = c_.uint(3);
    lf_delta_enabled_ = c_.bit();
    if (lf_delta_enabled_) {
        features_ |= F_LF_DELTAS;
        if (c_.bit()) {
            for (int i = 0; i < 4; ++i)
                if (c_.bit()) {
                    lf_ref_[i] = c_.uint(6);
                    if (c_.bit()) lf_ref_[i] = -lf_ref_[i];
                }
            for (int i = 0; i < 4; ++i)
                if (c_.bit()) {
                    lf_mode_[i] = c_.uint(6);
                    if (c_.bit()) lf_mode_[i] = -lf_mode_[i];
                }
        }
    }
    if (libwebp_ && c_.past_end()) fail(CORRUPT, "the filter header past the first partition");
    // the token partitions: the sizes of all but the last, 3 bytes each
    num_partitions_ = 1 << c_.uint(2);
    const size_t table = 3 * size_t(num_partitions_ - 1);
    if (left < table) fail(CORRUPT, "token partition sizes past the frame's end");
    const uint8_t* sizes = parts;
    parts += table;
    left -= table;
    for (int i = 0; i < num_partitions_ - 1; ++i) {
        size_t size = sizes[3 * i] | sizes[3 * i + 1] << 8 | size_t(sizes[3 * i + 2]) << 16;
        if (size > left) {
            if (!libwebp_) fail(CORRUPT, "a token partition past the frame's end");
            size = left;  // libwebp cuts it to the data
        }
        parts_[i].init(parts, static_cast<int>(size), libwebp_);
        parts += size;
        left -= size;
    }
    if (libwebp_ && !left) fail(CORRUPT, "an empty last token partition");
    parts_[num_partitions_ - 1].init(parts, static_cast<int>(left));

    yac_qi_ = c_.uint(7);
    ydc_delta_ = c_.sint(4);
    y2dc_delta_ = c_.sint(4);
    y2ac_delta_ = c_.sint(4);
    uvdc_delta_ = c_.sint(4);
    uvac_delta_ = c_.sint(4);
    compute_quants();

    if (!keyframe_) {
        const int refresh_golden = c_.bit(), refresh_altref = c_.bit();
        auto copy = [&](int refresh, int self) {
            if (refresh) return int(INTRA);
            switch (c_.uint(2)) {
                case 1: return int(LAST);
                case 2: return self == GOLDEN ? int(ALTREF) : int(GOLDEN);
                default: return -1;
            }
        };
        update_golden_ = copy(refresh_golden, GOLDEN);
        update_altref_ = copy(refresh_altref, ALTREF);
        if (update_golden_ >= 0) features_ |= F_GOLDEN;
        if (update_altref_ >= 0) features_ |= F_ALTREF;
        sign_bias_[GOLDEN] = c_.bit();
        sign_bias_[ALTREF] = c_.bit();
        if (sign_bias_[GOLDEN] || sign_bias_[ALTREF]) features_ |= F_SIGN_BIAS;
    }
    keep_probs_ = !c_.bit();
    if (keep_probs_) {
        features_ |= F_KEEP_PROBS;
        saved_ = prob_;
    }
    update_last_ = keyframe_ || c_.bit();
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 8; ++j)
            for (int k = 0; k < 3; ++k)
                for (int l = 0; l < 11; ++l)
                    if (c_.get(COEF_UPDATE_PROBS[i][j][k][l]))
                        prob_.token[i][j][k][l] = static_cast<uint8_t>(c_.uint(8));
    skip_enabled_ = c_.bit();
    if (skip_enabled_) prob_skip_ = c_.uint(8);
    if (!keyframe_) {
        prob_intra_ = c_.uint(8);
        prob_last_ = c_.uint(8);
        prob_golden_ = c_.uint(8);
        if (c_.bit())
            for (int i = 0; i < 4; ++i) prob_.ymode[i] = static_cast<uint8_t>(c_.uint(8));
        if (c_.bit())
            for (int i = 0; i < 3; ++i) prob_.uvmode[i] = static_cast<uint8_t>(c_.uint(8));
        for (int i = 0; i < 2; ++i)
            for (int j = 0; j < 19; ++j)
                if (c_.get(MV_UPDATE_PROBS[i][j])) {
                    const int v = c_.uint(7) << 1;
                    prob_.mv[i][j] = static_cast<uint8_t>(v ? v : 1);
                }
    }
}

// the sub-block modes a 16x16 mode implies for its neighbours' contexts
const uint8_t IMPLIED_BMODE[4] = {B_DC, B_VE, B_HE, B_TM};

void Decoder::decode_modes(MB& mb, int mx, int my) {
    RangeCoder& c = c_;
    uint8_t& seg = seg_map_[size_t(my) * mbw_ + mx];
    if (seg_update_map_) {
        const int b = c.get(prob_.segment[0]);
        seg = static_cast<uint8_t>(c.get(prob_.segment[1 + b]) + 2 * b);
    }
    mb.segment = seg;
    mb.skip = skip_enabled_ ? static_cast<uint8_t>(c.get(prob_skip_)) : 0;
    mb.split = SPLIT_NONE;
    if (keyframe_) {
        mb.ref = INTRA;
        if (!c.get(KF_YMODE_PROBS[0])) {
            mb.mode = B_PRED;
        } else if (!c.get(KF_YMODE_PROBS[1])) {
            mb.mode = c.get(KF_YMODE_PROBS[2]) ? V_PRED : DC_PRED;
        } else {
            mb.mode = c.get(KF_YMODE_PROBS[3]) ? TM_PRED : H_PRED;
        }
        const MB& above = mb_at(mx, my - 1);
        const MB& left = mb_at(mx - 1, my);
        for (int k = 0; k < 16; ++k) {
            if (mb.mode != B_PRED) {
                mb.bmodes[k] = IMPLIED_BMODE[mb.mode];
                continue;
            }
            const int a = k < 4 ? above.bmodes[k + 12] : mb.bmodes[k - 4];
            const int l = (k & 3) ? mb.bmodes[k - 1] : left.bmodes[k + 3];
            const uint8_t* p = KF_BMODE_PROBS[a][l];
            int m;
            if (!c.get(p[0])) m = B_DC;
            else if (!c.get(p[1])) m = B_TM;
            else if (!c.get(p[2])) m = B_VE;
            else if (!c.get(p[3])) m = !c.get(p[4]) ? B_HE : (c.get(p[5]) ? B_VR : B_RD);
            else if (!c.get(p[6])) m = B_LD;
            else if (!c.get(p[7])) m = B_VL;
            else m = c.get(p[8]) ? B_HU : B_HD;
            mb.bmodes[k] = static_cast<uint8_t>(m);
        }
        const uint8_t* q = KF_UV_MODE_PROBS;
        mb.uvmode = !c.get(q[0]) ? DC_PRED : (!c.get(q[1]) ? V_PRED : (c.get(q[2]) ? TM_PRED : H_PRED));
        mb.mv = MV();
        for (auto& v : mb.bmv) v = MV();
        return;
    }
    if (c.get(prob_intra_)) {  // an inter macroblock
        mb.ref = !c.get(prob_last_) ? LAST : (c.get(prob_golden_) ? ALTREF : GOLDEN);
        if (mb.ref != LAST) features_ |= F_GOLDEN_ALTREF_REFS;
        decode_mvs(mb, mx, my);
        return;
    }
    features_ |= F_INTRA_IN_INTER;
    mb.ref = INTRA;
    const uint8_t* p = prob_.ymode;
    if (!c.get(p[0])) mb.mode = DC_PRED;
    else if (!c.get(p[1])) mb.mode = c.get(p[2]) ? H_PRED : V_PRED;
    else mb.mode = c.get(p[3]) ? B_PRED : TM_PRED;
    if (mb.mode == B_PRED) {
        features_ |= F_BPRED_IN_INTER;
        for (int k = 0; k < 16; ++k) {
            const uint8_t* b = BMODE_PROBS;
            int m;
            if (!c.get(b[0])) m = B_DC;
            else if (!c.get(b[1])) m = B_TM;
            else if (!c.get(b[2])) m = B_VE;
            else if (!c.get(b[3])) m = !c.get(b[4]) ? B_HE : (c.get(b[5]) ? B_VR : B_RD);
            else if (!c.get(b[6])) m = B_LD;
            else if (!c.get(b[7])) m = B_VL;
            else m = c.get(b[8]) ? B_HU : B_HD;
            mb.bmodes[k] = static_cast<uint8_t>(m);
        }
    }
    const uint8_t* q = prob_.uvmode;
    mb.uvmode = !c.get(q[0]) ? DC_PRED : (!c.get(q[1]) ? V_PRED : (c.get(q[2]) ? TM_PRED : H_PRED));
    mb.mv = MV();
    for (auto& v : mb.bmv) v = MV();
}

// FFmpeg's clamp_mv: within 16 pixels (plus the quarter-pel margin) of
// the frame's macroblock-aligned edges
void Decoder::clamp_mv(MV& dst, const MV& src, int mx, int my) const {
    const int margin = 16 << 2;
    const int min_x = -margin - 64 * mx, max_x = ((mbw_ - 1) << 6) + margin - 64 * mx;
    const int min_y = -margin - 64 * my, max_y = ((mbh_ - 1) << 6) + margin - 64 * my;
    auto clip16 = [](int v) { return std::max(-32768, std::min(32767, v)); };
    dst.x = static_cast<int16_t>(std::max(clip16(min_x), std::min<int>(clip16(max_x), src.x)));
    dst.y = static_cast<int16_t>(std::max(clip16(min_y), std::min<int>(clip16(max_y), src.y)));
}

int Decoder::read_mv_component(const uint8_t* p) {
    RangeCoder& c = c_;
    int x = 0;
    if (c.get(p[0])) {  // long form: bits 0-2, 9-4, then 3
        for (int i = 0; i < 3; ++i) x += c.get(p[9 + i]) << i;
        for (int i = 9; i > 3; --i) x += c.get(p[9 + i]) << i;
        if (!(x & 0xFFF0) || c.get(p[12])) x += 8;
    } else {  // the short tree
        const uint8_t* ps = p + 2;
        int bit = c.get(*ps);
        ps += 1 + 3 * bit;
        x += 4 * bit;
        bit = c.get(*ps);
        ps += 1 + bit;
        x += 2 * bit;
        x += c.get(*ps);
    }
    return (x && c.get(p[1])) ? -x : x;
}

void Decoder::decode_mvs(MB& mb, int mx, int my) {
    RangeCoder& c = c_;
    const MB* edge[3] = {&mb_at(mx, my - 1), &mb_at(mx - 1, my), &mb_at(mx - 1, my - 1)};
    enum { CNT_ZERO, CNT_NEAREST, CNT_NEAR, CNT_SPLITMV };
    MV near_mv[4];
    int cnt[4] = {0, 0, 0, 0};
    int idx = CNT_ZERO;
    const int cur_bias = sign_bias_[mb.ref];
    for (int n = 0; n < 3; ++n) {
        const MB& e = *edge[n];
        if (e.ref == INTRA) continue;
        if (!e.mv.zero()) {
            MV v = e.mv;
            if (cur_bias != sign_bias_[e.ref]) {
                v.x = static_cast<int16_t>(-v.x);
                v.y = static_cast<int16_t>(-v.y);
            }
            if (!n || v != near_mv[idx]) near_mv[++idx] = v;
            cnt[idx] += 1 + (n != 2);
        } else {
            cnt[CNT_ZERO] += 1 + (n != 2);
        }
    }
    mb.split = SPLIT_NONE;
    if (!c.get(MODE_CONTEXTS[cnt[CNT_ZERO]][0])) {
        mb.mode = ZEROMV;
        mb.mv = MV();
    } else {
        // three distinct vectors: merge the first and the last when equal
        if (cnt[CNT_SPLITMV] && near_mv[1] == near_mv[3]) cnt[CNT_NEAREST] += 1;
        if (cnt[CNT_NEAR] > cnt[CNT_NEAREST]) {
            std::swap(cnt[CNT_NEAREST], cnt[CNT_NEAR]);
            std::swap(near_mv[CNT_NEAREST], near_mv[CNT_NEAR]);
        }
        if (!c.get(MODE_CONTEXTS[cnt[CNT_NEAREST]][1])) {
            mb.mode = NEARESTMV;
            clamp_mv(mb.mv, near_mv[CNT_NEAREST], mx, my);
        } else if (!c.get(MODE_CONTEXTS[cnt[CNT_NEAR]][2])) {
            mb.mode = NEARMV;
            clamp_mv(mb.mv, near_mv[CNT_NEAR], mx, my);
        } else {
            clamp_mv(mb.mv, near_mv[CNT_ZERO + (cnt[CNT_NEAREST] >= cnt[CNT_ZERO])], mx, my);
            cnt[CNT_SPLITMV] = ((edge[1]->mode == SPLITMV) + (edge[0]->mode == SPLITMV)) * 2 +
                               (edge[2]->mode == SPLITMV);
            if (c.get(MODE_CONTEXTS[cnt[CNT_SPLITMV]][3])) {
                mb.mode = SPLITMV;
                features_ |= F_SPLITMV;
                decode_splitmvs(mb, mx, my);
                return;
            }
            mb.mode = NEWMV;
            mb.mv.y = static_cast<int16_t>(mb.mv.y + read_mv_component(prob_.mv[0]));
            mb.mv.x = static_cast<int16_t>(mb.mv.x + read_mv_component(prob_.mv[1]));
        }
    }
    for (auto& v : mb.bmv) v = mb.mv;
}

void Decoder::decode_splitmvs(MB& mb, int mx, int my) {
    RangeCoder& c = c_;
    const MB& left = mb_at(mx - 1, my);
    const MB& top = mb_at(mx, my - 1);
    int split;
    if (!c.get(MBSPLIT_PROBS[0])) split = SPLIT_4x4;
    else if (!c.get(MBSPLIT_PROBS[1])) split = SPLIT_8x8;
    else split = SPLIT_16x8 + c.get(MBSPLIT_PROBS[2]);
    mb.split = static_cast<uint8_t>(split);
    const uint8_t* parts = MBSPLITS[split];
    const int num = MBSPLIT_COUNT[split];
    MV pmv[16];
    for (int n = 0, k = 0; n < num; ++n) {
        while (parts[k] != n) ++k;  // the partition's first sub-block
        const MV l = (k & 3) ? pmv[parts[k - 1]] : left.bmv[k + 3];
        const MV a = k > 3 ? pmv[parts[k - 4]] : top.bmv[k + 12];
        const uint8_t* p;
        if (l == a) p = SUBMV_PROBS[l.zero() ? 4 : 3];
        else if (a.zero()) p = SUBMV_PROBS[2];
        else p = SUBMV_PROBS[l.zero() ? 1 : 0];
        if (!c.get(p[0])) {
            pmv[n] = l;
        } else if (!c.get(p[1])) {
            pmv[n] = a;
        } else if (!c.get(p[2])) {
            pmv[n] = MV();
        } else {
            pmv[n].y = static_cast<int16_t>(mb.mv.y + read_mv_component(prob_.mv[0]));
            pmv[n].x = static_cast<int16_t>(mb.mv.x + read_mv_component(prob_.mv[1]));
        }
    }
    for (int k = 0; k < 16; ++k) mb.bmv[k] = pmv[parts[k]];
    mb.mv = pmv[num - 1];
}

// one block's tokens (FFmpeg's decode_block_coeffs): the index past the
// last token, 0 when the block is empty
int decode_block(RangeCoder& c, int16_t* block, const uint8_t (*probs)[3][11], int i, int ctx,
                 const int16_t* qmul) {
    const uint8_t* p = probs[COEF_BANDS[i]][ctx];
    if (!c.get(p[0])) return 0;  // EOB
    while (true) {
        if (!c.get(p[1])) {  // DCT_0
            if (++i == 16) return 16;
            p = probs[COEF_BANDS[i]][0];
            continue;  // no EOB after a zero
        }
        int coeff;
        if (!c.get(p[2])) {
            coeff = 1;
            ctx = 1;
        } else {
            if (!c.get(p[3])) {
                coeff = c.get(p[4]);
                if (coeff) coeff += c.get(p[5]);
                coeff += 2;
            } else if (!c.get(p[6])) {
                if (!c.get(p[7])) {
                    coeff = 5 + c.get(159);
                } else {
                    coeff = 7 + (c.get(165) << 1);
                    coeff += c.get(145);
                }
            } else {
                const int a = c.get(p[8]);
                const int b = c.get(p[9 + a]);
                const int cat = (a << 1) + b;
                coeff = 3 + (8 << cat);
                int v = 0;
                for (const uint8_t* q = CAT_PROBS[cat]; *q; ++q) v = (v << 1) + c.get(*q);
                coeff += v;
            }
            ctx = 2;
        }
        block[ZIGZAG[i]] = static_cast<int16_t>((c.bit() ? -coeff : coeff) * qmul[i ? 1 : 0]);
        if (++i == 16) return 16;
        p = probs[COEF_BANDS[i]][ctx];
        if (!c.get(p[0])) return i;  // EOB
    }
}

void Decoder::decode_coeffs(MB& mb, RangeCoder& c, uint8_t* t_nnz, uint8_t* l_nnz) {
    const int16_t(*q)[2] = qmul_[mb.segment];
    int luma_start = 0, luma_type = 3, total = 0;
    if (mb.mode != B_PRED && mb.mode != SPLITMV) {
        int16_t* dc = coef_[24];
        const int nnz = decode_block(c, dc, prob_.token[1], 0, t_nnz[8] + l_nnz[8], q[1]);
        t_nnz[8] = l_nnz[8] = nnz != 0;
        if (nnz) {
            total += nnz;
            // the inverse WHT (vp8_luma_dc_wht): columns, then rows with
            // rounding, each pass stored in 16 bits
            int16_t t[16];
            for (int i = 0; i < 4; ++i) {
                const int a0 = dc[i] + dc[12 + i], a1 = dc[4 + i] + dc[8 + i];
                const int a2 = dc[4 + i] - dc[8 + i], a3 = dc[i] - dc[12 + i];
                t[i] = static_cast<int16_t>(a0 + a1);
                t[4 + i] = static_cast<int16_t>(a3 + a2);
                t[8 + i] = static_cast<int16_t>(a0 - a1);
                t[12 + i] = static_cast<int16_t>(a3 - a2);
            }
            for (int i = 0; i < 4; ++i) {
                const int a0 = t[4 * i] + t[4 * i + 3] + 3, a1 = t[4 * i + 1] + t[4 * i + 2];
                const int a2 = t[4 * i + 1] - t[4 * i + 2], a3 = t[4 * i] - t[4 * i + 3] + 3;
                coef_[4 * i][0] = static_cast<int16_t>((a0 + a1) >> 3);
                coef_[4 * i + 1][0] = static_cast<int16_t>((a3 + a2) >> 3);
                coef_[4 * i + 2][0] = static_cast<int16_t>((a0 - a1) >> 3);
                coef_[4 * i + 3][0] = static_cast<int16_t>((a3 - a2) >> 3);
            }
        }
        luma_start = 1;
        luma_type = 0;
    }
    for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) {
            const int nnz = decode_block(c, coef_[4 * y + x], prob_.token[luma_type], luma_start,
                                         l_nnz[y] + t_nnz[x], q[0]);
            t_nnz[x] = l_nnz[y] = nnz != 0;
            total += nnz;
        }
    for (int i = 4; i < 8; i += 2)  // U, then V
        for (int y = 0; y < 2; ++y)
            for (int x = 0; x < 2; ++x) {
                const int nnz = decode_block(c, coef_[16 + 2 * (i - 4) + 2 * y + x],
                                             prob_.token[2], 0, l_nnz[i + y] + t_nnz[i + x], q[2]);
                t_nnz[i + x] = l_nnz[i + y] = nnz != 0;
                total += nnz;
            }
    // no coded coefficient: no residual and no inner loop filter
    if (!total) mb.skip = 1;
}

// vp8_idct_add: columns then rows, 16-bit intermediates, (x + 4) >> 3
void idct_add(const int16_t* b, uint8_t* dst, int stride) {
    bool ac = false;
    for (int i = 1; i < 16; ++i) ac |= b[i] != 0;
    if (!ac) {
        if (!b[0]) return;
        const int dc = (b[0] + 4) >> 3;
        for (int r = 0; r < 4; ++r)
            for (int c = 0; c < 4; ++c) dst[r * stride + c] = clip8(dst[r * stride + c] + dc);
        return;
    }
    auto m20091 = [](int a) { return ((a * 20091) >> 16) + a; };
    auto m35468 = [](int a) { return (a * 35468) >> 16; };
    int16_t t[16];
    for (int i = 0; i < 4; ++i) {
        const int t0 = b[i] + b[8 + i], t1 = b[i] - b[8 + i];
        const int t2 = m35468(b[4 + i]) - m20091(b[12 + i]);
        const int t3 = m20091(b[4 + i]) + m35468(b[12 + i]);
        t[4 * i] = static_cast<int16_t>(t0 + t3);
        t[4 * i + 1] = static_cast<int16_t>(t1 + t2);
        t[4 * i + 2] = static_cast<int16_t>(t1 - t2);
        t[4 * i + 3] = static_cast<int16_t>(t0 - t3);
    }
    for (int i = 0; i < 4; ++i) {
        const int t0 = t[i] + t[8 + i], t1 = t[i] - t[8 + i];
        const int t2 = m35468(t[4 + i]) - m20091(t[12 + i]);
        const int t3 = m20091(t[4 + i]) + m35468(t[12 + i]);
        uint8_t* d = dst + i * stride;
        d[0] = clip8(d[0] + ((t0 + t3 + 4) >> 3));
        d[1] = clip8(d[1] + ((t1 + t2 + 4) >> 3));
        d[2] = clip8(d[2] + ((t1 - t2 + 4) >> 3));
        d[3] = clip8(d[3] + ((t0 - t3 + 4) >> 3));
    }
}

void Decoder::add_residual(const MB& mb, int mx, int my, bool luma) {
    if (mb.skip) return;
    Picture& pic = *cur_;
    if (luma) {
        const int s = int(pic.p[0].stride);
        uint8_t* y0 = &pic.p[0].px[size_t(16 * my) * s + 16 * mx];
        for (int k = 0; k < 16; ++k) idct_add(coef_[k], y0 + (k >> 2) * 4 * s + (k & 3) * 4, s);
    }
    for (int pl = 1; pl < 3; ++pl) {
        const int s = int(pic.p[pl].stride);
        uint8_t* c0 = &pic.p[pl].px[size_t(8 * my) * s + 8 * mx];
        for (int k = 0; k < 4; ++k)
            idct_add(coef_[16 + 4 * (pl - 1) + k], c0 + (k >> 1) * 4 * s + (k & 1) * 4, s);
    }
}

inline int avg2(int a, int b) { return (a + b + 1) >> 1; }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }

// a 16x16 (luma) or 8x8 (chroma) intra prediction at (x0, y0) of `pl`
void predict_block(fmvfi_ff::Plane& pl, int x0, int y0, int n, int mode) {
    const int s = int(pl.stride);
    uint8_t* d = &pl.px[size_t(y0) * s + x0];
    uint8_t above[16], left[16];
    const bool has_above = y0 > 0, has_left = x0 > 0;
    for (int i = 0; i < n; ++i) {
        above[i] = has_above ? d[i - s] : 127;
        left[i] = has_left ? d[i * s - 1] : 129;
    }
    const int corner = !has_above ? 127 : (!has_left ? 129 : d[-s - 1]);
    const int log2n = n == 16 ? 4 : 3;
    for (int r = 0; r < n; ++r)
        for (int c = 0; c < n; ++c) {
            int v;
            switch (mode) {
                case V_PRED: v = above[c]; break;
                case H_PRED: v = left[r]; break;
                case TM_PRED: v = clip8(left[r] + above[c] - corner); break;
                default: {  // DC: from the edges inside the frame
                    int sum = 0;
                    if (has_above)
                        for (int i = 0; i < n; ++i) sum += above[i];
                    if (has_left)
                        for (int i = 0; i < n; ++i) sum += left[i];
                    if (has_above && has_left) v = (sum + n) >> (log2n + 1);
                    else if (has_above || has_left) v = (sum + n / 2) >> log2n;
                    else v = 128;
                }
            }
            d[r * s + c] = static_cast<uint8_t>(v);
        }
}

void Decoder::intra_predict(const MB& mb, int mx, int my) {
    fmvfi_ff::Plane& Y = cur_->p[0];
    if (mb.mode != B_PRED) {
        predict_block(Y, 16 * mx, 16 * my, 16, mb.mode);
        add_residual(mb, mx, my, true);
    } else {
        const int s = int(Y.stride);
        for (int k = 0; k < 16; ++k) {
            const int r = k >> 2, c = k & 3;
            const int x0 = 16 * mx + 4 * c, y0 = 16 * my + 4 * r;
            uint8_t* d = &Y.px[size_t(y0) * s + x0];
            int A[8], L[4];
            for (int i = 0; i < 4; ++i) {
                A[i] = y0 ? d[i - s] : 127;
                L[i] = x0 ? d[i * s - 1] : 129;
            }
            if (c < 3) {
                for (int i = 4; i < 8; ++i) A[i] = y0 ? d[i - s] : 127;
            } else if (!my) {
                for (int i = 4; i < 8; ++i) A[i] = 127;
            } else {  // the macroblock row above, repeated at the frame's right edge
                const uint8_t* row = &Y.px[size_t(16 * my - 1) * s + 16 * mx];
                for (int i = 4; i < 8; ++i) A[i] = mx == mbw_ - 1 ? row[15] : row[12 + i];
            }
            const int P = !y0 ? 127 : (!x0 ? 129 : d[-s - 1]);
            int B[4][4];
            const int E[9] = {L[3], L[2], L[1], L[0], P, A[0], A[1], A[2], A[3]};
            const int* e = E + 4;  // e[-4..4]
            switch (mb.bmodes[k]) {
                case B_DC: {
                    int v = 4;
                    for (int i = 0; i < 4; ++i) v += A[i] + L[i];
                    for (auto& row : B)
                        for (int& x : row) x = v >> 3;
                    break;
                }
                case B_TM:
                    for (int i = 0; i < 4; ++i)
                        for (int j = 0; j < 4; ++j) B[i][j] = clip8(L[i] + A[j] - P);
                    break;
                case B_VE:
                    for (int j = 0; j < 4; ++j) {
                        const int v = avg3(j ? A[j - 1] : P, A[j], A[j + 1]);
                        for (int i = 0; i < 4; ++i) B[i][j] = v;
                    }
                    break;
                case B_HE: {
                    const int v[4] = {avg3(P, L[0], L[1]), avg3(L[0], L[1], L[2]),
                                      avg3(L[1], L[2], L[3]), avg3(L[2], L[3], L[3])};
                    for (int i = 0; i < 4; ++i)
                        for (int j = 0; j < 4; ++j) B[i][j] = v[i];
                    break;
                }
                case B_LD:
                    for (int i = 0; i < 4; ++i)
                        for (int j = 0; j < 4; ++j) {
                            const int t = i + j;
                            B[i][j] = t < 6 ? avg3(A[t], A[t + 1], A[t + 2]) : avg3(A[6], A[7], A[7]);
                        }
                    break;
                case B_RD:
                    for (int i = 0; i < 4; ++i)
                        for (int j = 0; j < 4; ++j) B[i][j] = avg3(e[j - i - 1], e[j - i], e[j - i + 1]);
                    break;
                case B_VR:
                    B[3][0] = avg3(e[-3], e[-2], e[-1]);
                    B[2][0] = avg3(e[-2], e[-1], e[0]);
                    B[3][1] = B[1][0] = avg3(e[-1], e[0], e[1]);
                    B[2][1] = B[0][0] = avg2(e[0], e[1]);
                    B[3][2] = B[1][1] = avg3(e[0], e[1], e[2]);
                    B[2][2] = B[0][1] = avg2(e[1], e[2]);
                    B[3][3] = B[1][2] = avg3(e[1], e[2], e[3]);
                    B[2][3] = B[0][2] = avg2(e[2], e[3]);
                    B[1][3] = avg3(e[2], e[3], e[4]);
                    B[0][3] = avg2(e[3], e[4]);
                    break;
                case B_VL:
                    B[0][0] = avg2(A[0], A[1]);
                    B[1][0] = avg3(A[0], A[1], A[2]);
                    B[2][0] = B[0][1] = avg2(A[1], A[2]);
                    B[1][1] = B[3][0] = avg3(A[1], A[2], A[3]);
                    B[2][1] = B[0][2] = avg2(A[2], A[3]);
                    B[3][1] = B[1][2] = avg3(A[2], A[3], A[4]);
                    B[2][2] = B[0][3] = avg2(A[3], A[4]);
                    B[3][2] = B[1][3] = avg3(A[3], A[4], A[5]);
                    B[2][3] = avg3(A[4], A[5], A[6]);
                    B[3][3] = avg3(A[5], A[6], A[7]);
                    break;
                case B_HD:
                    B[3][0] = avg2(e[-4], e[-3]);
                    B[3][1] = avg3(e[-4], e[-3], e[-2]);
                    B[2][0] = B[3][2] = avg2(e[-3], e[-2]);
                    B[2][1] = B[3][3] = avg3(e[-3], e[-2], e[-1]);
                    B[2][2] = B[1][0] = avg2(e[-2], e[-1]);
                    B[2][3] = B[1][1] = avg3(e[-2], e[-1], e[0]);
                    B[1][2] = B[0][0] = avg2(e[-1], e[0]);
                    B[1][3] = B[0][1] = avg3(e[-1], e[0], e[1]);
                    B[0][2] = avg3(e[0], e[1], e[2]);
                    B[0][3] = avg3(e[1], e[2], e[3]);
                    break;
                default:  // B_HU
                    B[0][0] = avg2(L[0], L[1]);
                    B[0][1] = avg3(L[0], L[1], L[2]);
                    B[0][2] = B[1][0] = avg2(L[1], L[2]);
                    B[0][3] = B[1][1] = avg3(L[1], L[2], L[3]);
                    B[1][2] = B[2][0] = avg2(L[2], L[3]);
                    B[1][3] = B[2][1] = avg3(L[2], L[3], L[3]);
                    B[2][2] = B[2][3] = B[3][0] = B[3][1] = B[3][2] = B[3][3] = L[3];
            }
            for (int i = 0; i < 4; ++i)
                for (int j = 0; j < 4; ++j) d[i * s + j] = static_cast<uint8_t>(B[i][j]);
            if (!mb.skip) idct_add(coef_[k], d, s);
        }
    }
    predict_block(cur_->p[1], 8 * mx, 8 * my, 8, mb.uvmode);
    predict_block(cur_->p[2], 8 * mx, 8 * my, 8, mb.uvmode);
    add_residual(mb, mx, my, false);
}

// a bw x bh block at (x, y) of the reference plane (pw x ph, its edges
// repeated) moved by fx, fy eighths: six-tap (version 0) or bilinear
void Decoder::mc(uint8_t* dst, int ds, const fmvfi_ff::Plane& ref, int pw, int ph, int x, int y,
                 int fx, int fy, int bw, int bh) const {
    uint8_t win[21 * 21];
    const int ws = bw + 5, s = int(ref.stride);
    for (int r = 0; r < bh + 5; ++r) {
        const uint8_t* row = &ref.px[size_t(std::max(0, std::min(ph - 1, y - 2 + r))) * s];
        for (int c = 0; c < ws; ++c) win[r * ws + c] = row[std::max(0, std::min(pw - 1, x - 2 + c))];
    }
    const uint8_t* src = win + 2 * ws + 2;
    if (!fx && !fy) {
        for (int r = 0; r < bh; ++r) std::memcpy(dst + r * ds, src + r * ws, size_t(bw));
        return;
    }
    uint8_t tmp[21 * 16];
    if (version_ == 0) {
        const int16_t* fh = SUBPEL_FILTERS[fx];
        const int16_t* fv = SUBPEL_FILTERS[fy];
        auto tap = [](const int16_t* f, const uint8_t* p, int step) {
            return clip8((f[0] * p[-2 * step] + f[1] * p[-step] + f[2] * p[0] + f[3] * p[step] +
                          f[4] * p[2 * step] + f[5] * p[3 * step] + 64) >> 7);
        };
        if (fx && fy) {
            for (int r = -2; r < bh + 3; ++r)
                for (int c = 0; c < bw; ++c) tmp[(r + 2) * bw + c] = tap(fh, src + r * ws + c, 1);
            for (int r = 0; r < bh; ++r)
                for (int c = 0; c < bw; ++c) dst[r * ds + c] = tap(fv, tmp + (r + 2) * bw + c, bw);
        } else if (fx) {
            for (int r = 0; r < bh; ++r)
                for (int c = 0; c < bw; ++c) dst[r * ds + c] = tap(fh, src + r * ws + c, 1);
        } else {
            for (int r = 0; r < bh; ++r)
                for (int c = 0; c < bw; ++c) dst[r * ds + c] = tap(fv, src + r * ws + c, ws);
        }
        return;
    }
    auto bil = [](int f, const uint8_t* p, int step) {
        return static_cast<uint8_t>(((8 - f) * p[0] + f * p[step] + 4) >> 3);
    };
    if (fx && fy) {
        for (int r = 0; r < bh + 1; ++r)
            for (int c = 0; c < bw; ++c) tmp[r * bw + c] = bil(fx, src + r * ws + c, 1);
        for (int r = 0; r < bh; ++r)
            for (int c = 0; c < bw; ++c) dst[r * ds + c] = bil(fy, tmp + r * bw + c, bw);
    } else if (fx) {
        for (int r = 0; r < bh; ++r)
            for (int c = 0; c < bw; ++c) dst[r * ds + c] = bil(fx, src + r * ws + c, 1);
    } else {
        for (int r = 0; r < bh; ++r)
            for (int c = 0; c < bw; ++c) dst[r * ds + c] = bil(fy, src + r * ws + c, ws);
    }
}

void Decoder::inter_predict(const MB& mb, int mx, int my) {
    const Picture& ref = *ref_[mb.ref];
    Picture& pic = *cur_;
    const int pw = 16 * mbw_, ph = 16 * mbh_, ys = int(pic.p[0].stride), cs = int(pic.p[1].stride);
    auto luma = [&](int bx, int by, int bw, int bh, const MV& v) {  // bx, by in the macroblock
        const int x = 16 * mx + bx, y = 16 * my + by;
        mc(&pic.p[0].px[size_t(y) * ys + x], ys, ref.p[0], pw, ph, x + (v.x >> 2), y + (v.y >> 2),
           (v.x * 2) & 7, (v.y * 2) & 7, bw, bh);
    };
    auto chroma = [&](int bx, int by, int bw, int bh, MV v) {  // bx, by in chroma samples
        if (version_ == 3) {  // full-pixel chroma
            v.x = static_cast<int16_t>(v.x & ~7);
            v.y = static_cast<int16_t>(v.y & ~7);
        }
        const int x = 8 * mx + bx, y = 8 * my + by;
        for (int pl = 1; pl < 3; ++pl)
            mc(&pic.p[pl].px[size_t(y) * cs + x], cs, ref.p[pl], pw / 2, ph / 2, x + (v.x >> 3),
               y + (v.y >> 3), v.x & 7, v.y & 7, bw, bh);
    };
    switch (mb.split) {
        case SPLIT_NONE:
            luma(0, 0, 16, 16, mb.mv);
            chroma(0, 0, 8, 8, mb.mv);
            break;
        case SPLIT_16x8:
        case SPLIT_8x16:
        case SPLIT_8x8: {
            const int bw = mb.split == SPLIT_16x8 ? 16 : 8, bh = mb.split == SPLIT_8x16 ? 16 : 8;
            for (int by = 0; by < 16; by += bh)
                for (int bx = 0; bx < 16; bx += bw) {
                    const MV& v = mb.bmv[(by / 4) * 4 + bx / 4];
                    luma(bx, by, bw, bh, v);
                    chroma(bx / 2, by / 2, bw / 2, bh / 2, v);
                }
            break;
        }
        default:  // 4x4: each sub-block's vector; chroma from the mean of four
            for (int k = 0; k < 16; ++k) luma(4 * (k & 3), 4 * (k >> 2), 4, 4, mb.bmv[k]);
            for (int y = 0; y < 2; ++y)
                for (int x = 0; x < 2; ++x) {
                    const int k = 8 * y + 2 * x;
                    int sx = mb.bmv[k].x + mb.bmv[k + 1].x + mb.bmv[k + 4].x + mb.bmv[k + 5].x;
                    int sy = mb.bmv[k].y + mb.bmv[k + 1].y + mb.bmv[k + 4].y + mb.bmv[k + 5].y;
                    MV v;
                    v.x = static_cast<int16_t>((sx + 2 + (sx < 0 ? -1 : 0)) >> 2);
                    v.y = static_cast<int16_t>((sy + 2 + (sy < 0 ? -1 : 0)) >> 2);
                    chroma(4 * x, 4 * y, 4, 4, v);
                }
    }
    add_residual(mb, mx, my, true);
}

void Decoder::filter_params(MB& mb) const {
    int level = filter_level_;
    if (seg_enabled_) {
        level = seg_filter_[mb.segment];
        if (!seg_absolute_) level += filter_level_;
    }
    if (lf_delta_enabled_) {
        level += lf_ref_[mb.ref];
        switch (mb.mode) {
            case B_PRED: level += lf_mode_[0]; break;
            case ZEROMV: level += lf_mode_[1]; break;
            case NEARESTMV:
            case NEARMV:
            case NEWMV: level += lf_mode_[2]; break;
            case SPLITMV: level += lf_mode_[3]; break;
            default: break;
        }
    }
    level = clip_uint6(level);
    int interior = level;
    if (sharpness_) {
        interior >>= (sharpness_ + 3) >> 2;
        interior = std::min(interior, 9 - sharpness_);
    }
    mb.filter_level = static_cast<uint8_t>(level);
    mb.inner_limit = static_cast<uint8_t>(std::max(interior, 1));
    mb.inner_filter = !mb.skip || mb.mode == B_PRED || mb.mode == SPLITMV;
}

// vp8dsp.c's filters on the edge before p[0], `step` apart across it
inline void filter_common(uint8_t* p, int step, bool is4tap) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    int a = 3 * (q0 - p0);
    if (is4tap) a += clip_int8(p1 - q1);
    a = clip_int8(a);
    const int f1 = std::min(a + 4, 127) >> 3;
    const int f2 = std::min(a + 3, 127) >> 3;
    p[-step] = clip8(p0 + f2);
    p[0] = clip8(q0 - f1);
    if (!is4tap) {
        a = (f1 + 1) >> 1;
        p[-2 * step] = clip8(p1 + a);
        p[step] = clip8(q1 - a);
    }
}

inline void filter_mbedge(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    int w = clip_int8(p1 - q1);
    w = clip_int8(w + 3 * (q0 - p0));
    const int a0 = (27 * w + 63) >> 7, a1 = (18 * w + 63) >> 7, a2 = (9 * w + 63) >> 7;
    p[-3 * step] = clip8(p2 + a2);
    p[-2 * step] = clip8(p1 + a1);
    p[-step] = clip8(p0 + a0);
    p[0] = clip8(q0 - a0);
    p[step] = clip8(q1 - a1);
    p[2 * step] = clip8(q2 - a2);
}

inline bool simple_limit(const uint8_t* p, int step, int flim) {
    return 2 * std::abs(p[-step] - p[0]) + (std::abs(p[-2 * step] - p[step]) >> 1) <= flim;
}

inline bool normal_limit(const uint8_t* p, int step, int E, int I) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    return simple_limit(p, step, E) && std::abs(p3 - p2) <= I && std::abs(p2 - p1) <= I &&
           std::abs(p1 - p0) <= I && std::abs(q3 - q2) <= I && std::abs(q2 - q1) <= I &&
           std::abs(q1 - q0) <= I;
}

inline bool hev(const uint8_t* p, int step, int thresh) {
    return std::abs(p[-2 * step] - p[-step]) > thresh || std::abs(p[step] - p[0]) > thresh;
}

// n samples along an edge (`along` apart), filtered across it (`step`)
void edge_normal(uint8_t* p, int along, int step, int n, int E, int I, int thresh, bool mbedge) {
    for (int i = 0; i < n; ++i, p += along) {
        if (!normal_limit(p, step, E, I)) continue;
        if (hev(p, step, thresh)) filter_common(p, step, true);
        else if (mbedge) filter_mbedge(p, step);
        else filter_common(p, step, false);
    }
}

void edge_simple(uint8_t* p, int along, int step, int flim) {
    for (int i = 0; i < 16; ++i, p += along)
        if (simple_limit(p, step, flim)) filter_common(p, step, true);
}

void Decoder::loop_filter() {
    Picture& pic = *cur_;
    const int ys = int(pic.p[0].stride), cs = int(pic.p[1].stride);
    for (int my = 0; my < mbh_; ++my)
        for (int mx = 0; mx < mbw_; ++mx) {
            const MB& mb = mb_at(mx, my);
            const int level = mb.filter_level, I = mb.inner_limit;
            if (!level) continue;
            const int bedge = 2 * level + I, mbedge = bedge + 4;
            uint8_t* y0 = &pic.p[0].px[size_t(16 * my) * ys + 16 * mx];
            if (simple_) {
                if (mx) edge_simple(y0, ys, 1, mbedge);
                if (mb.inner_filter)
                    for (int x = 4; x < 16; x += 4) edge_simple(y0 + x, ys, 1, bedge);
                if (my) edge_simple(y0, 1, ys, mbedge);
                if (mb.inner_filter)
                    for (int y = 4; y < 16; y += 4) edge_simple(y0 + y * ys, 1, ys, bedge);
                continue;
            }
            const int thresh = keyframe_ ? (level >= 40 ? 2 : level >= 15 ? 1 : 0)
                                         : (level >= 40 ? 3 : level >= 20 ? 2 : level >= 15 ? 1 : 0);
            uint8_t* c0[2] = {&pic.p[1].px[size_t(8 * my) * cs + 8 * mx],
                              &pic.p[2].px[size_t(8 * my) * cs + 8 * mx]};
            if (mx) {
                edge_normal(y0, ys, 1, 16, mbedge, I, thresh, true);
                for (uint8_t* c : c0) edge_normal(c, cs, 1, 8, mbedge, I, thresh, true);
            }
            if (mb.inner_filter) {
                for (int x = 4; x < 16; x += 4) edge_normal(y0 + x, ys, 1, 16, bedge, I, thresh, false);
                for (uint8_t* c : c0) edge_normal(c + 4, cs, 1, 8, bedge, I, thresh, false);
            }
            if (my) {
                edge_normal(y0, 1, ys, 16, mbedge, I, thresh, true);
                for (uint8_t* c : c0) edge_normal(c, 1, cs, 8, mbedge, I, thresh, true);
            }
            if (mb.inner_filter) {
                for (int y = 4; y < 16; y += 4)
                    edge_normal(y0 + y * ys, 1, ys, 16, bedge, I, thresh, false);
                for (uint8_t* c : c0) edge_normal(c + 4 * cs, 1, cs, 8, bedge, I, thresh, false);
            }
        }
}

// `after`: the bytes that follow the frame in the caller's buffer (a WebP
// file's after its VP8 chunk), which a range decoder may read past the last
// partition's end; zeros (a demuxer's packet padding) when there are none
bool Decoder::decode(const uint8_t* data, size_t n, const uint8_t* after, size_t n_after) {
    const size_t n_data = libwebp_ ? n + n_after : n;
    data_.assign(data, data + n);
    data_.insert(data_.end(), after, after + (libwebp_ ? n_after : std::min<size_t>(n_after, 32)));
    data_.resize(n_data + 32, 0);  // what the range decoders read past a partition's end
    parse_header(data_.data(), n, n_data);
    cur_ = std::make_shared<Picture>();
    for (int i = 0; i < 3; ++i) {
        fmvfi_ff::Plane& p = cur_->p[i];
        const int sub = i ? 1 : 0;
        p.stride = size_t(16 * mbw_) >> sub;
        p.px.assign(p.stride * (size_t(16 * mbh_) >> sub), 0);
        p.w = (width_ + sub) >> sub;
        p.h = (height_ + sub) >> sub;
    }
    top_nnz_.assign(size_t(9) * mbw_, 0);
    for (int my = 0; my < mbh_; ++my) {
        uint8_t left_nnz[9] = {};
        RangeCoder& tok = parts_[my & (num_partitions_ - 1)];
        for (int mx = 0; mx < mbw_; ++mx) {
            if (!libwebp_ && tok.is_end())
                fail(CORRUPT, "a token partition read past its end at macroblock (" +
                                  std::to_string(mx) + ", " + std::to_string(my) + ")");
            MB& mb = mb_at(mx, my);
            decode_modes(mb, mx, my);
            std::memset(coef_, 0, sizeof(coef_));
            uint8_t* t_nnz = &top_nnz_[size_t(9) * mx];
            if (!mb.skip) {
                decode_coeffs(mb, tok, t_nnz, left_nnz);
            } else {
                std::memset(t_nnz, 0, 8);
                std::memset(left_nnz, 0, 8);
                if (mb.mode != B_PRED && mb.mode != SPLITMV) t_nnz[8] = left_nnz[8] = 0;
            }
            if (libwebp_ && (tok.past_end() || c_.past_end()))
                fail(CORRUPT, "a partition read past its end at macroblock (" + std::to_string(mx) +
                                  ", " + std::to_string(my) + ") (libwebp: premature end of file)");
            if (mb.ref == INTRA) intra_predict(mb, mx, my);
            else inter_predict(mb, mx, my);
            filter_params(mb);
        }
    }
    if (filter_level_) loop_filter();
    std::shared_ptr<Picture> old[4] = {cur_, ref_[1], ref_[2], ref_[3]};
    if (update_altref_ >= 0) ref_[ALTREF] = old[update_altref_];
    if (update_golden_ >= 0) ref_[GOLDEN] = old[update_golden_];
    if (update_last_) ref_[LAST] = cur_;
    if (keep_probs_) prob_ = saved_;
    have_key_ = true;
    return show_ != 0;
}

void Decoder::frame_rgb(uint8_t* out) const {
    fmvfi_ff::yuv_to_rgb(width_, height_, 3, 2, 2, cur_->p, false, out);
}

// the planes before the conversion, cropped to the frame's size: Y w x h, U
// and V (w + 1) / 2 x (h + 1) / 2, each row after row
void Decoder::frame_planes(uint8_t* y, uint8_t* u, uint8_t* v) const {
    uint8_t* dst[3] = {y, u, v};
    for (int i = 0; i < 3; ++i) {
        const fmvfi_ff::Plane& p = cur_->p[i];
        for (int r = 0; r < p.h; ++r)
            std::memcpy(dst[i] + size_t(r) * size_t(p.w), p.px.data() + size_t(r) * p.stride,
                        size_t(p.w));
    }
}


}  // namespace

extern "C" {

void* fmvfi_vp8_open(char* msg, int32_t msglen, int32_t* code) {
    try {
        *code = OK;
        return new Decoder();
    } catch (const std::bad_alloc&) {
        *code = fmvfi_jpeg::report(Error{CORRUPT, "out of memory"}, msg, msglen);
    }
    return nullptr;
}

// n_after: bytes readable after the frame's n (see Decoder::decode); info:
// width, height, shown, key frame, version, token partitions, feature bits
int32_t fmvfi_vp8_decode(void* handle, const uint8_t* data, int64_t n, int64_t n_after,
                         int32_t* info, char* msg, int32_t msglen) {
    Decoder* dec = static_cast<Decoder*>(handle);
    try {
        const bool shown = dec->decode(data, static_cast<size_t>(n), data + n,
                                       static_cast<size_t>(n_after));
        info[0] = dec->width();
        info[1] = dec->height();
        info[2] = shown;
        info[3] = dec->keyframe();
        info[4] = dec->version();
        info[5] = dec->partitions();
        info[6] = dec->features();
        return OK;
    } catch (const Error& e) {
        return fmvfi_jpeg::report(e, msg, msglen);
    } catch (const std::bad_alloc&) {
        return fmvfi_jpeg::report(Error{CORRUPT, "out of memory"}, msg, msglen);
    }
}

void fmvfi_vp8_frame(void* handle, uint8_t* out) { static_cast<Decoder*>(handle)->frame_rgb(out); }

void fmvfi_vp8_planes(void* handle, uint8_t* y, uint8_t* u, uint8_t* v) {
    static_cast<Decoder*>(handle)->frame_planes(y, u, v);
}

// the decoder's mode: FFmpeg's (0, the default) or libwebp's (1)
void fmvfi_vp8_libwebp(void* handle, int32_t on) { static_cast<Decoder*>(handle)->set_libwebp(on != 0); }

void fmvfi_vp8_close(void* handle) { delete static_cast<Decoder*>(handle); }

}  // extern "C"
