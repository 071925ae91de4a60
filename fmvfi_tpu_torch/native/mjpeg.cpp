// fmvfi_tpu_torch native host runtime: Motion-JPEG frames decoded as
// cv2.VideoCapture decodes them, for fmvfi_tpu_torch/utils/avi.py.
//
// cv2's video backend is FFmpeg: its mjpeg decoder turns a frame into
// planar full-range samples (yuvj420p, yuvj422p, yuvj444p or gray), and
// OpenCV converts those to BGR24 with swscale at the same size
// (sws_getCachedContext(..., AV_PIX_FMT_BGR24, SWS_BICUBIC, ...)).  Neither
// stage is libjpeg's, so a frame differs from cv2.imdecode of the same bytes
// by up to tens of levels.  This file repeats both, bit for bit:
//   - the decoder: the entropy decoding of jpeg.cpp (Annex K.3's tables
//     when the frame has no DHT, the AVI1 convention), coefficients
//     dequantized into 16 bits with the DC offset by 1024 (FFmpeg's level
//     shift), and FFmpeg's integer "simple" IDCT (ffmpeg_common.h);
//   - swscale's BT.601 full-range conversion, whose route depends on the
//     size (ffmpeg_common.h's yuv_to_rgb, with the full-range coefficients).
// Progressive frames, and samplings other than 4:2:0, 4:2:2 and 4:4:4
// (after removing a factor common to all three components), are refused
// as unsupported.
//
// Exposed C ABI (ctypes):
//   fmvfi_mjpeg_decode(data, n, out, msg, msglen) -> int32
//     out: height * width * 3 bytes, RGB; returns 0, 1 (unsupported) or 2
//     (corrupt), msg saying why.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "ffmpeg_common.h"
#include "jpeg_common.h"

namespace fmvfi_jpeg {

namespace {

using fmvfi_ff::Plane;

Plane idct_plane(const Component& c) {
    Plane p;
    p.stride = size_t(c.bw) * 8;
    p.w = c.w_real;
    p.h = c.h_real;
    p.px.assign(p.stride * size_t(c.bh) * 8, 0);
    for (int by = 0; by < c.hb; ++by)
        for (int bx = 0; bx < c.wb; ++bx)
            fmvfi_ff::simple_idct_put(c.block(by, bx), p.px.data() + size_t(by) * 8 * p.stride + size_t(bx) * 8,
                            p.stride);
    return p;
}

void decode_mjpeg(const uint8_t* d, size_t n, uint8_t* out) {
    Image img;
    read_header(d, n, img);
    if (img.progressive)
        fail(UNSUPPORTED, "a progressive (SOF2) Motion-JPEG frame; only sequential frames "
                          "(SOF0, SOF1) are decoded as FFmpeg decodes them");
    if (img.color != Color::GREY && img.color != Color::YCBCR)
        fail(UNSUPPORTED, "an RGB-coded or four-component Motion-JPEG frame; only grey and YCbCr "
                          "frames are decoded as FFmpeg decodes them");
    if (img.ncomp == 3) {
        const Component &l = img.comps[0], &cb = img.comps[1], &cr = img.comps[2];
        const bool ok = cb.h == cr.h && cb.v == cr.v && l.h % cb.h == 0 && l.v % cb.v == 0 &&
                        (l.h / cb.h == 1 || l.h / cb.h == 2) &&
                        (l.v / cb.v == 1 || (l.v / cb.v == 2 && l.h / cb.h == 2));
        if (!ok)
            fail(UNSUPPORTED, "a Motion-JPEG frame sampled other than 4:2:0, 4:2:2 or 4:4:4");
    }
    img = Image();
    decode_coefficients(d, n, img, Store::FFMPEG);
    std::vector<Plane> planes;
    for (const Component& c : img.comps) planes.push_back(idct_plane(c));
    const int rx = img.ncomp == 3 ? img.hmax / img.comps[1].h : 1;
    const int ry = img.ncomp == 3 ? img.vmax / img.comps[1].v : 1;
    fmvfi_ff::yuv_to_rgb(img.width, img.height, img.ncomp, rx, ry, planes.data(), true, out);
}

}  // namespace

}  // namespace fmvfi_jpeg

using namespace fmvfi_jpeg;

extern "C" {

int32_t fmvfi_mjpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, char* msg,
                           int32_t msglen) {
    try {
        decode_mjpeg(data, static_cast<size_t>(n), out);
        return OK;
    } catch (const Error& e) {
        return report(e, msg, msglen);
    } catch (const std::bad_alloc&) {
        return report(Error{CORRUPT, "out of memory"}, msg, msglen);
    }
}

}  // extern "C"
