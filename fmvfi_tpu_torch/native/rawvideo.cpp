// fmvfi_tpu_torch native host runtime: raw video frames (FFmpeg's rawvideo
// decoder) as cv2.VideoCapture converts them, for fmvfi_tpu_torch/utils/
// formats.py (I420 / IYUV / YV12 frames in AVI files).
//
//   fmvfi_yuv420p_swscale(y, u, v, w, h, out)
//     A yuv420p frame's planes (Y w x h, U and V (w + 1) / 2 x (h + 1) / 2,
//     each row after row) as swscale converts them to BGR24 for OpenCV:
//     BT.601, limited range, the chroma sited at its default (centre), by
//     ffmpeg_common.h's yuv_to_rgb routes.  out: w x h RGB bytes.
//
//   fmvfi_yuv16_swscale(y, u, v, w, h, ss_x, ss_y, depth, full_range, out)
//     Planes of `depth` (9-16) bits in 16-bit samples (yuv4xxp10le,
//     yuv4xxp12le, ...: U and V subsampled by ss_x / ss_y, 0 or 1), BT.601,
//     as swscale converts them (the route VP9's profiles 2 and 3 take); at
//     depth 8, samples below 256 as the 8-bit yuv4xxp formats.

#include <cstdint>
#include <cstring>

#include "ffmpeg_common.h"

extern "C" {

void fmvfi_yuv420p_swscale(const uint8_t* y, const uint8_t* u, const uint8_t* v, int32_t w,
                           int32_t h, uint8_t* out) {
    const uint8_t* src[3] = {y, u, v};
    fmvfi_ff::Plane planes[3];
    for (int i = 0; i < 3; ++i) {
        fmvfi_ff::Plane& p = planes[i];
        p.w = i ? (w + 1) >> 1 : w;
        p.h = i ? (h + 1) >> 1 : h;
        p.stride = size_t(p.w);
        p.px.assign(src[i], src[i] + p.stride * size_t(p.h));
    }
    fmvfi_ff::yuv_to_rgb(w, h, 3, 2, 2, planes, false, out);
}

void fmvfi_yuv16_swscale(const uint16_t* y, const uint16_t* u, const uint16_t* v, int32_t w,
                         int32_t h, int32_t ss_x, int32_t ss_y, int32_t depth, int32_t full_range,
                         uint8_t* out) {
    const uint16_t* src[3] = {y, u, v};
    if (depth == 8) {  // yuv4xxp: the 8-bit routes, the samples' low bytes
        fmvfi_ff::Plane planes[3];
        for (int i = 0; i < 3; ++i) {
            fmvfi_ff::Plane& p = planes[i];
            p.w = i ? (w + ss_x) >> ss_x : w;
            p.h = i ? (h + ss_y) >> ss_y : h;
            p.stride = size_t(p.w);
            p.px.assign(src[i], src[i] + p.stride * size_t(p.h));
        }
        fmvfi_ff::yuv_to_rgb(w, h, 3, 1 << ss_x, 1 << ss_y, planes, full_range != 0, out);
        return;
    }
    fmvfi_ff::Plane16 planes[3];
    for (int i = 0; i < 3; ++i) {
        fmvfi_ff::Plane16& p = planes[i];
        p.w = i ? (w + ss_x) >> ss_x : w;
        p.h = i ? (h + ss_y) >> ss_y : h;
        p.stride = size_t(p.w);
        p.px.assign(src[i], src[i] + p.stride * size_t(p.h));
    }
    fmvfi_ff::yuv_to_rgb(w, h, 3, 1 << ss_x, 1 << ss_y, planes, full_range != 0, out, -513,
                         fmvfi_ff::BT601, depth);
}

}  // extern "C"
