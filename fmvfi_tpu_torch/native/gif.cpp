// fmvfi_tpu_torch native host runtime: the LZW image data of a GIF, for
// fmvfi_tpu_torch/utils/gif.py, decoded as FFmpeg's lzw.c (under its gif
// decoder, which cv2.VideoCapture uses) and OpenCV's own GIF decoder (under
// cv2.imread) decode a well-formed stream.
//
// GIF's LZW: codes of min_code + 1 bits at first, packed least significant
// bit first; Clear (1 << min_code) resets the table and the width, End
// (Clear + 1) ends the data; each code after the first adds the previous
// string plus the first index of this one, and the width grows by a bit when
// the next free slot reaches 1 << width, up to 12 bits.  A full table (4096
// entries) stops growing and codes go on at 12 bits until a Clear (the
// "deferred clear" that encoders may use).  A code one past the table is the
// previous string plus its own first index (KwKwK).  The first code after a
// Clear adds nothing.
//
// The caller joins the data sub-blocks (their length bytes dropped).
//
// FFmpeg reads the first npix indices and ignores what follows them.
// OpenCV's decoder (strict) reads no image unless the data ends there: the
// last pixel's code is followed by nothing (the bits run out) or by End,
// with at most one byte after the one that holds End; a code whose string
// runs past npix indices, or any other code after them (a Clear too), is an
// error.
//
// Exposed C ABI (ctypes):
//   fmvfi_gif_lzw(src, n, min_code, strict, out, npix, msg, msglen) -> int64
//     decodes npix indices into out; returns npix, or -1 with msg set for
//     a code past the table, a minimum code size outside 1-8, data that
//     ends (End, or no bytes left) before npix indices, or (strict) data
//     that goes on after them.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr int MAX_BITS = 12;
constexpr int SLOTS = 1 << MAX_BITS;

int64_t fail(char* msg, int32_t msglen, const char* what, int64_t done, int64_t npix) {
    std::snprintf(msg, size_t(msglen), "%s after %lld of %lld pixels", what,
                  static_cast<long long>(done), static_cast<long long>(npix));
    return -1;
}

}  // namespace

extern "C" {

int64_t fmvfi_gif_lzw(const uint8_t* src, int64_t n, int32_t min_code, int32_t strict,
                      uint8_t* out, int64_t npix, char* msg, int32_t msglen) {
    if (min_code < 1 || min_code > 8) {
        std::snprintf(msg, size_t(msglen), "an LZW minimum code size of %d, not 1-8", min_code);
        return -1;
    }
    static thread_local uint16_t prefix[SLOTS];
    static thread_local uint8_t suffix[SLOTS];
    static thread_local uint8_t stack[SLOTS + 1];
    const int clear = 1 << min_code, end = clear + 1, first_free = clear + 2;
    int width = min_code + 1, slot = first_free, top = 1 << width;
    int old = -1, first = -1;
    uint32_t acc = 0;
    int nbits = 0;
    int64_t pos = 0, done = 0;
    while (done < npix) {
        while (nbits < width) {
            if (pos >= n) return fail(msg, msglen, "the LZW data ends", done, npix);
            acc |= uint32_t(src[pos++]) << nbits;
            nbits += 8;
        }
        const int c = int(acc & ((1u << width) - 1));
        acc >>= width;
        nbits -= width;
        if (c == end) return fail(msg, msglen, "the LZW data ends (End code)", done, npix);
        if (c == clear) {
            width = min_code + 1;
            slot = first_free;
            top = 1 << width;
            old = first = -1;
            continue;
        }
        int code = c, sp = 0;
        if (code == slot && first >= 0) {
            stack[sp++] = uint8_t(first);
            code = old;
        } else if (code >= slot) {
            return fail(msg, msglen, "an LZW code past the table", done, npix);
        }
        while (code >= first_free) {
            stack[sp++] = suffix[code];
            code = prefix[code];
        }
        stack[sp++] = uint8_t(code);
        if (slot < top && old >= 0) {
            suffix[slot] = uint8_t(code);
            prefix[slot++] = uint16_t(old);
        }
        first = code;
        old = c;
        if (slot >= top && width < MAX_BITS) {
            top <<= 1;
            ++width;
        }
        while (sp > 0 && done < npix) out[done++] = stack[--sp];
        if (strict && sp > 0) return fail(msg, msglen, "an LZW code past the last pixel", done, npix);
    }
    if (strict) {  // what follows the last pixel's code
        while (nbits < width && pos < n) {
            acc |= uint32_t(src[pos++]) << nbits;
            nbits += 8;
        }
        if (nbits >= width) {
            const int c = int(acc & ((1u << width) - 1));
            if (c != end) return fail(msg, msglen, "an LZW code past the last pixel", done, npix);
            if (n - pos >= 2) return fail(msg, msglen, "LZW data past the End code", done, npix);
        }
    }
    return npix;
}

}  // extern "C"
