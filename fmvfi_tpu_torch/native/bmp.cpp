// fmvfi_tpu_torch native host runtime: the run-length coded BMP pixel data
// (BI_RLE8, BI_RLE4) of fmvfi_tpu_torch/utils/bmp.py, decoded as OpenCV's
// own BMP decoder (grfmt_bmp.cpp, under cv2.imread) decodes it.
//
// The output is palette indices, width x height, in the order the rows are
// stored (the caller turns a bottom-up image over).  What OpenCV does, and
// this file repeats:
//   - an encoded run (count, index) must end inside the row; in RLE8 a run
//     that ends at the row's end moves to the next row, in RLE4 (two
//     indices alternating) it does not;
//   - an absolute run (0, count >= 3) must end inside the row and never moves
//     to the next row; its data is padded to 16 bits;
//   - end of line (0, 0), end of bitmap (0, 1) and delta (0, 2, dx, dy) fill
//     with palette index 0, not leave holes.  In RLE8: to the row's end, to
//     the image's end, and dx + dy * width pixels on from where the decoder
//     stands, and an end of line right after a run that moved to the next
//     row is skipped.  In RLE4 end of bitmap is one more end of line (the
//     data must go on to the last row) and a delta fills dx pixels, its dy
//     ignored;
//   - decoding ends once the last row is passed.
// A run past its row is corrupt; data that ends before the last row is passed
// is corrupt (cv2 reads no image from it).
//
// Exposed C ABI (ctypes):
//   fmvfi_bmp_rle(src, n, bits, width, height, out, msg, msglen) -> int32
//     bits 4 or 8; returns 0, or 2 (corrupt: msg says why).

#include <cstdint>
#include <cstring>

namespace {

enum { OK = 0, CORRUPT = 2 };

struct Corrupt {
    const char* what;
};

struct Rle {
    const uint8_t* src;
    int64_t n, pos = 0;
    int width, height, x = 0, y = 0;
    uint8_t* out;

    int byte() {
        if (pos >= n) throw Corrupt{"the run-length data ends before the last row"};
        return src[pos++];
    }

    // OpenCV's FillUniColor: count pixels of one index, moving to the next
    // row at each row's end, stopping past the last row
    void fill(int64_t count, uint8_t index) {
        do {
            int64_t end = x + count;
            if (end > width) end = width;
            count -= end - x;
            std::memset(out + int64_t(y) * width + x, index, size_t(end - x));
            x = int(end);
            if (x >= width) {
                x = 0;
                if (++y >= height) break;
            }
        } while (count > 0);
    }

    void absolute(int count, int bits) {
        if (x + count > width) throw Corrupt{"an absolute run past the end of its row"};
        const int size = bits == 8 ? (count + 1) & ~1 : (((count + 1) >> 1) + 1) & ~1;
        if (n - pos < size) throw Corrupt{"the run-length data ends before the last row"};
        const uint8_t* s = src + pos;
        uint8_t* o = out + int64_t(y) * width + x;
        for (int i = 0; i < count; ++i)
            o[i] = bits == 8 ? s[i] : ((i & 1) ? s[i >> 1] & 15 : s[i >> 1] >> 4);
        pos += size;
        x += count;
    }

    void rle8() {
        int line_end_flag = 0;
        for (;;) {
            const int len = byte(), code = byte();
            if (len) {
                const int prev_y = y;
                if (x + len > width) throw Corrupt{"a run past the end of its row"};
                fill(len, uint8_t(code));
                line_end_flag = y - prev_y;
                if (y >= height) break;
            } else if (code > 2) {
                absolute(code, 8);
                line_end_flag = 0;
            } else {
                int64_t xs = width - x, ys = height - y;
                if (code || !line_end_flag || xs < width) {
                    if (code == 2) {
                        xs = byte();
                        ys = byte();
                    }
                    if (code) xs += ys * width;
                    if (y >= height) break;
                    fill(xs, 0);
                    if (y >= height) break;
                }
                line_end_flag = 0;
                if (y >= height) break;
            }
        }
    }

    void rle4() {
        for (;;) {
            const int len = byte(), code = byte();
            if (len) {
                if (x + len > width) throw Corrupt{"a run past the end of its row"};
                uint8_t* o = out + int64_t(y) * width + x;
                for (int i = 0; i < len; ++i) o[i] = (i & 1) ? code & 15 : code >> 4;
                x += len;
            } else if (code > 2) {
                absolute(code, 4);
            } else {  // end of line, and end of bitmap too, fill to the row's end
                int64_t xs = width - x;
                if (code == 2) {  // a delta moves dx pixels on; its dy is read and ignored
                    xs = byte();
                    byte();
                }
                fill(xs, 0);
                if (y >= height) break;
            }
        }
    }
};

}  // namespace

extern "C" {

int32_t fmvfi_bmp_rle(const uint8_t* src, int64_t n, int32_t bits, int32_t width,
                      int32_t height, uint8_t* out, char* msg, int32_t msglen) {
    Rle r{src, n};
    r.width = width;
    r.height = height;
    r.out = out;
    try {
        if (bits == 8) r.rle8();
        else r.rle4();
    } catch (const Corrupt& e) {
        if (msg && msglen > 0) {
            std::strncpy(msg, e.what, size_t(msglen) - 1);
            msg[msglen - 1] = 0;
        }
        return CORRUPT;
    }
    return OK;
}

}  // extern "C"
