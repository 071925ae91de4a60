// fmvfi_tpu_torch native host runtime: a baseline JPEG encoder for
// fmvfi_tpu_torch/utils/imageio.py, byte-equal to libjpeg-turbo at the
// settings cv2.imwrite uses by default (and PIL's Image.save at the same
// quality): JFIF 1.01 with density 1:1, quality scaling of the Annex K
// tables (clamped to 1-255, baseline), 4:2:0 chroma (one 1x1 component for
// grey), the standard Huffman tables, no optimisation, not progressive, no
// restart markers.  What libjpeg-turbo computes, and this file repeats:
//   - jccolor.c's fixed-point RGB -> YCbCr (SCALEBITS 16, the tables'
//     rounding terms folded into the B->Y and B->Cb / R->Cr entries);
//   - jcprep.c / jcsample.c's edges: rows repeated to an even count, then
//     h2v2_downsample (2x2 means, bias alternating 1, 2 along a row) over
//     columns repeated to whole MCUs; each plane's last row repeated to
//     whole iMCU rows, its last column to whole blocks;
//   - jfdctint.c's ISLOW forward DCT (CONST_BITS 13, PASS1_BITS 2, outputs
//     scaled up by 8) on samples less 128;
//   - jcdctmgr.c's quantisation, (|c| + q*4) / (q*8) with the sign put
//     back;
//   - jccoefct.c's dummy blocks past the right and bottom edges of an MCU:
//     zero, with the DC of the block before;
//   - jchuff.c's coding with 0xFF00 stuffing and the last byte padded with
//     1-bits.
//
// Exposed C ABI (ctypes):
//   fmvfi_jpeg_encode(pixels, height, width, channels, quality, out, cap)
//     -> int64: pixels are height * width * channels bytes (RGB, or grey
//     with channels 1); the file's length when it fits in `cap` bytes of
//     `out`, else minus the length needed; 0 for bad arguments.

#include <cstdint>
#include <cstring>
#include <vector>

#include "jpeg_common.h"

namespace {

using namespace fmvfi_jpeg;

// ITU T.81 Annex K.1, natural order
const int kLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

struct HuffTable {
    const uint8_t* bits;
    const uint8_t* vals;
    int nvals;
    uint32_t code[256];
    uint8_t size[256];

    HuffTable(const uint8_t* b, const uint8_t* v, int n) : bits(b), vals(v), nvals(n) {
        std::memset(size, 0, sizeof(size));
        uint32_t c = 0;
        int p = 0;
        for (int len = 1; len <= 16; ++len) {  // jchuff.c's jpeg_make_c_derived_tbl
            for (int i = 0; i < bits[len - 1]; ++i, ++p) {
                code[vals[p]] = c++;
                size[vals[p]] = static_cast<uint8_t>(len);
            }
            c <<= 1;
        }
    }
};

// jcparam.c's jpeg_quality_scaling and jpeg_add_quant_table (force_baseline)
void quant_table(const int* base, int quality, int* out) {
    if (quality < 1) quality = 1;
    if (quality > 100) quality = 100;
    const long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int i = 0; i < 64; ++i) {
        long q = (base[i] * scale + 50) / 100;
        out[i] = static_cast<int>(q < 1 ? 1 : (q > 255 ? 255 : q));
    }
}

// jfdctint.c's jpeg_fdct_islow, in place on 64 level-shifted samples
void fdct_islow(int32_t* d) {
    const int CONST_BITS = 13, PASS1_BITS = 2;
    const int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373,
                  F1_175 = 9633, F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                  F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
    auto descale = [](int64_t x, int n) {
        return static_cast<int32_t>((x + (int64_t(1) << (n - 1))) >> n);
    };
    for (int pass = 0; pass < 2; ++pass) {
        const int step = pass == 0 ? 1 : 8;   // along a row, then down a column
        const int stride = pass == 0 ? 8 : 1;
        const int shift = pass == 0 ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;
        for (int r = 0; r < 8; ++r) {
            int32_t* p = d + r * stride;
            const int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
            const int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
            const int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
            const int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
            const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            if (pass == 0) {
                p[0] = static_cast<int32_t>((tmp10 + tmp11) << PASS1_BITS);
                p[4 * step] = static_cast<int32_t>((tmp10 - tmp11) << PASS1_BITS);
            } else {
                p[0] = descale(tmp10 + tmp11, PASS1_BITS);
                p[4 * step] = descale(tmp10 - tmp11, PASS1_BITS);
            }
            int64_t z1 = (tmp12 + tmp13) * F0_541;
            p[2 * step] = descale(z1 + tmp13 * F0_765, shift);
            p[6 * step] = descale(z1 - tmp12 * F1_847, shift);
            z1 = tmp4 + tmp7;
            int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
            const int64_t z5 = (z3 + z4) * F1_175;
            const int64_t t4 = tmp4 * F0_298, t5 = tmp5 * F2_053, t6 = tmp6 * F3_072,
                          t7 = tmp7 * F1_501;
            z1 *= -F0_899;
            z2 *= -F2_562;
            z3 = z3 * -F1_961 + z5;
            z4 = z4 * -F0_390 + z5;
            p[7 * step] = descale(t4 + z1 + z3, shift);
            p[5 * step] = descale(t5 + z2 + z4, shift);
            p[3 * step] = descale(t6 + z2 + z3, shift);
            p[step] = descale(t7 + z1 + z4, shift);
        }
    }
}

class BitWriter {
  public:
    explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}

    void put(uint32_t code, int size) {
        acc_ = (acc_ << size) | (code & ((1u << size) - 1));
        nbits_ += size;
        while (nbits_ >= 8) {
            const uint8_t byte = static_cast<uint8_t>(acc_ >> (nbits_ - 8));
            out_.push_back(byte);
            if (byte == 0xFF) out_.push_back(0);
            nbits_ -= 8;
        }
        acc_ &= (uint64_t(1) << nbits_) - 1;
    }

    void flush() { put(0x7F, 7); }  // jchuff.c's flush_bits: 1-bits to a whole byte

  private:
    std::vector<uint8_t>& out_;
    uint64_t acc_ = 0;
    int nbits_ = 0;
};

struct Plane {
    int width = 0, height = 0;  // padded to whole blocks of its iMCU rows
    std::vector<uint8_t> px;
};

// one component's samples, padded as jcprep.c and jcsample.c pad them
Plane full_plane(const std::vector<uint8_t>& src, int w, int h, int bw, int bh) {
    Plane p;
    p.width = bw * 8;
    p.height = bh * 8;
    p.px.resize(size_t(p.width) * p.height);
    for (int y = 0; y < p.height; ++y) {
        const uint8_t* row = &src[size_t(y < h ? y : h - 1) * w];
        uint8_t* dst = &p.px[size_t(y) * p.width];
        std::memcpy(dst, row, w);
        std::memset(dst + w, row[w - 1], p.width - w);
    }
    return p;
}

Plane h2v2_plane(const std::vector<uint8_t>& src, int w, int h, int bw, int bh) {
    Plane p;
    p.width = bw * 8;
    p.height = bh * 8;
    p.px.resize(size_t(p.width) * p.height);
    const int rows = (h + 1) / 2;  // downsampled rows from real (even-padded) input
    for (int oy = 0; oy < p.height; ++oy) {
        const int sy = oy < rows ? oy : rows - 1;
        const int y0 = 2 * sy < h ? 2 * sy : h - 1;
        const int y1 = 2 * sy + 1 < h ? 2 * sy + 1 : h - 1;
        const uint8_t* r0 = &src[size_t(y0) * w];
        const uint8_t* r1 = &src[size_t(y1) * w];
        int bias = 1;
        for (int ox = 0; ox < p.width; ++ox) {
            const int x0 = 2 * ox < w ? 2 * ox : w - 1;
            const int x1 = 2 * ox + 1 < w ? 2 * ox + 1 : w - 1;
            p.px[size_t(oy) * p.width + ox] =
                static_cast<uint8_t>((r0[x0] + r0[x1] + r1[x0] + r1[x1] + bias) >> 2);
            bias ^= 3;
        }
    }
    return p;
}

void put_u16(std::vector<uint8_t>& o, int v) {
    o.push_back(static_cast<uint8_t>(v >> 8));
    o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void put_dht(std::vector<uint8_t>& o, int cls_id, const HuffTable& t) {
    o.push_back(0xFF);
    o.push_back(0xC4);
    put_u16(o, 2 + 1 + 16 + t.nvals);
    o.push_back(static_cast<uint8_t>(cls_id));
    o.insert(o.end(), t.bits, t.bits + 16);
    o.insert(o.end(), t.vals, t.vals + t.nvals);
}

std::vector<uint8_t> encode(const uint8_t* pixels, int h, int w, int channels, int quality) {
    const bool color = channels == 3;
    const int ncomp = color ? 3 : 1;
    int qt[2][64];
    quant_table(kLumaQ, quality, qt[0]);
    quant_table(kChromaQ, quality, qt[1]);
    const HuffTable dc[2] = {HuffTable(kDcLumaBits, kDcVals, 12),
                             HuffTable(kDcChromaBits, kDcVals, 12)};
    const HuffTable ac[2] = {HuffTable(kAcLumaBits, kAcLumaVals, 162),
                             HuffTable(kAcChromaBits, kAcChromaVals, 162)};

    // jccolor.c's rgb_ycc_convert (grey passes through)
    const size_t npx = size_t(h) * w;
    std::vector<uint8_t> comp[3];
    if (color) {
        const int32_t SCALEBITS = 16, ONE_HALF = 1 << (SCALEBITS - 1),
                      CBCR_OFFSET = 128 << SCALEBITS;
        auto fix = [](double x) { return static_cast<int32_t>(x * 65536.0 + 0.5); };
        int32_t ry[256], gy[256], by[256], rcb[256], gcb[256], bcb[256], gcr[256], bcr[256];
        for (int i = 0; i < 256; ++i) {
            ry[i] = fix(0.29900) * i;
            gy[i] = fix(0.58700) * i;
            by[i] = fix(0.11400) * i + ONE_HALF;
            rcb[i] = -fix(0.16874) * i;
            gcb[i] = -fix(0.33126) * i;
            bcb[i] = fix(0.50000) * i + CBCR_OFFSET + ONE_HALF - 1;  // also R -> Cr
            gcr[i] = -fix(0.41869) * i;
            bcr[i] = -fix(0.08131) * i;
        }
        for (auto& c : comp) c.resize(npx);
        for (size_t p = 0; p < npx; ++p) {
            const int r = pixels[3 * p], g = pixels[3 * p + 1], b = pixels[3 * p + 2];
            comp[0][p] = static_cast<uint8_t>((ry[r] + gy[g] + by[b]) >> SCALEBITS);
            comp[1][p] = static_cast<uint8_t>((rcb[r] + gcb[g] + bcb[b]) >> SCALEBITS);
            comp[2][p] = static_cast<uint8_t>((bcb[r] + gcr[g] + bcr[b]) >> SCALEBITS);
        }
    } else {
        comp[0].assign(pixels, pixels + npx);
    }

    // MCU geometry: 16x16 with Y at 2x2 (colour), 8x8 (grey)
    const int mcu = color ? 16 : 8;
    const int mcus_x = (w + mcu - 1) / mcu, mcus_y = (h + mcu - 1) / mcu;
    const int ybw = (w + 7) / 8, ybh = (h + 7) / 8;  // Y's real blocks
    Plane planes[3];
    planes[0] = full_plane(comp[0], w, h, ybw, color ? mcus_y * 2 : ybh);
    if (color)
        for (int c = 1; c < 3; ++c) planes[c] = h2v2_plane(comp[c], w, h, mcus_x, mcus_y);

    std::vector<uint8_t> o;
    o.reserve(1024 + npx);
    const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                            0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
    o.insert(o.end(), head, head + sizeof(head));
    for (int t = 0; t < (color ? 2 : 1); ++t) {
        o.push_back(0xFF);
        o.push_back(0xDB);
        put_u16(o, 67);
        o.push_back(static_cast<uint8_t>(t));
        for (int i = 0; i < 64; ++i) o.push_back(static_cast<uint8_t>(qt[t][kNatural[i]]));
    }
    o.push_back(0xFF);
    o.push_back(0xC0);
    put_u16(o, 8 + 3 * ncomp);
    o.push_back(8);
    put_u16(o, h);
    put_u16(o, w);
    o.push_back(static_cast<uint8_t>(ncomp));
    for (int c = 0; c < ncomp; ++c) {
        o.push_back(static_cast<uint8_t>(c + 1));
        o.push_back(color && c == 0 ? 0x22 : 0x11);
        o.push_back(c == 0 ? 0 : 1);
    }
    for (int t = 0; t < (color ? 2 : 1); ++t) {
        put_dht(o, t, dc[t]);
        put_dht(o, 0x10 | t, ac[t]);
    }
    o.push_back(0xFF);
    o.push_back(0xDA);
    put_u16(o, 6 + 2 * ncomp);
    o.push_back(static_cast<uint8_t>(ncomp));
    for (int c = 0; c < ncomp; ++c) {
        o.push_back(static_cast<uint8_t>(c + 1));
        o.push_back(c == 0 ? 0x00 : 0x11);
    }
    o.push_back(0);
    o.push_back(63);
    o.push_back(0);

    BitWriter bw(o);
    int last_dc[3] = {0, 0, 0};
    int32_t work[64];
    int coef[64];

    auto emit_block = [&](int c, const int* blk) {
        const int t = c == 0 ? 0 : 1;
        int temp = blk[0] - last_dc[c];
        last_dc[c] = blk[0];
        int temp2 = temp;
        if (temp < 0) {
            temp = -temp;
            --temp2;
        }
        int nbits = 0;
        while (temp) {
            ++nbits;
            temp >>= 1;
        }
        bw.put(dc[t].code[nbits], dc[t].size[nbits]);
        if (nbits) bw.put(static_cast<uint32_t>(temp2), nbits);
        int run = 0;
        for (int k = 1; k < 64; ++k) {
            temp = blk[kNatural[k]];
            if (temp == 0) {
                ++run;
                continue;
            }
            while (run > 15) {
                bw.put(ac[t].code[0xF0], ac[t].size[0xF0]);
                run -= 16;
            }
            temp2 = temp;
            if (temp < 0) {
                temp = -temp;
                --temp2;
            }
            nbits = 0;
            while (temp) {
                ++nbits;
                temp >>= 1;
            }
            const int sym = (run << 4) + nbits;
            bw.put(ac[t].code[sym], ac[t].size[sym]);
            bw.put(static_cast<uint32_t>(temp2), nbits);
            run = 0;
        }
        if (run > 0) bw.put(ac[t].code[0], ac[t].size[0]);
    };

    // forward DCT and quantisation of the block at (bx, by) of plane c
    auto make_block = [&](int c, int bx, int by, int* out) {
        const Plane& p = planes[c];
        for (int y = 0; y < 8; ++y)
            for (int x = 0; x < 8; ++x)
                work[y * 8 + x] = int32_t(p.px[size_t(by * 8 + y) * p.width + bx * 8 + x]) - 128;
        fdct_islow(work);
        const int* q = qt[c == 0 ? 0 : 1];
        for (int i = 0; i < 64; ++i) {
            const int qval = q[i] << 3;
            int v = work[i];
            if (v < 0) {
                v = -v + (qval >> 1);
                v = v >= qval ? v / qval : 0;
                v = -v;
            } else {
                v += qval >> 1;
                v = v >= qval ? v / qval : 0;
            }
            out[i] = v;
        }
    };

    const int vs = color ? 2 : 1;
    for (int my = 0; my < mcus_y; ++my) {
        for (int mx = 0; mx < mcus_x; ++mx) {
            // Y: vs x vs blocks; a block past the real ones is a dummy
            int prev_dc = 0;
            for (int yy = 0; yy < vs; ++yy) {
                for (int xx = 0; xx < vs; ++xx) {
                    const int bx = mx * vs + xx, by = my * vs + yy;
                    if (by < ybh && bx < ybw) {
                        make_block(0, bx, by, coef);
                    } else {
                        std::memset(coef, 0, sizeof(coef));
                        coef[0] = prev_dc;
                    }
                    prev_dc = coef[0];
                    emit_block(0, coef);
                }
            }
            for (int c = 1; c < ncomp; ++c) {
                make_block(c, mx, my, coef);
                emit_block(c, coef);
            }
        }
    }
    bw.flush();
    o.push_back(0xFF);
    o.push_back(0xD9);
    return o;
}

}  // namespace

extern "C" {

int64_t fmvfi_jpeg_encode(const uint8_t* pixels, int32_t height, int32_t width,
                          int32_t channels, int32_t quality, uint8_t* out, int64_t cap) {
    if (height < 1 || width < 1 || height > 65535 || width > 65535 ||
        (channels != 1 && channels != 3))
        return 0;
    try {
        const std::vector<uint8_t> file = encode(pixels, height, width, channels, quality);
        const int64_t n = static_cast<int64_t>(file.size());
        if (n > cap) return -n;
        std::memcpy(out, file.data(), file.size());
        return n;
    } catch (const std::bad_alloc&) {
        return 0;
    }
}

}  // extern "C"
