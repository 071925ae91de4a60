// fmvfi_tpu_torch native host runtime: a baseline JPEG decoder for
// fmvfi_tpu_torch/utils/imageio.py, bit-equal to libjpeg-turbo's defaults
// (what cv2.imread and PIL decode with).
//
// Supported: SOF0/SOF1 (baseline and extended sequential, Huffman coded),
// 8-bit samples, one component (grey) or three (YCbCr), sampling factors
// whose ratios to the largest are integers, interleaved and non-interleaved
// scans, DRI/RSTn restart intervals.  What libjpeg-turbo computes, and this
// file repeats:
//   - the ISLOW integer IDCT of jidctint.c (13-bit constants, two passes,
//     the post-IDCT range-limit table indexed by value & 1023);
//   - jdsample.c's fancy upsampling: h2v1 and h2v2 triangle filters (3/4
//     nearer + 1/4 further, rounding biases alternating 1/2 and 8/7), h1v2
//     the same vertically, each on the component's real samples with the
//     edge sample repeated; h2v1/h2v2 on a component 2 or fewer samples
//     wide, and every other integer ratio, replicate;
//   - jdcolor.c's fixed-point YCbCr -> RGB (16-bit tables, arithmetic
//     shifts, values clamped to 0-255).
// Progressive, lossless, hierarchical and arithmetic-coded files, 12-bit
// samples, two or four components (CMYK) and RGB-coded three-component
// files are refused as unsupported; malformed or truncated data as corrupt.
//
// Exposed C ABI (ctypes):
//   fmvfi_jpeg_header(data, n, info, msg, msglen) -> int32
//     info[0..2] = width, height, components.
//   fmvfi_jpeg_decode(data, n, out, msg, msglen) -> int32
//     out: height * width * 3 bytes, RGB (grey repeated to three channels).
//   Both return 0, 1 (unsupported: msg says what) or 2 (corrupt: msg says
//   where).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { OK = 0, UNSUPPORTED = 1, CORRUPT = 2 };

struct Error {
    int code;
    std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) { throw Error{code, msg}; }

const int kZigzag[64] = {  // jpeg_natural_order: zigzag index -> natural index
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63};

struct Huffman {
    bool defined = false;
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
    // codes of up to 9 bits in one lookup: (length << 8) | value, 0 if longer
    uint16_t look[1 << 9];
};

const int kLookBits = 9;

// jdhuff.c's jpeg_make_d_derived_tbl
void build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* vals, int nvals) {
    uint8_t huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
        for (int i = 0; i < counts[l - 1]; ++i) huffsize[p++] = static_cast<uint8_t>(l);
    huffsize[p] = 0;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) huffcode[p++] = code++;
        if (code >= (1u << si)) fail(CORRUPT, "a bad Huffman table");
        code <<= 1;
        ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
        if (counts[l - 1]) {
            t.valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
            p += counts[l - 1];
            t.maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
        } else {
            t.maxcode[l] = -1;
        }
    }
    t.valoffset[17] = 0;
    t.maxcode[17] = 0x7FFFFFFF;
    std::memcpy(t.vals, vals, nvals);
    std::memset(t.look, 0, sizeof(t.look));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
        for (int i = 0; i < counts[l - 1]; ++i, ++p) {
            const uint32_t base = huffcode[p] << (kLookBits - l);
            for (uint32_t j = 0; j < (1u << (kLookBits - l)); ++j)
                t.look[base + j] = static_cast<uint16_t>((l << 8) | vals[p]);
        }
    }
    t.defined = true;
}

// The entropy-coded segment's bits, with the 0xFF00 stuffing removed.  At a
// marker, or at the end of the data, zero bits are fed in; consuming one of
// them means the segment ended early.
struct BitReader {
    const uint8_t* d;
    size_t n;
    size_t pos;
    uint64_t buf = 0;
    int cnt = 0;        // valid bits, the low `cnt` bits of buf
    int pad = 0;        // zero bits fed in at the bottom of those
    bool stopped = false;  // at a marker or at the end of the data

    void reset(size_t at) {
        pos = at;
        buf = 0;
        cnt = pad = 0;
        stopped = false;
    }

    void fill() {
        while (cnt <= 56) {
            int byte = 0;
            if (!stopped) {
                if (pos >= n) {
                    stopped = true;
                } else if (d[pos] != 0xFF) {
                    byte = d[pos++];
                } else {
                    size_t q = pos + 1;
                    while (q < n && d[q] == 0xFF) ++q;  // fill bytes before a marker
                    if (q < n && d[q] == 0) {
                        byte = 0xFF;
                        pos = q + 1;
                    } else {
                        stopped = true;  // pos stays on the marker's first 0xFF
                    }
                }
            }
            buf = (buf << 8) | static_cast<uint64_t>(byte);
            cnt += 8;
            if (stopped) pad += 8;
        }
    }

    void consume(int bits) {
        cnt -= bits;
        if (cnt < pad) fail(CORRUPT, "the entropy-coded data ends early (truncated or corrupt)");
    }

    int peek(int bits) {
        if (cnt < bits) fill();
        return static_cast<int>((buf >> (cnt - bits)) & ((1u << bits) - 1));
    }

    int get(int bits) {
        if (bits == 0) return 0;
        const int v = peek(bits);
        consume(bits);
        return v;
    }

    int decode(const Huffman& t) {
        const int look = peek(kLookBits);
        const uint16_t e = t.look[look];
        if (e) {
            consume(e >> 8);
            return e & 0xFF;
        }
        int l = kLookBits + 1;
        int32_t code = peek(l);
        while (code > t.maxcode[l]) {
            if (++l > 16) fail(CORRUPT, "a bad Huffman code");
            code = peek(l);
        }
        consume(l);
        return t.vals[(code + t.valoffset[l]) & 0xFF];
    }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// jidctint.c
const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int32_t descale(int64_t x, int n) {
    return static_cast<int32_t>((x + (int64_t(1) << (n - 1))) >> n);
}

// the post-IDCT range limit of jdmaster.c: value & 1023 -> sample
struct RangeLimit {
    uint8_t t[1024];
    RangeLimit() {
        for (int i = 0; i < 1024; ++i) {
            if (i < 128) t[i] = static_cast<uint8_t>(i + 128);
            else if (i < 512) t[i] = 255;
            else if (i < 896) t[i] = 0;
            else t[i] = static_cast<uint8_t>(i - 896);
        }
    }
};
const RangeLimit kRange;

// one 8x8 block: coef in natural order, quant the table in natural order
void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out, int stride) {
    int32_t ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t* in = coef + c;
        const uint16_t* q = quant + c;
        int32_t* w = ws + c;
        if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
            const int32_t dc = (int32_t(in[0]) * q[0]) * (1 << PASS1_BITS);
            for (int r = 0; r < 8; ++r) w[8 * r] = dc;
            continue;
        }
        int64_t z2 = int32_t(in[16]) * q[16], z3 = int32_t(in[48]) * q[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = int32_t(in[0]) * q[0];
        z3 = int32_t(in[32]) * q[32];
        int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = int32_t(in[56]) * q[56];
        tmp1 = int32_t(in[40]) * q[40];
        tmp2 = int32_t(in[24]) * q[24];
        tmp3 = int32_t(in[8]) * q[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        const int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = CONST_BITS - PASS1_BITS;
        w[0] = descale(tmp10 + tmp3, n);
        w[56] = descale(tmp10 - tmp3, n);
        w[8] = descale(tmp11 + tmp2, n);
        w[48] = descale(tmp11 - tmp2, n);
        w[16] = descale(tmp12 + tmp1, n);
        w[40] = descale(tmp12 - tmp1, n);
        w[24] = descale(tmp13 + tmp0, n);
        w[32] = descale(tmp13 - tmp0, n);
    }
    for (int r = 0; r < 8; ++r) {
        const int32_t* w = ws + 8 * r;
        uint8_t* o = out + r * stride;
        const int n = CONST_BITS + PASS1_BITS + 3;
        if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
            const uint8_t v = kRange.t[descale(w[0], PASS1_BITS + 3) & 1023];
            for (int c = 0; c < 8; ++c) o[c] = v;
            continue;
        }
        int64_t z2 = w[2], z3 = w[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << CONST_BITS);
        int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << CONST_BITS);
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        const int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        o[0] = kRange.t[descale(tmp10 + tmp3, n) & 1023];
        o[7] = kRange.t[descale(tmp10 - tmp3, n) & 1023];
        o[1] = kRange.t[descale(tmp11 + tmp2, n) & 1023];
        o[6] = kRange.t[descale(tmp11 - tmp2, n) & 1023];
        o[2] = kRange.t[descale(tmp12 + tmp1, n) & 1023];
        o[5] = kRange.t[descale(tmp12 - tmp1, n) & 1023];
        o[3] = kRange.t[descale(tmp13 + tmp0, n) & 1023];
        o[4] = kRange.t[descale(tmp13 - tmp0, n) & 1023];
    }
}

struct Component {
    int id, h, v, tq;
    int w_real, h_real;    // downsampled_width / _height: ceil(size * samp / max)
    int bw, bh;            // blocks per row and column in the plane
    std::vector<uint8_t> plane;  // bh*8 rows of bw*8 samples
    int16_t dc_pred = 0;
    int td = 0, ta = 0;
    bool scanned = false;
};

struct Decoder {
    const uint8_t* d;
    size_t n;
    size_t pos = 2;
    int width = 0, height = 0, ncomp = 0;
    int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    int restart = 0;
    bool jfif = false, adobe = false;
    int adobe_transform = -1;
    std::vector<Component> comps;
    uint16_t quant[4][64];
    bool quant_defined[4] = {false, false, false, false};
    Huffman dc[4], ac[4];

    Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

    int u16(size_t at) const {
        if (at + 2 > n) fail(CORRUPT, "truncated in a marker segment");
        return (d[at] << 8) | d[at + 1];
    }

    // the next marker from pos, skipping fill 0xFFs; pos ends past it
    int next_marker() {
        while (pos < n && d[pos] != 0xFF) ++pos;  // garbage before a marker
        while (pos < n && d[pos] == 0xFF) ++pos;
        if (pos >= n) fail(CORRUPT, "truncated: no EOI marker");
        return d[pos++];
    }

    void read_sof(int marker, size_t at, int len) {
        if (marker != 0xC0 && marker != 0xC1) {
            char buf[160];
            const char* kind = marker == 0xC2   ? "progressive"
                               : marker == 0xC3 ? "lossless"
                               : (marker >= 0xC9 && marker != 0xCC) ? "arithmetic-coded"
                                                                    : "hierarchical";
            std::snprintf(buf, sizeof(buf), "SOF%d (%s) JPEG; only baseline and extended "
                          "sequential Huffman (SOF0, SOF1) are supported", marker - 0xC0, kind);
            fail(UNSUPPORTED, buf);
        }
        if (len < 8) fail(CORRUPT, "a short SOF segment");
        const int precision = d[at];
        height = u16(at + 1);
        width = u16(at + 3);
        ncomp = d[at + 5];
        if (precision != 8) fail(UNSUPPORTED, std::to_string(precision) + "-bit samples");
        if (ncomp != 1 && ncomp != 3)
            fail(UNSUPPORTED, std::to_string(ncomp) + " components (only grey and YCbCr)");
        if (len < 6 + 3 * ncomp) fail(CORRUPT, "a short SOF segment");
        if (width == 0 || height == 0)
            fail(UNSUPPORTED, "a zero width or height (DNL) in the SOF segment");
        comps.resize(ncomp);
        for (int i = 0; i < ncomp; ++i) {
            Component& c = comps[i];
            c.id = d[at + 6 + 3 * i];
            c.h = d[at + 7 + 3 * i] >> 4;
            c.v = d[at + 7 + 3 * i] & 15;
            c.tq = d[at + 8 + 3 * i];
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
                fail(CORRUPT, "bad sampling factors or quantization table in SOF");
            hmax = c.h > hmax ? c.h : hmax;
            vmax = c.v > vmax ? c.v : vmax;
        }
    }

    void read_dht(size_t at, int len) {
        size_t p = at, end = at + len;
        while (p < end) {
            if (p + 17 > end) fail(CORRUPT, "a short DHT segment");
            const int tc = d[p] >> 4, th = d[p] & 15;
            if (tc > 1 || th > 3) fail(CORRUPT, "a bad DHT table id");
            int total = 0;
            for (int i = 0; i < 16; ++i) total += d[p + 1 + i];
            if (total > 256 || p + 17 + total > end) fail(CORRUPT, "a bad DHT segment");
            build_huffman(tc ? ac[th] : dc[th], d + p + 1, d + p + 17, total);
            p += 17 + total;
        }
    }

    void read_dqt(size_t at, int len) {
        size_t p = at, end = at + len;
        while (p < end) {
            const int pq = d[p] >> 4, tq = d[p] & 15;
            if (pq > 1 || tq > 3) fail(CORRUPT, "a bad DQT table id");
            if (p + 1 + 64 * (pq + 1) > end) fail(CORRUPT, "a short DQT segment");
            for (int k = 0; k < 64; ++k)
                quant[tq][kZigzag[k]] = static_cast<uint16_t>(
                    pq ? (d[p + 1 + 2 * k] << 8) | d[p + 2 + 2 * k] : d[p + 1 + k]);
            quant_defined[tq] = true;
            p += 1 + 64 * (pq + 1);
        }
    }

    void read_app(int marker, size_t at, int len) {
        if (marker == 0xE0 && len >= 5 && std::memcmp(d + at, "JFIF\0", 5) == 0) jfif = true;
        if (marker == 0xEE && len >= 12 && std::memcmp(d + at, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = d[at + 11];
        }
    }

    // markers up to the first SOS (or, header_only, up to the SOF); returns
    // the marker it stopped at
    int read_markers(bool header_only) {
        for (;;) {
            const int m = next_marker();
            if (m == 0xD9) return m;
            if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // TEM, a stray RSTn
            const int len = u16(pos) - 2;
            if (len < 0 || pos + 2 + len > n) fail(CORRUPT, "truncated in a marker segment");
            const size_t at = pos + 2;
            if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
                if (!comps.empty()) fail(CORRUPT, "two SOF markers");
                read_sof(m, at, len);
                pos = at + len;
                if (header_only) return m;
                continue;
            }
            if (m == 0xDA) return m;  // pos on the SOS segment's length
            if (m == 0xC4) read_dht(at, len);
            else if (m == 0xCC) fail(UNSUPPORTED, "a DAC marker (arithmetic coding)");
            else if (m == 0xDB) read_dqt(at, len);
            else if (m == 0xDD) {
                if (len < 2) fail(CORRUPT, "a short DRI segment");
                restart = u16(at);
            } else if (m >= 0xE0 && m <= 0xEF) read_app(m, at, len);
            pos = at + len;
        }
    }

    void header() {
        if (n < 3 || d[0] != 0xFF || d[1] != 0xD8) fail(CORRUPT, "not a JPEG file (no SOI)");
        const int m = read_markers(true);
        if (comps.empty()) fail(CORRUPT, m == 0xD9 ? "no SOF before EOI" : "no SOF before SOS");
    }

    void setup() {
        if (ncomp == 3) {
            const bool rgb_ids = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
            if ((adobe && adobe_transform == 0) || (!jfif && !adobe && rgb_ids))
                fail(UNSUPPORTED, "an RGB-coded (not YCbCr) three-component JPEG");
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (Component& c : comps) {
            if (hmax % c.h || vmax % c.v)
                fail(UNSUPPORTED, "sampling factors whose ratios are not integers");
            c.w_real = static_cast<int>((int64_t(width) * c.h + hmax - 1) / hmax);
            c.h_real = static_cast<int>((int64_t(height) * c.v + vmax - 1) / vmax);
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.plane.assign(size_t(c.bw) * 8 * size_t(c.bh) * 8, 0);
        }
    }

    void decode_block(BitReader& br, Component& c, int by, int bx) {
        const Huffman& hd = dc[c.td];
        const Huffman& ha = ac[c.ta];
        int16_t coef[64] = {0};
        const int s = br.decode(hd);
        if (s > 11) fail(CORRUPT, "a bad DC coefficient");
        const int diff = s ? extend(br.get(s), s) : 0;
        c.dc_pred = static_cast<int16_t>(c.dc_pred + diff);
        coef[0] = c.dc_pred;
        for (int k = 1; k < 64; ++k) {
            const int rs = br.decode(ha);
            const int r = rs >> 4, sz = rs & 15;
            if (sz) {
                k += r;
                if (k > 63) fail(CORRUPT, "an AC run past the block");
                coef[kZigzag[k]] = static_cast<int16_t>(extend(br.get(sz), sz));
            } else if (r == 15) {
                k += 15;
            } else {
                break;
            }
        }
        const size_t stride = size_t(c.bw) * 8;
        idct_islow(coef, quant[c.tq], c.plane.data() + size_t(by) * 8 * stride + size_t(bx) * 8,
                   static_cast<int>(stride));
    }

    // pos at the SOS segment's length; returns with pos past the scan
    void read_scan() {
        const int len = u16(pos) - 2;
        const size_t at = pos + 2;
        if (len < 1 || at + len > n) fail(CORRUPT, "a bad SOS segment");
        const int ns = d[at];
        if (ns < 1 || ns > 4 || len < 4 + 2 * ns) fail(CORRUPT, "a bad SOS segment");
        std::vector<Component*> sc;
        for (int i = 0; i < ns; ++i) {
            const int id = d[at + 1 + 2 * i];
            Component* found = nullptr;
            for (Component& c : comps)
                if (c.id == id) found = &c;
            if (!found) fail(CORRUPT, "SOS names a component the SOF does not have");
            found->td = d[at + 2 + 2 * i] >> 4;
            found->ta = d[at + 2 + 2 * i] & 15;
            if (found->td > 3 || found->ta > 3 || !dc[found->td].defined ||
                !ac[found->ta].defined)
                fail(CORRUPT, "SOS uses an undefined Huffman table");
            if (!quant_defined[found->tq])
                fail(CORRUPT, "a component's quantization table is undefined");
            found->scanned = true;
            found->dc_pred = 0;
            sc.push_back(found);
        }
        const int ss = d[at + 1 + 2 * ns], se = d[at + 2 + 2 * ns], ahal = d[at + 3 + 2 * ns];
        if (ss != 0 || se != 63 || ahal != 0) fail(CORRUPT, "a sequential scan with Ss/Se/Ah/Al "
                                                   "other than 0/63/0/0");
        BitReader br{d, n, at + len};
        int units_x, units_y;
        if (ns == 1) {  // non-interleaved: one block per MCU, the component's real blocks
            units_x = (sc[0]->w_real + 7) / 8;
            units_y = (sc[0]->h_real + 7) / 8;
        } else {
            units_x = mcux;
            units_y = mcuy;
        }
        const int64_t total = int64_t(units_x) * units_y;
        int rst = 0;
        for (int64_t u = 0; u < total; ++u) {
            if (restart && u && u % restart == 0) {
                pos = br.pos;
                const int m = next_marker();
                if (m != 0xD0 + (rst & 7)) fail(CORRUPT, "a missing or out-of-order RST marker");
                ++rst;
                br.reset(pos);
                for (Component* c : sc) c->dc_pred = 0;
            }
            const int uy = static_cast<int>(u / units_x), ux = static_cast<int>(u % units_x);
            if (ns == 1) {
                decode_block(br, *sc[0], uy, ux);
            } else {
                for (Component* c : sc)
                    for (int v = 0; v < c->v; ++v)
                        for (int h = 0; h < c->h; ++h)
                            decode_block(br, *c, uy * c->v + v, ux * c->h + h);
            }
        }
        pos = br.pos;
    }

    void decode(uint8_t* out) {
        header();
        setup();
        for (;;) {
            const int m = read_markers(false);
            if (m == 0xD9) break;
            read_scan();
        }
        for (const Component& c : comps)
            if (!c.scanned) fail(CORRUPT, "a component without a scan");
        std::vector<std::vector<uint8_t>> full(ncomp);
        for (int i = 0; i < ncomp; ++i) full[i] = upsample(comps[i]);
        const size_t npx = size_t(width) * height;
        if (ncomp == 1) {
            for (size_t p = 0; p < npx; ++p) out[3 * p] = out[3 * p + 1] = out[3 * p + 2] = full[0][p];
            return;
        }
        ycc_to_rgb(full[0].data(), full[1].data(), full[2].data(), out, npx);
    }

    // the component at full size, width x height (jdsample.c)
    std::vector<uint8_t> upsample(const Component& c) const {
        const int rx = hmax / c.h, ry = vmax / c.v;
        const int cw = c.w_real, ch = c.h_real;
        const size_t stride = size_t(c.bw) * 8;
        auto at = [&](int y, int x) -> int {
            y = y < 0 ? 0 : (y >= ch ? ch - 1 : y);
            x = x < 0 ? 0 : (x >= cw ? cw - 1 : x);
            return c.plane[size_t(y) * stride + x];
        };
        const int ow = cw * rx, oh = ch * ry;  // >= width, height
        std::vector<uint8_t> up(size_t(ow) * oh);
        const bool fancy_h2 = rx == 2 && cw > 2;
        if (rx == 1 && ry == 1) {
            for (int y = 0; y < oh; ++y)
                std::memcpy(&up[size_t(y) * ow], &c.plane[size_t(y) * stride], ow);
        } else if (rx == 2 && ry == 1 && fancy_h2) {  // h2v1_fancy_upsample
            for (int y = 0; y < ch; ++y)
                for (int x = 0; x < cw; ++x) {
                    const int s3 = at(y, x) * 3;
                    up[size_t(y) * ow + 2 * x] = static_cast<uint8_t>((s3 + at(y, x - 1) + 1) >> 2);
                    up[size_t(y) * ow + 2 * x + 1] = static_cast<uint8_t>((s3 + at(y, x + 1) + 2) >> 2);
                }
        } else if (rx == 1 && ry == 2) {  // h1v2_fancy_upsample
            for (int y = 0; y < ch; ++y)
                for (int x = 0; x < cw; ++x) {
                    const int s3 = at(y, x) * 3;
                    up[size_t(2 * y) * ow + x] = static_cast<uint8_t>((s3 + at(y - 1, x) + 1) >> 2);
                    up[size_t(2 * y + 1) * ow + x] = static_cast<uint8_t>((s3 + at(y + 1, x) + 2) >> 2);
                }
        } else if (rx == 2 && ry == 2 && fancy_h2) {  // h2v2_fancy_upsample
            std::vector<int> cs(cw + 2);
            for (int y = 0; y < oh; ++y) {
                const int r = y >> 1, other = (y & 1) ? r + 1 : r - 1;
                for (int x = 0; x < cw; ++x) cs[x + 1] = at(r, x) * 3 + at(other, x);
                cs[0] = cs[1];
                cs[cw + 1] = cs[cw];
                uint8_t* o = &up[size_t(y) * ow];
                for (int x = 0; x < cw; ++x) {
                    o[2 * x] = static_cast<uint8_t>((cs[x + 1] * 3 + cs[x] + 8) >> 4);
                    o[2 * x + 1] = static_cast<uint8_t>((cs[x + 1] * 3 + cs[x + 2] + 7) >> 4);
                }
            }
        } else {  // h2v1/h2v2 on a narrow component, int_upsample: replicate
            for (int y = 0; y < oh; ++y)
                for (int x = 0; x < ow; ++x) up[size_t(y) * ow + x] = static_cast<uint8_t>(at(y / ry, x / rx));
        }
        std::vector<uint8_t> cropped(size_t(width) * height);
        for (int y = 0; y < height; ++y)
            std::memcpy(&cropped[size_t(y) * width], &up[size_t(y) * ow], width);
        return cropped;
    }

    // jdcolor.c's ycc_rgb_convert
    static void ycc_to_rgb(const uint8_t* yp, const uint8_t* cbp, const uint8_t* crp,
                           uint8_t* out, size_t npx) {
        const int SCALEBITS = 16;
        const int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
        auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
        int cr_r[256], cb_b[256];
        int64_t cr_g[256], cb_g[256];
        for (int i = 0; i < 256; ++i) {
            const int64_t x = i - 128;
            cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
            cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + ONE_HALF;
        }
        auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
        for (size_t p = 0; p < npx; ++p) {
            const int y = yp[p], cb = cbp[p], cr = crp[p];
            out[3 * p] = clamp(y + cr_r[cr]);
            out[3 * p + 1] = clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
            out[3 * p + 2] = clamp(y + cb_b[cb]);
        }
    }
};

int32_t report(const Error& e, char* msg, int32_t msglen) {
    if (msg && msglen > 0) {
        std::strncpy(msg, e.msg.c_str(), size_t(msglen) - 1);
        msg[msglen - 1] = 0;
    }
    return e.code;
}

}  // namespace

extern "C" {

int32_t fmvfi_jpeg_header(const uint8_t* data, int64_t n, int32_t* info, char* msg,
                          int32_t msglen) {
    try {
        Decoder dec(data, static_cast<size_t>(n));
        dec.header();
        info[0] = dec.width;
        info[1] = dec.height;
        info[2] = dec.ncomp;
        return OK;
    } catch (const Error& e) {
        return report(e, msg, msglen);
    } catch (const std::bad_alloc&) {
        return report(Error{CORRUPT, "out of memory"}, msg, msglen);
    }
}

int32_t fmvfi_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, char* msg,
                          int32_t msglen) {
    try {
        Decoder dec(data, static_cast<size_t>(n));
        dec.decode(out);
        return OK;
    } catch (const Error& e) {
        return report(e, msg, msglen);
    } catch (const std::bad_alloc&) {
        return report(Error{CORRUPT, "out of memory"}, msg, msglen);
    }
}

}  // extern "C"
