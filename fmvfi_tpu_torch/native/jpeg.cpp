// fmvfi_tpu_torch native host runtime: a JPEG decoder for
// fmvfi_tpu_torch/utils/imageio.py, bit-equal to libjpeg-turbo's defaults
// (what cv2.imread and PIL decode with), and the entropy decoder that
// mjpeg.cpp shares.
//
// Supported: SOF0/SOF1 (baseline and extended sequential) and SOF2
// (progressive), Huffman coded, 8-bit samples, one component (grey) or
// three (YCbCr), sampling factors whose ratios to the largest are integers,
// interleaved and non-interleaved scans, DRI/RSTn restart intervals; a
// table a scan needs that no DHT segment defined is Annex K.3's, as
// libjpeg-turbo's jstdhuff.c supplies it.  Progressive scans: DC first and
// refinement, AC first (with end-of-band runs) and refinement, successive
// approximation, into a whole-image coefficient buffer.  What libjpeg-turbo
// computes, and this file repeats:
//   - the quantization table a component uses is the one defined when its
//     first scan starts (jdinput.c's latch_quant_tables);
//   - jdcoefct.c's block smoothing (do_block_smoothing, on by default): when
//     a progressive file leaves one of a component's first ten zigzag
//     coefficients short of its last bit, each block's still-zero
//     coefficients among them are estimated from the DC values of the 5x5
//     blocks around it (and, while no AC scan has come, the DC itself);
//   - the ISLOW integer IDCT of jidctint.c (13-bit constants, two passes,
//     the post-IDCT range-limit table indexed by value & 1023);
//   - jdsample.c's fancy upsampling: h2v1 and h2v2 triangle filters (3/4
//     nearer + 1/4 further, rounding biases alternating 1/2 and 8/7), h1v2
//     the same vertically, each on the component's real samples with the
//     edge sample repeated; h2v1/h2v2 on a component 2 or fewer samples
//     wide, and every other integer ratio, replicate;
//   - jdcolor.c's fixed-point YCbCr -> RGB (16-bit tables, arithmetic
//     shifts, values clamped to 0-255).
// Three components coded as RGB (jdapimin.c's choice: an Adobe marker's
// transform 0 without a JFIF marker, or the component ids 'R', 'G', 'B'
// without either marker) are copied as they decode; four components (CMYK,
// Adobe's inverted convention, as PIL and Photoshop write them) go through
// OpenCV's own CMYK -> BGR step (grfmt_jpeg.cpp's icvCvt_CMYK2BGR_8u_C4C3R:
// each channel k - ((255 - c) * k >> 8)).
// Lossless, hierarchical and arithmetic-coded files, 12-bit samples and
// YCCK (an Adobe transform other than 0 on four components) are refused as
// unsupported, each naming its SOF; two components (libjpeg's JCS_UNKNOWN,
// which cv2.imread reads no image of), malformed or truncated data as
// corrupt.  A JPEG-compressed TIFF's strips decode through
// fmvfi_jpeg_decode_strip, which hands the components on as libtiff asks
// libjpeg for them.
//
// Exposed C ABI (ctypes):
//   fmvfi_jpeg_header(data, n, info, msg, msglen) -> int32
//     info[0..2] = width, height, components.
//   fmvfi_jpeg_decode(data, n, out, msg, msglen) -> int32
//     out: height * width * 3 bytes, RGB (grey repeated to three channels).
//   fmvfi_jpeg_decode_strip(data, n, out, ycbcr, msg, msglen) -> int32
//     A JPEG-compressed TIFF's strip (its JPEGTables before it):
//     height * width * components bytes as they decode, or with ycbcr set
//     height * width * 3 bytes of RGB.
//   Both return 0, 1 (unsupported: msg says what) or 2 (corrupt: msg says
//   where).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "jpeg_common.h"

namespace fmvfi_jpeg {

namespace {

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

inline int16_t clip_int16(int64_t v) {
    return static_cast<int16_t>(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
}

struct Decoder {
    const uint8_t* d;
    size_t n;
    Image& img;
    Store store = Store::QUANTIZED;
    size_t pos = 2;
    int restart = 0;
    bool jfif = false, adobe = false;
    int adobe_transform = -1;
    uint16_t quant[4][64];
    bool quant_defined[4] = {false, false, false, false};
    Huffman dc[4], ac[4];

    Decoder(const uint8_t* data, size_t size, Image& image) : d(data), n(size), img(image) {}

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
        const int sof = marker - 0xC0;
        if (marker != 0xC0 && marker != 0xC1 && marker != 0xC2) {
            char buf[200];
            const char* kind = marker == 0xC3   ? "lossless"
                               : (marker >= 0xC9 && marker != 0xCC) ? "arithmetic-coded"
                                                                    : "hierarchical";
            std::snprintf(buf, sizeof(buf), "SOF%d (%s) JPEG; only baseline, extended "
                          "sequential and progressive Huffman (SOF0, SOF1, SOF2) are "
                          "supported", sof, kind);
            fail(UNSUPPORTED, buf);
        }
        if (len < 8) fail(CORRUPT, "a short SOF segment");
        const int precision = d[at];
        img.height = u16(at + 1);
        img.width = u16(at + 3);
        img.ncomp = d[at + 5];
        img.progressive = marker == 0xC2;
        if (precision != 8)
            fail(UNSUPPORTED, "SOF" + std::to_string(sof) + " JPEG with " +
                                  std::to_string(precision) + "-bit samples (only 8-bit)");
        if (img.ncomp < 1 || img.ncomp > 4)
            fail(UNSUPPORTED, "SOF" + std::to_string(sof) + " JPEG with " +
                                  std::to_string(img.ncomp) + " components (only 1 to 4)");
        if (len < 6 + 3 * img.ncomp) fail(CORRUPT, "a short SOF segment");
        if (img.width == 0 || img.height == 0)
            fail(UNSUPPORTED, "a zero width or height (DNL) in the SOF segment");
        img.comps.resize(img.ncomp);
        for (int i = 0; i < img.ncomp; ++i) {
            Component& c = img.comps[i];
            c.id = d[at + 6 + 3 * i];
            c.h = d[at + 7 + 3 * i] >> 4;
            c.v = d[at + 7 + 3 * i] & 15;
            c.tq = d[at + 8 + 3 * i];
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
                fail(CORRUPT, "bad sampling factors or quantization table in SOF");
            img.hmax = c.h > img.hmax ? c.h : img.hmax;
            img.vmax = c.v > img.vmax ? c.v : img.vmax;
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
                quant[tq][kNatural[k]] = static_cast<uint16_t>(
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
                if (!img.comps.empty()) fail(CORRUPT, "two SOF markers");
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

    // the SOF, then the markers up to the first scan (pos left on its SOS
    // segment's length), then the colour space; returns the marker it
    // stopped at (SOS, or EOI in a file of no scan)
    int header() {
        if (n < 3 || d[0] != 0xFF || d[1] != 0xD8) fail(CORRUPT, "not a JPEG file (no SOI)");
        int m = read_markers(true);
        if (img.comps.empty()) fail(CORRUPT, m == 0xD9 ? "no SOF before EOI" : "no SOF before SOS");
        m = read_markers(false);
        const auto& c = img.comps;
        if (img.ncomp == 1) {
            img.color = Color::GREY;
        } else if (img.ncomp == 3) {
            const bool rgb_ids = c[0].id == 'R' && c[1].id == 'G' && c[2].id == 'B';
            img.color = !jfif && (adobe ? adobe_transform == 0 : rgb_ids) ? Color::RGB : Color::YCBCR;
        } else if (img.ncomp == 4) {
            img.color = adobe && adobe_transform != 0 ? Color::YCCK : Color::CMYK;
        } else {
            img.color = Color::NONE;
        }
        return m;
    }

    void setup() {
        if (img.color == Color::YCCK)
            fail(UNSUPPORTED, "a YCCK (Adobe transform " + std::to_string(adobe_transform) +
                                  ") four-component JPEG; only CMYK ones are decoded");
        img.mcux = (img.width + 8 * img.hmax - 1) / (8 * img.hmax);
        img.mcuy = (img.height + 8 * img.vmax - 1) / (8 * img.vmax);
        for (Component& c : img.comps) {
            if (img.hmax % c.h || img.vmax % c.v)
                fail(UNSUPPORTED, "sampling factors whose ratios are not integers");
            c.w_real = static_cast<int>((int64_t(img.width) * c.h + img.hmax - 1) / img.hmax);
            c.h_real = static_cast<int>((int64_t(img.height) * c.v + img.vmax - 1) / img.vmax);
            c.wb = (c.w_real + 7) / 8;
            c.hb = (c.h_real + 7) / 8;
            c.bw = img.mcux * c.h;
            c.bh = img.mcuy * c.v;
            c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
            for (int& b : c.coef_bits) b = -1;
        }
    }

    // a table the scan needs: the DHT's, else Annex K.3's for ids 0 and 1
    void need_table(bool is_ac, int id) {
        Huffman& t = is_ac ? ac[id] : dc[id];
        if (t.defined) return;
        if (id > 1) fail(CORRUPT, "SOS uses an undefined Huffman table");
        if (is_ac)
            build_huffman(t, id ? kAcChromaBits : kAcLumaBits, id ? kAcChromaVals : kAcLumaVals, 162);
        else
            build_huffman(t, id ? kDcChromaBits : kDcLumaBits, kDcVals, 12);
    }

    // one block of a sequential scan
    void seq_block(BitReader& br, Component& c, int16_t* blk) {
        const int s = br.decode(dc[c.td]);
        if (s > 11) fail(CORRUPT, "a bad DC coefficient");
        c.dc_pred += s ? extend(br.get(s), s) : 0;
        const uint16_t* q = quant[c.tq];
        if (store == Store::FFMPEG)
            blk[0] = clip_int16(1024 + int64_t(c.dc_pred) * q[0]);
        else
            blk[0] = static_cast<int16_t>(c.dc_pred);
        const Huffman& ha = ac[c.ta];
        for (int k = 1; k < 64; ++k) {
            const int rs = br.decode(ha);
            const int r = rs >> 4, sz = rs & 15;
            if (sz) {
                k += r;
                if (k > 63) fail(CORRUPT, "an AC run past the block");
                const int v = extend(br.get(sz), sz);
                const int nat = kNatural[k];
                blk[nat] = static_cast<int16_t>(store == Store::FFMPEG ? v * q[nat] : v);
            } else if (r == 15) {
                k += 15;
            } else {
                break;
            }
        }
    }

    // jdphuff.c's four progressive block decoders
    void dc_first(BitReader& br, Component& c, int16_t* blk, int al) {
        const int s = br.decode(dc[c.td]);
        if (s > 11) fail(CORRUPT, "a bad DC coefficient");
        c.dc_pred += s ? extend(br.get(s), s) : 0;
        blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << al);
    }

    static void dc_refine(BitReader& br, int16_t* blk, int al) {
        if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
    }

    void ac_first(BitReader& br, const Component& c, int16_t* blk, int ss, int se, int al,
                  int& eobrun) {
        if (eobrun > 0) {
            --eobrun;
            return;
        }
        const Huffman& ha = ac[c.ta];
        for (int k = ss; k <= se; ++k) {
            const int rs = br.decode(ha);
            const int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                if (k > 63) fail(CORRUPT, "an AC run past the block");
                blk[kNatural[k]] = static_cast<int16_t>(
                    static_cast<unsigned>(extend(br.get(s), s)) << al);
            } else if (r == 15) {
                k += 15;
            } else {
                eobrun = 1 << r;
                if (r) eobrun += br.get(r);
                --eobrun;
                break;
            }
        }
    }

    void ac_refine(BitReader& br, const Component& c, int16_t* blk, int ss, int se, int al,
                   int& eobrun) {
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        // a correction bit for an already-nonzero coefficient: 1 grows its magnitude
        auto correct = [&](int16_t& coef) {
            if (br.get(1) && (coef & p1) == 0)
                coef = static_cast<int16_t>(coef + (coef >= 0 ? p1 : m1));
        };
        int k = ss;
        if (eobrun == 0) {
            const Huffman& ha = ac[c.ta];
            for (; k <= se; ++k) {
                const int rs = br.decode(ha);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    s = br.get(1) ? p1 : m1;  // a newly nonzero coefficient, of size 1
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += br.get(r);
                    break;
                }
                // skip r still-zero coefficients, correcting the nonzero ones on the way
                do {
                    int16_t& coef = blk[kNatural[k]];
                    if (coef != 0) correct(coef);
                    else if (--r < 0) break;
                    ++k;
                } while (k <= se);
                if (s) {
                    if (k > 63) fail(CORRUPT, "an AC run past the block");
                    blk[kNatural[k]] = static_cast<int16_t>(s);
                }
            }
        }
        if (eobrun > 0) {
            for (; k <= se; ++k) {
                int16_t& coef = blk[kNatural[k]];
                if (coef != 0) correct(coef);
            }
            --eobrun;
        }
    }

    // pos at the SOS segment's length; returns with pos past the scan
    void read_scan() {
        const int len = u16(pos) - 2;
        const size_t at = pos + 2;
        if (len < 1 || at + len > n) fail(CORRUPT, "a bad SOS segment");
        const int ns = d[at];
        if (ns < 1 || ns > 4 || len < 4 + 2 * ns) fail(CORRUPT, "a bad SOS segment");
        const int ss = d[at + 1 + 2 * ns], se = d[at + 2 + 2 * ns];
        const int ah = d[at + 3 + 2 * ns] >> 4, al = d[at + 3 + 2 * ns] & 15;
        if (!img.progressive) {
            if (ss != 0 || se != 63 || ah || al)
                fail(CORRUPT, "a sequential scan with Ss/Se/Ah/Al other than 0/63/0/0");
        } else if ((ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1)) || al > 13 ||
                   (ah && ah != al + 1)) {
            fail(CORRUPT, "a progressive scan with bad Ss/Se/Ah/Al or components");
        }
        const bool dc_scan = ss == 0;
        std::vector<Component*> sc;
        for (int i = 0; i < ns; ++i) {
            const int id = d[at + 1 + 2 * i];
            Component* c = nullptr;
            for (Component& k : img.comps)
                if (k.id == id) c = &k;
            if (!c) fail(CORRUPT, "SOS names a component the SOF does not have");
            c->td = d[at + 2 + 2 * i] >> 4;
            c->ta = d[at + 2 + 2 * i] & 15;
            if (c->td > 3 || c->ta > 3) fail(CORRUPT, "SOS uses an undefined Huffman table");
            if (!img.progressive || (dc_scan && ah == 0)) need_table(false, c->td);
            if (!img.progressive || !dc_scan) need_table(true, c->ta);
            if (!c->scanned) {  // latch_quant_tables
                if (!quant_defined[c->tq])
                    fail(CORRUPT, "a component's quantization table is undefined");
                std::memcpy(c->qt, quant[c->tq], sizeof(c->qt));
            }
            c->scanned = true;
            c->dc_pred = 0;
            if (img.progressive)
                for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
            sc.push_back(c);
        }
        BitReader br{d, n, at + len};
        int units_x, units_y;
        if (ns == 1) {  // non-interleaved: one block per MCU, the component's real blocks
            units_x = sc[0]->wb;
            units_y = sc[0]->hb;
        } else {
            units_x = img.mcux;
            units_y = img.mcuy;
        }
        const int64_t total = int64_t(units_x) * units_y;
        int rst = 0, eobrun = 0;
        auto block = [&](Component& c, int16_t* blk) {
            if (!img.progressive) seq_block(br, c, blk);
            else if (dc_scan && ah == 0) dc_first(br, c, blk, al);
            else if (dc_scan) dc_refine(br, blk, al);
            else if (ah == 0) ac_first(br, c, blk, ss, se, al, eobrun);
            else ac_refine(br, c, blk, ss, se, al, eobrun);
        };
        for (int64_t u = 0; u < total; ++u) {
            if (restart && u && u % restart == 0) {
                pos = br.pos;
                const int m = next_marker();
                if (m != 0xD0 + (rst & 7)) fail(CORRUPT, "a missing or out-of-order RST marker");
                ++rst;
                br.reset(pos);
                for (Component* c : sc) c->dc_pred = 0;
                eobrun = 0;
            }
            const int uy = static_cast<int>(u / units_x), ux = static_cast<int>(u % units_x);
            if (ns == 1) {
                block(*sc[0], sc[0]->block(uy, ux));
            } else {
                for (Component* c : sc)
                    for (int v = 0; v < c->v; ++v)
                        for (int h = 0; h < c->h; ++h)
                            block(*c, c->block(uy * c->v + v, ux * c->h + h));
            }
        }
        pos = br.pos;
    }

    void decode_all() {
        int m = header();
        setup();
        while (m != 0xD9) {
            read_scan();
            m = read_markers(false);
        }
        for (const Component& c : img.comps)
            if (!c.scanned) fail(CORRUPT, "a component without a scan");
    }
};

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

// jdcoefct.c's smoothing_ok: every component's DC at least partly known,
// its quantizers of the first ten zigzag coefficients nonzero, and one of
// those nine ACs not yet exact in some component
bool smoothing_useful(const Image& img) {
    if (!img.progressive) return false;
    bool useful = false;
    for (const Component& c : img.comps) {
        for (int k = 0; k < 10; ++k)
            if (c.qt[kNatural[k]] == 0) return false;
        if (c.coef_bits[0] < 0) return false;
        for (int k = 1; k < 10; ++k)
            if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
}

// The rounded quotient of libjpeg's AC estimate: num / (q << 8) of the
// coefficient's magnitude, kept under 2^Al when its low bits are unknown.
inline int16_t estimate(int64_t num, int64_t q, int al) {
    int64_t pred = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
    if (al > 0 && pred >= (int64_t(1) << al)) pred = (int64_t(1) << al) - 1;
    return static_cast<int16_t>(num >= 0 ? pred : -pred);
}

// jdcoefct.c's decompress_smooth_data for one component: each real block's
// estimates from the DCs of the 5x5 blocks around it, then the IDCT.  Columns
// past the component's real blocks repeat the edge column.  The rows read
// are libjpeg-turbo 3.1's, established against it block row by block row:
// the row above and the one below stop at the image's real rows, the row
// two below may be an MCU's padding row, and the row two above is not read
// from iMCU row 1 when the last iMCU row holds fewer block rows than the
// component's vertical sampling factor (each missing row repeats the
// nearer one).
void smooth_idct(const Image& img, const Component& c, uint8_t* plane, size_t stride) {
    const int* bits = c.coef_bits;
    const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 &&
                           bits[5] == -1 && bits[6] == -1 && bits[7] == -1 && bits[8] == -1 &&
                           bits[9] == -1;
    const int64_t Q00 = c.qt[0], Q01 = c.qt[1], Q10 = c.qt[8], Q20 = c.qt[16], Q11 = c.qt[9],
                  Q02 = c.qt[2], Q03 = c.qt[3], Q12 = c.qt[10], Q21 = c.qt[17], Q30 = c.qt[24];
    const int last_imcu = img.mcuy - 1, last_col = c.wb - 1;
    int16_t ws[64];
    for (int r = 0; r < c.hb; ++r) {
        const int imcu = r / c.v, br = r % c.v;
        int rows = c.v;  // block rows of this iMCU row
        if (imcu == last_imcu) {
            rows = c.hb % c.v;
            if (rows == 0) rows = c.v;
        }
        const int prev = (br > 0 || imcu > 0) ? r - 1 : r;
        const int prev2 = (r >= 2 && !(imcu == 1 && rows < c.v)) ? r - 2 : prev;
        const int next = (br < rows - 1 || imcu < last_imcu) ? r + 1 : r;
        const int next2 = r + 2 < c.bh && next != r ? r + 2 : next;
        const int row_of[5] = {prev2, prev, r, next, next2};
        int DC[5][5];  // DC[i][j]: row i (prev2 .. next2), column col - 2 + j (clamped)
        for (int col = 0; col < c.wb; ++col) {
            std::memcpy(ws, c.block(r, col), sizeof(ws));
            for (int i = 0; i < 5; ++i)
                for (int j = 0; j < 5; ++j) {
                    const int x = col - 2 + j;
                    DC[i][j] = c.block(row_of[i], x < 0 ? 0 : (x > last_col ? last_col : x))[0];
                }
            const int DC01 = DC[0][0], DC02 = DC[0][1], DC03 = DC[0][2], DC04 = DC[0][3],
                      DC05 = DC[0][4], DC06 = DC[1][0], DC07 = DC[1][1], DC08 = DC[1][2],
                      DC09 = DC[1][3], DC10 = DC[1][4], DC11 = DC[2][0], DC12 = DC[2][1],
                      DC13 = DC[2][2], DC14 = DC[2][3], DC15 = DC[2][4], DC16 = DC[3][0],
                      DC17 = DC[3][1], DC18 = DC[3][2], DC19 = DC[3][3], DC20 = DC[3][4],
                      DC21 = DC[4][0], DC22 = DC[4][1], DC23 = DC[4][2], DC24 = DC[4][3],
                      DC25 = DC[4][4];
            int64_t num;
            if (bits[1] != 0 && ws[1] == 0) {  // AC01
                num = Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                                          13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 -
                                          38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                                          13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
                                       : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
                ws[1] = estimate(num, Q01, bits[1]);
            }
            if (bits[2] != 0 && ws[8] == 0) {  // AC10
                num = Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                          13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                                          13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                                          3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                                       : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
                ws[8] = estimate(num, Q10, bits[2]);
            }
            if (bits[3] != 0 && ws[16] == 0) {  // AC20
                num = Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                                          14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 +
                                          2 * DC19 + DC23)
                                       : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
                ws[16] = estimate(num, Q20, bits[3]);
            }
            if (bits[4] != 0 && ws[9] == 0) {  // AC11
                num = Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                                          9 * DC19 + DC21 - DC25)
                                       : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 +
                                          DC22 - DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
                ws[9] = estimate(num, Q11, bits[4]);
            }
            if (bits[5] != 0 && ws[2] == 0) {  // AC02
                num = Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                                          14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                                          2 * DC19)
                                       : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
                ws[2] = estimate(num, Q02, bits[5]);
            }
            if (change_dc) {
                if (bits[6] != 0 && ws[3] == 0) {  // AC03
                    num = Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
                    ws[3] = estimate(num, Q03, bits[6]);
                }
                if (bits[7] != 0 && ws[10] == 0) {  // AC12
                    num = Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
                    ws[10] = estimate(num, Q12, bits[7]);
                }
                if (bits[8] != 0 && ws[17] == 0) {  // AC21
                    num = Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
                    ws[17] = estimate(num, Q21, bits[8]);
                }
                if (bits[9] != 0 && ws[24] == 0) {  // AC30
                    num = Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
                    ws[24] = estimate(num, Q30, bits[9]);
                }
                num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
                             6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 +
                             42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 +
                             6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 -
                             6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
                ws[0] = estimate(num, Q00, 0);  // the DC, no limit
            }
            idct_islow(ws, c.qt, plane + size_t(r) * 8 * stride + size_t(col) * 8,
                       static_cast<int>(stride));
        }
    }
}

// the component's samples: (bh * 8) rows of bw * 8, its real blocks filled
std::vector<uint8_t> component_plane(const Image& img, const Component& c, bool smooth) {
    const size_t stride = size_t(c.bw) * 8;
    std::vector<uint8_t> plane(stride * size_t(c.bh) * 8, 0);
    if (smooth) {
        smooth_idct(img, c, plane.data(), stride);
        return plane;
    }
    for (int by = 0; by < c.hb; ++by)
        for (int bx = 0; bx < c.wb; ++bx)
            idct_islow(c.block(by, bx), c.qt, plane.data() + size_t(by) * 8 * stride + size_t(bx) * 8,
                       static_cast<int>(stride));
    return plane;
}

// the component at full size, width x height (jdsample.c)
std::vector<uint8_t> upsample(const Image& img, const Component& c,
                              const std::vector<uint8_t>& plane) {
    const int rx = img.hmax / c.h, ry = img.vmax / c.v;
    const int cw = c.w_real, ch = c.h_real;
    const size_t stride = size_t(c.bw) * 8;
    auto at = [&](int y, int x) -> int {
        y = y < 0 ? 0 : (y >= ch ? ch - 1 : y);
        x = x < 0 ? 0 : (x >= cw ? cw - 1 : x);
        return plane[size_t(y) * stride + x];
    };
    const int ow = cw * rx, oh = ch * ry;  // >= width, height
    std::vector<uint8_t> up(size_t(ow) * oh);
    const bool fancy_h2 = rx == 2 && cw > 2;
    if (rx == 1 && ry == 1) {
        for (int y = 0; y < oh; ++y)
            std::memcpy(&up[size_t(y) * ow], &plane[size_t(y) * stride], ow);
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
    std::vector<uint8_t> cropped(size_t(img.width) * img.height);
    for (int y = 0; y < img.height; ++y)
        std::memcpy(&cropped[size_t(y) * img.width], &up[size_t(y) * ow], img.width);
    return cropped;
}

// jdcolor.c's ycc_rgb_convert
void ycc_to_rgb(const uint8_t* yp, const uint8_t* cbp, const uint8_t* crp, uint8_t* out,
                size_t npx) {
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

// How the decoded components leave decode_libjpeg: as cv2.imread hands
// them on (by the file's colour space), or as libtiff's JPEG codec asks
// libjpeg for a strip of a JPEG-compressed TIFF: its components as they
// decode (JCS_UNKNOWN out), or, for a YCbCr TIFF, converted to RGB
// (JPEGCOLORMODE_RGB).
enum class Out { IMREAD, COMPONENTS, YCBCR_TO_RGB };

void decode_libjpeg(const uint8_t* d, size_t n, uint8_t* out, Out how = Out::IMREAD) {
    Image img;
    decode_coefficients(d, n, img, Store::QUANTIZED);
    const bool smooth = smoothing_useful(img);
    std::vector<std::vector<uint8_t>> full(img.ncomp);
    for (int i = 0; i < img.ncomp; ++i)
        full[i] = upsample(img, img.comps[i], component_plane(img, img.comps[i], smooth));
    const size_t npx = size_t(img.width) * img.height;
    if (how == Out::COMPONENTS) {
        for (size_t p = 0; p < npx; ++p)
            for (int k = 0; k < img.ncomp; ++k) out[img.ncomp * p + k] = full[k][p];
    } else if (how == Out::YCBCR_TO_RGB) {
        if (img.ncomp != 3) fail(CORRUPT, "a YCbCr strip of other than three components");
        ycc_to_rgb(full[0].data(), full[1].data(), full[2].data(), out, npx);
    } else if (img.color == Color::NONE) {
        fail(CORRUPT, "two components, which libjpeg converts to no colour (cv2 reads no image)");
    } else if (img.color == Color::GREY) {
        for (size_t p = 0; p < npx; ++p) out[3 * p] = out[3 * p + 1] = out[3 * p + 2] = full[0][p];
    } else if (img.color == Color::RGB) {  // jdcolor.c's rgb_rgb_convert: a copy
        for (size_t p = 0; p < npx; ++p)
            for (int k = 0; k < 3; ++k) out[3 * p + k] = full[k][p];
    } else if (img.color == Color::CMYK) {
        // libjpeg-turbo hands CMYK out as stored; OpenCV's grfmt_jpeg.cpp
        // (icvCvt_CMYK2BGR_8u_C4C3R) reads it as Adobe's inverted CMYK
        for (size_t p = 0; p < npx; ++p) {
            const int k = full[3][p];
            for (int i = 0; i < 3; ++i) out[3 * p + i] = uint8_t(k - (((255 - full[i][p]) * k) >> 8));
        }
    } else {
        ycc_to_rgb(full[0].data(), full[1].data(), full[2].data(), out, npx);
    }
}

}  // namespace

void read_header(const uint8_t* d, size_t n, Image& img) {
    Decoder dec(d, n, img);
    dec.header();
}

void decode_coefficients(const uint8_t* d, size_t n, Image& img, Store store) {
    Decoder dec(d, n, img);
    dec.store = store;
    dec.decode_all();
}

}  // namespace fmvfi_jpeg

using namespace fmvfi_jpeg;

extern "C" {

int32_t fmvfi_jpeg_header(const uint8_t* data, int64_t n, int32_t* info, char* msg,
                          int32_t msglen) {
    try {
        Image img;
        read_header(data, static_cast<size_t>(n), img);
        info[0] = img.width;
        info[1] = img.height;
        info[2] = img.ncomp;
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
        decode_libjpeg(data, static_cast<size_t>(n), out);
        return OK;
    } catch (const Error& e) {
        return report(e, msg, msglen);
    } catch (const std::bad_alloc&) {
        return report(Error{CORRUPT, "out of memory"}, msg, msglen);
    }
}

int32_t fmvfi_jpeg_decode_strip(const uint8_t* data, int64_t n, uint8_t* out, int32_t ycbcr,
                                char* msg, int32_t msglen) {
    try {
        decode_libjpeg(data, static_cast<size_t>(n), out,
                       ycbcr ? Out::YCBCR_TO_RGB : Out::COMPONENTS);
        return OK;
    } catch (const Error& e) {
        return report(e, msg, msglen);
    } catch (const std::bad_alloc&) {
        return report(Error{CORRUPT, "out of memory"}, msg, msglen);
    }
}

}  // extern "C"
