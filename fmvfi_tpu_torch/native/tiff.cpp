// fmvfi_tpu_torch native host runtime: the TIFF strip codecs of
// fmvfi_tpu_torch/utils/tiff.py, as libtiff 4.7 (under cv2.imread and
// cv2.imwrite) runs them.
//   - LZW decoding (tif_lzw.c's LZWDecode): MSB-first codes of 9 to 12 bits
//     with the early change, Clear and EOI codes, a table that may grow past
//     4096 entries at 12 bits (up to libtiff's 5119); a strip must open with
//     Clear, and a code that names no entry yet, a table past its end or data
//     that ends before the strip is full are corrupt;
//   - LZW encoding (tif_lzw.c's LZWEncode / LZWPostEncode), byte for byte:
//     the 9001-slot open-addressed hash, the Clear at a full table, and the
//     compression-ratio check every 10000 input bytes that clears the table
//     when the ratio stops improving;
//   - PackBits decoding (tif_packbits.c): a run longer than what is left of
//     the strip is cut to it, a strip whose data ends before it is full is
//     corrupt.
//
// Exposed C ABI (ctypes):
//   fmvfi_tiff_lzw_decode(src, n, dst, occ, msg, msglen) -> int32
//   fmvfi_tiff_packbits_decode(src, n, dst, occ, msg, msglen) -> int32
//     Fill dst with occ decoded bytes; return 0, or 2 (corrupt: msg says why).
//   fmvfi_tiff_lzw_encode(src, n, dst, cap) -> int64
//     One strip's codes (Clear first, EOI last) into dst; returns their byte
//     count, or -1 when cap is too small (2 n + 16 always suffices).

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { OK = 0, CORRUPT = 2 };

int report(const char* what, char* msg, int32_t msglen) {
    if (msg && msglen > 0) {
        std::strncpy(msg, what, size_t(msglen) - 1);
        msg[msglen - 1] = 0;
    }
    return CORRUPT;
}

const int BITS_MIN = 9, BITS_MAX = 12, CODE_CLEAR = 256, CODE_EOI = 257, CODE_FIRST = 258;
const int CSIZE = (1 << BITS_MAX) - 1 + 1024;  // libtiff's MAXCODE(BITS_MAX) + 1024
inline int maxcode(int bits) { return (1 << bits) - 1; }

struct Entry {
    int next;       // the entry this one extends, -1 for a single byte
    int length;     // 0: not yet defined
    uint8_t value;  // its last byte
    uint8_t first;  // its first byte
};

int lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t occ, char* msg,
               int32_t msglen) {
    std::vector<Entry> tab(CSIZE);
    for (int i = 0; i < 256; ++i) tab[i] = Entry{-1, 1, uint8_t(i), uint8_t(i)};
    int64_t pos = 0, out = 0;
    uint64_t acc = 0;
    int have = 0;  // bits in acc
    int nbits = BITS_MIN, free_ent = CODE_FIRST, maxc = maxcode(BITS_MIN) - 1;
    int old = -2;  // libtiff's dec_codetab[-1]: no Clear yet
    auto next_code = [&](int& code) -> bool {  // MSB first
        while (have < nbits) {
            if (pos >= n) return false;  // "not terminated with EOI"
            acc = (acc << 8) | src[pos++];
            have += 8;
        }
        have -= nbits;
        code = int((acc >> have) & ((1u << nbits) - 1));
        return true;
    };
    while (out < occ) {
        int code;
        if (!next_code(code) || code == CODE_EOI) break;
        if (code == CODE_CLEAR) {
            do {
                for (int i = CODE_FIRST; i < CSIZE; ++i) tab[i].length = 0;
                free_ent = CODE_FIRST;
                nbits = BITS_MIN;
                maxc = maxcode(BITS_MIN) - 1;
                if (!next_code(code)) code = CODE_EOI;
            } while (code == CODE_CLEAR);
            if (code == CODE_EOI) break;
            if (code > CODE_CLEAR) return report("a corrupted LZW table (a string code after Clear)", msg, msglen);
            dst[out++] = uint8_t(code);
            old = code;
            continue;
        }
        if (old < 0 || free_ent >= CSIZE)
            return report("a corrupted LZW table", msg, msglen);
        Entry& e = tab[free_ent];
        e.next = old;
        e.first = tab[old].first;
        e.length = tab[old].length + 1;
        e.value = code < free_ent ? tab[code].first : e.first;
        if (++free_ent > maxc) {
            if (++nbits > BITS_MAX) nbits = BITS_MAX;
            maxc = maxcode(nbits) - 1;
        }
        old = code;
        if (code < 256) {
            dst[out++] = uint8_t(code);
            continue;
        }
        const int len = tab[code].length;
        if (len == 0) return report("an LZW code for no string yet (corrupt data)", msg, msglen);
        // the string's bytes, last first, down its chain: the tail past the
        // strip's end skipped
        int64_t take = len < occ - out ? len : occ - out;
        int c = code;
        for (int64_t skip = len - take; skip > 0; --skip) c = tab[c].next;
        for (int64_t i = take - 1; i >= 0; --i) {
            dst[out + i] = tab[c].value;
            c = tab[c].next;
        }
        out += take;
    }
    if (out < occ) return report("LZW data that ends before the strip is full", msg, msglen);
    return OK;
}

int packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t occ, char* msg,
                    int32_t msglen) {
    int64_t i = 0, out = 0;
    while (i < n && out < occ) {
        int c = src[i++];
        if (c >= 128) c -= 256;
        if (c < 0) {
            if (c == -128) continue;
            int64_t run = -c + 1;
            if (run > occ - out) run = occ - out;
            if (i >= n) break;
            std::memset(dst + out, src[i++], size_t(run));
            out += run;
        } else {
            int64_t run = c + 1;
            if (run > occ - out) run = occ - out;
            if (n - i < run) break;
            std::memcpy(dst + out, src + i, size_t(run));
            out += run;
            i += run;
        }
    }
    if (out < occ) return report("PackBits data that ends before the strip is full", msg, msglen);
    return OK;
}

// tif_lzw.c's encoder state and its PutNextCode
struct Encoder {
    uint8_t* op;
    uint8_t* end;
    uint64_t nextdata = 0;
    int nextbits = 0;
    int64_t outcount = 0;
    bool overflow = false;

    void put(int code, int nbits) {
        if (end - op < 2) {
            overflow = true;
            return;
        }
        nextdata = (nextdata << nbits) | uint64_t(code);
        nextbits += nbits;
        *op++ = uint8_t((nextdata >> (nextbits - 8)) & 0xff);
        nextbits -= 8;
        if (nextbits >= 8) {
            *op++ = uint8_t((nextdata >> (nextbits - 8)) & 0xff);
            nextbits -= 8;
        }
        outcount += nbits;
    }
};

const int HSIZE = 9001, HSHIFT = 13 - 8, CHECK_GAP = 10000;

int64_t lzw_encode(const uint8_t* bp, int64_t cc, uint8_t* dst, int64_t cap) {
    std::vector<int64_t> hash(HSIZE, -1);
    std::vector<int> hcode(HSIZE, 0);
    Encoder w{dst, dst + cap};
    int64_t incount = 0, checkpoint = CHECK_GAP, ratio = 0;
    int free_ent = CODE_FIRST, nbits = BITS_MIN, maxc = maxcode(BITS_MIN);
    const int CODE_MAX = maxcode(BITS_MAX);
    int ent = -1;
    auto clear = [&]() {
        std::fill(hash.begin(), hash.end(), -1);
        ratio = 0;
        incount = 0;
        w.outcount = 0;
        free_ent = CODE_FIRST;
        w.put(CODE_CLEAR, nbits);
        nbits = BITS_MIN;
        maxc = maxcode(BITS_MIN);
    };
    if (cc > 0) {
        w.put(CODE_CLEAR, nbits);
        ent = *bp++;
        --cc;
        ++incount;
    }
    while (cc > 0) {
        const int c = *bp++;
        --cc;
        ++incount;
        const int64_t fcode = (int64_t(c) << BITS_MAX) + ent;
        int h = (c << HSHIFT) ^ ent;
        bool hit = false;
        if (hash[h] == fcode) {
            ent = hcode[h];
            continue;
        }
        if (hash[h] >= 0) {
            const int disp = h == 0 ? 1 : HSIZE - h;
            do {
                if ((h -= disp) < 0) h += HSIZE;
                if (hash[h] == fcode) {
                    ent = hcode[h];
                    hit = true;
                    break;
                }
            } while (hash[h] >= 0);
        }
        if (hit) continue;
        w.put(ent, nbits);
        ent = c;
        hcode[h] = free_ent++;
        hash[h] = fcode;
        if (free_ent == CODE_MAX - 1) {
            clear();
        } else if (free_ent > maxc) {
            ++nbits;
            maxc = maxcode(nbits);
        } else if (incount >= checkpoint) {
            checkpoint = incount + CHECK_GAP;
            int64_t rat;
            if (incount > 0x007fffff) {
                rat = w.outcount >> 8;
                rat = rat == 0 ? 0x7fffffff : incount / rat;
            } else {
                rat = (incount << 8) / w.outcount;
            }
            if (rat <= ratio) clear();
            else ratio = rat;
        }
        if (w.overflow) return -1;
    }
    if (ent != -1) {  // LZWPostEncode
        w.put(ent, nbits);
        ++free_ent;
        if (free_ent == CODE_MAX - 1) {
            w.put(CODE_CLEAR, nbits);
            nbits = BITS_MIN;
        } else if (free_ent > maxc) {
            ++nbits;
        }
    }
    w.put(CODE_EOI, nbits);
    if (w.overflow || w.op >= w.end) return -1;
    if (w.nextbits > 0) *w.op++ = uint8_t((w.nextdata << (8 - w.nextbits)) & 0xff);
    return w.op - dst;
}

}  // namespace

extern "C" {

int32_t fmvfi_tiff_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t occ,
                              char* msg, int32_t msglen) {
    try {
        return lzw_decode(src, n, dst, occ, msg, msglen);
    } catch (const std::bad_alloc&) {
        return report("out of memory", msg, msglen);
    }
}

int32_t fmvfi_tiff_packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t occ,
                                   char* msg, int32_t msglen) {
    return packbits_decode(src, n, dst, occ, msg, msglen);
}

int64_t fmvfi_tiff_lzw_encode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    try {
        return lzw_encode(src, n, dst, cap);
    } catch (const std::bad_alloc&) {
        return -1;
    }
}

}  // extern "C"
