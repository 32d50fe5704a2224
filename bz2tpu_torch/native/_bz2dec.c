/* bz2tpu native decode core.
 *
 * Standalone C implementation of bzip2 stream decoding (and CRC32), the
 * TPU framework's host-native runtime piece — the counterpart of the
 * reference's host-side C++ decode stack (reference
 * include/InputStream.hpp:36-159, include/BlockDecompressor.hpp:37-284,
 * include/HuffmanStageDecoder.hpp:86-136), written fresh at standard
 * 100k-900k block scale (the reference rejects real bzip2 streams,
 * include/BlockDecompressor.hpp:213-215; this decoder accepts all
 * conformant streams).
 *
 * Exposed to Python via the CPython C API (no pybind11 in this image):
 *   decode_stream(data: bytes, verify_crc: bool = True) -> bytes
 *   crc32(data: bytes) -> int            (CRC-32/BZIP2, finalized)
 * and the device decode's host steps: scan_blocks (the block and end
 * markers), parse_block_header (one block's header) and inverse_rle1.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>
#include <stdlib.h>

/* ------------------------------------------------------------------ */
/* CRC-32/BZIP2: poly 0x04C11DB7, MSB-first, init/final 0xFFFFFFFF.    */

static uint32_t crc_table[256];

static void crc_init_table(void) {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i << 24;
        for (int k = 0; k < 8; k++)
            c = (c & 0x80000000u) ? (c << 1) ^ 0x04C11DB7u : (c << 1);
        crc_table[i] = c;
    }
}

/* ------------------------------------------------------------------ */
/* Legacy bzip2 0.9.0 block-randomisation schedule (format-defined       */
/* constants, bzip2 randtable.c; verified against the installed libbz2   */
/* via a crafted randomised stream, tests/test_randomised.py). Modern    */
/* encoders never set the bit; stock bzip2 still DECODES such blocks,    */
/* so this decoder does too — the reference rejects them                 */
/* (include/BlockDecompressor.hpp:274-277).                              */

static const int16_t rand_nums[512] = {
    619, 720, 127, 481, 931, 816, 813, 233, 566, 247, 985, 724,
    205, 454, 863, 491, 741, 242, 949, 214, 733, 859, 335, 708,
    621, 574, 73, 654, 730, 472, 419, 436, 278, 496, 867, 210,
    399, 680, 480, 51, 878, 465, 811, 169, 869, 675, 611, 697,
    867, 561, 862, 687, 507, 283, 482, 129, 807, 591, 733, 623,
    150, 238, 59, 379, 684, 877, 625, 169, 643, 105, 170, 607,
    520, 932, 727, 476, 693, 425, 174, 647, 73, 122, 335, 530,
    442, 853, 695, 249, 445, 515, 909, 545, 703, 919, 874, 474,
    882, 500, 594, 612, 641, 801, 220, 162, 819, 984, 589, 513,
    495, 799, 161, 604, 958, 533, 221, 400, 386, 867, 600, 782,
    382, 596, 414, 171, 516, 375, 682, 485, 911, 276, 98, 553,
    163, 354, 666, 933, 424, 341, 533, 870, 227, 730, 475, 186,
    263, 647, 537, 686, 600, 224, 469, 68, 770, 919, 190, 373,
    294, 822, 808, 206, 184, 943, 795, 384, 383, 461, 404, 758,
    839, 887, 715, 67, 618, 276, 204, 918, 873, 777, 604, 560,
    951, 160, 578, 722, 79, 804, 96, 409, 713, 940, 652, 934,
    970, 447, 318, 353, 859, 672, 112, 785, 645, 863, 803, 350,
    139, 93, 354, 99, 820, 908, 609, 772, 154, 274, 580, 184,
    79, 626, 630, 742, 653, 282, 762, 623, 680, 81, 927, 626,
    789, 125, 411, 521, 938, 300, 821, 78, 343, 175, 128, 250,
    170, 774, 972, 275, 999, 639, 495, 78, 352, 126, 857, 956,
    358, 619, 580, 124, 737, 594, 701, 612, 669, 112, 134, 694,
    363, 992, 809, 743, 168, 974, 944, 375, 748, 52, 600, 747,
    642, 182, 862, 81, 344, 805, 988, 739, 511, 655, 814, 334,
    249, 515, 897, 955, 664, 981, 649, 113, 974, 459, 893, 228,
    433, 837, 553, 268, 926, 240, 102, 654, 459, 51, 686, 754,
    806, 760, 493, 403, 415, 394, 687, 700, 946, 670, 656, 610,
    738, 392, 760, 799, 887, 653, 978, 321, 576, 617, 626, 502,
    894, 679, 243, 440, 680, 879, 194, 572, 640, 724, 926, 56,
    204, 700, 707, 151, 457, 449, 797, 195, 791, 558, 945, 679,
    297, 59, 87, 824, 713, 663, 412, 693, 342, 606, 134, 108,
    571, 364, 631, 212, 174, 643, 304, 329, 343, 97, 430, 751,
    497, 314, 983, 374, 822, 928, 140, 206, 73, 263, 980, 736,
    876, 478, 430, 305, 170, 514, 364, 692, 829, 82, 855, 953,
    676, 246, 369, 970, 294, 750, 807, 827, 150, 790, 288, 923,
    804, 378, 215, 828, 592, 281, 565, 555, 710, 82, 896, 831,
    547, 261, 524, 462, 293, 465, 502, 56, 661, 821, 976, 991,
    658, 869, 905, 758, 745, 193, 768, 550, 608, 933, 378, 286,
    215, 979, 792, 961, 61, 688, 793, 644, 986, 403, 106, 366,
    905, 644, 372, 567, 466, 434, 645, 210, 389, 550, 919, 135,
    780, 773, 635, 389, 707, 100, 626, 958, 165, 504, 920, 176,
    193, 713, 857, 265, 203, 50, 668, 108, 645, 990, 626, 197,
    510, 357, 358, 850, 858, 364, 936, 638,
};

static uint32_t crc_update(uint32_t s, const uint8_t *p, size_t n) {
    for (size_t i = 0; i < n; i++)
        s = (s << 8) ^ crc_table[(s >> 24) ^ p[i]];
    return s;
}

/* ------------------------------------------------------------------ */
/* MSB-first bit reader.                                               */

typedef struct {
    const uint8_t *data;
    size_t nbytes;
    size_t pos; /* bit position */
} BitReader;

static int br_read(BitReader *br, int nbits, uint32_t *out) {
    if (br->pos + (size_t)nbits > br->nbytes * 8) return -1;
    uint32_t v = 0;
    size_t pos = br->pos;
    int need = nbits;
    while (need > 0) {
        uint32_t byte = br->data[pos >> 3];
        int avail = 8 - (int)(pos & 7);
        int take = avail < need ? avail : need;
        v = (v << take) | ((byte >> (avail - take)) & ((1u << take) - 1u));
        pos += (size_t)take;
        need -= take;
    }
    br->pos = pos;
    *out = v;
    return 0;
}

/* 48-bit read for block/stream markers. */
static int br_read48(BitReader *br, uint64_t *out) {
    uint32_t hi, lo;
    if (br_read(br, 24, &hi) || br_read(br, 24, &lo)) return -1;
    *out = ((uint64_t)hi << 24) | lo;
    return 0;
}

/* ------------------------------------------------------------------ */
/* Growable output buffer.                                             */

typedef struct {
    uint8_t *buf;
    size_t len, capy;
} Vec;

static int vec_reserve(Vec *v, size_t extra) {
    if (v->len + extra <= v->capy) return 0;
    size_t nc = v->capy ? v->capy : 1 << 20;
    while (nc < v->len + extra) nc *= 2;
    uint8_t *nb = (uint8_t *)realloc(v->buf, nc);
    if (!nb) return -1;
    v->buf = nb;
    v->capy = nc;
    return 0;
}

/* ------------------------------------------------------------------ */
/* Format constants (standard bzip2 scale).                            */

#define MAX_ALPHA 258
#define MAX_GROUPS 6
#define GROUP_SIZE 50
#define MAX_CODE_LEN 23
#define MAX_ACCEPT_LEN 20
#define BLOCK_HEADER 0x314159265359ULL
#define STREAM_END 0x177245385090ULL
#define MAX_SELECTORS (2 + (900000 / GROUP_SIZE))

typedef struct {
    int32_t limit[MAX_CODE_LEN + 2];
    int32_t base[MAX_CODE_LEN + 2];
    uint16_t perm[MAX_ALPHA];
    int min_len;
} HuffTable;

static const char *build_table(const uint8_t *lengths, int alpha, HuffTable *t) {
    memset(t, 0, sizeof(*t)); /* deterministic base[]/perm[] on every path */
    int min_l = 32, max_l = 0;
    for (int i = 0; i < alpha; i++) {
        if (lengths[i] < min_l) min_l = lengths[i];
        if (lengths[i] > max_l) max_l = lengths[i];
    }
    if (min_l < 1 || max_l > MAX_ACCEPT_LEN) return "invalid code length range";
    t->min_len = min_l;
    /* stable counting sort of symbols by length */
    int count[MAX_CODE_LEN + 2] = {0};
    for (int i = 0; i < alpha; i++) count[lengths[i]]++;
    int pos[MAX_CODE_LEN + 2];
    int acc = 0;
    for (int l = 0; l <= MAX_CODE_LEN + 1; l++) { pos[l] = acc; acc += count[l]; }
    for (int i = 0; i < alpha; i++) t->perm[pos[lengths[i]]++] = (uint16_t)i;

    int32_t vec = 0, total = 0;
    for (int l = 0; l <= MAX_CODE_LEN + 1; l++) t->limit[l] = INT32_MAX;
    for (int bits = min_l; bits <= max_l; bits++) {
        t->base[bits] = vec - total;
        vec += count[bits];
        total += count[bits];
        t->limit[bits] = vec - 1;
        vec <<= 1;
    }
    return NULL;
}

/* ------------------------------------------------------------------ */
/* Block + stream decode.                                              */

typedef struct {
    const char *err;   /* static error message, NULL = ok */
    int crc_mismatch;  /* raise CRC-specific error */
} DecErr;

/* One block header, from the stored CRC to the first bit of the Huffman
   data: what read_block_header gives both the host decoder and the device
   path (parse_block_header below). */
typedef struct {
    uint32_t crc, randomised, orig_ptr;
    int n_in_use;                  /* used_bytes[0 .. n_in_use) */
    uint8_t used_bytes[256];
    int alpha;                     /* n_in_use + 2 */
    uint32_t n_groups, n_selectors;
    uint8_t *selectors;            /* n_selectors of them, malloc'd: the caller frees */
    uint8_t lens[MAX_GROUPS][MAX_ALPHA];
} BlockHeader;

/* Read the header that follows a block's 48-bit marker. On an error
   e->err is set, h->selectors is NULL, and the fields read before the
   error hold their values (h->randomised from the 33rd bit on). */
static int read_block_header(BitReader *br, BlockHeader *h, DecErr *e) {
    h->randomised = 0;
    h->selectors = NULL;
    if (br_read(br, 32, &h->crc) || br_read(br, 1, &h->randomised) ||
        br_read(br, 24, &h->orig_ptr)) { e->err = "truncated block header"; return -1; }

    /* symbol map */
    uint32_t ranges;
    h->n_in_use = 0;
    if (br_read(br, 16, &ranges)) { e->err = "truncated symbol map"; return -1; }
    for (int i = 0; i < 16; i++) {
        if (ranges & (0x8000u >> i)) {
            uint32_t bits;
            if (br_read(br, 16, &bits)) { e->err = "truncated symbol map"; return -1; }
            for (int j = 0; j < 16; j++)
                if (bits & (0x8000u >> j)) h->used_bytes[h->n_in_use++] = (uint8_t)(16 * i + j);
        }
    }
    if (h->n_in_use == 0) { e->err = "empty symbol map"; return -1; }
    h->alpha = h->n_in_use + 2;

    if (br_read(br, 3, &h->n_groups) || br_read(br, 15, &h->n_selectors)) {
        e->err = "truncated table header"; return -1;
    }
    if (h->n_groups < 2 || h->n_groups > MAX_GROUPS) { e->err = "bad table count"; return -1; }
    /* 18002 = 2 + 900000/50, the standard-scale cap (the reference enforces
       its downscaled analog, include/BlockDecompressor.hpp:158-161) */
    if (h->n_selectors < 1 || h->n_selectors > MAX_SELECTORS) { e->err = "bad selector count"; return -1; }

    /* selectors: unary MTF over table list */
    uint8_t *selectors = (uint8_t *)malloc(h->n_selectors);
    if (!selectors) { e->err = "out of memory"; return -1; }
    {
        uint8_t mtf[MAX_GROUPS];
        for (uint32_t i = 0; i < h->n_groups; i++) mtf[i] = (uint8_t)i;
        for (uint32_t s = 0; s < h->n_selectors; s++) {
            uint32_t j = 0, bit;
            for (;;) {
                if (br_read(br, 1, &bit)) { free(selectors); e->err = "truncated selectors"; return -1; }
                if (!bit) break;
                j++;
            }
            if (j >= h->n_groups) { free(selectors); e->err = "selector out of range"; return -1; }
            uint8_t v = mtf[j];
            memmove(mtf + 1, mtf, j);
            mtf[0] = v;
            selectors[s] = v;
        }
    }

    /* delta-coded code lengths */
    for (uint32_t t = 0; t < h->n_groups; t++) {
        uint32_t cur;
        if (br_read(br, 5, &cur)) { free(selectors); e->err = "truncated tables"; return -1; }
        for (int v = 0; v < h->alpha; v++) {
            for (;;) {
                uint32_t more;
                if (br_read(br, 1, &more)) { free(selectors); e->err = "truncated tables"; return -1; }
                if (!more) break;
                uint32_t dec;
                if (br_read(br, 1, &dec)) { free(selectors); e->err = "truncated tables"; return -1; }
                cur += dec ? (uint32_t)-1 : 1u;
            }
            if (cur < 1 || cur > MAX_ACCEPT_LEN) { free(selectors); e->err = "code length out of range"; return -1; }
            h->lens[t][v] = (uint8_t)cur;
        }
    }
    h->selectors = selectors;
    return 0;
}

static int decode_one_block(
    BitReader *br, int max_block, int verify_crc,
    uint32_t *stream_crc, Vec *out, DecErr *e,
    /* scratch, reused across blocks: */
    uint8_t *bwt, int32_t *tvec)
{
    BlockHeader h;
    if (read_block_header(br, &h, e)) return -1;
    uint32_t stored_crc = h.crc, randomised = h.randomised, orig_ptr = h.orig_ptr;
    uint32_t n_selectors = h.n_selectors;
    uint8_t *selectors = h.selectors;
    int alpha = h.alpha;

    /* canonical tables */
    HuffTable tables[MAX_GROUPS];
    for (uint32_t t = 0; t < h.n_groups; t++) {
        const char *err = build_table(h.lens[t], alpha, &tables[t]);
        if (err) { free(selectors); e->err = err; return -1; }
    }

    /* Huffman data -> RUNA/RUNB runs -> inverse MTF -> BWT last column */
    int eob = alpha - 1;
    uint8_t mtf_list[256];
    memcpy(mtf_list, h.used_bytes, (size_t)h.n_in_use);
    int n_bwt = 0;
    int64_t run = 0;
    int run_bit = 0;
    uint32_t group = 0, gcount = 0;
    HuffTable *tb = NULL;
    int32_t byte_count[256] = {0};
    for (;;) {
        if (gcount == 0) {
            if (group >= n_selectors) { free(selectors); e->err = "ran out of selectors"; return -1; }
            tb = &tables[selectors[group++]];
            gcount = GROUP_SIZE;
        }
        gcount--;
        int bits = tb->min_len;
        uint32_t code;
        if (br_read(br, bits, &code)) { free(selectors); e->err = "truncated block data"; return -1; }
        while ((int32_t)code > tb->limit[bits]) {
            uint32_t b;
            if (br_read(br, 1, &b)) { free(selectors); e->err = "truncated block data"; return -1; }
            code = (code << 1) | b;
            if (++bits > MAX_ACCEPT_LEN) { free(selectors); e->err = "invalid Huffman code"; return -1; }
        }
        int32_t perm_idx = (int32_t)code - tb->base[bits];
        if (perm_idx < 0 || perm_idx >= alpha) {
            /* over-subscribed/incomplete canonical code reached the
               INT32_MAX sentinel past max_len — malformed stream */
            free(selectors); e->err = "invalid Huffman code"; return -1;
        }
        int sym = tb->perm[perm_idx];
        if (sym <= 1) { /* RUNA=0 / RUNB=1 */
            /* 2^25 > any legal block; larger run_bit would overflow the
               shift (C UB at >= 63) and could wrap past the bound check */
            if (run_bit >= 25) { free(selectors); e->err = "block exceeds declared block size"; return -1; }
            run += (int64_t)(sym + 1) << run_bit;
            run_bit++;
            continue;
        }
        if (run > 0) {
            if (n_bwt + run > max_block) { free(selectors); e->err = "block exceeds declared block size"; return -1; }
            memset(bwt + n_bwt, mtf_list[0], (size_t)run);
            byte_count[mtf_list[0]] += (int32_t)run;
            n_bwt += (int)run;
            run = 0;
            run_bit = 0;
        }
        if (sym == eob) break;
        /* inverse MTF for index sym-1 >= 1 */
        int j = sym - 1;
        uint8_t v = mtf_list[j];
        memmove(mtf_list + 1, mtf_list, (size_t)j);
        mtf_list[0] = v;
        if (n_bwt >= max_block) { free(selectors); e->err = "block exceeds declared block size"; return -1; }
        bwt[n_bwt++] = v;
        byte_count[v]++;
    }
    free(selectors);
    if ((int)orig_ptr >= n_bwt) { e->err = "origin pointer out of range"; return -1; }

    /* inverse BWT: stable counting order, then the T-vector walk */
    int32_t starts[256];
    {
        int32_t acc = 0;
        for (int b = 0; b < 256; b++) { starts[b] = acc; acc += byte_count[b]; }
    }
    for (int i = 0; i < n_bwt; i++) tvec[starts[bwt[i]]++] = i;

    /* walk + inverse RLE1 + CRC, streaming */
    uint32_t crc = 0xFFFFFFFFu;
    if (vec_reserve(out, (size_t)n_bwt)) { e->err = "out of memory"; return -1; }
    int32_t p = tvec[orig_ptr];
    uint8_t prev = 0;
    int run_count = 0;
    /* randomised (0.9.0 legacy): XOR schedule over the walk output, i.e.
       the byte stream BEFORE inverse RLE1 (libbz2 decompress.c applies
       BZ_RAND_MASK to k1 in the un-RLE loop). */
    int rn_to_go = 0, rt_pos = 0;
    for (int i = 0; i < n_bwt; i++) {
        uint8_t c = bwt[p];
        p = tvec[p];
        if (randomised) {
            if (rn_to_go == 0) {
                rn_to_go = rand_nums[rt_pos];
                if (++rt_pos == 512) rt_pos = 0;
            }
            rn_to_go--;
            c ^= (rn_to_go == 1);
        }
        if (run_count == 4) {
            /* c is a count byte: emit c more copies of prev */
            if (c) {
                if (vec_reserve(out, (size_t)c)) { e->err = "out of memory"; return -1; }
                memset(out->buf + out->len, prev, c);
                out->len += c;
                if (verify_crc)
                    for (int k = 0; k < (int)c; k++)
                        crc = (crc << 8) ^ crc_table[(crc >> 24) ^ prev];
            }
            run_count = 0;
            continue;
        }
        if (c == prev) run_count++;
        else { run_count = 1; prev = c; }
        if (vec_reserve(out, 1)) { e->err = "out of memory"; return -1; }
        out->buf[out->len++] = c;
        if (verify_crc) crc = (crc << 8) ^ crc_table[(crc >> 24) ^ c];
    }
    crc ^= 0xFFFFFFFFu;
    if (verify_crc && crc != stored_crc) { e->crc_mismatch = 1; e->err = "block CRC mismatch"; return -1; }
    *stream_crc = ((*stream_crc << 1) | (*stream_crc >> 31)) ^ stored_crc;
    return 0;
}

static PyObject *CrcError;

static PyObject *py_decode_stream(PyObject *self, PyObject *args, PyObject *kwargs) {
    static char *kwlist[] = {"data", "verify_crc", NULL};
    Py_buffer view;
    int verify_crc = 1;
    if (!PyArg_ParseTupleAndKeywords(args, kwargs, "y*|p", kwlist, &view, &verify_crc))
        return NULL;
    if (view.len == 0) { /* stdlib parity: bz2.decompress(b"") == b"" */
        PyBuffer_Release(&view);
        return PyBytes_FromStringAndSize(NULL, 0);
    }

    BitReader br = {(const uint8_t *)view.buf, (size_t)view.len, 0};
    Vec out = {NULL, 0, 0};
    uint8_t *bwt = NULL;
    int32_t *tvec = NULL;
    DecErr e = {NULL, 0};
    int alloc_block = 0;
    int first_member = 1;
    int members_done = 0;
    size_t member_start_len = 0;

    /* Multi-member streams: like stock bzip2 / stdlib bz2, keep decoding
       while the (byte-aligned) remainder begins a valid stream header.
       stdlib parity (measured against CPython bz2.decompress):
       - trailing data that ERRORS during decode (bad magic byte, junk
         after a valid "BZh<d>") is ignored — return the decoded members;
       - trailing data that is merely TRUNCATED (a proper prefix of the
         magic, or a valid-magic member cut short) raises, like stdlib's
         "Compressed data ended before the end-of-stream marker". */
    for (;;) {
        if (!first_member) {
            br.pos = (br.pos + 7) & ~(size_t)7;
            size_t rem = br.nbytes - (br.pos >> 3);
            if (rem == 0) break;
            const uint8_t *p = br.data + (br.pos >> 3);
            static const uint8_t magic3[3] = {'B', 'Z', 'h'};
            size_t k = 0;
            int mismatch = 0;
            for (; k < rem && k < 3; k++)
                if (p[k] != magic3[k]) { mismatch = 1; break; }
            if (!mismatch && rem >= 4 && !(p[3] >= '1' && p[3] <= '9')) mismatch = 1;
            if (mismatch) break;                 /* junk tail: ignore */
            if (rem < 4) { e.err = "truncated stream"; goto fail; } /* magic prefix cut short */
        }
        member_start_len = out.len; /* rollback point for trailing junk */
        uint32_t magic, level_ch;
        if (br_read(&br, 24, &magic) || magic != 0x425A68u) { e.err = "bad stream magic (expected BZh)"; goto fail; }
        if (br_read(&br, 8, &level_ch)) { e.err = "truncated header"; goto fail; }
        int level = (int)level_ch - '0';
        if (level < 1 || level > 9) { e.err = "bad block-size level"; goto fail; }
        int max_block = level * 100000;
        if (max_block > alloc_block) {
            uint8_t *nb = (uint8_t *)realloc(bwt, (size_t)max_block);
            int32_t *nt = (int32_t *)realloc(tvec, sizeof(int32_t) * (size_t)max_block);
            if (nb) bwt = nb;
            if (nt) tvec = nt;
            if (!nb || !nt) { e.err = "out of memory"; goto fail; }
            alloc_block = max_block;
        }
        first_member = 0;

        uint32_t stream_crc = 0;
        for (;;) {
            uint64_t marker;
            if (br_read48(&br, &marker)) { e.err = "truncated stream"; goto fail; }
            if (marker == STREAM_END) {
                uint32_t stored;
                if (br_read(&br, 32, &stored)) { e.err = "truncated stream CRC"; goto fail; }
                if (verify_crc && stored != stream_crc) { e.crc_mismatch = 1; e.err = "stream CRC mismatch"; goto fail; }
                break;
            }
            if (marker != BLOCK_HEADER) { e.err = "bad block marker"; goto fail; }
            Py_BEGIN_ALLOW_THREADS
            decode_one_block(&br, max_block, verify_crc, &stream_crc, &out, &e, bwt, tvec);
            Py_END_ALLOW_THREADS
            if (e.err) goto fail;
        }
        members_done++;
    }

success:
    free(bwt);
    free(tvec);
    PyBuffer_Release(&view);
    PyObject *res = PyBytes_FromStringAndSize((const char *)out.buf, (Py_ssize_t)out.len);
    free(out.buf);
    return res;

fail:
    if (members_done > 0 && e.err && strcmp(e.err, "out of memory") != 0 &&
        strncmp(e.err, "truncated", 9) != 0) {
        /* Undecodable (non-truncated) data after >= 1 complete member:
           discard the partial member and return what decoded (stdlib bz2
           parity). Truncation of a member whose header validated re-raises,
           matching stdlib's eof check. */
        out.len = member_start_len;
        goto success;
    }
    free(bwt);
    free(tvec);
    free(out.buf);
    PyBuffer_Release(&view);
    PyErr_SetString(e.crc_mismatch ? CrcError : PyExc_ValueError, e.err);
    return NULL;
}

/* ------------------------------------------------------------------ */
/* Parallel-decode support: block-boundary scan + single-block decode. */
/* The reference decodes strictly sequentially on one thread           */
/* (reference include/InputStream.hpp:51-95). bzip2 blocks are         */
/* self-contained after their 48-bit marker, so a scan for the marker  */
/* bit pattern yields per-block work items that decode concurrently    */
/* (the pbzip2 trick); the Python driver verifies the offsets chain    */
/* exactly and falls back to sequential decode on any mismatch (a      */
/* false positive is a 2^-48 event per bit).                           */

/* The search is byte-wise. A marker that starts at bit s (0-7) of byte i
   fills bytes i+1 and i+2 whatever s is, so scan_filter, indexed by those
   two bytes, holds bit 8 m + s where marker m (0: block, 1: end) starting
   at bit s of byte i would give them; only where it is not zero are the
   alignments it names compared in full (on compressed data, about one
   byte in 4,096). The lists come out as a bit-serial scan gives them:
   every position whose 48 bits equal a marker, overlaps included, in
   ascending order. */

static uint16_t scan_filter[1 << 16];

static void scan_init_filter(void) {
    static const uint64_t markers[2] = {BLOCK_HEADER, STREAM_END};
    for (int m = 0; m < 2; m++)
        for (int s = 0; s < 8; s++) {
            uint64_t w = markers[m] << (8 - s); /* bytes i .. i+6 as 56 bits */
            scan_filter[(w >> 32) & 0xFFFF] |= (uint16_t)(1u << (8 * m + s));
        }
}

static int push_offset(size_t **v, size_t *n, size_t *cap, size_t x) {
    if (*n == *cap) {
        size_t *nv = (size_t *)realloc(*v, (*cap *= 2) * sizeof(size_t));
        if (!nv) return -1;
        *v = nv;
    }
    (*v)[(*n)++] = x;
    return 0;
}

static PyObject *py_scan_blocks(PyObject *self, PyObject *args) {
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "y*", &view)) return NULL;
    const uint8_t *d = (const uint8_t *)view.buf;
    size_t n = (size_t)view.len, nbits = n * 8;
    size_t cap_h = 64, n_h = 0, cap_e = 8, n_e = 0;
    size_t *hs = (size_t *)malloc(cap_h * sizeof(size_t));
    size_t *es = (size_t *)malloc(cap_e * sizeof(size_t));
    int oom = 0;
    if (!hs || !es) oom = 1;
    if (!oom) {
        Py_BEGIN_ALLOW_THREADS
        for (size_t i = 0; i + 6 <= n && !oom; i++) {
            unsigned hit = scan_filter[((unsigned)d[i + 1] << 8) | d[i + 2]];
            if (!hit) continue;
            uint64_t w = 0;
            for (size_t k = i; k < i + 7; k++) w = (w << 8) | (k < n ? d[k] : 0);
            for (int s = 0; s < 8; s++) {
                size_t p = 8 * i + (size_t)s;
                if (p + 48 > nbits) break;
                uint64_t win = (w >> (8 - s)) & 0xFFFFFFFFFFFFULL;
                if (((hit >> s) & 1) && win == BLOCK_HEADER) {
                    if (push_offset(&hs, &n_h, &cap_h, p)) { oom = 1; break; }
                } else if (((hit >> (8 + s)) & 1) && win == STREAM_END) {
                    if (push_offset(&es, &n_e, &cap_e, p)) { oom = 1; break; }
                }
            }
        }
        Py_END_ALLOW_THREADS
    }
    PyBuffer_Release(&view);
    if (oom) { free(hs); free(es); return PyErr_NoMemory(); }
    PyObject *headers = PyList_New((Py_ssize_t)n_h);
    PyObject *ends = PyList_New((Py_ssize_t)n_e);
    if (!headers || !ends) { Py_XDECREF(headers); Py_XDECREF(ends); free(hs); free(es); return NULL; }
    for (size_t k = 0; k < n_h; k++) PyList_SET_ITEM(headers, (Py_ssize_t)k, PyLong_FromSize_t(hs[k]));
    for (size_t k = 0; k < n_e; k++) PyList_SET_ITEM(ends, (Py_ssize_t)k, PyLong_FromSize_t(es[k]));
    free(hs); free(es);
    return Py_BuildValue("(NN)", headers, ends);
}

/* The device path's header parse: the block at bit_offset (its marker
   included) through read_block_header, with the GIL released. Returns
   (crc, randomised, orig_ptr, used_bytes, selectors, lengths,
   data_start_bit): used_bytes and selectors as bytes, lengths as
   n_groups rows of alpha bytes. A randomised block returns its CRC and
   bit alone, as (crc, 1, None, None, None, None, None), whatever follows
   the bit: the device path hands such a block to the host decoder. A
   header cut short raises EOFError, any other fault ValueError. */
static PyObject *py_parse_block_header(PyObject *self, PyObject *args) {
    Py_buffer view;
    Py_ssize_t bit_offset;
    if (!PyArg_ParseTuple(args, "y*n", &view, &bit_offset)) return NULL;
    if (bit_offset < 0) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "negative bit offset");
        return NULL;
    }
    BitReader br = {(const uint8_t *)view.buf, (size_t)view.len, (size_t)bit_offset};
    BlockHeader h;
    h.randomised = 0;
    h.selectors = NULL;
    DecErr e = {NULL, 0};
    Py_BEGIN_ALLOW_THREADS
    uint64_t marker;
    if (br_read48(&br, &marker)) e.err = "truncated block marker";
    else if (marker != BLOCK_HEADER) e.err = "bad block marker";
    else read_block_header(&br, &h, &e);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&view);
    if (h.randomised) {
        free(h.selectors);
        return Py_BuildValue("(IiOOOOO)", (unsigned int)h.crc, 1,
                             Py_None, Py_None, Py_None, Py_None, Py_None);
    }
    if (e.err) {
        if (strcmp(e.err, "out of memory") == 0) return PyErr_NoMemory();
        PyErr_SetString(strncmp(e.err, "truncated", 9) == 0 ? PyExc_EOFError : PyExc_ValueError, e.err);
        return NULL;
    }
    PyObject *lengths = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)h.n_groups * h.alpha);
    if (!lengths) { free(h.selectors); return NULL; }
    for (uint32_t t = 0; t < h.n_groups; t++)
        memcpy(PyBytes_AS_STRING(lengths) + (size_t)t * (size_t)h.alpha, h.lens[t], (size_t)h.alpha);
    PyObject *res = Py_BuildValue(
        "(IiIy#y#Nn)", (unsigned int)h.crc, 0, (unsigned int)h.orig_ptr,
        (const char *)h.used_bytes, (Py_ssize_t)h.n_in_use,
        (const char *)h.selectors, (Py_ssize_t)h.n_selectors,
        lengths, (Py_ssize_t)br.pos);
    free(h.selectors);
    return res;
}

static PyObject *py_decode_block_at(PyObject *self, PyObject *args) {
    Py_buffer view;
    Py_ssize_t bit_offset;
    int level, verify_crc;
    if (!PyArg_ParseTuple(args, "y*nip", &view, &bit_offset, &level, &verify_crc))
        return NULL;
    if (level < 1 || level > 9) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "level must be 1..9");
        return NULL;
    }
    int max_block = level * 100000;
    BitReader br = {(const uint8_t *)view.buf, (size_t)view.len, (size_t)bit_offset + 48};
    Vec out = {NULL, 0, 0};
    DecErr e = {NULL, 0};
    uint32_t dummy_crc = 0;
    uint8_t *bwt = (uint8_t *)malloc((size_t)max_block);
    int32_t *tvec = (int32_t *)malloc(sizeof(int32_t) * (size_t)max_block);
    if (!bwt || !tvec) { e.err = "out of memory"; goto done; }
    Py_BEGIN_ALLOW_THREADS
    decode_one_block(&br, max_block, verify_crc, &dummy_crc, &out, &e, bwt, tvec);
    Py_END_ALLOW_THREADS
done:
    free(bwt);
    free(tvec);
    PyBuffer_Release(&view);
    if (e.err) {
        free(out.buf);
        PyErr_SetString(e.crc_mismatch ? CrcError : PyExc_ValueError, e.err);
        return NULL;
    }
    /* dummy_crc = rotl1(0) ^ stored = stored block CRC */
    PyObject *res = Py_BuildValue(
        "(y#In)", (const char *)out.buf, (Py_ssize_t)out.len,
        (unsigned int)dummy_crc, (Py_ssize_t)br.pos);
    free(out.buf);
    return res;
}

/* ------------------------------------------------------------------ */
/* RLE1 + CRC block splitter (compress-side intake).                   */
/* Counterpart of the reference's BlockCompressor RLE1 state machine   */
/* (reference include/BlockCompressor.hpp:69-154) as a single host     */
/* pass: runs of 4-255 become 4 literals + count byte; the CRC is over */
/* the ORIGINAL bytes of each block. Block cuts follow stock bzip2's   */
/* fill rule EXACTLY (bzlib copy_input_until_stop + the no-flush_RL    */
/* mid-stream block close, verified against libbz2's own block spans   */
/* at levels 1-3, tests/test_native.py): pieces flush while the        */
/* block's output is < nblockMAX = 100000*level - 19, so the crossing  */
/* piece overshoots by up to 4 bytes; the in-progress run at the exit  */
/* check carries ENTIRELY into the next block (mid-stream compressBlock*/
/* runs without flush_RL). Matching stock's boundaries makes every     */
/* block's content identical to libbz2's, so ratio comparisons are     */
/* apples-to-apples per block (round 5: the level-6 sweep's +0.006%    */
/* was entirely boundary drift — on stock's spans our encoder was 291  */
/* bytes SMALLER than stock).                                          */
/* The split resumes at raw offset `start` and stops after            */
/* `max_blocks` blocks (0: at the end). A cut carries no state but the */
/* raw offset (an open run moves whole into the next block), so from a */
/* block boundary it gives the blocks that one pass gives there.       */

static PyObject *py_rle1_split(PyObject *self, PyObject *args, PyObject *kwargs) {
    static char *kwlist[] = {"data", "level", "start", "max_blocks", NULL};
    Py_buffer view;
    int level;
    Py_ssize_t start = 0, max_blocks = 0;
    if (!PyArg_ParseTupleAndKeywords(args, kwargs, "y*i|nn", kwlist, &view, &level, &start, &max_blocks))
        return NULL;
    if (level < 1 || level > 9) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "level must be 1..9");
        return NULL;
    }
    if (start < 0 || start > view.len || max_blocks < 0) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "start must be in 0..len(data) and max_blocks >= 0");
        return NULL;
    }
    const uint8_t *in = (const uint8_t *)view.buf;
    size_t n = (size_t)view.len;
    size_t cap = (size_t)level * 100000 - 19; /* bzlib nblockMAX */

    PyObject *blocks = PyList_New(0);
    uint8_t *out = (uint8_t *)malloc(cap + 8);
    if (!blocks || !out) goto oom;

    size_t i = (size_t)start;
    while (i < n && (max_blocks == 0 || PyList_GET_SIZE(blocks) < max_blocks)) {
        size_t out_len = 0;
        size_t raw_start = i;
        uint32_t crc = 0xFFFFFFFFu;
        Py_BEGIN_ALLOW_THREADS
        while (i < n) {
            if (out_len >= cap) break; /* stock: first crossing flush ends the block */
            /* measure the run at i, capped at 255 raw bytes (one piece) */
            uint8_t v = in[i];
            size_t run = 1;
            size_t lim = i + 255 < n ? i + 255 : n;
            while (i + run < lim && in[i + run] == v) run++;
            if (run >= 4) {
                out[out_len] = v; out[out_len + 1] = v;
                out[out_len + 2] = v; out[out_len + 3] = v;
                out[out_len + 4] = (uint8_t)(run - 4);
                out_len += 5;
            } else {
                for (size_t k = 0; k < run; k++) out[out_len + k] = v;
                out_len += run;
            }
            for (size_t k = 0; k < run; k++)
                crc = (crc << 8) ^ crc_table[(crc >> 24) ^ v];
            i += run;
        }
        Py_END_ALLOW_THREADS
        if (out_len == 0) break; /* defensive; cap >= 5 so impossible */
        PyObject *tup = Py_BuildValue(
            "(y#nI)", (const char *)out, (Py_ssize_t)out_len,
            (Py_ssize_t)(i - raw_start), (unsigned int)(crc ^ 0xFFFFFFFFu));
        if (!tup || PyList_Append(blocks, tup) < 0) { Py_XDECREF(tup); goto oom; }
        Py_DECREF(tup);
    }
    free(out);
    PyBuffer_Release(&view);
    return blocks;

oom:
    free(out);
    Py_XDECREF(blocks);
    PyBuffer_Release(&view);
    return PyErr_NoMemory();
}

/* Inverse RLE1 + CRC over an already-BWT-inverted block (the host tail of
   the DEVICE decode path: Huffman/MTF/IBWT run on the TPU, this single
   linear pass undoes the RLE1 pre-pass — reference
   include/BlockDecompressor.hpp:55-90 — and folds the block CRC). */
static PyObject *py_inverse_rle1(PyObject *self, PyObject *args) {
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "y*", &view)) return NULL;
    const uint8_t *in = (const uint8_t *)view.buf;
    size_t n = (size_t)view.len;
    Vec out = {NULL, 0, 0};
    uint32_t crc = 0xFFFFFFFFu;
    int oom = 0;
    Py_BEGIN_ALLOW_THREADS
    {
        uint8_t prev = 0;
        int run_count = 0;
        if (vec_reserve(&out, n)) oom = 1;
        for (size_t i = 0; i < n && !oom; i++) {
            uint8_t c = in[i];
            if (run_count == 4) {
                if (c) {
                    if (vec_reserve(&out, c)) { oom = 1; break; }
                    memset(out.buf + out.len, prev, c);
                    out.len += c;
                    for (int k = 0; k < (int)c; k++)
                        crc = (crc << 8) ^ crc_table[(crc >> 24) ^ prev];
                }
                run_count = 0;
                continue;
            }
            if (c == prev) run_count++;
            else { run_count = 1; prev = c; }
            if (vec_reserve(&out, 1)) { oom = 1; break; }
            out.buf[out.len++] = c;
            crc = (crc << 8) ^ crc_table[(crc >> 24) ^ c];
        }
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&view);
    if (oom) { free(out.buf); return PyErr_NoMemory(); }
    PyObject *res = Py_BuildValue(
        "(y#I)", (const char *)out.buf, (Py_ssize_t)out.len,
        (unsigned int)(crc ^ 0xFFFFFFFFu));
    free(out.buf);
    return res;
}

static PyObject *py_crc32(PyObject *self, PyObject *args) {
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "y*", &view)) return NULL;
    uint32_t s = 0xFFFFFFFFu;
    Py_BEGIN_ALLOW_THREADS
    s = crc_update(s, (const uint8_t *)view.buf, (size_t)view.len);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&view);
    return PyLong_FromUnsignedLong(s ^ 0xFFFFFFFFu);
}

static PyMethodDef methods[] = {
    {"decode_stream", (PyCFunction)py_decode_stream, METH_VARARGS | METH_KEYWORDS,
     "Decode a .bz2 stream to bytes (raises ValueError / CrcError)."},
    {"crc32", py_crc32, METH_VARARGS, "CRC-32/BZIP2 of a buffer (finalized)."},
    {"rle1_split", (PyCFunction)py_rle1_split, METH_VARARGS | METH_KEYWORDS,
     "rle1_split(data, level, start=0, max_blocks=0): RLE1-encode and split into blocks from raw "
     "offset start (a block boundary), at most max_blocks of them (0: to the end): "
     "[(block_bytes, raw_len, crc), ...]."},
    {"scan_blocks", py_scan_blocks, METH_VARARGS,
     "Scan for block/end markers: ([header_bit_offsets], [end_bit_offsets])."},
    {"parse_block_header", py_parse_block_header, METH_VARARGS,
     "parse_block_header(data, bit_offset) -> (crc, randomised, orig_ptr, used_bytes, selectors, "
     "lengths, data_start_bit)."},
    {"decode_block_at", py_decode_block_at, METH_VARARGS,
     "decode_block_at(data, bit_offset, level, verify) -> (bytes, crc, end_bit)."},
    {"inverse_rle1", py_inverse_rle1, METH_VARARGS,
     "inverse_rle1(bwt_walked_bytes) -> (bytes, crc)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_bz2dec", "bz2tpu native decode core", -1, methods,
};

PyMODINIT_FUNC PyInit__bz2dec(void) {
    crc_init_table();
    scan_init_filter();
    PyObject *m = PyModule_Create(&moduledef);
    if (!m) return NULL;
    CrcError = PyErr_NewException("_bz2dec.CrcError", PyExc_ValueError, NULL);
    Py_XINCREF(CrcError);
    if (PyModule_AddObject(m, "CrcError", CrcError) < 0) {
        Py_XDECREF(CrcError);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
