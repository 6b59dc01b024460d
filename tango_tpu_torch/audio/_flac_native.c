/* Native FLAC subframe decoder — the hot loop of audio/flac.py.
 *
 * The pure-python decoder is exact but ~1-3 s per 10 s clip (bit-level rice
 * decoding and the LPC recurrence dominate). This C implementation decodes
 * ONE subframe (constant/verbatim/fixed/LPC + rice/rice2 residuals + wasted
 * bits) from a bit position and writes int64 samples; the python side keeps
 * all container/frame-header/stereo logic and falls back to its own path if
 * this library is unavailable. Compiled on demand by audio/flac_native.py
 * (g++ -O2 -shared) and loaded with ctypes — no build step, no pybind11.
 *
 * Arithmetic notes: samples and the LPC accumulator use int64. For valid
 * streams the accumulator is bounded by order * 2^(bps+precision) <= 2^53
 * (order<=32, bps<=33 incl. the side-channel bit, precision<=15), so there
 * is no overflow class; the >> shift is an arithmetic shift on int64 exactly
 * like the python implementation's floor shift.
 */

#include <stdint.h>
#include <stddef.h>

#define ERR_TRUNCATED   (-1)
#define ERR_RESERVED    (-2)
#define ERR_BAD_PARAM   (-3)

typedef struct {
    const uint8_t *buf;
    int64_t len_bits;
    int64_t pos;
} bits_t;

static int read_bits(bits_t *b, int n, uint64_t *out) {
    if (b->pos + n > b->len_bits) return ERR_TRUNCATED;
    uint64_t v = 0;
    int64_t p = b->pos;
    b->pos += n;
    while (n > 0) {
        int64_t byte_i = p >> 3;
        int bit_off = (int)(p & 7);
        int take = 8 - bit_off;
        if (take > n) take = n;
        uint64_t chunk = (uint64_t)(b->buf[byte_i] >> (8 - bit_off - take)) &
                         ((1u << take) - 1u);
        v = (v << take) | chunk;
        p += take;
        n -= take;
    }
    *out = v;
    return 0;
}

static int read_signed(bits_t *b, int n, int64_t *out) {
    uint64_t v;
    int rc = read_bits(b, n, &v);
    if (rc) return rc;
    if (n > 0 && (v >> (n - 1)))
        *out = (int64_t)v - ((int64_t)1 << n);
    else
        *out = (int64_t)v;
    return 0;
}

static int read_unary(bits_t *b, int64_t *out) {
    int64_t q = 0;
    for (;;) {
        if (b->pos >= b->len_bits) return ERR_TRUNCATED;
        int64_t byte_i = b->pos >> 3;
        int rem = 8 - (int)(b->pos & 7);
        uint8_t byte = b->buf[byte_i] & (uint8_t)((1u << rem) - 1u);
        if (byte) {
            int bl = 0;                       /* bit_length(byte) */
            for (uint8_t t = byte; t; t >>= 1) bl++;
            int lz = rem - bl;
            b->pos += lz + 1;
            *out = q + lz;
            return 0;
        }
        q += rem;
        b->pos += rem;
    }
}

static int decode_residual(bits_t *b, int block_size, int pred_order,
                           int64_t *out) {
    uint64_t method, part_order, param, raw;
    int rc;
    if ((rc = read_bits(b, 2, &method))) return rc;
    if (method > 1) return ERR_RESERVED;
    int param_bits = method == 0 ? 4 : 5;
    uint64_t escape = (1u << param_bits) - 1u;
    if ((rc = read_bits(b, 4, &part_order))) return rc;
    int n_parts = 1 << part_order;
    if (block_size % n_parts) return ERR_BAD_PARAM;
    int part_len = block_size >> part_order;
    int64_t k = 0;
    for (int pi = 0; pi < n_parts; pi++) {
        int n = part_len - (pi == 0 ? pred_order : 0);
        if (n < 0) return ERR_BAD_PARAM;
        if ((rc = read_bits(b, param_bits, &param))) return rc;
        if (param == escape) {
            if ((rc = read_bits(b, 5, &raw))) return rc;
            if (raw == 0) {
                for (int i = 0; i < n; i++) out[k++] = 0;
            } else {
                for (int i = 0; i < n; i++) {
                    int64_t v;
                    if ((rc = read_signed(b, (int)raw, &v))) return rc;
                    out[k++] = v;
                }
            }
            continue;
        }
        for (int i = 0; i < n; i++) {
            int64_t q;
            uint64_t rem = 0;
            if ((rc = read_unary(b, &q))) return rc;
            if (param && (rc = read_bits(b, (int)param, &rem))) return rc;
            uint64_t u = ((uint64_t)q << param) | rem;
            out[k++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
        }
    }
    return 0;
}

static const int FIXED_COEFFS[5][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0}, {3, -3, 1, 0}, {4, -6, 4, -1},
};

/* Decode one subframe. Returns the new bit position (>=0) or a negative
 * error code. out must hold block_size int64s. */
int64_t flac_decode_subframe(const uint8_t *buf, int64_t len_bytes,
                             int64_t pos_bits, int32_t block_size,
                             int32_t bps, int64_t *out) {
    bits_t b = {buf, len_bytes * 8, pos_bits};
    uint64_t pad, sf_type, wflag;
    int rc;
    if ((rc = read_bits(&b, 1, &pad))) return rc;
    if (pad) return ERR_RESERVED;
    if ((rc = read_bits(&b, 6, &sf_type))) return rc;
    if ((rc = read_bits(&b, 1, &wflag))) return rc;
    int wasted = 0;
    if (wflag) {
        int64_t w;
        if ((rc = read_unary(&b, &w))) return rc;
        wasted = (int)w + 1;
        bps -= wasted;
    }
    if (bps <= 0 || bps > 33) return ERR_BAD_PARAM;

    if (sf_type == 0) {                     /* CONSTANT */
        int64_t v;
        if ((rc = read_signed(&b, bps, &v))) return rc;
        for (int i = 0; i < block_size; i++) out[i] = v;
    } else if (sf_type == 1) {              /* VERBATIM */
        for (int i = 0; i < block_size; i++)
            if ((rc = read_signed(&b, bps, &out[i]))) return rc;
    } else if (sf_type >= 8 && sf_type <= 12) {   /* FIXED order 0-4 */
        int order = (int)sf_type - 8;
        /* order > block_size would overrun out[] in the warmup loop below
         * (the python path rejects it via the residual length check) */
        if (order > block_size) return ERR_BAD_PARAM;
        for (int i = 0; i < order; i++)
            if ((rc = read_signed(&b, bps, &out[i]))) return rc;
        if ((rc = decode_residual(&b, block_size, order, out + order)))
            return rc;
        const int *c = FIXED_COEFFS[order];
        /* valid subframe samples fit bps bits; rejecting the first escapee
         * keeps every |out| < 2^32, so the accumulator below is bounded by
         * order * 2^(coeff_bits) * 2^32 << 2^63 — no signed-overflow UB on
         * crafted streams (same accept/reject set as the python path) */
        const int64_t lim = (int64_t)1 << (bps - 1);
        for (int i = order; i < block_size; i++) {
            int64_t acc = 0;
            for (int j = 0; j < order; j++) acc += (int64_t)c[j] * out[i - 1 - j];
            out[i] += acc;                  /* out[i] held the residual */
            if (out[i] >= lim || out[i] < -lim) return ERR_BAD_PARAM;
        }
    } else if (sf_type >= 32) {             /* LPC order 1-32 */
        int order = (int)sf_type - 31;
        int64_t coeffs[32];
        if (order > block_size) return ERR_BAD_PARAM;  /* out[] overrun guard */
        for (int i = 0; i < order; i++)
            if ((rc = read_signed(&b, bps, &out[i]))) return rc;
        uint64_t precision;
        if ((rc = read_bits(&b, 4, &precision))) return rc;
        if (precision == 0xF) return ERR_RESERVED;
        precision += 1;
        int64_t shift;
        if ((rc = read_signed(&b, 5, &shift))) return rc;
        if (shift < 0) return ERR_RESERVED;
        for (int i = 0; i < order; i++)
            if ((rc = read_signed(&b, (int)precision, &coeffs[i]))) return rc;
        if ((rc = decode_residual(&b, block_size, order, out + order)))
            return rc;
        /* same per-sample bps bound as the FIXED path (see comment there):
         * keeps the int64 accumulator provably overflow-free */
        const int64_t lim = (int64_t)1 << (bps - 1);
        for (int i = order; i < block_size; i++) {
            int64_t acc = 0;
            for (int j = 0; j < order; j++) acc += coeffs[j] * out[i - 1 - j];
            out[i] += acc >> shift;
            if (out[i] >= lim || out[i] < -lim) return ERR_BAD_PARAM;
        }
    } else {
        return ERR_RESERVED;
    }
    if (wasted)
        for (int i = 0; i < block_size; i++) out[i] <<= wasted;
    return b.pos;
}
