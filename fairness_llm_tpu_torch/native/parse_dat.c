/* Fast single-pass parser for MovieLens "::"-separated numeric tables (the
 * port's copy of fairness_llm_tpu/native/parse_dat.c).
 *
 * The original study parses ratings.dat (1,000,209 rows) with pandas'
 * python engine because of the two-char separator, the slowest path there
 * is. This parser does one pass over the raw bytes, no allocation per row,
 * writing straight into caller-provided numpy buffers via ctypes.
 *
 * Contract: each line is `a::b::c[::d...]` with the first three fields
 * numeric (user_id::movie_id::rating). Extra fields (timestamp) are skipped.
 * Returns the number of rows parsed, or -1 on I/O error, -2 if out_cap was
 * too small, -3 on a malformed line.
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <stdint.h>

static const char *parse_long(const char *p, const char *end, long *out) {
    long v = 0;
    int neg = 0;
    if (p < end && *p == '-') { neg = 1; p++; }
    while (p < end && *p >= '0' && *p <= '9') {
        /* Clamp instead of overflowing: a hostile digit run must not trigger
         * signed-overflow UB. Real ids are < 2^31; clamped rows then fail the
         * int32 range downstream rather than corrupting memory semantics. */
        if (v < (1L << 56)) v = v * 10 + (*p - '0');
        p++;
    }
    *out = neg ? -v : v;
    return p;
}

static const char *parse_double(const char *p, const char *end, double *out) {
    long ip = 0;
    p = parse_long(p, end, &ip);
    double v = (double)ip;
    if (p < end && *p == '.') {
        p++;
        double scale = 0.1;
        while (p < end && *p >= '0' && *p <= '9') {
            v += (*p - '0') * scale;
            scale *= 0.1;
            p++;
        }
    }
    *out = v;
    return p;
}

/* Exactly "::" between numeric fields — a single colon or a ":::" run makes
 * the NEXT field start with ':' which python's int()/split("::") combination
 * rejects, so both are malformed here too. NULL signals the error. */
static const char *expect_sep(const char *p, const char *end) {
    if (p + 1 >= end || p[0] != ':' || p[1] != ':') return NULL;
    p += 2;
    if (p < end && *p == ':') return NULL; /* ":::" -> next field starts with ':' */
    return p;
}

long parse_ratings(const char *path, int32_t *users, int32_t *movies,
                   float *values, long out_cap) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    /* ftell on a non-seekable path (FIFO) returns -1; feeding that size to
     * malloc/fread would be a 0-byte buffer with an unbounded read. */
    if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return -1; }
    long size = ftell(f);
    if (size < 0) { fclose(f); return -1; }
    if (fseek(f, 0, SEEK_SET) != 0) { fclose(f); return -1; }
    char *buf = (char *)malloc(size + 1);
    if (!buf) { fclose(f); return -1; }
    if ((long)fread(buf, 1, size, f) != size) { free(buf); fclose(f); return -1; }
    fclose(f);
    buf[size] = '\0';

    const char *p = buf;
    const char *end = buf + size;
    long n = 0;
    while (p < end) {
        while (p < end && (*p == '\n' || *p == '\r')) p++;
        if (p >= end) break;
        if (n >= out_cap) { free(buf); return -2; }
        long user, movie;
        double val;
        const char *q;
        /* Strict: every field must consume digits and be followed by the
         * separator (or EOL for the last). A malformed line returns -3 so the
         * caller raises — matching the pure-Python path's ValueError instead
         * of silently emitting phantom (0, 0, 0.0) rows. */
        q = parse_long(p, end, &user);
        if (q == p) { free(buf); return -3; }
        p = expect_sep(q, end);
        if (!p) { free(buf); return -3; }
        q = parse_long(p, end, &movie);
        if (q == p) { free(buf); return -3; }
        p = expect_sep(q, end);
        if (!p) { free(buf); return -3; }
        q = parse_double(p, end, &val);
        if (q == p) { free(buf); return -3; }
        if (q < end && *q != ':' && *q != '\n' && *q != '\r') { free(buf); return -3; }
        /* After the rating: "::" starts the (ignored) extra field, whose
         * CONTENT may be anything including more colons — python's
         * split("::") puts it all in field 4. A single ':' means the rating
         * field itself continued with garbage ("5:978"), which python's
         * float() rejects too. */
        if (q < end && *q == ':' && (q + 1 >= end || q[1] != ':')) { free(buf); return -3; }
        p = q;
        /* int32 range check: the pure-Python fallback raises OverflowError on
         * out-of-range ids; silent (int32_t) truncation would diverge. */
        if (user > 2147483647L || user < -2147483648L ||
            movie > 2147483647L || movie < -2147483648L) { free(buf); return -3; }
        users[n] = (int32_t)user;
        movies[n] = (int32_t)movie;
        values[n] = (float)val;
        n++;
        while (p < end && *p != '\n') p++;
    }
    free(buf);
    return n;
}

/* Count lines (for sizing output buffers without a Python pre-pass). */
long count_lines(const char *path) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    char chunk[1 << 16];
    size_t got;
    long lines = 0;
    int last = '\n';
    while ((got = fread(chunk, 1, sizeof(chunk), f)) > 0) {
        for (size_t i = 0; i < got; i++)
            if (chunk[i] == '\n') lines++;
        last = chunk[got - 1];
    }
    fclose(f);
    if (last != '\n') lines++;
    return lines;
}
