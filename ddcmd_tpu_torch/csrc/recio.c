/* recio: native record codec for pio-style collection files.
 *
 * TPU-native replacement for the runtime role of LLNL simutil's pio +
 * pioVariableRecordHelper (sources absent from the reference mount;
 * interface reconstructed from call sites, see SURVEY.md L0).  The hot
 * ASCII paths -- parsing atoms# shards into SoA arrays and formatting
 * them back -- run here in C; Python keeps the header/object logic.
 *
 * Build: cc -O2 -shared -fPIC -o libddcmdrecio.so recio.c
 * Binding: ctypes (ddcmd_tpu_torch/io/fastio.py, which builds this copy;
 * the JAX package keeps its own in ddcmd_tpu/native/).
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* field kinds */
#define FK_SKIP 0
#define FK_FLOAT 1
#define FK_UDEC 2
#define FK_UHEX 3
#define FK_STR 4

static const char *skip_ws(const char *p, const char *end)
{
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
        p++;
    return p;
}

static const char *skip_tok(const char *p, const char *end)
{
    while (p < end && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n')
        p++;
    return p;
}

/* Parse whitespace-separated records of nfields columns.
 * floats  -> out_f (column-major blocks: [fcol][record])
 * uints   -> out_u (same layout per ucol)
 * strings -> out_s, fixed str_width bytes per entry, NUL padded
 * Returns the number of records parsed, or -1 on error. */
long recio_parse(const char *buf, long nbytes, int nfields,
                 const int *kinds, long max_records, int str_width,
                 double *out_f, unsigned long long *out_u, char *out_s)
{
    const char *p = buf;
    const char *end = buf + nbytes;
    long rec = 0;
    int nf = 0, nu = 0, ns = 0;
    for (int i = 0; i < nfields; ++i) {
        if (kinds[i] == FK_FLOAT) nf++;
        else if (kinds[i] == FK_UDEC || kinds[i] == FK_UHEX) nu++;
        else if (kinds[i] == FK_STR) ns++;
    }
    while (rec < max_records) {
        p = skip_ws(p, end);
        if (p >= end)
            break;
        int fi = 0, ui = 0, si = 0;
        for (int col = 0; col < nfields; ++col) {
            p = skip_ws(p, end);
            if (p >= end)
                return (col == 0) ? rec : -1;
            const char *tok_end = skip_tok(p, end);
            switch (kinds[col]) {
            case FK_FLOAT: {
                char *ep;
                out_f[(long)fi * max_records + rec] = strtod(p, &ep);
                fi++;
                break;
            }
            case FK_UDEC: {
                char *ep;
                out_u[(long)ui * max_records + rec] =
                    strtoull(p, &ep, 10);
                ui++;
                break;
            }
            case FK_UHEX: {
                char *ep;
                out_u[(long)ui * max_records + rec] =
                    strtoull(p, &ep, 16);
                ui++;
                break;
            }
            case FK_STR: {
                long len = tok_end - p;
                if (len > str_width - 1)
                    len = str_width - 1;
                char *dst = out_s + ((long)si * max_records + rec) * str_width;
                memcpy(dst, p, (size_t)len);
                dst[len] = '\0';
                si++;
                break;
            }
            default:
                break;
            }
            p = tok_end;
        }
        rec++;
    }
    return rec;
}

/* Format records: "id class species group rx..vz" style.
 * gid printed decimal (hex=0) or hex (hex=1); floats as %21.13e.
 * Returns bytes written (excluding NUL), or -1 if out too small. */
long recio_format(long n, const unsigned long long *gid, int hex,
                  const char *const_strs, int str_width, int nstr,
                  const double *floats, int nfloat,
                  char *out, long out_cap)
{
    long w = 0;
    for (long i = 0; i < n; ++i) {
        if (out_cap - w < 64L + (long)nstr * str_width + 24L * nfloat)
            return -1;
        int k;
        if (hex)
            k = snprintf(out + w, out_cap - w, "%14llx", gid[i]);
        else
            k = snprintf(out + w, out_cap - w, "%14llu", gid[i]);
        w += k;
        for (int s = 0; s < nstr; ++s) {
            const char *sp = const_strs + ((long)s * n + i) * str_width;
            k = snprintf(out + w, out_cap - w, " %s", sp);
            w += k;
        }
        for (int f = 0; f < nfloat; ++f) {
            k = snprintf(out + w, out_cap - w, " %21.13e",
                         floats[(long)f * n + i]);
            w += k;
        }
        out[w++] = '\n';
    }
    return w;
}

/* ---- per-row crc32 (zlib polynomial) for binary record writers ------- */

static unsigned int crc_table[256];
static int crc_table_ready = 0;

static void crc32_init(void)
{
    for (unsigned int i = 0; i < 256; ++i) {
        unsigned int c = i;
        for (int k = 0; k < 8; ++k)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[i] = c;
    }
    crc_table_ready = 1;
}

/* crc32 of bytes [skip, lrec) of each of n rows of a (n, lrec) buffer
 * (FIXRECORDBINARY / bxyz checksum fields,
 * ddcMD src/collection_write.c:338-410). */
void recio_crc32_rows(const unsigned char *data, long n, long lrec,
                      long skip, unsigned int *out)
{
    if (!crc_table_ready)
        crc32_init();
    for (long i = 0; i < n; ++i) {
        const unsigned char *p = data + i * lrec + skip;
        unsigned int c = 0xFFFFFFFFu;
        for (long j = skip; j < lrec; ++j)
            c = crc_table[(c ^ *p++) & 0xFF] ^ (c >> 8);
        out[i] = c ^ 0xFFFFFFFFu;
    }
}
