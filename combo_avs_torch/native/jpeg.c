/* JPEG decoding and encoding on the host, for the data path's frames.
 *
 * The decoder gives the pixels that libjpeg(-turbo) gives with its default
 * decompression settings (the JAX package's native reader,
 * combo_avs_tpu/native/combo_io.cpp::decode_jpeg, and cv2.imread):
 *   - baseline and extended-sequential Huffman (SOF0, SOF1) and progressive
 *     Huffman (SOF2), 8-bit samples, one component (gray) or three (YCbCr);
 *   - sampling factors whose ratio to the largest is an integer; restart
 *     intervals; byte stuffing; sizes that are not a multiple of the MCU;
 *   - the "islow" integer inverse DCT (jidctint.c: CONST_BITS 13,
 *     PASS1_BITS 2, its roundings and the range limit of the +128-centred
 *     result);
 *   - "fancy" upsampling (jdsample.c): h2v1 and h2v2 triangle filters with
 *     their alternating biases and edge columns, where the component is
 *     more than 2 samples wide, h1v2 always; replication for every other
 *     integer ratio; context rows clamped to the component's edge;
 *   - the YCbCr -> RGB tables of jdcolor.c (SCALEBITS 16, ONE_HALF folded
 *     into the Cb -> G table). A gray read of a colour file is the Y plane.
 * EXIF orientation is not applied (the JAX native reader does not apply it).
 * It refuses, with a message naming the feature: arithmetic coding,
 * lossless and hierarchical frames, 12-bit samples, 2 or 4 components
 * (CMYK, YCCK), RGB files (Adobe transform 0, or R/G/B component ids), a
 * height defined by DNL, fractional sampling ratios, and a progressive file
 * whose scans leave low AC coefficients unrefined (libjpeg would smooth
 * those blocks).
 *
 * The encoder writes baseline JPEG as libjpeg(-turbo) does with its default
 * compression settings (cv2.imwrite's): gray or YCbCr at 4:2:0 or 4:4:4, a
 * JFIF APP0, the Annex K quantisation tables scaled by jpeg_quality_scaling,
 * the Annex K Huffman tables, the islow forward DCT (jfdctint.c), libjpeg's
 * RGB -> YCbCr tables and h2v2 box downsampling with biases 1, 2, its edge
 * replication and its dummy blocks.
 *
 * A plain C interface for ctypes (combo_avs_torch/data/jpeg.py); every
 * buffer belongs to the caller, and an error comes back as a nonzero code
 * with a message, never as an abort.
 */

#include <setjmp.h>
#include <stdarg.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* zigzag index -> natural (row-major) index; 16 spare entries keep a
 * corrupt run inside the block, as libjpeg's table does */
static const int NATURAL[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

#define LOOKAHEAD 9

typedef struct {
  uint8_t bits[17];
  uint8_t vals[256];
  int present;
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint16_t lut[1 << LOOKAHEAD]; /* (length << 8) | symbol; 0: longer code */
} htable;

typedef struct {
  int id, h, v, tq;
  int bw, bh;   /* blocks stored: the MCU grid's */
  int dw, dh;   /* samples of the component (jpeg "downsampled" size) */
  int bwr, bhr; /* blocks that hold them */
  int16_t *coef;
  int qlatched;
  int32_t q[64];
  int coef_bits[64];
  int dc_pred;
  uint8_t *plane; /* bw*8 x bh*8 samples */
} comp_t;

typedef struct {
  const uint8_t *data;
  size_t size, pos;
  jmp_buf jb;
  char *err;
  size_t errlen;
  int32_t qt[4][64];
  int qt_present[4];
  htable dc[4], ac[4];
  int restart_interval;
  int width, height, ncomp, progressive, sof_seen, scans;
  int hmax, vmax, mcux, mcuy;
  comp_t comp[4];
  int jfif, adobe, adobe_transform;
  uint64_t acc;
  int nbits, marker_hit;
  int eobrun;
  uint8_t *full[3]; /* each output component at full resolution */
} dec_t;

static void fail(dec_t *d, const char *fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(d->err, d->errlen, fmt, ap);
  va_end(ap);
  longjmp(d->jb, 1);
}

static void free_dec(dec_t *d) {
  for (int i = 0; i < 4; i++) {
    free(d->comp[i].coef);
    free(d->comp[i].plane);
    d->comp[i].coef = NULL;
    d->comp[i].plane = NULL;
  }
  for (int i = 0; i < 3; i++) {
    free(d->full[i]);
    d->full[i] = NULL;
  }
}

static void *xcalloc(dec_t *d, size_t n) {
  void *p = calloc(n ? n : 1, 1);
  if (!p) fail(d, "out of memory (%zu bytes)", n);
  return p;
}

static int u8(dec_t *d) {
  if (d->pos >= d->size) fail(d, "truncated JPEG header");
  return d->data[d->pos++];
}

static int u16(dec_t *d) {
  int hi = u8(d);
  return (hi << 8) | u8(d);
}

/* ------------------------------------------------------------ bit reader */

static void fill(dec_t *d) {
  while (d->nbits <= 56) {
    uint32_t b = 0;
    if (!d->marker_hit && d->pos < d->size) {
      b = d->data[d->pos];
      if (b == 0xFF) {
        size_t q = d->pos + 1;
        while (q < d->size && d->data[q] == 0xFF) q++;
        if (q < d->size && d->data[q] == 0x00) {
          d->pos = q + 1;
        } else { /* a marker: feed zeros from here on, as libjpeg does */
          d->marker_hit = 1;
          b = 0;
        }
      } else {
        d->pos++;
      }
    }
    d->acc |= (uint64_t)b << (56 - d->nbits);
    d->nbits += 8;
  }
}

static inline int getbits(dec_t *d, int n) {
  if (n == 0) return 0;
  if (d->nbits < n) fill(d);
  int v = (int)(d->acc >> (64 - n));
  d->acc <<= n;
  d->nbits -= n;
  return v;
}

static inline int getbit(dec_t *d) { return getbits(d, 1); }

static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (int)((unsigned)-1 << s) + 1 : v;
}

static void build_htable(dec_t *d, htable *t) {
  int code = 0, k = 0;
  memset(t->lut, 0, sizeof(t->lut));
  for (int l = 1; l <= 16; l++) {
    t->valptr[l] = k;
    t->mincode[l] = code;
    for (int i = 0; i < t->bits[l]; i++) {
      if (l <= LOOKAHEAD) {
        int base = code << (LOOKAHEAD - l);
        for (int s = 0; s < (1 << (LOOKAHEAD - l)); s++)
          t->lut[base + s] = (uint16_t)((l << 8) | t->vals[k]);
      }
      code++;
      k++;
    }
    if (code > (1 << l)) fail(d, "bad Huffman table");
    t->maxcode[l] = t->bits[l] ? code - 1 : -1;
    code <<= 1;
  }
  t->maxcode[17] = 0x7FFFFFFF;
}

static inline int huff(dec_t *d, const htable *t) {
  if (d->nbits < 16) fill(d);
  int e = t->lut[d->acc >> (64 - LOOKAHEAD)];
  if (e) {
    int len = e >> 8;
    d->acc <<= len;
    d->nbits -= len;
    return e & 0xFF;
  }
  int code = 0;
  for (int l = 1; l <= 16; l++) {
    code = (code << 1) | (int)((d->acc >> (64 - l)) & 1);
    if (t->maxcode[l] >= 0 && code <= t->maxcode[l]) {
      d->acc <<= l;
      d->nbits -= l;
      return t->vals[t->valptr[l] + code - t->mincode[l]];
    }
  }
  fail(d, "corrupt JPEG data: bad Huffman code");
  return 0;
}

/* ---------------------------------------------------------------- markers */

static void skip_segment(dec_t *d) {
  int len = u16(d);
  if (len < 2 || d->pos + (size_t)(len - 2) > d->size) fail(d, "truncated JPEG segment");
  d->pos += (size_t)(len - 2);
}

static void read_app(dec_t *d, int marker) {
  int len = u16(d);
  if (len < 2 || d->pos + (size_t)(len - 2) > d->size) fail(d, "truncated JPEG segment");
  const uint8_t *p = d->data + d->pos;
  int n = len - 2;
  if (marker == 0xE0 && n >= 5 && memcmp(p, "JFIF\0", 5) == 0) d->jfif = 1;
  if (marker == 0xEE && n >= 12 && memcmp(p, "Adobe", 5) == 0) {
    d->adobe = 1;
    d->adobe_transform = p[11];
  }
  d->pos += (size_t)n;
}

static void read_dqt(dec_t *d) {
  int len = u16(d) - 2;
  while (len > 0) {
    int pq_tq = u8(d);
    int pq = pq_tq >> 4, tq = pq_tq & 15;
    if (tq > 3 || pq > 1) fail(d, "bad DQT table %d precision %d", tq, pq);
    for (int i = 0; i < 64; i++) d->qt[tq][NATURAL[i]] = pq ? u16(d) : u8(d);
    d->qt_present[tq] = 1;
    len -= 1 + 64 * (pq + 1);
  }
  if (len != 0) fail(d, "bad DQT length");
}

static void read_dht(dec_t *d) {
  int len = u16(d) - 2;
  while (len > 0) {
    int tc_th = u8(d);
    int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3) fail(d, "bad DHT class %d table %d", tc, th);
    htable *t = tc ? &d->ac[th] : &d->dc[th];
    int total = 0;
    t->bits[0] = 0;
    for (int l = 1; l <= 16; l++) {
      t->bits[l] = (uint8_t)u8(d);
      total += t->bits[l];
    }
    if (total > 256) fail(d, "bad DHT: %d symbols", total);
    for (int i = 0; i < total; i++) t->vals[i] = (uint8_t)u8(d);
    build_htable(d, t);
    t->present = 1;
    len -= 17 + total;
  }
  if (len != 0) fail(d, "bad DHT length");
}

static void read_sof(dec_t *d, int marker) {
  if (d->sof_seen) fail(d, "two SOF markers");
  int len = u16(d);
  int precision = u8(d);
  d->height = u16(d);
  d->width = u16(d);
  d->ncomp = u8(d);
  if (len != 8 + 3 * d->ncomp) fail(d, "bad SOF length");
  if (precision != 8)
    fail(d, "unsupported JPEG: %d-bit samples (only 8-bit is decoded)", precision);
  if (d->height == 0)
    fail(d, "unsupported JPEG: the height is defined by a DNL marker");
  if (d->width == 0) fail(d, "bad JPEG: width 0");
  if (d->ncomp == 4)
    fail(d, "unsupported JPEG: 4 components (CMYK or YCCK; only gray and YCbCr are decoded)");
  if (d->ncomp != 1 && d->ncomp != 3)
    fail(d, "unsupported JPEG: %d components (only gray and YCbCr are decoded)", d->ncomp);
  d->progressive = marker == 0xC2;
  d->hmax = d->vmax = 1;
  for (int i = 0; i < d->ncomp; i++) {
    comp_t *c = &d->comp[i];
    c->id = u8(d);
    int hv = u8(d);
    c->h = hv >> 4;
    c->v = hv & 15;
    c->tq = u8(d);
    if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4 || c->tq > 3)
      fail(d, "bad SOF component %d", i);
    if (c->h > d->hmax) d->hmax = c->h;
    if (c->v > d->vmax) d->vmax = c->v;
  }
  if (d->ncomp == 3) { /* libjpeg's default_decompress_parms */
    int rgb;
    if (d->jfif)
      rgb = 0;
    else if (d->adobe)
      rgb = d->adobe_transform == 0;
    else
      rgb = d->comp[0].id == 'R' && d->comp[1].id == 'G' && d->comp[2].id == 'B';
    if (rgb) fail(d, "unsupported JPEG: RGB colour space (Adobe transform 0 or R/G/B ids)");
  }
  if (d->ncomp == 1) d->comp[0].h = d->comp[0].v = d->hmax = d->vmax = 1;
  d->mcux = (d->width + 8 * d->hmax - 1) / (8 * d->hmax);
  d->mcuy = (d->height + 8 * d->vmax - 1) / (8 * d->vmax);
  for (int i = 0; i < d->ncomp; i++) {
    comp_t *c = &d->comp[i];
    if (d->hmax % c->h || d->vmax % c->v)
      fail(d, "unsupported JPEG: fractional sampling ratio %dx%d of %dx%d", c->h, c->v,
           d->hmax, d->vmax);
    c->bw = d->mcux * c->h;
    c->bh = d->mcuy * c->v;
    c->dw = (int)(((long)d->width * c->h + d->hmax - 1) / d->hmax);
    c->dh = (int)(((long)d->height * c->v + d->vmax - 1) / d->vmax);
    c->bwr = (c->dw + 7) / 8;
    c->bhr = (c->dh + 7) / 8;
    for (int k = 0; k < 64; k++) c->coef_bits[k] = -1;
  }
  d->sof_seen = 1;
}

/* --------------------------------------------------------- entropy decode */

static void decode_block_seq(dec_t *d, comp_t *c, int16_t *blk, const htable *dct,
                             const htable *act) {
  int s = huff(d, dct);
  if (s) s = extend(getbits(d, s), s);
  c->dc_pred += s;
  blk[0] = (int16_t)c->dc_pred;
  for (int k = 1; k < 64; k++) {
    int rs = huff(d, act);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      blk[NATURAL[k]] = (int16_t)extend(getbits(d, s), s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

static void decode_dc_first(dec_t *d, comp_t *c, int16_t *blk, const htable *dct, int al) {
  int s = huff(d, dct);
  if (s) s = extend(getbits(d, s), s);
  c->dc_pred += s;
  blk[0] = (int16_t)(int)((unsigned)c->dc_pred << al);
}

static void decode_dc_refine(dec_t *d, int16_t *blk, int al) {
  if (getbit(d)) blk[0] |= (int16_t)(1 << al);
}

static void decode_ac_first(dec_t *d, int16_t *blk, const htable *act, int ss, int se,
                            int al) {
  if (d->eobrun > 0) {
    d->eobrun--;
    return;
  }
  for (int k = ss; k <= se; k++) {
    int rs = huff(d, act);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      int v = extend(getbits(d, s), s);
      blk[NATURAL[k]] = (int16_t)(int)((unsigned)v << al);
    } else {
      if (r == 15) {
        k += 15;
      } else {
        d->eobrun = 1 << r;
        if (r) d->eobrun += getbits(d, r);
        d->eobrun--;
        break;
      }
    }
  }
}

static void decode_ac_refine(dec_t *d, int16_t *blk, const htable *act, int ss, int se,
                             int al) {
  int p1 = 1 << al, m1 = (int)((unsigned)-1 << al);
  int k = ss;
  if (d->eobrun == 0) {
    for (; k <= se; k++) {
      int rs = huff(d, act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = getbit(d) ? p1 : m1;
      } else if (r != 15) {
        d->eobrun = 1 << r;
        if (r) d->eobrun += getbits(d, r);
        break;
      }
      do {
        int16_t *coef = blk + NATURAL[k];
        if (*coef != 0) {
          if (getbit(d) && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
        } else {
          if (--r < 0) break;
        }
        k++;
      } while (k <= se);
      if (s && k <= 63) blk[NATURAL[k]] = (int16_t)s;
    }
  }
  if (d->eobrun > 0) {
    for (; k <= se; k++) {
      int16_t *coef = blk + NATURAL[k];
      if (*coef != 0 && getbit(d) && (*coef & p1) == 0)
        *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
    }
    d->eobrun--;
  }
}

/* Skip to the restart marker (fill 0xFF bytes and any bits left over
 * included), then reset the predictors and the EOB run. */
static void restart(dec_t *d, comp_t **sc, int ns) {
  d->acc = 0;
  d->nbits = 0;
  d->marker_hit = 0;
  while (d->pos + 1 < d->size &&
         !(d->data[d->pos] == 0xFF && d->data[d->pos + 1] >= 0xD0 && d->data[d->pos + 1] <= 0xD7))
    d->pos++;
  if (d->pos + 1 < d->size) d->pos += 2;
  for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
  d->eobrun = 0;
}

static void read_sos(dec_t *d) {
  if (!d->sof_seen) fail(d, "SOS before SOF");
  int len = u16(d);
  int ns = u8(d);
  if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail(d, "bad SOS");
  comp_t *sc[4];
  int td[4], ta[4];
  for (int i = 0; i < ns; i++) {
    int id = u8(d), t = u8(d);
    sc[i] = NULL;
    for (int j = 0; j < d->ncomp; j++)
      if (d->comp[j].id == id) sc[i] = &d->comp[j];
    if (!sc[i]) fail(d, "SOS names an unknown component %d", id);
    td[i] = t >> 4;
    ta[i] = t & 15;
    if (td[i] > 3 || ta[i] > 3) fail(d, "bad SOS table selector");
  }
  int ss = u8(d), se = u8(d), ahal = u8(d);
  int ah = ahal >> 4, al = ahal & 15;
  if (d->progressive) {
    if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) || al > 13)
      fail(d, "bad progressive scan parameters Ss=%d Se=%d Ah=%d Al=%d", ss, se, ah, al);
  } else {
    ss = 0;
    se = 63;
    ah = al = 0;
  }
  for (int i = 0; i < ns; i++) {
    comp_t *c = sc[i];
    if (!c->coef) c->coef = (int16_t *)xcalloc(d, (size_t)c->bw * c->bh * 64 * sizeof(int16_t));
    if (!c->qlatched) { /* libjpeg latches a component's table at its first scan */
      if (!d->qt_present[c->tq]) fail(d, "missing quantisation table %d", c->tq);
      memcpy(c->q, d->qt[c->tq], sizeof(c->q));
      c->qlatched = 1;
    }
    int need_dc = !d->progressive || (ss == 0 && ah == 0);
    int need_ac = !d->progressive || ss > 0;
    if (need_dc && !d->dc[td[i]].present) fail(d, "missing DC Huffman table %d", td[i]);
    if (need_ac && !d->ac[ta[i]].present) fail(d, "missing AC Huffman table %d", ta[i]);
    for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
    c->dc_pred = 0;
  }
  d->acc = 0;
  d->nbits = 0;
  d->marker_hit = 0;
  d->eobrun = 0;
  int mode = !d->progressive ? 0 : ss == 0 ? (ah == 0 ? 1 : 2) : (ah == 0 ? 3 : 4);
  int todo = d->restart_interval;
  long nmcu;
  int mcw;
  if (ns == 1) {
    mcw = sc[0]->bwr;
    nmcu = (long)sc[0]->bwr * sc[0]->bhr;
  } else {
    mcw = d->mcux;
    nmcu = (long)d->mcux * d->mcuy;
  }
  for (long m = 0; m < nmcu; m++) {
    if (d->restart_interval) {
      if (todo == 0) {
        restart(d, sc, ns);
        todo = d->restart_interval;
      }
      todo--;
    }
    int my = (int)(m / mcw), mx = (int)(m % mcw);
    for (int i = 0; i < ns; i++) {
      comp_t *c = sc[i];
      int nv = ns == 1 ? 1 : c->v, nh = ns == 1 ? 1 : c->h;
      for (int by = 0; by < nv; by++)
        for (int bx = 0; bx < nh; bx++) {
          int row = my * nv + by, col = mx * nh + bx;
          int16_t *blk = c->coef + ((size_t)row * c->bw + col) * 64;
          switch (mode) {
            case 0: decode_block_seq(d, c, blk, &d->dc[td[i]], &d->ac[ta[i]]); break;
            case 1: decode_dc_first(d, c, blk, &d->dc[td[i]], al); break;
            case 2: decode_dc_refine(d, blk, al); break;
            case 3: decode_ac_first(d, blk, &d->ac[ta[i]], ss, se, al); break;
            default: decode_ac_refine(d, blk, &d->ac[ta[i]], ss, se, al); break;
          }
        }
    }
  }
  /* the entropy data ends at the next marker */
  d->acc = 0;
  d->nbits = 0;
  d->marker_hit = 0;
  while (d->pos + 1 < d->size &&
         !(d->data[d->pos] == 0xFF && d->data[d->pos + 1] != 0x00 && d->data[d->pos + 1] != 0xFF &&
           !(d->data[d->pos + 1] >= 0xD0 && d->data[d->pos + 1] <= 0xD7)))
    d->pos++;
  d->scans++;
}

/* Parse markers up to the first SOS (headers_only) or to EOI. */
static void parse(dec_t *d, int headers_only) {
  if (d->size < 2 || d->data[0] != 0xFF || d->data[1] != 0xD8) fail(d, "not a JPEG file");
  d->pos = 2;
  for (;;) {
    while (d->pos < d->size && d->data[d->pos] != 0xFF) d->pos++;
    while (d->pos < d->size && d->data[d->pos] == 0xFF) d->pos++;
    if (d->pos >= d->size) break; /* no EOI: libjpeg warns and ends the image */
    int m = d->data[d->pos++];
    if (m == 0xD9) break;
    if (m >= 0xD0 && m <= 0xD7) continue;
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2:
        read_sof(d, m);
        if (headers_only) return;
        break;
      case 0xC3: fail(d, "unsupported JPEG: lossless (SOF3)"); break;
      case 0xC5: case 0xC6: case 0xC7:
        fail(d, "unsupported JPEG: hierarchical (SOF%d)", m - 0xC0); break;
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        fail(d, "unsupported JPEG: arithmetic coding (SOF%d)", m - 0xC0); break;
      case 0xCC: fail(d, "unsupported JPEG: arithmetic coding (DAC)"); break;
      case 0xC4: read_dht(d); break;
      case 0xDB: read_dqt(d); break;
      case 0xDD: {
        int len = u16(d);
        if (len != 4) fail(d, "bad DRI length");
        d->restart_interval = u16(d);
        break;
      }
      case 0xDA: read_sos(d); break;
      case 0xDC: fail(d, "unsupported JPEG: the height is defined by a DNL marker"); break;
      case 0xD8: fail(d, "bad JPEG: a second SOI"); break;
      default:
        if (m >= 0xE0 && m <= 0xEF)
          read_app(d, m);
        else
          skip_segment(d);
    }
  }
  if (!d->sof_seen) fail(d, "JPEG without a frame header (SOF)");
  if (!d->scans) fail(d, "JPEG without a scan (SOS)");
}

/* ------------------------------------------------------------- islow IDCT */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

/* libjpeg's post-IDCT range limit: sample = limit[v & 1023], centred on 128 */
static inline uint8_t idct_limit(int v) {
  int i = v & 1023;
  if (i < 128) return (uint8_t)(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return (uint8_t)(i - 896);
}

static void idct_islow(const int16_t *in, const int32_t *q, uint8_t *out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t *ip = in + c;
    const int32_t *qp = q + c;
    int *wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      int dc = (int)(((int64_t)ip[0] * qp[0]) * (1 << PASS1_BITS));
      for (int r = 0; r < 8; r++) wp[r * 8] = dc;
      continue;
    }
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = (int64_t)ip[16] * qp[16];
    z3 = (int64_t)ip[48] * qp[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    t2 = z1 + z3 * (-FIX_1_847759065);
    t3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    t0 = (z2 + z3) * (1 << CONST_BITS);
    t1 = (z2 - z3) * (1 << CONST_BITS);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = (int64_t)ip[56] * qp[56];
    t1 = (int64_t)ip[40] * qp[40];
    t2 = (int64_t)ip[24] * qp[24];
    t3 = (int64_t)ip[8] * qp[8];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * FIX_1_175875602;
    t0 = t0 * FIX_0_298631336;
    t1 = t1 * FIX_2_053119869;
    t2 = t2 * FIX_3_072711026;
    t3 = t3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    wp[0] = (int)DESCALE(t10 + t3, CONST_BITS - PASS1_BITS);
    wp[56] = (int)DESCALE(t10 - t3, CONST_BITS - PASS1_BITS);
    wp[8] = (int)DESCALE(t11 + t2, CONST_BITS - PASS1_BITS);
    wp[48] = (int)DESCALE(t11 - t2, CONST_BITS - PASS1_BITS);
    wp[16] = (int)DESCALE(t12 + t1, CONST_BITS - PASS1_BITS);
    wp[40] = (int)DESCALE(t12 - t1, CONST_BITS - PASS1_BITS);
    wp[24] = (int)DESCALE(t13 + t0, CONST_BITS - PASS1_BITS);
    wp[32] = (int)DESCALE(t13 - t0, CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; r++) {
    const int *wp = ws + r * 8;
    uint8_t *op = out + (size_t)r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      uint8_t v = idct_limit((int)DESCALE((int64_t)wp[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; c++) op[c] = v;
      continue;
    }
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = wp[2];
    z3 = wp[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    t2 = z1 + z3 * (-FIX_1_847759065);
    t3 = z1 + z2 * FIX_0_765366865;
    t0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
    t1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = wp[7];
    t1 = wp[5];
    t2 = wp[3];
    t3 = wp[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * FIX_1_175875602;
    t0 = t0 * FIX_0_298631336;
    t1 = t1 * FIX_2_053119869;
    t2 = t2 * FIX_3_072711026;
    t3 = t3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int n = CONST_BITS + PASS1_BITS + 3;
    op[0] = idct_limit((int)DESCALE(t10 + t3, n));
    op[7] = idct_limit((int)DESCALE(t10 - t3, n));
    op[1] = idct_limit((int)DESCALE(t11 + t2, n));
    op[6] = idct_limit((int)DESCALE(t11 - t2, n));
    op[2] = idct_limit((int)DESCALE(t12 + t1, n));
    op[5] = idct_limit((int)DESCALE(t12 - t1, n));
    op[3] = idct_limit((int)DESCALE(t13 + t0, n));
    op[4] = idct_limit((int)DESCALE(t13 - t0, n));
  }
}

/* -------------------------------------------------------------- upsample */

/* The component's samples (stride `is`, dw x dh) at the full resolution,
 * `hr` x `vr` times, into the first H rows of `out` (stride `os`, at least
 * dw * hr wide): jdsample.c's choice and arithmetic. */
static void upsample(const uint8_t *in, int is, int dw, int dh, int hr, int vr, uint8_t *out,
                     int os, int H) {
  for (int y = 0; y < H; y++) {
    uint8_t *op = out + (size_t)y * os;
    int i = y / vr;
    const uint8_t *near = in + (size_t)i * is;
    if (hr == 1 && vr == 1) {
      memcpy(op, near, (size_t)dw);
    } else if (hr == 1 && vr == 2) {
      int odd = y & 1;
      const uint8_t *far = in + (size_t)(odd ? (i + 1 < dh ? i + 1 : dh - 1) : (i > 0 ? i - 1 : 0)) * is;
      int bias = odd ? 2 : 1;
      for (int x = 0; x < dw; x++) op[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
    } else if (hr == 2 && vr == 1 && dw > 2) {
      int v = near[0];
      op[0] = (uint8_t)v;
      op[1] = (uint8_t)((v * 3 + near[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        v = near[x] * 3;
        op[2 * x] = (uint8_t)((v + near[x - 1] + 1) >> 2);
        op[2 * x + 1] = (uint8_t)((v + near[x + 1] + 2) >> 2);
      }
      v = near[dw - 1];
      op[2 * dw - 2] = (uint8_t)((v * 3 + near[dw - 2] + 1) >> 2);
      op[2 * dw - 1] = (uint8_t)v;
    } else if (hr == 2 && vr == 2 && dw > 2) {
      int odd = y & 1;
      const uint8_t *far = in + (size_t)(odd ? (i + 1 < dh ? i + 1 : dh - 1) : (i > 0 ? i - 1 : 0)) * is;
      int this_ = near[0] * 3 + far[0], next = near[1] * 3 + far[1], last;
      op[0] = (uint8_t)((this_ * 4 + 8) >> 4);
      op[1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
      last = this_;
      this_ = next;
      for (int x = 1; x < dw - 1; x++) {
        next = near[x + 1] * 3 + far[x + 1];
        op[2 * x] = (uint8_t)((this_ * 3 + last + 8) >> 4);
        op[2 * x + 1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
        last = this_;
        this_ = next;
      }
      op[2 * dw - 2] = (uint8_t)((this_ * 3 + last + 8) >> 4);
      op[2 * dw - 1] = (uint8_t)((this_ * 4 + 7) >> 4);
    } else {
      for (int x = 0; x < dw * hr; x++) op[x] = near[x / hr];
    }
  }
}

/* --------------------------------------------------------------- output */

static void finish(dec_t *d, int gray, uint8_t *out) {
  if (d->progressive) { /* libjpeg smooths blocks whose low AC bits are unknown */
    int dc_known = 1, incomplete = 0;
    for (int i = 0; i < d->ncomp; i++) {
      if (d->comp[i].coef_bits[0] < 0) dc_known = 0;
      for (int k = 1; k < 10; k++)
        if (d->comp[i].coef_bits[k] != 0) incomplete = 1;
    }
    if (dc_known && incomplete)
      fail(d, "unsupported JPEG: progressive scans leave low AC coefficients unrefined "
              "(libjpeg's block smoothing is not reproduced)");
  }
  int W = d->width, H = d->height;
  int nout = gray ? 1 : d->ncomp;
  int ow = d->mcux * d->hmax * 8 + 16;
  uint8_t **full = d->full;
  for (int ci = 0; ci < nout; ci++) {
    comp_t *c = &d->comp[ci];
    if (!c->coef) fail(d, "JPEG component %d has no scan", c->id);
    int ps = c->bw * 8;
    c->plane = (uint8_t *)xcalloc(d, (size_t)ps * c->bh * 8);
    for (int r = 0; r < c->bhr; r++)
      for (int col = 0; col < c->bwr; col++)
        idct_islow(c->coef + ((size_t)r * c->bw + col) * 64, c->q,
                   c->plane + (size_t)r * 8 * ps + (size_t)col * 8, ps);
    full[ci] = (uint8_t *)xcalloc(d, (size_t)ow * H);
    upsample(c->plane, ps, c->dw, c->dh, d->hmax / c->h, d->vmax / c->v, full[ci], ow, H);
  }
  if (gray || d->ncomp == 1) {
    int reps = gray ? 1 : 3;
    for (int y = 0; y < H; y++) {
      const uint8_t *s = full[0] + (size_t)y * ow;
      uint8_t *o = out + (size_t)y * W * reps;
      if (reps == 1)
        memcpy(o, s, (size_t)W);
      else
        for (int x = 0; x < W; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = s[x];
    }
  } else {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = (int)((91881 * x + 32768) >> 16);  /* FIX(1.40200) */
      cb_b[i] = (int)((116130 * x + 32768) >> 16); /* FIX(1.77200) */
      cr_g[i] = -46802 * x;                        /* -FIX(0.71414) */
      cb_g[i] = -22554 * x + 32768;                /* -FIX(0.34414) + ONE_HALF */
    }
    for (int y = 0; y < H; y++) {
      const uint8_t *py = full[0] + (size_t)y * ow, *pb = full[1] + (size_t)y * ow,
                    *pr = full[2] + (size_t)y * ow;
      uint8_t *o = out + (size_t)y * W * 3;
      for (int x = 0; x < W; x++) {
        int Y = py[x], cb = pb[x], cr = pr[x];
        int r = Y + cr_r[cr], g = Y + (int)((cb_g[cb] + cr_g[cr]) >> 16), b = Y + cb_b[cb];
        o[3 * x] = (uint8_t)(r < 0 ? 0 : r > 255 ? 255 : r);
        o[3 * x + 1] = (uint8_t)(g < 0 ? 0 : g > 255 ? 255 : g);
        o[3 * x + 2] = (uint8_t)(b < 0 ? 0 : b > 255 ? 255 : b);
      }
    }
  }
}

/* ------------------------------------------------------------ public API */

static void init_dec(dec_t *d, const uint8_t *data, size_t size, char *err, size_t errlen) {
  memset(d, 0, sizeof(*d));
  d->data = data;
  d->size = size;
  d->err = err;
  d->errlen = errlen;
}

/* The image's height, width and component count; 0 on success. */
int combo_jpeg_info(const uint8_t *data, size_t size, int *h, int *w, int *ncomp, char *err,
                    size_t errlen) {
  dec_t *d = (dec_t *)malloc(sizeof(dec_t));
  if (!d) {
    snprintf(err, errlen, "out of memory");
    return 1;
  }
  init_dec(d, data, size, err, errlen);
  int rc = 0;
  if (setjmp(d->jb)) {
    rc = 1;
  } else {
    parse(d, 1);
    if (!d->sof_seen) fail(d, "JPEG without a frame header (SOF)");
    *h = d->height;
    *w = d->width;
    *ncomp = d->ncomp;
  }
  free_dec(d);
  free(d);
  return rc;
}

/* Decode into `out`: uint8 [H, W, 3] RGB, or [H, W] with gray != 0
 * (`out_size` bytes, checked); 0 on success. */
int combo_jpeg_decode(const uint8_t *data, size_t size, int gray, uint8_t *out, size_t out_size,
                      char *err, size_t errlen) {
  dec_t *d = (dec_t *)malloc(sizeof(dec_t));
  if (!d) {
    snprintf(err, errlen, "out of memory");
    return 1;
  }
  init_dec(d, data, size, err, errlen);
  int rc = 0;
  if (setjmp(d->jb)) {
    rc = 1;
  } else {
    parse(d, 0);
    size_t need = (size_t)d->width * d->height * (gray ? 1 : 3);
    if (out_size != need) fail(d, "output buffer of %zu bytes, need %zu", out_size, need);
    finish(d, gray, out);
  }
  free_dec(d);
  free(d);
  return rc;
}

/* ================================================================ encoder */

static const uint8_t STD_LUMA_Q[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
static const uint8_t STD_CHROMA_Q[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

static const uint8_t DC_LUMA_BITS[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t DC_CHROMA_BITS[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t DC_VALS[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t AC_LUMA_BITS[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t AC_LUMA_VALS[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t AC_CHROMA_BITS[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t AC_CHROMA_VALS[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

typedef struct {
  uint16_t code[256];
  uint8_t size[256];
} ehuff;

typedef struct {
  uint8_t *out;
  size_t cap, n;
  uint32_t acc;
  int nbits;
  int overflow;
} writer;

static void put_byte(writer *w, int b) {
  if (w->n < w->cap)
    w->out[w->n++] = (uint8_t)b;
  else
    w->overflow = 1;
}

static void put16(writer *w, int v) {
  put_byte(w, v >> 8);
  put_byte(w, v & 255);
}

static void put_bits(writer *w, uint32_t code, int size) {
  if (size == 0) return;
  w->acc = (w->acc << size) | (code & ((1u << size) - 1));
  w->nbits += size;
  while (w->nbits >= 8) {
    int b = (int)(w->acc >> (w->nbits - 8)) & 255;
    put_byte(w, b);
    if (b == 0xFF) put_byte(w, 0);
    w->nbits -= 8;
  }
}

static void flush_bits(writer *w) {
  put_bits(w, 0x7F, 7); /* pad with ones to the byte */
  w->nbits = 0;
  w->acc = 0;
}

static void make_ehuff(ehuff *e, const uint8_t *bits, const uint8_t *vals) {
  int code = 0, k = 0;
  memset(e, 0, sizeof(*e));
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < bits[l]; i++) {
      e->code[vals[k]] = (uint16_t)code;
      e->size[vals[k]] = (uint8_t)l;
      code++;
      k++;
    }
    code <<= 1;
  }
}

static void scale_qtable(const uint8_t *base, int quality, int32_t *q) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long t = ((long)base[i] * scale + 50L) / 100L;
    if (t <= 0L) t = 1L;
    if (t > 255L) t = 255L; /* baseline */
    q[i] = (int32_t)t;
  }
}

/* jfdctint.c's islow forward DCT on centred samples, then libjpeg's
 * rounding division by 8 * q. */
static void fdct_quant(const int *in, const int32_t *q, int16_t *out) {
  int64_t d[64];
  for (int i = 0; i < 64; i++) d[i] = in[i];
  for (int r = 0; r < 8; r++) {
    int64_t *p = d + r * 8;
    int64_t t0 = p[0] + p[7], t7 = p[0] - p[7], t1 = p[1] + p[6], t6 = p[1] - p[6];
    int64_t t2 = p[2] + p[5], t5 = p[2] - p[5], t3 = p[3] + p[4], t4 = p[3] - p[4];
    int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    p[0] = (t10 + t11) * (1 << PASS1_BITS);
    p[4] = (t10 - t11) * (1 << PASS1_BITS);
    int64_t z1 = (t12 + t13) * FIX_0_541196100;
    p[2] = DESCALE(z1 + t13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
    p[6] = DESCALE(z1 + t12 * (-FIX_1_847759065), CONST_BITS - PASS1_BITS);
    z1 = t4 + t7;
    int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    t4 *= FIX_0_298631336;
    t5 *= FIX_2_053119869;
    t6 *= FIX_3_072711026;
    t7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = DESCALE(t4 + z1 + z3, CONST_BITS - PASS1_BITS);
    p[5] = DESCALE(t5 + z2 + z4, CONST_BITS - PASS1_BITS);
    p[3] = DESCALE(t6 + z2 + z3, CONST_BITS - PASS1_BITS);
    p[1] = DESCALE(t7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  for (int c = 0; c < 8; c++) {
    int64_t *p = d + c;
    int64_t t0 = p[0] + p[56], t7 = p[0] - p[56], t1 = p[8] + p[48], t6 = p[8] - p[48];
    int64_t t2 = p[16] + p[40], t5 = p[16] - p[40], t3 = p[24] + p[32], t4 = p[24] - p[32];
    int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    p[0] = DESCALE(t10 + t11, PASS1_BITS);
    p[32] = DESCALE(t10 - t11, PASS1_BITS);
    int64_t z1 = (t12 + t13) * FIX_0_541196100;
    p[16] = DESCALE(z1 + t13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
    p[48] = DESCALE(z1 + t12 * (-FIX_1_847759065), CONST_BITS + PASS1_BITS);
    z1 = t4 + t7;
    int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    t4 *= FIX_0_298631336;
    t5 *= FIX_2_053119869;
    t6 *= FIX_3_072711026;
    t7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = DESCALE(t4 + z1 + z3, CONST_BITS + PASS1_BITS);
    p[40] = DESCALE(t5 + z2 + z4, CONST_BITS + PASS1_BITS);
    p[24] = DESCALE(t6 + z2 + z3, CONST_BITS + PASS1_BITS);
    p[8] = DESCALE(t7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
  for (int i = 0; i < 64; i++) {
    int64_t qv = (int64_t)q[i] << 3, t = d[i];
    if (t < 0)
      t = -((-t + (qv >> 1)) / qv);
    else
      t = (t + (qv >> 1)) / qv;
    out[i] = (int16_t)t;
  }
}

static void encode_block(writer *w, const int16_t *blk, int *last_dc, const ehuff *dc,
                         const ehuff *ac) {
  int t = blk[0] - *last_dc, t2 = t;
  *last_dc = blk[0];
  if (t < 0) {
    t = -t;
    t2--;
  }
  int nbits = 0;
  while (t) {
    nbits++;
    t >>= 1;
  }
  put_bits(w, dc->code[nbits], dc->size[nbits]);
  put_bits(w, (uint32_t)t2, nbits);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    t = blk[NATURAL[k]];
    if (t == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      put_bits(w, ac->code[0xF0], ac->size[0xF0]);
      r -= 16;
    }
    t2 = t;
    if (t < 0) {
      t = -t;
      t2--;
    }
    nbits = 1;
    while ((t >>= 1)) nbits++;
    int sym = (r << 4) + nbits;
    put_bits(w, ac->code[sym], ac->size[sym]);
    put_bits(w, (uint32_t)t2, nbits);
    r = 0;
  }
  if (r > 0) put_bits(w, ac->code[0], ac->size[0]);
}

static void put_dht(writer *w, int index, const uint8_t *bits, const uint8_t *vals) {
  int n = 0;
  for (int l = 1; l <= 16; l++) n += bits[l];
  put_byte(w, 0xFF);
  put_byte(w, 0xC4);
  put16(w, 2 + 1 + 16 + n);
  put_byte(w, index);
  for (int l = 1; l <= 16; l++) put_byte(w, bits[l]);
  for (int i = 0; i < n; i++) put_byte(w, vals[i]);
}

/* Encode uint8 `img` (h x w x channels, channels 1 or 3, RGB) as baseline
 * JPEG at `quality`; colour at 4:2:0 (subsample_420 != 0) or 4:4:4. Writes
 * at most `cap` bytes to `out` and their count to `*out_len`; 0 on
 * success. */
int combo_jpeg_encode(const uint8_t *img, int h, int w, int channels, int quality,
                      int subsample_420, uint8_t *out, size_t cap, size_t *out_len, char *err,
                      size_t errlen) {
  if (h < 1 || w < 1 || h > 65535 || w > 65535 || (channels != 1 && channels != 3)) {
    snprintf(err, errlen, "cannot encode a %dx%dx%d image as JPEG", h, w, channels);
    return 1;
  }
  int nc = channels;
  int hs[3] = {1, 1, 1}, vs[3] = {1, 1, 1};
  if (nc == 3 && subsample_420) hs[0] = vs[0] = 2;
  int hmax = hs[0], vmax = vs[0];
  int mcux = (w + 8 * hmax - 1) / (8 * hmax), mcuy = (h + 8 * vmax - 1) / (8 * vmax);
  /* full-size planes, padded by edge replication to the MCU grid */
  int fw = mcux * 8 * hmax, fh = mcuy * 8 * vmax;
  uint8_t *planes[3] = {NULL, NULL, NULL};
  int rc = 0;
  for (int c = 0; c < nc; c++) {
    planes[c] = (uint8_t *)malloc((size_t)fw * fh);
    if (!planes[c]) {
      snprintf(err, errlen, "out of memory");
      rc = 1;
      goto done;
    }
  }
  for (int y = 0; y < h; y++) {
    const uint8_t *row = img + (size_t)y * w * nc;
    for (int x = 0; x < w; x++) {
      const uint8_t *px = row + (size_t)x * nc;
      if (nc == 1) {
        planes[0][(size_t)y * fw + x] = px[0];
      } else {
        int64_t r = px[0], g = px[1], b = px[2];
        /* jccolor.c: FIX(0.29900) 19595, FIX(0.58700) 38470, FIX(0.11400) 7471,
         * FIX(0.16874) 11059, FIX(0.33126) 21709, FIX(0.5) 32768,
         * FIX(0.41869) 27439, FIX(0.08131) 5329 */
        int64_t yy = 19595 * r + 38470 * g + 7471 * b + 32768;
        int64_t cb = -11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767;
        int64_t cr = 32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767;
        planes[0][(size_t)y * fw + x] = (uint8_t)(yy >> 16);
        planes[1][(size_t)y * fw + x] = (uint8_t)(cb >> 16);
        planes[2][(size_t)y * fw + x] = (uint8_t)(cr >> 16);
      }
    }
    for (int c = 0; c < nc; c++)
      memset(planes[c] + (size_t)y * fw + w, planes[c][(size_t)y * fw + w - 1], (size_t)(fw - w));
  }
  for (int y = h; y < fh; y++)
    for (int c = 0; c < nc; c++)
      memcpy(planes[c] + (size_t)y * fw, planes[c] + (size_t)(h - 1) * fw, (size_t)fw);

  int32_t qtab[2][64];
  scale_qtable(STD_LUMA_Q, quality, qtab[0]);
  scale_qtable(STD_CHROMA_Q, quality, qtab[1]);
  ehuff dch[2], ach[2];
  make_ehuff(&dch[0], DC_LUMA_BITS, DC_VALS);
  make_ehuff(&ach[0], AC_LUMA_BITS, AC_LUMA_VALS);
  make_ehuff(&dch[1], DC_CHROMA_BITS, DC_VALS);
  make_ehuff(&ach[1], AC_CHROMA_BITS, AC_CHROMA_VALS);

  writer wr = {out, cap, 0, 0, 0, 0};
  writer *W = &wr;
  put_byte(W, 0xFF); put_byte(W, 0xD8);
  static const uint8_t JFIF[16] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1};
  for (int i = 0; i < 16; i++) put_byte(W, JFIF[i]);
  put_byte(W, 0); put_byte(W, 0); /* no thumbnail */
  for (int t = 0; t < (nc == 3 ? 2 : 1); t++) {
    put_byte(W, 0xFF); put_byte(W, 0xDB);
    put16(W, 2 + 1 + 64);
    put_byte(W, t);
    for (int i = 0; i < 64; i++) put_byte(W, qtab[t][NATURAL[i]]);
  }
  put_byte(W, 0xFF); put_byte(W, 0xC0);
  put16(W, 8 + 3 * nc);
  put_byte(W, 8);
  put16(W, h);
  put16(W, w);
  put_byte(W, nc);
  for (int c = 0; c < nc; c++) {
    put_byte(W, c + 1);
    put_byte(W, (hs[c] << 4) | vs[c]);
    put_byte(W, c ? 1 : 0);
  }
  put_dht(W, 0x00, DC_LUMA_BITS, DC_VALS);
  put_dht(W, 0x10, AC_LUMA_BITS, AC_LUMA_VALS);
  if (nc == 3) {
    put_dht(W, 0x01, DC_CHROMA_BITS, DC_VALS);
    put_dht(W, 0x11, AC_CHROMA_BITS, AC_CHROMA_VALS);
  }
  put_byte(W, 0xFF); put_byte(W, 0xDA);
  put16(W, 6 + 2 * nc);
  put_byte(W, nc);
  for (int c = 0; c < nc; c++) {
    put_byte(W, c + 1);
    put_byte(W, c ? 0x11 : 0x00);
  }
  put_byte(W, 0); put_byte(W, 63); put_byte(W, 0);

  /* component geometry: samples and blocks of each (libjpeg's
   * width_in_blocks / height_in_blocks) */
  int last_dc[3] = {0, 0, 0};
  int cw[3], chh[3], wib[3], hib[3];
  for (int c = 0; c < nc; c++) {
    cw[c] = (w * hs[c] + hmax - 1) / hmax;
    chh[c] = (h * vs[c] + vmax - 1) / vmax;
    wib[c] = (cw[c] + 7) / 8;
    hib[c] = (chh[c] + 7) / 8;
  }
  /* chroma planes: h2v2 box downsampling with biases 1, 2, 1, 2 ... of the
   * replicated full planes, then edge replication to whole blocks */
  int dsw = mcux * 8, dsh = mcuy * 8;
  uint8_t *ds[3] = {planes[0], NULL, NULL};
  int dstride[3] = {fw, fw, fw};
  if (nc == 3 && hmax == 2) {
    for (int c = 1; c < 3; c++) {
      ds[c] = (uint8_t *)malloc((size_t)dsw * dsh);
      if (!ds[c]) {
        snprintf(err, errlen, "out of memory");
        free(ds[1]);
        rc = 1;
        goto done;
      }
      for (int y = 0; y < dsh; y++) {
        const uint8_t *r0 = planes[c] + (size_t)(2 * y) * fw, *r1 = r0 + fw;
        int bias = 1;
        for (int x = 0; x < dsw; x++) {
          ds[c][(size_t)y * dsw + x] =
              (uint8_t)((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
      /* rows past the component's own repeat its last row (libjpeg pads
       * the downsampled data to the iMCU height so) */
      for (int y = chh[c]; y < dsh; y++)
        memcpy(ds[c] + (size_t)y * dsw, ds[c] + (size_t)(chh[c] - 1) * dsw, (size_t)dsw);
      dstride[c] = dsw;
    }
  } else if (nc == 3) {
    ds[1] = planes[1];
    ds[2] = planes[2];
  }

  int16_t blk[64];
  int cen[64];
  for (int my = 0; my < mcuy; my++)
    for (int mx = 0; mx < mcux; mx++)
      for (int c = 0; c < nc; c++)
        for (int by = 0; by < vs[c]; by++)
          for (int bx = 0; bx < hs[c]; bx++) {
            int brow = my * vs[c] + by, bcol = mx * hs[c] + bx;
            int t = c ? 1 : 0;
            if (brow >= hib[c] || bcol >= wib[c]) {
              /* a dummy block: zero AC, the DC of the block before it */
              memset(blk, 0, sizeof(blk));
              blk[0] = (int16_t)last_dc[c];
            } else {
              const uint8_t *src = ds[c] + (size_t)brow * 8 * dstride[c] + (size_t)bcol * 8;
              for (int yy = 0; yy < 8; yy++)
                for (int xx = 0; xx < 8; xx++)
                  cen[yy * 8 + xx] = (int)src[(size_t)yy * dstride[c] + xx] - 128;
              fdct_quant(cen, qtab[t], blk);
            }
            encode_block(W, blk, &last_dc[c], &dch[t], &ach[t]);
          }
  flush_bits(W);
  put_byte(W, 0xFF); put_byte(W, 0xD9);
  if (nc == 3 && hmax == 2) {
    free(ds[1]);
    free(ds[2]);
  }
  if (W->overflow) {
    snprintf(err, errlen, "JPEG output exceeds its %zu-byte buffer", cap);
    rc = 2;
  }
  *out_len = W->n;
done:
  for (int c = 0; c < 3; c++) free(planes[c]);
  return rc;
}
