/* Baseline JPEG decode and encode, and PNG row unfiltering, in plain C.
 *
 * The decoder reproduces what `cv2.imread(path)` returns for a baseline
 * (SOF0/SOF1) 8-bit Huffman JPEG with libjpeg-turbo's defaults: the integer
 * "islow" inverse DCT (jidctint.c), fancy (triangle) upsampling of 2x1 and
 * 2x2 chroma (jdsample.c), and the fixed-point YCbCr->RGB tables
 * (jdcolor.c). Output is BGR, 3 bytes per pixel; a grayscale file is
 * replicated into the three channels as imread does.
 *
 * The encoder writes what `cv2.imwrite(path, img, [IMWRITE_JPEG_QUALITY, q])`
 * writes: JFIF, the Annex K quantisation tables scaled by libjpeg's quality
 * rule (baseline-limited), 4:2:0 with libjpeg's h2v2 downsampling for 3
 * channels (one component for gray), the islow forward DCT (jfdctint.c), and
 * the standard Huffman tables.
 *
 * No global state: every call owns its buffers, so calls may run in
 * parallel (ctypes releases the GIL around them).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <stdio.h>

#define DCTSIZE2 64
#define CONST_BITS 13
#define PASS1_BITS 2
#define ONE ((int64_t)1)
#define DESCALE(x, n) (((x) + (ONE << ((n)-1))) >> (n))

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

static const int natural_order[DCTSIZE2 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    /* extra entries catch a corrupt run that overshoots k = 63 */
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

static void set_err(char *err, int errlen, const char *msg) {
  if (err && errlen > 0) {
    strncpy(err, msg, (size_t)errlen - 1);
    err[errlen - 1] = 0;
  }
}

/* ===================================================================== */
/*                                DECODER                                */
/* ===================================================================== */

typedef struct {
  int valid;
  uint8_t bits[17];
  uint8_t vals[256];
  int32_t mincode[17], maxcode[18], valptr[17];
  /* 9-bit lookahead: (length << 8) | value, 0 when the code is longer */
  uint16_t look[1 << 9];
} DHuff;

static void build_dhuff(DHuff *h) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < h->bits[l]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (h->bits[l]) {
      h->valptr[l] = p;
      h->mincode[l] = huffcode[p];
      p += h->bits[l];
      h->maxcode[l] = huffcode[p - 1];
    } else {
      h->maxcode[l] = -1;
    }
  }
  h->maxcode[17] = 0x7FFFFFFF;
  memset(h->look, 0, sizeof(h->look));
  p = 0;
  for (int l = 1; l <= 9; l++) {
    for (int i = 0; i < h->bits[l]; i++, p++) {
      int lookbits = huffcode[p] << (9 - l);
      for (int ctr = 1 << (9 - l); ctr > 0; ctr--) h->look[lookbits++] = (uint16_t)((l << 8) | h->vals[p]);
    }
  }
  h->valid = 1;
}

typedef struct {
  const uint8_t *p, *end;
  uint32_t buf; /* MSB-first */
  int cnt;
  int marker_hit;
} BitReader;

static void br_fill(BitReader *br) {
  while (br->cnt <= 24) {
    uint32_t c = 0;
    if (!br->marker_hit && br->p < br->end) {
      c = br->p[0];
      if (c == 0xFF) {
        uint32_t c2 = (br->p + 1 < br->end) ? br->p[1] : 0xD9;
        if (c2 == 0) {
          br->p += 2;
        } else {
          br->marker_hit = 1; /* a marker: feed zeros from here, as libjpeg does */
          c = 0;
        }
      } else {
        br->p++;
      }
    }
    br->buf |= c << (24 - br->cnt);
    br->cnt += 8;
  }
}

static inline int br_bits(BitReader *br, int n) {
  if (n == 0) return 0;
  if (br->cnt < n) br_fill(br);
  int v = (int)(br->buf >> (32 - n));
  br->buf <<= n;
  br->cnt -= n;
  return v;
}

static inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

static int huff_decode(BitReader *br, const DHuff *h) {
  if (br->cnt < 16) br_fill(br);
  int look = (int)(br->buf >> (32 - 9));
  int e = h->look[look];
  if (e) {
    int l = e >> 8;
    br->buf <<= l;
    br->cnt -= l;
    return e & 0xFF;
  }
  int code = (int)(br->buf >> (32 - 10));
  int l = 10;
  while (l <= 16 && code > h->maxcode[l]) {
    l++;
    code = (int)(br->buf >> (32 - l));
  }
  if (l > 16) return -1;
  br->buf <<= l;
  br->cnt -= l;
  return h->vals[h->valptr[l] + code - h->mincode[l]];
}

typedef struct {
  int id, h, v, tq;
  int cw, ch;           /* downsampled width/height in samples */
  int wblocks, hblocks; /* real blocks */
  int bw, bh;           /* allocated blocks (MCU-padded) */
  int16_t *coef;        /* bh * bw * 64, natural order */
  int dc_pred;
} DComp;

typedef struct {
  int width, height, ncomp;
  DComp comp[4];
  uint16_t qt[4][64]; /* natural order */
  int qt_valid[4];
  DHuff dc[4], ac[4];
  int hmax, vmax, mcus_x, mcus_y;
  int restart_interval;
  int have_frame;
} Decoder;

static int read_u16(const uint8_t *p) { return (p[0] << 8) | p[1]; }

static int decode_scan(Decoder *d, const uint8_t **pp, const uint8_t *end, const int *scomp, const int *tdc, const int *tac,
                       int ns, char *err, int errlen) {
  BitReader br = {*pp, end, 0, 0, 0};
  for (int i = 0; i < ns; i++) {
    DComp *c = &d->comp[scomp[i]];
    c->dc_pred = 0;
    if (!d->dc[tdc[i]].valid || !d->ac[tac[i]].valid) {
      set_err(err, errlen, "scan uses an undefined Huffman table");
      return -1;
    }
  }
  int total;
  int mx_count;
  if (ns == 1) {
    DComp *c = &d->comp[scomp[0]];
    mx_count = c->wblocks;
    total = c->wblocks * c->hblocks;
  } else {
    mx_count = d->mcus_x;
    total = d->mcus_x * d->mcus_y;
  }
  int restarts_left = d->restart_interval;
  for (int m = 0; m < total; m++) {
    if (d->restart_interval) {
      if (restarts_left == 0) {
        /* Expect RSTn: drop the partial byte, find the marker, reset predictors. */
        br.buf = 0;
        br.cnt = 0;
        const uint8_t *q = br.p;
        while (q + 1 < end && !(q[0] == 0xFF && q[1] != 0 && q[1] != 0xFF)) q++;
        if (q + 1 < end && q[1] >= 0xD0 && q[1] <= 0xD7) q += 2;
        br.p = q;
        br.marker_hit = 0;
        for (int i = 0; i < ns; i++) d->comp[scomp[i]].dc_pred = 0;
        restarts_left = d->restart_interval;
      }
      restarts_left--;
    }
    int my = m / mx_count, mx = m % mx_count;
    for (int i = 0; i < ns; i++) {
      DComp *c = &d->comp[scomp[i]];
      int nv = (ns == 1) ? 1 : c->v, nh = (ns == 1) ? 1 : c->h;
      for (int yy = 0; yy < nv; yy++) {
        for (int xx = 0; xx < nh; xx++) {
          int by = my * nv + yy, bx = mx * nh + xx;
          int16_t *blk = c->coef + ((size_t)by * c->bw + bx) * 64;
          int s = huff_decode(&br, &d->dc[tdc[i]]);
          if (s < 0 || s > 16) {
            set_err(err, errlen, "corrupt JPEG data: bad Huffman code");
            return -1;
          }
          int diff = s ? extend(br_bits(&br, s), s) : 0;
          c->dc_pred += diff;
          blk[0] = (int16_t)c->dc_pred;
          for (int k = 1; k < 64;) {
            int rs = huff_decode(&br, &d->ac[tac[i]]);
            if (rs < 0) {
              set_err(err, errlen, "corrupt JPEG data: bad Huffman code");
              return -1;
            }
            int r = rs >> 4, ss = rs & 15;
            if (ss) {
              k += r;
              blk[natural_order[k]] = (int16_t)extend(br_bits(&br, ss), ss);
              k++;
            } else {
              if (r != 15) break;
              k += 16;
            }
          }
        }
      }
    }
  }
  /* Skip to the next marker. */
  const uint8_t *q = br.p;
  while (q + 1 < end && !(q[0] == 0xFF && q[1] != 0 && q[1] != 0xFF && !(q[1] >= 0xD0 && q[1] <= 0xD7))) q++;
  *pp = q;
  return 0;
}

/* jidctint.c: jpeg_idct_islow, 8x8, into out (stride) with range limiting. */
static inline uint8_t range_limit_idct(int64_t x) {
  int v = (int)(x & 1023);
  if (v >= 512) v -= 1024;
  v += 128;
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

static void idct_islow(const int16_t *coef, const uint16_t *q, uint8_t *out, int stride) {
  int64_t tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13, z1, z2, z3, z4, z5;
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t *in = coef + c;
    const uint16_t *qp = q + c;
    int *w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = (int)(((int64_t)in[0] * qp[0]) * (1 << PASS1_BITS));
      for (int r = 0; r < 8; r++) w[r * 8] = dc;
      continue;
    }
    z2 = (int64_t)in[16] * qp[16];
    z3 = (int64_t)in[48] * qp[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * (-FIX_1_847759065);
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * qp[0];
    z3 = (int64_t)in[32] * qp[32];
    tmp0 = (z2 + z3) * (ONE << CONST_BITS);
    tmp1 = (z2 - z3) * (ONE << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * qp[56];
    tmp1 = (int64_t)in[40] * qp[40];
    tmp2 = (int64_t)in[24] * qp[24];
    tmp3 = (int64_t)in[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    w[0] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
    w[56] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
    w[8] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
    w[48] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
    w[16] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
    w[40] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
    w[24] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
    w[32] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; r++) {
    const int *w = ws + r * 8;
    uint8_t *o = out + (size_t)r * stride;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * (-FIX_1_847759065);
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = ((int64_t)w[0] + w[4]) * (ONE << CONST_BITS);
    tmp1 = ((int64_t)w[0] - w[4]) * (ONE << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    o[0] = range_limit_idct(DESCALE(tmp10 + tmp3, sh));
    o[7] = range_limit_idct(DESCALE(tmp10 - tmp3, sh));
    o[1] = range_limit_idct(DESCALE(tmp11 + tmp2, sh));
    o[6] = range_limit_idct(DESCALE(tmp11 - tmp2, sh));
    o[2] = range_limit_idct(DESCALE(tmp12 + tmp1, sh));
    o[5] = range_limit_idct(DESCALE(tmp12 - tmp1, sh));
    o[3] = range_limit_idct(DESCALE(tmp13 + tmp0, sh));
    o[4] = range_limit_idct(DESCALE(tmp13 - tmp0, sh));
  }
}

/* One component's samples (ch x cw, in a plane of stride ps) upsampled to
 * the image (height x width) as libjpeg's jdsample.c does. */
static int upsample(const DComp *c, const uint8_t *plane, int ps, int hmax, int vmax, int width, int height, uint8_t *out) {
  int fh = hmax / c->h, fv = vmax / c->v;
  if (hmax % c->h || vmax % c->v) return -1;
  if (fh == 1 && fv == 1) {
    for (int y = 0; y < height; y++) memcpy(out + (size_t)y * width, plane + (size_t)y * ps, (size_t)width);
    return 0;
  }
  if (fh != 2 || (fv != 1 && fv != 2)) return -1;
  int cw = c->cw;
  int fancy = cw > 2;
  uint8_t *row = (uint8_t *)malloc((size_t)2 * cw + 2);
  if (!row) return -2;
  for (int y = 0; y < height; y++) {
    if (fv == 1) {
      const uint8_t *in = plane + (size_t)y * ps;
      if (fancy) {
        row[0] = in[0];
        row[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < cw - 1; x++) {
          int v = in[x] * 3;
          row[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
          row[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
        }
        row[2 * cw - 2] = (uint8_t)((in[cw - 1] * 3 + in[cw - 2] + 1) >> 2);
        row[2 * cw - 1] = in[cw - 1];
      } else {
        for (int x = 0; x < cw; x++) row[2 * x] = row[2 * x + 1] = in[x];
      }
    } else {
      int iy = y >> 1;
      const uint8_t *in0 = plane + (size_t)iy * ps;
      if (fancy) {
        int ny = (y & 1) ? iy + 1 : iy - 1;
        if (ny < 0) ny = 0;
        if (ny > c->ch - 1) ny = c->ch - 1;
        const uint8_t *in1 = plane + (size_t)ny * ps;
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        int last_sum;
        row[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
        row[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 1; x < cw - 1; x++) {
          next_sum = in0[x + 1] * 3 + in1[x + 1];
          row[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
          row[2 * x + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        row[2 * cw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        row[2 * cw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
      } else {
        for (int x = 0; x < cw; x++) row[2 * x] = row[2 * x + 1] = in0[x];
      }
    }
    memcpy(out + (size_t)y * width, row, (size_t)width);
  }
  free(row);
  return 0;
}

static void free_decoder(Decoder *d) {
  for (int i = 0; i < 4; i++) free(d->comp[i].coef);
}

/* Parse the file; with out == NULL stop after the frame header. */
static int jpeg_run(const uint8_t *data, int64_t n, uint8_t *out, int *width, int *height, int *ncomp, char *err, int errlen) {
  Decoder *d = (Decoder *)calloc(1, sizeof(Decoder));
  if (!d) {
    set_err(err, errlen, "out of memory");
    return -2;
  }
  const uint8_t *p = data, *end = data + n;
  int rc = -1;
  if (n < 4 || p[0] != 0xFF || p[1] != 0xD8) {
    set_err(err, errlen, "not a JPEG file (no SOI marker)");
    goto done;
  }
  p += 2;
  for (;;) {
    while (p < end && *p != 0xFF) p++;
    while (p < end && *p == 0xFF) p++;
    if (p >= end) {
      set_err(err, errlen, "truncated JPEG file");
      goto done;
    }
    int marker = *p++;
    if (marker == 0xD9) break; /* EOI */
    if (marker >= 0xD0 && marker <= 0xD7) continue;
    if (p + 2 > end) {
      set_err(err, errlen, "truncated JPEG marker");
      goto done;
    }
    int len = read_u16(p);
    if (len < 2 || p + len > end) {
      set_err(err, errlen, "truncated JPEG segment");
      goto done;
    }
    const uint8_t *seg = p + 2, *seg_end = p + len;
    p += len;
    switch (marker) {
      case 0xC0:
      case 0xC1: {
        if (d->have_frame) {
          set_err(err, errlen, "more than one frame header");
          goto done;
        }
        if (seg[0] != 8) {
          set_err(err, errlen, "only 8-bit JPEG samples are supported");
          goto done;
        }
        d->height = read_u16(seg + 1);
        d->width = read_u16(seg + 3);
        d->ncomp = seg[5];
        if (d->width <= 0 || d->height <= 0 || (d->ncomp != 1 && d->ncomp != 3) || seg + 6 + 3 * d->ncomp > seg_end) {
          set_err(err, errlen, "unsupported JPEG frame (need 1 or 3 components and a known size)");
          goto done;
        }
        d->hmax = d->vmax = 1;
        for (int i = 0; i < d->ncomp; i++) {
          DComp *c = &d->comp[i];
          c->id = seg[6 + 3 * i];
          c->h = seg[7 + 3 * i] >> 4;
          c->v = seg[7 + 3 * i] & 15;
          c->tq = seg[8 + 3 * i] & 3;
          if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4) {
            set_err(err, errlen, "bad sampling factors");
            goto done;
          }
          if (c->h > d->hmax) d->hmax = c->h;
          if (c->v > d->vmax) d->vmax = c->v;
        }
        d->mcus_x = (d->width + 8 * d->hmax - 1) / (8 * d->hmax);
        d->mcus_y = (d->height + 8 * d->vmax - 1) / (8 * d->vmax);
        for (int i = 0; i < d->ncomp; i++) {
          DComp *c = &d->comp[i];
          c->cw = (d->width * c->h + d->hmax - 1) / d->hmax;
          c->ch = (d->height * c->v + d->vmax - 1) / d->vmax;
          c->wblocks = (c->cw + 7) / 8;
          c->hblocks = (c->ch + 7) / 8;
          c->bw = d->mcus_x * c->h;
          c->bh = d->mcus_y * c->v;
          if (d->ncomp == 1) {
            c->bw = c->wblocks;
            c->bh = c->hblocks;
          }
          if (out) {
            c->coef = (int16_t *)calloc((size_t)c->bw * c->bh * 64, sizeof(int16_t));
            if (!c->coef) {
              set_err(err, errlen, "out of memory");
              rc = -2;
              goto done;
            }
          }
        }
        d->have_frame = 1;
        if (!out) {
          rc = 0;
          goto done;
        }
        break;
      }
      case 0xC2:
      case 0xC6:
      case 0xCA:
      case 0xCE:
        set_err(err, errlen, "progressive JPEG is not supported");
        goto done;
      case 0xC3:
      case 0xC5:
      case 0xC7:
      case 0xC9:
      case 0xCB:
      case 0xCD:
      case 0xCF:
        set_err(err, errlen, "lossless, hierarchical or arithmetic-coded JPEG is not supported");
        goto done;
      case 0xC4: { /* DHT */
        const uint8_t *q = seg;
        while (q < seg_end) {
          int tc = q[0] >> 4, th = q[0] & 15;
          if (tc > 1 || th > 3 || q + 17 > seg_end) {
            set_err(err, errlen, "bad DHT segment");
            goto done;
          }
          DHuff *h = tc ? &d->ac[th] : &d->dc[th];
          int count = 0;
          h->bits[0] = 0;
          for (int i = 1; i <= 16; i++) {
            h->bits[i] = q[i];
            count += q[i];
          }
          if (count > 256 || q + 17 + count > seg_end) {
            set_err(err, errlen, "bad DHT segment");
            goto done;
          }
          memcpy(h->vals, q + 17, (size_t)count);
          build_dhuff(h);
          q += 17 + count;
        }
        break;
      }
      case 0xDB: { /* DQT */
        const uint8_t *q = seg;
        while (q < seg_end) {
          int pq = q[0] >> 4, tq = q[0] & 15;
          if (tq > 3 || q + 1 + 64 * (pq + 1) > seg_end) {
            set_err(err, errlen, "bad DQT segment");
            goto done;
          }
          for (int i = 0; i < 64; i++)
            d->qt[tq][natural_order[i]] = (uint16_t)(pq ? read_u16(q + 1 + 2 * i) : q[1 + i]);
          d->qt_valid[tq] = 1;
          q += 1 + 64 * (pq + 1);
        }
        break;
      }
      case 0xDD: /* DRI */
        d->restart_interval = read_u16(seg);
        break;
      case 0xDA: { /* SOS */
        if (!d->have_frame) {
          set_err(err, errlen, "scan before frame header");
          goto done;
        }
        int ns = seg[0];
        int scomp[4], tdc[4], tac[4];
        if (ns < 1 || ns > 4 || seg + 1 + 2 * ns + 3 > seg_end) {
          set_err(err, errlen, "bad SOS segment");
          goto done;
        }
        for (int i = 0; i < ns; i++) {
          int id = seg[1 + 2 * i];
          scomp[i] = -1;
          for (int k = 0; k < d->ncomp; k++)
            if (d->comp[k].id == id) scomp[i] = k;
          if (scomp[i] < 0) {
            set_err(err, errlen, "scan names an unknown component");
            goto done;
          }
          tdc[i] = seg[2 + 2 * i] >> 4;
          tac[i] = seg[2 + 2 * i] & 15;
          if (tdc[i] > 3 || tac[i] > 3) {
            set_err(err, errlen, "bad Huffman table index");
            goto done;
          }
        }
        const uint8_t *t = seg + 1 + 2 * ns;
        if (t[0] != 0 || t[1] != 63 || t[2] != 0) {
          set_err(err, errlen, "not a sequential scan");
          goto done;
        }
        if (decode_scan(d, &p, end, scomp, tdc, tac, ns, err, errlen)) goto done;
        break;
      }
      default:
        break; /* APPn, COM, ... */
    }
  }
  if (!d->have_frame) {
    set_err(err, errlen, "no frame header");
    goto done;
  }
  if (!out) {
    rc = 0;
    goto done;
  }
  {
    int W = d->width, H = d->height;
    uint8_t *full[3] = {0, 0, 0};
    uint8_t *plane = NULL;
    for (int i = 0; i < d->ncomp; i++) {
      DComp *c = &d->comp[i];
      if (!d->qt_valid[c->tq]) {
        set_err(err, errlen, "component uses an undefined quantization table");
        goto cleanup;
      }
      int ps = c->bw * 8;
      plane = (uint8_t *)malloc((size_t)ps * c->bh * 8);
      full[i] = (uint8_t *)malloc((size_t)W * H);
      if (!plane || !full[i]) {
        set_err(err, errlen, "out of memory");
        rc = -2;
        goto cleanup;
      }
      for (int by = 0; by < c->bh; by++)
        for (int bx = 0; bx < c->bw; bx++)
          idct_islow(c->coef + ((size_t)by * c->bw + bx) * 64, d->qt[c->tq], plane + (size_t)by * 8 * ps + bx * 8, ps);
      int urc = upsample(c, plane, ps, d->hmax, d->vmax, W, H, full[i]);
      free(plane);
      plane = NULL;
      if (urc) {
        set_err(err, errlen, urc == -2 ? "out of memory" : "unsupported chroma subsampling");
        goto cleanup;
      }
    }
    if (d->ncomp == 1) {
      for (int64_t k = 0; k < (int64_t)W * H; k++) out[3 * k] = out[3 * k + 1] = out[3 * k + 2] = full[0][k];
    } else {
      /* jdcolor.c build_ycc_rgb_table, SCALEBITS 16 */
      int cr_r[256], cb_b[256];
      int64_t cr_g[256], cb_g[256];
      for (int i = 0, x = -128; i < 256; i++, x++) {
        cr_r[i] = (int)((91881 * (int64_t)x + 32768) >> 16);  /* FIX(1.40200) */
        cb_b[i] = (int)((116130 * (int64_t)x + 32768) >> 16); /* FIX(1.77200) */
        cr_g[i] = (-46802) * (int64_t)x;                      /* FIX(0.71414) */
        cb_g[i] = (-22554) * (int64_t)x + 32768;              /* FIX(0.34414) */
      }
      for (int64_t k = 0; k < (int64_t)W * H; k++) {
        int y = full[0][k], cb = full[1][k], cr = full[2][k];
        int r = y + cr_r[cr];
        int g = y + (int)((cb_g[cb] + cr_g[cr]) >> 16);
        int b = y + cb_b[cb];
        out[3 * k + 0] = (uint8_t)(b < 0 ? 0 : (b > 255 ? 255 : b));
        out[3 * k + 1] = (uint8_t)(g < 0 ? 0 : (g > 255 ? 255 : g));
        out[3 * k + 2] = (uint8_t)(r < 0 ? 0 : (r > 255 ? 255 : r));
      }
    }
    rc = 0;
  cleanup:
    free(plane);
    for (int i = 0; i < 3; i++) free(full[i]);
  }
done:
  if (width) *width = d->width;
  if (height) *height = d->height;
  if (ncomp) *ncomp = d->ncomp;
  free_decoder(d);
  free(d);
  return rc;
}

/* Frame size of a JPEG: 0 on success. */
int jpeg_info(const uint8_t *data, int64_t n, int *width, int *height, int *ncomp, char *err, int errlen) {
  return jpeg_run(data, n, NULL, width, height, ncomp, err, errlen);
}

/* Decode into out (height x width x 3 BGR, from jpeg_info's size). */
int jpeg_decode(const uint8_t *data, int64_t n, uint8_t *out, int width, int height, char *err, int errlen) {
  int w = 0, h = 0, c = 0;
  int rc = jpeg_run(data, n, out, &w, &h, &c, err, errlen);
  if (rc == 0 && (w != width || h != height)) {
    set_err(err, errlen, "output buffer size does not match the frame");
    return -1;
  }
  return rc;
}

/* ===================================================================== */
/*                                ENCODER                                */
/* ===================================================================== */

static const uint8_t std_lum_q[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
static const uint8_t std_chr_q[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

static const uint8_t dc_lum_bits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t dc_chr_bits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t dc_vals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t ac_lum_bits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t ac_lum_vals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14,
    0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09,
    0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a,
    0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65,
    0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88,
    0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9,
    0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea,
    0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t ac_chr_bits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t ac_chr_vals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32,
    0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16,
    0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86,
    0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8,
    0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9,
    0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

typedef struct {
  unsigned int code[256];
  int size[256];
} EHuff;

static void build_ehuff(const uint8_t *bits, const uint8_t *vals, EHuff *e) {
  int p = 0, code = 0;
  memset(e, 0, sizeof(*e));
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < bits[l]; i++, p++) {
      e->code[vals[p]] = (unsigned int)code++;
      e->size[vals[p]] = l;
    }
    code <<= 1;
  }
}

typedef struct {
  uint8_t *buf;
  int64_t len, cap;
  int oom;
  uint32_t acc; /* pending bits, right-aligned */
  int nacc;
} Writer;

static void w_byte(Writer *w, uint8_t b) {
  if (w->len >= w->cap) {
    int64_t cap = w->cap ? 2 * w->cap : 65536;
    uint8_t *nb = (uint8_t *)realloc(w->buf, (size_t)cap);
    if (!nb) {
      w->oom = 1;
      return;
    }
    w->buf = nb;
    w->cap = cap;
  }
  w->buf[w->len++] = b;
}

static void w_u16(Writer *w, int v) {
  w_byte(w, (uint8_t)(v >> 8));
  w_byte(w, (uint8_t)(v & 0xFF));
}

static void w_bits(Writer *w, unsigned int code, int size) {
  code &= (1u << size) - 1u;
  w->acc = (w->acc << size) | code;
  w->nacc += size;
  while (w->nacc >= 8) {
    uint8_t c = (uint8_t)(w->acc >> (w->nacc - 8));
    w_byte(w, c);
    if (c == 0xFF) w_byte(w, 0);
    w->nacc -= 8;
  }
  w->acc &= (1u << w->nacc) - 1u;
}

static void w_dht(Writer *w, int tc, int th, const uint8_t *bits, const uint8_t *vals) {
  int count = 0;
  for (int i = 1; i <= 16; i++) count += bits[i];
  w_byte(w, 0xFF);
  w_byte(w, 0xC4);
  w_u16(w, 2 + 1 + 16 + count);
  w_byte(w, (uint8_t)((tc << 4) | th));
  for (int i = 1; i <= 16; i++) w_byte(w, bits[i]);
  for (int i = 0; i < count; i++) w_byte(w, vals[i]);
}

/* jfdctint.c: jpeg_fdct_islow, in place on 64 values (sample - 128). */
static void fdct_islow(int32_t *data) {
  int64_t tmp0, tmp1, tmp2, tmp3, tmp4, tmp5, tmp6, tmp7, tmp10, tmp11, tmp12, tmp13, z1, z2, z3, z4, z5;
  int32_t *d = data;
  for (int r = 0; r < 8; r++, d += 8) {
    tmp0 = d[0] + d[7];
    tmp7 = d[0] - d[7];
    tmp1 = d[1] + d[6];
    tmp6 = d[1] - d[6];
    tmp2 = d[2] + d[5];
    tmp5 = d[2] - d[5];
    tmp3 = d[3] + d[4];
    tmp4 = d[3] - d[4];
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    d[0] = (int32_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
    d[4] = (int32_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
    z1 = (tmp12 + tmp13) * FIX_0_541196100;
    d[2] = (int32_t)DESCALE(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
    d[6] = (int32_t)DESCALE(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS - PASS1_BITS);
    z1 = tmp4 + tmp7;
    z2 = tmp5 + tmp6;
    z3 = tmp4 + tmp6;
    z4 = tmp5 + tmp7;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 = tmp4 * FIX_0_298631336;
    tmp5 = tmp5 * FIX_2_053119869;
    tmp6 = tmp6 * FIX_3_072711026;
    tmp7 = tmp7 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    d[7] = (int32_t)DESCALE(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
    d[5] = (int32_t)DESCALE(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
    d[3] = (int32_t)DESCALE(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
    d[1] = (int32_t)DESCALE(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  d = data;
  for (int c = 0; c < 8; c++, d++) {
    tmp0 = d[0] + d[56];
    tmp7 = d[0] - d[56];
    tmp1 = d[8] + d[48];
    tmp6 = d[8] - d[48];
    tmp2 = d[16] + d[40];
    tmp5 = d[16] - d[40];
    tmp3 = d[24] + d[32];
    tmp4 = d[24] - d[32];
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    d[0] = (int32_t)DESCALE(tmp10 + tmp11, PASS1_BITS);
    d[32] = (int32_t)DESCALE(tmp10 - tmp11, PASS1_BITS);
    z1 = (tmp12 + tmp13) * FIX_0_541196100;
    d[16] = (int32_t)DESCALE(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
    d[48] = (int32_t)DESCALE(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS + PASS1_BITS);
    z1 = tmp4 + tmp7;
    z2 = tmp5 + tmp6;
    z3 = tmp4 + tmp6;
    z4 = tmp5 + tmp7;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 = tmp4 * FIX_0_298631336;
    tmp5 = tmp5 * FIX_2_053119869;
    tmp6 = tmp6 * FIX_3_072711026;
    tmp7 = tmp7 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    d[56] = (int32_t)DESCALE(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
    d[40] = (int32_t)DESCALE(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
    d[24] = (int32_t)DESCALE(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
    d[8] = (int32_t)DESCALE(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

typedef struct {
  const uint8_t *plane; /* padded component samples */
  int stride;
  int h, v;             /* sampling factors */
  int wblocks, hblocks; /* real blocks */
  int tq, td;           /* quant table, Huffman table set (0 luma, 1 chroma) */
  int dc_pred;
} EComp;

static void encode_block(Writer *w, const int16_t *blk, int *pred, const EHuff *dc, const EHuff *ac) {
  int temp = blk[0] - *pred, temp2 = temp;
  *pred = blk[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = 0;
  while (temp) {
    nbits++;
    temp >>= 1;
  }
  w_bits(w, dc->code[nbits], dc->size[nbits]);
  if (nbits) w_bits(w, (unsigned int)temp2, nbits);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    temp = blk[natural_order[k]];
    if (temp == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      w_bits(w, ac->code[0xF0], ac->size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = 1;
    while ((temp >>= 1)) nbits++;
    int i = (r << 4) + nbits;
    w_bits(w, ac->code[i], ac->size[i]);
    w_bits(w, (unsigned int)temp2, nbits);
    r = 0;
  }
  if (r > 0) w_bits(w, ac->code[0], ac->size[0]);
}

/* Forward DCT and quantization of the block at (bx, by) of a component. */
static void fdct_block(const EComp *c, int bx, int by, const int *divisors, int16_t *out) {
  int32_t ws[64];
  for (int y = 0; y < 8; y++) {
    const uint8_t *row = c->plane + (size_t)(by * 8 + y) * c->stride + bx * 8;
    for (int x = 0; x < 8; x++) ws[y * 8 + x] = (int32_t)row[x] - 128;
  }
  fdct_islow(ws);
  for (int i = 0; i < 64; i++) {
    int q = divisors[i];
    int t = ws[i];
    if (t < 0) {
      t = -t + (q >> 1);
      t = t >= q ? t / q : 0;
      t = -t;
    } else {
      t += q >> 1;
      t = t >= q ? t / q : 0;
    }
    out[i] = (int16_t)t;
  }
}

/* Encode an image (height x width x channels, channels 3 = BGR or 1 = gray)
 * at the given quality. Returns a malloc'd buffer (free with jpeg_free) and
 * its length in *out_len; NULL on failure. */
uint8_t *jpeg_encode(const uint8_t *img, int width, int height, int channels, int quality, int64_t *out_len) {
  *out_len = 0;
  if (width <= 0 || height <= 0 || width > 65535 || height > 65535 || (channels != 1 && channels != 3)) return NULL;
  if (quality < 1) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t qt[2][64];
  for (int i = 0; i < 64; i++) {
    long t0 = ((long)std_lum_q[i] * scale + 50L) / 100L, t1 = ((long)std_chr_q[i] * scale + 50L) / 100L;
    t0 = t0 <= 0 ? 1 : (t0 > 255 ? 255 : t0);
    t1 = t1 <= 0 ? 1 : (t1 > 255 ? 255 : t1);
    qt[0][i] = (uint16_t)t0;
    qt[1][i] = (uint16_t)t1;
  }
  int divisors[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) divisors[t][i] = qt[t][i] << 3;

  int ncomp = channels == 3 ? 3 : 1;
  int hmax = ncomp == 3 ? 2 : 1, vmax = hmax;
  int mcus_x = (width + 8 * hmax - 1) / (8 * hmax), mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
  EComp comps[3];
  uint8_t *planes[3] = {0, 0, 0};
  uint8_t *result = NULL;
  Writer w = {0};

  /* Component planes, padded as libjpeg's prep/downsample controllers pad:
   * replicate the last column and row out to whole blocks of every MCU. */
  for (int ci = 0; ci < ncomp; ci++) {
    EComp *c = &comps[ci];
    c->h = ci == 0 ? hmax : 1;
    c->v = ci == 0 ? vmax : 1;
    int cw = (width * c->h + hmax - 1) / hmax, ch = (height * c->v + vmax - 1) / vmax;
    c->wblocks = (cw + 7) / 8;
    c->hblocks = (ch + 7) / 8;
    c->stride = c->wblocks * 8;
    c->tq = c->td = ci == 0 ? 0 : 1;
    c->dc_pred = 0;
    planes[ci] = (uint8_t *)malloc((size_t)c->stride * c->hblocks * 8);
    if (!planes[ci]) goto fail;
    c->plane = planes[ci];
  }
  if (ncomp == 1) {
    EComp *c = &comps[0];
    for (int y = 0; y < c->hblocks * 8; y++) {
      const uint8_t *src = img + (size_t)(y < height ? y : height - 1) * width;
      uint8_t *dst = planes[0] + (size_t)y * c->stride;
      memcpy(dst, src, (size_t)width);
      memset(dst + width, src[width - 1], (size_t)(c->stride - width));
    }
  } else {
    /* jccolor.c rgb_ycc tables, SCALEBITS 16 */
    int64_t tab[8][256];
    for (int i = 0; i < 256; i++) {
      tab[0][i] = 19595 * (int64_t)i;                                   /* R_Y  FIX(0.29900) */
      tab[1][i] = 38470 * (int64_t)i;                                   /* G_Y  FIX(0.58700) */
      tab[2][i] = 7471 * (int64_t)i + 32768;                            /* B_Y  FIX(0.11400) + ONE_HALF */
      tab[3][i] = -11059 * (int64_t)i;                                  /* R_CB FIX(0.16874) */
      tab[4][i] = -21709 * (int64_t)i;                                  /* G_CB FIX(0.33126) */
      tab[5][i] = 32768 * (int64_t)i + (128 << 16) + 32768 - 1;         /* B_CB = R_CR */
      tab[6][i] = -27439 * (int64_t)i;                                  /* G_CR FIX(0.41869) */
      tab[7][i] = -5329 * (int64_t)i;                                   /* B_CR FIX(0.08131) */
    }
    /* Full-resolution planes, width padded to 16 * chroma blocks and height to
     * an even row count (then to whole blocks), replicating the edge. */
    int fw = comps[1].wblocks * 16;
    if (fw < comps[0].stride) fw = comps[0].stride;
    int fh = comps[1].hblocks * 16;
    if (fh < comps[0].hblocks * 8) fh = comps[0].hblocks * 8;
    uint8_t *full = (uint8_t *)malloc((size_t)fw * fh * 3);
    if (!full) goto fail;
    for (int y = 0; y < height; y++) {
      const uint8_t *src = img + (size_t)y * width * 3;
      uint8_t *py = full + (size_t)y * fw, *pcb = full + (size_t)fw * fh + (size_t)y * fw,
              *pcr = full + (size_t)2 * fw * fh + (size_t)y * fw;
      for (int x = 0; x < width; x++) {
        int b = src[3 * x], g = src[3 * x + 1], r = src[3 * x + 2];
        py[x] = (uint8_t)((tab[0][r] + tab[1][g] + tab[2][b]) >> 16);
        pcb[x] = (uint8_t)((tab[3][r] + tab[4][g] + tab[5][b]) >> 16);
        pcr[x] = (uint8_t)((tab[5][r] + tab[6][g] + tab[7][b]) >> 16);
      }
      for (int k = 0; k < 3; k++) {
        uint8_t *row = full + (size_t)k * fw * fh + (size_t)y * fw;
        memset(row + width, row[width - 1], (size_t)(fw - width));
      }
    }
    for (int k = 0; k < 3; k++)
      for (int y = height; y < fh; y++)
        memcpy(full + (size_t)k * fw * fh + (size_t)y * fw, full + (size_t)k * fw * fh + (size_t)(height - 1) * fw, (size_t)fw);
    /* Y: the full-resolution plane. */
    for (int y = 0; y < comps[0].hblocks * 8; y++) memcpy(planes[0] + (size_t)y * comps[0].stride, full + (size_t)y * fw, (size_t)comps[0].stride);
    /* Cb, Cr: jcsample.c h2v2_downsample, bias 1, 2, 1, 2, ... along a row;
     * rows past the last real one replicate it. */
    int ch_real = (height + 1) / 2;
    for (int k = 1; k < 3; k++) {
      EComp *c = &comps[k];
      const uint8_t *src = full + (size_t)k * fw * fh;
      for (int y = 0; y < c->hblocks * 8; y++) {
        int sy = y < ch_real ? y : ch_real - 1;
        const uint8_t *r0 = src + (size_t)(2 * sy) * fw, *r1 = r0 + fw;
        uint8_t *dst = planes[k] + (size_t)y * c->stride;
        int bias = 1;
        for (int x = 0; x < c->stride; x++) {
          dst[x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
    }
    free(full);
  }

  /* Headers: SOI, JFIF APP0, DQT, SOF0, DHT, SOS. */
  w_byte(&w, 0xFF);
  w_byte(&w, 0xD8);
  {
    static const uint8_t app0[18] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    for (int i = 0; i < 18; i++) w_byte(&w, app0[i]);
  }
  for (int t = 0; t < (ncomp == 3 ? 2 : 1); t++) {
    w_byte(&w, 0xFF);
    w_byte(&w, 0xDB);
    w_u16(&w, 67);
    w_byte(&w, (uint8_t)t);
    for (int i = 0; i < 64; i++) w_byte(&w, (uint8_t)qt[t][natural_order[i]]);
  }
  w_byte(&w, 0xFF);
  w_byte(&w, 0xC0);
  w_u16(&w, 8 + 3 * ncomp);
  w_byte(&w, 8);
  w_u16(&w, height);
  w_u16(&w, width);
  w_byte(&w, (uint8_t)ncomp);
  for (int ci = 0; ci < ncomp; ci++) {
    w_byte(&w, (uint8_t)(ci + 1));
    w_byte(&w, (uint8_t)((comps[ci].h << 4) | comps[ci].v));
    w_byte(&w, (uint8_t)comps[ci].tq);
  }
  w_dht(&w, 0, 0, dc_lum_bits, dc_vals);
  w_dht(&w, 1, 0, ac_lum_bits, ac_lum_vals);
  if (ncomp == 3) {
    w_dht(&w, 0, 1, dc_chr_bits, dc_vals);
    w_dht(&w, 1, 1, ac_chr_bits, ac_chr_vals);
  }
  w_byte(&w, 0xFF);
  w_byte(&w, 0xDA);
  w_u16(&w, 6 + 2 * ncomp);
  w_byte(&w, (uint8_t)ncomp);
  for (int ci = 0; ci < ncomp; ci++) {
    w_byte(&w, (uint8_t)(ci + 1));
    w_byte(&w, (uint8_t)((comps[ci].td << 4) | comps[ci].td));
  }
  w_byte(&w, 0);
  w_byte(&w, 63);
  w_byte(&w, 0);

  {
    EHuff dc[2], ac[2];
    build_ehuff(dc_lum_bits, dc_vals, &dc[0]);
    build_ehuff(ac_lum_bits, ac_lum_vals, &ac[0]);
    build_ehuff(dc_chr_bits, dc_vals, &dc[1]);
    build_ehuff(ac_chr_bits, ac_chr_vals, &ac[1]);
    int16_t mcu[4][64];
    if (ncomp == 1) {
      /* A one-component scan is not interleaved: one block per MCU. */
      EComp *c = &comps[0];
      for (int by = 0; by < c->hblocks; by++)
        for (int bx = 0; bx < c->wblocks; bx++) {
          fdct_block(c, bx, by, divisors[0], mcu[0]);
          encode_block(&w, mcu[0], &c->dc_pred, &dc[0], &ac[0]);
        }
    } else {
      for (int my = 0; my < mcus_y; my++)
        for (int mx = 0; mx < mcus_x; mx++)
          for (int ci = 0; ci < 3; ci++) {
            EComp *c = &comps[ci];
            int16_t(*blocks)[64] = mcu;
            /* jccoefct.c compress_data: blocks past the component's edge are
             * dummies, all-zero AC with the DC of the block before. */
            int n = 0;
            for (int yy = 0; yy < c->v; yy++) {
              int by = my * c->v + yy;
              for (int xx = 0; xx < c->h; xx++, n++) {
                int bx = mx * c->h + xx;
                if (by < c->hblocks && bx < c->wblocks) {
                  fdct_block(c, bx, by, divisors[c->tq], blocks[n]);
                } else {
                  memset(blocks[n], 0, sizeof(blocks[n]));
                  if (by < c->hblocks)
                    blocks[n][0] = blocks[n - 1][0];                  /* right edge */
                  else
                    blocks[n][0] = blocks[yy * c->h - 1][0];          /* bottom row */
                }
              }
            }
            for (int k = 0; k < n; k++) encode_block(&w, blocks[k], &c->dc_pred, &dc[c->td], &ac[c->td]);
          }
    }
  }
  /* flush with 1-bits, then EOI */
  if (w.nacc) w_bits(&w, 0x7F, 8 - w.nacc);
  w_byte(&w, 0xFF);
  w_byte(&w, 0xD9);
  if (w.oom) goto fail;
  result = w.buf;
  *out_len = w.len;
  w.buf = NULL;
fail:
  free(w.buf);
  for (int i = 0; i < 3; i++) free(planes[i]);
  return result;
}

void jpeg_free(uint8_t *p) { free(p); }

/* ===================================================================== */
/*                                  PNG                                  */
/* ===================================================================== */

/* Undo PNG's per-row filters (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth).
 * raw: height rows of (1 + rowbytes) bytes; out: height x rowbytes.
 * Returns 0, or -1 for an unknown filter type. */
int png_unfilter(const uint8_t *raw, int height, int64_t rowbytes, int bpp, uint8_t *out) {
  for (int y = 0; y < height; y++) {
    const uint8_t *src = raw + (size_t)y * (rowbytes + 1);
    uint8_t *dst = out + (size_t)y * rowbytes;
    const uint8_t *up = y ? dst - rowbytes : NULL;
    int f = src[0];
    src++;
    for (int64_t x = 0; x < rowbytes; x++) {
      int a = x >= bpp ? dst[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= bpp) ? up[x - bpp] : 0;
      int v;
      switch (f) {
        case 0: v = src[x]; break;
        case 1: v = src[x] + a; break;
        case 2: v = src[x] + b; break;
        case 3: v = src[x] + ((a + b) >> 1); break;
        case 4: {
          int p = a + b - c;
          int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          v = src[x] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c));
          break;
        }
        default: return -1;
      }
      dst[x] = (uint8_t)v;
    }
  }
  return 0;
}
