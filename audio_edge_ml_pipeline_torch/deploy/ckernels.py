"""Static C sources emitted into every generated project.

C99 NHWC kernel library (weights in Keras/flax HWIO layout) and the shared
headers — the role of reference model_to_c.py:98-323, re-derived for the
framework's flax bundles (asymmetric SAME padding computed per layer at
generation time and passed explicitly, like the reference's ONNX path,
onnx_to_c.py:33-200).
"""

ML_KERNELS_H = """\
#ifndef ML_KERNELS_H
#define ML_KERNELS_H

#include <stddef.h>

/* NHWC float32 kernel library. Explicit asymmetric zero padding (pt, pl)
 * generalizes SAME (computed per layer at generation time) and VALID
 * (pt = pl = 0). relu: 0 = linear, 1 = fused ReLU. */
void ml_normalize(const float *x, float *y, size_t n, const float *mean,
                  const float *inv_std, size_t c);
void ml_conv2d(const float *x, float *y, const float *w, const float *b,
               int h, int wdt, int cin, int cout, int kh, int kw,
               int sh, int sw, int pt, int pl, int oh, int ow, int relu);
void ml_dwconv2d(const float *x, float *y, const float *w, const float *b,
                 int h, int wdt, int c, int kh, int kw,
                 int sh, int sw, int pt, int pl, int oh, int ow, int relu);
void ml_maxpool2d(const float *x, float *y, int h, int w, int c,
                  int kh, int kw, int sh, int sw, int oh, int ow);
void ml_avgpool2d(const float *x, float *y, int h, int w, int c,
                  int kh, int kw, int sh, int sw, int oh, int ow);
void ml_gap2d(const float *x, float *y, int h, int w, int c);
void ml_batchnorm(const float *x, float *y, int n_pix, int c,
                  const float *scale, const float *shift, int relu);
void ml_dense(const float *x, float *y, const float *w, const float *b,
              int in_dim, int out_dim, int activation); /* 0=linear 1=relu 2=softmax */
void ml_quant_dequant(const float *x, float *y, size_t n, float lo, float scale);

/* int8 weight variants: weights live in flash as int8 with one per-tensor
 * scale (Stage-6 dynamic/static_int8 artifacts deployed without a float
 * re-materialization — the reference folds DequantizeLinear instead,
 * onnx_to_c.py:259-274; keeping q8 weights saves 4x flash). */
void ml_conv2d_q8(const float *x, float *y, const signed char *w, float wscale,
                  const float *b, int h, int wdt, int cin, int cout, int kh, int kw,
                  int sh, int sw, int pt, int pl, int oh, int ow, int relu);
void ml_dwconv2d_q8(const float *x, float *y, const signed char *w, float wscale,
                    const float *b, int h, int wdt, int c, int kh, int kw,
                    int sh, int sw, int pt, int pl, int oh, int ow, int relu);
void ml_dense_q8(const float *x, float *y, const signed char *w, float wscale,
                 const float *b, int in_dim, int out_dim, int activation);

#endif
"""

ML_KERNELS_C = """\
#include "ml_kernels.h"
#include <math.h>

void ml_normalize(const float *x, float *y, size_t n, const float *mean,
                  const float *inv_std, size_t c) {
    for (size_t i = 0; i < n; ++i) {
        y[i] = (x[i] - mean[i % c]) * inv_std[i % c];
    }
}

/* NHWC activations, HWIO weights (kh, kw, cin, cout); explicit asymmetric
 * padding (pt, pl) with zeros outside. */
void ml_conv2d(const float *x, float *y, const float *w, const float *b,
               int h, int wdt, int cin, int cout, int kh, int kw,
               int sh, int sw, int pt, int pl, int oh, int ow, int relu) {
    for (int oy = 0; oy < oh; ++oy) {
        for (int ox = 0; ox < ow; ++ox) {
            for (int oc = 0; oc < cout; ++oc) {
                float acc = b ? b[oc] : 0.0f;
                for (int ky = 0; ky < kh; ++ky) {
                    int iy = oy * sh - pt + ky;
                    if (iy < 0 || iy >= h) continue;
                    for (int kx = 0; kx < kw; ++kx) {
                        int ix = ox * sw - pl + kx;
                        if (ix < 0 || ix >= wdt) continue;
                        const float *xp = x + ((size_t)iy * wdt + ix) * cin;
                        const float *wp = w + (((size_t)ky * kw + kx) * cin) * cout + oc;
                        for (int ic = 0; ic < cin; ++ic) {
                            acc += xp[ic] * wp[(size_t)ic * cout];
                        }
                    }
                }
                if (relu && acc < 0.0f) acc = 0.0f;
                y[((size_t)oy * ow + ox) * cout + oc] = acc;
            }
        }
    }
}

/* depthwise conv: one filter per channel, weights (kh, kw, 1, c) */
void ml_dwconv2d(const float *x, float *y, const float *w, const float *b,
                 int h, int wdt, int c, int kh, int kw,
                 int sh, int sw, int pt, int pl, int oh, int ow, int relu) {
    for (int oy = 0; oy < oh; ++oy) {
        for (int ox = 0; ox < ow; ++ox) {
            for (int ch = 0; ch < c; ++ch) {
                float acc = b ? b[ch] : 0.0f;
                for (int ky = 0; ky < kh; ++ky) {
                    int iy = oy * sh - pt + ky;
                    if (iy < 0 || iy >= h) continue;
                    for (int kx = 0; kx < kw; ++kx) {
                        int ix = ox * sw - pl + kx;
                        if (ix < 0 || ix >= wdt) continue;
                        acc += x[((size_t)iy * wdt + ix) * c + ch]
                             * w[((size_t)ky * kw + kx) * c + ch];
                    }
                }
                if (relu && acc < 0.0f) acc = 0.0f;
                y[((size_t)oy * ow + ox) * c + ch] = acc;
            }
        }
    }
}

void ml_conv2d_q8(const float *x, float *y, const signed char *w, float wscale,
                  const float *b, int h, int wdt, int cin, int cout, int kh, int kw,
                  int sh, int sw, int pt, int pl, int oh, int ow, int relu) {
    for (int oy = 0; oy < oh; ++oy) {
        for (int ox = 0; ox < ow; ++ox) {
            for (int oc = 0; oc < cout; ++oc) {
                float acc = 0.0f;
                for (int ky = 0; ky < kh; ++ky) {
                    int iy = oy * sh - pt + ky;
                    if (iy < 0 || iy >= h) continue;
                    for (int kx = 0; kx < kw; ++kx) {
                        int ix = ox * sw - pl + kx;
                        if (ix < 0 || ix >= wdt) continue;
                        const float *xp = x + ((size_t)iy * wdt + ix) * cin;
                        const signed char *wp = w + (((size_t)ky * kw + kx) * cin) * cout + oc;
                        for (int ic = 0; ic < cin; ++ic) {
                            acc += xp[ic] * (float)wp[(size_t)ic * cout];
                        }
                    }
                }
                acc = acc * wscale + (b ? b[oc] : 0.0f);
                if (relu && acc < 0.0f) acc = 0.0f;
                y[((size_t)oy * ow + ox) * cout + oc] = acc;
            }
        }
    }
}

void ml_dwconv2d_q8(const float *x, float *y, const signed char *w, float wscale,
                    const float *b, int h, int wdt, int c, int kh, int kw,
                    int sh, int sw, int pt, int pl, int oh, int ow, int relu) {
    for (int oy = 0; oy < oh; ++oy) {
        for (int ox = 0; ox < ow; ++ox) {
            for (int ch = 0; ch < c; ++ch) {
                float acc = 0.0f;
                for (int ky = 0; ky < kh; ++ky) {
                    int iy = oy * sh - pt + ky;
                    if (iy < 0 || iy >= h) continue;
                    for (int kx = 0; kx < kw; ++kx) {
                        int ix = ox * sw - pl + kx;
                        if (ix < 0 || ix >= wdt) continue;
                        acc += x[((size_t)iy * wdt + ix) * c + ch]
                             * (float)w[((size_t)ky * kw + kx) * c + ch];
                    }
                }
                acc = acc * wscale + (b ? b[ch] : 0.0f);
                if (relu && acc < 0.0f) acc = 0.0f;
                y[((size_t)oy * ow + ox) * c + ch] = acc;
            }
        }
    }
}

void ml_maxpool2d(const float *x, float *y, int h, int w, int c,
                  int kh, int kw, int sh, int sw, int oh, int ow) {
    for (int oy = 0; oy < oh; ++oy) {
        for (int ox = 0; ox < ow; ++ox) {
            for (int ch = 0; ch < c; ++ch) {
                float m = -3.4e38f;
                for (int ky = 0; ky < kh; ++ky) {
                    int iy = oy * sh + ky;
                    if (iy >= h) continue;
                    for (int kx = 0; kx < kw; ++kx) {
                        int ix = ox * sw + kx;
                        if (ix >= w) continue;
                        float v = x[((size_t)iy * w + ix) * c + ch];
                        if (v > m) m = v;
                    }
                }
                y[((size_t)oy * ow + ox) * c + ch] = m;
            }
        }
    }
}

/* average pool, VALID windows (all taps inside; partial cells skipped and
 * the divisor counts only visited taps, matching flax avg_pool) */
void ml_avgpool2d(const float *x, float *y, int h, int w, int c,
                  int kh, int kw, int sh, int sw, int oh, int ow) {
    for (int oy = 0; oy < oh; ++oy) {
        for (int ox = 0; ox < ow; ++ox) {
            for (int ch = 0; ch < c; ++ch) {
                float acc = 0.0f;
                int cnt = 0;
                for (int ky = 0; ky < kh; ++ky) {
                    int iy = oy * sh + ky;
                    if (iy >= h) continue;
                    for (int kx = 0; kx < kw; ++kx) {
                        int ix = ox * sw + kx;
                        if (ix >= w) continue;
                        acc += x[((size_t)iy * w + ix) * c + ch];
                        ++cnt;
                    }
                }
                y[((size_t)oy * ow + ox) * c + ch] = cnt ? acc / (float)cnt : 0.0f;
            }
        }
    }
}

void ml_gap2d(const float *x, float *y, int h, int w, int c) {
    for (int ch = 0; ch < c; ++ch) y[ch] = 0.0f;
    for (int i = 0; i < h * w; ++i) {
        for (int ch = 0; ch < c; ++ch) y[ch] += x[(size_t)i * c + ch];
    }
    float inv = 1.0f / (float)(h * w);
    for (int ch = 0; ch < c; ++ch) y[ch] *= inv;
}

/* batch norm folded to per-channel affine at generation time:
 * scale = gamma / sqrt(var + eps), shift = beta - mean * scale */
void ml_batchnorm(const float *x, float *y, int n_pix, int c,
                  const float *scale, const float *shift, int relu) {
    for (int i = 0; i < n_pix; ++i) {
        for (int ch = 0; ch < c; ++ch) {
            float v = x[(size_t)i * c + ch] * scale[ch] + shift[ch];
            if (relu && v < 0.0f) v = 0.0f;
            y[(size_t)i * c + ch] = v;
        }
    }
}

/* static-int8 input emulation: quantize to the calibrated uint8 grid and
 * dequantize back (the accuracy the Stage-6 report measured) */
void ml_quant_dequant(const float *x, float *y, size_t n, float lo, float scale) {
    for (size_t i = 0; i < n; ++i) {
        float q = (x[i] - lo) / scale;
        q = q < 0.0f ? 0.0f : (q > 255.0f ? 255.0f : q);
        /* nearbyintf under the default FP env rounds half-to-even like
         * np.round, matching the emulation the report's accuracy used */
        y[i] = nearbyintf(q) * scale + lo;
    }
}

void ml_dense(const float *x, float *y, const float *w, const float *b,
              int in_dim, int out_dim, int activation) {
    for (int o = 0; o < out_dim; ++o) {
        float acc = b ? b[o] : 0.0f;
        const float *wp = w + o; /* weights (in_dim, out_dim) */
        for (int i = 0; i < in_dim; ++i) acc += x[i] * wp[(size_t)i * out_dim];
        y[o] = acc;
    }
    if (activation == 1) {
        for (int o = 0; o < out_dim; ++o) y[o] = y[o] > 0.0f ? y[o] : 0.0f;
    } else if (activation == 2) {
        float mx = y[0];
        for (int o = 1; o < out_dim; ++o) if (y[o] > mx) mx = y[o];
        float sum = 0.0f;
        for (int o = 0; o < out_dim; ++o) { y[o] = expf(y[o] - mx); sum += y[o]; }
        for (int o = 0; o < out_dim; ++o) y[o] /= sum;
    }
}

void ml_dense_q8(const float *x, float *y, const signed char *w, float wscale,
                 const float *b, int in_dim, int out_dim, int activation) {
    for (int o = 0; o < out_dim; ++o) {
        float acc = 0.0f;
        const signed char *wp = w + o; /* weights (in_dim, out_dim) */
        for (int i = 0; i < in_dim; ++i) acc += x[i] * (float)wp[(size_t)i * out_dim];
        y[o] = acc * wscale + (b ? b[o] : 0.0f);
    }
    if (activation == 1) {
        for (int o = 0; o < out_dim; ++o) y[o] = y[o] > 0.0f ? y[o] : 0.0f;
    } else if (activation == 2) {
        float mx = y[0];
        for (int o = 1; o < out_dim; ++o) if (y[o] > mx) mx = y[o];
        float sum = 0.0f;
        for (int o = 0; o < out_dim; ++o) { y[o] = expf(y[o] - mx); sum += y[o]; }
        for (int o = 0; o < out_dim; ++o) y[o] /= sum;
    }
}
"""

FEATURES_C_TEMPLATE = """\
#include "frontend.h"
#include "feat_data.h"
#include <math.h>
#include <string.h>

/* Mel-spectrogram frontend with librosa-contract parity:
 *   center=True constant padding (frame fi starts at fi*hop - n_fft/2,
 *   zeros outside), periodic Hann, power spectrum, slaney mel filterbank,
 *   power_to_db(ref=max, amin=1e-10, top_db=80), min-max [0,1].
 * Matches ops.golden.mel_spec_feature to float32 precision.
 */

#define N_FFT      {n_fft}
#define HOP        {hop}
#define N_MELS     {n_mels}
#define N_FRAMES   {n_frames}
#define N_SAMPLES  {n_samples}
#define N_FREQ     (N_FFT / 2 + 1)

static float fft_re[N_FFT];
static float fft_im[N_FFT];
static float power_spec[N_FREQ];

/* iterative radix-2 complex FFT (in place, bit-reversal permutation) */
static void fft_radix2(float *re, float *im, int n) {{
    for (int i = 1, j = 0; i < n; ++i) {{
        int bit = n >> 1;
        for (; j & bit; bit >>= 1) j ^= bit;
        j ^= bit;
        if (i < j) {{
            float tr = re[i]; re[i] = re[j]; re[j] = tr;
            float ti = im[i]; im[i] = im[j]; im[j] = ti;
        }}
    }}
    for (int len = 2; len <= n; len <<= 1) {{
        float ang = -6.283185307179586f / (float)len;
        float wr = cosf(ang), wi = sinf(ang);
        for (int i = 0; i < n; i += len) {{
            float cr = 1.0f, ci = 0.0f;
            for (int k = 0; k < len / 2; ++k) {{
                int a = i + k, b = i + k + len / 2;
                float ur = re[a], ui = im[a];
                float vr = re[b] * cr - im[b] * ci;
                float vi = re[b] * ci + im[b] * cr;
                re[a] = ur + vr; im[a] = ui + vi;
                re[b] = ur - vr; im[b] = ui - vi;
                float ncr = cr * wr - ci * wi;
                ci = cr * wi + ci * wr;
                cr = ncr;
            }}
        }}
    }}
}}

/* one frame: windowed FFT -> mel power column fi of out */
static void feat_frame(const float *samples, const short *pcm, int fi, float *out) {{
    int start = fi * HOP - N_FFT / 2; /* center=True */
    for (int i = 0; i < N_FFT; ++i) {{
        int idx = start + i;
        float v = 0.0f;
        if (idx >= 0 && idx < N_SAMPLES)
            v = samples ? samples[idx] : (float)pcm[idx] * (1.0f / 32768.0f);
        fft_re[i] = v * feat_hann[i];
        fft_im[i] = 0.0f;
    }}
    fft_radix2(fft_re, fft_im, N_FFT);
    for (int k = 0; k < N_FREQ; ++k) {{
        power_spec[k] = fft_re[k] * fft_re[k] + fft_im[k] * fft_im[k];
    }}
    for (int m = 0; m < N_MELS; ++m) {{
        const float *fb = feat_mel_fb + (size_t)m * N_FREQ;
        float acc = 0.0f;
        for (int k = 0; k < N_FREQ; ++k) acc += fb[k] * power_spec[k];
        out[(size_t)m * N_FRAMES + fi] = acc;
    }}
}}

static void feat_finish(float *out) {{
    /* power_to_db(ref=max, amin=1e-10, top_db=80) */
    float peak = 1e-10f;
    size_t n = (size_t)N_MELS * N_FRAMES;
    for (size_t i = 0; i < n; ++i) if (out[i] > peak) peak = out[i];
    float ref_db = 10.0f * log10f(peak);
    float mx = -3.4e38f;
    for (size_t i = 0; i < n; ++i) {{
        float v = out[i] > 1e-10f ? out[i] : 1e-10f;
        out[i] = 10.0f * log10f(v) - ref_db;
        if (out[i] > mx) mx = out[i];
    }}
    float floor_db = mx - 80.0f, mn = 3.4e38f;
    for (size_t i = 0; i < n; ++i) {{
        if (out[i] < floor_db) out[i] = floor_db;
        if (out[i] < mn) mn = out[i];
    }}
    float inv = 1.0f / (mx - mn + 1e-8f);
    for (size_t i = 0; i < n; ++i) out[i] = (out[i] - mn) * inv;
}}

/* samples: float waveform in [-1, 1], length N_SAMPLES.
 * out: N_MELS * N_FRAMES floats, row-major (mel, frame). */
void features_extract(const float *samples, float *out) {{
    for (int fi = 0; fi < N_FRAMES; ++fi) feat_frame(samples, 0, fi, out);
    feat_finish(out);
}}

/* int16 PCM straight from capture — per-frame conversion, no float
 * waveform buffer (the PCM can stay aliased inside the model arena). */
void features_extract_pcm(const short *pcm, float *out) {{
    for (int fi = 0; fi < N_FRAMES; ++fi) feat_frame(0, pcm, fi, out);
    feat_finish(out);
}}
"""

FEATURES_H = """\
#ifndef FRONTEND_H
#define FRONTEND_H

void features_extract(const float *samples, float *out);
void features_extract_pcm(const short *pcm, float *out);

#endif
"""

HOST_MAIN_C = """\
/* Host parity harness: reads a raw float32 file and prints outputs.
 *
 *   ./host_runner --features in.f32     -> mel features, one float per line
 *   ./host_runner --predict  in.f32     -> class probabilities
 *   ./host_runner --predict-feat in.f32 -> probabilities from raw features
 *
 * Compiled by tests with: gcc -O2 -std=c99 host_main.c frontend.c feat_data.c
 *   ml_kernels.c model.c weights.c -lm
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "frontend.h"
#include "model.h"

static float *read_f32(const char *path, size_t n) {
    FILE *f = fopen(path, "rb");
    if (!f) { fprintf(stderr, "cannot open %s\\n", path); exit(2); }
    float *buf = (float *)malloc(n * sizeof(float));
    if (fread(buf, sizeof(float), n, f) != n) { fprintf(stderr, "short read\\n"); exit(2); }
    fclose(f);
    return buf;
}

int main(int argc, char **argv) {
    if (argc < 3) { fprintf(stderr, "usage: %s --features|--predict|--predict-feat <file.f32>\\n", argv[0]); return 2; }
    static float feat[MODEL_INPUT_SIZE];
    static float arena[MODEL_ARENA_FLOATS];
    static float scores[MODEL_N_CLASSES];
    if (strcmp(argv[1], "--features") == 0) {
        float *wav = read_f32(argv[2], MODEL_N_SAMPLES);
        features_extract(wav, feat);
        for (size_t i = 0; i < MODEL_INPUT_SIZE; ++i) printf("%.9g\\n", feat[i]);
    } else if (strcmp(argv[1], "--predict") == 0) {
        float *wav = read_f32(argv[2], MODEL_N_SAMPLES);
        features_extract(wav, feat);
        model_run(feat, scores, arena);
        for (int i = 0; i < MODEL_N_CLASSES; ++i) printf("%.9g\\n", scores[i]);
    } else if (strcmp(argv[1], "--predict-feat") == 0) {
        float *in = read_f32(argv[2], MODEL_INPUT_SIZE);
        model_run(in, scores, arena);
        for (int i = 0; i < MODEL_N_CLASSES; ++i) printf("%.9g\\n", scores[i]);
    } else {
        fprintf(stderr, "unknown mode %s\\n", argv[1]);
        return 2;
    }
    return 0;
}
"""
