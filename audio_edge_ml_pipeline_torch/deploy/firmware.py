"""Firmware templates: main.cpp (inference loop + serial modes), audio
capture drivers, and the Nicla Vision linker script.

Behavioral contract of reference model_to_c.py:329-470 (drivers), 630-827
(main loop, PCM/arena aliasing, DC removal, 4 kHz notch, top-3 output,
FEAT_DUMP / PCM_DUMP / EVAL modes with magic-framed binary serial), 833-964
(platformio.ini + linker script exposing the full 1 MB AXI SRAM and a
.pdm_buffer section in RAM_D3).
"""

MAIN_CPP_TEMPLATE = """\
/* Generated inference firmware.
 *
 * Compile-time modes (add to build_flags):
 *   -DFEAT_DUMP_MODE  stream extracted mel features over serial (magic-framed)
 *   -DPCM_DUMP_MODE   stream raw PCM captures over serial (magic-framed)
 *   -DEVAL_MODE       host-driven evaluation: READY -> 'R' -> PRED/SCORES/EVAL_DONE
 */
#include <Arduino.h>
extern "C" {{
#include "model.h"
#include "frontend.h"
}}
#include "audio.h"
#include "labels.h"

#define SAMPLE_RATE {sample_rate}
#define N_SAMPLES   {n_samples}

/* The PCM buffer aliases the activation arena: capture fills it with int16,
 * the frontend reads the int16 directly (features_extract_pcm converts per
 * frame), and the model then reuses the same memory for activations — no
 * separate float waveform buffer ever exists (saves N_SAMPLES*4 bytes). */
static float g_arena[MODEL_ARENA_FLOATS > (N_SAMPLES / 2 + 1) ? MODEL_ARENA_FLOATS : (N_SAMPLES / 2 + 1)];
static short *g_pcm = (short *)g_arena;
static float g_feat[MODEL_INPUT_SIZE];
static float g_scores[MODEL_N_CLASSES];

/* DC removal + 4 kHz biquad notch (PDM clock artifact) */
static void preprocess_pcm(short *pcm, int n) {{
    long long sum = 0; /* 32-bit overflows at ~26800 mean counts x 80k samples */
    for (int i = 0; i < n; ++i) sum += pcm[i];
    short dc = (short)(sum / n);
    float x1 = 0, x2 = 0, y1 = 0, y2 = 0;
    const float b0 = {b0}f, b1 = {b1}f, b2 = {b2}f, a1 = {a1}f, a2 = {a2}f;
    for (int i = 0; i < n; ++i) {{
        float x = (float)(pcm[i] - dc);
        float y = b0 * x + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2;
        x2 = x1; x1 = x; y2 = y1; y1 = y;
        if (y > 32767.0f) y = 32767.0f;
        if (y < -32768.0f) y = -32768.0f;
        pcm[i] = (short)y;
    }}
}}

static void extract_features() {{
    features_extract_pcm(g_pcm, g_feat);
}}

static void print_top3() {{
    int top[3] = {{0, 0, 0}};
    for (int k = 0; k < 3; ++k) {{
        float best = -1.0f;
        for (int i = 0; i < MODEL_N_CLASSES; ++i) {{
            bool used = false;
            for (int j = 0; j < k; ++j) if (top[j] == i) used = true;
            if (!used && g_scores[i] > best) {{ best = g_scores[i]; top[k] = i; }}
        }}
    }}
    for (int k = 0; k < 3; ++k) {{
        Serial.print(LABELS[top[k]]);
        Serial.print(": ");
        Serial.println(g_scores[top[k]], 4);
    }}
}}

#if defined(FEAT_DUMP_MODE) || defined(PCM_DUMP_MODE)
static void write_magic(const unsigned char m[4]) {{ Serial.write(m, 4); }}
static const unsigned char MAGIC_FEAT[4] = {{0xFE, 0xED, 0x12, 0x34}};
static const unsigned char MAGIC_END[4]  = {{0xDE, 0xAD, 0x56, 0x78}};
static const unsigned char MAGIC_PCM[4]  = {{0xCA, 0xFE, 0xBA, 0xBE}};
#endif

void setup() {{
    Serial.begin(115200);
    while (!Serial && millis() < 4000) {{}}
    audio_init(SAMPLE_RATE);
    Serial.println("READY");
}}

void loop() {{
#ifdef EVAL_MODE
    /* host protocol: wait for 'R', record, reply PRED/SCORES/EVAL_DONE */
    if (!Serial.available()) {{ delay(5); return; }}
    int c = Serial.read();
    if (c != 'R') return;
#endif
    audio_record(g_pcm, N_SAMPLES);
    preprocess_pcm(g_pcm, N_SAMPLES);
#ifdef PCM_DUMP_MODE
    write_magic(MAGIC_PCM);
    unsigned int n = N_SAMPLES;
    Serial.write((unsigned char *)&n, 4);
    Serial.write((unsigned char *)g_pcm, N_SAMPLES * 2);
    write_magic(MAGIC_END);
    return;
#endif
    extract_features();
#ifdef FEAT_DUMP_MODE
    write_magic(MAGIC_FEAT);
    unsigned int dims[2] = {{MODEL_N_MELS, MODEL_N_FRAMES}};
    Serial.write((unsigned char *)dims, 8);
    Serial.write((unsigned char *)g_feat, sizeof(g_feat));
    write_magic(MAGIC_END);
    return;
#endif
    model_run(g_feat, g_scores, g_arena);
#ifdef EVAL_MODE
    int best = 0;
    for (int i = 1; i < MODEL_N_CLASSES; ++i) if (g_scores[i] > g_scores[best]) best = i;
    Serial.print("PRED ");
    Serial.println(LABELS[best]);
    Serial.print("SCORES");
    for (int i = 0; i < MODEL_N_CLASSES; ++i) {{ Serial.print(' '); Serial.print(g_scores[i], 6); }}
    Serial.println();
    Serial.println("EVAL_DONE");
#else
    Serial.println("---");
    print_top3();
#endif
}}
"""

AUDIO_H = """\
#ifndef AUDIO_H
#define AUDIO_H

void audio_init(int sample_rate);
/* blocking capture of n int16 samples */
void audio_record(short *buf, int n);

#endif
"""

AUDIO_PDM_CPP = """\
/* PDM microphone capture (STM32 Nicla Vision / nRF52840 Sense).
 *
 * ISR copies PDM.read() chunks into the caller's ring position. Guards:
 *  - a 512-sample warmup flush (the first PDM samples are DC-biased junk)
 *  - the done flag only latches when the position is valid and the target
 *    buffer is non-NULL, avoiding the false-done race on restart.
 */
#include <Arduino.h>
#include <PDM.h>
#include "audio.h"

static volatile int g_pos = 0;
static volatile int g_target = 0;
static short *g_buf = 0;
static volatile bool g_done = true;

#if defined(ARDUINO_NICLA_VISION) || defined(TARGET_STM32H7)
__attribute__((section(".pdm_buffer")))
#endif
static short g_chunk[512];

static void on_pdm() {
    int bytes = PDM.available();
    if (bytes > (int)sizeof(g_chunk)) bytes = sizeof(g_chunk);
    PDM.read(g_chunk, bytes);
    int n = bytes / 2;
    if (g_done || g_buf == 0) return;      /* idle guard */
    int pos = g_pos;
    if (pos >= g_target) return;           /* false-done race guard */
    int copy = g_target - pos;
    if (copy > n) copy = n;
    for (int i = 0; i < copy; ++i) g_buf[pos + i] = g_chunk[i];
    g_pos = pos + copy;
    if (g_pos >= g_target && g_buf != 0) g_done = true;
}

static int g_rate = 16000;

void audio_init(int sample_rate) {
    g_rate = sample_rate;
    PDM.onReceive(on_pdm);
    PDM.setGain(12);
    if (!PDM.begin(1, sample_rate)) {
        Serial.println("PDM init failed!");
        while (1) delay(100);
    }
    /* warmup flush */
    static short warmup[512];
    g_buf = warmup; g_target = 512; g_pos = 0; g_done = false;
    unsigned long t0 = millis();
    while (!g_done && millis() - t0 < 500) delay(1);
    g_buf = 0; g_done = true;
}

void audio_record(short *buf, int n) {
    g_buf = buf; g_target = n; g_pos = 0; g_done = false;
    while (!g_done) delay(1);
    g_buf = 0;
}
"""

AUDIO_I2S_CPP = """\
/* I2S microphone capture (ESP32-S3, e.g. INMP441). */
#include <Arduino.h>
#include <driver/i2s.h>
#include "audio.h"

#define I2S_PORT I2S_NUM_0
#define PIN_BCK  4
#define PIN_WS   5
#define PIN_DIN  6

void audio_init(int sample_rate) {
    i2s_config_t cfg = {};
    cfg.mode = (i2s_mode_t)(I2S_MODE_MASTER | I2S_MODE_RX);
    cfg.sample_rate = sample_rate;
    cfg.bits_per_sample = I2S_BITS_PER_SAMPLE_32BIT;
    cfg.channel_format = I2S_CHANNEL_FMT_ONLY_LEFT;
    cfg.communication_format = I2S_COMM_FORMAT_STAND_I2S;
    cfg.dma_buf_count = 8;
    cfg.dma_buf_len = 256;
    i2s_driver_install(I2S_PORT, &cfg, 0, NULL);
    i2s_pin_config_t pins = {};
    pins.bck_io_num = PIN_BCK;
    pins.ws_io_num = PIN_WS;
    pins.data_out_num = I2S_PIN_NO_CHANGE;
    pins.data_in_num = PIN_DIN;
    i2s_set_pin(I2S_PORT, &pins);
}

void audio_record(short *buf, int n) {
    static int32_t raw[256];
    int got = 0;
    while (got < n) {
        size_t bytes = 0;
        i2s_read(I2S_PORT, raw, sizeof(raw), &bytes, portMAX_DELAY);
        int samples = bytes / 4;
        for (int i = 0; i < samples && got < n; ++i) {
            /* INMP441: 24-bit sample MSB-aligned in 32 bits -> >>16 keeps
             * the top 16 bits; the old >>14 wrapped loud audio in the
             * int16 cast instead of scaling it */
            buf[got++] = (short)(raw[i] >> 16);
        }
    }
}
"""

AUDIO_STUB_CPP = """\
/* Stub capture driver (no microphone): returns silence. */
#include "audio.h"
#include <string.h>

void audio_init(int sample_rate) { (void)sample_rate; }
void audio_record(short *buf, int n) { memset(buf, 0, (size_t)n * 2); }
"""

NICLA_LD = """\
/* Nicla Vision (STM32H747 M7) linker script override:
 * expose the full 1 MB AXI SRAM for data (the stock script caps it) and a
 * dedicated .pdm_buffer section in RAM_D3 so the PDM DMA chunk lives in a
 * domain the peripheral can reach. */
MEMORY
{
  FLASH (rx)  : ORIGIN = 0x08040000, LENGTH = 768K
  DTCMRAM (rwx) : ORIGIN = 0x20000000, LENGTH = 128K
  RAM (rwx)   : ORIGIN = 0x24000000, LENGTH = 1024K  /* AXI SRAM, full 1 MB */
  RAM_D2 (rwx): ORIGIN = 0x30000000, LENGTH = 288K
  RAM_D3 (rwx): ORIGIN = 0x38000000, LENGTH = 64K
}

SECTIONS
{
  .pdm_buffer (NOLOAD) :
  {
    . = ALIGN(4);
    *(.pdm_buffer)
    . = ALIGN(4);
  } > RAM_D3
}
INSERT AFTER .bss;
"""
