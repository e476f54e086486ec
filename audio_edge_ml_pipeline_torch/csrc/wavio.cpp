// Native batched WAV decoder for the host side of feature extraction.
//
// The port's copy of the JAX package's native/wavio.cpp. Extraction decodes
// WAV files and downmixes them on the host while the card runs the previous
// batch's kernels. This library decodes RIFF/WAVE (PCM 8/16/24/32-bit and
// IEEE float32/64) to mono float32 with a C++ thread pool, behind a plain C
// ABI that ctypes loads (audio_edge_ml_pipeline_torch/data/native_wavio.py).
// Its samples equal the numpy codec's (data/audio_io.py::read_wav).
//
// Built at first use by ops/_build.py with g++ -O3 -std=c++17 -fPIC -Wall
// -pthread -shared into build/kernels/libwavio-<digest>.so.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
    uint16_t format = 0;
    uint16_t channels = 0;
    uint32_t rate = 0;
    uint16_t bits = 0;
    const uint8_t *data = nullptr;
    size_t data_len = 0;
};

bool parse_wav(const uint8_t *buf, size_t len, WavInfo *info) {
    if (len < 12 || memcmp(buf, "RIFF", 4) != 0 || memcmp(buf + 8, "WAVE", 4) != 0) return false;
    size_t pos = 12;
    size_t fmt_off = 0, fmt_size = 0;
    while (pos + 8 <= len) {
        const uint8_t *cid = buf + pos;
        uint32_t size;
        memcpy(&size, buf + pos + 4, 4);
        size_t body = pos + 8;
        if (memcmp(cid, "fmt ", 4) == 0 && body + 16 <= len) {
            fmt_off = body;
            fmt_size = size;
            memcpy(&info->format, buf + body, 2);
            memcpy(&info->channels, buf + body + 2, 2);
            memcpy(&info->rate, buf + body + 4, 4);
            memcpy(&info->bits, buf + body + 14, 2);
        } else if (memcmp(cid, "data", 4) == 0) {
            info->data = buf + body;
            info->data_len = size < len - body ? size : len - body;
        }
        pos = body + size + (size & 1);
    }
    if (info->format == 0xFFFE && fmt_size >= 26 && fmt_off + 26 <= len) {
        memcpy(&info->format, buf + fmt_off + 24, 2);  // SubFormat GUID tag
        if (info->format != 1 && info->format != 3)
            info->format = (info->bits == 32) ? 3 : 1;
    }
    return info->data != nullptr && info->channels > 0 && info->rate > 0;
}

// decode to mono float32; returns samples written (capped at capacity)
long decode_mono(const WavInfo &w, float *out, long capacity) {
    const int ch = w.channels;
    const float inv_ch = 1.0f / ch;
    long n_frames = 0;
    switch (w.format) {
        case 1:  // PCM
            switch (w.bits) {
                case 16: {
                    const int16_t *s = reinterpret_cast<const int16_t *>(w.data);
                    n_frames = (long)(w.data_len / 2 / ch);
                    if (n_frames > capacity) n_frames = capacity;
                    for (long i = 0; i < n_frames; ++i) {
                        float acc = 0.0f;
                        for (int c = 0; c < ch; ++c) acc += s[i * ch + c];
                        out[i] = acc * inv_ch / 32768.0f;
                    }
                    break;
                }
                case 32: {
                    const int32_t *s = reinterpret_cast<const int32_t *>(w.data);
                    n_frames = (long)(w.data_len / 4 / ch);
                    if (n_frames > capacity) n_frames = capacity;
                    for (long i = 0; i < n_frames; ++i) {
                        double acc = 0.0;
                        for (int c = 0; c < ch; ++c) acc += s[i * ch + c];
                        out[i] = (float)(acc * inv_ch / 2147483648.0);
                    }
                    break;
                }
                case 24: {
                    const uint8_t *s = w.data;
                    n_frames = (long)(w.data_len / 3 / ch);
                    if (n_frames > capacity) n_frames = capacity;
                    for (long i = 0; i < n_frames; ++i) {
                        float acc = 0.0f;
                        for (int c = 0; c < ch; ++c) {
                            const uint8_t *p = s + (i * ch + c) * 3;
                            int32_t v = (int32_t)(p[0] | (p[1] << 8) | (p[2] << 16));
                            if (v & 0x800000) v -= 0x1000000;
                            acc += (float)v;
                        }
                        out[i] = acc * inv_ch / 8388608.0f;
                    }
                    break;
                }
                case 8: {
                    const uint8_t *s = w.data;
                    n_frames = (long)(w.data_len / ch);
                    if (n_frames > capacity) n_frames = capacity;
                    for (long i = 0; i < n_frames; ++i) {
                        float acc = 0.0f;
                        for (int c = 0; c < ch; ++c) acc += (float)s[i * ch + c] - 128.0f;
                        out[i] = acc * inv_ch / 128.0f;
                    }
                    break;
                }
                default:
                    return -2;
            }
            break;
        case 3:  // IEEE float
            if (w.bits == 32) {
                const float *s = reinterpret_cast<const float *>(w.data);
                n_frames = (long)(w.data_len / 4 / ch);
                if (n_frames > capacity) n_frames = capacity;
                for (long i = 0; i < n_frames; ++i) {
                    float acc = 0.0f;
                    for (int c = 0; c < ch; ++c) acc += s[i * ch + c];
                    out[i] = acc * inv_ch;
                }
            } else if (w.bits == 64) {
                const double *s = reinterpret_cast<const double *>(w.data);
                n_frames = (long)(w.data_len / 8 / ch);
                if (n_frames > capacity) n_frames = capacity;
                for (long i = 0; i < n_frames; ++i) {
                    double acc = 0.0;
                    for (int c = 0; c < ch; ++c) acc += s[i * ch + c];
                    out[i] = (float)(acc * inv_ch);
                }
            } else {
                return -2;
            }
            break;
        default:
            return -2;
    }
    return n_frames;
}

long decode_file(const char *path, float *out, long capacity, int *rate) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long len = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> buf((size_t)len);
    if (fread(buf.data(), 1, (size_t)len, f) != (size_t)len) {
        fclose(f);
        return -1;
    }
    fclose(f);
    WavInfo info;
    if (!parse_wav(buf.data(), buf.size(), &info)) return -3;
    *rate = (int)info.rate;
    return decode_mono(info, out, capacity);
}

}  // namespace

extern "C" {

// Decode one file to mono float32. Returns frames written, or negative:
// -1 io error, -2 unsupported encoding, -3 malformed RIFF.
long wavio_decode(const char *path, float *out, long capacity, int *rate) {
    return decode_file(path, out, capacity, rate);
}

// Decode a batch of files in parallel into one (n, capacity) row-major
// buffer. lengths[i] receives frames-or-error per file, rates[i] the native
// sample rate. n_threads <= 0 selects the hardware concurrency.
void wavio_decode_batch(const char **paths, long n, float *out, long capacity,
                        long *lengths, int *rates, int n_threads) {
    int hw = (int)std::thread::hardware_concurrency();
    int workers = n_threads > 0 ? n_threads : (hw > 0 ? hw : 4);
    if (workers > n) workers = (int)n;
    if (workers < 1) workers = 1;
    std::vector<std::thread> threads;
    std::atomic<long> next(0);
    for (int w = 0; w < workers; ++w) {
        threads.emplace_back([&]() {
            for (long i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
                memset(out + i * capacity, 0, (size_t)capacity * sizeof(float));
                lengths[i] = decode_file(paths[i], out + i * capacity, capacity, &rates[i]);
            }
        });
    }
    for (auto &t : threads) t.join();
}

}  // extern "C"
