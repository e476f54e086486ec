// Unfolded mel-power spectrogram, fused in one kernel for Hopper (sm_90a).
//
// Replaces audio_edge_ml_pipeline_tpu/ops/pallas_mel.py::_mel_kernel
// (launched by mel_power_pallas) for the even n_fft that the real FFT of
// csrc/mel_rfft.cu has no plan for (482 or 2050, say): ops/mel_unfolded.py
// routes by n_fft alone. For each frame t of a clip x, with the clip
// center-padded by n_fft/2 zeros on each side and start = t * hop:
//
//   re[f] = sum_k x[start + k] C[k][f]        (k = 0 .. n_fft - 1)
//   im[f] = sum_k x[start + k] S[k][f]
//   out[t][j] = sum_f (re[f]^2 + im[f]^2) fb[f][j]
//
// C and S are the two halves of the windowed DFT basis (dsp.dft_bases(n_fft)
// transposed: w[k] cos(2 pi f k / N) and -w[k] sin(2 pi f k / N)), fb the
// slaney mel bank; the wrapper (ops/mel_unfolded.py) builds them and pads
// them with zeros to f_pad columns. Every sample outside the clip reads as
// zero: the JAX driver right-pads with at least n_fft/2 zeros, so no index is
// clamped (unlike the folded kernel's gather).
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the
// tensor cores, 700 W). The function is the folded kernel's, so it is bound
// by bytes: 0.061 ms at 512 five-second clips (640 bytes of waveform read and
// 160 bytes written per frame at hop 160 and 40 mels). This kernel's
// formulation, the dense unfolded DFT, does 2 * n_fft * n_freq multiply-adds
// per frame for re/im, about 5.3e5 FLOP, twice the folded form's: 2.0 ms for
// the same batch at the float32 peak. The products are plain float32 FMAs on
// the CUDA cores: the mel features must stay within 1e-5 of a float64
// oracle, and a TF32 or 3-pass product measured 8.8e-5.
//
// Design. One block handles one clip and kTileT consecutive frames. It loads
// the tile's contiguous span of the padded clip, (kTileT - 1) * hop + n_fft
// samples, into shared memory once, with zeros outside the clip, and reads
// the overlapping frames from there: no frames tensor reaches device memory.
// That in-kernel framing is what the TPU kernel could not express and left
// to XLA. Warp w owns frames 4w .. 4w+3 and lane l owns frequency columns l,
// l+32, ...; each pass accumulates kChunksPerPass column chunks, reading C
// and S rows straight from global memory (all warps read the same rows, so
// L1 serves most of them). Power goes to shared memory, then each thread
// forms (frame, mel) dot products and writes the (B, T, n_mels) output in
// time-major order, masking the frames past T in the last tile.
//
// Rounding. re and im are sums of n_fft products whose running totals grow
// large for a tone near the bin, so one float32 chain over all 512 samples,
// in this kernel or in one cuBLAS GEMM, rounds at the 1e-6 level of a clip's
// peak mel power: the two chains differed by 1.04e-6 on an H100
// (chip_smoke.py, T=201). So each block of kBlockK samples is summed into
// fresh partials and then added to the running total, and the plain version
// (ops/mel_unfolded.py) sums the same blocks in the same order; the two then
// differ by about 1.5e-7. It costs 24 registers.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kTileT = 32;          // frames per block
constexpr int kThreads = 256;       // 8 warps
constexpr int kFramesPerThread = 4; // kTileT / (kThreads / 32)
constexpr int kChunksPerPass = 3;   // f_pad must be a multiple of 32 * this
constexpr int kBlockK = 64;         // samples summed into a fresh partial before the running total

static_assert(kTileT == kFramesPerThread * (kThreads / 32), "one warp per 4 frames");

__global__ void __launch_bounds__(kThreads)
mel_unfolded_kernel(const float* __restrict__ y, int n, int n_frames, int n_fft, int hop,
                    const float* __restrict__ C, const float* __restrict__ S, int n_freq, int f_pad,
                    const float* __restrict__ fb, int n_mels, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int span = (kTileT - 1) * hop + n_fft;
  const int pw_stride = f_pad + 1;  // odd stride: rows of the mel pass land in different banks
  float* xs = smem;                 // [span] padded samples of this tile
  float* pw = xs + span;            // [kTileT][pw_stride]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTileT;
  const float* row = y + static_cast<long>(b) * n;
  const long first = static_cast<long>(t0) * hop - n_fft / 2;  // clip index of xs[0]

  // 1. The tile's span of the center-padded clip; zeros outside [0, n).
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long j = first + i;
    xs[i] = (j >= 0 && j < n) ? __ldg(row + j) : 0.0f;
  }
  __syncthreads();

  // 2. re / im for 4 frames x kChunksPerPass columns per thread, then power.
  const int lane = threadIdx.x & 31;
  const int tb = (threadIdx.x >> 5) * kFramesPerThread;
  const float* x0 = xs + tb * hop;
  const int n_chunks = f_pad / 32;
  for (int c0 = 0; c0 < n_chunks; c0 += kChunksPerPass) {
    float re[kChunksPerPass][kFramesPerThread];
    float im[kChunksPerPass][kFramesPerThread];
#pragma unroll
    for (int c = 0; c < kChunksPerPass; ++c) {
#pragma unroll
      for (int i = 0; i < kFramesPerThread; ++i) {
        re[c][i] = 0.0f;
        im[c][i] = 0.0f;
      }
    }
    const float* c_col = C + c0 * 32 + lane;
    const float* s_col = S + c0 * 32 + lane;
    for (int k0 = 0; k0 < n_fft; k0 += kBlockK) {
      // blocked sum: kBlockK terms into fresh partials, then into the total
      float bre[kChunksPerPass][kFramesPerThread];
      float bim[kChunksPerPass][kFramesPerThread];
#pragma unroll
      for (int c = 0; c < kChunksPerPass; ++c) {
#pragma unroll
        for (int i = 0; i < kFramesPerThread; ++i) {
          bre[c][i] = 0.0f;
          bim[c][i] = 0.0f;
        }
      }
      const int k1 = min(k0 + kBlockK, n_fft);
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        float x[kFramesPerThread];
#pragma unroll
        for (int i = 0; i < kFramesPerThread; ++i) x[i] = x0[i * hop + k];
        const long off = static_cast<long>(k) * f_pad;
#pragma unroll
        for (int c = 0; c < kChunksPerPass; ++c) {
          const float cv = __ldg(c_col + off + c * 32);
          const float sv = __ldg(s_col + off + c * 32);
#pragma unroll
          for (int i = 0; i < kFramesPerThread; ++i) {
            bre[c][i] = fmaf(x[i], cv, bre[c][i]);
            bim[c][i] = fmaf(x[i], sv, bim[c][i]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kChunksPerPass; ++c) {
#pragma unroll
        for (int i = 0; i < kFramesPerThread; ++i) {
          re[c][i] += bre[c][i];
          im[c][i] += bim[c][i];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kChunksPerPass; ++c) {
      const int f = (c0 + c) * 32 + lane;
#pragma unroll
      for (int i = 0; i < kFramesPerThread; ++i) {
        pw[(tb + i) * pw_stride + f] = re[c][i] * re[c][i] + im[c][i] * im[c][i];
      }
    }
  }
  __syncthreads();

  // 3. Mel product, written time-major; frames past n_frames are dropped.
  for (int e = threadIdx.x; e < kTileT * n_mels; e += kThreads) {
    const int t = e / n_mels;
    const int j = e - t * n_mels;
    if (t0 + t >= n_frames) continue;
    const float* prow = pw + t * pw_stride;
    float acc = 0.0f;
    for (int f = 0; f < n_freq; ++f) acc = fmaf(prow[f], __ldg(fb + f * n_mels + j), acc);
    out[(static_cast<long>(b) * n_frames + t0 + t) * n_mels + j] = acc;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
size_t mel_unfolded_smem_bytes(int n_fft, int hop, int f_pad) {
  return sizeof(float) * (static_cast<size_t>(kTileT - 1) * hop + n_fft +
                          static_cast<size_t>(kTileT) * (f_pad + 1));
}

// Launches the kernel on `stream` (on the current device); returns
// cudaGetLastError() (0 on success). The kernel's dynamic shared-memory limit
// is raised once per device, on its first launch there, and again only if a
// larger shape needs more.
int mel_unfolded_launch(const float* y, int batch, int n, int n_frames, int n_fft, int hop,
                        const float* C, const float* S, int n_freq, int f_pad,
                        const float* fb, int n_mels, float* out, void* stream) {
  constexpr int kMaxDevices = 64;
  static std::mutex lock;
  static int smem_set[kMaxDevices] = {};  // per device: the limit set so far
  const int smem = static_cast<int>(mel_unfolded_smem_bytes(n_fft, hop, f_pad));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  {
    std::lock_guard<std::mutex> guard(lock);
    if (smem > smem_set[dev]) {
      err = cudaFuncSetAttribute(mel_unfolded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set[dev] = smem;
    }
  }
  const dim3 grid((n_frames + kTileT - 1) / kTileT, batch);
  mel_unfolded_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, n, n_frames, n_fft, hop, C, S, n_freq, f_pad, fb, n_mels, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
