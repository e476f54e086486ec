// Folded mel-power spectrogram, fused in one kernel for Hopper (sm_90a).
//
// Replaces audio_edge_ml_pipeline_tpu/ops/pallas_mel.py::_mel_folded_kernel
// (launched by mel_power_pallas_folded) for the even n_fft that the real FFT
// of csrc/mel_rfft.cu has no plan for (480, say): ops/mel_kernel.py routes by
// n_fft alone. A block's shared memory holds n_fft up to 1150; the wrapper
// refuses a larger one (2048, say). For each frame t of a clip x, with the clip
// center-padded by n_fft/2 zeros on each side and start = t * hop:
//
//   p[k]  = x[start + k] + x[start + n_fft - k]     (k = 1 .. n_fft/2 - 1)
//   m[k]  = x[start + k] - x[start + n_fft - k]     (p[0] = m[0] = x[start])
//   re[f] = sum_k p[k] A[k][f] + x[start + n_fft/2] wr[f]
//   im[f] = sum_k m[k] B[k][f]
//   out[t][j] = sum_f (re[f]^2 + im[f]^2) fb[f][j]
//
// A, B (the folded Hann DFT bases), wr and fb (the slaney mel bank) are
// built by the wrapper (ops/mel_kernel.py) and zero-padded to f_pad columns.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the
// tensor cores, 700 W). The function is bound by bytes: per frame it reads
// 640 new bytes of waveform and writes 160 bytes at hop 160 and 40 mels,
// against about 1.4e4 FLOP at its least (a real FFT, and the mel product over
// the slaney bank's 490 nonzeros, each bin lying in at most two filters). At
// 512 five-second clips that is 205 MB, 0.061 ms. This kernel's formulation,
// the folded dense DFT, does 2 * (n_fft/2) * n_freq multiply-adds per frame
// for re/im, about 2.7e5 FLOP, so it is bound by operations: 1.02 ms for the
// same batch. The products run as plain float32 FMAs on the CUDA cores: the
// mel features must stay within 1e-5 of a float64 oracle, and a TF32 or
// 3-pass product measured 8.8e-5, so the tensor cores are not used.
//
// Design. One block handles one clip and kTileT consecutive frames. It
// gathers p and m straight from the unpadded (B, n) waveform, doing the
// center padding with bounds checks, into shared memory (k-major, so a
// thread reads its four frames with one 16-byte load). No padded copy, p/m
// tensor or frames tensor reaches device memory: that gather is what the
// TPU kernel could not express and left to XLA. Warp w owns frames
// 4w .. 4w+3 and lane l owns frequency columns l, l+32, ...; each pass
// accumulates kChunksPerPass column chunks, reading A and B rows straight
// from global memory (all warps of the block read the same rows, so L1
// serves most of them). Power goes to shared memory, then each thread forms
// (frame, mel) dot products and writes the (B, T, n_mels) output in
// time-major order, masking the frames past T in the last tile.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kTileT = 32;          // frames per block
constexpr int kThreads = 256;       // 8 warps
constexpr int kFramesPerThread = 4; // kTileT / (kThreads / 32)
constexpr int kChunksPerPass = 3;   // f_pad must be a multiple of 32 * this

static_assert(kTileT == kFramesPerThread * (kThreads / 32), "one warp per 4 frames");

// Sample i of the center-padded clip (i in padded coordinates, clamped to
// the last padded sample like the JAX gather indices).
__device__ __forceinline__ float padded_sample(const float* __restrict__ row, long i, int n,
                                               int pad, long limit) {
  i = i < limit ? i : limit;
  const long j = i - pad;
  return (j >= 0 && j < n) ? __ldg(row + j) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
mel_folded_kernel(const float* __restrict__ y, int n, int n_frames, int n_fft, int hop,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ wr, int n_freq, int f_pad,
                  const float* __restrict__ fb, int n_mels, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int half = n_fft / 2;
  const int pw_stride = f_pad + 1;  // odd stride: rows of the mel pass land in different banks
  float* pT = smem;                         // [half][kTileT]
  float* mT = pT + half * kTileT;           // [half][kTileT]
  float* cs = mT + half * kTileT;           // [kTileT]
  float* pw = cs + kTileT;                  // [kTileT][pw_stride]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTileT;
  const float* row = y + static_cast<long>(b) * n;
  const int pad = half;
  const long limit = static_cast<long>(n) + 2 * pad - 1;

  // 1. Gather p, m and the center sample of this tile's frames.
  for (int e = threadIdx.x; e < half * kTileT; e += kThreads) {
    const int k = e / kTileT;
    const int t = e - k * kTileT;
    const long start = static_cast<long>(t0 + t) * hop;
    const float front = padded_sample(row, start + k, n, pad, limit);
    // reverse column 0 would be x[start + n_fft], the next frame's sample: forced to zero
    const float rev = k == 0 ? 0.0f : padded_sample(row, start + n_fft - k, n, pad, limit);
    pT[e] = front + rev;
    mT[e] = front - rev;
  }
  if (threadIdx.x < kTileT) {
    const long start = static_cast<long>(t0 + threadIdx.x) * hop;
    cs[threadIdx.x] = padded_sample(row, start + half, n, pad, limit);
  }
  __syncthreads();

  // 2. re / im for 4 frames x kChunksPerPass columns per thread, then power.
  const int lane = threadIdx.x & 31;
  const int tb = (threadIdx.x >> 5) * kFramesPerThread;
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
    const float* a_col = A + c0 * 32 + lane;
    const float* b_col = Bm + c0 * 32 + lane;
#pragma unroll 4
    for (int k = 0; k < half; ++k) {
      const float4 p = *reinterpret_cast<const float4*>(pT + k * kTileT + tb);
      const float4 m = *reinterpret_cast<const float4*>(mT + k * kTileT + tb);
      const long off = static_cast<long>(k) * f_pad;
#pragma unroll
      for (int c = 0; c < kChunksPerPass; ++c) {
        const float a = __ldg(a_col + off + c * 32);
        const float bb = __ldg(b_col + off + c * 32);
        re[c][0] = fmaf(p.x, a, re[c][0]);
        re[c][1] = fmaf(p.y, a, re[c][1]);
        re[c][2] = fmaf(p.z, a, re[c][2]);
        re[c][3] = fmaf(p.w, a, re[c][3]);
        im[c][0] = fmaf(m.x, bb, im[c][0]);
        im[c][1] = fmaf(m.y, bb, im[c][1]);
        im[c][2] = fmaf(m.z, bb, im[c][2]);
        im[c][3] = fmaf(m.w, bb, im[c][3]);
      }
    }
#pragma unroll
    for (int c = 0; c < kChunksPerPass; ++c) {
      const int f = (c0 + c) * 32 + lane;
      const float w = __ldg(wr + f);
#pragma unroll
      for (int i = 0; i < kFramesPerThread; ++i) {
        const float r = re[c][i] + cs[tb + i] * w;
        pw[(tb + i) * pw_stride + f] = r * r + im[c][i] * im[c][i];
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
size_t mel_folded_smem_bytes(int n_fft, int f_pad) {
  return sizeof(float) * (static_cast<size_t>(n_fft / 2) * kTileT * 2 + kTileT +
                          static_cast<size_t>(kTileT) * (f_pad + 1));
}

// Launches the kernel on `stream` (on the current device); returns
// cudaGetLastError() (0 on success). The kernel's dynamic shared-memory limit
// is raised once per device, on its first launch there, and again only if a
// larger n_fft needs more.
int mel_folded_launch(const float* y, int batch, int n, int n_frames, int n_fft, int hop,
                      const float* A, const float* Bm, const float* wr, int n_freq, int f_pad,
                      const float* fb, int n_mels, float* out, void* stream) {
  constexpr int kMaxDevices = 64;
  static std::mutex lock;
  static int smem_set[kMaxDevices] = {};  // per device: the limit set so far
  const int smem = static_cast<int>(mel_folded_smem_bytes(n_fft, f_pad));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  {
    std::lock_guard<std::mutex> guard(lock);
    if (smem > smem_set[dev]) {
      err = cudaFuncSetAttribute(mel_folded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set[dev] = smem;
    }
  }
  const dim3 grid((n_frames + kTileT - 1) / kTileT, batch);
  mel_folded_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, n, n_frames, n_fft, hop, A, Bm, wr, n_freq, f_pad, fb, n_mels, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
