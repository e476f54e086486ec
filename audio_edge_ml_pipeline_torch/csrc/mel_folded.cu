// Folded mel-power spectrogram, fused in one kernel for Hopper (sm_90a).
//
// Replaces audio_edge_ml_pipeline_tpu/ops/pallas_mel.py::_mel_folded_kernel
// (launched by mel_power_pallas_folded) for the even n_fft that the real FFT
// of csrc/mel_rfft.cu has no plan for (482, 2050, say): ops/mel_kernel.py
// routes by n_fft alone. It has a float32 instantiation and a float64 one
// (``precise=True``, the MFCC features). For each frame t of a clip x, with
// the clip center-padded by n_fft/2 zeros on each side and start = t * hop:
//
//   p[k]  = x[start + k] + x[start + n_fft - k]     (k = 1 .. n_fft/2 - 1)
//   m[k]  = x[start + k] - x[start + n_fft - k]     (p[0] = m[0] = x[start])
//   re[f] = sum_k p[k] A[k][f] + x[start + n_fft/2] wr[f]
//   im[f] = sum_k m[k] B[k][f]
//   out[t][j] = sum_f (re[f]^2 + im[f]^2) fb[f][j]
//
// A, B (the folded Hann DFT bases), wr and fb (the slaney mel bank) are
// built by the wrapper (ops/mel_kernel.py), in the instantiation's type from
// float64, and zero-padded to f_pad columns.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the
// tensor cores, 700 W). The function is bound by bytes: per frame it reads
// 640 new bytes of waveform and writes 160 bytes at hop 160 and 40 mels,
// against about 1.4e4 FLOP at its least (a real FFT, and the mel product over
// the slaney bank's 490 nonzeros, each bin lying in at most two filters). At
// 512 five-second clips that is 205 MB, 0.061 ms. This kernel's formulation,
// the folded dense DFT, does 2 * (n_fft/2) * n_freq multiply-adds per frame
// for re/im, about 2.7e5 FLOP, so it is bound by operations: 1.02 ms for the
// same batch. The products run as plain FMAs on the CUDA cores: the mel
// features must stay within 1e-5 of a float64 oracle, and a TF32 or 3-pass
// product measured 8.8e-5, so the tensor cores are not used. It is the
// route of the sizes with no FFT plan, kept simple and right, not fast.
//
// Design. One block handles one clip and kTileT consecutive frames. It
// gathers p and m straight from the unpadded (B, n) waveform, doing the
// center padding with bounds checks, into shared memory (k-major, so a
// thread reads its four frames with one 16-byte load in float32, two in
// float64). No padded copy, p/m tensor or frames tensor reaches device
// memory: that gather is what the TPU kernel could not express and left to
// XLA. The 8 warps split into kTileT / 4 frame groups of 4 frames times
// 32 / kTileT column groups; lane l owns frequency columns l, l + 32, ...
// of each chunk, and each pass accumulates kChunksPerPass column chunks,
// reading A and B rows straight from global memory (all warps of the block
// read the same rows, so L1 serves most of them). Power goes to shared
// memory, then each thread forms (frame, mel) dot products and writes the
// (B, T, n_mels) output in time-major order, masking the frames past T in
// the last tile.
//
// Rounding. re and im are sums of n_fft/2 products; one float32 chain over
// all of them rounded at 1.39e-6 of a clip's peak mel power at n_fft 3000 on
// an H100, against the plain version's float64 (tolerance 1e-6). So each
// block of kBlockK fold pairs is summed into fresh partials and then added
// to the running totals, as csrc/mel_unfolded.cu does: at most 4.1e-7 from
// n_fft 4 to 4096 on an H100 (chip_smoke.py's sweep).
//
// Shared memory is sizeof(T) (n_fft/2 kTileT 2 + kTileT + kTileT (f_pad + 1))
// bytes, so the frames a block shrink with n_fft and the type: the wrapper
// takes the largest of 32, 16, 8 and 4 that fits in 232,448 bytes. At 4
// frames a block that holds every even n_fft up to 9,630 in float32 and 4,798
// in float64.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;       // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kFramesPerThread = 4; // one 4-frame group a warp
constexpr int kChunksPerPass = 3;   // f_pad must be a multiple of 32 * this
constexpr int kBlockK = 64;         // fold pairs summed into fresh partials before the running totals

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

// Four consecutive frames of p or m from shared memory (16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Sample i of the center-padded clip (i in padded coordinates, clamped to
// the last padded sample like the JAX gather indices).
__device__ __forceinline__ float padded_sample(const float* __restrict__ row, long i, int n,
                                               int pad, long limit) {
  i = i < limit ? i : limit;
  const long j = i - pad;
  return (j >= 0 && j < n) ? __ldg(row + j) : 0.0f;
}

template <typename T, int kTileT>
__global__ void __launch_bounds__(kThreads)
mel_folded_kernel(const float* __restrict__ y, int n, int n_frames, int n_fft, int hop,
                  const T* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ wr, int n_freq, int f_pad,
                  const T* __restrict__ fb, int n_mels, float* __restrict__ out) {
  constexpr int kFrameGroups = kTileT / kFramesPerThread;  // warps along the frames
  constexpr int kColumnGroups = kWarps / kFrameGroups;     // warps along the frequency chunks
  static_assert(kFrameGroups * kColumnGroups == kWarps, "the warps tile the frames and chunks");
  extern __shared__ __align__(16) float smem_words[];
  T* smem = reinterpret_cast<T*>(smem_words);
  const int half = n_fft / 2;
  const int pw_stride = f_pad + 1;  // odd stride: rows of the mel pass land in different banks
  T* pT = smem;                         // [half][kTileT]
  T* mT = pT + half * kTileT;           // [half][kTileT]
  T* cs = mT + half * kTileT;           // [kTileT]
  T* pw = cs + kTileT;                  // [kTileT][pw_stride]

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
    const T front = padded_sample(row, start + k, n, pad, limit);
    // reverse column 0 would be x[start + n_fft], the next frame's sample: forced to zero
    const T rev = k == 0 ? T(0) : T(padded_sample(row, start + n_fft - k, n, pad, limit));
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
  const int warp = threadIdx.x >> 5;
  const int tb = (warp % kFrameGroups) * kFramesPerThread;
  const int n_chunks = f_pad / 32;
  for (int c0 = (warp / kFrameGroups) * kChunksPerPass; c0 < n_chunks; c0 += kColumnGroups * kChunksPerPass) {
    T re[kChunksPerPass][kFramesPerThread];
    T im[kChunksPerPass][kFramesPerThread];
#pragma unroll
    for (int c = 0; c < kChunksPerPass; ++c) {
#pragma unroll
      for (int i = 0; i < kFramesPerThread; ++i) {
        re[c][i] = T(0);
        im[c][i] = T(0);
      }
    }
    const T* a_col = A + c0 * 32 + lane;
    const T* b_col = Bm + c0 * 32 + lane;
    for (int k0 = 0; k0 < half; k0 += kBlockK) {
      const int k1 = k0 + kBlockK < half ? k0 + kBlockK : half;
      T pre[kChunksPerPass][kFramesPerThread] = {};
      T pim[kChunksPerPass][kFramesPerThread] = {};
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        T p[kFramesPerThread], m[kFramesPerThread];
        load4(pT + k * kTileT + tb, p);
        load4(mT + k * kTileT + tb, m);
        const long off = static_cast<long>(k) * f_pad;
#pragma unroll
        for (int c = 0; c < kChunksPerPass; ++c) {
          const T a = __ldg(a_col + off + c * 32);
          const T bb = __ldg(b_col + off + c * 32);
#pragma unroll
          for (int i = 0; i < kFramesPerThread; ++i) {
            pre[c][i] = fma_(p[i], a, pre[c][i]);
            pim[c][i] = fma_(m[i], bb, pim[c][i]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kChunksPerPass; ++c) {
#pragma unroll
        for (int i = 0; i < kFramesPerThread; ++i) {
          re[c][i] += pre[c][i];
          im[c][i] += pim[c][i];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kChunksPerPass; ++c) {
      const int f = (c0 + c) * 32 + lane;
      const T w = __ldg(wr + f);
#pragma unroll
      for (int i = 0; i < kFramesPerThread; ++i) {
        const T r = re[c][i] + cs[tb + i] * w;
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
    const T* prow = pw + t * pw_stride;
    T acc = T(0);
    for (int f = 0; f < n_freq; ++f) acc = fma_(prow[f], __ldg(fb + f * n_mels + j), acc);
    out[(static_cast<long>(b) * n_frames + t0 + t) * n_mels + j] = static_cast<float>(acc);
  }
}

size_t smem_bytes(int n_fft, int f_pad, int tile_t, int t_bytes) {
  return static_cast<size_t>(t_bytes) * (static_cast<size_t>(n_fft / 2) * tile_t * 2 + tile_t +
                                         static_cast<size_t>(tile_t) * (f_pad + 1));
}

template <typename T, int kTileT>
int launch(const float* y, int batch, int n, int n_frames, int n_fft, int hop, const T* A, const T* Bm,
           const T* wr, int n_freq, int f_pad, const T* fb, int n_mels, float* out, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static std::mutex lock;
  static int smem_set[kMaxDevices] = {};  // per device: the limit set so far
  const int smem = static_cast<int>(smem_bytes(n_fft, f_pad, kTileT, sizeof(T)));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  {
    std::lock_guard<std::mutex> guard(lock);
    if (smem > smem_set[dev]) {
      err = cudaFuncSetAttribute(mel_folded_kernel<T, kTileT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set[dev] = smem;
    }
  }
  const dim3 grid((n_frames + kTileT - 1) / kTileT, batch);
  mel_folded_kernel<T, kTileT><<<grid, kThreads, smem, stream>>>(
      y, n, n_frames, n_fft, hop, A, Bm, wr, n_freq, f_pad, fb, n_mels, out);
  return static_cast<int>(cudaGetLastError());
}

// Launches the instantiation of tile_t frames a block in type T, or returns
// cudaErrorInvalidValue for another tile_t.
template <typename T>
int dispatch(const float* y, int batch, int n, int n_frames, int n_fft, int hop, int tile_t, const T* A,
             const T* Bm, const T* wr, int n_freq, int f_pad, const T* fb, int n_mels, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_t) {
    case 32: return launch<T, 32>(y, batch, n, n_frames, n_fft, hop, A, Bm, wr, n_freq, f_pad, fb, n_mels, out, s);
    case 16: return launch<T, 16>(y, batch, n, n_frames, n_fft, hop, A, Bm, wr, n_freq, f_pad, fb, n_mels, out, s);
    case 8: return launch<T, 8>(y, batch, n, n_frames, n_fft, hop, A, Bm, wr, n_freq, f_pad, fb, n_mels, out, s);
    case 4: return launch<T, 4>(y, batch, n, n_frames, n_fft, hop, A, Bm, wr, n_freq, f_pad, fb, n_mels, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at tile_t frames a block, in bytes
// (t_bytes 4: the float32 instantiation, 8: the float64 one).
size_t mel_folded_smem_bytes(int n_fft, int f_pad, int tile_t, int t_bytes) {
  return smem_bytes(n_fft, f_pad, tile_t, t_bytes);
}

// Launches the kernel at tile_t (32, 16, 8 or 4) frames a block on `stream`
// (on the current device); returns cudaGetLastError() (0 on success). The
// kernel's dynamic shared-memory limit is raised once per device and
// instantiation, on its first launch there, and again only if a larger
// n_fft needs more.
int mel_folded_launch(const float* y, int batch, int n, int n_frames, int n_fft, int hop, int tile_t,
                      const float* A, const float* Bm, const float* wr, int n_freq, int f_pad,
                      const float* fb, int n_mels, float* out, void* stream) {
  return dispatch<float>(y, batch, n, n_frames, n_fft, hop, tile_t, A, Bm, wr, n_freq, f_pad, fb, n_mels, out,
                         stream);
}

// The same launch on the float64 instantiation, with float64 tables.
int mel_folded_launch_f64(const float* y, int batch, int n, int n_frames, int n_fft, int hop, int tile_t,
                          const double* A, const double* Bm, const double* wr, int n_freq, int f_pad,
                          const double* fb, int n_mels, float* out, void* stream) {
  return dispatch<double>(y, batch, n, n_frames, n_fft, hop, tile_t, A, Bm, wr, n_freq, f_pad, fb, n_mels, out,
                          stream);
}

}  // extern "C"
