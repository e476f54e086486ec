// The mel feature's epilogue, dB at the clip's max and per-clip min-max, in one kernel for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this epilogue to XLA
// (audio_edge_ml_pipeline_tpu/ops/dsp.py), and the port ran it as some 75
// PyTorch launches a batch (ops/dsp.py::mel_epilogue, which stays as the
// plain version for CPU tensors). The wrapper is
// ops/mel_kernel.py::launch_epilogue, reached from mel_spec_feature. For
// each clip b of the (B, n_mels, T) float32 mel power S, with the frames
// t < valid = 1 + lengths[b] // hop counted (every frame without lengths):
//
//   L[i]  = 10 log10(max(S[i], 1e-10))          log10_precise's arithmetic
//   ref   = 10 log10(max(max S over counted, 1e-10))
//   peak  = max over counted of (L - ref),  floor = peak - 80
//   D[i]  = max(L[i] - ref, floor)
//   lo, hi = min, max of D over counted
//   out[i] = (D[i] - lo) / (hi - lo + 1e-8)     every frame, the padded ones too
//
// Every step is the float32 operation that ops/dsp.py's torch ops take, in
// their order, each rounded on its own (__f*_rn: no FMA contraction), so the
// output is that chain's bit for bit (on an H100 against PyTorch 2.11's
// CUDA kernels at B = 512, with and without lengths); a build that takes
// r2 / 13 as r2 * (1/13) may differ by an ulp. One pass reduces max S, max L and
// min L together. Rounding is monotone, so max(L - ref) = max(L) - ref, and
// max(x, floor) is monotone, so min D = max(min L - ref, floor) and max D =
// max(peak, floor): the same values as the four reductions of the chain,
// each taken in its order of definition, bit for bit, and nothing relies
// on the polynomial being monotone. The max and min pass NaN on, as
// torch.amax and torch.maximum do.
//
// What bounds it on an H100 SXM (3.35 TB/s): one read and one write of the
// clip from device memory, 8 n_mels T bytes a clip: 160,320 B at (40, 501),
// 12.3 us for 256 clips, 1.5 us for 32. Some 30 float32 operations an
// element are far below the operations' bound.
//
// Design. One block of 1024 threads a clip, the grid the batch. The block
// reads its clip twice, once for the reduction and once for the output,
// and computes L both times. The second read comes from L2 where the
// clips in flight fit there (two blocks a SM: 264 clips of 80 KB at (40,
// 501)), so device memory sees one read. 16-byte loads where n_mels T is a
// multiple of 4 and both pointers are 16-byte aligned, else 4-byte ones.
// The reduction is one warp shuffle tree, one barrier, and a second tree
// that every warp runs over the 32 warps' partials, so no second barrier.
// The layout of a clip is the caller's: frames-major (the mel kernels' (B,
// T, n_mels) seen through a transpose) or mels-major; the output has the
// input's strides, and only the test of whether element i is counted
// depends on it.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// ops/dsp.py's constants as float32: log10(2) in two floats, 1 / ln 10, the
// atanh series' 1/3 .. 1/11, sqrt(1/2)
constexpr float kLog10Hi = 0x1.344134p-2f;
constexpr float kLog10Lo = 0x1.09f7a0p-26f;
constexpr float kInvLn10 = 0x1.bcb7b2p-2f;
constexpr float kSqrtHalf = 0x1.6a09e6p-1f;
constexpr float kThird = 0x1.555556p-2f, kFifth = 0x1.99999ap-3f, kSeventh = 0x1.24924ap-3f;
constexpr float kNinth = 0x1.c71c72p-4f, kEleventh = 0x1.745d18p-4f;
constexpr float kAmin = 1e-10f, kTopDb = 80.0f, kEps = 1e-8f;

__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }

// 10 log10(max(x, 1e-10)): dsp.power_to_db's clamp_min and log10_precise.
__device__ __forceinline__ float db(float x) {
  x = x < kAmin ? kAmin : x;   // clamp_min passes NaN on
  int e;
  float m = frexpf(x, &e);
  if (m < kSqrtHalf) {
    m = __fmul_rn(m, 2.0f);
    e -= 1;
  }
  const float ef = static_cast<float>(e);
  const float r = __fdiv_rn(__fsub_rn(m, 1.0f), __fadd_rn(m, 1.0f));
  const float r2 = __fmul_rn(r, r);
  float p = __fadd_rn(kEleventh, __fdiv_rn(r2, 13.0f));
  p = __fadd_rn(kNinth, __fmul_rn(r2, p));
  p = __fadd_rn(kSeventh, __fmul_rn(r2, p));
  p = __fadd_rn(kFifth, __fmul_rn(r2, p));
  p = __fadd_rn(kThird, __fmul_rn(r2, p));
  p = __fadd_rn(1.0f, __fmul_rn(r2, p));
  const float ln_m = __fmul_rn(__fmul_rn(2.0f, r), p);
  const float lg = __fadd_rn(__fmul_rn(ef, kLog10Hi), __fadd_rn(__fmul_rn(ef, kLog10Lo), __fmul_rn(ln_m, kInvLn10)));
  return __fmul_rn(10.0f, lg);
}

template <int V>
__device__ __forceinline__ void load_global(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_global(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// (max, max, min) of the three partials over the warp, on every lane.
__device__ __forceinline__ void warp_reduce(float& s_max, float& l_max, float& l_min) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s_max = nan_max(s_max, __shfl_xor_sync(0xffffffffu, s_max, o));
    l_max = nan_max(l_max, __shfl_xor_sync(0xffffffffu, l_max, o));
    l_min = nan_min(l_min, __shfl_xor_sync(0xffffffffu, l_min, o));
  }
}

// One clip a block; V: floats a load (4 or 1).
template <int V>
__global__ void __launch_bounds__(kThreads, 2)
mel_epilogue_kernel(const float* __restrict__ mel, const long long* __restrict__ lengths, int n_mels, int n_frames,
                    int hop, int frames_major, float* __restrict__ out) {
  __shared__ float partial[3][kWarps];
  const int size = n_mels * n_frames;
  const long long base = static_cast<long long>(blockIdx.x) * size;
  const float* x = mel + base;
  float* y = out + base;

  int valid = n_frames;   // frames counted: 1 + lengths[b] // hop (floor division), within [0, T]
  if (lengths != nullptr) {
    const long long len = lengths[blockIdx.x];
    long long q = len / hop;
    if (len % hop != 0 && len < 0) --q;
    const long long v = 1 + q;
    valid = v < 0 ? 0 : (v < n_frames ? static_cast<int>(v) : n_frames);
  }
  const bool all_counted = valid == n_frames;
  const int prefix = valid * n_mels;   // frames-major: the counted elements are i < prefix
  auto counted = [&](int i) { return all_counted || (frames_major ? i < prefix : i % n_frames < valid); };

  const int chunks = size / V;
  float s_max = -FLT_MAX, l_max = -FLT_MAX, l_min = FLT_MAX;   // torch's fill for frames not counted
  for (int j = threadIdx.x; j < chunks; j += kThreads) {
    float v[V];
    load_global<V>(x + j * V, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (counted(j * V + k)) {
        const float d = db(v[k]);
        s_max = nan_max(s_max, v[k]);
        l_max = nan_max(l_max, d);
        l_min = nan_min(l_min, d);
      }
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  warp_reduce(s_max, l_max, l_min);
  if (lane == 0) {
    partial[0][warp] = s_max;
    partial[1][warp] = l_max;
    partial[2][warp] = l_min;
  }
  __syncthreads();
  s_max = lane < kWarps ? partial[0][lane] : -FLT_MAX;
  l_max = lane < kWarps ? partial[1][lane] : -FLT_MAX;
  l_min = lane < kWarps ? partial[2][lane] : FLT_MAX;
  warp_reduce(s_max, l_max, l_min);

  const float ref = db(s_max);
  const float peak = __fsub_rn(l_max, ref);
  const float floor_db = __fsub_rn(peak, kTopDb);
  const float lo = nan_max(__fsub_rn(l_min, ref), floor_db);
  const float hi = nan_max(peak, floor_db);
  const float denom = __fadd_rn(__fsub_rn(hi, lo), kEps);

  for (int j = threadIdx.x; j < chunks; j += kThreads) {
    float v[V], o[V];
    load_global<V>(x + j * V, v);
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = __fdiv_rn(__fsub_rn(nan_max(__fsub_rn(db(v[k]), ref), floor_db), lo), denom);
    store_global<V>(y + j * V, o);
  }
}

template <int V>
int launch(const float* mel, const long long* lengths, int batch, int n_mels, int n_frames, int hop, int frames_major,
           float* out, cudaStream_t stream) {
  mel_epilogue_kernel<V><<<batch, kThreads, 0, stream>>>(mel, lengths, n_mels, n_frames, hop, frames_major, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the epilogue on `stream` (on the current device) over `batch`
// clips of n_mels x n_frames float32 values each, clip b at mel + b n_mels
// n_frames, frames-major (element i of a clip is frame i / n_mels) or
// mels-major (frame i % n_frames); out in the same layout. lengths: batch
// int64 sample counts, or null to count every frame. Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for an empty
// shape, hop < 1 or n_mels n_frames of 2^31 or more.
int mel_epilogue_launch(const float* mel, const long long* lengths, int batch, int n_mels, int n_frames, int hop,
                        int frames_major, float* out, void* stream) {
  if (batch < 1 || n_mels < 1 || n_frames < 1 || hop < 1 || static_cast<long long>(n_mels) * n_frames > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (n_mels * n_frames) % 4 == 0 &&
                   ((reinterpret_cast<std::uintptr_t>(mel) | reinterpret_cast<std::uintptr_t>(out)) & 15) == 0;
  return vec ? launch<4>(mel, lengths, batch, n_mels, n_frames, hop, frames_major, out, s)
             : launch<1>(mel, lengths, batch, n_mels, n_frames, hop, frames_major, out, s);
}

}  // extern "C"
