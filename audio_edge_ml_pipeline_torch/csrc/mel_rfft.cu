// Mel-power spectrogram through a real FFT, fused in one kernel for Hopper (sm_90a).
//
// Replaces both TPU kernels of audio_edge_ml_pipeline_tpu/ops/pallas_mel.py,
// which compute the same function: _mel_folded_kernel (launched by
// mel_power_pallas_folded; wrapper ops/mel_kernel.py::mel_power_folded) and
// _mel_kernel (launched by mel_power_pallas; wrapper
// ops/mel_unfolded.py::mel_power_unfolded), for n_fft in {256, 320, 400,
// 480, 512, 640, 1024, 2048}. Each wrapper sends every other even n_fft to its dense
// kernel, csrc/mel_folded.cu or csrc/mel_unfolded.cu. For each frame t of a
// clip x, center-padded with N/2 zeros on each side (N = n_fft), start =
// t * hop, window w (Hann):
//
//   xw[i]  = x[start + i] w[i]                        (i = 0 .. N-1)
//   z[m]   = xw[2m] + i xw[2m+1]                      (m = 0 .. M-1, M = N/2)
//   Z      = FFT_M(z)                                 three or four Stockham passes
//   E = (Z[k] + conj Z[M-k]) / 2,  O = (Z[k] - conj Z[M-k]) / 2i
//   X[k] = E + W^k O,  X[M-k] = conj(E - W^k O)       (k = 0 .. M/2, W = e^{-2 pi i/N})
//   out[t][j] = sum over f in [lo_j, lo_j + len_j) of |X[f]|^2 fb_j[f]
//
// The passes' radices are 8 4 4, 8 4 5, 8 5 5, 4 4 3 5, 8 8 4, 8 8 5, 8 8 8
// and 8 8 4 4 at M = 128, 160, 200, 240, 256, 320, 512 and 1024
// (rfft_plan.RADICES). The window, the
// pass twiddles, the split twiddles W^k, the mel bank's nonzero bands and
// their lane schedule come as tables from ops/rfft_plan.py, built in float64
// with the angles that are multiples of pi/2 exact, so DC and Nyquist come
// out with an imaginary part of exactly 0. rfft_plan.py also holds a torch
// emulation of this kernel's framing, passes, butterflies, scratch
// addressing, split and chunk sums, which the CPU tests check against float64
// np.fft.rfft.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the
// tensor cores, 700 W). At 512 five-second clips (hop 160, 40 mels) the
// function reads 164 MB of waveform and writes 41 MB of mel power: 205 MB,
// 0.061 ms, whatever n_fft. Its least operations, a real FFT at 2.5 N log2 N
// FLOP, the window, the power and the mel product over the bank's nonzeros
// (490 at n_fft 512, 383 at 400), are 3.5e9 FLOP, 0.053 ms, at n_fft 512 and
// 2.7e9 FLOP, 0.040 ms, at 400: the function is bound by bytes up to n_fft
// 512 (at 640 the operations take 0.068 ms). The dense folded DFT of
// csrc/mel_folded.cu needs 6.8e10 FLOP, 1.018 ms at the float32 peak, at
// n_fft 512 (0.624 ms at 400); this formulation does about 20 times fewer
// operations, so it can get under that. All products are plain float32
// FMAs: once the FFT has removed the dense DFT, the tensor cores have
// nothing large to multiply, and TF32 misses the 1e-5 feature gate.
//
// Design. A persistent grid: each block loads the window, the mel weights
// and their schedule into shared memory and its lanes' twiddles into
// registers once, then walks (clip, tile) pairs of tile_t consecutive
// frames (32, or fewer where a long hop's span would not fit; the wrapper
// picks it). For each tile it copies the contiguous span of the padded clip,
// (tile_t - 1) hop + N samples, into shared memory once with cp.async (zeros
// outside [0, n), which is the center padding, so no index is clamped). The
// copies are 4 bytes a thread, coalesced: a tile's span starts at any sample
// offset, and with every frame cut the spans and tables alone take within
// 2 % of the bound, so 16-byte copies would have little to gain. Each
// warp then takes one frame at a time. The first pass reads its inputs
// straight from the span times the window; every pass does its
// butterflies in registers and exchanges through a per-warp shared-memory
// scratch (re and im apart, five floats of padding every 32 so the strided
// writes spread over the banks), with __syncwarp between reads and writes.
// Lane l takes butterflies l, l + 32, ...: where M / R is not a multiple of
// 32, lanes idle (at M = 200, 7 of 32 in the first pass's 25 butterflies,
// and 24 in the second round of each radix-5 pass's 40). The split reads
// Z[k] and Z[M-k] and writes the power of both bins back into the scratch.
// The mel product then sums each filter's nonzero band only: the bands are
// cut into chunks spread evenly over the lanes (rfft_plan.mel_schedule; at
// 512 / 40 mels no lane walks more than 17 bins, where one filter a lane
// walked 41), each chunk is summed in ascending bin order into its own slot,
// and each filter adds its slots in ascending order and is written to the
// (B, T, n_mels) output time-major. Frames past T are not computed.
//
// Bank wavefronts of one scratch array and frame (the passes' exchanges and
// the split's reads, counted by tests/test_torch_mel_rfft.py): 62 for 50
// warp accesses at n_fft 512 (78 with one float of padding, 130 with none),
// 73 for 56 at n_fft 400, which no padding of 1-8 floats every 8, 16, 32 or
// 64 values brings lower.
//
// Measured on an H100 80GB HBM3 at 700 W (scripts/torch_mel_rfft_variants.py,
// 512 five-second clips). At n_fft 512: 0.44 ms, 7x the bound, 20x faster
// than either dense kernel. Shared-memory traffic and instruction throughput
// bound it, not device memory: the tile spans and tables alone take 0.063
// ms, the mel sums 0.15 ms and the second and third passes 0.11 ms. One
// filter a lane costs 10 % more, one float of padding 7 %, __ldg span loads
// 3 %. At n_fft 400: 0.456 ms, 7.4x the bound; the mel sums take 0.134 ms
// and the two radix-5 passes 0.165 ms, one float of padding costs nothing
// (the same 73 wavefronts), __ldg span loads 8 %, one filter a lane 10 %.
// ptxas (float32): 80 registers at n_fft 512 (64 at 256, 80 at 320, 118 at
// 400, 164 at 480, 128 at 640 and 2048, 180 at 1024), no spills; 47,560
// bytes of shared memory a block at n_fft 512, hop 160 and 40 mels (42,332
// at 400), so registers allow 3 blocks an SM at 512 and 2 at 400.
//
// Float64. Every stage above rounds in float32, which leaves a bin error of
// about 1e-7 of the frame's loudest bin: a bin 60 dB under it comes out
// 2.5e-5 off (relative power). The mel spectrogram (ref = max, min-max to
// [0, 1]) does not see that, but the MFCC does: power_to_db at ref = 1 keeps
// every bin down to 80 dB under the clip's peak, the DCT mixes them and the
// z-score divides by each coefficient's spread over time, which put the
// MFCC sequence of fsc22-like 5 s clips at 22.05 kHz 1.38e-5 from float64
// against a gate of 1e-5. So the kernel has a second instantiation, T =
// double, that takes the same steps on float64 tables (window, twiddles,
// split, mel weights): the window product, the passes, the split, the power
// and the mel sums run in float64, the waveform comes in and the mel power
// goes out as float32. Its twiddles are read through the L1 cache at each
// use instead of held in registers, which would spill at n_fft 1024.
//
// n_fft 480 and 2048 (four passes). M = 240 = 4 4 3 5 and M = 1024 =
// 8 8 4 4 take a fourth pass; radix 3 is a butterfly of its own (rfft_plan
// ._dft3). At M = 1024 a lane's twiddles of the three exchanging passes
// would take 192 registers in float32 and its split twiddles 34, so there
// both are read through L1 in either type, as the float64 instantiation
// reads them everywhere. The float64 instantiation at M = 1024 runs 4 warps
// a block, not 8: each warp's scratch holds 2 x 1179 doubles, and at n_fft
// 2048, hop 512 and 128 mels 8 warps would need 266,896 bytes of shared
// memory against 232,448 (4 warps: 187,344).

#include <cuda_runtime.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int kTileT = 32;          // frames per tile at most (the wrapper passes tile_t <= kTileT)
// The butterflies' constants, each rounded to float32 once (rfft_plan.SQRT_HALF, COS1, SIN1, COS2, SIN2).
constexpr float kSqrtHalf = 0.70710678118654752440f;  // radix 8
constexpr float kCos1 = 0.30901699437494742410f;      // radix 5: cos and sin of 2 pi/5 ...
constexpr float kSin1 = 0.95105651629515357212f;
constexpr float kCos2 = -0.80901699437494742410f;     // ... and of 4 pi/5
constexpr float kSin2 = 0.58778525229247312917f;
constexpr float kSin3 = 0.86602540378443864676f;      // radix 3: sin of pi/3

__host__ __device__ constexpr int pad_index(int i) { return i + 5 * (i >> 5); }  // rfft_plan.pad_index
__host__ __device__ constexpr int scratch_floats(int M) { return pad_index(M - 1) + 1; }

__host__ __device__ constexpr int plan(int s, int r0, int r1, int r2, int r3 = 0) {
  return s == 0 ? r0 : s == 1 ? r1 : s == 2 ? r2 : s == 3 ? r3 : 0;
}

// Radices of the M-point complex FFT, in pass order, 0 past the last pass (rfft_plan.RADICES, n_fft = 2 M).
template <int M>
__host__ __device__ constexpr int radix(int s) {
  static_assert(M == 128 || M == 160 || M == 200 || M == 240 || M == 256 || M == 320 || M == 512 || M == 1024,
                "n_fft must be 256, 320, 400, 480, 512, 640, 1024 or 2048");
  switch (M) {
    case 128: return plan(s, 8, 4, 4);
    case 160: return plan(s, 8, 4, 5);
    case 200: return plan(s, 8, 5, 5);
    case 240: return plan(s, 4, 4, 3, 5);
    case 256: return plan(s, 8, 8, 4);
    case 320: return plan(s, 8, 8, 5);
    case 512: return plan(s, 8, 8, 8);
    case 1024: return plan(s, 8, 8, 4, 4);
    default: return 0;
  }
}
template <int M>
__host__ __device__ constexpr int passes() { return radix<M>(3) ? 4 : 3; }

// Warps a block: 4 for the float64 instantiation at M = 1024 (shared memory), else 8.
__host__ __device__ constexpr int warps_for(int M, int t_bytes) { return t_bytes == 8 && M >= 1024 ? 4 : 8; }

// Product of the radices before pass s.
template <int M>
__host__ __device__ constexpr int stride_before(int s) {
  return s == 0 ? 1 : stride_before<M>(s - 1) * radix<M>(s - 1);
}

// The same constants for T = double, exact to float64.
constexpr double kSqrtHalf64 = 0.70710678118654752440;
constexpr double kCos1_64 = 0.30901699437494742410;
constexpr double kSin1_64 = 0.95105651629515357212;
constexpr double kCos2_64 = -0.80901699437494742410;
constexpr double kSin2_64 = 0.58778525229247312917;
constexpr double kSin3_64 = 0.86602540378443864676;

// T's complex type and constants.
template <typename T> struct Real;
template <> struct Real<float> {
  using C = float2;
  static constexpr float sqrt_half = kSqrtHalf, cos1 = kCos1, sin1 = kSin1, cos2 = kCos2, sin2 = kSin2,
                         sin3 = kSin3;
};
template <> struct Real<double> {
  using C = double2;
  static constexpr double sqrt_half = kSqrtHalf64, cos1 = kCos1_64, sin1 = kSin1_64, cos2 = kCos2_64,
                          sin2 = kSin2_64, sin3 = kSin3_64;
};

__device__ __forceinline__ float2 cplx(float x, float y) { return make_float2(x, y); }
__device__ __forceinline__ double2 cplx(double x, double y) { return make_double2(x, y); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

template <typename C> __device__ __forceinline__ C add(C a, C b) { return cplx(a.x + b.x, a.y + b.y); }
template <typename C> __device__ __forceinline__ C sub(C a, C b) { return cplx(a.x - b.x, a.y - b.y); }
template <typename C> __device__ __forceinline__ C cmul(C a, C b) {
  return cplx(fma_(a.x, b.x, -(a.y * b.y)), fma_(a.x, b.y, a.y * b.x));
}

template <typename C>
__device__ __forceinline__ void dft4(C& a0, C& a1, C& a2, C& a3) {
  const C t0 = add(a0, a2), t1 = sub(a0, a2), t2 = add(a1, a3);
  const C t3 = cplx(a1.y - a3.y, a3.x - a1.x);  // -i (a1 - a3)
  a0 = add(t0, t2);
  a1 = add(t1, t3);
  a2 = sub(t0, t2);
  a3 = sub(t1, t3);
}

// In place, natural order out: v[k] = sum_r v[r] e^{-2 pi i r k / R}.
template <int R, typename T>
struct Dft;

// With t = v1 + v2, d = v1 - v2, m = v0 - t/2 and s the sin of pi/3:
// v0 = v0 + t, v1, v2 = m -+ i s d (rfft_plan._dft3).
template <typename T>
struct Dft<3, T> {
  using C = typename Real<T>::C;
  __device__ __forceinline__ static void run(C (&v)[3]) {
    constexpr T s = Real<T>::sin3;
    const C t = add(v[1], v[2]), d = sub(v[1], v[2]);
    const C m = cplx(v[0].x - T(0.5) * t.x, v[0].y - T(0.5) * t.y);
    v[0] = add(v[0], t);
    v[1] = cplx(m.x + s * d.y, m.y - s * d.x);  // m - i s d
    v[2] = cplx(m.x - s * d.y, m.y + s * d.x);  // m + i s d
  }
};

template <typename T>
struct Dft<4, T> {
  using C = typename Real<T>::C;
  __device__ __forceinline__ static void run(C (&v)[4]) { dft4(v[0], v[1], v[2], v[3]); }
};

// With t1 = v1 + v4, t2 = v2 + v3, t3 = v1 - v4, t4 = v2 - v3: v0 = v0 + (t1 + t2),
// v1, v4 = a1 -+ i b1 and v2, v3 = a2 -+ i b2, where a1 = v0 + c1 t1 + c2 t2,
// a2 = v0 + c2 t1 + c1 t2, b1 = s1 t3 + s2 t4, b2 = s2 t3 - s1 t4 (rfft_plan._dft5).
template <typename T>
struct Dft<5, T> {
  using C = typename Real<T>::C;
  __device__ __forceinline__ static void run(C (&v)[5]) {
    constexpr T c1 = Real<T>::cos1, s1 = Real<T>::sin1, c2 = Real<T>::cos2, s2 = Real<T>::sin2;
    const C t1 = add(v[1], v[4]), t2 = add(v[2], v[3]), t3 = sub(v[1], v[4]), t4 = sub(v[2], v[3]);
    const C a1 = cplx(v[0].x + c1 * t1.x + c2 * t2.x, v[0].y + c1 * t1.y + c2 * t2.y);
    const C a2 = cplx(v[0].x + c2 * t1.x + c1 * t2.x, v[0].y + c2 * t1.y + c1 * t2.y);
    const C b1 = cplx(s1 * t3.x + s2 * t4.x, s1 * t3.y + s2 * t4.y);
    const C b2 = cplx(s2 * t3.x - s1 * t4.x, s2 * t3.y - s1 * t4.y);
    v[0] = add(v[0], add(t1, t2));
    v[1] = cplx(a1.x + b1.y, a1.y - b1.x);  // a1 - i b1
    v[2] = cplx(a2.x + b2.y, a2.y - b2.x);
    v[3] = cplx(a2.x - b2.y, a2.y + b2.x);  // a2 + i b2
    v[4] = cplx(a1.x - b1.y, a1.y + b1.x);
  }
};

template <typename T>
struct Dft<8, T> {
  using C = typename Real<T>::C;
  __device__ __forceinline__ static void run(C (&v)[8]) {
    constexpr T h = Real<T>::sqrt_half;
    C e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
    C o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
    dft4(e0, e1, e2, e3);
    dft4(o0, o1, o2, o3);
    o1 = cplx((o1.x + o1.y) * h, (o1.y - o1.x) * h);     // e^{-i pi/4} o1
    o2 = cplx(o2.y, -o2.x);                               // -i o2
    o3 = cplx((o3.y - o3.x) * h, -(o3.x + o3.y) * h);    // e^{-3i pi/4} o3
    v[0] = add(e0, o0); v[4] = sub(e0, o0);
    v[1] = add(e1, o1); v[5] = sub(e1, o1);
    v[2] = add(e2, o2); v[6] = sub(e2, o2);
    v[3] = add(e3, o3); v[7] = sub(e3, o3);
  }
};

// Pass S of the Stockham FFT: butterfly j (lane + 32 b) reads z[j + r M/R],
// twiddles input r by e^{-2 pi i r (j % Ns) / (Ns R)}, and writes its
// outputs to (j / Ns) Ns R + j % Ns + r Ns (rfft_plan.pass_indices). In
// float32 up to M = 512 a lane holds its twiddles in registers; in float64,
// and at M = 1024, it reads them at each use (kHeld).
template <int M, int S, typename T>
struct Pass {
  using C = typename Real<T>::C;
  static constexpr int R = radix<M>(S);
  static constexpr int Ns = stride_before<M>(S);
  static constexpr int NB = M / R;               // butterflies
  static constexpr int BPL = (NB + 31) / 32;     // butterflies a lane
  static constexpr bool kHeld = sizeof(T) == 4 && M <= 512;
  C tw[kHeld ? BPL : 1][R];
  const C* __restrict__ table;

  __device__ __forceinline__ void load(const C* __restrict__ twiddles, int lane) {
    table = twiddles + S * M;
    if constexpr (kHeld) {
#pragma unroll
      for (int b = 0; b < BPL; ++b) {
        const int j = lane + 32 * b;
#pragma unroll
        for (int r = 1; r < R; ++r) tw[b][r] = j < NB ? __ldg(table + j * R + r) : cplx(T(1), T(0));
      }
    }
  }

  // Butterflies and the write of v; the caller has read v (with twiddles applied).
  __device__ __forceinline__ static void finish(C (&v)[BPL][R], T* re, T* im, int lane) {
#pragma unroll
    for (int b = 0; b < BPL; ++b) {
      const int j = lane + 32 * b;
      if (j < NB) {
        Dft<R, T>::run(v[b]);
        const int d = (j / Ns) * Ns * R + j % Ns;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = pad_index(d + r * Ns);
          re[i] = v[b][r].x;
          im[i] = v[b][r].y;
        }
      }
    }
    __syncwarp();
  }

  // Passes after the first: in place on the scratch.
  __device__ __forceinline__ void run(T* re, T* im, int lane) const {
    C v[BPL][R];
#pragma unroll
    for (int b = 0; b < BPL; ++b) {
      const int j = lane + 32 * b;
      if (j < NB) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = pad_index(j + r * NB);
          v[b][r] = cplx(re[i], im[i]);
        }
      }
    }
    __syncwarp();  // every lane has read before any lane writes
#pragma unroll
    for (int b = 0; b < BPL; ++b) {
      const int j = lane + 32 * b;
#pragma unroll
      for (int r = 1; r < R; ++r) {
        if constexpr (kHeld) {
          v[b][r] = cmul(v[b][r], tw[b][r]);
        } else if (j < NB) {
          v[b][r] = cmul(v[b][r], __ldg(table + j * R + r));
        }
      }
    }
    finish(v, re, im, lane);
  }

  // The first pass (Ns = 1, no twiddles) reads z from the frame and the window.
  __device__ __forceinline__ static void first(const float* x, const C* win2, T* re, T* im, int lane) {
    static_assert(S == 0, "only pass 0 reads the frame");
    C v[BPL][R];
#pragma unroll
    for (int b = 0; b < BPL; ++b) {
      const int j = lane + 32 * b;
      if (j < NB) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int m = j + r * NB;
          const C w = win2[m];
          v[b][r] = cplx(x[2 * m] * w.x, x[2 * m + 1] * w.y);
        }
      }
    }
    finish(v, re, im, lane);
  }
};

// The fourth pass of a three-pass plan: nothing.
struct NoPass {
  template <typename C>
  __device__ __forceinline__ void load(const C*, int) {}
  template <typename T>
  __device__ __forceinline__ void run(T*, T*, int) const {}
};

// Asynchronous 4-byte copy to shared memory (zero-filled where !valid) and its waits.
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void copy_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Starts the copy of one tile's span of the center-padded clip into xs:
// clip samples first .. first + span - 1, zeros outside [0, n).
template <int kThreads>
__device__ __forceinline__ void load_span(float* xs, const float* row, int n, long first, int span) {
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long j = first + i;
    const bool inside = j >= 0 && j < n;
    copy_async(xs + i, inside ? row + j : row, inside);
  }
  copy_async_commit();
}

template <int M, typename T, int W = warps_for(M, sizeof(T))>
__global__ void __launch_bounds__(32 * W)
mel_rfft_kernel(const float* __restrict__ y, int batch, int n, int n_frames, int hop, int tile_t,
                const T* __restrict__ window, const typename Real<T>::C* __restrict__ twiddles,
                const typename Real<T>::C* __restrict__ split, const T* __restrict__ weights, int n_weights,
                const int4* __restrict__ chunks, int n_rounds, const int2* __restrict__ slots, int n_mels,
                int n_slots, float* __restrict__ out) {
  using C = typename Real<T>::C;
  constexpr int N = 2 * M;
  constexpr int KS = (M / 2 + 1 + 31) / 32;   // split bins k = lane + 32 i, k <= M/2
  constexpr bool kHeldSplit = M <= 512;       // split twiddles in registers (else read through L1)
  static_assert(stride_before<M>(passes<M>()) == M, "the passes cover M");
  // Shared memory, each region aligned for its widest load (smem_bytes):
  extern __shared__ __align__(16) float smem[];
  const int span = (tile_t - 1) * hop + N;
  float* xs = smem;                                                      // [span], padded to 4
  int4* chunk = reinterpret_cast<int4*>(xs + ((span + 3) & ~3));         // [n_rounds][32]
  T* win = reinterpret_cast<T*>(chunk + 32 * n_rounds);                  // [N]
  int2* slot = reinterpret_cast<int2*>(win + N);                         // [n_mels]
  T* scratch = reinterpret_cast<T*>(slot + n_mels);                      // [W][2][scratch_floats(M)]
  T* parts = scratch + W * 2 * scratch_floats(M);                        // [W][n_slots]
  T* wt = parts + W * n_slots;                                           // [n_weights]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* re = scratch + warp * 2 * scratch_floats(M);
  T* im = re + scratch_floats(M);
  T* part = parts + warp * n_slots;
  const C* win2 = reinterpret_cast<const C*>(win);

  constexpr int kThreads = 32 * W;
  for (int i = threadIdx.x; i < N; i += kThreads) win[i] = __ldg(window + i);
  for (int i = threadIdx.x; i < 32 * n_rounds; i += kThreads) chunk[i] = __ldg(chunks + i);
  for (int i = threadIdx.x; i < n_mels; i += kThreads) slot[i] = __ldg(slots + i);
  for (int i = threadIdx.x; i < n_weights; i += kThreads) wt[i] = __ldg(weights + i);
  Pass<M, 1, T> p1;
  Pass<M, 2, T> p2;
  std::conditional_t<passes<M>() == 4, Pass<M, 3, T>, NoPass> p3;
  p1.load(twiddles, lane);
  p2.load(twiddles, lane);
  p3.load(twiddles, lane);
  C sw[kHeldSplit ? KS : 1];
  if constexpr (kHeldSplit) {
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int k = lane + 32 * i;
      sw[i] = k <= M / 2 ? __ldg(split + k) : cplx(T(1), T(0));
    }
  }

  const int tiles_per_clip = (n_frames + tile_t - 1) / tile_t;
  const long n_tiles = static_cast<long>(batch) * tiles_per_clip;
  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = static_cast<int>(tile / tiles_per_clip);
    const int t0 = static_cast<int>(tile - static_cast<long>(b) * tiles_per_clip) * tile_t;
    __syncthreads();  // the previous tile is done with xs
    load_span<kThreads>(xs, y + static_cast<long>(b) * n, n, static_cast<long>(t0) * hop - M, span);
    copy_async_wait();
    __syncthreads();  // this tile's span and the tables are in

    for (int f = warp; f < tile_t; f += W) {
      const int t = t0 + f;
      if (t >= n_frames) break;  // warp-uniform: frames past T are not computed

      Pass<M, 0, T>::first(xs + f * hop, win2, re, im, lane);
      p1.run(re, im, lane);
      p2.run(re, im, lane);
      p3.run(re, im, lane);

      // Real split: power of bins k and M - k from Z[k] and Z[M - k].
      T pk[KS], pm[KS];
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const int k = lane + 32 * i;
        if (k <= M / 2) {
          const int ia = pad_index(k), ib = pad_index((M - k) % M);
          const C a = cplx(re[ia], im[ia]);
          const C c = cplx(re[ib], im[ib]);
          const C e = cplx((a.x + c.x) * T(0.5), (a.y - c.y) * T(0.5));
          const C o = cplx((a.y + c.y) * T(0.5), (c.x - a.x) * T(0.5));
          C w;
          if constexpr (kHeldSplit) {
            w = sw[i];
          } else {
            w = __ldg(split + k);
          }
          const C wo = cmul(o, w);
          const C x1 = add(e, wo), x2 = sub(e, wo);
          pk[i] = fma_(x1.x, x1.x, x1.y * x1.y);
          pm[i] = fma_(x2.x, x2.x, x2.y * x2.y);
        }
      }
      __syncwarp();
      T* pw = re;  // power of bins 0 .. M, unpadded
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const int k = lane + 32 * i;
        if (k <= M / 2) {
          pw[k] = pk[i];
          if (k != M / 2) pw[M - k] = pm[i];
        }
      }
      __syncwarp();

      // Mel product over the bands' chunks (first bin, length, weight
      // offset, slot), ascending bins, then each filter's slots in order.
      for (int q = 0; q < n_rounds; ++q) {
        const int4 c = chunk[32 * q + lane];
        if (c.w >= 0) {
          T acc = T(0);
          for (int i = 0; i < c.y; ++i) acc = fma_(pw[c.x + i], wt[c.z + i], acc);
          part[c.w] = acc;
        }
      }
      __syncwarp();
      float* orow = out + (static_cast<long>(b) * n_frames + t) * n_mels;
      for (int j = lane; j < n_mels; j += 32) {
        const int2 sj = slot[j];
        T acc = part[sj.x];
        for (int c = 1; c < sj.y; ++c) acc += part[sj.x + c];
        orow[j] = static_cast<float>(acc);
      }
      __syncwarp();  // the next frame overwrites the power and the partial sums
    }
  }
}

// The span, chunks and slots take 4-byte words; the window, scratch, partial sums and weights T.
size_t smem_bytes(int n_fft, int hop, int n_mels, int n_weights, int n_rounds, int n_slots, int tile_t,
                  int t_bytes) {
  const size_t span = static_cast<size_t>(tile_t - 1) * hop + n_fft;
  const size_t warps = warps_for(n_fft / 2, t_bytes);
  return sizeof(float) * (((span + 3) & ~static_cast<size_t>(3)) + 4 * 32 * static_cast<size_t>(n_rounds) +
                          2 * static_cast<size_t>(n_mels)) +
         t_bytes * (n_fft + warps * (2 * scratch_floats(n_fft / 2) + n_slots) + n_weights);
}

constexpr int kMaxDevices = 64;

template <int M, typename T = float>
int launch(const float* y, int batch, int n, int n_frames, int hop, int tile_t, const T* window, const T* twiddles,
           const T* split, const T* weights, int n_weights, const int* chunks, int n_rounds,
           const int* slots, int n_mels, int n_slots, float* out, cudaStream_t stream) {
  using C = typename Real<T>::C;
  constexpr int kThreads = 32 * warps_for(M, sizeof(T));
  static std::mutex lock;
  static int smem_set[kMaxDevices] = {};  // per device: the limit set so far
  if (tile_t < 1 || tile_t > kTileT) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(smem_bytes(2 * M, hop, n_mels, n_weights, n_rounds, n_slots, tile_t, sizeof(T)));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  {
    std::lock_guard<std::mutex> guard(lock);
    if (smem > smem_set[dev]) {
      err = cudaFuncSetAttribute(mel_rfft_kernel<M, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set[dev] = smem;
    }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mel_rfft_kernel<M, T>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long n_tiles = static_cast<long>(batch) * ((n_frames + tile_t - 1) / tile_t);
  const int grid = static_cast<int>(n_tiles < static_cast<long>(sms) * per_sm ? n_tiles : static_cast<long>(sms) * per_sm);
  mel_rfft_kernel<M, T><<<grid, kThreads, smem, stream>>>(
      y, batch, n, n_frames, hop, tile_t, window, reinterpret_cast<const C*>(twiddles),
      reinterpret_cast<const C*>(split), weights, n_weights, reinterpret_cast<const int4*>(chunks), n_rounds,
      reinterpret_cast<const int2*>(slots), n_mels, n_slots, out);
  return static_cast<int>(cudaGetLastError());
}

// Launches the instantiation of M = n_fft / 2 in type T, or returns
// cudaErrorInvalidValue for an n_fft with no plan.
template <typename T>
int dispatch(const float* y, int batch, int n, int n_frames, int n_fft, int hop, int tile_t, const T* window,
             const T* twiddles, const T* split, const T* weights, int n_weights, const int* chunks, int n_rounds,
             const int* slots, int n_mels, int n_slots, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MEL_RFFT_ARGS y, batch, n, n_frames, hop, tile_t, window, twiddles, split, weights, n_weights, chunks, \
                      n_rounds, slots, n_mels, n_slots, out, s
  switch (n_fft) {
    case 256: return launch<128, T>(MEL_RFFT_ARGS);
    case 320: return launch<160, T>(MEL_RFFT_ARGS);
    case 400: return launch<200, T>(MEL_RFFT_ARGS);
    case 480: return launch<240, T>(MEL_RFFT_ARGS);
    case 512: return launch<256, T>(MEL_RFFT_ARGS);
    case 640: return launch<320, T>(MEL_RFFT_ARGS);
    case 1024: return launch<512, T>(MEL_RFFT_ARGS);
    case 2048: return launch<1024, T>(MEL_RFFT_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MEL_RFFT_ARGS
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at tile_t frames a tile, in bytes
// (float32 and float64 instantiations).
size_t mel_rfft_smem_bytes(int n_fft, int hop, int n_mels, int n_weights, int n_rounds, int n_slots, int tile_t) {
  return smem_bytes(n_fft, hop, n_mels, n_weights, n_rounds, n_slots, tile_t, sizeof(float));
}
size_t mel_rfft_smem_bytes_f64(int n_fft, int hop, int n_mels, int n_weights, int n_rounds, int n_slots,
                               int tile_t) {
  return smem_bytes(n_fft, hop, n_mels, n_weights, n_rounds, n_slots, tile_t, sizeof(double));
}

// Launches the kernel for n_fft in {256, 320, 400, 480, 512, 640, 1024, 2048}
// on `stream` (on the current device), tile_t (1 .. 32) frames a tile;
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// another n_fft or tile_t. The tables are rfft_plan.tables(): window (N,),
// twiddles (passes, M, 2), split (M/2 + 1, 2), weights (n_weights,), chunks
// (n_rounds, 32, 4) int32, slots (n_mels, 2) int32, whose counts add up to
// n_slots.
int mel_rfft_launch(const float* y, int batch, int n, int n_frames, int n_fft, int hop, int tile_t,
                    const float* window, const float* twiddles, const float* split, const float* weights,
                    int n_weights, const int* chunks, int n_rounds, const int* slots, int n_mels, int n_slots,
                    float* out, void* stream) {
  return dispatch<float>(y, batch, n, n_frames, n_fft, hop, tile_t, window, twiddles, split, weights, n_weights,
                         chunks, n_rounds, slots, n_mels, n_slots, out, stream);
}

// The same launch on the float64 instantiation, with rfft_plan.tables64()'s
// window, twiddles, split and weights (float64; chunks and slots as above).
int mel_rfft_launch_f64(const float* y, int batch, int n, int n_frames, int n_fft, int hop, int tile_t,
                        const double* window, const double* twiddles, const double* split, const double* weights,
                        int n_weights, const int* chunks, int n_rounds, const int* slots, int n_mels, int n_slots,
                        float* out, void* stream) {
  return dispatch<double>(y, batch, n, n_frames, n_fft, hop, tile_t, window, twiddles, split, weights, n_weights,
                          chunks, n_rounds, slots, n_mels, n_slots, out, stream);
}

}  // extern "C"
