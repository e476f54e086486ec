// Mel-power spectrogram through a chirp-z real FFT of run-time length, fused in one kernel for Hopper (sm_90a).
//
// Replaces both TPU kernels of audio_edge_ml_pipeline_tpu/ops/pallas_mel.py,
// which compute the same function, for every even n_fft that csrc/mel_rfft.cu
// has no plan for (482, 800, 882, 1102, 2050, 4096, ...):
// _mel_folded_kernel (launched by mel_power_pallas_folded; wrapper
// ops/mel_kernel.py::mel_power_folded, float32 and, with precise=True,
// float64) and _mel_kernel (launched by mel_power_pallas; wrapper
// ops/mel_unfolded.py::mel_power_unfolded, float32). It takes the place of the
// dense DFT kernels csrc/mel_folded.cu and csrc/mel_unfolded.cu on that
// route; those stay in the tree, reached only through their launch_dense.
// For each frame t of a clip x, center-padded with N/2 zeros on each side
// (N = n_fft), start = t * hop, window w (Hann):
//
//   xw[i] = x[start + i] w[i]                    (i = 0 .. N-1)
//   z[m]  = xw[2m] + i xw[2m+1]                  (m = 0 .. M-1, M = N/2)
//   Z     = DFT_M(z), one of two ways:
//     direct (M 5-smooth: 800, 1600, 960, 1200, 4096, 2 ...): an M-point FFT;
//     chirp-z (482, 882, 1102, 2050 ...): with w[m] = e^{-i pi m^2/M},
//       a[m] = z[m] w[m] zero-padded to P >= 2M - 1 (5-smooth),
//       F = FFT_P(conj(FFT_P(a) H / P)),  Z[k] = w[k] conj(F[k]),
//       H = FFT_P of the chirp filter conj(w[j]), j in (-M, M), wrapped to P
//   E = (Z[k] + conj Z[M-k]) / 2,  O = (Z[k] - conj Z[M-k]) / 2i
//   X[k] = E + W^k O,  X[M-k] = conj(E - W^k O)  (2k <= M, W = e^{-2 pi i/N};
//                                                  k = 0 gives bins 0 and M)
//   out[t][j] = sum over f in [lo_j, lo_j + len_j) of |X[f]|^2 fb_j[f]
//
// The plan (direct or chirp-z, P, radices over 8, 4, 2, 5 and 3), and every
// table (window, chirp, the filter spectrum in digit-reversed order, the
// digit-reversal positions, pass twiddles, split twiddles, the mel bank's
// bands and their lane schedule) come from ops/czt_plan.py, built in float64
// with numpy (chirp phases from m^2 mod 2M in integers, angles that are
// multiples of pi/2 exact) and rounded once to the instantiation's type.
// czt_plan.py also holds a torch emulation of this kernel's steps, which the
// CPU tests check against float64 np.fft.rfft, the golden mel and the Pallas
// kernels.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the
// tensor cores, 700 W). The function reads each clip once and writes its mel
// power once: at 512 five-second clips, hop 160 and 40 mels, 205 MB, 0.061
// ms whatever n_fft. Its least operations, a 2.5 N log2 N real FFT, the
// window, the power and the mel product over the bank's nonzeros, pass that
// time near n_fft 640 at hop 160, so the function is bound by bytes below
// and by operations above (at 2050, hop 512, 128 mels: 0.108 ms). The dense
// kernels' formulation, an O(N^2) DFT, does 64x the bound's operations at
// 2050; this one does two P-point FFTs, about 16x fewer operations than the
// dense DFT there, so only it can come near the bound. All products are
// plain FMAs: TF32 misses the 1e-5 feature gate.
//
// Design. A persistent grid of blocks of `warps` warps: each walks (clip,
// tile) pairs of tile_t consecutive frames and copies each tile's contiguous
// span of the padded clip, (tile_t - 1) hop + N samples, into shared memory
// with cp.async (zeros outside [0, n), which is the center padding, so no
// index is clamped), as csrc/mel_rfft.cu does. Each warp then takes one frame
// at a time through its own scratch (re and im apart, five values of padding
// every 32). The plan is known only at run time, so no pass can hold a
// lane's share of a frame in registers, as mel_rfft's Stockham passes do
// before writing back; and a second scratch to write into would halve the
// warps that fit. So the FFTs run in place (Cooley-Tukey): the forward FFT
// by decimation in frequency (natural order in, digit-reversed order out),
// the filter product on the digit-reversed values (H is stored in that
// order), the second FFT by decimation in time (the transposed passes in
// reverse order: digit-reversed in, natural order out). No permutation is
// ever applied, butterflies of one pass touch disjoint slots, and a warp
// needs only a __syncwarp between passes. The last forward pass, the filter
// product and the first inverse pass share their butterflies' slots, so they
// run as one pass in registers. The direct mode writes z at its
// digit-reversed slots and runs the inverse-order passes alone. A lane
// switches on the pass's radix (warp-uniform) and reads its twiddles, the
// chirp and the filter through L1 (__ldg), as mel_rfft's float64
// instantiation reads its twiddles. The split reads Z[k] and Z[M-k], which
// no other lane reads, so it writes their power back in place (bin M past
// the transform's slots). The mel product then sums each filter's nonzero
// band only, in chunks spread over the lanes (rfft_plan.mel_schedule), and
// writes the (B, T, n_mels) output time-major. Frames past T are not
// computed.
//
// Shared memory: 4 bytes a span sample and sizeof(T) (2 scratch + n_slots)
// a warp, scratch = czt_plan.scratch_size (P or M + 1 values plus padding).
// The wrapper (ops/mel_kernel.py::launch_czt) takes the first (warps, tile)
// of 8 x 32, 8 x 16, 8 x 8, 4 x 8, 4 x 4, 2 x 4, 2 x 2, 1 x 2, 1 x 1 that
// fits in 232,448 bytes; the float64 instantiation at n_fft 2050 (P 2560)
// runs 4 warps. One warp of one frame holds every even n_fft up to 16,384 in
// float32 and 10,240 in float64 at hop 160 and 40 mels (the dense kernels:
// 9,630 and 4,798).
//
// Rounding. The chirp-z route adds a second transform's rounding: the
// float32 instantiation came within 7.50e-7 of a clip's peak mel power (at
// n_fft 3314, against the 1e-6 gate) and the float64 one within 5.96e-8 of
// each bin (the float32 output's rounding) over every even n_fft from 4 to
// 4096 off mel_rfft's plans (chip_smoke.py phase 3 on an H100 80GB HBM3 at
// 700 W), so the float32 instantiation keeps its convolution in float32.
// The butterflies are mel_rfft.cu's (radix 2 added).
//
// Measured (chip_smoke.py phase 6, the same card, 512 five-second clips):
// n_fft 482 at 16 kHz, hop 160, 40 mels, 1.386 ms through either entry
// (the dense folded kernel 5.245 ms, the unfolded 8.452), 4.4 % of the
// bound; n_fft 2050 in float64 at 22.05 kHz, hop 512, 128 mels, 12.294 ms
// (dense 51.763, its plain version 19.902), 0.9 % of the bound; n_fft 4096
// there 4.951 ms in float32 and 9.766 in float64 (dense 432.263 and
// 992.517). ptxas: 64 registers in float32 (16 bytes of spill stores), 102
// in float64. What holds it back is not measured (no ncu on that machine);
// by reading, latency, where the scratch takes most of the shared memory:
// at 2050 in float64 4 warps an SM each walk a frame butterfly by
// butterfly. Two butterflies a lane an iteration (loads ahead of the
// in-place stores) raised the registers to 163 / 255 and cost more
// occupancy than the overlap won (482: 2.24 ms), so a lane takes one.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kMaxTileT = 32;       // frames a tile at most
constexpr int kMaxWarps = 8;        // warps a block at most
constexpr int kMaxPasses = 16;      // czt_plan.MAX_PASSES

// The butterflies' constants, each rounded to float32 once (rfft_plan.SQRT_HALF, COS1, SIN1, COS2, SIN2, SIN3).
constexpr float kSqrtHalf = 0.70710678118654752440f;  // radix 8
constexpr float kCos1 = 0.30901699437494742410f;      // radix 5: cos and sin of 2 pi/5 ...
constexpr float kSin1 = 0.95105651629515357212f;
constexpr float kCos2 = -0.80901699437494742410f;     // ... and of 4 pi/5
constexpr float kSin2 = 0.58778525229247312917f;
constexpr float kSin3 = 0.86602540378443864676f;      // radix 3: sin of pi/3

// The same for T = double, exact to float64 (rfft_plan.CONSTANTS64).
constexpr double kSqrtHalf64 = 0.70710678118654752440;
constexpr double kCos1_64 = 0.30901699437494742410;
constexpr double kSin1_64 = 0.95105651629515357212;
constexpr double kCos2_64 = -0.80901699437494742410;
constexpr double kSin2_64 = 0.58778525229247312917;
constexpr double kSin3_64 = 0.86602540378443864676;

__host__ __device__ constexpr int pad_index(int i) { return i + 5 * (i >> 5); }  // rfft_plan.pad_index

// The FFT's plan (czt_plan.Plan), passed by value.
struct Plan {
  int chirp;                // 1: chirp-z mode, 0: direct
  int M;                    // n_fft / 2
  int L;                    // the FFT's length: P, or M in the direct mode
  int passes;
  int radix[kMaxPasses];    // DIF order
  int len[kMaxPasses];      // each pass's group length L_s
  int tw[kMaxPasses];       // each pass's first twiddle
};

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
template <typename C> __device__ __forceinline__ C conjg(C a) { return cplx(a.x, -a.y); }
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

// In place, natural order out: v[k] = sum_r v[r] e^{-2 pi i r k / R} (mel_rfft.cu's, and radix 2).
template <int R, typename T>
struct Dft;

template <typename T>
struct Dft<2, T> {
  using C = typename Real<T>::C;
  __device__ __forceinline__ static void run(C (&v)[2]) {
    const C a = v[0];
    v[0] = add(a, v[1]);
    v[1] = sub(a, v[1]);
  }
};

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

// One pass over a warp's scratch of n values, in place (czt_plan._passes):
// butterfly b = g m + j (m = Ls / R) reads and writes slots g Ls + j + r m.
// Decimation in frequency (kDit false) multiplies output q by
// tw[(q - 1) m + j] = e^{-2 pi i q j / Ls} after the DFT, decimation in time
// input q before it; a pass with m = 1 has no twiddles. Neighbouring lanes
// read neighbouring twiddles.
template <int R, bool kDit, typename T>
__device__ __forceinline__ void run_pass(T* re, T* im, int n, int Ls, const typename Real<T>::C* __restrict__ tw,
                                         int lane) {
  using C = typename Real<T>::C;
  const int m = Ls / R;
  const int nb = n / R;
  for (int b = lane; b < nb; b += 32) {
    const int g = b / m, j = b - g * m;
    const int base = g * Ls + j;
    C v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = pad_index(base + r * m);
      v[r] = cplx(re[i], im[i]);
    }
    if (kDit && m > 1) {
#pragma unroll
      for (int q = 1; q < R; ++q) v[q] = cmul(v[q], __ldg(tw + (q - 1) * m + j));
    }
    Dft<R, T>::run(v);
    if (!kDit && m > 1) {
#pragma unroll
      for (int q = 1; q < R; ++q) v[q] = cmul(v[q], __ldg(tw + (q - 1) * m + j));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = pad_index(base + r * m);
      re[i] = v[r].x;
      im[i] = v[r].y;
    }
  }
  __syncwarp();
}

// The chirp-z mode's middle: the last forward pass (m = 1), the filter
// product conj(A) conj(H) / P on its outputs (slot b R + r's at row
// r n / R + b: czt_plan.filter_rows), and the first inverse pass over the
// same slots, in registers.
template <int R, typename T>
__device__ __forceinline__ void middle_pass(T* re, T* im, int n, const typename Real<T>::C* __restrict__ filt,
                                            int lane) {
  using C = typename Real<T>::C;
  const int nb = n / R;
  for (int b = lane; b < nb; b += 32) {
    C v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = pad_index(b * R + r);
      v[r] = cplx(re[i], im[i]);
    }
    Dft<R, T>::run(v);
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = cmul(conjg(v[r]), __ldg(filt + r * nb + b));
    Dft<R, T>::run(v);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = pad_index(b * R + r);
      re[i] = v[r].x;
      im[i] = v[r].y;
    }
  }
  __syncwarp();
}

// Pass s of the plan, by its radix (warp-uniform).
template <bool kDit, typename T>
__device__ __forceinline__ void pass(const Plan& p, int s, T* re, T* im, const typename Real<T>::C* __restrict__ tw,
                                     int lane) {
  const auto* t = tw + p.tw[s];
  switch (p.radix[s]) {
    case 2: run_pass<2, kDit, T>(re, im, p.L, p.len[s], t, lane); break;
    case 3: run_pass<3, kDit, T>(re, im, p.L, p.len[s], t, lane); break;
    case 4: run_pass<4, kDit, T>(re, im, p.L, p.len[s], t, lane); break;
    case 5: run_pass<5, kDit, T>(re, im, p.L, p.len[s], t, lane); break;
    default: run_pass<8, kDit, T>(re, im, p.L, p.len[s], t, lane); break;
  }
}

template <typename T>
__device__ __forceinline__ void middle(const Plan& p, T* re, T* im, const typename Real<T>::C* __restrict__ filt,
                                       int lane) {
  switch (p.radix[p.passes - 1]) {
    case 2: middle_pass<2, T>(re, im, p.L, filt, lane); break;
    case 3: middle_pass<3, T>(re, im, p.L, filt, lane); break;
    case 4: middle_pass<4, T>(re, im, p.L, filt, lane); break;
    case 5: middle_pass<5, T>(re, im, p.L, filt, lane); break;
    default: middle_pass<8, T>(re, im, p.L, filt, lane); break;
  }
}

// Asynchronous 4-byte copy to shared memory (zero-filled where !valid) and its waits.
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void copy_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps)
mel_czt_kernel(const float* __restrict__ y, int batch, int n, int n_frames, int hop, int tile_t, const Plan p,
               int scratch, const T* __restrict__ window, const typename Real<T>::C* __restrict__ chirp,
               const typename Real<T>::C* __restrict__ filt, const int* __restrict__ positions,
               const typename Real<T>::C* __restrict__ twiddles, const typename Real<T>::C* __restrict__ split,
               const T* __restrict__ weights, const int4* __restrict__ chunks, int n_rounds,
               const int2* __restrict__ slots, int n_mels, int n_slots, float* __restrict__ out) {
  using C = typename Real<T>::C;
  const int M = p.M;
  const int N = 2 * M;
  const int W = blockDim.x >> 5;
  // Shared memory (smem_bytes): the span, then each warp's scratch and partial sums.
  extern __shared__ __align__(16) float smem[];
  const int span = (tile_t - 1) * hop + N;
  float* xs = smem;                                                   // [span], padded to 4
  T* scratch_all = reinterpret_cast<T*>(xs + ((span + 3) & ~3));      // [W][2][scratch]
  T* parts = scratch_all + W * 2 * scratch;                           // [W][n_slots]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* re = scratch_all + warp * 2 * scratch;
  T* im = re + scratch;
  T* part = parts + warp * n_slots;
  const C* win2 = reinterpret_cast<const C*>(window);

  const int tiles_per_clip = (n_frames + tile_t - 1) / tile_t;
  const long n_tiles = static_cast<long>(batch) * tiles_per_clip;
  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = static_cast<int>(tile / tiles_per_clip);
    const int t0 = static_cast<int>(tile - static_cast<long>(b) * tiles_per_clip) * tile_t;
    __syncthreads();  // the previous tile is done with xs
    const float* row = y + static_cast<long>(b) * n;
    const long first = static_cast<long>(t0) * hop - M;
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
      const long j = first + i;
      const bool inside = j >= 0 && j < n;
      copy_async(xs + i, inside ? row + j : row, inside);
    }
    copy_async_commit();
    copy_async_wait();
    __syncthreads();  // this tile's span is in

    for (int f = warp; f < tile_t; f += W) {
      const int t = t0 + f;
      if (t >= n_frames) break;  // warp-uniform: frames past T are not computed
      const float* x = xs + f * hop;

      // Load: z times the chirp at natural slots (zeros up to P), or z at its digit-reversed slot.
      if (p.chirp) {
        for (int m = lane; m < p.L; m += 32) {
          C v = cplx(T(0), T(0));
          if (m < M) {
            const C w = __ldg(win2 + m);
            v = cmul(cplx(x[2 * m] * w.x, x[2 * m + 1] * w.y), __ldg(chirp + m));
          }
          re[pad_index(m)] = v.x;
          im[pad_index(m)] = v.y;
        }
      } else {
        for (int m = lane; m < M; m += 32) {
          const C w = __ldg(win2 + m);
          const int i = pad_index(__ldg(positions + m));
          re[i] = x[2 * m] * w.x;
          im[i] = x[2 * m + 1] * w.y;
        }
      }
      __syncwarp();

      if (p.chirp) {
        for (int s = 0; s < p.passes - 1; ++s) pass<false, T>(p, s, re, im, twiddles, lane);
        middle<T>(p, re, im, filt, lane);
        for (int s = p.passes - 2; s >= 0; --s) pass<true, T>(p, s, re, im, twiddles, lane);
      } else {
        for (int s = p.passes - 1; s >= 0; --s) pass<true, T>(p, s, re, im, twiddles, lane);
      }

      // Real split: power of bins k and M - k (k = 0: 0 and M) from Z[k] and
      // Z[M - k], written back to the slots only this lane reads.
      for (int k = lane; 2 * k <= M; k += 32) {
        const int kb = k == 0 ? 0 : M - k;
        const int ia = pad_index(k), ib = pad_index(kb);
        C a = cplx(re[ia], im[ia]);
        C c = cplx(re[ib], im[ib]);
        if (p.chirp) {
          a = cmul(__ldg(chirp + k), conjg(a));
          c = cmul(__ldg(chirp + kb), conjg(c));
        }
        const C e = cplx((a.x + c.x) * T(0.5), (a.y - c.y) * T(0.5));
        const C o = cplx((a.y + c.y) * T(0.5), (c.x - a.x) * T(0.5));
        const C wo = cmul(o, __ldg(split + k));
        const C x1 = add(e, wo), x2 = sub(e, wo);
        re[ia] = fma_(x1.x, x1.x, x1.y * x1.y);
        if (k == 0) {
          re[pad_index(M)] = fma_(x2.x, x2.x, x2.y * x2.y);
        } else if (2 * k != M) {
          re[ib] = fma_(x2.x, x2.x, x2.y * x2.y);
        }
      }
      __syncwarp();

      // Mel product over the bands' chunks (first bin, length, weight
      // offset, slot), ascending bins, then each filter's slots in order.
      for (int q = 0; q < n_rounds; ++q) {
        const int4 c = __ldg(chunks + 32 * q + lane);
        if (c.w >= 0) {
          T acc = T(0);
          for (int i = 0; i < c.y; ++i) acc = fma_(re[pad_index(c.x + i)], __ldg(weights + c.z + i), acc);
          part[c.w] = acc;
        }
      }
      __syncwarp();
      float* orow = out + (static_cast<long>(b) * n_frames + t) * n_mels;
      for (int j = lane; j < n_mels; j += 32) {
        const int2 sj = __ldg(slots + j);
        T acc = part[sj.x];
        for (int c = 1; c < sj.y; ++c) acc += part[sj.x + c];
        orow[j] = static_cast<float>(acc);
      }
      __syncwarp();  // the next frame overwrites the scratch and the partial sums
    }
  }
}

// Dynamic shared memory one block needs, in bytes (mel_kernel.czt_shape
// computes the same to pick the warps and frames a tile).
size_t smem_bytes(int n_fft, int hop, int tile_t, int warps, int scratch, int n_slots, int t_bytes) {
  const size_t span = static_cast<size_t>(tile_t - 1) * hop + n_fft;
  return sizeof(float) * ((span + 3) & ~static_cast<size_t>(3)) +
         static_cast<size_t>(t_bytes) * warps * (2 * static_cast<size_t>(scratch) + n_slots);
}

constexpr int kMaxDevices = 64;

template <typename T>
int launch(const float* y, int batch, int n, int n_frames, int n_fft, int hop, int tile_t, int warps, int chirp_mode,
           int L, int passes, const int* radices, const int* lengths, const int* tw_offsets, int scratch,
           const T* window, const T* chirp, const T* filt, const int* positions, const T* twiddles, const T* split,
           const T* weights, const int* chunks, int n_rounds, const int* slots, int n_mels, int n_slots, float* out,
           void* stream) {
  using C = typename Real<T>::C;
  static std::mutex lock;
  static int smem_set[kMaxDevices] = {};  // per device: the limit set so far
  if (tile_t < 1 || tile_t > kMaxTileT || warps < 1 || warps > kMaxWarps || passes < 0 || passes > kMaxPasses ||
      n_fft < 2 || n_fft % 2 || (chirp_mode && passes < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p{};
  p.chirp = chirp_mode;
  p.M = n_fft / 2;
  p.L = L;
  p.passes = passes;
  for (int s = 0; s < passes; ++s) {
    p.radix[s] = radices[s];
    p.len[s] = lengths[s];
    p.tw[s] = tw_offsets[s];
    const int r = radices[s];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 8) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(smem_bytes(n_fft, hop, tile_t, warps, scratch, n_slots, sizeof(T)));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  {
    std::lock_guard<std::mutex> guard(lock);
    if (smem > smem_set[dev]) {
      err = cudaFuncSetAttribute(mel_czt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set[dev] = smem;
    }
  }
  const int threads = 32 * warps;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mel_czt_kernel<T>, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long n_tiles = static_cast<long>(batch) * ((n_frames + tile_t - 1) / tile_t);
  const long most = static_cast<long>(sms) * per_sm;
  const int grid = static_cast<int>(n_tiles < most ? n_tiles : most);
  mel_czt_kernel<T><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, batch, n, n_frames, hop, tile_t, p, scratch, window, reinterpret_cast<const C*>(chirp),
      reinterpret_cast<const C*>(filt), positions, reinterpret_cast<const C*>(twiddles),
      reinterpret_cast<const C*>(split), weights, reinterpret_cast<const int4*>(chunks), n_rounds,
      reinterpret_cast<const int2*>(slots), n_mels, n_slots, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the float32 instantiation on `stream` (on the current device):
// tile_t (1 .. 32) frames a tile, `warps` (1 .. 8) warps a block, the plan
// (chirp_mode 1 or 0, its length L, `passes` radices, group lengths and
// twiddle offsets, host arrays) and czt_plan.tables(): window (N,), chirp
// (M, 2), filt (L, 2), positions (L,) int32, twiddles (n_tw, 2), split
// (M/2 + 1, 2), weights, chunks (n_rounds, 32, 4) int32, slots (n_mels, 2)
// int32, whose counts add up to n_slots. Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for arguments out of range.
int mel_czt_launch(const float* y, int batch, int n, int n_frames, int n_fft, int hop, int tile_t, int warps,
                   int chirp_mode, int L, int passes, const int* radices, const int* lengths, const int* tw_offsets,
                   int scratch, const float* window, const float* chirp, const float* filt, const int* positions,
                   const float* twiddles, const float* split, const float* weights, const int* chunks, int n_rounds,
                   const int* slots, int n_mels, int n_slots, float* out, void* stream) {
  return launch<float>(y, batch, n, n_frames, n_fft, hop, tile_t, warps, chirp_mode, L, passes, radices, lengths,
                       tw_offsets, scratch, window, chirp, filt, positions, twiddles, split, weights, chunks, n_rounds,
                       slots, n_mels, n_slots, out, stream);
}

// The same launch on the float64 instantiation, with czt_plan.tables64()'s
// window, chirp, filt, twiddles, split and weights (float64).
int mel_czt_launch_f64(const float* y, int batch, int n, int n_frames, int n_fft, int hop, int tile_t, int warps,
                       int chirp_mode, int L, int passes, const int* radices, const int* lengths,
                       const int* tw_offsets, int scratch, const double* window, const double* chirp,
                       const double* filt, const int* positions, const double* twiddles, const double* split,
                       const double* weights, const int* chunks, int n_rounds, const int* slots, int n_mels,
                       int n_slots, float* out, void* stream) {
  return launch<double>(y, batch, n, n_frames, n_fft, hop, tile_t, warps, chirp_mode, L, passes, radices, lengths,
                        tw_offsets, scratch, window, chirp, filt, positions, twiddles, split, weights, chunks,
                        n_rounds, slots, n_mels, n_slots, out, stream);
}

}  // extern "C"
