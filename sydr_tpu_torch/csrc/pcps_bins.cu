// K2 pcps_bins: non-coherent PCPS correlation magnitudes for every
// (Doppler bin, channel) of the shift-theorem acquisition plan.
//
// Replaces the Pallas kernel sydr_tpu/ops/acq_kernel.py (_kernel, launched by
// pcps_fused_bins). For bin b with plan entry (k_b, p_b) and channel c:
//
//   out[c, b, :] = sum_j | IDFT_n( S[p_b, c, j, :] * roll(K[c], k_b) ) |
//
// over the nc non-coherent blocks j, where S are the per-phase block
// spectra and K the conjugate code spectrum (roll(K, k)[i] = K[(i-k) mod n]).
// The TPU kernel formed the inverse DFT as two matrix products (a four-step
// transform on the MXU, the chip having no complex type and no FFT); on this
// card that form reads 16 bytes of shared memory per multiply-add and sits
// at the shared-memory ceiling (the four-step entry that served the
// lengths with a prime factor above 31 before the generic pass below ran
// n = 4070 in 3.92 ms against torch.fft.ifft's 0.57 on an NVIDIA H100
// 80GB HBM3).
//
// This entry is a mixed-radix Stockham (autosort) FFT in shared memory, in
// float32 on the CUDA cores, for n = r_0 r_1 ... r_{P-1} with radices from
// {10, 5, 4, 3, 2} and the odd primes 7 to 31 (the wrapper's radix_plan:
// 10 10 5 5 at n = 2500, 10 10 10 10 at n = 10000, and 31 4 3 11 at
// n = 4092 = 2^2 3 11 31, the code period of every front end clocked at a
// multiple of 1.023 MHz), and every prime factor above 31 as a generic
// pass of runtime radix between the first and the last (11 37 10 at
// n = 4070; 1 41 37 1 at n = 1517 = 37 x 41, the radix-1 ends only
// forming the product and its magnitude), one block a transform; a
// transform that does not fit one block runs on a cluster of blocks
// (pcps_bins_cluster.cu, same passes and arithmetic; the butterflies and
// the generic pass of both in pcps_fft.cuh).
// With ns the product of the radices already done, pass p takes for
// j < n / r
//
//   v[q]  = in[j + q n/r] * tw[q (j mod ns) n/(ns r)]          q < r
//   out[(j div ns) ns r + (j mod ns) + q ns] = DFT_r(v)[q]
//
// so every pass reads at stride n / r and writes at stride ns, and the last
// pass (ns r = n) ends in natural order. Twiddles come from one table
// tw[t] = e^{+2 pi i t / n}, built in float64 by the wrapper, at the exact
// integer index above (always below n), never from an f32 product of
// angles; the butterflies' own roots are float64 literals.
//
// A prime radix r >= 7 is the direct r-point DFT of the r inputs a thread
// holds in registers, in its real-symmetric form: with s_q = v[q] + v[r-q]
// and d_q = v[q] - v[r-q] for q <= (r-1)/2, outputs k and r - k are
// A_k +- i B_k, A_k = v[0] + sum_q cos(2 pi k q / r) s_q, B_k = sum_q
// sin(2 pi k q / r) d_q: (r-1)^2 real multiply-adds for r complex points
// (29 a point at r = 31, 9 at r = 11) where a four-step DFT spends
// 4 (n1 + n2) = 512 at n = 4092, every operand in a register or the
// constant bank. Its loops are fully unrolled, so a thread needs some 4 r
// registers; the kernel is compiled by the block's largest size: 1024
// threads (64 registers, radices up to 10 only, as before the prime
// radices existed), 512 and 256 threads (128 and 255 registers) for plans
// with a prime radix, chosen at the launch from the plan and the thread
// count. A radix above 31 (a prime factor of n, up to 32,749 at
// n = 65,498) cannot live in registers: generic_pass (pcps_fft.cuh) folds
// the twiddled inputs into sums and differences in place, then sums them
// against roots read from the twiddle table. Plans with such a radix run
// two more variants (256 and 512 threads) that add it and radix 1; in the
// prime variants themselves it made n = 4092 4.7% slower (NVIDIA H100
// 80GB HBM3).
//
// Bound on the H100: operations. Each input byte once is 97 MB at the
// session shape (32 ch x 101 bins x n = 2500; 0.03 ms of HBM time), while
// 32,320 transforms of ~5 n log2 n + 10 n flops are ~5 GFLOP (0.08 ms at
// the f32 rate). In practice a pass costs about as much in shared-memory
// and L1 traffic (points in and out, one twiddle a point) as in
// arithmetic, so the design cuts both:
//   * one block per (bin, channel) walks the nc blocks; the spectrum
//     product with the rolled code is fused into the first pass's load
//     (the spectrum row is shared by the ~10 bins of its phase through
//     L2), so no product ever reaches memory;
//   * radix 10 = 2 x 5 in registers (Cooley-Tukey inside the butterfly,
//     its inner roots compile-time constants): 4 passes at n = 2500 and at
//     n = 10000 where radices 4 and 5 take 5 and 6, each pass less saving
//     a barrier, 16 n bytes of shared-memory traffic and n twiddles;
//   * two ping-pong buffers of n complex are all the shared memory (16 n
//     bytes: 40 KB at n = 2500, 4 blocks of 256 threads an SM; 160 KB at
//     n = 10000, one block of 1024 threads an SM, one thread per
//     radix-10 butterfly of a pass);
//   * the last pass keeps its outputs in registers: a thread owns the same
//     n / threads output points for every block j, so magnitude and the
//     non-coherent sum never touch shared memory, the 1/n scale is one
//     multiply at the store, and the map is stored coalesced in natural
//     order;
//   * j mod ns by a multiply-high with a per-pass reciprocal instead of an
//     integer division.
// Tried on the card and not kept: 16-byte loads of the spectrum row (two
// butterflies a thread in the first pass: the registers they need spill
// under the 64 a thread has at 1024 threads), the twiddle table's first
// half in shared memory, radix 16. Tensor cores are not used: TF32 keeps
// ~10 mantissa bits and the map is held to 1e-4 of its maximum.

#include <cuda_runtime.h>
#include <math.h>

#include "pcps_fft.cuh"

namespace {

// The block's buffers, for generic_pass.
struct Local {
  float2* p;
  __device__ __forceinline__ float2 load(int i) const { return p[i]; }
  __device__ __forceinline__ void store(int i, float2 v) const { p[i] = v; }
  static __device__ __forceinline__ void sync() { __syncthreads(); }
};

// Pass 0 (ns = 1, no twiddles), fused with the spectrum product: reads
// global memory, writes out[j R + q].
template <int R>
__device__ __forceinline__ void first_pass(const float2* __restrict__ s,
                                           const float2* __restrict__ kc,
                                           int k, int n,
                                           float2* __restrict__ out) {
  const int m = n / R;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = j + r * m;
      int src = i - k;
      if (src < 0) src += n;
      v[r] = cmul(__ldg(s + i), __ldg(kc + src));
    }
    butterfly<R>(v);
#pragma unroll
    for (int r = 0; r < R; ++r) out[j * R + r] = v[r];
  }
}

// A pass between the first and the last: shared memory to shared memory.
template <int R>
__device__ __forceinline__ void middle_pass(const float2* __restrict__ in,
                                            float2* __restrict__ out,
                                            const float2* __restrict__ tw,
                                            int n, int ns) {
  const int m = n / R;
  const int tstride = m / ns;   // n / (ns R)
  // j / ns as a multiply-high: exact for j * ns < 2^32 (ns >= 2 here).
  const unsigned magic = 0xFFFFFFFFu / static_cast<unsigned>(ns) + 1u;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int hi = static_cast<int>(__umulhi(static_cast<unsigned>(j), magic));
    const int k = j - hi * ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = in[j + r * m];
    const int t1 = k * tstride;
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(tw + r * t1));
    butterfly<R>(v);
    float2* o = out + hi * ns * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) o[r * ns] = v[r];
  }
}

// The last pass (ns = n / R, so j mod ns = j and the output index is
// j + q n/R): magnitudes added to the thread's accumulators.
template <int R, int kAcc>
__device__ __forceinline__ void last_pass(const float2* __restrict__ in,
                                          const float2* __restrict__ tw,
                                          int n, float (&acc)[kAcc]) {
  constexpr int kIters = kAcc / R;
  const int m = n / R;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = threadIdx.x + it * blockDim.x;
    if (j < m) {
      float2 v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = in[j + r * m];
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(tw + r * j));
      butterfly<R>(v);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[it * R + r] += sqrtf(v[r].x * v[r].x + v[r].y * v[r].y);
      }
    }
  }
}

template <int R, int kAcc>
__device__ __forceinline__ void store_map(const float (&acc)[kAcc], int n,
                                          float scale,
                                          float* __restrict__ dst) {
  constexpr int kIters = kAcc / R;
  const int m = n / R;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = threadIdx.x + it * blockDim.x;
    if (j < m) {
#pragma unroll
      for (int r = 0; r < R; ++r) dst[j + r * m] = acc[it * R + r] * scale;
    }
  }
}

// kMaxT: the largest block (it sets the registers a thread may have);
// kAcc: the accumulators a thread holds; kPrimes: with the prime radices;
// kGeneric: also with the generic pass and radix 1.
template <int kMaxT, int kAcc, bool kPrimes, bool kGeneric>
__global__ void __launch_bounds__(kMaxT) pcps_bins_kernel(
    const float2* __restrict__ spec, const float2* __restrict__ code,
    const float2* __restrict__ tw, const int* __restrict__ shift,
    const int* __restrict__ phase, int n_ch, int nc, int n, int n_bins,
    Plan plan, float* __restrict__ out) {
  extern __shared__ float4 smem_raw[];
  float2* buf0 = reinterpret_cast<float2*>(smem_raw);
  float2* buf1 = buf0 + n;

  const int bin = blockIdx.x;
  const int c = blockIdx.y;
  int k = shift[bin] % n;
  if (k < 0) k += n;
  const int p = phase[bin];
  const int r_first = plan.radix[0];
  const int r_last = plan.radix[plan.n_pass - 1];
  const float2* kc = code + static_cast<size_t>(c) * n;

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

  for (int j = 0; j < nc; ++j) {
    const float2* s =
        spec + ((static_cast<size_t>(p) * n_ch + c) * nc + j) * n;
    SYDR_RADIX_SWITCH(r_first, first_pass<R>(s, kc, k, n, buf0));
    __syncthreads();
    float2* in = buf0;
    float2* other = buf1;
    int ns = r_first;
    for (int ps = 1; ps + 1 < plan.n_pass; ++ps) {
      const int r = plan.radix[ps];
      SYDR_MIDDLE_SWITCH(r, middle_pass<R>(in, other, tw, n, ns),
                         generic_pass(Local{in}, Local{other}, tw, n, ns, r,
                                      0, 1));
      __syncthreads();
      float2* t = in;
      in = other;
      other = t;
      ns *= r;
    }
    SYDR_RADIX_SWITCH(r_last, (last_pass<R, kAcc>(in, tw, n, acc)));
    __syncthreads();   // the next block's passes overwrite both buffers
  }

  float* dst = out + (static_cast<size_t>(c) * n_bins + bin) * n;
  const float scale = 1.0f / static_cast<float>(n);
  SYDR_RADIX_SWITCH(r_last, (store_map<R, kAcc>(acc, n, scale, dst)));
}

// Launch one variant of the kernel; its shared memory is above the 48 KB
// a kernel gets unasked from n = 3073 on.
template <int kMaxT, int kAcc, bool kPrimes, bool kGeneric>
int launch_variant(const float2* spec, const float2* code, const float2* tw,
                   const int* shift, const int* phase, int n_ch, int nc,
                   int n, int n_bins, const Plan& plan, int threads,
                   float* out, cudaStream_t stream) {
  const int r_last = plan.radix[plan.n_pass - 1];
  if (threads > kMaxT || n / r_last > (kAcc / r_last) * threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(n) * 2 * sizeof(float2);
  const cudaError_t err = cudaFuncSetAttribute(
      pcps_bins_kernel<kMaxT, kAcc, kPrimes, kGeneric>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pcps_bins_kernel<kMaxT, kAcc, kPrimes, kGeneric>
      <<<dim3(n_bins, n_ch), threads, smem, stream>>>(
          spec, code, tw, shift, phase, n_ch, nc, n, n_bins, plan, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* sydr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// spec [n_ph, n_ch, nc, n] complex64, code [n_ch, n]
// complex64, tw [n] complex64, shift / phase [n_bins] int32 (device), out
// [n_ch, n_bins, n]; radices: host array of n_pass >= 2 radices whose
// product is n, as parse_plan (pcps_fft.cuh) takes them; threads: a
// multiple of 32, at most 1024 without a radix outside {2, 3, 4, 5, 10}
// (n <= 20 threads) and 512 with one (n / r_last <= floor(32 / r_last)
// threads).
extern "C" int pcps_bins_launch(
    const void* spec, const void* code, const void* tw, const void* shift,
    const void* phase, int n_ch, int nc, int n, const int* radices,
    int n_pass, int threads, int n_bins, void* out, void* stream) {
  Plan plan;
  bool primes, generic;
  const int bad = parse_plan(radices, n_pass, n, &plan, &primes, &generic);
  if (bad != 0) return bad;
  if (threads < 32 || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float2* s = static_cast<const float2*>(spec);
  const float2* kc = static_cast<const float2*>(code);
  const float2* t = static_cast<const float2*>(tw);
  const int* sh = static_cast<const int*>(shift);
  const int* ph = static_cast<const int*>(phase);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!primes) {
    return launch_variant<1024, kAccSmall, false, false>(
        s, kc, t, sh, ph, n_ch, nc, n, n_bins, plan, threads, o, st);
  }
  if (generic) {
    if (threads <= 256) {
      return launch_variant<256, kAccPrime, true, true>(
          s, kc, t, sh, ph, n_ch, nc, n, n_bins, plan, threads, o, st);
    }
    return launch_variant<512, kAccPrime, true, true>(
        s, kc, t, sh, ph, n_ch, nc, n, n_bins, plan, threads, o, st);
  }
  if (threads <= 256) {
    return launch_variant<256, kAccPrime, true, false>(
        s, kc, t, sh, ph, n_ch, nc, n, n_bins, plan, threads, o, st);
  }
  return launch_variant<512, kAccPrime, true, false>(
      s, kc, t, sh, ph, n_ch, nc, n, n_bins, plan, threads, o, st);
}
