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
// at the shared-memory ceiling (pcps_bins_fourstep.cu keeps it for lengths
// with a prime factor above 5).
//
// This entry is a mixed-radix Stockham (autosort) FFT in shared memory, in
// float32 on the CUDA cores, for n = r_0 r_1 ... r_{P-1} with radices from
// {10, 5, 4, 3, 2} (the wrapper's radix_plan: 10 10 5 5 at n = 2500, 10 10
// 10 10 at n = 10000). With ns the product of the radices already done,
// pass p takes for j < n / r
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

namespace {

constexpr int kMaxPasses = 16;
constexpr int kMaxThreads = 1024;
constexpr int kMaxPerThread = 20;   // n / threads is at most this
constexpr int kMaxAcc = 21;         // ceil(20 / r) * r over the radices

struct Plan {
  int radix[kMaxPasses];
  int n_pass;
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// i * a
__device__ __forceinline__ float2 mul_i(float2 a) {
  return make_float2(-a.y, a.x);
}

// v <- DFT_R(v) with the inverse sign: v[q] = sum_r v[r] e^{+2 pi i q r / R}.
template <int R>
__device__ __forceinline__ void butterfly(float2 (&v)[R]);

template <>
__device__ __forceinline__ void butterfly<2>(float2 (&v)[2]) {
  const float2 a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}

template <>
__device__ __forceinline__ void butterfly<3>(float2 (&v)[3]) {
  constexpr float kSin = 0.8660254037844386;   // sin(2 pi / 3)
  const float2 t1 = cadd(v[1], v[2]);
  const float2 t2 = make_float2(v[0].x - 0.5f * t1.x, v[0].y - 0.5f * t1.y);
  const float2 d = csub(v[1], v[2]);
  const float2 t3 = mul_i(make_float2(kSin * d.x, kSin * d.y));
  v[0] = cadd(v[0], t1);
  v[1] = cadd(t2, t3);
  v[2] = csub(t2, t3);
}

template <>
__device__ __forceinline__ void butterfly<4>(float2 (&v)[4]) {
  const float2 s02 = cadd(v[0], v[2]);
  const float2 d02 = csub(v[0], v[2]);
  const float2 s13 = cadd(v[1], v[3]);
  const float2 d13 = mul_i(csub(v[1], v[3]));
  v[0] = cadd(s02, s13);
  v[1] = cadd(d02, d13);
  v[2] = csub(s02, s13);
  v[3] = csub(d02, d13);
}

template <>
__device__ __forceinline__ void butterfly<5>(float2 (&v)[5]) {
  constexpr float kC1 = 0.30901699437494745;    // cos(2 pi / 5)
  constexpr float kC2 = -0.8090169943749475;    // cos(4 pi / 5)
  constexpr float kS1 = 0.9510565162951535;     // sin(2 pi / 5)
  constexpr float kS2 = 0.5877852522924731;     // sin(4 pi / 5)
  const float2 t1 = cadd(v[1], v[4]);
  const float2 t2 = cadd(v[2], v[3]);
  const float2 t3 = csub(v[1], v[4]);
  const float2 t4 = csub(v[2], v[3]);
  const float2 m1 = make_float2(v[0].x + kC1 * t1.x + kC2 * t2.x,
                                v[0].y + kC1 * t1.y + kC2 * t2.y);
  const float2 m2 = make_float2(v[0].x + kC2 * t1.x + kC1 * t2.x,
                                v[0].y + kC2 * t1.y + kC1 * t2.y);
  const float2 n1 = mul_i(make_float2(kS1 * t3.x + kS2 * t4.x,
                                      kS1 * t3.y + kS2 * t4.y));
  const float2 n2 = mul_i(make_float2(kS2 * t3.x - kS1 * t4.x,
                                      kS2 * t3.y - kS1 * t4.y));
  v[0] = cadd(v[0], cadd(t1, t2));
  v[1] = cadd(m1, n1);
  v[2] = cadd(m2, n2);
  v[3] = csub(m2, n2);
  v[4] = csub(m1, n1);
}

// Roots of unity e^{+2 pi i e / 10}, e < 5, of the radix-10 butterfly.
__constant__ float2 kRoots10[5] = {
    {1.0f, 0.0f},
    {0.8090169943749475f, 0.5877852522924731f},
    {0.30901699437494745f, 0.9510565162951535f},
    {-0.30901699437494734f, 0.9510565162951536f},
    {-0.8090169943749473f, 0.5877852522924732f}};

// DFT of length 10 = A B in registers (Cooley-Tukey, A = 2, B = 5): B
// butterflies of length A over the points B n1 + n2, the roots w^{n2 k1},
// then A butterflies of length B; output k1 + A k2. Every index is a
// compile-time constant.
template <>
__device__ __forceinline__ void butterfly<10>(float2 (&v)[10]) {
  constexpr int A = 2, B = 5;
  float2 y[B][A];
#pragma unroll
  for (int n2 = 0; n2 < B; ++n2) {
    float2 t[A];
#pragma unroll
    for (int n1 = 0; n1 < A; ++n1) t[n1] = v[B * n1 + n2];
    butterfly<A>(t);
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) {
      y[n2][k1] = n2 * k1 == 0 ? t[k1] : cmul(t[k1], kRoots10[n2 * k1]);
    }
  }
#pragma unroll
  for (int k1 = 0; k1 < A; ++k1) {
    float2 t[B];
#pragma unroll
    for (int n2 = 0; n2 < B; ++n2) t[n2] = y[n2][k1];
    butterfly<B>(t);
#pragma unroll
    for (int k2 = 0; k2 < B; ++k2) v[k1 + A * k2] = t[k2];
  }
}

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
template <int R>
__device__ __forceinline__ void last_pass(const float2* __restrict__ in,
                                          const float2* __restrict__ tw,
                                          int n, float (&acc)[kMaxAcc]) {
  constexpr int kIters = (kMaxPerThread + R - 1) / R;
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

template <int R>
__device__ __forceinline__ void store_map(const float (&acc)[kMaxAcc], int n,
                                          float scale,
                                          float* __restrict__ dst) {
  constexpr int kIters = (kMaxPerThread + R - 1) / R;
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

// Run `call` with R the compile-time value of the runtime radix r.
#define SYDR_RADIX_SWITCH(r, call)                 \
  switch (r) {                                     \
    case 2: { constexpr int R = 2; call; } break;   \
    case 3: { constexpr int R = 3; call; } break;   \
    case 4: { constexpr int R = 4; call; } break;   \
    case 5: { constexpr int R = 5; call; } break;   \
    default: { constexpr int R = 10; call; } break; \
  }

__global__ void __launch_bounds__(kMaxThreads) pcps_bins_kernel(
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

  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.0f;

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
      SYDR_RADIX_SWITCH(r, middle_pass<R>(in, other, tw, n, ns));
      __syncthreads();
      float2* t = in;
      in = other;
      other = t;
      ns *= r;
    }
    SYDR_RADIX_SWITCH(r_last, last_pass<R>(in, tw, n, acc));
    __syncthreads();   // the next block's passes overwrite both buffers
  }

  float* dst = out + (static_cast<size_t>(c) * n_bins + bin) * n;
  const float scale = 1.0f / static_cast<float>(n);
  SYDR_RADIX_SWITCH(r_last, store_map<R>(acc, n, scale, dst));
}

}  // namespace

extern "C" const char* sydr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// spec [n_ph, n_ch, nc, n] complex64, code [n_ch, n]
// complex64, tw [n] complex64, shift / phase [n_bins] int32 (device), out
// [n_ch, n_bins, n]; radices: host array of n_pass >= 2 radices from
// {2, 3, 4, 5, 10} whose product is n; threads: a multiple of 32 with
// n <= 20 threads.
extern "C" int pcps_bins_launch(
    const void* spec, const void* code, const void* tw, const void* shift,
    const void* phase, int n_ch, int nc, int n, const int* radices,
    int n_pass, int threads, int n_bins, void* out, void* stream) {
  if (n_pass < 2 || n_pass > kMaxPasses || n < 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan plan;
  plan.n_pass = n_pass;
  long long product = 1;
  for (int i = 0; i < kMaxPasses; ++i) {
    plan.radix[i] = i < n_pass ? radices[i] : 1;
    if (i < n_pass) {
      const int r = radices[i];
      if (!(r >= 2 && r <= 5) && r != 10) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      product *= radices[i];
    }
  }
  if (product != n) return static_cast<int>(cudaErrorInvalidValue);
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      n > kMaxPerThread * threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(n) * 2 * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      pcps_bins_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_bins, n_ch);
  pcps_bins_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), static_cast<const float2*>(code),
      static_cast<const float2*>(tw), static_cast<const int*>(shift),
      static_cast<const int*>(phase), n_ch, nc, n, n_bins, plan,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
