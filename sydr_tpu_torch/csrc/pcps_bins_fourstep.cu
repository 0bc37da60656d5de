// K2, four-step entry: non-coherent PCPS correlation magnitudes for every
// (Doppler bin, channel) of the shift-theorem acquisition plan, for a code
// period n that the radix FFT of pcps_bins.cu does not take: one with a
// prime factor above 31 (n = 4070 = 2 * 5 * 11 * 37), or with a prime
// radix above n = 8192. The wrapper chooses from n alone.
//
// Replaces the Pallas kernel sydr_tpu/ops/acq_kernel.py (_kernel, launched by
// pcps_fused_bins). For bin b with plan entry (k_b, p_b) and channel c:
//
//   out[c, b, :] = sum_j | IDFT_n( S[p_b, c, j, :] * roll(K[c], k_b) ) |
//
// over the nc non-coherent blocks j, where S are the per-phase block
// spectra and K the conjugate code spectrum (roll(K, k)[i] = K[(i-k) mod n]).
// The inverse DFT of length n = n1 * n2 is the four-step transform of
// sydr_tpu/ops/fft.py, run in shared memory:
//
//   B[k2][m1] = (1/n) sum_{m2} W2[k2, m2] x[m1 + n1 * m2]     (column DFTs)
//   C[k2][m1] = B[k2][m1] * T[k2, m1]                          (twiddle)
//   D[k2][k1] = sum_{m1} C[k2][m1] W1[m1, k1]                  (row DFTs)
//   X[n2 * k1 + k2] = D[k2][k1]
//
// with W2[k2, m2] = e^{+2 pi i k2 m2 / n2}, W1[m1, k1] = e^{+2 pi i m1 k1 / n1},
// T[k2, m1] = e^{+2 pi i k2 m1 / n}. Every twiddle is read from one table
// tw[t] = e^{+2 pi i t / n} (built in float64 by the wrapper) at an exact
// integer index product reduced mod n, never from an f32 product of angles.
//
// Bound on the H100: the transform costs (n1 + n2) complex multiply-adds
// per output point with both operands read from shared memory, so the
// kernel is bound by shared-memory bandwidth (16 B per multiply-add), not
// by HBM or the FP32 rate: it runs at the rate the SMs' shared memory can
// deliver at all, some 20 times the work of an FFT. It is kept for the
// lengths no radix plan covers. A block keeps the product A and
// the column-DFT output B (8n bytes each), the magnitude accumulator (4n)
// and the n1 + n2 row/column twiddles in shared memory (82.4 KB at
// n = 4070 = 55 x 74), above the 48 KB static limit, so the launcher
// raises the kernel's dynamic shared-memory limit with
// cudaFuncSetAttribute and reports its error.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(kThreads) pcps_bins_fourstep_kernel(
    const float2* __restrict__ spec, const float2* __restrict__ code,
    const float2* __restrict__ tw, const int* __restrict__ shift,
    const int* __restrict__ phase, int n_ch, int nc, int n, int n1, int n2,
    int n_bins, float* __restrict__ out) {
  extern __shared__ float4 smem_raw[];
  float2* a = reinterpret_cast<float2*>(smem_raw);   // [n] product, canonical
  float2* b = a + n;                                  // [n] C[k2][m1]
  float2* w1 = b + n;                                 // [n1]
  float2* w2 = w1 + n1;                               // [n2]
  float* acc = reinterpret_cast<float*>(w2 + n2);     // [n] |D| sum, [k2][k1]

  const int bin = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int k = shift[bin];
  const int p = phase[bin];
  const float inv_n = 1.0f / static_cast<float>(n);

  for (int t = tid; t < n1; t += kThreads) w1[t] = tw[t * n2];
  for (int t = tid; t < n2; t += kThreads) w2[t] = tw[t * n1];
  for (int t = tid; t < n; t += kThreads) acc[t] = 0.0f;

  const float2* kc = code + static_cast<size_t>(c) * n;
  for (int j = 0; j < nc; ++j) {
    const float2* s =
        spec + ((static_cast<size_t>(p) * n_ch + c) * nc + j) * n;
    for (int i = tid; i < n; i += kThreads) {
      int src = i - k;
      src %= n;
      if (src < 0) src += n;
      a[i] = cmul(s[i], kc[src]);
    }
    __syncthreads();

    // Column DFTs over m2, then the twiddle and the 1/n scale.
    for (int o = tid; o < n; o += kThreads) {
      const int k2 = o / n1;
      const int m1 = o - k2 * n1;
      float2 sum = make_float2(0.0f, 0.0f);
      int widx = 0;
      for (int m2 = 0; m2 < n2; ++m2) {
        const float2 x = a[m1 + n1 * m2];
        const float2 w = w2[widx];
        sum.x += w.x * x.x - w.y * x.y;
        sum.y += w.x * x.y + w.y * x.x;
        widx += k2;
        if (widx >= n2) widx -= n2;
      }
      const float2 t = tw[(k2 * m1) % n];
      const float2 r = cmul(sum, t);
      b[o] = make_float2(r.x * inv_n, r.y * inv_n);
    }
    __syncthreads();

    // Row DFTs over m1, magnitude, non-coherent sum.
    for (int o = tid; o < n; o += kThreads) {
      const int k2 = o / n1;
      const int k1 = o - k2 * n1;
      const float2* row = b + k2 * n1;
      float2 sum = make_float2(0.0f, 0.0f);
      int widx = 0;
      for (int m1 = 0; m1 < n1; ++m1) {
        const float2 x = row[m1];
        const float2 w = w1[widx];
        sum.x += x.x * w.x - x.y * w.y;
        sum.y += x.x * w.y + x.y * w.x;
        widx += k1;
        if (widx >= n1) widx -= n1;
      }
      acc[o] += sqrtf(sum.x * sum.x + sum.y * sum.y);
    }
    __syncthreads();
  }

  // Canonical order: X[n2 * k1 + k2] = D[k2][k1].
  float* dst = out + (static_cast<size_t>(c) * n_bins + bin) * n;
  for (int t = tid; t < n; t += kThreads) {
    const int k1 = t / n2;
    const int k2 = t - k1 * n2;
    dst[t] = acc[k2 * n1 + k1];
  }
}

}  // namespace

extern "C" const char* sydr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// spec [n_ph, n_ch, nc, n] complex64, code [n_ch, n] complex64, tw [n]
// complex64, shift / phase [n_bins] int32 (device), out [n_ch, n_bins, n].
extern "C" int pcps_bins_fourstep_launch(
    const void* spec, const void* code, const void* tw, const void* shift,
    const void* phase, int n_ch, int nc, int n, int n1, int n2, int n_bins,
    void* out, void* stream) {
  if (n1 * n2 != n || n1 < 1 || n2 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(n) * (2 * sizeof(float2) +
                                                sizeof(float)) +
                      static_cast<size_t>(n1 + n2) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      pcps_bins_fourstep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_bins, n_ch);
  pcps_bins_fourstep_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), static_cast<const float2*>(code),
      static_cast<const float2*>(tw), static_cast<const int*>(shift),
      static_cast<const int*>(phase), n_ch, nc, n, n1, n2, n_bins,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
