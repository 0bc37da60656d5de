// K1 epoch_correlate: per-epoch E/P/L correlators of the batched tracking
// runtime, straight from the sample window and the code table.
//
// Replaces the Pallas kernel sydr_tpu/ops/correlator_kernel.py
// (_kernel_rowsum, launched by block_rowsum_streams) together with the XLA
// boundary recompute that turned its 128-sample row totals into per-epoch
// sums (batch_runtime._rowsum_boundary_prefix). Both existed because Mosaic
// has no gather: chips had to be rebuilt from packed words and epochs split
// at row granularity. Here a block reads its chips from the channel's code
// table in shared memory and sums exactly between the epoch bounds.
//
// Semantics (those of batch_runtime.dense_streams + the boundary
// differences): window sample m lies in millisecond q = m / spms at offset
// lm = m - q * spms; carrier wipe-off by phic_q[q] - omega * lm; the chip
// of tap t is the code bit at c_int + ceil(fb_q[q'] + sp_t + lm' * step),
// evaluated at sample m' = m + k_t with the anchors of the millisecond m'
// falls in (q' = min(m' / spms, n_q - 1), so the lookahead past the window
// continues the last millisecond's anchors linearly).
//
// Rounding: the chip index is a ceil of an f32 expression, so a sample that
// lies within rounding of an integer chip boundary flips chips if the
// arithmetic rounds differently. The index r + lm' * step and the carrier
// phase phic - omega * lm are each ONE fused multiply-add (__fmaf_rn, a
// single rounding), the form XLA's CPU backend gives the JAX reference;
// r = fb + sp is one __fadd_rn. The plain version computes the same fused
// values (float64 product and sum, rounded once to float32), so with
// identical inputs kernel and plain version pick the same chips and differ
// only by summation order and sincosf's last ulp. nvcc's default FMA
// contraction cannot change these: every rounding step is explicit.
//
// Bound on the H100: one block per (epoch, channel) — 640 blocks in the
// cruise shape (20 ms x 32 ch) reading 2500 complex samples each; the work
// is ~1 sincosf + ~10 flops per sample and tap, so the kernel is bound by
// instruction issue and launch latency, not by HBM: every channel reads the
// same window (served from L2) plus one 16.6 KB code row. No atomics: each
// block reduces its own sums (warp shuffles, then shared memory) and stores
// them once, so results are deterministic.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxTaps = 5;
constexpr int kCodeWidth = 4160;   // tiled_code_bits row: chip u at 1023 + u
constexpr int kCodeOrigin = 1023;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Taps {
  float sp[kMaxTaps];   // tap spacing [chips]
  int k[kMaxTaps];      // tap sample shift
  int n;
};

__global__ void __launch_bounds__(kThreads) epoch_correlate_kernel(
    const float* __restrict__ win_re, const float* __restrict__ win_im,
    const float* __restrict__ code_bits, const int* __restrict__ c_int,
    const float* __restrict__ omega, const float* __restrict__ code_step,
    const float* __restrict__ fb_q, const float* __restrict__ phic_q,
    const int* __restrict__ bounds, Taps taps, int n_ch, int n_q, int spms,
    float* __restrict__ out) {
  __shared__ float chips[kCodeWidth];
  __shared__ float partial[kWarps][2 * kMaxTaps];

  const int e = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;

  const float* bits = code_bits + static_cast<size_t>(c) * kCodeWidth;
  for (int i = tid; i < kCodeWidth; i += kThreads) {
    chips[i] = 2.0f * bits[i] - 1.0f;
  }
  __syncthreads();

  const int b0 = bounds[e * n_ch + c];
  const int b1 = bounds[(e + 1) * n_ch + c];
  const float om = omega[c];
  const float step = code_step[c];
  const int origin = kCodeOrigin + c_int[c];
  const float* fb = fb_q + static_cast<size_t>(c) * n_q;
  const float* ph = phic_q + static_cast<size_t>(c) * n_q;

  float acc[2 * kMaxTaps];
#pragma unroll
  for (int s = 0; s < 2 * kMaxTaps; ++s) acc[s] = 0.0f;

  for (int m = b0 + tid; m < b1; m += kThreads) {
    const int q = m / spms;
    const int lm = m - q * spms;
    const float phase = __fmaf_rn(-om, static_cast<float>(lm), ph[q]);
    float sn, cs;
    sincosf(phase, &sn, &cs);
    const float xr = win_re[m];
    const float xi = win_im[m];
    const float mre = __fsub_rn(__fmul_rn(cs, xr), __fmul_rn(sn, xi));
    const float mim = __fadd_rn(__fmul_rn(cs, xi), __fmul_rn(sn, xr));
#pragma unroll
    for (int t = 0; t < kMaxTaps; ++t) {
      if (t < taps.n) {
        const int mk = m + taps.k[t];
        const int qk = min(mk / spms, n_q - 1);
        const int lk = mk - qk * spms;
        const float r = __fadd_rn(fb[qk], taps.sp[t]);
        const int idx = static_cast<int>(
            ceilf(__fmaf_rn(static_cast<float>(lk), step, r)));
        const int pos = min(max(origin + idx, 0), kCodeWidth - 1);
        const float chip = chips[pos];
        acc[2 * t] += chip * mre;
        acc[2 * t + 1] += chip * mim;
      }
    }
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int s = 0; s < 2 * kMaxTaps; ++s) {
    float v = acc[s];
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) partial[warp][s] = v;
  }
  __syncthreads();

  const int n_streams = 2 * taps.n;
  if (tid < n_streams) {
    float total = 0.0f;
    for (int w = 0; w < kWarps; ++w) total += partial[w][tid];
    out[(static_cast<size_t>(e) * n_ch + c) * n_streams + tid] = total;
  }
}

}  // namespace

extern "C" const char* sydr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[e, c, 2t + {0: I, 1: Q}] for e < block_ms; bounds is
// [block_ms + 1, n_ch]; tap_sp / tap_k are host arrays of n_taps entries.
extern "C" int epoch_correlate_launch(
    const void* win_re, const void* win_im, const void* code_bits,
    const void* c_int, const void* omega, const void* code_step,
    const void* fb_q, const void* phic_q, const void* bounds,
    const float* tap_sp, const int* tap_k, int n_taps, int block_ms,
    int n_ch, int n_q, int spms, void* out, void* stream) {
  if (n_taps < 1 || n_taps > kMaxTaps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps taps;
  for (int t = 0; t < kMaxTaps; ++t) {
    taps.sp[t] = t < n_taps ? tap_sp[t] : 0.0f;
    taps.k[t] = t < n_taps ? tap_k[t] : 0;
  }
  taps.n = n_taps;
  const dim3 grid(block_ms, n_ch);
  epoch_correlate_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(win_re), static_cast<const float*>(win_im),
      static_cast<const float*>(code_bits), static_cast<const int*>(c_int),
      static_cast<const float*>(omega), static_cast<const float*>(code_step),
      static_cast<const float*>(fb_q), static_cast<const float*>(phic_q),
      static_cast<const int*>(bounds), taps, n_ch, n_q, spms,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
