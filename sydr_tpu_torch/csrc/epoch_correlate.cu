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
// The per-sample streams (chip index, carrier mix, their rounding) are the
// shared ones of streams.cuh, so K1 and K3 sum identical values. With
// identical inputs kernel and plain version pick the same chips and differ
// only by summation order and sincosf's last ulp.
//
// Bound on the H100: one block per (epoch, channel) — 640 blocks in the
// cruise shape (20 ms x 32 ch) reading 2500 complex samples each; the work
// is ~1 sincosf + ~10 flops per sample and tap, so the kernel is bound by
// instruction issue and launch latency, not by HBM: every channel reads the
// same window (served from L2) plus one 16.6 KB code row. No atomics: each
// block reduces its own sums (warp shuffles, then shared memory) and stores
// them once, so results are deterministic.

#include "streams.cuh"

namespace {

using sydr::kCodeWidth;
using sydr::kMaxTaps;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) epoch_correlate_kernel(
    const float* __restrict__ win_re, const float* __restrict__ win_im,
    const float* __restrict__ code_bits, const int* __restrict__ c_int,
    const float* __restrict__ omega, const float* __restrict__ code_step,
    const float* __restrict__ fb_q, const float* __restrict__ phic_q,
    const int* __restrict__ bounds, sydr::Taps taps, int n_ch, int n_q,
    int spms, float* __restrict__ out) {
  __shared__ float chips[kCodeWidth];
  __shared__ float partial[kWarps][2 * kMaxTaps];

  const int e = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;

  sydr::load_chips(code_bits, c, chips);
  __syncthreads();

  const int b0 = bounds[e * n_ch + c];
  const int b1 = bounds[(e + 1) * n_ch + c];
  const sydr::Channel ch = sydr::load_channel(
      c, c_int, omega, code_step, fb_q, phic_q, n_q, spms);

  float acc[2 * kMaxTaps];
#pragma unroll
  for (int s = 0; s < 2 * kMaxTaps; ++s) acc[s] = 0.0f;

  for (int m = b0 + tid; m < b1; m += kThreads) {
    float mre, mim;
    sydr::mix_sample(ch, win_re, win_im, m, &mre, &mim);
#pragma unroll
    for (int t = 0; t < kMaxTaps; ++t) {
      if (t < taps.n) {
        const float chip =
            sydr::tap_chip(ch, chips, taps.sp[t], taps.k[t], m);
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
  const sydr::Taps taps = sydr::make_taps(tap_sp, tap_k, n_taps);
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
