// K1 epoch_correlate: per-epoch E/P/L correlators of the batched tracking
// runtime, straight from the sample window and the code table.
//
// Replaces the Pallas kernel sydr_tpu/ops/correlator_kernel.py
// (_kernel_rowsum, launched by block_rowsum_streams) together with the XLA
// boundary recompute that turned its 128-sample row totals into per-epoch
// sums (batch_runtime._rowsum_boundary_prefix). Both existed because Mosaic
// has no gather: chips had to be rebuilt from packed words and epochs split
// at row granularity. Here a block reads its chips from the channel's code
// row in shared memory and sums exactly between the epoch bounds.
//
// The per-sample streams (chip index, carrier mix, their rounding) are the
// shared ones of streams.cuh, so K1 and K3 sum identical values. With
// identical inputs kernel and plain version pick the same chips and differ
// only by summation order and sincosf's last ulp.
//
// Bound on the H100: by operations, and far below a launch's own cost: one
// accurate sincosf and ~8 flops per tap for each of n_ch x (samples of the
// block) pairs, ~0.1 GFLOP in the cruise shape (32 ch x 50,000 samples),
// against ~1 MB of input that every channel shares through L2. What the
// kernel pays for is its opcode count and latency: the prologue (the
// code row), the chain of samples per thread, the epilogue (the
// reduction). Design:
//   * one block serves ONE channel over several epochs (epochs_per_block,
//     chosen by the wrapper so that the grid still covers the card): the
//     4160-chip code row is loaded once per block with 16-byte loads and
//     kept as +/-1 floats in shared memory; its barrier is the only
//     block-wide one;
//   * each epoch belongs to a fixed set of warps (warps_per_epoch): its
//     reduction is warp shuffles, one shared-memory row per warp and a
//     named barrier among those warps only, so the epochs of a block never
//     wait for each other;
//   * a thread takes 4 consecutive samples at a time, laid on 16-byte
//     addresses of the window planes (whatever the window's offset). An
//     interior group (inside the epoch and inside one millisecond, taps
//     included) is one 16-byte load per plane and straight-line code: no
//     mask, no division, the millisecond's anchors (carrier phase, each
//     tap's fb + sp) held in registers, four independent sincosf chains,
//     the tap loop unrolled for the tap count (a template parameter). The
//     groups on an epoch's or a millisecond's edge go sample by sample
//     through the general path;
//   * per sample one int-to-float conversion and per tap one float-to-int
//     (streams.cuh), where the first version spent four per tap, and no
//     integer division at all (one per tap and sample before);
//   * no atomics, fixed summation order: thread-strided partial sums, a
//     shuffle tree, then the epoch's warps in order. Deterministic.
// Grids (the wrapper's launch_shape): cruise 2.5 Msps x 20 ms x 32 ch:
// (10, 32) blocks of 2 epochs x 4 warps; pull-in 5 ms: (5, 32) blocks of
// 1 epoch x 8 warps; at 10 Msps an epoch takes all 8 warps of a block and
// the grid is (20, 32) = 640 blocks of 256 threads, some 38 warps an SM.
// The accurate sincosf stays: a __sincosf (MUFU) variant was tried on the
// card and was somewhat faster with the kernel-vs-plain error unchanged in
// its leading digits, too little to give up the last ulp for.

#include "streams.cuh"

namespace {

using sydr::kCodeWidth;
using sydr::kMaxTaps;
constexpr int kMaxWarps = 8;              // warps per block, at most
constexpr int kMaxThreads = 32 * kMaxWarps;

// Synchronise the `threads` threads that name barrier `id` (1..15).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int kTaps>
__global__ void __launch_bounds__(kMaxThreads) epoch_correlate_kernel(
    const float* __restrict__ win_re, const float* __restrict__ win_im,
    const float* __restrict__ code_bits, const int* __restrict__ c_int,
    const float* __restrict__ omega, const float* __restrict__ code_step,
    const float* __restrict__ fb_q, const float* __restrict__ phic_q,
    const int* __restrict__ bounds, sydr::Taps taps, int n_epochs, int n_ch,
    int n_q, int spms, int warps_per_epoch, float* __restrict__ out) {
  __shared__ __align__(16) float chips[kCodeWidth];
  __shared__ float partial[kMaxWarps][2 * kTaps];

  const int c = blockIdx.y;
  const int tid = threadIdx.x;

  // The channel's code row, once per block.
  sydr::load_chips(code_bits, c, chips);
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int e_local = warp / warps_per_epoch;
  const int w_in = warp - e_local * warps_per_epoch;
  const int epochs_per_block = (blockDim.x >> 5) / warps_per_epoch;
  const int e = blockIdx.x * epochs_per_block + e_local;
  if (e >= n_epochs) return;   // all warps of an epoch leave together

  const int b0 = bounds[e * n_ch + c];
  const int b1 = bounds[(e + 1) * n_ch + c];
  const sydr::Channel ch = sydr::load_channel(
      c, c_int, omega, code_step, fb_q, phic_q, n_q, spms);

  float acc[2 * kTaps];
#pragma unroll
  for (int s = 0; s < 2 * kTaps; ++s) acc[s] = 0.0f;

  sydr::accumulate_range<kTaps>(ch, chips, taps, win_re, win_im, b0, b1,
                                w_in * 32 + lane, warps_per_epoch * 32, acc);

  // The epoch's sums: a shuffle tree per warp, then its warps in order.
  constexpr int kStreams = 2 * kTaps;
#pragma unroll
  for (int s = 0; s < kStreams; ++s) {
    float v = acc[s];
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) partial[warp][s] = v;
  }
  named_barrier(1 + e_local, warps_per_epoch * 32);
  if (w_in == 0 && lane < kStreams) {
    float total = 0.0f;
    for (int w = 0; w < warps_per_epoch; ++w) total += partial[warp + w][lane];
    out[(static_cast<size_t>(e) * n_ch + c) * kStreams + lane] = total;
  }
}

}  // namespace

extern "C" const char* sydr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[e, c, 2t + {0: I, 1: Q}] for e < block_ms; bounds is
// [block_ms + 1, n_ch]; tap_sp / tap_k are host arrays of n_taps entries.
// A block holds epochs_per_block epochs of one channel, warps_per_epoch
// warps each (their product at most 8).
extern "C" int epoch_correlate_launch(
    const void* win_re, const void* win_im, const void* code_bits,
    const void* c_int, const void* omega, const void* code_step,
    const void* fb_q, const void* phic_q, const void* bounds,
    const float* tap_sp, const int* tap_k, int n_taps, int block_ms,
    int n_ch, int n_q, int spms, int warps_per_epoch, int epochs_per_block,
    void* out, void* stream) {
  if (n_taps < 1 || n_taps > kMaxTaps || block_ms < 1 || n_ch < 1 ||
      spms < sydr::kGroup || warps_per_epoch < 1 || epochs_per_block < 1 ||
      warps_per_epoch * epochs_per_block > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const sydr::Taps taps = sydr::make_taps(tap_sp, tap_k, n_taps);
  const dim3 grid((block_ms + epochs_per_block - 1) / epochs_per_block, n_ch);
  const int threads = 32 * warps_per_epoch * epochs_per_block;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SYDR_TAPS_SWITCH(
      n_taps, epoch_correlate_kernel<kTaps><<<grid, threads, 0, st>>>(
      static_cast<const float*>(win_re), static_cast<const float*>(win_im),
      static_cast<const float*>(code_bits), static_cast<const int*>(c_int),
      static_cast<const float*>(omega), static_cast<const float*>(code_step),
      static_cast<const float*>(fb_q), static_cast<const float*>(phic_q),
      static_cast<const int*>(bounds), taps, block_ms, n_ch, n_q, spms,
      warps_per_epoch, static_cast<float*>(out)));
  return static_cast<int>(cudaGetLastError());
}
