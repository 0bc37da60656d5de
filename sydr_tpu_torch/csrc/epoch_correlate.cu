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

#include <stdint.h>

#include "streams.cuh"

namespace {

using sydr::kCodeWidth;
using sydr::kMaxTaps;
constexpr int kMaxWarps = 8;              // warps per block, at most
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kGroup = 4;                 // consecutive samples per thread

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Synchronise the `threads` threads that name barrier `id` (1..15).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// One sample of an edge group: masked to [b0, b1), any millisecond, taps
// that may reach into a neighbouring millisecond.
template <int kTaps>
__device__ __forceinline__ void edge_sample(
    const sydr::Channel& ch, const float* chips, const sydr::Taps& taps,
    int q, int lm, float xr, float xi, sydr::TapRow* row,
    float (&acc)[2 * kTaps]) {
  if (lm >= ch.spms) {   // at most once: the group began inside q
    lm -= ch.spms;
    ++q;
  }
  if (q != row->q) sydr::load_row(ch, taps, q, row);
  const float fl = static_cast<float>(lm);
  float mre, mim;
  sydr::mix_phase(ch, row->ph, fl, xr, xi, &mre, &mim);
  const bool inside = lm + taps.kmin >= 0 && lm + taps.kmax < ch.spms;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const float chip =
        inside ? sydr::tap_chip_row(ch, chips, taps, t, *row, fl)
               : sydr::tap_chip_at(ch, chips, taps, t, q, lm, fl);
    acc[2 * t] += chip * mre;
    acc[2 * t + 1] += chip * mim;
  }
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

  // The channel's code row, once per block: 1040 16-byte loads.
  const float* bits = code_bits + static_cast<size_t>(c) * kCodeWidth;
  if (aligned16(bits)) {
    const float4* bits4 = reinterpret_cast<const float4*>(bits);
    float4* chips4 = reinterpret_cast<float4*>(chips);
    for (int i = tid; i < kCodeWidth / 4; i += blockDim.x) {
      const float4 b = __ldg(bits4 + i);
      chips4[i] = make_float4(2.0f * b.x - 1.0f, 2.0f * b.y - 1.0f,
                              2.0f * b.z - 1.0f, 2.0f * b.w - 1.0f);
    }
  } else {
    sydr::load_chips(code_bits, c, chips);
  }
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

  // Groups of kGroup samples that start on 16-byte addresses of both
  // planes; the first group may begin before b0 (masked).
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(win_re) >> 2) & (kGroup - 1));
  const bool vec = mis == static_cast<int>(
      (reinterpret_cast<uintptr_t>(win_im) >> 2) & (kGroup - 1));
  const int stride = warps_per_epoch * 32 * kGroup;
  int g = ((b0 + mis) & ~(kGroup - 1)) - mis + (w_in * 32 + lane) * kGroup;
  int q = g > 0 ? g / spms : 0;
  int lm = g - q * spms;   // negative only for masked samples before 0
  sydr::TapRow row;
  row.q = -1;
  for (; g < b1; g += stride) {
    // Interior: the whole group inside the epoch and inside one
    // millisecond, taps included (kmin <= 0 <= kmax): no masks, no
    // branches, four independent sincosf chains.
    if (vec && g >= b0 && g + kGroup <= b1 && lm + taps.kmin >= 0 &&
        lm + kGroup - 1 + taps.kmax < spms) {
      if (q != row.q) sydr::load_row(ch, taps, q, &row);
      const float4 r4 = __ldg(reinterpret_cast<const float4*>(win_re + g));
      const float4 i4 = __ldg(reinterpret_cast<const float4*>(win_im + g));
      const float xr[kGroup] = {r4.x, r4.y, r4.z, r4.w};
      const float xi[kGroup] = {i4.x, i4.y, i4.z, i4.w};
      const float fl0 = static_cast<float>(lm);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        // exact: float(lm + i)
        const float fl = __fadd_rn(fl0, static_cast<float>(i));
        float mre, mim;
        sydr::mix_phase(ch, row.ph, fl, xr[i], xi[i], &mre, &mim);
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          const float chip = sydr::tap_chip_row(ch, chips, taps, t, row, fl);
          acc[2 * t] += chip * mre;
          acc[2 * t + 1] += chip * mim;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int m = g + i;
        if (m >= b0 && m < b1) {
          edge_sample<kTaps>(ch, chips, taps, q, lm + i, win_re[m], win_im[m],
                             &row, acc);
        }
      }
    }
    lm += stride;
    while (lm >= spms) {
      lm -= spms;
      ++q;
    }
  }

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
      spms < kGroup || warps_per_epoch < 1 || epochs_per_block < 1 ||
      warps_per_epoch * epochs_per_block > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const sydr::Taps taps = sydr::make_taps(tap_sp, tap_k, n_taps);
  const dim3 grid((block_ms + epochs_per_block - 1) / epochs_per_block, n_ch);
  const int threads = 32 * warps_per_epoch * epochs_per_block;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SYDR_LAUNCH(kTaps)                                                   \
  epoch_correlate_kernel<kTaps><<<grid, threads, 0, st>>>(                   \
      static_cast<const float*>(win_re), static_cast<const float*>(win_im),  \
      static_cast<const float*>(code_bits), static_cast<const int*>(c_int),  \
      static_cast<const float*>(omega),                                      \
      static_cast<const float*>(code_step),                                  \
      static_cast<const float*>(fb_q), static_cast<const float*>(phic_q),    \
      static_cast<const int*>(bounds), taps, block_ms, n_ch, n_q, spms,      \
      warps_per_epoch, static_cast<float*>(out))
  switch (n_taps) {   // the tap loops are unrolled for the count in use
    case 1: SYDR_LAUNCH(1); break;
    case 2: SYDR_LAUNCH(2); break;
    case 3: SYDR_LAUNCH(3); break;
    case 4: SYDR_LAUNCH(4); break;
    default: SYDR_LAUNCH(5); break;
  }
#undef SYDR_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
