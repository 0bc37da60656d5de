// K3 block_cumsum_streams: the full per-sample inclusive prefix of every
// correlation stream of the batched tracking runtime (the prefix boundary
// form, TrackingConfig.boundary_mode = "prefix").
//
// Replaces the Pallas kernel sydr_tpu/ops/correlator_kernel.py
// (_kernel with _sub_streams, launched by block_cumsum_streams). That
// kernel walked the window in order on one TensorCore, carried each
// channel's running sums across super-chunks in SMEM, and formed the lane
// prefix as a bf16 triangular matmul on the MXU (Mosaic has no cumsum).
// Here out[c, s, t] = sum of stream s of channel c over window samples
// [0, t], accumulated in float32 from the same per-sample values K1 sums
// (streams.cuh): no bf16 rounding, no padding of the window.
//
// Bound on the H100: by bytes, the output, n_ch x n_streams x n_win float32
// (46 MB in the cruise shape, 184 MB at full rate), written once. The work
// per sample (one sincosf, ~10 operations a tap, the scan) is far below
// the card's rate in flops but not in instruction slots: at 32 channels x
// 60,000 samples it takes about as long as the write itself, so whatever
// is done twice, or once per block where once per channel would do, shows
// (on an H100 80GB HBM3 at 700 W the two launches take 0.013 + 0.028 ms
// there and the stores alone 0.018; PERF.md has every shape). Blocks run
// in no order, so no carry can cross them as the TPU's sequential grid
// did.
// Design, two launches, no atomics, every sum in a fixed order:
//   * a block owns one channel and a SEGMENT of seg_chunks consecutive
//     chunks of 1024 samples (the wrapper's cumsum_shape sizes the grid
//     (n_seg, n_ch) to about one block for each block the card holds at
//     once). It loads the channel's 4160-chip code row once, with 16-byte
//     loads, where the first version loaded it once per 1024 samples;
//   * each of the block's 8 warps owns a RUN, a contiguous eighth of the
//     segment (128 seg_chunks samples), and after the code row's barrier
//     never waits for another warp: no shared memory and no barrier in the
//     scan, where the first version paid both once per 1024 samples;
//   * launch 1, totals: each warp sums its run's streams exactly as K1
//     sums an epoch (streams.cuh accumulate_range: no per-sample state,
//     no scan) and stores 2 n_taps floats;
//   * launch 2, prefix: each warp adds the totals of the runs before its
//     own in index order (one lane a stream, at most 8 n_seg - 1
//     additions), then walks its run in steps of 128 samples and carries
//     the running sum in registers. In a step a lane takes 4 consecutive
//     samples (a sequential prefix, one 16-byte store a stream) and the
//     warp scans its lanes' sums with shuffles;
//   * per-sample values by K1's row-wise path: a group of 4 samples that
//     lies inside one millisecond, taps included, is straight-line code
//     from the millisecond's anchors in registers (no division, no anchor
//     loads); the groups on a millisecond's or the window's edge go sample
//     by sample through the general path. (q, lm) are carried from step to
//     step, not divided out;
//   * the tap loops are unrolled for the tap count (a template parameter),
//     so the cruise's 3 taps keep 24 per-sample values a thread, not 40.
// The scan order differs from torch.cumsum's, by float32 rounding only; it
// is the same from run to run.

#include "streams.cuh"

namespace {

using sydr::kCodeWidth;
using sydr::kGroup;
using sydr::kMaxTaps;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 32 * kGroup;          // samples of one warp step
constexpr int kChunk = kWarps * kStep;      // a segment is seg_chunks of these

// totals[c, run, s] = sum of stream s of channel c over the run's samples;
// run = 8 * segment + warp.
template <int kTaps>
__global__ void __launch_bounds__(kThreads) totals_kernel(
    const float* __restrict__ win_re, const float* __restrict__ win_im,
    const float* __restrict__ code_bits, const int* __restrict__ c_int,
    const float* __restrict__ omega, const float* __restrict__ code_step,
    const float* __restrict__ fb_q, const float* __restrict__ phic_q,
    sydr::Taps taps, int n_q, int spms, int n_win, int seg_chunks,
    float* __restrict__ totals) {
  constexpr int kStreams = 2 * kTaps;
  __shared__ __align__(16) float chips[kCodeWidth];

  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int run = blockIdx.x * kWarps + (threadIdx.x >> 5);

  sydr::load_chips(code_bits, c, chips);
  __syncthreads();
  const sydr::Channel ch = sydr::load_channel(
      c, c_int, omega, code_step, fb_q, phic_q, n_q, spms);
  const int run_len = seg_chunks * kStep;
  const int b0 = min(run * run_len, n_win);
  const int b1 = min(b0 + run_len, n_win);

  float acc[kStreams];
#pragma unroll
  for (int s = 0; s < kStreams; ++s) acc[s] = 0.0f;
  sydr::accumulate_range<kTaps>(ch, chips, taps, win_re, win_im, b0, b1, lane,
                                32, acc);
  float* tot =
      totals + (static_cast<size_t>(c) * gridDim.x * kWarps + run) * kStreams;
#pragma unroll
  for (int s = 0; s < kStreams; ++s) {
    float v = acc[s];
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) tot[s] = v;
  }
}

// out[c, s, m] = prefix of stream s of channel c over samples [0, m], for
// the m of each warp's run, with the earlier runs' sums taken from totals.
template <int kTaps>
__global__ void __launch_bounds__(kThreads) prefix_kernel(
    const float* __restrict__ win_re, const float* __restrict__ win_im,
    const float* __restrict__ code_bits, const int* __restrict__ c_int,
    const float* __restrict__ omega, const float* __restrict__ code_step,
    const float* __restrict__ fb_q, const float* __restrict__ phic_q,
    sydr::Taps taps, int n_q, int spms, int n_win, int seg_chunks,
    const float* __restrict__ totals, float* __restrict__ out) {
  constexpr int kStreams = 2 * kTaps;
  __shared__ __align__(16) float chips[kCodeWidth];

  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int run = blockIdx.x * kWarps + (threadIdx.x >> 5);

  sydr::load_chips(code_bits, c, chips);
  // The earlier runs' totals, in index order: lane s sums stream s.
  float before = 0.0f;
  if (lane < kStreams) {
    const float* tot =
        totals + static_cast<size_t>(c) * gridDim.x * kWarps * kStreams + lane;
    for (int i = 0; i < run; ++i) before += tot[i * kStreams];
  }
  __syncthreads();
  const sydr::Channel ch = sydr::load_channel(
      c, c_int, omega, code_step, fb_q, phic_q, n_q, spms);

  float carry[kStreams];   // the prefix at the end of the previous step
#pragma unroll
  for (int s = 0; s < kStreams; ++s) {
    carry[s] = __shfl_sync(0xffffffffu, before, s);
  }

  const bool vec_in = sydr::aligned16(win_re) && sydr::aligned16(win_im);
  const bool vec_out = n_win % kGroup == 0 && sydr::aligned16(out);
  float* row0 = out + static_cast<size_t>(c) * kStreams * n_win;
  const int run_start = run * seg_chunks * kStep;
  int m0 = run_start + lane * kGroup;
  int q = m0 / spms;
  int lm = m0 - q * spms;
  sydr::TapRow row;
  row.q = -1;

  for (int k = 0; k < seg_chunks && run_start + k * kStep < n_win; ++k) {
    // The lane's kGroup samples of every stream, then their sequential
    // prefix.
    float v[kGroup][kStreams];
    if (m0 + kGroup <= n_win && sydr::group_inside(ch, taps, lm)) {
      if (q != row.q) sydr::load_row(ch, taps, q, &row);
      float xr[kGroup], xi[kGroup];
      if (vec_in) {
        const float4 r4 = __ldg(reinterpret_cast<const float4*>(win_re + m0));
        const float4 i4 = __ldg(reinterpret_cast<const float4*>(win_im + m0));
        xr[0] = r4.x; xr[1] = r4.y; xr[2] = r4.z; xr[3] = r4.w;
        xi[0] = i4.x; xi[1] = i4.y; xi[2] = i4.z; xi[3] = i4.w;
      } else {
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          xr[i] = __ldg(win_re + m0 + i);
          xi[i] = __ldg(win_im + m0 + i);
        }
      }
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
          v[i][2 * t] = chip * mre;
          v[i][2 * t + 1] = chip * mim;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int m = m0 + i;
#pragma unroll
        for (int s = 0; s < kStreams; ++s) v[i][s] = 0.0f;
        if (m < n_win) {
          sydr::edge_sample<kTaps>(
              ch, chips, taps, q, lm + i, win_re[m], win_im[m], &row,
              [&v, i](int t, float chip, float mre, float mim) {
                v[i][2 * t] = chip * mre;
                v[i][2 * t + 1] = chip * mim;
              });
        }
      }
    }
#pragma unroll
    for (int i = 1; i < kGroup; ++i) {
#pragma unroll
      for (int s = 0; s < kStreams; ++s) v[i][s] += v[i - 1][s];
    }

    const bool full = vec_out && m0 + kGroup <= n_win;
#pragma unroll
    for (int s = 0; s < kStreams; ++s) {
      // The lanes' sums scanned across the warp; the prefix before this
      // lane's samples; the step's sum onto the carry.
      float incl = v[kGroup - 1][s];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      const float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      const float base = lane == 0 ? carry[s] : carry[s] + excl;
      carry[s] += __shfl_sync(0xffffffffu, incl, 31);
      float* dst = row0 + static_cast<size_t>(s) * n_win + m0;
      if (full) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(base + v[0][s], base + v[1][s], base + v[2][s],
                        base + v[3][s]);
      } else {
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (m0 + i < n_win) dst[i] = base + v[i][s];
        }
      }
    }

    m0 += kStep;
    lm += kStep;
    while (lm >= spms) {
      lm -= spms;
      ++q;
    }
  }
}

}  // namespace

extern "C" const char* sydr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out [n_ch, 2 * n_taps, n_win]: inclusive prefix over window samples;
// totals [n_ch, 8 n_seg, 2 * n_taps] scratch, n_seg = ceil(n_win / (1024
// seg_chunks)) segments of seg_chunks chunks of 1024 samples; tap_sp /
// tap_k are host arrays of n_taps entries. `launches` selects what runs:
// 1 the totals launch, 2 the prefix launch (it reads totals), 3 both, as
// the wrapper asks; the parts alone are for timing them.
extern "C" int block_cumsum_streams_launch(
    const void* win_re, const void* win_im, const void* code_bits,
    const void* c_int, const void* omega, const void* code_step,
    const void* fb_q, const void* phic_q, const float* tap_sp,
    const int* tap_k, int n_taps, int n_ch, int n_q, int spms, int n_win,
    int seg_chunks, int n_seg, int launches, void* totals, void* out,
    void* stream) {
  if (n_taps < 1 || n_taps > kMaxTaps || n_win < 1 || n_ch < 1 ||
      spms < kGroup || seg_chunks < 1 ||
      n_seg != (n_win + seg_chunks * kChunk - 1) / (seg_chunks * kChunk) ||
      launches < 1 || launches > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const sydr::Taps taps = sydr::make_taps(tap_sp, tap_k, n_taps);
  const dim3 grid(n_seg, n_ch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wre = static_cast<const float*>(win_re);
  const float* wim = static_cast<const float*>(win_im);
  const float* bits = static_cast<const float*>(code_bits);
  const int* ci = static_cast<const int*>(c_int);
  const float* om = static_cast<const float*>(omega);
  const float* step = static_cast<const float*>(code_step);
  const float* fb = static_cast<const float*>(fb_q);
  const float* ph = static_cast<const float*>(phic_q);
  float* tot = static_cast<float*>(totals);
  if (launches & 1) {
    SYDR_TAPS_SWITCH(n_taps, totals_kernel<kTaps><<<grid, kThreads, 0, st>>>(
        wre, wim, bits, ci, om, step, fb, ph, taps, n_q, spms, n_win,
        seg_chunks, tot));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (launches & 2) {
    SYDR_TAPS_SWITCH(n_taps, prefix_kernel<kTaps><<<grid, kThreads, 0, st>>>(
        wre, wim, bits, ci, om, step, fb, ph, taps, n_q, spms, n_win,
        seg_chunks, tot, static_cast<float*>(out)));
  }
  return static_cast<int>(cudaGetLastError());
}
