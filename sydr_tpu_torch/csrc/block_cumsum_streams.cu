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
// (46 MB in the cruise shape, 184 MB at full rate), written once; the work
// per sample is ~1 sincosf + ~10 flops per tap, far below the card's rate.
// (Measured, it writes at ~0.4-0.5 TB/s, well short of HBM's 3.35 TB/s:
// at these sizes the doubled stream build and two launches still weigh
// more than the write. PERF.md has the times.) Blocks run in no order, so
// no carry can cross them as the TPU's sequential grid did. Design, two
// launches, no atomics, deterministic:
//   1. totals: grid (n_chunks, n_ch); each block builds the streams of
//      its 1024-sample chunk and stores only the chunk's sums (nothing per
//      sample reaches memory);
//   2. prefix: the same grid builds the streams again (cheap: compute is
//      not the bound), scans the chunk in the same order, adds the sum of
//      the earlier chunks' totals (a fixed-order block reduction over the
//      totals of launch 1) and writes each sample's prefix once.
// Within a chunk each thread takes 4 consecutive samples (a sequential
// prefix), warps scan the thread sums with shuffles, and each warp adds
// the earlier warps' sums in a fixed order; so the scan order differs
// from torch.cumsum's, by float32 rounding only.

#include "streams.cuh"

namespace {

using sydr::kCodeWidth;
using sydr::kMaxTaps;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                   // consecutive samples per thread
constexpr int kChunk = kThreads * kItems;   // samples per block
constexpr int kMaxStreams = 2 * kMaxTaps;

// kWrite false: store the chunk's stream sums into totals[c, s, chunk].
// kWrite true: write out[c, s, m] = prefix over [0, m], with the earlier
// chunks' sums taken from totals.
template <bool kWrite>
__global__ void __launch_bounds__(kThreads) cumsum_kernel(
    const float* __restrict__ win_re, const float* __restrict__ win_im,
    const float* __restrict__ code_bits, const int* __restrict__ c_int,
    const float* __restrict__ omega, const float* __restrict__ code_step,
    const float* __restrict__ fb_q, const float* __restrict__ phic_q,
    sydr::Taps taps, int n_q, int spms, int n_win, int n_chunks,
    float* __restrict__ totals, float* __restrict__ out) {
  __shared__ float chips[kCodeWidth];
  __shared__ float warp_sum[kWarps][kMaxStreams];
  __shared__ float carry[kMaxStreams];

  const int j = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_streams = 2 * taps.n;
  float* tot = totals + static_cast<size_t>(c) * n_streams * n_chunks;

  sydr::load_chips(code_bits, c, chips);
  if (kWrite) {
    // Sum of the earlier chunks' totals: per-thread strided sums, then
    // warp shuffles, then the warps in order.
    float part[kMaxStreams];
#pragma unroll
    for (int s = 0; s < kMaxStreams; ++s) {
      part[s] = 0.0f;
      if (s < n_streams) {
        for (int i = tid; i < j; i += kThreads) {
          part[s] += tot[static_cast<size_t>(s) * n_chunks + i];
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        part[s] += __shfl_down_sync(0xffffffffu, part[s], off);
      }
      if (lane == 0) warp_sum[warp][s] = part[s];
    }
    __syncthreads();
    if (tid < kMaxStreams) {
      float sum = 0.0f;
      for (int w = 0; w < kWarps; ++w) sum += warp_sum[w][tid];
      carry[tid] = sum;
    }
  }
  __syncthreads();

  const sydr::Channel ch = sydr::load_channel(
      c, c_int, omega, code_step, fb_q, phic_q, n_q, spms);
  const int m0 = j * kChunk + tid * kItems;

  // Thread-local inclusive prefix of its kItems samples.
  float loc[kItems][kMaxStreams];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int m = m0 + i;
    float mre = 0.0f, mim = 0.0f;
    if (m < n_win) sydr::mix_sample(ch, win_re, win_im, m, &mre, &mim);
#pragma unroll
    for (int t = 0; t < kMaxTaps; ++t) {
      float v_re = 0.0f, v_im = 0.0f;
      if (t < taps.n && m < n_win) {
        const float chip =
            sydr::tap_chip(ch, chips, taps, t, m);
        v_re = chip * mre;
        v_im = chip * mim;
      }
      loc[i][2 * t] = i == 0 ? v_re : loc[i - 1][2 * t] + v_re;
      loc[i][2 * t + 1] = i == 0 ? v_im : loc[i - 1][2 * t + 1] + v_im;
    }
  }

  // Exclusive offset of each thread within the chunk.
  float offset[kMaxStreams];
#pragma unroll
  for (int s = 0; s < kMaxStreams; ++s) {
    float incl = loc[kItems - 1][s];
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    const float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    offset[s] = lane == 0 ? 0.0f : excl;
    if (lane == 31) warp_sum[warp][s] = incl;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kMaxStreams; ++s) {
    float before = 0.0f;
    for (int w = 0; w < warp; ++w) before += warp_sum[w][s];
    offset[s] = before + offset[s];
  }

  if (!kWrite) {
    if (tid == kThreads - 1) {
#pragma unroll
      for (int s = 0; s < kMaxStreams; ++s) {
        if (s < n_streams) {
          tot[static_cast<size_t>(s) * n_chunks + j] =
              offset[s] + loc[kItems - 1][s];
        }
      }
    }
    return;
  }

  const bool vec = n_win % kItems == 0;   // rows 16-byte aligned
#pragma unroll
  for (int s = 0; s < kMaxStreams; ++s) {
    if (s >= n_streams) break;
    float* row = out + (static_cast<size_t>(c) * n_streams + s) * n_win;
    float v[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      v[i] = (offset[s] + loc[i][s]) + carry[s];
    }
    if (vec && m0 < n_win) {
      *reinterpret_cast<float4*>(row + m0) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (m0 + i < n_win) row[m0 + i] = v[i];
      }
    }
  }
}

}  // namespace

extern "C" const char* sydr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out [n_ch, 2 * n_taps, n_win]: inclusive prefix over window samples;
// totals [n_ch, 2 * n_taps, n_chunks] scratch, n_chunks = ceil(n_win /
// 1024); tap_sp / tap_k are host arrays of n_taps entries.
extern "C" int block_cumsum_streams_launch(
    const void* win_re, const void* win_im, const void* code_bits,
    const void* c_int, const void* omega, const void* code_step,
    const void* fb_q, const void* phic_q, const float* tap_sp,
    const int* tap_k, int n_taps, int n_ch, int n_q, int spms, int n_win,
    int n_chunks, void* totals, void* out, void* stream) {
  if (n_taps < 1 || n_taps > kMaxTaps || n_win < 1
      || n_chunks != (n_win + kChunk - 1) / kChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const sydr::Taps taps = sydr::make_taps(tap_sp, tap_k, n_taps);
  const dim3 grid(n_chunks, n_ch);
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
  cumsum_kernel<false><<<grid, kThreads, 0, st>>>(
      wre, wim, bits, ci, om, step, fb, ph, taps, n_q, spms, n_win,
      n_chunks, tot, nullptr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cumsum_kernel<true><<<grid, kThreads, 0, st>>>(
      wre, wim, bits, ci, om, step, fb, ph, taps, n_q, spms, n_win,
      n_chunks, tot, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
