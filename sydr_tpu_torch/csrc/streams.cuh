// Per-sample correlation streams of the batched tracking runtime, shared
// by K1 (epoch_correlate.cu, per-epoch sums) and K3
// (block_cumsum_streams.cu, per-sample inclusive prefix), so both kernels
// sum exactly the same values.
//
// Window sample m lies in millisecond q = m / spms at offset
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
// r = fb + sp is one __fadd_rn. The plain versions compute the same fused
// values (float64 product and sum, rounded once to float32). nvcc's
// default FMA contraction cannot change these: every rounding step is
// explicit.
//
// The integer split of a sample into (q, lm) is exact however it is
// computed, so a caller that walks consecutive samples (K1) carries
// (q, lm) along instead of dividing by spms per sample and per tap, keeps
// the millisecond's anchors in registers (TapRow: the carrier phase and
// each tap's intercept fb + sp) and takes tap_chip_row for every sample
// whose taps all fall inside the millisecond (Taps::kmin / kmax); the
// others go through tap_chip_at (edge_sample). K3 walks its samples the
// same way. Conversions between int and float are kept to one per sample
// and one per tap without changing a bit: float(lm + k) is the exact sum
// float(lm) + float(k) (small integers), and int(ceilf(x)) is the one
// round-up conversion __float2int_ru(x).
//
// accumulate_range is the loop both kernels use to sum every stream over a
// range of window samples (K1: an epoch; K3: a warp's run, for its total).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sydr {

constexpr int kMaxTaps = 5;
constexpr int kGroup = 4;   // consecutive samples a thread takes at a time
constexpr int kCodeWidth = 4160;   // tiled_code_bits row: chip u at 1023 + u
constexpr int kCodeOrigin = 1023;

struct Taps {
  float sp[kMaxTaps];   // tap spacing [chips]
  int k[kMaxTaps];      // tap sample shift
  float fk[kMaxTaps];   // float(k)
  int kmin, kmax;       // least and largest sample shift, kmin <= 0 <= kmax
  int n;
};

// Host side: the first n_taps entries of tap_sp / tap_k, zero-padded.
inline Taps make_taps(const float* tap_sp, const int* tap_k, int n_taps) {
  Taps taps;
  for (int t = 0; t < kMaxTaps; ++t) {
    taps.sp[t] = t < n_taps ? tap_sp[t] : 0.0f;
    taps.k[t] = t < n_taps ? tap_k[t] : 0;
    taps.fk[t] = static_cast<float>(taps.k[t]);
  }
  taps.kmin = taps.kmax = 0;
  for (int t = 0; t < n_taps; ++t) {
    taps.kmin = taps.k[t] < taps.kmin ? taps.k[t] : taps.kmin;
    taps.kmax = taps.k[t] > taps.kmax ? taps.k[t] : taps.kmax;
  }
  taps.n = n_taps;
  return taps;
}

// One channel's block geometry.
struct Channel {
  const float* fb;   // [n_q] fractional code phase at each millisecond
  const float* ph;   // [n_q] carrier phase at each millisecond
  float om;          // carrier [rad / sample]
  float step;        // code [chips / sample]
  int origin;        // code-row column of chip 0: kCodeOrigin + c_int
  int n_q;
  int spms;
};

__device__ __forceinline__ Channel load_channel(
    int c, const int* c_int, const float* omega, const float* code_step,
    const float* fb_q, const float* phic_q, int n_q, int spms) {
  Channel ch;
  ch.fb = fb_q + static_cast<size_t>(c) * n_q;
  ch.ph = phic_q + static_cast<size_t>(c) * n_q;
  ch.om = omega[c];
  ch.step = code_step[c];
  ch.origin = kCodeOrigin + c_int[c];
  ch.n_q = n_q;
  ch.spms = spms;
  return ch;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The channel's code row as +/-1 floats, into shared memory (chips is
// 16-byte aligned; all threads of the block take part; the caller
// synchronises): 1040 16-byte loads where the row allows them.
__device__ __forceinline__ void load_chips(const float* code_bits, int c,
                                           float* chips) {
  const float* bits = code_bits + static_cast<size_t>(c) * kCodeWidth;
  if (aligned16(bits)) {
    const float4* bits4 = reinterpret_cast<const float4*>(bits);
    float4* chips4 = reinterpret_cast<float4*>(chips);
    for (int i = threadIdx.x; i < kCodeWidth / 4; i += blockDim.x) {
      const float4 b = __ldg(bits4 + i);
      chips4[i] = make_float4(2.0f * b.x - 1.0f, 2.0f * b.y - 1.0f,
                              2.0f * b.z - 1.0f, 2.0f * b.w - 1.0f);
    }
  } else {
    for (int i = threadIdx.x; i < kCodeWidth; i += blockDim.x) {
      chips[i] = 2.0f * bits[i] - 1.0f;
    }
  }
}

// Sample (xr, xi) at offset flm of a millisecond whose carrier anchor is
// ph, with the carrier wiped off: (mre, mim).
__device__ __forceinline__ void mix_phase(const Channel& ch, float ph,
                                          float flm, float xr, float xi,
                                          float* mre, float* mim) {
  const float phase = __fmaf_rn(-ch.om, flm, ph);
  float sn, cs;
  sincosf(phase, &sn, &cs);
  *mre = __fsub_rn(__fmul_rn(cs, xr), __fmul_rn(sn, xi));
  *mim = __fadd_rn(__fmul_rn(cs, xi), __fmul_rn(sn, xr));
}

// The code-row column of chip index ceil(x).
__device__ __forceinline__ int chip_column(const Channel& ch, float x) {
  return min(max(ch.origin + __float2int_ru(x), 0), kCodeWidth - 1);
}

// One millisecond's anchors in registers: the carrier phase and each
// tap's intercept r_t = fb[q] + sp_t.
struct TapRow {
  float r[kMaxTaps];
  float ph;
  int q;
};

__device__ __forceinline__ void load_row(const Channel& ch, const Taps& taps,
                                         int q, TapRow* row) {
  const float fb = ch.fb[q];
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) row->r[t] = __fadd_rn(fb, taps.sp[t]);
  row->ph = ch.ph[q];
  row->q = q;
}

// The +/-1 chip of tap t at offset flm = float(lm) of row's millisecond,
// for a sample whose tap stays inside it (0 <= lm + k_t < spms).
__device__ __forceinline__ float tap_chip_row(const Channel& ch,
                                              const float* chips,
                                              const Taps& taps, int t,
                                              const TapRow& row, float flm) {
  const float flk = __fadd_rn(flm, taps.fk[t]);   // exact: small integers
  return chips[chip_column(ch, __fmaf_rn(flk, ch.step, row.r[t]))];
}

// The +/-1 chip of tap t at offset lm (flm = float(lm), 0 <= lm < spms) of
// millisecond q, wherever the tap's own sample m + k_t falls.
__device__ __forceinline__ float tap_chip_at(const Channel& ch,
                                             const float* chips,
                                             const Taps& taps, int t, int q,
                                             int lm, float flm) {
  int qk = q;
  const int lk = lm + taps.k[t];
  float flk = __fadd_rn(flm, taps.fk[t]);   // exact: small integers
  if (lk < 0 || lk >= ch.spms) {   // the tap's sample is in another ms
    const int mk = q * ch.spms + lk;
    qk = min(mk / ch.spms, ch.n_q - 1);
    flk = static_cast<float>(mk - qk * ch.spms);
  }
  const float r = __fadd_rn(ch.fb[qk], taps.sp[t]);
  return chips[chip_column(ch, __fmaf_rn(flk, ch.step, r))];
}

// One sample anywhere: offset lm of millisecond q, or lm - spms of q + 1
// where lm >= spms (at most once: the caller's group began inside q); taps
// that may reach into a neighbouring millisecond. Calls emit(t, chip, mre,
// mim) for each tap t with its chip and the mixed sample, and leaves the
// sample's millisecond in row.
template <int kTaps, typename Emit>
__device__ __forceinline__ void edge_sample(
    const Channel& ch, const float* chips, const Taps& taps, int q, int lm,
    float xr, float xi, TapRow* row, Emit emit) {
  if (lm >= ch.spms) {
    lm -= ch.spms;
    ++q;
  }
  if (q != row->q) load_row(ch, taps, q, row);
  const float fl = static_cast<float>(lm);
  float mre, mim;
  mix_phase(ch, row->ph, fl, xr, xi, &mre, &mim);
  const bool inside = lm + taps.kmin >= 0 && lm + taps.kmax < ch.spms;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const float chip =
        inside ? tap_chip_row(ch, chips, taps, t, *row, fl)
               : tap_chip_at(ch, chips, taps, t, q, lm, fl);
    emit(t, chip, mre, mim);
  }
}

// Whether the kGroup samples from offset lm of a millisecond, taps
// included, all lie inside it (kmin <= 0 <= kmax).
__device__ __forceinline__ bool group_inside(const Channel& ch,
                                             const Taps& taps, int lm) {
  return lm + taps.kmin >= 0 && lm + kGroup - 1 + taps.kmax < ch.spms;
}

// acc[2t], acc[2t + 1] += the I and Q streams of tap t summed over window
// samples [b0, b1), for thread `rank` of the `n_threads` that share the
// range: thread-strided groups of kGroup samples that start on 16-byte
// addresses of both planes (whatever the window's offset; the first group
// may begin before b0, masked). A group wholly inside the range and inside
// one millisecond, taps included, is one 16-byte load per plane and
// straight-line code with four independent sincosf chains; the others go
// sample by sample through edge_sample. Fixed order, no atomics.
template <int kTaps>
__device__ __forceinline__ void accumulate_range(
    const Channel& ch, const float* chips, const Taps& taps,
    const float* __restrict__ win_re, const float* __restrict__ win_im,
    int b0, int b1, int rank, int n_threads, float (&acc)[2 * kTaps]) {
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(win_re) >> 2) & (kGroup - 1));
  const bool vec = mis == static_cast<int>(
      (reinterpret_cast<uintptr_t>(win_im) >> 2) & (kGroup - 1));
  const int stride = n_threads * kGroup;
  int g = ((b0 + mis) & ~(kGroup - 1)) - mis + rank * kGroup;
  int q = g > 0 ? g / ch.spms : 0;
  int lm = g - q * ch.spms;   // negative only for masked samples before 0
  TapRow row;
  row.q = -1;
  for (; g < b1; g += stride) {
    if (vec && g >= b0 && g + kGroup <= b1 && group_inside(ch, taps, lm)) {
      if (q != row.q) load_row(ch, taps, q, &row);
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
        mix_phase(ch, row.ph, fl, xr[i], xi[i], &mre, &mim);
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          const float chip = tap_chip_row(ch, chips, taps, t, row, fl);
          acc[2 * t] += chip * mre;
          acc[2 * t + 1] += chip * mim;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int m = g + i;
        if (m >= b0 && m < b1) {
          edge_sample<kTaps>(
              ch, chips, taps, q, lm + i, win_re[m], win_im[m], &row,
              [&acc](int t, float chip, float mre, float mim) {
                acc[2 * t] += chip * mre;
                acc[2 * t + 1] += chip * mim;
              });
        }
      }
    }
    lm += stride;
    while (lm >= ch.spms) {
      lm -= ch.spms;
      ++q;
    }
  }
}

}  // namespace sydr

// Run the statement given after n_taps with kTaps the compile-time value
// of the tap count (1..kMaxTaps): the kernels' tap loops are unrolled for
// the count in use.
#define SYDR_TAPS_SWITCH(n_taps, ...)                         \
  switch (n_taps) {                                           \
    case 1: { constexpr int kTaps = 1; __VA_ARGS__; } break;   \
    case 2: { constexpr int kTaps = 2; __VA_ARGS__; } break;   \
    case 3: { constexpr int kTaps = 3; __VA_ARGS__; } break;   \
    case 4: { constexpr int kTaps = 4; __VA_ARGS__; } break;   \
    default: { constexpr int kTaps = 5; __VA_ARGS__; } break;  \
  }
