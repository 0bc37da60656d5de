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
// others go through tap_chip_at. K3, whose time is its output's, keeps
// the plain per-sample forms mix_sample and tap_chip. Conversions between
// int and float are kept to one per sample and one per tap without
// changing a bit: float(lm + k) is the exact sum float(lm) + float(k)
// (small integers), and int(ceilf(x)) is the one round-up conversion
// __float2int_ru(x).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sydr {

constexpr int kMaxTaps = 5;
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

// The channel's code row as +/-1 floats, into shared memory (all threads
// of the block take part; the caller synchronises).
__device__ __forceinline__ void load_chips(const float* code_bits, int c,
                                           float* chips) {
  const float* bits = code_bits + static_cast<size_t>(c) * kCodeWidth;
  for (int i = threadIdx.x; i < kCodeWidth; i += blockDim.x) {
    chips[i] = 2.0f * bits[i] - 1.0f;
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

// Window sample m with the carrier wiped off: (mre, mim).
__device__ __forceinline__ void mix_sample(const Channel& ch,
                                           const float* win_re,
                                           const float* win_im, int m,
                                           float* mre, float* mim) {
  const int q = m / ch.spms;
  mix_phase(ch, ch.ph[q], static_cast<float>(m - q * ch.spms), win_re[m],
            win_im[m], mre, mim);
}

// The +/-1 chip of tap t at window sample m, with no branch: the tap's own
// split of m + k into (millisecond, offset).
__device__ __forceinline__ float tap_chip(const Channel& ch,
                                          const float* chips,
                                          const Taps& taps, int t, int m) {
  const int mk = m + taps.k[t];
  const int qk = min(mk / ch.spms, ch.n_q - 1);
  const int lk = mk - qk * ch.spms;
  const float r = __fadd_rn(ch.fb[qk], taps.sp[t]);
  return chips[chip_column(
      ch, __fmaf_rn(static_cast<float>(lk), ch.step, r))];
}

}  // namespace sydr
