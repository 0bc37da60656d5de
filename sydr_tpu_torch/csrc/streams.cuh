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
  int n;
};

// Host side: the first n_taps entries of tap_sp / tap_k, zero-padded.
inline Taps make_taps(const float* tap_sp, const int* tap_k, int n_taps) {
  Taps taps;
  for (int t = 0; t < kMaxTaps; ++t) {
    taps.sp[t] = t < n_taps ? tap_sp[t] : 0.0f;
    taps.k[t] = t < n_taps ? tap_k[t] : 0;
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

// Window sample m with the carrier wiped off: (mre, mim).
__device__ __forceinline__ void mix_sample(const Channel& ch,
                                           const float* win_re,
                                           const float* win_im, int m,
                                           float* mre, float* mim) {
  const int q = m / ch.spms;
  const int lm = m - q * ch.spms;
  const float phase = __fmaf_rn(-ch.om, static_cast<float>(lm), ch.ph[q]);
  float sn, cs;
  sincosf(phase, &sn, &cs);
  const float xr = win_re[m];
  const float xi = win_im[m];
  *mre = __fsub_rn(__fmul_rn(cs, xr), __fmul_rn(sn, xi));
  *mim = __fadd_rn(__fmul_rn(cs, xi), __fmul_rn(sn, xr));
}

// The +/-1 chip of tap (sp, k) at window sample m.
__device__ __forceinline__ float tap_chip(const Channel& ch,
                                          const float* chips, float sp,
                                          int k, int m) {
  const int mk = m + k;
  const int qk = min(mk / ch.spms, ch.n_q - 1);
  const int lk = mk - qk * ch.spms;
  const float r = __fadd_rn(ch.fb[qk], sp);
  const int idx = static_cast<int>(
      ceilf(__fmaf_rn(static_cast<float>(lk), ch.step, r)));
  const int pos = min(max(ch.origin + idx, 0), kCodeWidth - 1);
  return chips[pos];
}

}  // namespace sydr
