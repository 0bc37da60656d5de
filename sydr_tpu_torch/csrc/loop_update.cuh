// The per-epoch tracking-loop update of one channel, as device functions on
// its scalars: sydr_tpu_torch/ops/profiles.py::loop_update and the helpers
// it calls in ops/tracking.py (discriminators, loop filters, lock
// indicators, C/N0), plus the bit-edge declaration rule of
// channels/runtime.py::_bit_sync_declare. Shared by the kernels that replay
// a block's epochs (csrc/pass_c.cu).
//
// The update is two functions: discriminate, what one epoch's correlators
// and the previous active epoch's prompt give without the loops' carry
// (the discriminators' raw values, the lock indicators' inputs), and
// filter_step, the carried part (the compensation subtractions, the loop
// filters, the NCO, the lock low-passes, the state machine). loop_update is
// their composition. A kernel may run discriminate for many epochs at once
// and only filter_step in series.
//
// Every operation rounds as the plain version's PyTorch op does on the
// card, one op at a time: products and sums through __fmul_rn / __fadd_rn /
// __fsub_rn (never contracted into a fused multiply-add), divisions of two
// tensors through __fdiv_rn, a division of a tensor by a Python scalar as
// the multiplication that PyTorch's CUDA division computes, by the scalar's
// reciprocal rounded to float32 (from the host, LoopConsts), x**2 as x * x,
// torch.remainder, torch.round (half to even), torch.sign (0 at 0) and
// torch.clamp (NaN passes) in their CUDA forms, and atanf, atan2f, sinf,
// cosf, log10f and powf, the functions PyTorch's CUDA ops call. Every
// Python float constant enters as the float32 value its op sees.

#pragma once

namespace sydr {

constexpr int kLockPullIn = 0;
constexpr int kLockWide = 1;
constexpr int kLockNarrow = 2;
constexpr int kProfileBorre = 0;
constexpr int kProfileKaplan = 1;
constexpr int kProfileKaplanNarrowOnly = 2;
constexpr int kHistBins = 20;
constexpr int kFlagCodeLock = 1;
constexpr int kFlagBitSync = 2;

// The configuration's constants, each the float32 value the plain
// version's op sees (ops/loop_kernel.py::loop_consts builds it; the field
// order is ctypes' LoopConsts there).
struct LoopConsts {
  int profile;             // kProfile*
  int dlf_order;           // 2 or 3
  int fll_atan2;           // 1: fll_atan2, 0: fll_atan
  int cn0_beaulieu;        // 1: cn0_beaulieu, 0: cn0_nwpr
  int freq_rail_on;        // freq_rail_hz > 0
  int block_step_on;       // max_block_freq_step > 0
  int code_rail_on;        // code_rail_hz > 0
  int min_convergence_ms;
  int bit_sync_unanimous;
  int bit_sync_flips;
  float dll_k1;            // tau2 / tau1 of the DLL's Borre filter
  float dll_k2;            // pdi / tau1
  float pll_k1;            // the same for the borre profile's PLL
  float pll_k2;
  float w0f[3];            // kaplan DLF natural frequencies, by lock state
  float w0p[3];
  float a2;
  float a3;
  float b3;
  float t_int;             // 1e-3: the DLF's and the virtual NCO's 1 ms
  float alpha;             // lock-indicator low-pass
  float one_minus_alpha;
  float fll_thr_wide;
  float fll_thr_narrow;
  float pll_thr_narrow;
  float freq_rail;
  float block_step;
  float code_rail;
  float dominance;         // bit_sync_dominance
  float two_pi;
  float pi;
  float half_pi;
  float rcp_two_pi;        // the scalar divisors' reciprocals (f32(1 / x))
  float rcp_dt;            // 1 / 1e-3
  float rcp_ten;           // 1 / 10
  float cn0_alpha;         // cn0_beaulieu's low-pass, 0.1
  float cn0_one_minus_alpha;
  float cn0_floor;         // 1e-12
  float n_accum;           // 20
  float code_freq;         // GPS_L1CA_CODE_FREQ
  int slew_on;             // anchor_slew_hz_per_s > 0 and freq_rail_hz > 0
  float slew_step;         // anchor_slew_hz_per_s * block_ms * 1e-3
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqr(float a) { return __fmul_rn(a, a); }

// torch.remainder of two floats (CUDA form).
__device__ __forceinline__ float mod_f(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = add(m, b);
  return m;
}

// torch.remainder of two ints (Python's modulo).
__device__ __forceinline__ int mod_i(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__device__ __forceinline__ float sign(float x) {
  return static_cast<float>((0.0f < x) - (x < 0.0f));
}

// torch.clamp with tensor or scalar bounds, and with a lower bound only.
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float low_pass(float value, float previous,
                                          float alpha, float one_minus) {
  return add(mul(previous, one_minus), mul(value, alpha));
}

// --- Discriminators (ops/tracking.py) -------------------------------------

__device__ __forceinline__ float dll_nneml(float ie, float qe, float il,
                                           float ql) {
  const float e = __fsqrt_rn(add(sqr(ie), sqr(qe)));
  const float l = __fsqrt_rn(add(sqr(il), sqr(ql)));
  const float s = add(e, l);
  return s > 0.0f ? quot(sub(e, l), s) : 0.0f;
}

__device__ __forceinline__ float ratio_or_zero(float q, float i) {
  return i != 0.0f ? quot(q, i) : 0.0f;
}

__device__ __forceinline__ float pll_costas(const LoopConsts& k, float ip,
                                            float qp) {
  return mul(atanf(ratio_or_zero(qp, ip)), k.rcp_two_pi);
}

__device__ __forceinline__ float fll_atan(const LoopConsts& k, float ip,
                                          float qp, float ip_prev,
                                          float qp_prev) {
  float d = sub(atanf(ratio_or_zero(qp, ip)),
                atanf(ratio_or_zero(qp_prev, ip_prev)));
  if (isnan(d)) d = 0.0f;
  if (d >= k.half_pi) d = sub(d, k.pi);
  if (d <= -k.half_pi) d = add(d, k.pi);
  return mul(mul(d, k.rcp_dt), k.rcp_two_pi);
}

__device__ __forceinline__ float fll_atan2(const LoopConsts& k, float ip,
                                           float qp, float ip_prev,
                                           float qp_prev) {
  const float cross = sub(mul(ip_prev, qp), mul(qp_prev, ip));
  const float dot = add(mul(ip_prev, ip), mul(qp_prev, qp));
  return mul(mul(atan2f(mul(cross, sign(dot)), fabsf(dot)), k.rcp_dt),
             k.rcp_two_pi);
}

// --- Loop filters ----------------------------------------------------------

__device__ __forceinline__ float borre_loop_filter(float value, float memory,
                                                   float k1, float k2) {
  return add(mul(sub(value, memory), k1), mul(value, k2));
}

// --- Lock indicators and C/N0 ----------------------------------------------

// The lock indicators' raw values; each indicator is
// low_pass(value, previous, alpha, one_minus).
__device__ __forceinline__ float pll_lock_value(float ip, float qp) {
  const float nbd = sub(sqr(ip), sqr(qp));
  const float nbp = add(sqr(ip), sqr(qp));
  return nbp > 0.0f ? quot(nbd, nbp) : 0.0f;
}

__device__ __forceinline__ float fll_lock_value(float ip, float qp,
                                                float ip_prev,
                                                float qp_prev) {
  const float dot = sub(mul(ip, ip_prev), mul(qp, qp_prev));
  const float cross_sign = sign(add(mul(ip, ip_prev), mul(qp, qp_prev)));
  const float power = add(sqr(ip), sqr(qp));
  return power > 0.0f ? fabsf(quot(mul(dot, cross_sign), power)) : 0.0f;
}

__device__ __forceinline__ float beaulieu_ratio_term(float ip, float qp,
                                                     float ip_prev,
                                                     float qp_prev) {
  const float m1 = add(sqr(ip), sqr(qp));
  const float m0 = add(sqr(ip_prev), sqr(qp_prev));
  const float pn = sqr(sub(__fsqrt_rn(m1), __fsqrt_rn(m0)));
  const float pd = add(m1, m0);
  return pd > 0.0f ? quot(pn, pd) : 0.0f;
}

// cn0_update's estimate at a bit completion, before its where().
__device__ __forceinline__ float cn0_estimate(const LoopConsts& k,
                                              float ip_sum, float qp_sum,
                                              float ip_sq, float qp_sq,
                                              float ratio_sum, float prev) {
  if (k.cn0_beaulieu) {
    const float prev_lin = powf(10.0f, mul(prev, k.rcp_ten));
    // n / ratio is PyTorch's ratio.reciprocal() * n.
    const float value = mul(
        ratio_sum > 0.0f ? mul(quot(1.0f, ratio_sum), k.n_accum) : 0.0f,
        k.rcp_dt);
    const float lin =
        low_pass(value, prev_lin, k.cn0_alpha, k.cn0_one_minus_alpha);
    return mul(log10f(clamp_min(lin, k.cn0_floor)), 10.0f);
  }
  const float nbp = add(sqr(ip_sum), sqr(qp_sum));
  const float wbp = add(ip_sq, qp_sq);
  const float np_ratio = wbp > 0.0f ? quot(nbp, wbp) : 1.0f;
  const float arg =
      mul(quot(sub(np_ratio, 1.0f), sub(k.n_accum, np_ratio)), k.rcp_dt);
  return mul(log10f(clamp_min(arg, k.cn0_floor)), 10.0f);
}

// --- The loop update (ops/profiles.py::loop_update) ------------------------

// What loop_update reads of the carried state (st.*), and the virtual-NCO
// compensation (comp) the batched runtime subtracts.
struct LoopIn {
  float dll_memory, pll_memory, fll_vel, fll_acc;
  float i_prompt_prev, q_prompt_prev, pll_lock, fll_lock;
  int lock_state, code_counter;
  float comp_freq, comp_phase, comp_code;
};

struct LoopOut {
  float i_early, q_early, i_prompt, q_prompt, i_late, q_late;
  float code_err, phase_err, freq_err, nco_code, nco_carrier;
  float fll_vel, fll_acc, pll_lock, fll_lock;
  int lock_state;
};

// One epoch's carry-free values: the correlator pairs, the discriminators'
// raw values and the lock low-passes' input terms (value * alpha). The
// kaplan profile picks its early/late pair by lock state, so both pairs
// and both NNEML values are here (the narrow pair in ie..ql and dll).
struct Disc {
  float ie, qe, ip, qp, il, ql;
  float ie_w, qe_w, il_w, ql_w;
  float dll, dll_w;        // dll_nneml of the (narrow) pair and the wide pair
  float costas;            // pll_costas
  float fll;               // the FLL discriminator (kaplan), 0 otherwise
  float pll_lock_in;       // mul(pll_lock_value, alpha)
  float fll_lock_in;       // mul(fll_lock_value, alpha)
};

// The carry-free part of loop_update for the profile `profile` (k.profile;
// a kernel may pass it as a compile-time constant): correlators `corr` and
// the prompt of the previous active epoch (st.i_prompt_prev).
__device__ __forceinline__ Disc discriminate(const LoopConsts& k, int profile,
                                             const float* corr,
                                             float ip_prev, float qp_prev) {
  Disc d;
  if (profile != kProfileKaplan) {
    d.ie = corr[0];
    d.qe = corr[1];
    d.ip = corr[2];
    d.qp = corr[3];
    d.il = corr[4];
    d.ql = corr[5];
    d.ie_w = d.ie;
    d.qe_w = d.qe;
    d.il_w = d.il;
    d.ql_w = d.ql;
  } else {
    d.ie = corr[2];
    d.qe = corr[3];
    d.ip = corr[4];
    d.qp = corr[5];
    d.il = corr[6];
    d.ql = corr[7];
    d.ie_w = corr[0];
    d.qe_w = corr[1];
    d.il_w = corr[8];
    d.ql_w = corr[9];
  }
  d.dll = dll_nneml(d.ie, d.qe, d.il, d.ql);
  d.dll_w = profile == kProfileKaplan
                ? dll_nneml(d.ie_w, d.qe_w, d.il_w, d.ql_w)
                : d.dll;
  d.costas = pll_costas(k, d.ip, d.qp);
  if (profile != kProfileBorre) {
    d.fll = k.fll_atan2 ? fll_atan2(k, d.ip, d.qp, ip_prev, qp_prev)
                        : fll_atan(k, d.ip, d.qp, ip_prev, qp_prev);
  } else {
    d.fll = 0.0f;
  }
  d.pll_lock_in = mul(pll_lock_value(d.ip, d.qp), k.alpha);
  d.fll_lock_in = mul(fll_lock_value(d.ip, d.qp, ip_prev, qp_prev), k.alpha);
  return d;
}

// A lock indicator's low-pass from its input term (Disc::*_lock_in).
__device__ __forceinline__ float lock_low_pass(float term, float previous,
                                               float one_minus) {
  return add(mul(previous, one_minus), term);
}

// The carried part of loop_update: from discriminate's values `d` and the
// state `s` (its prompt is not read: d holds what it gave), gated by
// `active` where the plain version gates. `profile` and `order` are
// k.profile and k.dlf_order (a kernel may pass compile-time constants).
__device__ __forceinline__ LoopOut filter_step(const LoopConsts& k,
                                               int profile, int order,
                                               const Disc& d,
                                               const LoopIn& s, bool active) {
  LoopOut o;
  const bool kaplan = profile != kProfileBorre;
  const bool narrow_only = profile == kProfileKaplanNarrowOnly;
  const bool wide_pair =
      profile == kProfileKaplan && s.lock_state != kLockNarrow;
  o.i_early = wide_pair ? d.ie_w : d.ie;
  o.q_early = wide_pair ? d.qe_w : d.qe;
  o.i_prompt = d.ip;
  o.q_prompt = d.qp;
  o.i_late = wide_pair ? d.il_w : d.il;
  o.q_late = wide_pair ? d.ql_w : d.ql;

  // DLL (shared): NNEML + Borre PI filter.
  o.code_err = sub(wide_pair ? d.dll_w : d.dll, s.comp_code);
  o.nco_code = borre_loop_filter(o.code_err, s.dll_memory, k.dll_k1,
                                 k.dll_k2);

  if (kaplan) {
    const bool pull_in = !narrow_only && s.lock_state == kLockPullIn;
    const bool converged = s.code_counter > 1;
    o.freq_err = converged ? sub(d.fll, s.comp_freq) : 0.0f;
    o.phase_err = pull_in ? 0.0f : sub(d.costas, s.comp_phase);
    // The bandwidths by lock state (the narrow-only shape has the narrow
    // ones in every entry, and takes entry 2), divided by their DLF scales
    // on the host; selected, not indexed (a run-time index into the
    // constants puts them in local memory).
    const bool narrow = narrow_only || s.lock_state == kLockNarrow;
    const bool wide = s.lock_state == kLockWide;
    const float w0f = narrow ? k.w0f[2] : wide ? k.w0f[1] : k.w0f[0];
    const float w0p = narrow ? k.w0p[2] : wide ? k.w0p[1] : k.w0p[0];
    const float pe = o.phase_err, fe = o.freq_err;
    float vel, acc = s.fll_acc;
    if (order == 3) {
      const float w0p2 = mul(w0p, w0p);
      const float acc_update =
          mul(add(mul(pe, mul(w0p2, w0p)), mul(fe, mul(w0f, w0f))), k.t_int);
      const float first = add(acc_update, s.fll_acc);
      vel = mul(add(add(first, mul(mul(pe, k.a3), w0p2)),
                    mul(mul(fe, k.a2), w0f)),
                k.t_int);
      o.nco_carrier = add(add(vel, s.fll_vel), mul(mul(pe, k.b3), w0p));
      acc = active ? acc_update : s.fll_acc;
    } else {
      vel = mul(add(mul(pe, mul(w0p, w0p)), mul(fe, w0f)), k.t_int);
      o.nco_carrier = add(add(vel, s.fll_vel), mul(mul(pe, k.a2), w0p));
    }
    o.fll_vel = active ? vel : s.fll_vel;
    o.fll_acc = acc;
    o.fll_lock = active ? lock_low_pass(d.fll_lock_in, s.fll_lock,
                                        k.one_minus_alpha)
                        : s.fll_lock;
    o.pll_lock = (active && !pull_in)
                     ? lock_low_pass(d.pll_lock_in, s.pll_lock,
                                     k.one_minus_alpha)
                     : s.pll_lock;
    if (narrow_only) {
      o.lock_state = active ? kLockNarrow : s.lock_state;
    } else {
      // State machine (reference trackingStateUpdate :538-619).
      const bool to_narrow = s.lock_state != kLockNarrow &&
                             o.fll_lock >= k.fll_thr_narrow &&
                             o.pll_lock >= k.pll_thr_narrow;
      const bool to_wide = !to_narrow && s.lock_state != kLockWide &&
                           o.fll_lock >= k.fll_thr_wide &&
                           o.fll_lock < k.fll_thr_narrow;
      const bool to_pullin = !to_narrow && !to_wide &&
                             s.lock_state != kLockPullIn &&
                             o.fll_lock <= k.fll_thr_wide;
      const int nxt = to_narrow ? kLockNarrow
                      : to_wide ? kLockWide
                      : to_pullin ? kLockPullIn : s.lock_state;
      o.lock_state = active ? nxt : s.lock_state;
    }
  } else {
    o.phase_err = sub(d.costas, s.comp_phase);
    o.freq_err = 0.0f;
    o.nco_carrier = borre_loop_filter(o.phase_err, s.pll_memory, k.pll_k1,
                                      k.pll_k2);
    o.fll_vel = s.fll_vel;
    o.fll_acc = s.fll_acc;
    o.pll_lock = active ? lock_low_pass(d.pll_lock_in, s.pll_lock,
                                        k.one_minus_alpha)
                        : s.pll_lock;
    o.fll_lock = active ? lock_low_pass(d.fll_lock_in, s.fll_lock,
                                        k.one_minus_alpha)
                        : s.fll_lock;
    o.lock_state = active ? kLockNarrow : s.lock_state;
  }
  return o;
}

// One channel's update from its correlators `corr` (i, q per spacing, as
// the plain version's columns), gated by `active` where the plain version
// gates. Zero compensation gives the uncompensated update bit for bit
// (x - 0 is x), as the scan runtime's loop_update(comp=None) computes it.
__device__ __forceinline__ LoopOut loop_update(const LoopConsts& k,
                                               const float* corr,
                                               const LoopIn& s, bool active) {
  return filter_step(
      k, k.profile, k.dlf_order,
      discriminate(k, k.profile, corr, s.i_prompt_prev, s.q_prompt_prev), s,
      active);
}

// The bit-edge declaration rule (channels/runtime.py::_bit_sync_declare)
// from a histogram's largest bin `mode` and its sum `total`.
__device__ __forceinline__ bool bit_sync_rule(const LoopConsts& k, int mode,
                                              int total) {
  const bool unanimous = k.bit_sync_unanimous > 0 && mode == total &&
                         total >= k.bit_sync_unanimous;
  const bool dominant =
      total >= k.bit_sync_flips &&
      static_cast<float>(mode) >=
          mul(static_cast<float>(total), k.dominance);
  return unanimous || dominant;
}

// The rule on a histogram in registers; `argmax` gets its first maximal
// bin.
__device__ __forceinline__ bool bit_sync_declare(const LoopConsts& k,
                                                 const int (&hist)[kHistBins],
                                                 int& argmax) {
  int total = 0, mode = hist[0];
  argmax = 0;
#pragma unroll
  for (int b = 0; b < kHistBins; ++b) {
    total += hist[b];
    if (hist[b] > mode) {
      mode = hist[b];
      argmax = b;
    }
  }
  return bit_sync_rule(k, mode, total);
}

}  // namespace sydr
