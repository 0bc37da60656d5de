// The per-ms ("scan") tracking runtime's block: every channel's epochs,
// correlation and loop update in one launch.
//
// Replaces no Pallas kernel. Its counterpart in the JAX package is the
// jitted lax.scan of sydr_tpu/channels/runtime.py::run_block (:443-472)
// over _epoch (:235): XLA compiles a block's epochs into one program. The
// port's plain version (sydr_tpu_torch/channels/runtime.py::
// _run_block_plain) is a Python loop of ~314 [n_ch]-wide launches an epoch,
// ~6,300 a 20 ms block; this kernel is one.
//
// Per epoch it computes what the plain _epoch computes: the samples that
// arrive, the code rate and the epoch's length (`required`, a ceil of a
// division), the activity and the read pointer; the EPL correlation of
// ops/tracking.py::epl_correlate (the carrier wipe-off, one chip gather a
// spacing and sample from the padded code row, every sample up to
// `required` summed); the loop update (loop_update.cuh's discriminate and
// filter_step with no compensation); the phase advance of
// runtime.py::scan_phase_advance; the rails; the bit-edge histogram and its
// declaration; the bit accumulators, C/N0 and flags; and the epoch's 24
// outputs, each written where the plain version stacks it. After the last
// epoch it slews the rail's anchor (runtime.py::_slew_anchor) and writes
// the new state. Every operation before a sum rounds as the plain version's
// op does on the card (loop_update.cuh's rules; the chip index as
// correlator_kernel.fma32 does it, in double): the phase, cosf/sinf, the
// mixed sample, the chip index, the chip and the product. The sums cannot
// follow PyTorch's reduction tree, so the correlators, and through the
// loops the rest, agree with the plain version within bounds, not bits.
//
// Bound on the H100: latency. An epoch's correlation is ~window_size
// samples of a channel (~30 operations a sample with cosf and sinf, and 4
// a spacing), microseconds below what the card could do across its SMs;
// but epoch e + 1's rate, length and read pointer come from epoch e's loop
// update, so the correlation sits inside the carry. The design, simple
// first:
//   - one CTA a channel (kThreads threads), so that no step crosses
//     channels: a channel shard computes what the full launch computes,
//     and two runs are bit-identical;
//   - the channel's code row staged in shared memory once, the gathers
//     read from there;
//   - the threads stride over the epoch's samples (the window read at the
//     channel's pointer, zero past its end), each summing its products in
//     sample order; the partials are reduced in one fixed order: a
//     butterfly of shuffles within each warp, then the warps in order;
//   - one thread runs the loop update and the bookkeeping with the carry in
//     its registers and the histogram in shared memory, writes the epoch's
//     outputs, and computes the next epoch's geometry for the others.
// The loops' configuration (profile, DLF order) and the spacing count are
// compiled in. Launched on the caller's stream without a synchronisation,
// so the session's step graph captures it.

#include <climits>
#include <cstddef>

#include "channel_layout.cuh"
#include "loop_update.cuh"

namespace sydr {

constexpr int kMaxSpacings = 5;

// The scan runtime's constants beside LoopConsts, each the value the plain
// version's op sees (ops/scan_kernel.py::scan_consts builds it; the field
// order is ctypes' ScanConsts there).
struct ScanConsts {
  double code_ratio;       // f32(1023) * f32(1 / samples_per_ms), in float32
  int samples_per_ms;
  int tail_ms;
  int window_size;
  int n_spacings;
  int carrier_aiding;
  int slew_on;             // anchor_slew_hz_per_s > 0 and freq_rail_hz > 0
  float spacing[kMaxSpacings];   // ops/profiles.py::spacings_for
  float intermediate_frequency;
  float aiding;            // GPS_L1CA_CODE_FREQ / GPS_L1CA_CARRIER_FREQ
  float rcp_fs;            // 1 / sampling_frequency
  float code_length;       // GPS_L1CA_CODE_LENGTH
  float slew_step;         // anchor_slew_hz_per_s * block_ms * 1e-3
};

// Device pointers (ops/scan_kernel.py's ScanArgs, field by field).
struct ScanArgs {
  const float* state_f[kNumStateF];   // [n_ch] each
  const int* state_i[kNumStateI];     // [n_ch] each
  const int* edge_hist;               // [n_ch, 20]
  const float* codes;                 // [n_ch, 1025]
  const float* window_re;             // [n_window]
  const float* window_im;             // [n_window]
  float* out_f;                       // [kNumOutF, block_ms, n_ch]
  int* out_i;                         // [kNumOutI, block_ms, n_ch]
  bool* out_b;                        // [kNumOutB, block_ms, n_ch]
  float* new_f;                       // [kNumStateF, n_ch]
  int* new_i;                         // [kNumStateI, n_ch]
  int* new_hist;                      // [n_ch, 20]
};

}  // namespace sydr

namespace {

using namespace sydr;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCodeLen = 1025;       // the padded code row
constexpr unsigned kFull = 0xffffffffu;

// What the threads read of an epoch for its correlation.
struct Geometry {
  double step;                 // code_step, as a double
  double chip0[kMaxSpacings];  // f32(rem_code + spacing), as doubles
  float rate;                  // carrier radians a sample
  float rem_carrier;
  int read_ptr;
  int n_valid;                 // samples summed: required, within the window
};

// One channel's state from epoch to epoch, in the updating thread's
// registers (the histogram is in shared memory).
struct Carry {
  float carrier, code_off, rem_carrier, rem_code;
  float dll_mem, pll_mem, fll_mem, fll_vel, fll_acc;
  float ip_prev, qp_prev, ip_sum, qp_sum, ratio_sum, ip_sq, qp_sq, cn0;
  float pll_lock, fll_lock;
  int flags, unread, code_counter, ms_counter, bit_edge, accum_count;
  int lock_state;
};

// What an epoch's start gives before its correlation.
struct Start {
  float delta, code_freq, omega;
  int unread, required;
  bool active;
};

// The epoch's start (runtime.py::_epoch up to the correlation) and the
// geometry the correlation reads.
__device__ __forceinline__ Start epoch_start(const LoopConsts& k,
                                             const ScanConsts& sc,
                                             const Carry& cr, bool tracking,
                                             int e, int n_spacings,
                                             Geometry& g) {
  Start q;
  const int spms = sc.samples_per_ms;
  const int avail = (sc.tail_ms + e + 1) * spms;
  q.unread = min(cr.unread + spms, avail);
  q.delta = sc.carrier_aiding
                ? add(cr.code_off,
                      mul(sub(cr.carrier, sc.intermediate_frequency),
                          sc.aiding))
                : add(cr.code_off, 0.0f);
  q.code_freq = add(q.delta, k.code_freq);
  const float step = mul(q.code_freq, sc.rcp_fs);
  // .to(int32) of the ceil: the saturating conversion, NaN to 0.
  q.required = static_cast<int>(
      ceilf(quot(sub(sc.code_length, cr.rem_code), step)));
  q.active = tracking && q.unread >= q.required;
  q.omega = mul(mul(cr.carrier, k.two_pi), sc.rcp_fs);
  g.step = static_cast<double>(step);
  for (int s = 0; s < n_spacings; ++s) {
    g.chip0[s] = static_cast<double>(add(cr.rem_code, sc.spacing[s]));
  }
  g.rate = q.omega;
  g.rem_carrier = cr.rem_carrier;
  g.read_ptr = max(avail - q.unread, 0);
  g.n_valid = min(max(q.required, 0), sc.window_size);
  return q;
}

// This thread's sums over its samples of the epoch (i = threadIdx.x,
// + kThreads, ...): I and Q of each spacing, in sample order.
template <int kSp>
__device__ __forceinline__ void correlate(const ScanArgs& p,
                                          const float* code,
                                          const Geometry& g, int n_window,
                                          float (&part)[2 * kSp]) {
  double chip0[kSp];
#pragma unroll
  for (int s = 0; s < kSp; ++s) {
    chip0[s] = g.chip0[s];
    part[2 * s] = 0.0f;
    part[2 * s + 1] = 0.0f;
  }
  const double step = g.step;
  const float rate = g.rate, rem = g.rem_carrier;
  for (int i = threadIdx.x; i < g.n_valid; i += kThreads) {
    const int j = g.read_ptr + i;
    float xr = 0.0f, xi = 0.0f;   // the zero pad past the window
    if (j < n_window) {
      xr = p.window_re[j];
      xi = p.window_im[j];
    }
    // tracking.py::mix_carrier.
    const float phase = sub(rem, mul(rate, static_cast<float>(i)));
    const float cs = cosf(phase), sn = sinf(phase);
    const float mr = sub(mul(cs, xr), mul(sn, xi));
    const float mi = add(mul(cs, xi), mul(sn, xr));
    const double n = static_cast<double>(i);
#pragma unroll
    for (int s = 0; s < kSp; ++s) {
      // tracking.py::_epl_gather: fma32 (exact product, one double
      // rounding, then float), ceil, clamp to the padded row, gather.
      const float x = __double2float_rn(__dadd_rn(__dmul_rn(n, step),
                                                  chip0[s]));
      const int q = min(max(static_cast<int>(ceilf(x)), 0), kCodeLen - 1);
      const float chip = code[q];
      part[2 * s] = add(part[2 * s], mul(chip, mr));
      part[2 * s + 1] = add(part[2 * s + 1], mul(chip, mi));
    }
  }
}

template <int kProf, int kOrder, int kSp>
__global__ void __launch_bounds__(kThreads)
    scan_block_kernel(const LoopConsts k, const ScanConsts sc,
                      const ScanArgs p, int n_ch, int n_epochs,
                      int n_window) {
  __shared__ float code[kCodeLen];
  __shared__ int hist[kHistBins];
  __shared__ float red[kWarps][2 * kSp];
  __shared__ Geometry geo;
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bool updater = threadIdx.x == 0;

  const float* code_row = p.codes + static_cast<size_t>(c) * kCodeLen;
  for (int i = threadIdx.x; i < kCodeLen; i += kThreads) code[i] = code_row[i];
  if (threadIdx.x < kHistBins) {
    hist[threadIdx.x] = p.edge_hist[c * kHistBins + threadIdx.x];
  }

  // The carry and the block's constants of this channel, in the updating
  // thread.
  Carry cr = {};
  Start st = {};
  bool tracking = false;
  float anchor = 0.0f, rail_lo = 0.0f, rail_hi = 0.0f;
  if (updater) {
    const float* const* f = p.state_f;
    const int* const* in = p.state_i;
    cr.carrier = f[kCarrierFreq][c];
    cr.code_off = f[kCodeFreqOffset][c];
    cr.rem_carrier = f[kRemCarrier][c];
    cr.rem_code = f[kRemCode][c];
    cr.dll_mem = f[kDllMemory][c];
    cr.pll_mem = f[kPllMemory][c];
    cr.fll_mem = f[kFllMemory][c];
    cr.fll_vel = f[kFllVel][c];
    cr.fll_acc = f[kFllAcc][c];
    cr.ip_prev = f[kIPromptPrev][c];
    cr.qp_prev = f[kQPromptPrev][c];
    cr.ip_sum = f[kIpSum][c];
    cr.qp_sum = f[kQpSum][c];
    cr.ratio_sum = f[kCn0RatioSum][c];
    cr.ip_sq = f[kIpSqSum][c];
    cr.qp_sq = f[kQpSqSum][c];
    cr.cn0 = f[kCn0][c];
    cr.pll_lock = f[kPllLock][c];
    cr.fll_lock = f[kFllLock][c];
    cr.flags = in[kFlags][c];
    cr.unread = in[kUnread][c];
    cr.code_counter = in[kCodeCounter][c];
    cr.ms_counter = in[kMsCounter][c];
    cr.bit_edge = in[kBitEdge][c];
    cr.accum_count = in[kAccumCount][c];
    cr.lock_state = in[kLockState][c];
    tracking = in[kMode][c] == kModeTracking;
    anchor = f[kFreqAnchor][c];
    rail_lo = sub(anchor, k.freq_rail);
    rail_hi = add(anchor, k.freq_rail);
    st = epoch_start(k, sc, cr, tracking, 0, kSp, geo);
  }
  __syncthreads();

  const size_t plane = static_cast<size_t>(n_epochs) * n_ch;
  for (int e = 0; e < n_epochs; ++e) {
    float part[2 * kSp];
    correlate<kSp>(p, code, geo, n_window, part);
#pragma unroll
    for (int s = 0; s < 2 * kSp; ++s) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        part[s] = add(part[s], __shfl_xor_sync(kFull, part[s], off));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < 2 * kSp; ++s) red[w][s] = part[s];
    }
    __syncthreads();

    if (updater) {
      float corr[2 * kSp];
#pragma unroll
      for (int s = 0; s < 2 * kSp; ++s) {
        float v = red[0][s];
        for (int r = 1; r < kWarps; ++r) v = add(v, red[r][s]);
        corr[s] = v;
      }
      const bool active = st.active;

      // Discriminators + loop filters (ops/profiles.py::loop_update).
      LoopIn in;
      in.dll_memory = cr.dll_mem;
      in.pll_memory = cr.pll_mem;
      in.fll_vel = cr.fll_vel;
      in.fll_acc = cr.fll_acc;
      in.i_prompt_prev = cr.ip_prev;
      in.q_prompt_prev = cr.qp_prev;
      in.pll_lock = cr.pll_lock;
      in.fll_lock = cr.fll_lock;
      in.lock_state = cr.lock_state;
      in.code_counter = cr.code_counter;
      in.comp_freq = 0.0f;
      in.comp_phase = 0.0f;
      in.comp_code = 0.0f;
      const Disc d = discriminate(k, kProf, corr, cr.ip_prev, cr.qp_prev);
      const LoopOut lu = filter_step(k, kProf, kOrder, d, in, active);

      // NCO / phase bookkeeping (runtime.py::scan_phase_advance).
      const float req_f = static_cast<float>(st.required);
      const float whole = __double2float_rn(__dadd_rn(
          __dmul_rn(static_cast<double>(static_cast<float>(
                        st.required - sc.samples_per_ms)),
                    sc.code_ratio),
          static_cast<double>(cr.rem_code)));
      const float rem_code = __double2float_rn(__dadd_rn(
          __dmul_rn(static_cast<double>(req_f),
                    static_cast<double>(mul(st.delta, sc.rcp_fs))),
          static_cast<double>(whole)));
      const float rem_carrier =
          sydr::mod_f(sub(cr.rem_carrier, mul(st.omega, req_f)), k.two_pi);
      float carrier = add(cr.carrier, lu.nco_carrier);
      if (k.freq_rail_on) carrier = sydr::clamp(carrier, rail_lo, rail_hi);
      float code_off = sub(cr.code_off, lu.nco_code);
      if (k.code_rail_on) {
        code_off = sydr::clamp(code_off, -k.code_rail, k.code_rail);
      }

      // Bit-edge synchronisation (histogram method).
      const bool had_sync = (cr.flags & kFlagBitSync) != 0;
      const int ms =
          active ? sydr::mod_i(cr.ms_counter + 1, 20) : cr.ms_counter;
      const bool counting = active && !had_sync &&
                            cr.code_counter > k.min_convergence_ms &&
                            cr.pll_lock > 0.5f;
      if (counting && sydr::sign(cr.ip_prev) != sydr::sign(lu.i_prompt)) {
        hist[ms] += 1;
      }
      int argmax = 0;
      const bool declare = !had_sync && bit_sync_declare(k, hist, argmax);
      const int bit_edge = declare ? argmax : cr.bit_edge;
      const bool bit_sync = had_sync || declare;
      const bool at_edge =
          active && bit_sync && sydr::mod_i(ms - bit_edge, 20) == 0;
      const bool bit_complete = at_edge && cr.accum_count >= 20;
      const bool keep_sums = !(at_edge || declare);
      const bool acc = active && bit_sync;

      // C/N0 + lock indicators over bit-aligned 20-ms intervals.
      const float ip = lu.i_prompt, qp = lu.q_prompt;
      const float ratio = beaulieu_ratio_term(ip, qp, cr.ip_prev, cr.qp_prev);
      const float cn0 = bit_complete
                            ? cn0_estimate(k, cr.ip_sum, cr.qp_sum, cr.ip_sq,
                                           cr.qp_sq, cr.ratio_sum, cr.cn0)
                            : cr.cn0;
      const float bit_ip_sum = cr.ip_sum;
      cr.ip_sum = add(keep_sums ? cr.ip_sum : 0.0f, acc ? ip : 0.0f);
      cr.qp_sum = add(keep_sums ? cr.qp_sum : 0.0f, acc ? qp : 0.0f);
      cr.ip_sq = add(keep_sums ? cr.ip_sq : 0.0f, acc ? sqr(ip) : 0.0f);
      cr.qp_sq = add(keep_sums ? cr.qp_sq : 0.0f, acc ? sqr(qp) : 0.0f);
      cr.ratio_sum = add(keep_sums ? cr.ratio_sum : 0.0f, acc ? ratio : 0.0f);
      cr.accum_count = (keep_sums ? cr.accum_count : 0) + (acc ? 1 : 0);
      const int flags =
          active ? (cr.flags | kFlagCodeLock | (bit_sync ? kFlagBitSync : 0))
                 : cr.flags;

      // The new carry.
      const int unread = active ? st.unread - st.required : st.unread;
      if (active) {
        cr.carrier = carrier;
        cr.code_off = code_off;
        cr.rem_carrier = rem_carrier;
        cr.rem_code = rem_code;
        cr.dll_mem = lu.code_err;
        cr.pll_mem = lu.phase_err;
        cr.fll_mem = lu.freq_err;
        cr.ip_prev = ip;
        cr.qp_prev = qp;
        cr.code_counter += 1;
      }
      cr.unread = unread;
      cr.fll_vel = lu.fll_vel;
      cr.fll_acc = lu.fll_acc;
      cr.pll_lock = lu.pll_lock;
      cr.fll_lock = lu.fll_lock;
      cr.lock_state = lu.lock_state;
      cr.ms_counter = ms;
      cr.bit_edge = bit_edge;
      cr.cn0 = cn0;
      cr.flags = flags;

      // The epoch's outputs, row e of each [block_ms, n_ch] output.
      const size_t at = static_cast<size_t>(e) * n_ch + c;
      float* of = p.out_f + at;
      of[kOutIEarly * plane] = lu.i_early;
      of[kOutQEarly * plane] = lu.q_early;
      of[kOutIPrompt * plane] = ip;
      of[kOutQPrompt * plane] = qp;
      of[kOutILate * plane] = lu.i_late;
      of[kOutQLate * plane] = lu.q_late;
      of[kOutDllError * plane] = lu.code_err;
      of[kOutPllError * plane] = lu.phase_err;
      of[kOutFllError * plane] = lu.freq_err;
      of[kOutNcoCode * plane] = lu.nco_code;
      of[kOutNcoCarrier * plane] = lu.nco_carrier;
      of[kOutCarrierFreq * plane] = carrier;   // before the activity gate
      of[kOutCodeFreq * plane] = st.code_freq;
      of[kOutCn0 * plane] = cn0;
      of[kOutPllLock * plane] = lu.pll_lock;
      of[kOutFllLock * plane] = lu.fll_lock;
      of[kOutRemCode * plane] = cr.rem_code;
      of[kOutBitIpSum * plane] = bit_ip_sum;
      int* oi = p.out_i + at;
      oi[kOutLockState * plane] = lu.lock_state;
      oi[kOutFlags * plane] = flags;
      oi[kOutUnread * plane] = unread;
      oi[kOutRequired * plane] = st.required;
      bool* ob = p.out_b + at;
      ob[kOutActive * plane] = active;
      ob[kOutBitReady * plane] = bit_complete;

      if (e + 1 < n_epochs) {
        st = epoch_start(k, sc, cr, tracking, e + 1, kSp, geo);
      }
    }
    __syncthreads();
  }

  if (threadIdx.x < kHistBins) {
    p.new_hist[c * kHistBins + threadIdx.x] = hist[threadIdx.x];
  }
  if (!updater) return;
  // Per-block rail re-anchoring (runtime.py::_slew_anchor).
  if (sc.slew_on && (cr.flags & kFlagBitSync) != 0) {
    anchor = add(anchor, sydr::clamp(sub(cr.carrier, anchor),
                                     -sc.slew_step, sc.slew_step));
  }
  float* nf = p.new_f + c;
  nf[kCarrierFreq * n_ch] = cr.carrier;
  nf[kFreqAnchor * n_ch] = anchor;
  nf[kCodeFreqOffset * n_ch] = cr.code_off;
  nf[kRemCarrier * n_ch] = cr.rem_carrier;
  nf[kRemCode * n_ch] = cr.rem_code;
  nf[kDllMemory * n_ch] = cr.dll_mem;
  nf[kPllMemory * n_ch] = cr.pll_mem;
  nf[kFllMemory * n_ch] = cr.fll_mem;
  nf[kFllVel * n_ch] = cr.fll_vel;
  nf[kFllAcc * n_ch] = cr.fll_acc;
  nf[kIPromptPrev * n_ch] = cr.ip_prev;
  nf[kQPromptPrev * n_ch] = cr.qp_prev;
  nf[kIpSum * n_ch] = cr.ip_sum;
  nf[kQpSum * n_ch] = cr.qp_sum;
  nf[kCn0RatioSum * n_ch] = cr.ratio_sum;
  nf[kIpSqSum * n_ch] = cr.ip_sq;
  nf[kQpSqSum * n_ch] = cr.qp_sq;
  nf[kCn0 * n_ch] = cr.cn0;
  nf[kPllLock * n_ch] = cr.pll_lock;
  nf[kFllLock * n_ch] = cr.fll_lock;
  int* ni = p.new_i + c;
  ni[kMode * n_ch] = p.state_i[kMode][c];
  ni[kFlags * n_ch] = cr.flags;
  ni[kUnread * n_ch] = cr.unread;
  ni[kCodeCounter * n_ch] = cr.code_counter;
  ni[kMsCounter * n_ch] = cr.ms_counter;
  ni[kBitEdge * n_ch] = cr.bit_edge;
  ni[kAccumCount * n_ch] = cr.accum_count;
  ni[kLockState * n_ch] = cr.lock_state;
}

template <int kProf, int kOrder, int kSp>
cudaError_t launch(const LoopConsts& k, const ScanConsts& sc,
                   const ScanArgs& p, int n_ch, int n_epochs, int n_window,
                   cudaStream_t stream) {
  scan_block_kernel<kProf, kOrder, kSp><<<n_ch, kThreads, 0, stream>>>(
      k, sc, p, n_ch, n_epochs, n_window);
  return cudaGetLastError();
}

// The spacing counts each profile's loops read: borre 3 to kMaxSpacings
// (the loops read the first three), kaplan 5, narrow-only kaplan 3.
bool spacings_fit(int profile, int n) {
  switch (profile) {
    case kProfileBorre:
      return n >= 3 && n <= kMaxSpacings;
    case kProfileKaplan:
      return n == 5;
    default:
      return n == 3;
  }
}

}  // namespace

extern "C" const char* sydr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One block of the scan runtime: `consts`, `scan` and `args` are host
// structs, copied into the launch's parameters; `n_window` is the length
// of the window planes. Returns cudaErrorInvalidValue, launching nothing,
// for what the kernel does not take.
extern "C" int scan_block_launch(const sydr::LoopConsts* consts,
                                 const sydr::ScanConsts* scan,
                                 const sydr::ScanArgs* args, int n_ch,
                                 int n_epochs, int n_window, void* stream) {
  if (consts == nullptr || scan == nullptr || args == nullptr || n_ch < 1 ||
      n_epochs < 1 || n_window < 0 || scan->samples_per_ms < 1 ||
      scan->tail_ms < 0 || scan->window_size < 1 ||
      scan->window_size > (1 << 24) ||
      consts->profile < sydr::kProfileBorre ||
      consts->profile > sydr::kProfileKaplanNarrowOnly ||
      (consts->dlf_order != 2 && consts->dlf_order != 3) ||
      !spacings_fit(consts->profile, scan->n_spacings)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const bool third = consts->dlf_order == 3;
  const auto& k = *consts;
  const auto& sc = *scan;
  const auto& p = *args;
  cudaError_t err;
  switch (consts->profile) {
    case sydr::kProfileBorre:      // no DLF
      err = sc.n_spacings == 3
                ? launch<sydr::kProfileBorre, 2, 3>(k, sc, p, n_ch, n_epochs,
                                                    n_window, s)
            : sc.n_spacings == 4
                ? launch<sydr::kProfileBorre, 2, 4>(k, sc, p, n_ch, n_epochs,
                                                    n_window, s)
                : launch<sydr::kProfileBorre, 2, 5>(k, sc, p, n_ch, n_epochs,
                                                    n_window, s);
      break;
    case sydr::kProfileKaplan:
      err = third ? launch<sydr::kProfileKaplan, 3, 5>(k, sc, p, n_ch,
                                                       n_epochs, n_window, s)
                  : launch<sydr::kProfileKaplan, 2, 5>(k, sc, p, n_ch,
                                                       n_epochs, n_window, s);
      break;
    default:
      err = third ? launch<sydr::kProfileKaplanNarrowOnly, 3, 3>(
                        k, sc, p, n_ch, n_epochs, n_window, s)
                  : launch<sydr::kProfileKaplanNarrowOnly, 2, 3>(
                        k, sc, p, n_ch, n_epochs, n_window, s);
  }
  return static_cast<int>(err);
}
