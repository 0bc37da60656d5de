// Pass C of the batched tracking runtime: one block's epochs replayed through
// the tracking loops, one launch a block.
//
// Replaces no Pallas kernel. Its counterpart in the JAX package is the
// XLA-fused lax.scan of sydr_tpu/channels/batch_runtime.py::_pass_c
// (jax.lax.scan(step, init, inputs, unroll=True), :1205, inside the jitted
// run_block_batched): XLA compiles a block's epochs into one program that
// keeps the carry on chip. PyTorch runs the plain version
// (sydr_tpu_torch/channels/batch_runtime.py::_pass_c) as ~280 [n_ch]-wide
// launches an epoch, ~5,600 a 20 ms block; this kernel is one.
//
// Per epoch it computes what the plain version computes: the virtual-NCO
// compensation, the loop update (loop_update.cuh), the carrier and code
// rails and the bound on the block's carrier step, the derotated prompts,
// the bit-edge histogram and its declaration, the bit accumulators, C/N0
// and flags; each [block_ms, n_ch] output row is written where the plain
// version stacks it. After the last epoch it writes the end-of-block phase
// catch-up and the new state. Every operation rounds as the plain version's
// op does on the card (loop_update.cuh), so the two agree bit for bit
// wherever the card's math functions do.
//
// Bound on the H100: latency. A channel's epochs are a serial chain of
// scalar arithmetic (the carry of one epoch is the input of the next), some
// 20 epochs of a few hundred dependent operations with accurate atanf,
// sinf and cosf in them; the bytes (the correlators in, ~25 words a channel
// and epoch out) and the operations are microseconds below what one launch
// costs. Design: one thread per channel, so channels never wait for each
// other and a channel shard computes what the full launch computes; the
// whole carry (the JAX scan's 28 fields) and the 20-bin edge histogram in
// registers (the histogram's loops unrolled, so it is never indexed at run
// time); one warp a block, as many blocks as the channels need (one at 32
// channels). Launched on the caller's stream without a synchronisation, so
// it is captured into the session's step graph like K1 and K3.

#include <cstddef>

#include "loop_update.cuh"

namespace sydr {

// The state's float32 and int32 fields, in the order of
// channels/state.py's F32_FIELDS and I32_SCALAR_FIELDS.
enum StateF {
  kCarrierFreq,
  kFreqAnchor,
  kCodeFreqOffset,
  kRemCarrier,
  kRemCode,
  kDllMemory,
  kPllMemory,
  kFllMemory,
  kFllVel,
  kFllAcc,
  kIPromptPrev,
  kQPromptPrev,
  kIpSum,
  kQpSum,
  kCn0RatioSum,
  kIpSqSum,
  kQpSqSum,
  kCn0,
  kPllLock,
  kFllLock,
  kNumStateF
};
enum StateI {
  kMode,
  kFlags,
  kUnread,
  kCodeCounter,
  kMsCounter,
  kBitEdge,
  kAccumCount,
  kLockState,
  kNumStateI
};
// The outputs' rows, in the order of ops/loop_kernel.py's OUT_F32, OUT_I32
// and OUT_BOOL.
enum OutF {
  kOutIEarly,
  kOutQEarly,
  kOutIPrompt,
  kOutQPrompt,
  kOutILate,
  kOutQLate,
  kOutDllError,
  kOutPllError,
  kOutFllError,
  kOutNcoCode,
  kOutNcoCarrier,
  kOutCarrierFreq,
  kOutCodeFreq,
  kOutCn0,
  kOutPllLock,
  kOutFllLock,
  kOutRemCode,
  kOutBitIpSum,
  kNumOutF
};
enum OutI { kOutLockState, kOutFlags, kOutUnread, kOutRequired, kNumOutI };
enum OutB { kOutActive, kOutBitReady, kNumOutB };

// Device pointers (ops/loop_kernel.py's PassCArgs, field by field).
struct PassCArgs {
  const float* state_f[kNumStateF];   // [n_ch] each
  const int* state_i[kNumStateI];     // [n_ch] each
  const int* edge_hist;               // [n_ch, 20]
  const float* corr;                  // [block_ms, n_ch, n_streams]
  const bool* active;                 // [block_ms, n_ch], row stride given
  const int* required;                // [block_ms, n_ch]
  const int* unread_after;            // [block_ms, n_ch]
  const float* rem_code;              // [block_ms, n_ch]
  const float* rem_code_end;          // [n_ch]
  const float* rem_carrier_end;       // [n_ch]
  const float* delta;                 // [n_ch]
  const int* unread_end;              // [n_ch]
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

constexpr int kThreads = 32;
constexpr int kMinStreams = 6;

__global__ void __launch_bounds__(kThreads)
    pass_c_kernel(const LoopConsts k, const PassCArgs p, int n_ch,
                  int n_epochs, int n_streams, int active_stride) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_ch) return;

  const float frozen_carrier = p.state_f[kCarrierFreq][c];
  const float frozen_code_off = p.state_f[kCodeFreqOffset][c];
  const float anchor = p.state_f[kFreqAnchor][c];
  float carrier = frozen_carrier, code_off = frozen_code_off;
  float dll_mem = p.state_f[kDllMemory][c];
  float pll_mem = p.state_f[kPllMemory][c];
  float fll_mem = p.state_f[kFllMemory][c];
  float fll_vel = p.state_f[kFllVel][c];
  float fll_acc = p.state_f[kFllAcc][c];
  float ip_prev = p.state_f[kIPromptPrev][c];
  float qp_prev = p.state_f[kQPromptPrev][c];
  float ip_sum = p.state_f[kIpSum][c];
  float qp_sum = p.state_f[kQpSum][c];
  float ratio_sum = p.state_f[kCn0RatioSum][c];
  float ip_sq = p.state_f[kIpSqSum][c];
  float qp_sq = p.state_f[kQpSqSum][c];
  float cn0 = p.state_f[kCn0][c];
  float pll_lock = p.state_f[kPllLock][c];
  float fll_lock = p.state_f[kFllLock][c];
  int flags = p.state_i[kFlags][c];
  int code_counter = p.state_i[kCodeCounter][c];
  int ms_counter = p.state_i[kMsCounter][c];
  int bit_edge = p.state_i[kBitEdge][c];
  int accum_count = p.state_i[kAccumCount][c];
  int lock_state = p.state_i[kLockState][c];
  int hist[kHistBins];
#pragma unroll
  for (int b = 0; b < kHistBins; ++b) hist[b] = p.edge_hist[c * kHistBins + b];
  float phi_virt = 0.0f, chip_virt = 0.0f;
  float ipc_prev = ip_prev;
  // GPS_L1CA_CODE_FREQ + geo["delta"]: the same in every epoch.
  const float code_freq = add(p.delta[c], k.code_freq);
  const size_t plane = static_cast<size_t>(n_epochs) * n_ch;

  for (int e = 0; e < n_epochs; ++e) {
    const size_t at = static_cast<size_t>(e) * n_ch + c;
    const bool active = p.active[static_cast<size_t>(e) * active_stride + c];

    // Virtual-NCO compensation: the within-block NCO is frozen, so the raw
    // discriminators measure the full error; subtract what the already
    // applied corrections would have removed.
    sydr::LoopIn in;
    in.dll_memory = dll_mem;
    in.pll_memory = pll_mem;
    in.fll_vel = fll_vel;
    in.fll_acc = fll_acc;
    in.i_prompt_prev = ip_prev;
    in.q_prompt_prev = qp_prev;
    in.pll_lock = pll_lock;
    in.fll_lock = fll_lock;
    in.lock_state = lock_state;
    in.code_counter = code_counter;
    in.comp_freq = sub(carrier, frozen_carrier);
    in.comp_phase = sub(phi_virt, rintf(phi_virt));
    in.comp_code = chip_virt;
    const sydr::LoopOut lu =
        sydr::loop_update(k, p.corr + at * n_streams, in, active);
    const float ip = lu.i_prompt, qp = lu.q_prompt;

    float new_carrier = add(carrier, lu.nco_carrier);
    if (k.freq_rail_on) {
      new_carrier = sydr::clamp(new_carrier, sub(anchor, k.freq_rail),
                                add(anchor, k.freq_rail));
    }
    if (k.block_step_on) {
      new_carrier =
          sydr::clamp(new_carrier, sub(frozen_carrier, k.block_step),
                      add(frozen_carrier, k.block_step));
    }
    float new_code_off = sub(code_off, lu.nco_code);
    if (k.code_rail_on) {
      new_code_off = sydr::clamp(new_code_off, -k.code_rail, k.code_rail);
    }

    // Prompts derotated by the virtual phase, so every epoch of a bit sums
    // in one frame.
    const float theta = mul(in.comp_phase, k.two_pi);
    const float cth = cosf(theta), sth = sinf(theta);
    const float ip_c = add(mul(ip, cth), mul(qp, sth));
    const float qp_c = sub(mul(qp, cth), mul(ip, sth));

    // Bit-edge histogram sync.
    const bool had_sync = (flags & sydr::kFlagBitSync) != 0;
    const int new_ms = active ? sydr::mod_i(ms_counter + 1, 20) : ms_counter;
    const bool sign_flip = sydr::sign(ipc_prev) != sydr::sign(ip_c);
    const bool counting = active && !had_sync &&
                          code_counter > k.min_convergence_ms &&
                          pll_lock > 0.5f;
    const bool flip_now = counting && sign_flip;
#pragma unroll
    for (int b = 0; b < kHistBins; ++b) hist[b] += (flip_now && b == new_ms);
    int argmax;
    const bool declare = !had_sync && sydr::bit_sync_declare(k, hist, argmax);
    const int new_edge = declare ? argmax : bit_edge;
    const bool bit_sync = had_sync || declare;
    const int phase_in_bit = sydr::mod_i(new_ms - new_edge, 20);
    const bool at_edge = active && bit_sync && phase_in_bit == 0;
    const bool bit_complete = at_edge && accum_count >= 20;
    const float bit_ip_sum = ip_sum;
    const bool accum_reset = at_edge || declare;
    const bool acc = active && bit_sync;
    const int new_accum = (accum_reset ? 0 : accum_count) + (acc ? 1 : 0);
    const float n_ip = add(accum_reset ? 0.0f : ip_sum, acc ? ip_c : 0.0f);
    const float n_qp = add(accum_reset ? 0.0f : qp_sum, acc ? qp_c : 0.0f);
    const float n_ip2 =
        add(accum_reset ? 0.0f : ip_sq, acc ? sydr::sqr(ip) : 0.0f);
    const float n_qp2 =
        add(accum_reset ? 0.0f : qp_sq, acc ? sydr::sqr(qp) : 0.0f);
    const float n_ratio = add(
        accum_reset ? 0.0f : ratio_sum,
        acc ? sydr::beaulieu_ratio_term(ip, qp, ip_prev, qp_prev) : 0.0f);
    const float new_cn0 =
        bit_complete ? sydr::cn0_estimate(k, ip_sum, qp_sum, ip_sq, qp_sq,
                                          ratio_sum, cn0)
                     : cn0;
    const int new_flags =
        active ? (flags | sydr::kFlagCodeLock |
                  (bit_sync ? sydr::kFlagBitSync : 0))
               : flags;
    const float carrier_out = active ? new_carrier : carrier;
    const float code_off_out = active ? new_code_off : code_off;

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
    of[kOutCarrierFreq * plane] = carrier_out;
    of[kOutCodeFreq * plane] = code_freq;
    of[kOutCn0 * plane] = new_cn0;
    of[kOutPllLock * plane] = lu.pll_lock;
    of[kOutFllLock * plane] = lu.fll_lock;
    of[kOutRemCode * plane] =
        e + 1 < n_epochs ? p.rem_code[at + n_ch] : p.rem_code_end[c];
    of[kOutBitIpSum * plane] = bit_ip_sum;
    int* oi = p.out_i + at;
    oi[kOutLockState * plane] = lu.lock_state;
    oi[kOutFlags * plane] = new_flags;
    oi[kOutUnread * plane] = p.unread_after[at];
    oi[kOutRequired * plane] = p.required[at];
    bool* ob = p.out_b + at;
    ob[kOutActive * plane] = active;
    ob[kOutBitReady * plane] = bit_complete;

    if (active) {
      phi_virt = add(phi_virt, mul(sub(carrier_out, frozen_carrier), k.t_int));
      chip_virt =
          add(chip_virt, mul(sub(code_off_out, frozen_code_off), k.t_int));
      dll_mem = lu.code_err;
      pll_mem = lu.phase_err;
      fll_mem = lu.freq_err;
      ip_prev = ip;
      qp_prev = qp;
      code_counter += 1;
      ipc_prev = ip_c;
    }
    carrier = carrier_out;
    code_off = code_off_out;
    fll_vel = lu.fll_vel;
    fll_acc = lu.fll_acc;
    lock_state = lu.lock_state;
    flags = new_flags;
    ms_counter = new_ms;
    bit_edge = new_edge;
    accum_count = new_accum;
    ip_sum = n_ip;
    qp_sum = n_qp;
    ip_sq = n_ip2;
    qp_sq = n_qp2;
    ratio_sum = n_ratio;
    cn0 = new_cn0;
    pll_lock = lu.pll_lock;
    fll_lock = lu.fll_lock;
  }

  // End-of-block phase catch-up: realise the virtual-NCO phase the
  // within-block corrections assumed.
  float* nf = p.new_f + c;
  nf[kCarrierFreq * n_ch] = carrier;
  nf[kFreqAnchor * n_ch] = anchor;
  nf[kCodeFreqOffset * n_ch] = code_off;
  nf[kRemCarrier * n_ch] = sydr::mod_f(
      sub(p.rem_carrier_end[c], mul(phi_virt, k.two_pi)), k.two_pi);
  nf[kRemCode * n_ch] = add(p.rem_code_end[c], chip_virt);
  nf[kDllMemory * n_ch] = dll_mem;
  nf[kPllMemory * n_ch] = pll_mem;
  nf[kFllMemory * n_ch] = fll_mem;
  nf[kFllVel * n_ch] = fll_vel;
  nf[kFllAcc * n_ch] = fll_acc;
  nf[kIPromptPrev * n_ch] = ip_prev;
  nf[kQPromptPrev * n_ch] = qp_prev;
  nf[kIpSum * n_ch] = ip_sum;
  nf[kQpSum * n_ch] = qp_sum;
  nf[kCn0RatioSum * n_ch] = ratio_sum;
  nf[kIpSqSum * n_ch] = ip_sq;
  nf[kQpSqSum * n_ch] = qp_sq;
  nf[kCn0 * n_ch] = cn0;
  nf[kPllLock * n_ch] = pll_lock;
  nf[kFllLock * n_ch] = fll_lock;
  int* ni = p.new_i + c;
  ni[kMode * n_ch] = p.state_i[kMode][c];
  ni[kFlags * n_ch] = flags;
  ni[kUnread * n_ch] = p.unread_end[c];
  ni[kCodeCounter * n_ch] = code_counter;
  ni[kMsCounter * n_ch] = ms_counter;
  ni[kBitEdge * n_ch] = bit_edge;
  ni[kAccumCount * n_ch] = accum_count;
  ni[kLockState * n_ch] = lock_state;
#pragma unroll
  for (int b = 0; b < kHistBins; ++b) p.new_hist[c * kHistBins + b] = hist[b];
}

}  // namespace

extern "C" const char* sydr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One block's pass C: `consts` and `args` are host structs, copied into the
// launch's parameters. `active_stride` is the row stride of `active` in
// elements (0 for a row broadcast over the epochs, n_ch when contiguous).
extern "C" int pass_c_launch(const sydr::LoopConsts* consts,
                             const sydr::PassCArgs* args,
                             int n_ch, int n_epochs, int n_streams,
                             int active_stride, void* stream) {
  if (consts == nullptr || args == nullptr || n_ch < 1 || n_epochs < 1 ||
      n_streams < kMinStreams || active_stride < 0 ||
      (consts->profile == sydr::kProfileKaplan && n_streams < 10)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n_ch + kThreads - 1) / kThreads;
  pass_c_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *consts, *args, n_ch, n_epochs, n_streams, active_stride);
  return static_cast<int>(cudaGetLastError());
}
