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
// catch-up and the new state, its rail anchor slewed toward the carrier
// (channels/runtime.py::_slew_anchor, which the plain version,
// ops/loop_kernel.py::pass_c_plain, runs after _pass_c). Every operation
// rounds as the plain version's op does on the card (loop_update.cuh), so
// the two agree bit for bit wherever the card's math functions do.
//
// Bound on the H100: latency. The bytes (the correlators in, ~25 words a
// channel and epoch out) and the operations are microseconds below what one
// launch costs; what cannot be shortened is the chain of dependent
// operations that carries one epoch into the next. Most of an epoch's work
// does not depend on that carry: the discriminators' raw values (NNEML,
// the Costas atanf, the FLL against the previous active epoch's prompt),
// the lock indicators' inputs, the Beaulieu terms and the epoch counters
// follow from the block's inputs alone. So the design keeps only the
// carried work in series:
//   - a warp a channel, lane e taking epoch e of a tile of 32 (a block of
//     more than 32 epochs runs tile after tile, the carry in registers);
//     a few warps a CTA, so that a session's channels spread over SMs and no
//     step crosses channels (a channel shard computes what the full launch
//     computes);
//   - the CTA's inputs of a tile (correlators, required, unread, the next
//     epoch's code phase, activity) staged in shared memory by cp.async
//     before any arithmetic;
//   - phase A, lane = epoch: discriminate (loop_update.cuh), the previous
//     active epoch's prompt by __ballot_sync and __shfl_sync, the code and
//     ms counters as prefix counts (__popc);
//   - phase B, in series: filter_step, the rails, the carrier step bound and
//     the virtual NCO, epoch by epoch, every lane computing the same carry
//     (the next epoch's inputs fetched by __shfl_sync one epoch ahead); lane
//     e keeps epoch e's values;
//   - phase C, lane = epoch: the derotation (sinf, cosf) and the bit-edge
//     flip candidates;
//   - phase D, in series: the histogram (bin b in lane b, its sum, maximum
//     and first maximal bin by warp reductions, taken again only when a
//     flip changed it), the declaration and the accumulators, in the plain
//     version's order of additions, the epochs at the bit edge a ballot
//     mask (taken again when a declaration moves the edge); then C/N0 at
//     the tile's bit completions, one after the other (powf and log10f off
//     the epoch loop);
//   - each lane puts its epoch's outputs in shared memory, and the CTA
//     stores them a row at a time, its channels side by side (each output
//     row is [epoch][channel] in device memory: a lane's own epoch is 32
//     lines away from its neighbour's);
// and the loops' configuration (profile, DLF order) is compiled in, the
// rails that are off taken as infinite bounds, so that the serial loop has
// no branches.
// Launched on the caller's stream without a synchronisation, so it is
// captured into the session's step graph like K1 and K3.

#include <cuda_pipeline.h>

#include <climits>
#include <cstddef>

#include "channel_layout.cuh"
#include "loop_update.cuh"

namespace sydr {

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

constexpr int kTile = 32;            // epochs a tile: a warp's lanes
constexpr int kMaxWarps = 8;         // warps (channels) a CTA
constexpr int kMinStreams = 6;
constexpr unsigned kFull = 0xffffffffu;
// The slab's output rows: OutF's, then OutI's from kRowI, then OutB's from
// kRowB.
constexpr int kRowI = kNumOutF;
constexpr int kRowB = kRowI + kNumOutI;
constexpr int kOutRows = kRowB + kNumOutB;

// A CTA's shared memory for one tile, for `warps` channels and `streams`
// correlator streams, each [epoch][channel](stream): the inputs, and the
// outputs (32-bit words, [row][epoch][channel]) on their way out.
struct Slab {
  float* corr;         // [kTile][warps][streams]
  float* rem_next;     // [kTile][warps]: rem_code of the next epoch
  int* required;       // [kTile][warps]
  int* unread;         // [kTile][warps]
  int* out;            // [kOutRows][kTile][warps]
  bool* active;        // [kTile][warps]
};

__host__ __device__ constexpr size_t slab_bytes(int warps, int streams) {
  return static_cast<size_t>(kTile) * warps *
         (4 * streams + 13 + 4 * kOutRows);
}

__device__ __forceinline__ Slab slab_of(unsigned char* base, int warps,
                                        int streams) {
  Slab s;
  const int cells = kTile * warps;
  s.corr = reinterpret_cast<float*>(base);
  s.rem_next = s.corr + cells * streams;
  s.required = reinterpret_cast<int*>(s.rem_next + cells);
  s.unread = s.required + cells;
  s.out = s.unread + cells;
  s.active = reinterpret_cast<bool*>(s.out + kOutRows * cells);
  return s;
}

// The CTA's inputs of epochs [e0, e0 + m) for its `live` channels from c0,
// copied into the slab by every thread; the caller waits and synchronises.
__device__ __forceinline__ void stage_tile(const PassCArgs& p, const Slab& s,
                                           int warps, int live, int c0,
                                           int e0, int m, int n_ch,
                                           int n_epochs, int streams,
                                           int active_stride) {
  const int run = live * streams;    // an epoch's words of the CTA's channels
  for (int i = threadIdx.x; i < m * run; i += blockDim.x) {
    const int e = i / run, j = i - e * run;
    __pipeline_memcpy_async(
        s.corr + e * warps * streams + j,
        p.corr + (static_cast<size_t>(e0 + e) * n_ch + c0) * streams + j, 4);
  }
  for (int i = threadIdx.x; i < m * live; i += blockDim.x) {
    const int e = i / live, w = i - e * live;
    const size_t at = static_cast<size_t>(e0 + e) * n_ch + c0 + w;
    const int cell = e * warps + w;
    __pipeline_memcpy_async(s.required + cell, p.required + at, 4);
    __pipeline_memcpy_async(s.unread + cell, p.unread_after + at, 4);
    __pipeline_memcpy_async(
        s.rem_next + cell,
        e0 + e + 1 < n_epochs ? p.rem_code + at + n_ch
                              : p.rem_code_end + c0 + w,
        4);
    s.active[cell] =
        p.active[static_cast<size_t>(e0 + e) * active_stride + c0 + w];
  }
  __pipeline_commit();
}

// One channel's carry from epoch to epoch (and tile to tile): the same
// value in every lane of its warp, but `hist`, bin `lane` of the bit-edge
// histogram (lanes from kHistBins on hold 0).
struct Carry {
  float carrier, code_off, phi_virt, chip_virt;
  float dll_mem, pll_mem, fll_mem, fll_vel, fll_acc, pll_lock, fll_lock;
  float ip_prev, qp_prev, ipc_prev;
  float ip_sum, qp_sum, ip_sq, qp_sq, ratio_sum, cn0;
  int lock_state, flags, code_counter, ms_counter, bit_edge, accum_count;
  int hist;
};

// What lane e keeps of epoch e from the serial phases.
struct Rec {
  int lock_pre;        // the lock state before the epoch
  float pll_pre;       // the PLL lock indicator before the epoch
  float comp_phase;
  float code_err, phase_err, freq_err, nco_code, nco_carrier, carrier;
  float pll_lock, fll_lock;
  int lock_state;
  float cn0;
  float bit_ip_sum, bit_qp_sum, bit_ip_sq, bit_qp_sq, bit_ratio_sum;
  int flags;
  bool bit_ready;
};

template <typename T>
__device__ __forceinline__ void keep(bool mine, T& dst, T value) {
  dst = mine ? value : dst;
}

// torch.clamp(torch.clamp(v, lo0, hi0), lo1, hi1) (one clamp: lo1 = -inf,
// hi1 = inf), its bounds' NaN cases settled once: for a v that is not NaN
// the first NaN bound in that order, if there is one, else the four
// fminf/fmaxf; v itself if v is NaN. Infinite bounds leave v as it is, so
// a rail that is off is one. No branch in an epoch loop of them.
struct Clamp2 {
  float lo0, hi0, lo1, hi1;
  float nan_bound;
  bool has_nan;

  __device__ __forceinline__ Clamp2(float l0, float h0, float l1, float h1)
      : lo0(l0), hi0(h0), lo1(l1), hi1(h1) {
    has_nan = isnan(l0) || isnan(h0) || isnan(l1) || isnan(h1);
    nan_bound = isnan(l0) ? l0 : isnan(h0) ? h0 : isnan(l1) ? l1 : h1;
  }

  __device__ __forceinline__ float operator()(float v) const {
    const float r = fminf(fmaxf(fminf(fmaxf(v, lo0), hi0), lo1), hi1);
    const float b = has_nan ? nan_bound : r;
    return isnan(v) ? v : b;
  }
};

// One channel's clamps (infinite bounds where a rail is off) and code
// rate: the same in every epoch.
struct Bounds {
  Clamp2 carrier;      // the carrier rail, then the block's step bound
  Clamp2 code;         // the code-rate rail
  float code_freq;     // GPS_L1CA_CODE_FREQ + geo["delta"]
};

// One tile of one channel's epochs [e0, e0 + m), run by its warp; its
// outputs go to the slab's `out`.
template <int kProf, int kOrder>
__device__ __forceinline__ void run_tile(
    const LoopConsts& k, const Slab& s, Carry& cr, int warps, int w,
    int lane, int m, int streams, float frozen_carrier,
    float frozen_code_off, const Bounds& b) {
  // Phase A, lane = epoch: the carry-free values.
  const bool valid = lane < m;
  const int el = valid ? lane : 0;
  const float* corr = s.corr + (el * warps + w) * streams;
  const bool act = valid && s.active[el * warps + w];
  const unsigned amask = __ballot_sync(kFull, act);
  const unsigned before = amask & ((1u << lane) - 1u);
  const unsigned through = amask & (lane == 31 ? kFull : (2u << lane) - 1u);
  const int src = before ? 31 - __clz(before) : lane;   // last active < e
  const float ip = kProf == kProfileKaplan ? corr[4] : corr[2];
  const float qp = kProf == kProfileKaplan ? corr[5] : corr[3];
  float ip_prev = __shfl_sync(kFull, ip, src);
  float qp_prev = __shfl_sync(kFull, qp, src);
  if (!before) {
    ip_prev = cr.ip_prev;
    qp_prev = cr.qp_prev;
  }
  const Disc d = discriminate(k, kProf, corr, ip_prev, qp_prev);
  const int cc = cr.code_counter + __popc(before);   // before the epoch
  const int n_through = __popc(through);
  const int ms = n_through ? mod_i(cr.ms_counter + n_through, 20)
                           : cr.ms_counter;          // after the epoch

  // Phase B, in series: the loop filters and the virtual NCO. Every lane
  // runs the same carry; epoch e + 1's inputs are fetched during epoch e.
  Rec rec = {};
  {
    float nx_dll = __shfl_sync(kFull, d.dll, 0);
    float nx_dll_w = __shfl_sync(kFull, d.dll_w, 0);
    float nx_costas = __shfl_sync(kFull, d.costas, 0);
    float nx_fll = __shfl_sync(kFull, d.fll, 0);
    float nx_pin = __shfl_sync(kFull, d.pll_lock_in, 0);
    float nx_fin = __shfl_sync(kFull, d.fll_lock_in, 0);
    int nx_cc = __shfl_sync(kFull, cc, 0);
#pragma unroll 2
    for (int e = 0; e < m; ++e) {
      Disc de = d;
      de.dll = nx_dll;
      de.dll_w = nx_dll_w;
      de.costas = nx_costas;
      de.fll = nx_fll;
      de.pll_lock_in = nx_pin;
      de.fll_lock_in = nx_fin;
      const int cc_e = nx_cc;
      const int nxt = (e + 1) & 31;
      nx_dll = __shfl_sync(kFull, d.dll, nxt);
      nx_dll_w = __shfl_sync(kFull, d.dll_w, nxt);
      nx_costas = __shfl_sync(kFull, d.costas, nxt);
      nx_fll = __shfl_sync(kFull, d.fll, nxt);
      nx_pin = __shfl_sync(kFull, d.pll_lock_in, nxt);
      nx_fin = __shfl_sync(kFull, d.fll_lock_in, nxt);
      nx_cc = __shfl_sync(kFull, cc, nxt);
      const bool active = (amask >> e) & 1u;
      const bool mine = lane == e;

      // Virtual-NCO compensation: the within-block NCO is frozen, so the
      // raw discriminators measure the full error; subtract what the
      // already applied corrections would have removed.
      LoopIn in;
      in.dll_memory = cr.dll_mem;
      in.pll_memory = cr.pll_mem;
      in.fll_vel = cr.fll_vel;
      in.fll_acc = cr.fll_acc;
      in.i_prompt_prev = 0.0f;     // discriminate's: not read here
      in.q_prompt_prev = 0.0f;
      in.pll_lock = cr.pll_lock;
      in.fll_lock = cr.fll_lock;
      in.lock_state = cr.lock_state;
      in.code_counter = cc_e;
      in.comp_freq = sub(cr.carrier, frozen_carrier);
      in.comp_phase = sub(cr.phi_virt, rintf(cr.phi_virt));
      in.comp_code = cr.chip_virt;
      keep(mine, rec.lock_pre, cr.lock_state);
      keep(mine, rec.pll_pre, cr.pll_lock);
      keep(mine, rec.comp_phase, in.comp_phase);
      const LoopOut lu = filter_step(k, kProf, kOrder, de, in, active);

      const float new_carrier = b.carrier(add(cr.carrier, lu.nco_carrier));
      const float new_code_off = b.code(sub(cr.code_off, lu.nco_code));
      const float carrier_out = active ? new_carrier : cr.carrier;
      const float code_off_out = active ? new_code_off : cr.code_off;
      keep(mine, rec.code_err, lu.code_err);
      keep(mine, rec.phase_err, lu.phase_err);
      keep(mine, rec.freq_err, lu.freq_err);
      keep(mine, rec.nco_code, lu.nco_code);
      keep(mine, rec.nco_carrier, lu.nco_carrier);
      keep(mine, rec.carrier, carrier_out);
      keep(mine, rec.pll_lock, lu.pll_lock);
      keep(mine, rec.fll_lock, lu.fll_lock);
      keep(mine, rec.lock_state, lu.lock_state);
      if (active) {
        cr.phi_virt = add(cr.phi_virt,
                          mul(sub(carrier_out, frozen_carrier), k.t_int));
        cr.chip_virt = add(cr.chip_virt,
                           mul(sub(code_off_out, frozen_code_off), k.t_int));
        cr.dll_mem = lu.code_err;
        cr.pll_mem = lu.phase_err;
        cr.fll_mem = lu.freq_err;
      }
      cr.carrier = carrier_out;
      cr.code_off = code_off_out;
      cr.fll_vel = lu.fll_vel;
      cr.fll_acc = lu.fll_acc;
      cr.lock_state = lu.lock_state;
      cr.pll_lock = lu.pll_lock;
      cr.fll_lock = lu.fll_lock;
    }
  }

  // Phase C, lane = epoch: prompts derotated by the virtual phase, so every
  // epoch of a bit sums in one frame; the bit-edge flip candidates.
  const float theta = mul(rec.comp_phase, k.two_pi);
  const float cth = cosf(theta), sth = sinf(theta);
  const float ip_c = add(mul(d.ip, cth), mul(d.qp, sth));
  const float qp_c = sub(mul(d.qp, cth), mul(d.ip, sth));
  float ipc_prev = __shfl_sync(kFull, ip_c, src);
  if (!before) ipc_prev = cr.ipc_prev;
  const bool flip = act && cc > k.min_convergence_ms &&
                    rec.pll_pre > 0.5f &&
                    sydr::sign(ipc_prev) != sydr::sign(ip_c);
  const unsigned fmask = __ballot_sync(kFull, flip);
  const float sq_i = sqr(d.ip), sq_q = sqr(d.qp);
  const float ratio = beaulieu_ratio_term(d.ip, d.qp, ip_prev, qp_prev);
  // The epochs at the bit edge `edge` (the phase in the bit,
  // (ms - edge) mod 20, is 0), a bit each: the tile's edge until a
  // declaration moves it.
  int edge = cr.bit_edge;
  unsigned emask = __ballot_sync(kFull, valid && mod_i(ms - edge, 20) == 0);

  // Phase D, in series: bit-edge sync, accumulators, C/N0.
  {
    bool rule_known = false, rule_declare = false;
    int rule_argmax = 0;
    for (int e = 0; e < m; ++e) {
      const float ipc_e = __shfl_sync(kFull, ip_c, e);
      const float qpc_e = __shfl_sync(kFull, qp_c, e);
      const float sqi_e = __shfl_sync(kFull, sq_i, e);
      const float sqq_e = __shfl_sync(kFull, sq_q, e);
      const float ratio_e = __shfl_sync(kFull, ratio, e);
      const bool active = (amask >> e) & 1u;
      const bool mine = lane == e;

      const bool had_sync = (cr.flags & kFlagBitSync) != 0;
      bool declare = false;
      if (!had_sync) {
        // The rule reads the histogram alone: take it again only after a
        // flip changed the histogram.
        if ((fmask >> e) & 1u) {
          cr.hist += lane == __shfl_sync(kFull, ms, e) ? 1 : 0;
          rule_known = false;
        }
        if (!rule_known) {
          const bool bin = lane < kHistBins;
          const int total = __reduce_add_sync(kFull, bin ? cr.hist : 0);
          const int mode =
              __reduce_max_sync(kFull, bin ? cr.hist : INT_MIN);
          rule_argmax =
              __ffs(__ballot_sync(kFull, bin && cr.hist == mode)) - 1;
          rule_declare = bit_sync_rule(k, mode, total);
          rule_known = true;
        }
        declare = rule_declare;
        if (declare && rule_argmax != edge) {
          edge = rule_argmax;
          emask = __ballot_sync(kFull, valid && mod_i(ms - edge, 20) == 0);
        }
      }
      // emask holds new_edge's epochs.
      const int new_edge = declare ? rule_argmax : cr.bit_edge;
      const bool bit_sync = had_sync || declare;
      const bool at_edge = active && bit_sync && ((emask >> e) & 1u);
      const bool bit_complete = at_edge && cr.accum_count >= 20;
      const bool accum_reset = at_edge || declare;
      const bool acc = active && bit_sync;
      keep(mine, rec.bit_ip_sum, cr.ip_sum);
      keep(mine, rec.bit_qp_sum, cr.qp_sum);
      keep(mine, rec.bit_ip_sq, cr.ip_sq);
      keep(mine, rec.bit_qp_sq, cr.qp_sq);
      keep(mine, rec.bit_ratio_sum, cr.ratio_sum);
      keep(mine, rec.bit_ready, bit_complete);
      const bool keep_sums = !accum_reset;
      const int new_accum =
          (keep_sums ? cr.accum_count : 0) + (acc ? 1 : 0);
      const float n_ip = add(keep_sums ? cr.ip_sum : 0.0f, acc ? ipc_e : 0.0f);
      const float n_qp = add(keep_sums ? cr.qp_sum : 0.0f, acc ? qpc_e : 0.0f);
      const float n_ip2 = add(keep_sums ? cr.ip_sq : 0.0f, acc ? sqi_e : 0.0f);
      const float n_qp2 = add(keep_sums ? cr.qp_sq : 0.0f, acc ? sqq_e : 0.0f);
      const float n_ratio =
          add(keep_sums ? cr.ratio_sum : 0.0f, acc ? ratio_e : 0.0f);
      const int new_flags =
          active ? (cr.flags | kFlagCodeLock | (bit_sync ? kFlagBitSync : 0))
                 : cr.flags;
      keep(mine, rec.flags, new_flags);
      cr.flags = new_flags;
      cr.bit_edge = new_edge;
      cr.accum_count = new_accum;
      cr.ip_sum = n_ip;
      cr.qp_sum = n_qp;
      cr.ip_sq = n_ip2;
      cr.qp_sq = n_qp2;
      cr.ratio_sum = n_ratio;
    }
  }

  // C/N0 at the tile's bit completions, in order: each estimate from the
  // sums before its epoch and the estimate before it; an epoch's output is
  // the estimate of the last completion up to it.
  rec.cn0 = cr.cn0;
  for (unsigned done = __ballot_sync(kFull, rec.bit_ready); done;
       done &= done - 1u) {
    const int e = __ffs(done) - 1;
    cr.cn0 = cn0_estimate(k, __shfl_sync(kFull, rec.bit_ip_sum, e),
                          __shfl_sync(kFull, rec.bit_qp_sum, e),
                          __shfl_sync(kFull, rec.bit_ip_sq, e),
                          __shfl_sync(kFull, rec.bit_qp_sq, e),
                          __shfl_sync(kFull, rec.bit_ratio_sum, e), cr.cn0);
    if (lane >= e) rec.cn0 = cr.cn0;
  }

  // Each lane puts its epoch's outputs in the slab (the CTA stores them).
  if (valid) {
    const int cells = kTile * warps;
    int* o = s.out + lane * warps + w;
    const bool wide = kProf == kProfileKaplan && rec.lock_pre != kLockNarrow;
    auto put = [&](int row, float v) { o[row * cells] = __float_as_int(v); };
    put(kOutIEarly, wide ? d.ie_w : d.ie);
    put(kOutQEarly, wide ? d.qe_w : d.qe);
    put(kOutIPrompt, d.ip);
    put(kOutQPrompt, d.qp);
    put(kOutILate, wide ? d.il_w : d.il);
    put(kOutQLate, wide ? d.ql_w : d.ql);
    put(kOutDllError, rec.code_err);
    put(kOutPllError, rec.phase_err);
    put(kOutFllError, rec.freq_err);
    put(kOutNcoCode, rec.nco_code);
    put(kOutNcoCarrier, rec.nco_carrier);
    put(kOutCarrierFreq, rec.carrier);
    put(kOutCodeFreq, b.code_freq);
    put(kOutCn0, rec.cn0);
    put(kOutPllLock, rec.pll_lock);
    put(kOutFllLock, rec.fll_lock);
    put(kOutBitIpSum, rec.bit_ip_sum);
    o[(kRowI + kOutLockState) * cells] = rec.lock_state;
    o[(kRowI + kOutFlags) * cells] = rec.flags;
    o[(kRowB + kOutActive) * cells] = act;
    o[(kRowB + kOutBitReady) * cells] = rec.bit_ready;
  }

  // The carry of the counters and previous prompts into the next tile.
  cr.code_counter += __popc(amask);
  if (amask) {
    const int last = 31 - __clz(amask);
    cr.ms_counter = mod_i(cr.ms_counter + __popc(amask), 20);
    cr.ip_prev = __shfl_sync(kFull, ip, last);
    cr.qp_prev = __shfl_sync(kFull, qp, last);
    cr.ipc_prev = __shfl_sync(kFull, ip_c, last);
  }
}

// The CTA's outputs of epochs [e0, e0 + m) from the slab, a row at a time:
// thread t takes channel t % warps of epoch t / warps (warps a power of
// two), so that a warp's stores are runs of the CTA's channels.
__device__ __forceinline__ void store_tile(const PassCArgs& p, const Slab& s,
                                           int warps, int live, int c0,
                                           int e0, int m, int n_ch,
                                           int n_epochs) {
  const int w = threadIdx.x & (warps - 1);
  const int e = threadIdx.x / warps;
  if (w >= live || e >= m) return;
  const int cells = kTile * warps, cell = e * warps + w;
  const size_t plane = static_cast<size_t>(n_epochs) * n_ch;
  const size_t at = static_cast<size_t>(e0 + e) * n_ch + c0 + w;
  const int* o = s.out + cell;
  int* of = reinterpret_cast<int*>(p.out_f) + at;
#pragma unroll
  for (int r = 0; r < kNumOutF; ++r) {
    if (r != kOutRemCode) of[r * plane] = o[r * cells];
  }
  of[kOutRemCode * plane] = __float_as_int(s.rem_next[cell]);
  int* oi = p.out_i + at;
  oi[kOutLockState * plane] = o[(kRowI + kOutLockState) * cells];
  oi[kOutFlags * plane] = o[(kRowI + kOutFlags) * cells];
  oi[kOutUnread * plane] = s.unread[cell];
  oi[kOutRequired * plane] = s.required[cell];
  bool* ob = p.out_b + at;
  ob[kOutActive * plane] = o[(kRowB + kOutActive) * cells];
  ob[kOutBitReady * plane] = o[(kRowB + kOutBitReady) * cells];
}

template <int kProf, int kOrder>
__global__ void __launch_bounds__(kMaxWarps * 32)
    pass_c_kernel(const LoopConsts k, const PassCArgs p, int n_ch,
                  int n_epochs, int n_streams, int active_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c0 = blockIdx.x * warps;
  const int live = min(warps, n_ch - c0);   // the CTA's channels
  const int c = c0 + w;
  const Slab s = slab_of(smem, warps, n_streams);

  // The state, read before the first tile's copies land.
  Carry cr = {};
  float frozen_carrier = 0.0f, frozen_code_off = 0.0f, anchor = 0.0f;
  float delta = 0.0f;
  if (w < live) {
    frozen_carrier = p.state_f[kCarrierFreq][c];
    frozen_code_off = p.state_f[kCodeFreqOffset][c];
    anchor = p.state_f[kFreqAnchor][c];
    delta = p.delta[c];
    cr.carrier = frozen_carrier;
    cr.code_off = frozen_code_off;
    cr.dll_mem = p.state_f[kDllMemory][c];
    cr.pll_mem = p.state_f[kPllMemory][c];
    cr.fll_mem = p.state_f[kFllMemory][c];
    cr.fll_vel = p.state_f[kFllVel][c];
    cr.fll_acc = p.state_f[kFllAcc][c];
    cr.ip_prev = p.state_f[kIPromptPrev][c];
    cr.qp_prev = p.state_f[kQPromptPrev][c];
    cr.ipc_prev = cr.ip_prev;
    cr.ip_sum = p.state_f[kIpSum][c];
    cr.qp_sum = p.state_f[kQpSum][c];
    cr.ratio_sum = p.state_f[kCn0RatioSum][c];
    cr.ip_sq = p.state_f[kIpSqSum][c];
    cr.qp_sq = p.state_f[kQpSqSum][c];
    cr.cn0 = p.state_f[kCn0][c];
    cr.pll_lock = p.state_f[kPllLock][c];
    cr.fll_lock = p.state_f[kFllLock][c];
    cr.flags = p.state_i[kFlags][c];
    cr.code_counter = p.state_i[kCodeCounter][c];
    cr.ms_counter = p.state_i[kMsCounter][c];
    cr.bit_edge = p.state_i[kBitEdge][c];
    cr.accum_count = p.state_i[kAccumCount][c];
    cr.lock_state = p.state_i[kLockState][c];
    cr.hist = lane < kHistBins ? p.edge_hist[c * kHistBins + lane] : 0;
  }
  const float inf = __int_as_float(0x7f800000);
  const Bounds b = {
      Clamp2(k.freq_rail_on ? sub(anchor, k.freq_rail) : -inf,
             k.freq_rail_on ? add(anchor, k.freq_rail) : inf,
             k.block_step_on ? sub(frozen_carrier, k.block_step) : -inf,
             k.block_step_on ? add(frozen_carrier, k.block_step) : inf),
      Clamp2(k.code_rail_on ? -k.code_rail : -inf,
             k.code_rail_on ? k.code_rail : inf, -inf, inf),
      add(delta, k.code_freq)};

  for (int e0 = 0; e0 < n_epochs; e0 += kTile) {
    const int m = min(kTile, n_epochs - e0);
    if (e0 > 0) __syncthreads();      // the last tile's slab is stored
    stage_tile(p, s, warps, live, c0, e0, m, n_ch, n_epochs, n_streams,
               active_stride);
    __pipeline_wait_prior(0);
    __syncthreads();
    if (w < live) {
      run_tile<kProf, kOrder>(k, s, cr, warps, w, lane, m, n_streams,
                              frozen_carrier, frozen_code_off, b);
    }
    __syncthreads();
    store_tile(p, s, warps, live, c0, e0, m, n_ch, n_epochs);
  }
  if (w >= live) return;

  // End-of-block phase catch-up: realise the virtual-NCO phase the
  // within-block corrections assumed. Then the per-block rail re-anchoring
  // (runtime.py::_slew_anchor) on the new state.
  if (lane < kHistBins) p.new_hist[c * kHistBins + lane] = cr.hist;
  if (lane != 0) return;
  if (k.slew_on && (cr.flags & kFlagBitSync) != 0) {
    anchor = add(anchor, sydr::clamp(sub(cr.carrier, anchor), -k.slew_step,
                                     k.slew_step));
  }
  float* nf = p.new_f + c;
  nf[kCarrierFreq * n_ch] = cr.carrier;
  nf[kFreqAnchor * n_ch] = anchor;
  nf[kCodeFreqOffset * n_ch] = cr.code_off;
  nf[kRemCarrier * n_ch] = sydr::mod_f(
      sub(p.rem_carrier_end[c], mul(cr.phi_virt, k.two_pi)), k.two_pi);
  nf[kRemCode * n_ch] = add(p.rem_code_end[c], cr.chip_virt);
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
  ni[kUnread * n_ch] = p.unread_end[c];
  ni[kCodeCounter * n_ch] = cr.code_counter;
  ni[kMsCounter * n_ch] = cr.ms_counter;
  ni[kBitEdge * n_ch] = cr.bit_edge;
  ni[kAccumCount * n_ch] = cr.accum_count;
  ni[kLockState * n_ch] = cr.lock_state;
}

template <int kProf, int kOrder>
cudaError_t launch(const LoopConsts& k, const PassCArgs& p, int n_ch,
                   int n_epochs, int n_streams, int active_stride, int warps,
                   cudaStream_t stream) {
  const int blocks = (n_ch + warps - 1) / warps;
  const size_t smem = slab_bytes(warps, n_streams);
  pass_c_kernel<kProf, kOrder><<<blocks, warps * 32, smem, stream>>>(
      k, p, n_ch, n_epochs, n_streams, active_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* sydr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One block's pass C: `consts` and `args` are host structs, copied into the
// launch's parameters. `active_stride` is the row stride of `active` in
// elements (0 for a row broadcast over the epochs, n_ch when contiguous);
// `warps` the channels (warps) a CTA: 1, 2, 4 or 8.
extern "C" int pass_c_launch(const sydr::LoopConsts* consts,
                             const sydr::PassCArgs* args,
                             int n_ch, int n_epochs, int n_streams,
                             int active_stride, int warps, void* stream) {
  if (consts == nullptr || args == nullptr || n_ch < 1 || n_epochs < 1 ||
      n_streams < kMinStreams || active_stride < 0 || warps < 1 ||
      warps > kMaxWarps || (warps & (warps - 1)) != 0 ||
      (consts->profile == sydr::kProfileKaplan && n_streams < 10) ||
      consts->profile < sydr::kProfileBorre ||
      consts->profile > sydr::kProfileKaplanNarrowOnly ||
      (consts->dlf_order != 2 && consts->dlf_order != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const bool third = consts->dlf_order == 3;
  cudaError_t err;
  switch (consts->profile) {
    case sydr::kProfileBorre:      // no DLF
      err = launch<sydr::kProfileBorre, 2>(*consts, *args, n_ch, n_epochs,
                                           n_streams, active_stride, warps,
                                           s);
      break;
    case sydr::kProfileKaplan:
      err = third ? launch<sydr::kProfileKaplan, 3>(
                        *consts, *args, n_ch, n_epochs, n_streams,
                        active_stride, warps, s)
                  : launch<sydr::kProfileKaplan, 2>(
                        *consts, *args, n_ch, n_epochs, n_streams,
                        active_stride, warps, s);
      break;
    default:
      err = third ? launch<sydr::kProfileKaplanNarrowOnly, 3>(
                        *consts, *args, n_ch, n_epochs, n_streams,
                        active_stride, warps, s)
                  : launch<sydr::kProfileKaplanNarrowOnly, 2>(
                        *consts, *args, n_ch, n_epochs, n_streams,
                        active_stride, warps, s);
  }
  return static_cast<int>(err);
}
