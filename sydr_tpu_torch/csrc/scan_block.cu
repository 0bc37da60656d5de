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
// update, so the correlation sits inside the carry. Only that carried
// chain is serial: the correlators, discriminate, filter_step, the rails,
// the carry and the next epoch's start, whose geometry the correlation
// reads. The design:
//   - a cluster of kCluster = 4 CTAs a channel (the same for every
//     configuration: ops/scan_kernel.py::SCAN_CLUSTER), so that no step
//     crosses channels: a channel shard computes what the full launch
//     computes, and two runs are bit-identical;
//   - in each CTA, kThreads correlating threads (warps 2 on), the loop
//     warp (warp 0) and the bookkeeping warp (warp 1); the channel's code
//     row staged in every CTA's shared memory;
//   - the cluster's kCluster x kThreads threads stride over the epoch's
//     samples (the window read at the channel's pointer, zero past its end; a
//     thread's first sample loaded an epoch ahead, its next one before
//     the arithmetic), each summing its products in sample order; a
//     butterfly of shuffles within each warp; then lane q of every warp
//     stores the warp's sums into CTA q's shared memory (st.async, a slot
//     by epoch parity), their bytes counted on CTA q's mbarrier of that
//     parity (complete_tx);
//   - each CTA's loop warp arrives on its mbarrier expecting the cluster's
//     bytes, waits for the phase (acquire), adds the C x kWarps partials
//     in one fixed tree across its lanes (the same order in every CTA),
//     and runs the same loop update on every lane: every CTA holds the
//     same carry bit for bit, so nothing is broadcast back;
//   - the loop warp publishes the next epoch's geometry (a named barrier
//     the correlating warps wait on) as soon as the chain has it; then,
//     while the next correlation runs, the next phase advance (the
//     doubles and fmodf) and, on rank 0, the epoch's record (its outputs
//     as the chain has them) into a ring in shared memory;
//   - rank 0's bookkeeping warp takes each record while the next epoch's
//     chain runs (the correlating warps wait then, so it steals them no
//     issue slots): the bit-edge histogram (a bin a lane, its declaration
//     by warp reductions), C/N0, the bit sums and flags, then the epoch's
//     24 outputs, each row's by one of 24 lanes at once (the [row, epoch,
//     channel] layout puts a channel's values n_ch apart, so a CTA's
//     stores cannot coalesce);
//   - rank 0 alone writes the outputs and the new state.
// The loops' configuration (profile, DLF order) and the spacing count are
// compiled in. Launched on the caller's stream without a
// synchronisation, so the session's step graph captures it.

#include <climits>
#include <cstddef>
#include <cstdint>

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

constexpr int kThreads = 256;                 // correlating threads a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kLoopThreads = 64;     // the loop warp and the bookkeeping's
constexpr int kBlock = kThreads + kLoopThreads;
constexpr int kRing = 4;             // the bookkeeping's record slots
constexpr int kCluster = 4;          // CTAs a channel
constexpr int kCodeLen = 1025;       // the padded code row
constexpr int kNumOut = kNumOutF + kNumOutI + kNumOutB;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBarGeometry = 1;      // named barrier: the geometry is out
constexpr int kGeometryThreads = kThreads + 32;   // its threads

// The least power of two at or above n.
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// What the threads read of an epoch for its correlation.
struct Geometry {
  float step;                  // code_step
  float rem_code;              // the chip index's offset, before a spacing
  float rate;                  // carrier radians a sample
  float rem_carrier;
  int read_ptr;
  int n_valid;                 // samples summed: required, within the window
  int next_read_ptr;           // the next epoch's read pointer
  int epoch;                   // the epoch it is for
};

// The loops' state from epoch to epoch, in every lane of the loop warp
// (the bookkeeping warp keeps the rest).
struct Carry {
  float carrier, code_off, rem_carrier, rem_code;
  float dll_mem, pll_mem, fll_mem, fll_vel, fll_acc;
  float ip_prev, qp_prev, pll_lock, fll_lock;
  int unread, code_counter, lock_state;
};

// What an epoch's start gives before its correlation.
struct Start {
  float delta, code_freq, omega;
  int unread, required;
  bool active;
};

// --- Cluster primitives ------------------------------------------------

// Arrive (release) and wait (acquire) at the cluster's barrier, every
// thread of every CTA.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n\t"
      "barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of this CTA's shared `addr` in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t in_rank(uint32_t addr, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a) : "r"(addr), "r"(rank));
  return a;
}

// Two floats into a CTA's shared memory (`addr`, a cluster address), their
// 8 bytes counted on that CTA's mbarrier `bar` when they have landed.
__device__ __forceinline__ void store_async(uint32_t addr, float x, float y,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];"
      :: "r"(addr), "f"(x), "f"(y), "r"(bar) : "memory");
}

// This CTA's arrival on its mbarrier `bar`, expecting `bytes` more.
__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait for the phase of parity `parity` of this CTA's mbarrier `bar` to
// complete, with acquire at cluster scope (the exchange's barriers, which
// other CTAs' stores complete) or at CTA scope (the record's).
template <bool kClusterScope>
__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    if (kClusterScope) {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
          "[%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } else {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
  }
}

// One arrival on this CTA's mbarrier `bar` (release at CTA scope).
__device__ __forceinline__ void arrive_local(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar)
               : "memory");
}

// An mbarrier of one arrival a phase.
__device__ __forceinline__ void init_barrier(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar)
               : "memory");
}

// Named barrier kBarGeometry: the loop warp arrives, the correlating warps
// wait.
__device__ __forceinline__ void geometry_out() {
  asm volatile("bar.arrive %0, %1;"
               :: "n"(kBarGeometry), "n"(kGeometryThreads) : "memory");
}

__device__ __forceinline__ void geometry_wait() {
  asm volatile("bar.sync %0, %1;"
               :: "n"(kBarGeometry), "n"(kGeometryThreads) : "memory");
}

// Whether the phase of parity `parity` of this CTA's mbarrier `bar` has
// completed, without waiting.
__device__ __forceinline__ bool phase_done(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// --- The protocol check ------------------------------------------------
//
// Built with -DSCAN_CHECK_PROTOCOL (ops/scan_kernel.py::SCAN_CHECK_KERNEL,
// for tests and tools), the kernel checks its own hand-offs as it runs and
// counts each fault by kind in scan_protocol_faults: every exchange slot
// and record slot holds kPoison until it is written and again once it is
// consumed, so a read before its write, or a write before the previous
// read, shows as a poisoned read; each geometry carries its epoch, checked
// before and after the correlation reads it; after its wait, the exchange
// barrier's next phase must still be open (nothing else arrived). Each
// warp also sleeps a hashed 0-4 us at its hand-offs, half of the time, so
// that CTAs and warps reach them in other orders than their usual ones.
// The outputs are the production build's, bit for bit.
#ifdef SCAN_CHECK_PROTOCOL
constexpr bool kCheck = true;
#else
constexpr bool kCheck = false;
#endif
constexpr uint32_t kPoison = 0x7fa5deadu;   // a NaN that no sum gives
enum Fault {
  kFaultPartial,        // a partial read before it was stored
  kFaultGeometry,       // a geometry read before, or rewritten while, in use
  kFaultPhase,          // the exchange barrier a phase ahead
  kFaultRecordRead,     // a record read before it was written
  kFaultRecordWrite,    // a record written before it was consumed
  kNumFaults
};
__device__ unsigned int scan_protocol_faults[kNumFaults];

__device__ __forceinline__ void fault_if(bool bad, Fault kind) {
  if (kCheck && bad) atomicAdd(&scan_protocol_faults[kind], 1u);
}

// `x`, read from a slot, counted as a `kind` fault if it is the poison.
__device__ __forceinline__ float checked(float x, Fault kind) {
  fault_if(__float_as_uint(x) == kPoison, kind);
  return x;
}

// The check build's wait at hand-off `where` of epoch `e` in this CTA.
__device__ __forceinline__ void jitter(int e, int where) {
  if (!kCheck) return;
  uint32_t h = static_cast<uint32_t>(e) * 0x9e3779b1u ^
               static_cast<uint32_t>(where) * 0x85ebca6bu ^
               blockIdx.x * 0xc2b2ae35u;
  h ^= h >> 15;
  h *= 0x2c1b3c6du;
  h ^= h >> 12;
  h *= 0x297a2d39u;
  h ^= h >> 15;
  if ((h & 1u) == 0) __nanosleep((h >> 8) & 4095u);
}

// --- The carried chain -------------------------------------------------

// The epoch's start (runtime.py::_epoch up to the correlation) and the
// geometry the correlation reads.
__device__ __forceinline__ Start epoch_start(const LoopConsts& k,
                                             const ScanConsts& sc,
                                             const Carry& cr, bool tracking,
                                             int e, Geometry& g) {
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
  g.step = step;
  g.rem_code = cr.rem_code;
  g.rate = q.omega;
  g.rem_carrier = cr.rem_carrier;
  g.read_ptr = max(avail - q.unread, 0);
  g.n_valid = min(max(q.required, 0), sc.window_size);
  // The next epoch's pointer: its unread count needs only this epoch's
  // activity and length.
  const int left = q.active ? q.unread - q.required : q.unread;
  g.next_read_ptr = max(avail + spms - min(left + spms, avail + spms), 0);
  g.epoch = e;
  return q;
}

// The code and carrier phases after an epoch that starts at `q`
// (runtime.py::scan_phase_advance, the compiled JAX reference's roundings):
// carry-free, so the loop warp computes it while the epoch correlates.
__device__ __forceinline__ void phase_advance(const LoopConsts& k,
                                              const ScanConsts& sc,
                                              const Carry& cr,
                                              const Start& q,
                                              float& rem_code,
                                              float& rem_carrier) {
  const float req_f = static_cast<float>(q.required);
  const float whole = __double2float_rn(__dadd_rn(
      __dmul_rn(static_cast<double>(static_cast<float>(
                    q.required - sc.samples_per_ms)),
                sc.code_ratio),
      static_cast<double>(cr.rem_code)));
  rem_code = __double2float_rn(__dadd_rn(
      __dmul_rn(static_cast<double>(req_f),
                static_cast<double>(mul(q.delta, sc.rcp_fs))),
      static_cast<double>(whole)));
  rem_carrier = sydr::mod_f(sub(cr.rem_carrier, mul(q.omega, req_f)),
                            k.two_pi);
}

// --- The correlating threads -------------------------------------------

// This thread's sums over its samples of the epoch (i = first, + stride,
// ...): I and Q of each spacing, in sample order. (xr, xi) is the sample
// at `first`, loaded before the geometry came; each iteration loads the
// next one before its arithmetic.
template <int kSp>
__device__ __forceinline__ void correlate(const ScanConsts& sc,
                                          const ScanArgs& p,
                                          const float* code,
                                          const Geometry& g, int n_window,
                                          int first, int stride, float xr,
                                          float xi,
                                          float (&part)[2 * kSp]) {
  // f32(rem_code + spacing) and the code step, as doubles.
  double chip0[kSp];
#pragma unroll
  for (int s = 0; s < kSp; ++s) {
    chip0[s] = static_cast<double>(add(g.rem_code, sc.spacing[s]));
    part[2 * s] = 0.0f;
    part[2 * s + 1] = 0.0f;
  }
  const double step = static_cast<double>(g.step);
  const float rate = g.rate, rem = g.rem_carrier;
  for (int i = first; i < g.n_valid; i += stride) {
    const int next = g.read_ptr + i + stride;
    float nr = 0.0f, ni = 0.0f;   // the zero pad past the window
    if (i + stride < g.n_valid && next < n_window) {
      nr = __ldg(p.window_re + next);
      ni = __ldg(p.window_im + next);
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
    xr = nr;
    xi = ni;
  }
}

// The sample `first` of an epoch read at `read_ptr` (zero past the window
// or past window_size, where no epoch reads).
__device__ __forceinline__ void first_sample(const ScanArgs& p,
                                             const ScanConsts& sc,
                                             int read_ptr, int first,
                                             int n_window, float& xr,
                                             float& xi) {
  const int j = read_ptr + first;
  xr = 0.0f;
  xi = 0.0f;
  if (first < sc.window_size && j < n_window) {
    xr = __ldg(p.window_re + j);
    xi = __ldg(p.window_im + j);
  }
}

// The correlating warps: per epoch, wait for the geometry, correlate,
// reduce the warp, hand its sums to every CTA of the cluster, and load
// the next epoch's first sample (its read pointer is known an epoch
// ahead).
template <int kSp>
__device__ __forceinline__ void correlating_warps(
    const ScanConsts& sc, const ScanArgs& p, const float* code,
    const Geometry* geo, float (*red)[kCluster * kWarps][2 * kSp],
    const uint64_t* full, uint32_t rank, int n_epochs,
    int n_window) {
  const int t = static_cast<int>(threadIdx.x) - kLoopThreads;
  const int w = t >> 5, lane = t & 31;
  const int first = static_cast<int>(rank) * kThreads + t;
  const int stride = kCluster * kThreads;
  float xr, xi;
  for (int e = 0; e < n_epochs; ++e) {
    __syncwarp();
    geometry_wait();
    const Geometry g = geo[e & 1];
    fault_if(g.epoch != e, kFaultGeometry);
    if (e == 0) first_sample(p, sc, g.read_ptr, first, n_window, xr, xi);
    float part[2 * kSp];
    correlate<kSp>(sc, p, code, g, n_window, first, stride, xr, xi, part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int s = 0; s < 2 * kSp; ++s) {
        part[s] = add(part[s], __shfl_xor_sync(kFull, part[s], off));
      }
    }
    if (kCheck) {
      fault_if(*reinterpret_cast<const volatile int*>(&geo[e & 1].epoch) != e,
               kFaultGeometry);
      jitter(e, w);
    }
    if (lane < kCluster) {
      // Lane q: this warp's sums into CTA q's slot, counted on CTA q's
      // barrier of the epoch's parity.
      const uint32_t slot = smem_addr(&red[e & 1][rank * kWarps + w][0]);
      const uint32_t bar = in_rank(smem_addr(&full[e & 1]), lane);
#pragma unroll
      for (int s = 0; s < kSp; ++s) {
        store_async(in_rank(slot + 8u * s, lane), part[2 * s],
                    part[2 * s + 1], bar);
      }
    }
    first_sample(p, sc, g.next_read_ptr, first, n_window, xr, xi);
  }
}

// --- The loop warp -----------------------------------------------------

// The carried chain of one channel, in every lane of warp 0: per epoch,
// wait for the cluster's partials, add them in a fixed tree, update the
// loops, publish the next epoch's geometry; then, off the chain, the next
// phase advance and (rank 0) the epoch's record for the bookkeeping warp.
template <int kProf, int kOrder, int kSp>
__device__ __forceinline__ void loop_warp(
    const LoopConsts& k, const ScanConsts& sc, const ScanArgs& p,
    Geometry* geo, float (*red)[kCluster * kWarps][2 * kSp],
    const uint64_t* full, uint32_t (*record)[kNumOut],
    const uint64_t* rec_full, const uint64_t* rec_free, int c,
    uint32_t rank, int n_ch, int n_epochs) {
  const int lane = static_cast<int>(threadIdx.x);
  const bool writer = rank == 0;
  Carry cr;
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
  cr.pll_lock = f[kPllLock][c];
  cr.fll_lock = f[kFllLock][c];
  cr.unread = in[kUnread][c];
  cr.code_counter = in[kCodeCounter][c];
  cr.lock_state = in[kLockState][c];
  const bool tracking = in[kMode][c] == kModeTracking;
  const float anchor = f[kFreqAnchor][c];
  const float rail_lo = sub(anchor, k.freq_rail);
  const float rail_hi = add(anchor, k.freq_rail);

  Geometry g;
  Start st = epoch_start(k, sc, cr, tracking, 0, g);
  if (lane == 0) geo[0] = g;
  __syncwarp();
  geometry_out();
  float adv_code, adv_carrier;
  phase_advance(k, sc, cr, st, adv_code, adv_carrier);

  // The partials' tree: P = C kWarps partials a correlator. Lane l of a
  // group of `span` lanes (32, or the power of two at or above P) takes
  // partial l and adds l + 32, l + 64, ... in order (0 past P), then a
  // butterfly over the group: every group, so every lane, holds the sum.
  constexpr int n_part = kCluster * kWarps;
  constexpr int span = n_part >= 32 ? 32 : pow2_at_least(n_part);
  const int l = lane & (span - 1);
  // The bytes the cluster's warps store into this CTA an epoch.
  constexpr uint32_t bytes = n_part * 2 * kSp * 4;

  for (int e = 0; e < n_epochs; ++e) {
    jitter(e, kWarps);
    if (lane == 0) expect_bytes(smem_addr(&full[e & 1]), bytes);
    wait_parity<true>(smem_addr(&full[e & 1]), (e >> 1) & 1);
    fault_if(kCheck && phase_done(smem_addr(&full[e & 1]), ((e >> 1) + 1) & 1),
             kFaultPhase);
    // The previous epoch's record to the bookkeeping warp, which then runs
    // beside this epoch's chain, while the correlating warps wait.
    if (writer && lane == 0 && e > 0) {
      arrive_local(smem_addr(&rec_full[(e - 1) % kRing]));
    }
    float corr[2 * kSp];
#pragma unroll
    for (int s = 0; s < 2 * kSp; ++s) {
      float v = l < n_part ? checked(red[e & 1][l][s], kFaultPartial) : 0.0f;
#pragma unroll
      for (int j = 32; j < n_part; j += 32) {
        if (l + j < n_part) {
          v = add(v, checked(red[e & 1][l + j][s], kFaultPartial));
        }
      }
      corr[s] = v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < span) {
#pragma unroll
        for (int s = 0; s < 2 * kSp; ++s) {
          corr[s] = add(corr[s], __shfl_xor_sync(kFull, corr[s], off));
        }
      }
    }
    if (kCheck) {
      // The slots read, poisoned for the next epoch of this parity.
      __syncwarp();
      jitter(e, kWarps + 1);
      for (int i = lane; i < n_part && lane < span; i += 32) {
        for (int s = 0; s < 2 * kSp; ++s) {
          red[e & 1][i][s] = __uint_as_float(kPoison);
        }
      }
    }
    const bool active = st.active;

    // Discriminators + loop filters (ops/profiles.py::loop_update).
    LoopIn li;
    li.dll_memory = cr.dll_mem;
    li.pll_memory = cr.pll_mem;
    li.fll_vel = cr.fll_vel;
    li.fll_acc = cr.fll_acc;
    li.i_prompt_prev = cr.ip_prev;
    li.q_prompt_prev = cr.qp_prev;
    li.pll_lock = cr.pll_lock;
    li.fll_lock = cr.fll_lock;
    li.lock_state = cr.lock_state;
    li.code_counter = cr.code_counter;
    li.comp_freq = 0.0f;
    li.comp_phase = 0.0f;
    li.comp_code = 0.0f;
    const Disc d = discriminate(k, kProf, corr, cr.ip_prev, cr.qp_prev);
    const LoopOut lu = filter_step(k, kProf, kOrder, d, li, active);

    // The rails, the carry of the chain, the next epoch's start.
    float carrier = add(cr.carrier, lu.nco_carrier);
    if (k.freq_rail_on) carrier = sydr::clamp(carrier, rail_lo, rail_hi);
    float code_off = sub(cr.code_off, lu.nco_code);
    if (k.code_rail_on) {
      code_off = sydr::clamp(code_off, -k.code_rail, k.code_rail);
    }
    const int unread = active ? st.unread - st.required : st.unread;
    if (active) {
      cr.carrier = carrier;
      cr.code_off = code_off;
      cr.rem_carrier = adv_carrier;
      cr.rem_code = adv_code;
    }
    cr.unread = unread;
    const Start now = st;
    if (e + 1 < n_epochs) {
      st = epoch_start(k, sc, cr, tracking, e + 1, g);
      if (lane == 0) geo[(e + 1) & 1] = g;
      __syncwarp();
      geometry_out();
    }

    // Off the chain, while epoch e + 1 correlates: the rest of the loops'
    // carry, the next phase advance, the record.
    if (active) {
      cr.dll_mem = lu.code_err;
      cr.pll_mem = lu.phase_err;
      cr.fll_mem = lu.freq_err;
      cr.ip_prev = lu.i_prompt;
      cr.qp_prev = lu.q_prompt;
      cr.code_counter += 1;
    }
    cr.fll_vel = lu.fll_vel;
    cr.fll_acc = lu.fll_acc;
    cr.pll_lock = lu.pll_lock;
    cr.fll_lock = lu.fll_lock;
    cr.lock_state = lu.lock_state;
    if (e + 1 < n_epochs) {
      phase_advance(k, sc, cr, st, adv_code, adv_carrier);
    }
    if (!writer || lane != 0) continue;
    // The epoch's record: its outputs but the bookkeeping's (C/N0, the
    // finished bit's sum, the flags, bit_ready), and the activity.
    const int slot = e % kRing;
    if (e >= kRing) wait_parity<false>(smem_addr(&rec_free[slot]),
                                       ((e / kRing) - 1) & 1);
    if (kCheck) {
      jitter(e, kWarps + 2);
      for (int i = 0; i < kNumOut; ++i) {
        fault_if(record[slot][i] != kPoison, kFaultRecordWrite);
      }
    }
    // Six 16-byte stores: the rows in their order (channel_layout.cuh),
    // the bookkeeping's (C/N0, bit_ip_sum, flags, bit_ready) left as 0.
    uint4* out = reinterpret_cast<uint4*>(record[slot]);
    static_assert(kOutQLate == 5 && kOutPllError == 7 && kOutFllError == 8 &&
                  kOutCarrierFreq == 11 && kOutCn0 == 13 &&
                  kOutFllLock == 15 && kOutRemCode == 16 &&
                  kOutBitIpSum == 17 && kNumOutF == 18 &&
                  kOutLockState == 0 && kOutRequired == 3 && kNumOutI == 4 &&
                  kOutActive == 0 && kNumOut == 24, "the record's layout");
    out[0] = make_uint4(__float_as_uint(lu.i_early),
                        __float_as_uint(lu.q_early),
                        __float_as_uint(lu.i_prompt),
                        __float_as_uint(lu.q_prompt));
    out[1] = make_uint4(__float_as_uint(lu.i_late), __float_as_uint(lu.q_late),
                        __float_as_uint(lu.code_err),
                        __float_as_uint(lu.phase_err));
    // The carrier before the activity gate.
    out[2] = make_uint4(__float_as_uint(lu.freq_err),
                        __float_as_uint(lu.nco_code),
                        __float_as_uint(lu.nco_carrier),
                        __float_as_uint(carrier));
    out[3] = make_uint4(__float_as_uint(now.code_freq), 0u,
                        __float_as_uint(lu.pll_lock),
                        __float_as_uint(lu.fll_lock));
    out[4] = make_uint4(__float_as_uint(cr.rem_code), 0u,
                        static_cast<uint32_t>(lu.lock_state), 0u);
    out[5] = make_uint4(static_cast<uint32_t>(unread),
                        static_cast<uint32_t>(now.required),
                        static_cast<uint32_t>(active), 0u);
  }
  if (!writer || lane != 0) return;
  arrive_local(smem_addr(&rec_full[(n_epochs - 1) % kRing]));
  float* nf = p.new_f + c;
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
  nf[kPllLock * n_ch] = cr.pll_lock;
  nf[kFllLock * n_ch] = cr.fll_lock;
  int* ni = p.new_i + c;
  ni[kUnread * n_ch] = cr.unread;
  ni[kCodeCounter * n_ch] = cr.code_counter;
  ni[kLockState * n_ch] = cr.lock_state;
}

// --- The bookkeeping warp ----------------------------------------------

// What does not feed the next epoch, rank 0's warp 1, an epoch behind the
// chain: from each epoch's record, the bit-edge histogram (a bin a lane,
// its declaration by warp reductions), the bit sums, C/N0 and the flags;
// then the epoch's 24 outputs, each row's by a lane. After the last
// epoch, the anchor's slew and the state it keeps.
__device__ __forceinline__ void bookkeeping_warp(
    const LoopConsts& k, const ScanConsts& sc, const ScanArgs& p,
    uint32_t (*record)[kNumOut], const uint64_t* rec_full,
    const uint64_t* rec_free, int c, int n_ch, int n_epochs) {
  const int lane = static_cast<int>(threadIdx.x) - 32;
  const float* const* f = p.state_f;
  const int* const* in = p.state_i;
  // The part of the carry this warp reads or keeps.
  float carrier = f[kCarrierFreq][c];
  float ip_prev = f[kIPromptPrev][c];
  float qp_prev = f[kQPromptPrev][c];
  float ip_sum = f[kIpSum][c];
  float qp_sum = f[kQpSum][c];
  float ratio_sum = f[kCn0RatioSum][c];
  float ip_sq = f[kIpSqSum][c];
  float qp_sq = f[kQpSqSum][c];
  float cn0 = f[kCn0][c];
  float pll_lock = f[kPllLock][c];
  int flags = in[kFlags][c];
  int code_counter = in[kCodeCounter][c];
  int ms_counter = in[kMsCounter][c];
  int bit_edge = in[kBitEdge][c];
  int accum_count = in[kAccumCount][c];
  // Lane b holds the histogram's bin b.
  int bin = lane < kHistBins ? p.edge_hist[c * kHistBins + lane] : 0;
  const size_t plane = static_cast<size_t>(n_epochs) * n_ch;

  for (int e = 0; e < n_epochs; ++e) {
    const int slot = e % kRing;
    jitter(e, kWarps + 3);
    wait_parity<false>(smem_addr(&rec_full[slot]), (e / kRing) & 1);
    uint32_t* out = record[slot];
    if (kCheck && lane < kNumOut) {
      fault_if(out[lane] == kPoison, kFaultRecordRead);
    }
    const bool active = out[kNumOutF + kNumOutI + kOutActive] != 0;
    const float ip = __uint_as_float(out[kOutIPrompt]);
    const float qp = __uint_as_float(out[kOutQPrompt]);

    // Bit-edge synchronisation (histogram method).
    const bool had_sync = (flags & kFlagBitSync) != 0;
    const int ms = active ? sydr::mod_i(ms_counter + 1, 20) : ms_counter;
    const bool counting = active && !had_sync &&
                          code_counter > k.min_convergence_ms &&
                          pll_lock > 0.5f;
    if (counting && sydr::sign(ip_prev) != sydr::sign(ip) && lane == ms) {
      bin += 1;
    }
    bool declare = false;
    int argmax = 0;
    if (!had_sync) {
      const int total = __reduce_add_sync(kFull, bin);
      const int mode = __reduce_max_sync(kFull, bin);
      // bit_sync_declare's first maximal bin.
      argmax = __ffs(__ballot_sync(kFull, lane < kHistBins && bin == mode))
               - 1;
      declare = bit_sync_rule(k, mode, total);
    }
    bit_edge = declare ? argmax : bit_edge;
    const bool bit_sync = had_sync || declare;
    const bool at_edge =
        active && bit_sync && sydr::mod_i(ms - bit_edge, 20) == 0;
    const bool bit_complete = at_edge && accum_count >= 20;
    const bool keep_sums = !(at_edge || declare);
    const bool acc = active && bit_sync;

    // C/N0 + lock indicators over bit-aligned 20-ms intervals.
    const float ratio = beaulieu_ratio_term(ip, qp, ip_prev, qp_prev);
    const float bit_ip_sum = ip_sum;
    if (bit_complete) {
      cn0 = cn0_estimate(k, ip_sum, qp_sum, ip_sq, qp_sq, ratio_sum, cn0);
    }
    ip_sum = add(keep_sums ? ip_sum : 0.0f, acc ? ip : 0.0f);
    qp_sum = add(keep_sums ? qp_sum : 0.0f, acc ? qp : 0.0f);
    ip_sq = add(keep_sums ? ip_sq : 0.0f, acc ? sqr(ip) : 0.0f);
    qp_sq = add(keep_sums ? qp_sq : 0.0f, acc ? sqr(qp) : 0.0f);
    ratio_sum = add(keep_sums ? ratio_sum : 0.0f, acc ? ratio : 0.0f);
    accum_count = (keep_sums ? accum_count : 0) + (acc ? 1 : 0);
    flags = active ? (flags | kFlagCodeLock | (bit_sync ? kFlagBitSync : 0))
                   : flags;
    ms_counter = ms;
    if (active) {
      carrier = __uint_as_float(out[kOutCarrierFreq]);
      ip_prev = ip;
      qp_prev = qp;
      code_counter += 1;
    }
    pll_lock = __uint_as_float(out[kOutPllLock]);

    // The record completed, then row e of each [block_ms, n_ch] output.
    if (lane == 0) {
      out[kOutCn0] = __float_as_uint(cn0);
      out[kOutBitIpSum] = __float_as_uint(bit_ip_sum);
      out[kNumOutF + kOutFlags] = static_cast<uint32_t>(flags);
      out[kNumOutF + kNumOutI + kOutBitReady] = bit_complete;
    }
    __syncwarp();
    const size_t at = static_cast<size_t>(e) * n_ch + c;
    if (lane < kNumOutF) {
      p.out_f[lane * plane + at] = __uint_as_float(out[lane]);
    } else if (lane < kNumOutF + kNumOutI) {
      p.out_i[(lane - kNumOutF) * plane + at] = static_cast<int>(out[lane]);
    } else if (lane < kNumOut) {
      p.out_b[(lane - kNumOutF - kNumOutI) * plane + at] = out[lane] != 0;
    }
    if (kCheck) {
      __syncwarp();
      if (lane < kNumOut) out[lane] = kPoison;
    }
    __syncwarp();
    if (lane == 0) arrive_local(smem_addr(&rec_free[slot]));
  }

  if (lane < kHistBins) p.new_hist[c * kHistBins + lane] = bin;
  if (lane != 0) return;
  // Per-block rail re-anchoring (runtime.py::_slew_anchor).
  float anchor = f[kFreqAnchor][c];
  if (sc.slew_on && (flags & kFlagBitSync) != 0) {
    anchor = add(anchor, sydr::clamp(sub(carrier, anchor), -sc.slew_step,
                                     sc.slew_step));
  }
  float* nf = p.new_f + c;
  nf[kCarrierFreq * n_ch] = carrier;
  nf[kFreqAnchor * n_ch] = anchor;
  nf[kIpSum * n_ch] = ip_sum;
  nf[kQpSum * n_ch] = qp_sum;
  nf[kCn0RatioSum * n_ch] = ratio_sum;
  nf[kIpSqSum * n_ch] = ip_sq;
  nf[kQpSqSum * n_ch] = qp_sq;
  nf[kCn0 * n_ch] = cn0;
  int* ni = p.new_i + c;
  ni[kMode * n_ch] = in[kMode][c];
  ni[kFlags * n_ch] = flags;
  ni[kMsCounter * n_ch] = ms_counter;
  ni[kBitEdge * n_ch] = bit_edge;
  ni[kAccumCount * n_ch] = accum_count;
}

// One cluster of kCluster CTAs a channel: blockIdx.x = c kCluster + rank.
template <int kProf, int kOrder, int kSp>
__global__ void __launch_bounds__(kBlock, 1)
    scan_block_kernel(const LoopConsts k, const ScanConsts sc,
                      const ScanArgs p, int n_ch, int n_epochs,
                      int n_window) {
  __shared__ float code[kCodeLen];
  __shared__ __align__(16) float red[2][kCluster * kWarps][2 * kSp];
  __shared__ Geometry geo[2];
  __shared__ __align__(16) uint32_t record[kRing][kNumOut];
  __shared__ __align__(8) uint64_t full[2];
  __shared__ __align__(8) uint64_t rec_full[kRing];
  __shared__ __align__(8) uint64_t rec_free[kRing];
  uint32_t rank, c;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(c));

  const float* code_row = p.codes + static_cast<size_t>(c) * kCodeLen;
  for (int i = threadIdx.x; i < kCodeLen; i += kBlock) code[i] = code_row[i];
  if (kCheck) {
    float* slots = &red[0][0][0];
    for (int i = threadIdx.x; i < 2 * kCluster * kWarps * 2 * kSp;
         i += kBlock) {
      slots[i] = __uint_as_float(kPoison);
    }
    for (int i = threadIdx.x; i < kRing * kNumOut; i += kBlock) {
      (&record[0][0])[i] = kPoison;
    }
  }
  if (threadIdx.x == 0) {
    // Each parity's exchange barrier: the loop warp's one arrival an epoch
    // of that parity, and the bytes it expects from the cluster's warps;
    // each record slot's: one arrival when it is full, one when free.
    for (int b = 0; b < 2; ++b) init_barrier(smem_addr(&full[b]));
    for (int b = 0; b < kRing; ++b) {
      init_barrier(smem_addr(&rec_full[b]));
      init_barrier(smem_addr(&rec_free[b]));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Every CTA's code row and barriers before any arrival or read.
  cluster_sync();
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  if (warp == 0) {
    loop_warp<kProf, kOrder, kSp>(
        k, sc, p, geo, red, full, record, rec_full, rec_free,
        static_cast<int>(c), rank, n_ch, n_epochs);
  } else if (warp == 1) {
    if (rank == 0) {
      bookkeeping_warp(k, sc, p, record, rec_full, rec_free,
                       static_cast<int>(c), n_ch, n_epochs);
    }
  } else {
    correlating_warps<kSp>(sc, p, code, geo, red, full, rank, n_epochs,
                           n_window);
  }
  // No CTA leaves while another may still write into its shared memory.
  __syncwarp();
  cluster_sync();
}

// Launch one instance on a grid of n_ch clusters of kCluster CTAs, or,
// with max_clusters, ask how many such clusters the card runs at once
// (cudaOccupancyMaxActiveClusters) and launch nothing.
template <int kProf, int kOrder, int kSp>
cudaError_t launch(const LoopConsts& k, const ScanConsts& sc,
                   const ScanArgs& p, int n_ch, int n_epochs, int n_window,
                   cudaStream_t stream, int* max_clusters) {
  auto* kernel = scan_block_kernel<kProf, kOrder, kSp>;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ch * kCluster);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) {
    return cudaOccupancyMaxActiveClusters(
        max_clusters, reinterpret_cast<const void*>(kernel), &cfg);
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, k, sc, p, n_ch,
                                             n_epochs, n_window);
  if (err != cudaSuccess) return err;
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

// The instance for the configuration: launched, or asked for its clusters.
cudaError_t dispatch(const LoopConsts& k, const ScanConsts& sc,
                     const ScanArgs& p, int n_ch, int n_epochs, int n_window,
                     cudaStream_t s, int* max_clusters) {
  const bool third = k.dlf_order == 3;
  switch (k.profile) {
    case sydr::kProfileBorre:      // no DLF
      return sc.n_spacings == 3
                 ? launch<sydr::kProfileBorre, 2, 3>(
                       k, sc, p, n_ch, n_epochs, n_window, s, max_clusters)
             : sc.n_spacings == 4
                 ? launch<sydr::kProfileBorre, 2, 4>(
                       k, sc, p, n_ch, n_epochs, n_window, s, max_clusters)
                 : launch<sydr::kProfileBorre, 2, 5>(
                       k, sc, p, n_ch, n_epochs, n_window, s, max_clusters);
    case sydr::kProfileKaplan:
      return third ? launch<sydr::kProfileKaplan, 3, 5>(
                         k, sc, p, n_ch, n_epochs, n_window, s, max_clusters)
                   : launch<sydr::kProfileKaplan, 2, 5>(
                         k, sc, p, n_ch, n_epochs, n_window, s, max_clusters);
    default:
      return third ? launch<sydr::kProfileKaplanNarrowOnly, 3, 3>(
                         k, sc, p, n_ch, n_epochs, n_window, s, max_clusters)
                   : launch<sydr::kProfileKaplanNarrowOnly, 2, 3>(
                         k, sc, p, n_ch, n_epochs, n_window, s, max_clusters);
  }
}

bool loops_fit(const sydr::LoopConsts* consts, const sydr::ScanConsts* scan) {
  return consts != nullptr && scan != nullptr &&
         consts->profile >= sydr::kProfileBorre &&
         consts->profile <= sydr::kProfileKaplanNarrowOnly &&
         (consts->dlf_order == 2 || consts->dlf_order == 3) &&
         spacings_fit(consts->profile, scan->n_spacings);
}

}  // namespace

// The protocol check's fault counts by kind (Fault's order) into
// out[0..kNumFaults), then cleared: all 0 but in the check build.
extern "C" int scan_block_protocol_faults(unsigned int* out) {
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemcpyFromSymbol(out, scan_protocol_faults,
                                         sizeof(scan_protocol_faults));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int zero[kNumFaults] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(scan_protocol_faults, zero, sizeof(zero)));
}

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
  if (!loops_fit(consts, scan) || args == nullptr || n_ch < 1 ||
      n_ch > INT_MAX / kCluster || n_epochs < 1 || n_window < 0 ||
      scan->samples_per_ms < 1 || scan->tail_ms < 0 ||
      scan->window_size < 1 || scan->window_size > (1 << 24)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dispatch(*consts, *scan, *args, n_ch, n_epochs,
                                   n_window, static_cast<cudaStream_t>(stream),
                                   nullptr));
}

// How many clusters of the configuration's instance the card runs at once,
// into `*out` (cudaOccupancyMaxActiveClusters); launches nothing.
extern "C" int scan_block_max_clusters(const sydr::LoopConsts* consts,
                                       const sydr::ScanConsts* scan,
                                       int* out) {
  if (!loops_fit(consts, scan) || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const sydr::ScanArgs none = {};
  return static_cast<int>(dispatch(*consts, *scan, none, 1, 1, 0, nullptr,
                                   out));
}
