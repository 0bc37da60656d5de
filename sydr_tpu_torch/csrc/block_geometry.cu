// Pass A and pass B's geometry of the batched tracking runtime: everything
// of a block between the channel state and the kernels that read the
// window (K1, K3) and replay the loops (pass C), one launch a block.
//
// Replaces no Pallas kernel. Its counterpart in the JAX package is the part
// of the jitted run_block_batched (sydr_tpu/channels/batch_runtime.py
// :1237-1253) that XLA fuses ahead of the correlation: the frozen rates,
// pass A's closed form (_pass_a_closed, :197), the code intercept
// (_intercept, :340), the per-millisecond anchors (block_geometry, :494)
// and the epoch bounds. PyTorch runs the plain version
// (sydr_tpu_torch/channels/batch_runtime.py: _rates, _pass_a_closed,
// _intercept, block_geometry, epoch_bounds) as ~130 [n_ch]-wide launches a
// block; this kernel is one.
//
// It writes what the plain version returns: the rates (delta, code_step,
// omega), pass A's [block_ms, n_ch] rows (required, active, b_start,
// rem_code, rem_carrier, unread_after) and its end-of-block values, the
// whole chip of the intercept (c_int), the anchors fb_q and phic_q
// ([n_ch, tail_ms + block_ms]) and the epoch bounds ([block_ms + 1, n_ch]).
// Every operation rounds as the plain version's op does on the card
// (loop_update.cuh's helpers: no product contracts into a sum; a division
// of a tensor by a Python scalar is the multiplication by the scalar's
// reciprocal rounded to float32, from the host; correlator_kernel.fma32 in
// double, rounded once to float32; torch.remainder's CUDA form), so the two
// agree bit for bit.
//
// Bound on the H100: latency. A block's bytes are a few tens of kB; what
// cannot be shortened is the chain from a channel's state to its last
// anchor. The consumed samples after epoch e, C(e), are closed-form in e,
// so no step of the block is a scan:
//   - a warp a channel, lane e taking epoch e of a 32-epoch chunk (a block
//     of more epochs runs chunk after chunk); C(e - 1) is the next lower
//     lane's value (__shfl_up_sync), the block's all-or-nothing activity
//     one __all_sync over every epoch's sample budget;
//   - then lane q taking anchor millisecond q of the tail_ms + block_ms;
//   - kWarps channels a CTA, so that a session's channels spread over SMs
//     and no step crosses channels (a channel shard computes what the full
//     launch computes).
// Launched on the caller's stream without a synchronisation, so it is
// captured into the session's step graph like K1 and pass C.

#include <cuda_runtime.h>

#include "loop_update.cuh"

namespace sydr {

constexpr int kModeTracking = 2;     // channels/state.py's MODE_TRACKING

// The configuration's constants, each the value the plain version's op
// sees (ops/geometry_kernel.py::geometry_consts builds it; the field order
// is ctypes' GeoConsts there).
struct GeoConsts {
  int n_epochs;            // block_ms
  int n_anchors;           // tail_ms + block_ms
  int samples_per_ms;
  int tail_ms;
  int window_samples;      // (tail_ms + block_ms) * samples_per_ms
  int carrier_aiding;
  float intermediate_frequency;
  float aiding;            // GPS_L1CA_CODE_FREQ / GPS_L1CA_CARRIER_FREQ
  float code_freq;         // GPS_L1CA_CODE_FREQ
  float rcp_fs;            // 1 / sampling_frequency
  float rcp_spms;          // 1 / samples_per_ms
  float spms_over_fs;      // samples_per_ms / sampling_frequency
  float spms;              // samples_per_ms
  float two_pi;
  float code_length;       // GPS_L1CA_CODE_LENGTH
};

// Device pointers (ops/geometry_kernel.py's GeoArgs, field by field).
struct GeoArgs {
  const float* rem_code;              // [n_ch] each: the state's fields
  const float* rem_carrier;
  const float* carrier_freq;
  const float* code_freq_offset;
  const int* unread;
  const int* mode;
  float* vec_f;      // [kNumVecF, n_ch]
  int* vec_i;        // [kNumVecI, n_ch]
  float* seq_f;      // [kNumSeqF, block_ms, n_ch]
  int* seq_i;        // [kNumSeqI, block_ms, n_ch]
  bool* active;      // [block_ms, n_ch]
  float* anchors;    // [2, n_ch, tail_ms + block_ms]: fb_q, phic_q
  int* bounds;       // [block_ms + 1, n_ch]
};

// The output rows (ops/geometry_kernel.py's VEC_F32, VEC_I32, SEQ_F32 and
// SEQ_I32, in order).
enum VecF { kVecDelta, kVecCodeStep, kVecOmega, kVecRemCodeEnd,
            kVecRemCarrierEnd, kNumVecF };
enum VecI { kVecUnreadEnd, kVecConsumedEnd, kVecCInt, kNumVecI };
enum SeqF { kSeqRemCode, kSeqRemCarrier, kNumSeqF };
enum SeqI { kSeqRequired, kSeqBStart, kSeqUnreadAfter, kNumSeqI };

}  // namespace sydr

namespace {

using namespace sydr;

constexpr int kWarps = 4;            // warps (channels) a CTA
constexpr unsigned kFull = 0xffffffffu;

// One channel's state and its frozen rates (batch_runtime.py::_rates), the
// same in every lane of its warp.
struct Chan {
  float rem_code, rem_carrier;
  int unread;
  bool tracking;
  float delta, code_step, omega;
  float eps;         // delta * (spms / fs)
  float om_ms;       // remainder(omega * spms, 2 pi)
};

__device__ __forceinline__ Chan channel(const GeoConsts& k, const GeoArgs& p,
                                        int c) {
  Chan ch;
  ch.rem_code = p.rem_code[c];
  ch.rem_carrier = p.rem_carrier[c];
  ch.unread = p.unread[c];
  ch.tracking = p.mode[c] == kModeTracking;
  const float carrier = p.carrier_freq[c];
  const float offset = p.code_freq_offset[c];
  ch.delta = k.carrier_aiding
                 ? add(offset, mul(sub(carrier, k.intermediate_frequency),
                                   k.aiding))
                 : add(offset, 0.0f);
  ch.code_step = mul(add(ch.delta, k.code_freq), k.rcp_fs);
  ch.omega = mul(mul(carrier, k.two_pi), k.rcp_fs);
  ch.eps = mul(ch.delta, k.spms_over_fs);
  ch.om_ms = mod_f(mul(ch.omega, k.spms), k.two_pi);
  return ch;
}

// C(e): the samples consumed after epoch e,
// (e + 1) spms + ceil(-fma32(e + 1, eps, rem_code) / code_step).
__device__ __forceinline__ int consumed(const GeoConsts& k, const Chan& ch,
                                        int e) {
  const float e1 = add(static_cast<float>(e), 1.0f);
  const float f = __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(e1),
                          static_cast<double>(ch.eps)),
                static_cast<double>(ch.rem_code)));
  const int dd = static_cast<int>(ceilf(quot(-f, ch.code_step)));
  return (e + 1) * k.samples_per_ms + dd;
}

// The sample budget of epoch e: min(unread0 + (e + 1) spms,
// (tail + e + 1) spms).
__device__ __forceinline__ int budget(const GeoConsts& k, const Chan& ch,
                                      int e) {
  return min(ch.unread + (e + 1) * k.samples_per_ms,
             (k.tail_ms + e + 1) * k.samples_per_ms);
}

// The code phase after `d` samples more than e whole milliseconds
// (rem_code + e eps + d code_step) and the carrier phase,
// remainder(rem_carrier - (om_ms e + omega d), 2 pi).
__device__ __forceinline__ float code_phase(const Chan& ch, float e, int d) {
  return add(add(ch.rem_code, mul(e, ch.eps)),
             mul(static_cast<float>(d), ch.code_step));
}

__device__ __forceinline__ float carrier_phase(const GeoConsts& k,
                                               const Chan& ch, float e,
                                               int d) {
  return mod_f(sub(ch.rem_carrier, add(mul(ch.om_ms, e),
                                       mul(ch.omega, static_cast<float>(d)))),
               k.two_pi);
}

__global__ void __launch_bounds__(kWarps * 32)
    block_geometry_kernel(const GeoConsts k, const GeoArgs p, int n_ch) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_ch) return;             // a whole warp: no shuffle is cut
  const Chan ch = channel(k, p, c);
  const int n_e = k.n_epochs, spms = k.samples_per_ms;

  // The block runs iff every epoch's budget covers C(e) (pass A's
  // all-or-nothing activity). The first chunk's C(e) is kept for the
  // stores below.
  const int first = lane < n_e ? consumed(k, ch, lane) : 0;
  bool ok = lane >= n_e || budget(k, ch, lane) >= first;
  for (int e0 = 32; e0 < n_e; e0 += 32) {
    const int e = e0 + lane;
    ok = ok && (e >= n_e || budget(k, ch, e) >= consumed(k, ch, e));
  }
  const bool act = ch.tracking && __all_sync(kFull, ok);

  // The intercept (batch_runtime.py::_intercept): the window position of
  // the block's first consumed sample and its code phase.
  const int avail0 = (k.tail_ms + 1) * spms;
  const int base = avail0 - min(ch.unread + spms, avail0);
  const int a_ms = base >= 0 ? base / spms : -((spms - 1 - base) / spms);
  const int b_rem = base - a_ms * spms;
  const float b1023 = static_cast<float>(b_rem * 1023);
  float phase = sub(sub(ch.rem_code, mul(static_cast<float>(base),
                                         mul(ch.delta, k.rcp_fs))),
                    mul(b1023, k.rcp_spms));
  phase = mod_f(phase, k.code_length);
  const int c_int = static_cast<int>(floorf(phase));
  const float fb = sub(phase, static_cast<float>(c_int));

  // Pass A's rows and the epoch bounds, lane e epoch e of each chunk.
  const size_t plane = static_cast<size_t>(n_e) * n_ch;
  int carry = 0;                     // C(e0 - 1) of the chunk
  for (int e0 = 0; e0 < n_e; e0 += 32) {
    const int e = e0 + lane;
    const int full = e0 == 0 ? first : (e < n_e ? consumed(k, ch, e) : 0);
    int prev = __shfl_up_sync(kFull, full, 1);
    if (lane == 0) prev = carry;
    carry = __shfl_sync(kFull, full, 31);
    if (e >= n_e) continue;
    const float e_f = static_cast<float>(e);
    const int d_prev = prev - e * spms;
    const int required = full - prev;
    const int start = act ? prev : 0;
    const size_t at = static_cast<size_t>(e) * n_ch + c;
    p.seq_i[kSeqRequired * plane + at] = required;
    p.seq_i[kSeqBStart * plane + at] = start;
    p.seq_i[kSeqUnreadAfter * plane + at] = budget(k, ch, e) -
                                            (act ? full : 0);
    p.seq_f[kSeqRemCode * plane + at] =
        act ? code_phase(ch, e_f, d_prev) : ch.rem_code;
    p.seq_f[kSeqRemCarrier * plane + at] =
        act ? carrier_phase(k, ch, e_f, d_prev) : ch.rem_carrier;
    p.active[at] = act;
    const int bound = min(max(start + base, 0), k.window_samples);
    p.bounds[at] = bound;
    if (e == n_e - 1) {
      p.bounds[at + n_ch] =
          min(max(bound + (act ? required : 0), 0), k.window_samples);
    }
  }

  // The anchors (batch_runtime.py::block_geometry), lane q millisecond q.
  const float step = mul(mul(ch.delta, k.spms), k.rcp_fs);
  const float rem_carrier0 = act ? carrier_phase(k, ch, 0.0f, 0)
                                 : ch.rem_carrier;
  const float phic0 = add(add(rem_carrier0, mul(static_cast<float>(a_ms),
                                                ch.om_ms)),
                          mul(ch.omega, static_cast<float>(b_rem)));
  float* fb_q = p.anchors + static_cast<size_t>(c) * k.n_anchors;
  float* phic_q = fb_q + static_cast<size_t>(n_ch) * k.n_anchors;
  for (int q = lane; q < k.n_anchors; q += 32) {
    const float q_f = static_cast<float>(q);
    fb_q[q] = add(fb, mul(q_f, step));
    phic_q[q] = mod_f(sub(phic0, mul(q_f, ch.om_ms)), k.two_pi);
  }

  if (lane != 0) return;
  // The end of the block and the rates.
  const int last = consumed(k, ch, n_e - 1);
  const float e_end = static_cast<float>(n_e);
  const int d_end = last - n_e * spms;
  p.vec_f[kVecDelta * n_ch + c] = ch.delta;
  p.vec_f[kVecCodeStep * n_ch + c] = ch.code_step;
  p.vec_f[kVecOmega * n_ch + c] = ch.omega;
  p.vec_f[kVecRemCodeEnd * n_ch + c] =
      act ? code_phase(ch, e_end, d_end) : ch.rem_code;
  p.vec_f[kVecRemCarrierEnd * n_ch + c] =
      act ? carrier_phase(k, ch, e_end, d_end) : ch.rem_carrier;
  p.vec_i[kVecUnreadEnd * n_ch + c] = budget(k, ch, n_e - 1) -
                                      (act ? last : 0);
  p.vec_i[kVecConsumedEnd * n_ch + c] = act ? last : 0;
  p.vec_i[kVecCInt * n_ch + c] = c_int;
}

}  // namespace

extern "C" const char* sydr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One block's geometry: `consts` and `args` are host structs, copied into
// the launch's parameters.
extern "C" int block_geometry_launch(const sydr::GeoConsts* consts,
                                     const sydr::GeoArgs* args, int n_ch,
                                     void* stream) {
  if (consts == nullptr || args == nullptr || n_ch < 1 ||
      consts->n_epochs < 1 || consts->samples_per_ms < 1 ||
      consts->n_anchors != consts->tail_ms + consts->n_epochs ||
      consts->tail_ms < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n_ch + kWarps - 1) / kWarps;
  block_geometry_kernel<<<blocks, kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(*consts,
                                                               *args, n_ch);
  return static_cast<int>(cudaGetLastError());
}
