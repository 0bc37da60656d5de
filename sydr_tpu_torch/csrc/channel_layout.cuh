// The rows of a channel's state and of a block's loop outputs, as the
// Python side lays them out, shared by the kernels that run a block's
// epochs (csrc/pass_c.cu, csrc/scan_block.cu).

#pragma once

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

constexpr int kModeTracking = 2;   // channels/state.py's MODE_TRACKING

}  // namespace sydr
