// The tile FFT of K2's global-memory entries, shared by pcps_bins_twostep.cu
// (the FFT at length n = N1 N2) and pcps_bins_bluestein.cu (the chirp
// convolution at a smooth length M = M1 M2): a sub-transform of length L
// (a column of length N1 or M1, a row of length N2 or M2) is a Stockham FFT
// over a tile of up to 4096 points in shared memory, the butterflies of
// pcps_fft.cuh (radices 2, 3, 4, 5, 10 and the odd primes 7 to 31, inverse
// sign) and the tile's own radix-8 and radix-16 butterflies (below), pass
// by pass over every transform of the tile, between two
// buffers (padded one slot in 16 against bank conflicts) beside the L
// roots (tw[x T / L], x < L, of a table of T points). A pass of radix R
// reads in[j + q m] (m = L / R) of its butterfly j, twiddles by the roots
// rts[q (j mod ns) m / ns], and writes out[(j - j mod ns) R + j mod ns +
// q ns]: the radix entries' arithmetic, so the walk of
// acq_kernel.stockham_ifft_ref describes each sub-transform. A tile is
// point-major (Tile<true>: W columns side by side, a warp's butterflies on
// W consecutive columns of global memory) or row-major (Tile<false>). A
// thread holds one butterfly's points at a time, so the registers are a
// butterfly's: a first form that held all of a pass's points across a
// barrier to run in place in one buffer spilled 0.5-2.4 KB a thread at 80
// and 128 registers and took 21.55 ms at 8 ch x 101 bins x 10 blocks at
// n = 70000 on the two-step entry where this one took 12.40 in the same
// run (NVIDIA H100 80GB HBM3, 700.00 W).
//
// A power of two takes radix-16 passes and one pass of 8, 4 or 2
// (acq_kernel.sub_plan): 1024 points in three passes where radix 4 took
// five, so a transform sweeps the tile through shared memory, behind a
// barrier, fewer times.
//
// Variants by the largest radix of a sub-plan (each pass chooses its own):
// radices up to 10, up to 13, up to 16 (radix 8 and 16 beside 7, 11 and
// 13), up to 31, and kAnyRadix (the radices up to 31, radix 1 and the
// generic pass, generic_tile_pass, for an odd radix above 31), each
// compiled for kThreads threads and its own blocks an SM (the register
// cap): the unrolled radix-31 butterfly needs some 4 x 31 registers a
// thread and would cap the other plans' occupancy if they shared its
// code, radix 16 holds 16 points and their 4 x 4 intermediate, and the
// generic branch is kept out of the prime variants (inside them it cost
// the radix entries' n = 4092 4.7%, pcps_fft.cuh). On the two-step
// entry at 8 ch x 101 bins x 10 blocks 4 / 4 / 2 blocks of 256 threads ran
// n = 70000 in 8.83 ms (3 / 3 / 2: 10.09; 512 threads: 12.66; a 4096-point
// tile: 10.33) and n = 245520 in 51.72 (4 / 4 / 1: 55.26; 512 threads:
// 48.70; NVIDIA H100 80GB HBM3, 700.00 W, tools/torch_kernel_variants.py
// --twostep).

#pragma once

#include <cuda_runtime.h>

#include "pcps_fft.cuh"

namespace {

constexpr int kThreads = 256;
// Blocks an SM each variant is compiled for (__launch_bounds__): at most
// 65536 / (kThreads x blocks) registers a thread. The radix-16 variant's
// (radix 8 and 16 beside the radices up to 13) is each entry's own
// (kMinBlocks16 in pcps_bins_twostep.cu and pcps_bins_bluestein.cu).
constexpr int kMinBlocksSmall = 4;   // radices up to 10
constexpr int kMinBlocksMid = 4;     // and 7, 11, 13
constexpr int kMinBlocksWide = 2;    // and 17 to 31
constexpr int kMinBlocksAny = 2;     // and 1 and the generic pass
// The variant of the plans with a generic radix above 31 (or radix 1).
constexpr int kAnyRadix = 4096;
constexpr int kTile = 4096;          // the largest tile: a row <= 4096
// The tile where a row and eight columns fit it (64 bytes a row of the
// point-major tile).
constexpr int kSmallTile = 2048;
constexpr int kMaxN1 = 1024;         // a column: W = kTile / N1 >= 4
constexpr long long kL2Bytes = 50LL << 20;

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// Slots of a tile buffer of `points` points: one spare slot every 16.
__host__ __device__ constexpr int padded(int points) {
  return points + points / 16;
}

// The tile of a split into columns of length n1 and rows of length n2;
// `full`: a sub-plan takes kAnyRadix, whose generic pass has about
// tile / 16 work items a pass, or radix 16, whose pass has tile / 16
// butterflies (one a thread only in the largest tile).
inline int tile_points(int n1, int n2, bool full = false) {
  return !full && n2 <= kSmallTile && 8 * n1 <= kSmallTile ? kSmallTile
                                                           : kTile;
}

// x / d by a multiply-high, exact for x d < 2^32 (here x, d <= 4096).
struct Div {
  int d;
  unsigned magic;
  __device__ __forceinline__ explicit Div(int d_)
      : d(d_), magic(d_ == 1 ? 0u : 0xFFFFFFFFu / d_ + 1u) {}
  __device__ __forceinline__ int operator()(int x) const {
    return d == 1 ? x
                  : static_cast<int>(__umulhi(static_cast<unsigned>(x),
                                              magic));
  }
};

template <int kMaxR, int kBlocks16>
constexpr int kMinBlocks = kMaxR <= 10 ? kMinBlocksSmall
                         : kMaxR <= 13 ? kMinBlocksMid
                         : kMaxR <= 16 ? kBlocks16
                         : kMaxR <= kMaxFixedRadix ? kMinBlocksWide
                                                   : kMinBlocksAny;

// Butterflies of radix R a thread owns in a pass over the largest tile.
template <int R>
constexpr int kItems = (kTile / R + kThreads - 1) / kThreads;

// Accumulators a thread of a magnitude-summing last pass holds: the
// largest kItems<R> R of the variant's radices (its last pass's outputs;
// radix 1 in kAnyRadix's; 16 for radix 8 and radix 16).
__host__ __device__ constexpr int acc_points(int max_radix) {
  constexpr int kRadices[] = {1, 2, 3, 4, 5, 8, 10, 7, 11, 13, 16, 17, 19,
                              23, 29, 31};
  int most = 0;
  for (int r : kRadices) {
    const int points = (kTile / r + kThreads - 1) / kThreads * r;
    if (r <= max_radix && points > most) most = points;
  }
  return most;
}

// Roots of unity e^{+2 pi i f / 16} at the odd f (kRoots16[f / 2]) of the
// radix-16 butterfly's twiddles (float64 values rounded once); the even f
// are a sign swap and sqrt(1/2) rotations (rotate16).
__constant__ float2 kRoots16[8] = {
    {0.9238795325112867f, 0.3826834323650898f},
    {0.38268343236508984f, 0.9238795325112867f},
    {-0.3826834323650897f, 0.9238795325112867f},
    {-0.9238795325112867f, 0.3826834323650899f},
    {-0.9238795325112868f, -0.38268343236508967f},
    {-0.38268343236509034f, -0.9238795325112865f},
    {0.38268343236509f, -0.9238795325112866f},
    {0.9238795325112865f, -0.3826834323650904f}};

// a e^{+2 pi i f / 16} for the f of split_butterfly's roots (0, 2, 4, 6
// and the odd 1, 3, 9), a compile-time constant once the callers' loops
// are unrolled: the quarter turn as a sign swap, the odd eighths as
// sqrt(1/2) (+-1 + i), the odd f from kRoots16.
__device__ __forceinline__ float2 rotate16(float2 a, int f) {
  constexpr float kHalf = 0.7071067811865476;   // sqrt(1/2)
  switch (f) {
    case 0: return a;
    case 4: return mul_i(a);
    case 2: return make_float2(kHalf * (a.x - a.y), kHalf * (a.x + a.y));
    case 6: return make_float2(-kHalf * (a.x + a.y), kHalf * (a.x - a.y));
    default: return cmul(a, kRoots16[f >> 1]);
  }
}

// DFT of length A B (8 = 2 x 4, 16 = 4 x 4) in registers, Cooley-Tukey as
// pcps_fft.cuh's butterfly<10>: B butterflies of length A over the points
// B n1 + n2, the roots e^{+2 pi i n2 k1 / (A B)} (rotate16), then A
// butterflies of length B; output k1 + A k2. Every index and root is a
// compile-time constant once the loops are unrolled.
template <int A, int B>
__device__ __forceinline__ void split_butterfly(float2 (&v)[A * B]) {
  static_assert(16 % (A * B) == 0, "radix 8 or 16");
  float2 y[B][A];
#pragma unroll
  for (int n2 = 0; n2 < B; ++n2) {
    float2 t[A];
#pragma unroll
    for (int n1 = 0; n1 < A; ++n1) t[n1] = v[B * n1 + n2];
    butterfly<A>(t);
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) {
      y[n2][k1] = rotate16(t[k1], 16 / (A * B) * n2 * k1);
    }
  }
#pragma unroll
  for (int k1 = 0; k1 < A; ++k1) {
    float2 t[B];
#pragma unroll
    for (int n2 = 0; n2 < B; ++n2) t[n2] = y[n2][k1];
    butterfly<B>(t);
#pragma unroll
    for (int k2 = 0; k2 < B; ++k2) v[k1 + A * k2] = t[k2];
  }
}

template <>
__device__ __forceinline__ void butterfly<8>(float2 (&v)[8]) {
  split_butterfly<2, 4>(v);
}

template <>
__device__ __forceinline__ void butterfly<16>(float2 (&v)[16]) {
  split_butterfly<4, 4>(v);
}

// Run `call` with R the compile-time value of the runtime radix r, among
// the radices up to 10 and the powers of two, in the variants from 16 up:
// each of 2, 3, 4, 5, 8, 10 and 16 named (pcps_fft.cuh's
// SYDR_SMALL_SWITCH runs its default as radix 10, where an 8 or a 16
// would give wrong maps; sub_plan refuses any other radix, so this
// default runs nothing).
#define TILE_SMALL_SWITCH(r, call)                                       \
  switch (r) {                                                           \
    case 2: { constexpr int R = 2; call; } break;                        \
    case 3: { constexpr int R = 3; call; } break;                        \
    case 4: { constexpr int R = 4; call; } break;                        \
    case 5: { constexpr int R = 5; call; } break;                        \
    case 8: { constexpr int R = 8; call; } break;                        \
    case 10: { constexpr int R = 10; call; } break;                      \
    case 16: { constexpr int R = 16; call; } break;                      \
    default: break;                                                      \
  }

// Run `call` with R the compile-time value of the runtime radix r, among
// the radices of the variant kMaxR (TILE_SMALL_SWITCH and SYDR_PRIME_CASE:
// pcps_fft.cuh). The variants up to 13 keep SYDR_SMALL_SWITCH, the code
// they had before radix 8 and 16 (an explicit switch there cost the
// two-step entry's n = 70000 1.6%, tools/torch_kernel_variants.py
// --parent): sub_plan gives every plan with an 8 or a 16 the variant 16
// or a wider one, so no 8 or 16 reaches its default.
#define TILE_RADIX_SWITCH(r, call)                                       \
  if constexpr (kMaxR > 16) {                                            \
    SYDR_PRIME_CASE(r, 31, call) SYDR_PRIME_CASE(r, 29, call)            \
    SYDR_PRIME_CASE(r, 23, call) SYDR_PRIME_CASE(r, 19, call)            \
    SYDR_PRIME_CASE(r, 17, call) SYDR_PRIME_CASE(r, 13, call)            \
    SYDR_PRIME_CASE(r, 11, call) SYDR_PRIME_CASE(r, 7, call)             \
    { TILE_SMALL_SWITCH(r, call) }                                       \
  } else if constexpr (kMaxR > 13) {                                     \
    SYDR_PRIME_CASE(r, 13, call) SYDR_PRIME_CASE(r, 11, call)            \
    SYDR_PRIME_CASE(r, 7, call)                                          \
    { TILE_SMALL_SWITCH(r, call) }                                       \
  } else if constexpr (kMaxR > 10) {                                     \
    SYDR_PRIME_CASE(r, 13, call) SYDR_PRIME_CASE(r, 11, call)            \
    SYDR_PRIME_CASE(r, 7, call)                                          \
    { SYDR_SMALL_SWITCH(r, call) }                                       \
  } else {                                                               \
    SYDR_SMALL_SWITCH(r, call)                                           \
  }

// Run `call` with R the compile-time value of the runtime radix r, or
// `generic` for a radix above 31 (kAnyRadix alone: radix 1 and the
// generic pass; the other variants' code is TILE_RADIX_SWITCH's).
#define TILE_PASS_SWITCH(r, call, generic)                               \
  if constexpr (kMaxR > kMaxFixedRadix) {                                \
    if (r > kMaxFixedRadix) { generic; }                                 \
    else SYDR_PRIME_CASE(r, 1, call)                                     \
    { TILE_RADIX_SWITCH(r, call) }                                       \
  } else {                                                               \
    TILE_RADIX_SWITCH(r, call)                                           \
  }

// A tile buffer of `count` transforms of length `len`: point-major (kCols:
// the count columns side by side, as a column pass reads them) or
// row-major.
template <bool kCols>
struct Tile {
  float2* p;
  int len, count;
  __device__ __forceinline__ float2& at(int t, int i) const {
    return p[pad(kCols ? i * count + t : t * len + i)];
  }
};

// Butterfly w of a pass is (transform t, butterfly j): t fastest in the
// point-major layout, j fastest in the row-major one, so that a warp's
// global and shared accesses fall on consecutive points.
template <bool kCols>
__device__ __forceinline__ void item(int w, const Div& by, int count, int m,
                                     int& t, int& j) {
  const int a = by(w);
  t = kCols ? w - a * count : a;
  j = kCols ? a : w - a * m;
}

// The R inputs of butterfly j of transform t, twiddled: load(t, i) gives
// point i; with ns the radices done so far (k = j mod ns), input q takes
// rts[q k m / ns] (an exact index below len).
template <int R, class Load>
__device__ __forceinline__ void gather(float2 (&v)[R], const Load& load,
                                       const float2* __restrict__ rts,
                                       int t, int j, int k, int m, int ns) {
#pragma unroll
  for (int q = 0; q < R; ++q) v[q] = load(t, j + q * m);
  if (ns > 1) {
    const int e = k * (m / ns);
#pragma unroll
    for (int q = 1; q < R; ++q) v[q] = cmul(v[q], rts[q * e]);
  }
}

// One Stockham pass of radix R over the tile's `count` transforms of length
// `len`, out of place: butterfly j reads points j + q m (m = len / R)
// through load(t, i) and writes DFT_R output q to point (j - k) R + k +
// q ns through sink(t, i, v).
template <int R, bool kCols, class Load, class Sink>
__device__ __forceinline__ void pass(int len, int count, int ns,
                                     const float2* __restrict__ rts,
                                     const Load& load, const Sink& sink) {
  const int m = len / R;
  const int items = m * count;
  const Div by(kCols ? count : m);
  const Div by_ns(ns);
  for (int w = threadIdx.x; w < items; w += kThreads) {
    int t, j;
    item<kCols>(w, by, count, m, t, j);
    const int hi = by_ns(j);
    const int k = j - hi * ns;
    float2 v[R];
    gather<R>(v, load, rts, t, j, k, m, ns);
    butterfly<R>(v);
    const int base = hi * ns * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q) sink(t, base + q * ns, v[q]);
  }
}

// One Stockham pass of odd radix R > 31, a runtime value, over the tile's
// `count` transforms of length `len`: pcps_fft.cuh's generic_pass (its
// note: the real-symmetric form of prime_butterfly, H = (R - 1) / 2, m =
// len / R), with the roots rts[] of the tile:
//   fold: for butterfly j (k = j mod ns) and 1 <= r <= H, the twiddled
//         x_r = in[j + r m] rts[r k (m / ns)] and x_{R-r} likewise,
//         stored as s_r = x_r + x_{R-r}, d_r = x_r - x_{R-r} in their
//         places of the tile buffer `buf` (for a first pass, which reads
//         global memory through load(t, i), x_0 = in[j] is copied there
//         too; later passes read `buf` itself and fold in place);
//   sum:  outputs q and R - q of butterfly j, 0 <= q <= H, are A + i B
//         and A - i B, A = x_0 + sum_r cos(2 pi q r / R) s_r, B = sum_r
//         sin(2 pi q r / R) d_r, the root read as rts[(q r mod R) m] (the
//         index grows by q m < len a term and wraps at len), written to
//         point (j - k) R + k + q ns through sink(t, i, v). A work item is
//         butterfly j and kGenericPairs consecutive q.
// Every index is an exact integer below len. Items run with t fastest in
// the point-major tile and j fastest in the row-major one (as pass does),
// the pair group q0 slowest, so a warp reads consecutive points and the
// same roots. The caller's barrier follows, as after pass.
template <bool kCols, class Load, class Sink>
__device__ __forceinline__ void generic_tile_pass(
    int len, int count, int ns, int R, bool first, const Tile<kCols>& buf,
    const float2* __restrict__ rts, const Load& load, const Sink& sink) {
  constexpr int P = kGenericPairs;
  const int m = len / R;
  const int h = (R - 1) / 2;
  const int span = m * count;
  const Div by(kCols ? count : m);
  const Div by_span(span);
  const Div by_ns(ns);
  const int estep = m / ns;
  const int r0 = first ? 0 : 1;
  const int folds = span * (h + 1 - r0);
  for (int w = threadIdx.x; w < folds; w += kThreads) {
    const int r = by_span(w);
    int t, j;
    item<kCols>(w - r * span, by, count, m, t, j);
    if (r + r0 == 0) {
      buf.at(t, j) = load(t, j);
      continue;
    }
    const int q = r + r0;
    const int ia = j + q * m;
    const int ib = j + (R - q) * m;
    float2 x = load(t, ia);
    float2 y = load(t, ib);
    if (ns > 1) {
      const int e = (j - by_ns(j) * ns) * estep;
      x = cmul(x, rts[q * e]);
      y = cmul(y, rts[(R - q) * e]);
    }
    buf.at(t, ia) = cadd(x, y);
    buf.at(t, ib) = csub(x, y);
  }
  __syncthreads();
  const int groups = (h + P) / P;   // ceil((H + 1) / P)
  const int sums = span * groups;
  for (int w = threadIdx.x; w < sums; w += kThreads) {
    const int g = by_span(w);
    int t, j;
    item<kCols>(w - g * span, by, count, m, t, j);
    const int q0 = g * P;
    const int k = j - by_ns(j) * ns;
    const int o = (j - k) * R + k;
    const float2 x0 = buf.at(t, j);
    float2 a[P], b[P];
    int idx[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      a[p] = x0;
      b[p] = make_float2(0.0f, 0.0f);
      idx[p] = 0;
    }
#pragma unroll 2
    for (int r = 1; r <= h; ++r) {
      const float2 sr = buf.at(t, j + r * m);
      const float2 dr = buf.at(t, j + (R - r) * m);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        idx[p] += (q0 + p) * m;   // (q0 + p) m <= (H + P - 1) m < len
        if (idx[p] >= len) idx[p] -= len;
        const float2 wr = rts[idx[p]];
        a[p].x += wr.x * sr.x;
        a[p].y += wr.x * sr.y;
        b[p].x += wr.y * dr.x;
        b[p].y += wr.y * dr.y;
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int q = q0 + p;
      if (q > h) break;
      sink(t, o + q * ns, make_float2(a[p].x - b[p].y, a[p].y + b[p].x));
      if (q > 0) {
        sink(t, o + (R - q) * ns,
             make_float2(a[p].x + b[p].y, a[p].y - b[p].x));
      }
    }
  }
}

// rts[x] = tw[x step] = e^{+2 pi i x / len}, x < len (a table of len step
// points).
__device__ __forceinline__ void load_roots(float2* rts,
                                           const float2* __restrict__ tw,
                                           int len, int step) {
  for (int x = threadIdx.x; x < len; x += kThreads) {
    rts[x] = __ldg(tw + x * step);
  }
}

// Whether a plan has a radix-16 pass (tile_points' `full`).
inline bool has_radix16(const Plan& plan) {
  for (int i = 0; i < plan.n_pass; ++i) {
    if (plan.radix[i] == 16) return true;
  }
  return false;
}

// Fill plan from a host array of n_pass radices of product len, each from
// {2, 3, 4, 5, 8, 10, 16}, the odd primes 7 to 31, or an odd radix above 31
// (a generic pass; never the last of a row plan, `row`, whose last pass
// sums magnitudes in registers), and radix 1 as the last pass of a row
// plan (only the magnitude); *variant the kMaxR whose radix switch holds
// them all: 10, 13, 16, 31 or kAnyRadix.
inline int sub_plan(const int* radices, int n_pass, int len, bool row,
                    Plan* plan, int* variant) {
  if (n_pass < 1 || n_pass > kMaxPasses) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long product = 1;
  *variant = 10;
  plan->n_pass = n_pass;
  for (int i = 0; i < kMaxPasses; ++i) {
    plan->radix[i] = i < n_pass ? radices[i] : 1;
  }
  for (int i = 0; i < n_pass; ++i) {
    const int r = radices[i];
    const bool last = i == n_pass - 1;
    const bool small =
        (r >= 2 && r <= 5) || r == 8 || r == 10 || r == 16;
    const bool prime = r == 7 || r == 11 || r == 13 || r == 17 || r == 19 ||
                       r == 23 || r == 29 || r == 31;
    const bool wide = r > kMaxFixedRadix && r <= kTile && r % 2 == 1 &&
                      !(row && last);
    const bool one = r == 1 && row && last && n_pass > 1;
    if (!small && !prime && !wide && !one) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int need = wide || one ? kAnyRadix
                   : r == 8 || r == 16 ? 16
                   : small ? 10
                   : r <= 13 ? 13 : 31;
    if (need > *variant) *variant = need;
    product *= r;
  }
  return static_cast<int>(product == len ? cudaSuccess
                                         : cudaErrorInvalidValue);
}

}  // namespace
