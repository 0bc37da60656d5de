// The tile FFT of K2's global-memory entries, shared by pcps_bins_twostep.cu
// (the FFT at length n = N1 N2) and pcps_bins_bluestein.cu (the chirp
// convolution at a smooth length M = M1 M2): a sub-transform of length L
// (a column of length N1 or M1, a row of length N2 or M2) is a Stockham FFT
// over a tile of up to 4096 points in shared memory, the butterflies of
// pcps_fft.cuh (radices 2, 3, 4, 5, 10 and the odd primes 7 to 31, inverse
// sign), pass by pass over every transform of the tile, between two
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
// Variants by the largest radix of a sub-plan (each pass chooses its own):
// radices up to 10, up to 13 and up to 31, each compiled for kThreads
// threads and its own blocks an SM (the register cap): the unrolled
// radix-31 butterfly needs some 4 x 31 registers a thread and would cap
// the other plans' occupancy if they shared its code. On the two-step
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
// 65536 / (kThreads x blocks) registers a thread.
constexpr int kMinBlocksSmall = 4;   // radices up to 10
constexpr int kMinBlocksMid = 4;     // and 7, 11, 13
constexpr int kMinBlocksWide = 2;    // and 17 to 31
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

// The tile of a split into columns of length n1 and rows of length n2.
inline int tile_points(int n1, int n2) {
  return n2 <= kSmallTile && 8 * n1 <= kSmallTile ? kSmallTile : kTile;
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

template <int kMaxR>
constexpr int kMinBlocks = kMaxR <= 10 ? kMinBlocksSmall
                         : kMaxR <= 13 ? kMinBlocksMid : kMinBlocksWide;

// Butterflies of radix R a thread owns in a pass over the largest tile.
template <int R>
constexpr int kItems = (kTile / R + kThreads - 1) / kThreads;

// Accumulators a thread of a magnitude-summing last pass holds: the
// largest kItems<R> R of the variant's radices (its last pass's outputs).
__host__ __device__ constexpr int acc_points(int max_radix) {
  constexpr int kRadices[] = {2, 3, 4, 5, 10, 7, 11, 13, 17, 19, 23, 29, 31};
  int most = 0;
  for (int r : kRadices) {
    const int points = (kTile / r + kThreads - 1) / kThreads * r;
    if (r <= max_radix && points > most) most = points;
  }
  return most;
}

// Run `call` with R the compile-time value of the runtime radix r, among
// the radices of the variant kMaxR (SYDR_SMALL_SWITCH and SYDR_PRIME_CASE:
// pcps_fft.cuh).
#define TILE_RADIX_SWITCH(r, call)                                       \
  if constexpr (kMaxR > 13) {                                            \
    SYDR_PRIME_CASE(r, 31, call) SYDR_PRIME_CASE(r, 29, call)            \
    SYDR_PRIME_CASE(r, 23, call) SYDR_PRIME_CASE(r, 19, call)            \
    SYDR_PRIME_CASE(r, 17, call) SYDR_PRIME_CASE(r, 13, call)            \
    SYDR_PRIME_CASE(r, 11, call) SYDR_PRIME_CASE(r, 7, call)             \
    { SYDR_SMALL_SWITCH(r, call) }                                       \
  } else if constexpr (kMaxR > 10) {                                     \
    SYDR_PRIME_CASE(r, 13, call) SYDR_PRIME_CASE(r, 11, call)            \
    SYDR_PRIME_CASE(r, 7, call)                                          \
    { SYDR_SMALL_SWITCH(r, call) }                                       \
  } else {                                                               \
    SYDR_SMALL_SWITCH(r, call)                                           \
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

// rts[x] = tw[x step] = e^{+2 pi i x / len}, x < len (a table of len step
// points).
__device__ __forceinline__ void load_roots(float2* rts,
                                           const float2* __restrict__ tw,
                                           int len, int step) {
  for (int x = threadIdx.x; x < len; x += kThreads) {
    rts[x] = __ldg(tw + x * step);
  }
}

// Fill plan from a host array of n_pass radices of product len, each from
// {2, 3, 4, 5, 10} or the odd primes 7 to 31; *variant the kMaxR whose
// radix switch holds them all: 10, 13 or 31.
inline int sub_plan(const int* radices, int n_pass, int len, Plan* plan,
                    int* variant) {
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
    const bool small = (r >= 2 && r <= 5) || r == 10;
    const bool prime = r == 7 || r == 11 || r == 13 || r == 17 || r == 19 ||
                       r == 23 || r == 29 || r == 31;
    if (!small && !prime) return static_cast<int>(cudaErrorInvalidValue);
    if (prime) *variant = r > 13 ? 31 : *variant > 13 ? 31 : 13;
    product *= r;
  }
  return static_cast<int>(product == len ? cudaSuccess
                                         : cudaErrorInvalidValue);
}

}  // namespace
