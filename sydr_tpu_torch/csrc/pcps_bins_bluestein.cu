// K2 pcps_bins, Bluestein entry: the per-bin PCPS chain for a code period n
// that the other entries do not take or take slowly: an n whose largest
// prime factor is above acq_kernel.GENERIC_MAX_PRIME (the radix entries'
// generic pass costs p operations a point) or, above the clusters' 65,536
// points, above 31 (the two-step entry's sub-FFTs have no generic pass).
//
// Replaces the Pallas kernel sydr_tpu/ops/acq_kernel.py (_kernel, launched by
// pcps_fused_bins), as the other entries do: for bin b with plan entry
// (k_b, p_b) and channel c,
//
//   out[c, b, :] = sum_j | IDFT_n( S[p_b, c, j, :] * roll(K[c], k_b) ) | / n
//
// over the nc non-coherent blocks j (IDFT_n unnormalised, + sign).
//
// Bluestein's identity: j k = (j^2 + k^2 - (k - j)^2) / 2, so with the
// chirp c_j = e^{+i pi j^2 / n},
//
//   IDFT_n(x)[k] = c_k * sum_j (x_j c_j) conj(c_{k-j}),
//
// a linear convolution of a_j = x_j c_j (j < n) with b_j = conj(c_j)
// (|j| < n), taken as a circular one of length M >= 2 n - 1: conv =
// IFFT_M(FFT_M(a) * FFT_M(b)) / M. M is 13-smooth, split M = M1 M2 with
// M1 <= 1024 and M2 <= 4096 (the lengths of pcps_tile.cuh's tile FFT): of
// those from 2n - 1 up to 2% above it, the one with the fewest passes
// (acq_kernel.bluestein_lengths: 19712 = 176 x 112 at n = 9722, plans
// (11, 16) and (7, 16), since the tile has radix 16; before it, 19500 =
// 150 x 130, plans (10, 3, 5) and (13, 10), where the least 7-smooth M,
// 19600 = 140 x 140 in six passes, ran 17% slower). The filter's
// transform B = FFT_M(b) / (M n) is
// a constant of n, built in float64 on the host by the wrapper
// (acq_kernel.bluestein_filter) with the 1/M of the convolution and the
// 1/n of torch.fft.ifft folded in. |c_k| = 1, so the magnitude needs no
// last chirp product: |IDFT_n(x)[k]| / n = |conv[k]|. The chirp is read
// from a table of the 2n values e^{i pi t/n} (float64-built) at the exact
// index t = j^2 mod 2n, j^2 in 64 bits (j reaches 2^20), by Barrett's
// reduction.
//
// Each length-M transform is a four-step FFT: with input index j = j1 M2 +
// j2 and output index k = k1 + M1 k2, column FFTs of length M1 over j1
// (stride M2), the twiddle at k1 j2, row FFTs of length M2 over j2, leaving
// the transform's point k1 + M1 k2 at row k1, column k2; the inverse walks
// the same steps backwards. The tile butterflies have the inverse (+) sign,
// so the forward transform runs in the conjugate, FFT(a) = conj(IFFT(conj
// a)): (a) loads conj(a), and (b) conjugates the transform where it
// multiplies by B. Three launches per chunk of (bin, channel) pairs, on
// global scratch that the wrapper allocates (M complex64 a transform, nc
// transforms a pair):
//   (a) column_forward, block (tile, transform): the product at the radix
//       entries' fused index times c_j, conjugated, for j < n only (the
//       rows j1 >= ceil(n / M2) and the tail of the last one are zeros that
//       are never loaded); the length-M1 FFTs of W = tile / M1 columns; the
//       twiddle tw[k1 j2] (two table factors); stored at [k1][j2];
//   (b) row_filter, block (tile, transform): for R = tile / M2 rows, the
//       length-M2 FFT, conj(v) B (B stored by the wrapper in this [k1][k2]
//       order), the length-M2 inverse FFT and the inverse twiddle tw[k1 j2],
//       in one tile, back to the same rows;
//   (c) column_inverse, block (tile, pair): for each of the pair's nc
//       transforms in order, the length-M1 inverse FFTs of W columns, the
//       last pass adding the magnitudes to sums that each thread holds in
//       registers (no atomics: two runs are bit-identical); then the n
//       outputs k = j1 M2 + j2 < n, W consecutive floats a row of the tile.
// The levers of the two-step entry carry over: a chunk's pairs run in
// channel order and, within a channel, in the wrapper's `order` (the bins
// sorted by phase, so the bins of one phase read its spectrum rows from L2
// in turn), and (a) runs block j of every pair before j + 1 where a pair's
// moves (the spectrum rows read, the scratch written: nc (n + M) x 8
// bytes) pass half the L2. Each launch takes the tile FFT's variant by the
// largest radix of its sub-plan; a 13-smooth M needs radices up to 10, 13
// and 16 (4 blocks of 256 threads an SM each), and the entry is built with
// those three variants only (kWidestRadix).
//
// Bound on the H100: bytes. A transform moves ~32 M + 8 n bytes through
// device memory ((a) reads the spectrum row and writes M points, (b)
// reads and writes them, (c) reads them; the code row, the chirp, the
// filter and the twiddles mostly from L2) where the function itself needs
// ~16 n (the spectrum row in, the map out): at M ~ 2n, ~72 n bytes, 5.7 GB
// at the 9.722 Msps session's 8 ch x 101 bins x 10 blocks (1.7 ms at
// 3.35 TB/s), against its ~3.4 GFLOP of float32 butterflies (0.05 ms at
// 67 TFLOP/s). Each pass of a sub-transform is a sweep of the tile through
// shared memory behind a barrier, and the passes set the time as much as
// the bytes do: at that shape the least 7-smooth M (12 sweeps of the
// tile a transform) ran 5.02 ms, 19500 (10 sweeps) 4.31 and 19683 = 3^9
// (18 sweeps) 6.24, about 0.3 ms a sweep (NVIDIA H100 80GB HBM3,
// 700.00 W; tools/torch_kernel_variants.py --k2 --bluestein). Its three
// kernels there: 1.67 / 1.75 / 0.89 ms, 1.3 TB/s of those bytes.

#include <cuda_runtime.h>

#include "pcps_tile.cuh"

namespace {

// The widest variant of the tile FFT built here (pcps_tile.cuh's kMaxR: 10,
// 13, 16 or 31); a sub-plan with a wider radix is refused.
constexpr int kWidestRadix = 16;
// Blocks an SM of the tile's radix-16 variant: 2, at 128 registers a
// thread, spills nothing where 3 (80 registers) spilled 508 bytes in
// column_inverse, whose accumulators live beside radix 16's 32 floats:
// 9722 at 8 ch x 101 bins x 10 blocks ran 4.08 ms at 2, 5.31 at 3 and
// 5.63 at 4; 16370 6.13 / 8.27 / 8.91; 65498 30.54 / 39.75 / 41.71
// (NVIDIA H100 80GB HBM3, 700.00 W; tools/torch_kernel_variants.py --k2
// --bluestein --layouts).
constexpr int kMinBlocks16 = 2;

struct Args {
  const float2* spec;    // [n_ph, n_ch, nc, n]
  const float2* code;    // [n_ch, n]
  const float2* chirp;   // [2 n]: e^{i pi t / n}
  const float2* filt;    // [M1, M2]: B[k1 + M1 k2] / (M n) at k1 M2 + k2
  const float2* tw;      // [M]: e^{+2 pi i t / M}
  const int* shift;      // [n_bins]
  const int* phase;      // [n_bins]
  const int* order;      // [n_bins]: the bins in the order the pairs run
  int n_ch, nc, n, m1, m2, n_bins;
  int tile;              // points a tile holds: kSmallTile or kTile
  int block_major;       // (a) runs block j of every pair before j + 1
  unsigned long long magic;   // floor((2^64 - 1) / 2n), for j^2 mod 2n
  Plan plan1, plan2;     // radices of the length-M1 and length-M2 FFTs
  int pair0;             // first (channel, bin) pair of this chunk
  float2* scratch;       // [pairs of the chunk, nc, M]
  float* out;            // [n_ch, n_bins, n]
};

// tw[r] as tw[r - r mod 1024] tw[r mod 1024]: two reads from at most 2048
// points of the table (L1), where tw[r] at r = k1 j2 reads a 32-byte
// sector of L2 a point (the two-step entry's twiddle).
__device__ __forceinline__ float2 table_twiddle(
    const float2* __restrict__ tw, int r) {
  return cmul(__ldg(tw + (r & ~1023)), __ldg(tw + (r & 1023)));
}

// Pass p of P of (a)'s column FFTs (length M1 over the tile's W columns),
// in the conjugate: the first reads conj(x_j c_j) from global memory (zero
// from j = n on, not loaded), the last twiddles by tw[k1 j2] and stores to
// scratch at [k1][j2], the others run shared memory to shared memory.
template <int R>
__device__ __forceinline__ void forward_step(
    const Args& a, int p, int ns, const Tile<true>& in,
    const Tile<true>& out, const float2* __restrict__ rts,
    const float2* __restrict__ s, const float2* __restrict__ kc, int k,
    int col0, float2* __restrict__ dst) {
  const int n = a.n, m2 = a.m2, len = a.m1, count = in.count;
  const unsigned long long two_n = 2ull * static_cast<unsigned>(n);
  const auto global = [&](int t, int i) {
    const int j2 = col0 + t;
    const int j = i * m2 + j2;
    if (j2 >= m2 || j >= n) return make_float2(0.0f, 0.0f);
    int src = j - k;
    if (src < 0) src += n;
    // j^2 mod 2n in 64 bits (j^2 reaches 2^40), by Barrett's reduction:
    // the quotient from the high product is short by at most one.
    const unsigned long long jj = static_cast<unsigned long long>(j) * j;
    unsigned long long r = jj - __umul64hi(jj, a.magic) * two_n;
    if (r >= two_n) r -= two_n;
    const float2 v = cmul(cmul(__ldg(s + j), __ldg(kc + src)),
                          __ldg(a.chirp + static_cast<int>(r)));
    return make_float2(v.x, -v.y);
  };
  const auto shared = [&](int t, int i) { return in.at(t, i); };
  const auto store = [&](int t, int i, float2 v) { out.at(t, i) = v; };
  const auto scratch = [&](int t, int i, float2 v) {
    const int j2 = col0 + t;
    if (j2 < m2) dst[i * m2 + j2] = cmul(v, table_twiddle(a.tw, i * j2));
  };
  const bool first = p == 0, last = p == a.plan1.n_pass - 1;
  if (first && last) {
    pass<R, true>(len, count, ns, rts, global, scratch);
  } else if (first) {
    pass<R, true>(len, count, ns, rts, global, store);
  } else if (last) {
    pass<R, true>(len, count, ns, rts, shared, scratch);
  } else {
    pass<R, true>(len, count, ns, rts, shared, store);
  }
}

// (a) Block (tile, transform): W = tile / M1 columns from col0 of
// transform tr = local pair * nc + j of the chunk. Consecutive blocks run
// a transform's tiles, then the pair's next transform, or (block_major)
// the same block j of the next pair.
template <int kMaxR>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kMaxR, kMinBlocks16>)
    column_forward(Args a) {
  extern __shared__ float4 smem_raw[];
  const int n = a.n, m1 = a.m1, m2 = a.m2;
  float2* buf0 = reinterpret_cast<float2*>(smem_raw);
  float2* buf1 = buf0 + padded(a.tile);
  float2* rts = buf1 + padded(a.tile);
  const int cols = min(a.tile / m1, m2);
  const int tiles = (m2 + cols - 1) / cols;
  const int count = gridDim.x / (tiles * a.nc);   // pairs of the chunk
  const int step = blockIdx.x / tiles;
  const int tile = blockIdx.x - step * tiles;
  const int major = a.block_major ? count : a.nc;
  const int outer = step / major;
  const int inner = step - outer * major;
  const int local = a.block_major ? inner : outer;
  const int jb = a.block_major ? outer : inner;
  const int tr = local * a.nc + jb;
  const int pair = a.pair0 + local;
  const int c = pair / a.n_bins;
  const int bin = a.order[pair - c * a.n_bins];
  int k = a.shift[bin] % n;
  if (k < 0) k += n;
  const float2* s =
      a.spec + ((static_cast<size_t>(a.phase[bin]) * a.n_ch + c) * a.nc +
                jb) * n;
  const float2* kc = a.code + static_cast<size_t>(c) * n;
  float2* dst = a.scratch + static_cast<size_t>(tr) * m1 * m2;
  load_roots(rts, a.tw, m1, m2);
  int ns = 1;
  for (int p = 0; p < a.plan1.n_pass; ++p) {
    const int r = a.plan1.radix[p];
    const Tile<true> in{p & 1 ? buf0 : buf1, m1, cols};
    const Tile<true> out{p & 1 ? buf1 : buf0, m1, cols};
    TILE_RADIX_SWITCH(r, (forward_step<R>(a, p, ns, in, out, rts, s, kc, k,
                                          tile * cols, dst)));
    __syncthreads();
    ns *= r;
  }
}

// Pass p of (b)'s 2 P passes over the tile's rows (length M2): passes 0 to
// P - 1 the forward FFT in the conjugate, the first reading the scratch
// rows from global memory, the last storing conj(v) B (the transforms'
// product FFT_M(a) B); passes P to 2 P - 1 its inverse FFT, the last
// twiddling by tw[k1 j2] and storing back to the same rows.
template <int R>
__device__ __forceinline__ void filter_step(
    const Args& a, int p, int ns, const Tile<false>& in,
    const Tile<false>& out, const float2* __restrict__ rts,
    float2* __restrict__ row, const float2* __restrict__ f, int row0,
    int rows_left) {
  const int len = a.m2, count = in.count, n_pass = a.plan2.n_pass;
  const auto global = [&](int t, int i) {
    return t < rows_left ? row[t * len + i] : make_float2(0.0f, 0.0f);
  };
  const auto shared = [&](int t, int i) { return in.at(t, i); };
  const auto store = [&](int t, int i, float2 v) { out.at(t, i) = v; };
  const auto filter = [&](int t, int i, float2 v) {
    out.at(t, i) = t < rows_left
                       ? cmul(make_float2(v.x, -v.y), __ldg(f + t * len + i))
                       : make_float2(0.0f, 0.0f);
  };
  const auto scratch = [&](int t, int i, float2 v) {
    if (t < rows_left) {
      row[t * len + i] = cmul(v, table_twiddle(a.tw, (row0 + t) * i));
    }
  };
  if (p < n_pass) {
    const bool first = p == 0, last = p == n_pass - 1;
    if (first && last) {
      pass<R, false>(len, count, ns, rts, global, filter);
    } else if (first) {
      pass<R, false>(len, count, ns, rts, global, store);
    } else if (last) {
      pass<R, false>(len, count, ns, rts, shared, filter);
    } else {
      pass<R, false>(len, count, ns, rts, shared, store);
    }
  } else if (p == 2 * n_pass - 1) {
    pass<R, false>(len, count, ns, rts, shared, scratch);
  } else {
    pass<R, false>(len, count, ns, rts, shared, store);
  }
}

// (b) Block (tile, transform): R = tile / M2 rows from row0 of transform
// tr of the chunk, in place (every read in the first pass, every write in
// the last).
template <int kMaxR>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kMaxR, kMinBlocks16>)
    row_filter(Args a) {
  extern __shared__ float4 smem_raw[];
  const int m1 = a.m1, m2 = a.m2;
  float2* buf0 = reinterpret_cast<float2*>(smem_raw);
  float2* buf1 = buf0 + padded(a.tile);
  float2* rts = buf1 + padded(a.tile);
  const int rows = min(a.tile / m2, m1);
  const int tiles = (m1 + rows - 1) / rows;
  const int tr = blockIdx.x / tiles;
  const int tile = blockIdx.x - tr * tiles;
  const int row0 = tile * rows;
  float2* row = a.scratch + static_cast<size_t>(tr) * m1 * m2 +
                static_cast<size_t>(row0) * m2;
  const float2* f = a.filt + static_cast<size_t>(row0) * m2;
  load_roots(rts, a.tw, m2, m1);
  const int n_pass = a.plan2.n_pass;
  int ns = 1;
  for (int p = 0; p < 2 * n_pass; ++p) {
    const int r = a.plan2.radix[p < n_pass ? p : p - n_pass];
    const Tile<false> in{p & 1 ? buf0 : buf1, m2, rows};
    const Tile<false> out{p & 1 ? buf1 : buf0, m2, rows};
    TILE_RADIX_SWITCH(r, (filter_step<R>(a, p, ns, in, out, rts, row, f,
                                         row0, m1 - row0)));
    __syncthreads();
    ns = p == n_pass - 1 ? 1 : ns * r;
  }
}

// Pass p < P - 1 of (c)'s column inverse FFTs (length M1 over the tile's W
// columns): the first reads the scratch columns from global memory.
template <int R>
__device__ __forceinline__ void inverse_step(
    const Args& a, int p, int ns, const Tile<true>& in,
    const Tile<true>& out, const float2* __restrict__ rts,
    const float2* __restrict__ src, int col0) {
  const int m2 = a.m2, len = a.m1, count = in.count;
  const auto global = [&](int t, int i) {
    return col0 + t < m2 ? src[i * m2 + col0 + t] : make_float2(0.0f, 0.0f);
  };
  const auto shared = [&](int t, int i) { return in.at(t, i); };
  const auto store = [&](int t, int i, float2 v) { out.at(t, i) = v; };
  if (p == 0) {
    pass<R, true>(len, count, ns, rts, global, store);
  } else {
    pass<R, true>(len, count, ns, rts, shared, store);
  }
}

// The last pass of (c)'s column inverse FFTs (ns = m = M1 / R): output
// j1 = j + q m of butterfly (t, j), its magnitude added to acc[it R + q]
// for the thread's butterflies w = threadIdx.x + it kThreads (the same
// every transform); `global` (the plan's only pass) reads through
// `first`, else the tile `in`.
template <int R, int kAcc, class First>
__device__ __forceinline__ void column_last(int len, int count, bool global,
                                            const Tile<true>& in,
                                            const float2* __restrict__ rts,
                                            const First& first,
                                            float (&acc)[kAcc]) {
  const int m = len / R;
  const int items = m * count;
  const Div by(count);
  const auto shared = [&](int t, int i) { return in.at(t, i); };
#pragma unroll
  for (int it = 0; it < kItems<R>; ++it) {
    const int w = threadIdx.x + it * kThreads;
    if (w < items) {
      int t, j;
      item<true>(w, by, count, m, t, j);
      float2 v[R];
      if (global) {
        gather<R>(v, first, rts, t, j, j, m, m);
      } else {
        gather<R>(v, shared, rts, t, j, j, m, m);
      }
      butterfly<R>(v);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        acc[it * R + q] += sqrtf(v[q].x * v[q].x + v[q].y * v[q].y);
      }
    }
  }
}

// The sums of column_last to sums[j1 W + t] (shared memory).
template <int R, int kAcc>
__device__ __forceinline__ void column_sums(int len, int count,
                                            const float (&acc)[kAcc],
                                            float* sums) {
  const int m = len / R;
  const int items = m * count;
  const Div by(count);
#pragma unroll
  for (int it = 0; it < kItems<R>; ++it) {
    const int w = threadIdx.x + it * kThreads;
    if (w < items) {
      int t, j;
      item<true>(w, by, count, m, t, j);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        sums[(j + q * m) * count + t] = acc[it * R + q];
      }
    }
  }
}

// (c) Block (tile, pair): W = tile / M1 columns from col0 of the pair's nc
// transforms, in order; the map's outputs j1 M2 + col0 + t < n stored t
// fastest.
template <int kMaxR>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kMaxR, kMinBlocks16>)
    column_inverse(Args a) {
  extern __shared__ float4 smem_raw[];
  const int m1 = a.m1, m2 = a.m2;
  float2* buf0 = reinterpret_cast<float2*>(smem_raw);
  float2* buf1 = buf0 + padded(a.tile);
  float2* rts = buf1 + padded(a.tile);
  const int cols = min(a.tile / m1, m2);
  const int tiles = (m2 + cols - 1) / cols;
  const int local = blockIdx.x / tiles;
  const int tile = blockIdx.x - local * tiles;
  const int col0 = tile * cols;
  const int n_pass = a.plan1.n_pass;
  const int r_last = a.plan1.radix[n_pass - 1];
  load_roots(rts, a.tw, m1, m2);
  float acc[acc_points(kMaxR)];
#pragma unroll
  for (int i = 0; i < acc_points(kMaxR); ++i) acc[i] = 0.0f;
  for (int jb = 0; jb < a.nc; ++jb) {
    const float2* src =
        a.scratch + (static_cast<size_t>(local) * a.nc + jb) * m1 * m2;
    int ns = 1;
    for (int p = 0; p + 1 < n_pass; ++p) {
      const int r = a.plan1.radix[p];
      const Tile<true> in{p & 1 ? buf0 : buf1, m1, cols};
      const Tile<true> out{p & 1 ? buf1 : buf0, m1, cols};
      TILE_RADIX_SWITCH(r, (inverse_step<R>(a, p, ns, in, out, rts, src,
                                            col0)));
      __syncthreads();
      ns *= r;
    }
    const Tile<true> last{n_pass & 1 ? buf1 : buf0, m1, cols};
    const auto global = [&](int t, int i) {
      return col0 + t < m2 ? src[i * m2 + col0 + t] : make_float2(0.0f, 0.0f);
    };
    TILE_RADIX_SWITCH(r_last, (column_last<R>(m1, cols, n_pass == 1, last,
                                              rts, global, acc)));
    __syncthreads();   // the next transform's first pass overwrites bufs
  }
  float* sums = reinterpret_cast<float*>(buf0);
  TILE_RADIX_SWITCH(r_last, (column_sums<R>(m1, cols, acc, sums)));
  __syncthreads();
  const int pair = a.pair0 + local;
  const int c = pair / a.n_bins;
  const int bin = a.order[pair - c * a.n_bins];
  float* dst = a.out + (static_cast<size_t>(c) * a.n_bins + bin) * a.n;
  const Div by_cols(cols);
  for (int e = threadIdx.x; e < cols * m1; e += kThreads) {
    const int j1 = by_cols(e);
    const int t = e - j1 * cols;
    const int j = j1 * m2 + col0 + t;
    if (col0 + t < m2 && j < a.n) dst[j] = sums[e];
  }
}

// Launch step `which` of a chunk (0: column_forward, 1: row_filter, 2:
// column_inverse) in the tile FFT's variant kMaxR.
template <int kMaxR>
int launch_variant(int which, const Args& args, long long blocks,
                   cudaStream_t stream) {
  void (*const kernels[])(Args) = {column_forward<kMaxR>, row_filter<kMaxR>,
                                   column_inverse<kMaxR>};
  const int len = which == 1 ? args.m2 : args.m1;
  const size_t smem = (2 * padded(args.tile) + len) * sizeof(float2);
  const cudaError_t err = cudaFuncSetAttribute(
      kernels[which], cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernels[which]<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}

template <int kWidest = kWidestRadix>
int launch_step(int which, int variant, const Args& args, long long blocks,
                cudaStream_t stream) {
  if (blocks < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant == 10) return launch_variant<10>(which, args, blocks, stream);
  if (variant == 13) return launch_variant<13>(which, args, blocks, stream);
  if (variant == 16) return launch_variant<16>(which, args, blocks, stream);
  if constexpr (kWidest > 16) {
    return launch_variant<31>(which, args, blocks, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" const char* sydr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// spec [n_ph, n_ch, nc, n], code [n_ch, n], chirp [2 n], filt [M1 M2], tw
// [M1 M2] complex64; shift / phase / order [n_bins] int32 (order: a
// permutation of the bins, the order their pairs run in within a channel);
// scratch [chunk_pairs, nc, M1 M2] complex64; out [n_ch, n_bins, n] f32;
// all on the device. 2 <= m1 <= 1024, 2 <= m2 <= 4096, M = m1 m2 >= 2 n - 1;
// radices1 / radices2: host arrays of the sub-plans (n_pass1, n_pass2
// radices of product m1, m2; the widest radix kWidestRadix). The n_ch
// n_bins (channel, bin) pairs run in chunks of chunk_pairs, three launches
// each, all queued on `stream`.
extern "C" int pcps_bins_bluestein_launch(
    const void* spec, const void* code, const void* chirp, const void* filt,
    const void* tw, const void* shift, const void* phase, const void* order,
    int n_ch, int nc, int n, int m1, int m2, const int* radices1,
    int n_pass1, const int* radices2, int n_pass2, int n_bins, void* scratch,
    int chunk_pairs, void* out, void* stream) {
  if (n < 2 || n_ch < 1 || nc < 1 || n_bins < 1 || chunk_pairs < 1 ||
      m1 < 2 || m1 > kMaxN1 || m2 < 2 || m2 > kTile ||
      static_cast<long long>(m1) * m2 < 2LL * n - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args;
  int max1 = 0, max2 = 0;
  int bad = sub_plan(radices1, n_pass1, m1, false, &args.plan1, &max1);
  if (bad == 0) {
    bad = sub_plan(radices2, n_pass2, m2, false, &args.plan2, &max2);
  }
  if (bad != 0) return bad;
  if (max1 > kWidestRadix || max2 > kWidestRadix) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long m = static_cast<long long>(m1) * m2;
  args.spec = static_cast<const float2*>(spec);
  args.code = static_cast<const float2*>(code);
  args.chirp = static_cast<const float2*>(chirp);
  args.filt = static_cast<const float2*>(filt);
  args.tw = static_cast<const float2*>(tw);
  args.shift = static_cast<const int*>(shift);
  args.phase = static_cast<const int*>(phase);
  args.order = static_cast<const int*>(order);
  args.n_ch = n_ch;
  args.nc = nc;
  args.n = n;
  args.m1 = m1;
  args.m2 = m2;
  args.n_bins = n_bins;
  args.tile = tile_points(m1, m2, has_radix16(args.plan1) ||
                                      has_radix16(args.plan2));
  args.block_major = 1LL * nc * (n + m) * sizeof(float2) > kL2Bytes / 2;
  args.magic = ~0ull / (2ull * static_cast<unsigned>(n));
  args.scratch = static_cast<float2*>(scratch);
  args.out = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = args.tile / m1 < m2 ? args.tile / m1 : m2;
  const int rows = args.tile / m2 < m1 ? args.tile / m2 : m1;
  const long long col_tiles = (m2 + cols - 1) / cols;
  const long long row_tiles = (m1 + rows - 1) / rows;
  const int pairs = n_ch * n_bins;
  for (int p0 = 0; p0 < pairs; p0 += chunk_pairs) {
    const int count = pairs - p0 < chunk_pairs ? pairs - p0 : chunk_pairs;
    args.pair0 = p0;
    const long long transforms = static_cast<long long>(count) * nc;
    int err = launch_step(0, max1, args, col_tiles * transforms, st);
    if (err == 0) err = launch_step(1, max2, args, row_tiles * transforms, st);
    if (err == 0) err = launch_step(2, max1, args, col_tiles * count, st);
    if (err != 0) return err;
  }
  return 0;
}
