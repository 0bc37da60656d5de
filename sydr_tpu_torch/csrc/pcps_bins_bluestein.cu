// K2 pcps_bins, Bluestein entry: the per-bin PCPS chain for a code period n
// that the radix entries (pcps_bins.cu, pcps_bins_cluster.cu) do not take
// or take slowly: above 65,536 points, where a transform outgrows a
// cluster's shared memory, and where n has a prime factor above
// acq_kernel.GENERIC_MAX_PRIME, whose generic pass costs p operations a
// point.
//
// Replaces the Pallas kernel sydr_tpu/ops/acq_kernel.py (_kernel, launched by
// pcps_fused_bins), as the radix entries do: for bin b with plan entry
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
// (|j| < n), taken as a circular one of length M >= 2 n - 1, M a power of
// two up to 2^21 (n up to 2^20): conv = IFFT_M(FFT_M(a) * FFT_M(b)) / M.
// The filter's transform B = FFT_M(b) / (M n) is a constant of n, built in
// float64 on the host by the wrapper (acq_kernel.bluestein_filter) with the
// 1/M of the convolution and the 1/n of torch.fft.ifft folded in. |c_k| =
// 1, so the magnitude needs no last chirp product: |IDFT_n(x)[k]| / n =
// |conv[k]|. The chirp is read from a table of the 2n values e^{i pi t/n}
// (float64-built) at the exact index t = j^2 mod 2n, j^2 in 64 bits (j
// reaches 2^20).
//
// Each length-M transform is a four-step FFT, M = M1 M2 (M1 = 2^floor(m/2),
// M2 = 2^ceil(m/2), both at most 2048): with input index j = j1 M2 + j2 and
// output index k = k1 + M1 k2,
//   column FFTs of length M1 over j1 (stride M2), twiddle
//   e^{-2 pi i j2 k1 / M}, row FFTs of length M2 over j2,
// leaving FFT(a)[k1 + M1 k2] at row k1, column k2. The inverse walks the
// same steps backwards with the + sign. Three launches per chunk of
// (bin, channel) pairs, on global scratch that the wrapper allocates
// (M complex64 per transform, nc transforms per pair):
//   (a) column_forward: the spectrum product with the rolled code (as the
//       radix entries' first pass forms it), times c_j, zero past n; the
//       column FFTs; the twiddle; stored at [k1][j2];
//   (b) row_filter: row FFTs, times B (stored by the wrapper in this
//       [k1][k2] order), row inverse FFTs, the inverse twiddle; in place;
//   (c) column_inverse: column inverse FFTs, magnitude, summed over the nc
//       transforms of the pair in order inside one block (no atomics: two
//       runs are bit-identical); the n outputs k = j1 M2 + j2 < n stored.
// A short transform (length L = M1 or M2) is a Stockham FFT in shared
// memory over a tile of 4096 points a block, 256 threads: W = 4096 / M1
// columns at once in (a) and (c) (each row of the tile W contiguous points
// of global memory, at least 4: one 32-byte sector), 4096 / M2 rows in
// (b). Its passes are radix 16 (4 x 4 in registers, roots as float64
// literals), after one of radix 2, 4 or 8 for the rest of log2 L: L = 256
// is 2 passes, 2048 is 3. A thread holds the 16 points of its butterflies
// in registers across a barrier, so one tile buffer serves (in place),
// padded one slot in 16 against bank conflicts, beside the L roots of the
// pass twiddles (tw[x M / L], x < L). Every twiddle and root is tw[t] =
// e^{+2 pi i t / M} (float64-built, stored complex64) at an exact integer
// index below M, conjugated for the forward transforms.
//
// Bound on the H100: bytes. A transform moves 4 M complex64 through global
// memory ((a) writes, (b) reads and writes, (c) reads: 32 M bytes) where the
// function itself needs ~16 n (the spectrum row in, the map out): 0.31 us
// a transform at the card's 3.35 TB/s at M = 2^15, where its 2 x 5 M
// log2 M flops take 0.07 us at the f32 rate. The design
// keeps to the plain form (one pass a launch, no L2 blocking of the
// scratch, no TMA): what it removes is the generic pass's p operations a
// point and the clusters' ceiling on n. Measured (NVIDIA H100 80GB HBM3,
// 700.00 W, 8 ch x 101 bins x 10 blocks at n = 9722, M = 32768;
// tools/torch_kernel_variants.py --k2 --entries, --bluestein): a first
// form with radix-4 passes over two ping-pong buffers and every root read
// from the global table took 12.40 ms; radix-16 passes in registers over
// one padded buffer with the roots in shared memory 9.32; Barrett's
// reduction for j^2 mod 2n (in place of a 64-bit division), unrolled
// tile loads and the magnitudes' sums in shared memory (they spilled in
// registers) 7.73, its three kernels 2.33 / 2.90 / 2.49 ms, 0.9-1.5 TB/s
// of scratch traffic: latency bound at three blocks an SM. A cap of 128
// registers (two blocks an SM, no spills) ran 1% faster there and 12%
// slower at n = 26500; 64 (four blocks) spilled and ran 42-48% slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;             // blocks an SM: <= 85 registers
constexpr int kLgTile = 12;               // 4096 points a block
constexpr int kTile = 1 << kLgTile;
constexpr int kPts = kTile / kThreads;    // points a thread holds in a pass
constexpr int kLgMaxSub = 11;             // M1, M2 <= 2048
constexpr int kLgMaxM = 21;               // M <= 2^21, n <= 2^20
// The tile with one spare slot every 16 points (pad), then the roots of
// one sub-FFT length.
constexpr int kTilePadded = kTile + kTile / 16;
constexpr size_t kSmem =
    (kTilePadded + (1 << kLgMaxSub)) * sizeof(float2);
// column_inverse adds the magnitudes' sums, one float a tile point.
constexpr size_t kSmemInverse = kSmem + kTile * sizeof(float);

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
template <bool kInv>
__device__ __forceinline__ float2 sign(float2 w) {
  return kInv ? w : make_float2(w.x, -w.y);
}

// A tile slot: one spare slot after every 16, so that the strides of a
// radix-16 pass (16 and its multiples) do not fall on one bank.
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// e^{+2 pi i e / 16}, e < 16 (float64 values rounded once): the roots
// inside the register butterflies.
__constant__ float2 kRoots16[16] = {
    {1.0f, 0.0f},
    {0.9238795325112867f, 0.3826834323650898f},
    {0.7071067811865476f, 0.7071067811865476f},
    {0.3826834323650898f, 0.9238795325112867f},
    {0.0f, 1.0f},
    {-0.3826834323650898f, 0.9238795325112867f},
    {-0.7071067811865476f, 0.7071067811865476f},
    {-0.9238795325112867f, 0.3826834323650898f},
    {-1.0f, 0.0f},
    {-0.9238795325112867f, -0.3826834323650898f},
    {-0.7071067811865476f, -0.7071067811865476f},
    {-0.3826834323650898f, -0.9238795325112867f},
    {0.0f, -1.0f},
    {0.3826834323650898f, -0.9238795325112867f},
    {0.7071067811865476f, -0.7071067811865476f},
    {0.9238795325112867f, -0.3826834323650898f}};

// v <- DFT_R(v) in registers, sign + (kInv) or -: v[q] = sum_r v[r]
// e^{+-2 pi i q r / R}.
template <bool kInv>
__device__ __forceinline__ void dft(float2 (&v)[2]) {
  const float2 a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}

template <bool kInv>
__device__ __forceinline__ void dft(float2 (&v)[4]) {
  const float2 s02 = cadd(v[0], v[2]);
  const float2 d02 = csub(v[0], v[2]);
  const float2 s13 = cadd(v[1], v[3]);
  const float2 d13 = csub(v[1], v[3]);
  // +i d13 for the inverse, -i d13 for the forward transform.
  const float2 t = kInv ? make_float2(-d13.y, d13.x)
                        : make_float2(d13.y, -d13.x);
  v[0] = cadd(s02, s13);
  v[1] = cadd(d02, t);
  v[2] = csub(s02, s13);
  v[3] = csub(d02, t);
}

// DFT of length A B (8 = 2 x 4, 16 = 4 x 4) by Cooley-Tukey in registers:
// B DFTs of length A over the points B n1 + n2, the roots w^{n2 k1}, then
// A DFTs of length B; output k1 + A k2. Every index is a compile-time
// constant.
template <int A, int B, bool kInv>
__device__ __forceinline__ void dft_split(float2 (&v)[A * B]) {
  float2 y[B][A];
#pragma unroll
  for (int n2 = 0; n2 < B; ++n2) {
    float2 t[A];
#pragma unroll
    for (int n1 = 0; n1 < A; ++n1) t[n1] = v[B * n1 + n2];
    dft<kInv>(t);
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) {
      y[n2][k1] = n2 * k1 == 0
          ? t[k1]
          : cmul(t[k1], sign<kInv>(kRoots16[n2 * k1 * (16 / (A * B))]));
    }
  }
#pragma unroll
  for (int k1 = 0; k1 < A; ++k1) {
    float2 u[B];
#pragma unroll
    for (int n2 = 0; n2 < B; ++n2) u[n2] = y[n2][k1];
    dft<kInv>(u);
#pragma unroll
    for (int k2 = 0; k2 < B; ++k2) v[k1 + A * k2] = u[k2];
  }
}

template <bool kInv>
__device__ __forceinline__ void dft(float2 (&v)[8]) {
  dft_split<2, 4, kInv>(v);
}

template <bool kInv>
__device__ __forceinline__ void dft(float2 (&v)[16]) {
  dft_split<4, 4, kInv>(v);
}

// Offset of point i of transform t in a tile of 2^lg_count transforms of
// length 2^lg_len: columns (kCols, point-major: the tile's W columns
// side by side) or rows (transform-major).
template <bool kCols>
__device__ __forceinline__ int tile_offset(int t, int i, int lg_len,
                                           int lg_count) {
  return kCols ? (i << lg_count) | t : (t << lg_len) | i;
}

// One Stockham pass of radix R over every transform of the tile, in place:
// with ns = 2^lg_ns the radices done so far and m = L / R, butterfly j
// (k = j mod ns) reads in[j + q m] q < R, twiddles by w_L^{q k L / (R ns)}
// = rts[q k L / (R ns)], and writes out[(j - k) R + k + q ns]. A thread
// holds its kPts / R butterflies' points in registers between a barrier
// after the loads and one after the stores, so one buffer serves.
template <int R, bool kInv, bool kCols>
__device__ __forceinline__ void tile_pass(float2* buf,
                                          const float2* __restrict__ rts,
                                          int lg_len, int lg_count,
                                          int lg_ns) {
  constexpr int kLgR = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  constexpr int kItems = kPts / R;
  const int lg_q = lg_len - kLgR;
  const int items = 1 << (lg_q + lg_count);
  const int rt_shift = lg_len - kLgR - lg_ns;
  float2 v[kItems][R];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int w = threadIdx.x + it * kThreads;
    if (w < items) {
      const int t = kCols ? w & ((1 << lg_count) - 1) : w >> lg_q;
      const int j = kCols ? w >> lg_count : w & ((1 << lg_q) - 1);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        v[it][q] = buf[pad(
            tile_offset<kCols>(t, j + (q << lg_q), lg_len, lg_count))];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int w = threadIdx.x + it * kThreads;
    if (w < items) {
      const int t = kCols ? w & ((1 << lg_count) - 1) : w >> lg_q;
      const int j = kCols ? w >> lg_count : w & ((1 << lg_q) - 1);
      const int k = j & ((1 << lg_ns) - 1);
      if (lg_ns > 0) {
#pragma unroll
        for (int q = 1; q < R; ++q) {
          v[it][q] = cmul(v[it][q], sign<kInv>(rts[(q * k) << rt_shift]));
        }
      }
      dft<kInv>(v[it]);
      const int base = ((j - k) << kLgR) + k;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        buf[pad(tile_offset<kCols>(t, base + (q << lg_ns), lg_len,
                                   lg_count))] = v[it][q];
      }
    }
  }
  __syncthreads();
}

// FFTs of length L = 2^lg_len (natural order in and out) of every transform
// of the tile, in place: radix-16 passes after one of radix 2, 4 or 8 for
// the rest of lg_len. rts[x] = e^{+2 pi i x / L}, x < L.
template <bool kInv, bool kCols>
__device__ void tile_fft(float2* buf, const float2* __restrict__ rts,
                         int lg_len, int lg_count) {
  int lg_ns = lg_len & 3;
  if (lg_ns == 1) tile_pass<2, kInv, kCols>(buf, rts, lg_len, lg_count, 0);
  if (lg_ns == 2) tile_pass<4, kInv, kCols>(buf, rts, lg_len, lg_count, 0);
  if (lg_ns == 3) tile_pass<8, kInv, kCols>(buf, rts, lg_len, lg_count, 0);
  for (; lg_ns < lg_len; lg_ns += 4) {
    tile_pass<16, kInv, kCols>(buf, rts, lg_len, lg_count, lg_ns);
  }
}

// rts[x] = tw[x M / L] = e^{+2 pi i x / L} for x < L = 2^lg_len.
__device__ __forceinline__ void load_roots(float2* rts,
                                           const float2* __restrict__ tw,
                                           int lg_len, int lg_m) {
  for (int x = threadIdx.x; x < (1 << lg_len); x += kThreads) {
    rts[x] = __ldg(tw + (x << (lg_m - lg_len)));
  }
}

struct Args {
  const float2* spec;    // [n_ph, n_ch, nc, n]
  const float2* code;    // [n_ch, n]
  const float2* chirp;   // [2 n]: e^{i pi t / n}
  const float2* filt;    // [M1, M2]: B[k1 + M1 k2] / (M n) at k1 M2 + k2
  const float2* tw;      // [M]: e^{+2 pi i t / M}
  const int* shift;      // [n_bins]
  const int* phase;      // [n_bins]
  int n_ch, nc, n, n_bins;
  int lg_m1, lg_m2;
  unsigned long long magic;   // floor((2^64 - 1) / 2n), for j^2 mod 2n
  int pair0;             // first (channel, bin) pair of this chunk
  float2* scratch;       // [pairs of the chunk, nc, M]
  float* out;            // [n_ch, n_bins, n]
};

// (a) Block (tile, transform): W = 2^lg_w columns from col0 of transform
// tr = local pair * nc + j of the chunk.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    column_forward(Args a) {
  extern __shared__ float4 smem_raw[];
  float2* buf = reinterpret_cast<float2*>(smem_raw);
  float2* rts = buf + kTilePadded;
  const int lg_m = a.lg_m1 + a.lg_m2;
  const int lg_tile = min(kLgTile, lg_m);
  const int lg_w = lg_tile - a.lg_m1;
  const int lg_tiles = lg_m - lg_tile;
  const int tile = blockIdx.x & ((1 << lg_tiles) - 1);
  const int tr = blockIdx.x >> lg_tiles;
  const int pair = a.pair0 + tr / a.nc;
  const int jb = tr - (tr / a.nc) * a.nc;
  const int c = pair / a.n_bins;
  const int bin = pair - c * a.n_bins;
  const int n = a.n;
  int k = a.shift[bin] % n;
  if (k < 0) k += n;
  const int p = a.phase[bin];
  const float2* s =
      a.spec + ((static_cast<size_t>(p) * a.n_ch + c) * a.nc + jb) * n;
  const float2* kc = a.code + static_cast<size_t>(c) * n;
  const int col0 = tile << lg_w;
  const int points = 1 << lg_tile;
  const unsigned long long two_n = 2ull * static_cast<unsigned>(n);
  load_roots(rts, a.tw, a.lg_m1, lg_m);
#pragma unroll
  for (int i = 0; i < kPts; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int j = ((e >> lg_w) << a.lg_m2) + col0 + (e & ((1 << lg_w) - 1));
    float2 v = make_float2(0.0f, 0.0f);
    if (e < points && j < n) {
      int src = j - k;
      if (src < 0) src += n;
      // j^2 mod 2n in 64 bits (j^2 reaches 2^40), by Barrett's reduction:
      // the quotient from the high product is short by at most one.
      const unsigned long long jj = static_cast<unsigned long long>(j) * j;
      unsigned long long t = jj - __umul64hi(jj, a.magic) * two_n;
      if (t >= two_n) t -= two_n;
      v = cmul(cmul(__ldg(s + j), __ldg(kc + src)),
               __ldg(a.chirp + static_cast<int>(t)));
    }
    if (e < points) buf[pad(e)] = v;
  }
  __syncthreads();
  tile_fft<false, true>(buf, rts, a.lg_m1, lg_w);
  float2* dst = a.scratch + (static_cast<size_t>(tr) << lg_m);
#pragma unroll
  for (int i = 0; i < kPts; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int k1 = e >> lg_w;
    const int j2 = col0 + (e & ((1 << lg_w) - 1));
    if (e < points) {
      dst[(k1 << a.lg_m2) + j2] =
          cmul(buf[pad(e)], sign<false>(__ldg(a.tw + k1 * j2)));
    }
  }
}

// (b) Block (tile, transform): R = 2^lg_r rows from row0, in place.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    row_filter(Args a) {
  extern __shared__ float4 smem_raw[];
  float2* buf = reinterpret_cast<float2*>(smem_raw);
  float2* rts = buf + kTilePadded;
  const int lg_m = a.lg_m1 + a.lg_m2;
  const int lg_tile = min(kLgTile, lg_m);
  const int lg_r = lg_tile - a.lg_m2;
  const int lg_tiles = lg_m - lg_tile;
  const int tile = blockIdx.x & ((1 << lg_tiles) - 1);
  const int tr = blockIdx.x >> lg_tiles;
  const int points = 1 << lg_tile;
  const size_t start = (static_cast<size_t>(tr) << lg_m) +
                       (static_cast<size_t>(tile) << lg_tile);
  float2* row = a.scratch + start;
  load_roots(rts, a.tw, a.lg_m2, lg_m);
#pragma unroll
  for (int i = 0; i < kPts; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < points) buf[pad(e)] = row[e];
  }
  __syncthreads();
  tile_fft<false, false>(buf, rts, a.lg_m2, lg_r);
  const float2* f = a.filt + (static_cast<size_t>(tile) << lg_tile);
#pragma unroll
  for (int i = 0; i < kPts; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < points) buf[pad(e)] = cmul(buf[pad(e)], __ldg(f + e));
  }
  __syncthreads();
  tile_fft<true, false>(buf, rts, a.lg_m2, lg_r);
  const int row0 = tile << lg_r;
#pragma unroll
  for (int i = 0; i < kPts; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int k1 = row0 + (e >> a.lg_m2);
    const int j2 = e & ((1 << a.lg_m2) - 1);
    if (e < points) row[e] = cmul(buf[pad(e)], __ldg(a.tw + k1 * j2));
  }
}

// (c) Block (tile, pair): W columns from col0 of the pair's nc transforms,
// in order.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    column_inverse(Args a) {
  extern __shared__ float4 smem_raw[];
  float2* buf = reinterpret_cast<float2*>(smem_raw);
  float2* rts = buf + kTilePadded;
  const int lg_m = a.lg_m1 + a.lg_m2;
  const int lg_tile = min(kLgTile, lg_m);
  const int lg_w = lg_tile - a.lg_m1;
  const int lg_tiles = lg_m - lg_tile;
  const int tile = blockIdx.x & ((1 << lg_tiles) - 1);
  const int local = blockIdx.x >> lg_tiles;
  const int col0 = tile << lg_w;
  const int points = 1 << lg_tile;
  // The sums live in shared memory (registers would spill under the
  // FFT's); a thread owns tile points threadIdx.x + i kThreads.
  float* acc = reinterpret_cast<float*>(rts + (1 << kLgMaxSub));
  load_roots(rts, a.tw, a.lg_m1, lg_m);
#pragma unroll
  for (int i = 0; i < kPts; ++i) acc[threadIdx.x + i * kThreads] = 0.0f;
  for (int jb = 0; jb < a.nc; ++jb) {
    const float2* src =
        a.scratch + (static_cast<size_t>(local * a.nc + jb) << lg_m);
#pragma unroll
    for (int i = 0; i < kPts; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int k1 = e >> lg_w;
      if (e < points) {
        buf[pad(e)] = src[(k1 << a.lg_m2) + col0 + (e & ((1 << lg_w) - 1))];
      }
    }
    __syncthreads();
    tile_fft<true, true>(buf, rts, a.lg_m1, lg_w);
#pragma unroll
    for (int i = 0; i < kPts; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < points) {
        const float2 v = buf[pad(e)];
        acc[e] += sqrtf(v.x * v.x + v.y * v.y);
      }
    }
    __syncthreads();   // the next transform's load overwrites the tile
  }
  float* dst = a.out + static_cast<size_t>(a.pair0 + local) * a.n;
#pragma unroll
  for (int i = 0; i < kPts; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int k = ((e >> lg_w) << a.lg_m2) + col0 + (e & ((1 << lg_w) - 1));
    if (e < points && k < a.n) dst[k] = acc[e];
  }
}

template <class Kernel>
int launch(Kernel kernel, long long blocks, size_t smem, const Args& args,
           cudaStream_t stream) {
  if (blocks < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* sydr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// spec [n_ph, n_ch, nc, n], code [n_ch, n], chirp [2 n], filt [M1 M2], tw
// [M1 M2] complex64; shift / phase [n_bins] int32; scratch [chunk_pairs,
// nc, M1 M2] complex64; out [n_ch, n_bins, n] f32; all on the device. M1 =
// 2^lg_m1 and M2 = 2^lg_m2, each at most 2048, M = M1 M2 >= 2 n - 1 (at
// most 2^21). The n_ch n_bins (channel, bin) pairs run in chunks of
// chunk_pairs, three launches each, all queued on `stream`.
extern "C" int pcps_bins_bluestein_launch(
    const void* spec, const void* code, const void* chirp, const void* filt,
    const void* tw, const void* shift, const void* phase, int n_ch, int nc,
    int n, int lg_m1, int lg_m2, int n_bins, void* scratch, int chunk_pairs,
    void* out, void* stream) {
  const int lg_m = lg_m1 + lg_m2;
  if (n < 2 || n_ch < 1 || nc < 1 || n_bins < 1 || chunk_pairs < 1 ||
      lg_m1 < 1 || lg_m2 < lg_m1 || lg_m2 > kLgMaxSub || lg_m > kLgMaxM ||
      (1LL << lg_m) < 2LL * n - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*const kernels[])(Args) = {column_forward, row_filter,
                                   column_inverse};
  const size_t smem[] = {kSmem, kSmem, kSmemInverse};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem[i]));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Args args;
  args.spec = static_cast<const float2*>(spec);
  args.code = static_cast<const float2*>(code);
  args.chirp = static_cast<const float2*>(chirp);
  args.filt = static_cast<const float2*>(filt);
  args.tw = static_cast<const float2*>(tw);
  args.shift = static_cast<const int*>(shift);
  args.phase = static_cast<const int*>(phase);
  args.n_ch = n_ch;
  args.nc = nc;
  args.n = n;
  args.n_bins = n_bins;
  args.lg_m1 = lg_m1;
  args.lg_m2 = lg_m2;
  args.magic = ~0ull / (2ull * static_cast<unsigned>(n));
  args.scratch = static_cast<float2*>(scratch);
  args.out = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pairs = n_ch * n_bins;
  const long long tiles = 1LL << (lg_m - (lg_m < kLgTile ? lg_m : kLgTile));
  for (int p0 = 0; p0 < pairs; p0 += chunk_pairs) {
    const int count = pairs - p0 < chunk_pairs ? pairs - p0 : chunk_pairs;
    args.pair0 = p0;
    const long long transforms = static_cast<long long>(count) * nc;
    int err = launch(column_forward, tiles * transforms, kSmem, args, st);
    if (err == 0) {
      err = launch(row_filter, tiles * transforms, kSmem, args, st);
    }
    if (err == 0) {
      err = launch(column_inverse, tiles * count, kSmemInverse, args, st);
    }
    if (err != 0) return err;
  }
  return 0;
}
