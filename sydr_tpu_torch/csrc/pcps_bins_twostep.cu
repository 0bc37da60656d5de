// K2 pcps_bins, two-step entry: the per-bin PCPS chain for a code period n
// above the clusters' 65,536 points whose prime factors are all at most 31
// (70000 at 70 Msps, 122880, 245520 at 245.52 Msps, 2^20), as one FFT of
// length n in two passes through global memory.
//
// Replaces the Pallas kernel sydr_tpu/ops/acq_kernel.py (_kernel, launched by
// pcps_fused_bins), as the other entries do: for bin b with plan entry
// (k_b, p_b) and channel c,
//
//   out[c, b, :] = sum_j | IDFT_n( S[p_b, c, j, :] * roll(K[c], k_b) ) | / n
//
// over the nc non-coherent blocks j (IDFT_n unnormalised, + sign).
//
// The four-step split n = N1 N2 (N1 <= N2, acq_kernel.balanced_factors, the
// JAX package's split: 250 x 280 at n = 70000), input index j = N2 j1 + j2,
// output index k = k1 + N1 k2:
//
//   IDFT_n(x)[k1 + N1 k2] = sum_j2 e^{+2 pi i j2 k2 / N2}
//       [ e^{+2 pi i j2 k1 / n} sum_j1 x[N2 j1 + j2] e^{+2 pi i j1 k1 / N1} ]
//
// Two launches per chunk of (bin, channel) pairs, on global scratch that
// the wrapper allocates (n complex64 a transform, nc transforms a pair):
//   (a) column_pass, block (tile, transform): the length-N1 inverse FFTs
//       over j1 (stride N2) of W columns, the first pass reading the
//       spectrum product with the rolled code at the radix entries' fused
//       index (no chirp, no padding) from global memory, the last
//       twiddling by e^{+2 pi i k1 j2 / n} (tw[k1 j2], an exact integer
//       index below n, read as two factors of the table) and storing to
//       scratch at [k1][j2];
//   (b) row_pass, block (tile, pair): for each of the pair's nc transforms
//       in order, the length-N2 inverse FFTs of R contiguous rows k1, the
//       first pass reading scratch, the last adding the magnitudes to
//       sums that each thread holds in registers for the same outputs of
//       every transform (no atomics: two runs are bit-identical); then
//       out[k1 + N1 k2] = sum / n through shared memory, R consecutive
//       floats of the map a column of the tile.
// A tile holds W = tile / N1 columns in (a) and R = tile / N2 rows in (b),
// tile = 2048 points where N2 <= 2048 and N1 <= 256 (at least 8 columns:
// 64-byte rows of scratch) and no sub-plan has a generic or a radix-16
// pass (pcps_tile.cuh's tile_points), else 4096: every n the entry takes
// splits with N1 <= 1024 (W >= 4) and N2 <= 4096 (R >= 1). W and R need
// not divide N2 and N1: the last tile's spare lanes load zeros and store
// nothing.
// A chunk's pairs run in channel order and, within a channel, in the
// order of the wrapper's `order` (the bins sorted by phase), so the bins
// that share a phase read its spectrum rows from L2 in turn: (a) runs a
// pair's nc transforms one after the other, or, where those moves pass
// half the L2 (2 nc n x 8 bytes: the rows read and the scratch written
// before the next bin reads them again), block j of every pair of the
// chunk before block j + 1. At 8 ch x 101 bins x 10 blocks the second
// order ran n = 245520 (39 MB) in 51.73 ms against 56.89 and n = 70000
// (11 MB) in 9.17 against 8.82; the bins in the plan's order, 57.27 and
// 10.46 (NVIDIA H100 80GB HBM3, 700.00 W; one run of
// tools/torch_kernel_variants.py --twostep).
//
// A sub-transform (length L = N1 or N2, plan acq_kernel.sub_plan(L): the
// generic radices, then tile_radix_plan, whose power of two takes radix-16
// passes, or one pass for a length that is a radix) is pcps_tile.cuh's
// Stockham FFT over a tile in shared memory (its header: the passes, the
// buffers, the variants by the largest radix of the sub-plan), point-major
// in (a) and row-major in (b).
//
// Bound on the H100: bytes. A transform moves ~24 n bytes through device
// memory (the spectrum row in, the scratch written by (a) and read by (b),
// the map out once a pair; the code row and the bins' shared spectrum
// rows mostly from L2) where Bluestein's entry moves 32 M (M >= 2n - 1)
// and the function itself ~12 n: 13.7
// GB at the 70 Msps session's 8 ch x 101 bins x 10 blocks, 4.1 ms at
// 3.35 TB/s, against its ~45 GFLOP of float32 butterflies, 0.7 ms at 67
// TFLOP/s. It runs in 8.82 ms there (column pass 5.46, row pass 3.38;
// the order note's run), 1.55 TB/s of those bytes.

#include <cuda_runtime.h>

#include "pcps_tile.cuh"

namespace {

// Blocks an SM of the tile's radix-16 variant (pcps_tile.cuh): its plans
// take the 4096-point tile, which holds 3 blocks of shared memory an SM
// where the sub-transform is up to ~450 points. At 1 ch x 11 bins x 2
// blocks 3 ran n = 131072 in 0.0728 ms and 122880 in 0.0801 where 2 ran
// 0.0894 and 0.0957 (4: 0.0778, 0.0845), and 2^20 at 2 ch x 101 x 10 in
// 46.36 ms against 46.38 (4: 49.52); 80 registers a thread spill 144
// bytes in the row pass (NVIDIA H100 80GB HBM3, 700.00 W;
// tools/torch_kernel_variants.py --twostep --layouts).
constexpr int kMinBlocks16 = 3;

struct Args {
  const float2* spec;    // [n_ph, n_ch, nc, n]
  const float2* code;    // [n_ch, n]
  const float2* tw;      // [n]: e^{+2 pi i t / n}
  const int* shift;      // [n_bins]
  const int* phase;      // [n_bins]
  const int* order;      // [n_bins]: the bins in the order the pairs run
  int n_ch, nc, n, n1, n2, n_bins;
  int tile;              // points a tile holds: kSmallTile or kTile
  int block_major;       // (a) runs block j of every pair before j + 1
  Plan plan1, plan2;     // radices of the length-N1 and length-N2 FFTs
  int pair0;             // first (channel, bin) pair of this chunk
  float2* scratch;       // [pairs of the chunk, nc, n]
  float* out;            // [n_ch, n_bins, n]
};

// Pass p of P of the column FFTs (length N1 over the tile's W columns):
// the first reads the spectrum product from global memory, the last
// twiddles by tw[k1 j2] and stores to scratch at [k1][j2], the others
// run shared memory to shared memory.
template <int R>
__device__ __forceinline__ void column_step(
    const Args& a, int p, int ns, const Tile<true>& in,
    const Tile<true>& out, const float2* __restrict__ rts,
    const float2* __restrict__ s, const float2* __restrict__ kc, int k,
    int col0, float2* __restrict__ dst) {
  const int n = a.n, n2 = a.n2, len = a.n1, count = in.count;
  const auto global = [&](int t, int i) {
    const int j2 = col0 + t;
    if (j2 >= n2) return make_float2(0.0f, 0.0f);
    const int j = i * n2 + j2;
    int src = j - k;
    if (src < 0) src += n;
    return cmul(__ldg(s + j), __ldg(kc + src));
  };
  const auto shared = [&](int t, int i) { return in.at(t, i); };
  const auto store = [&](int t, int i, float2 v) { out.at(t, i) = v; };
  const auto scratch = [&](int t, int i, float2 v) {
    const int j2 = col0 + t;
    if (j2 < n2) {
      // tw[r], r = k1 j2 < n, as tw[r - r mod 1024] tw[r mod 1024]: two
      // reads from at most 2048 points of the table (L1), where tw[r]
      // reads a 32-byte sector of L2 a point: 8.82 ms against 10.10 at
      // n = 70000, 8 ch x 101 bins x 10 blocks (the order note's run).
      const int r = i * j2;
      dst[i * n2 + j2] =
          cmul(v, cmul(__ldg(a.tw + (r & ~1023)), __ldg(a.tw + (r & 1023))));
    }
  };
  const bool first = p == 0, last = p == a.plan1.n_pass - 1;
  if constexpr (R > kMaxFixedRadix) {
    // R stands for every radix above 31: the generic pass's, a.plan1's.
    const int r = a.plan1.radix[p];
    if (first && last) {
      generic_tile_pass<true>(len, count, ns, r, true, in, rts, global,
                              scratch);
    } else if (first) {
      generic_tile_pass<true>(len, count, ns, r, true, in, rts, global,
                              store);
    } else if (last) {
      generic_tile_pass<true>(len, count, ns, r, false, in, rts, shared,
                              scratch);
    } else {
      generic_tile_pass<true>(len, count, ns, r, false, in, rts, shared,
                              store);
    }
  } else if (first && last) {
    pass<R, true>(len, count, ns, rts, global, scratch);
  } else if (first) {
    pass<R, true>(len, count, ns, rts, global, store);
  } else if (last) {
    pass<R, true>(len, count, ns, rts, shared, scratch);
  } else {
    pass<R, true>(len, count, ns, rts, shared, store);
  }
}

// (a) Block (tile, transform): W = tile / N1 columns from col0 of
// transform tr = local pair * nc + j of the chunk. Consecutive blocks run
// a transform's tiles, then the pair's next transform, or (block_major)
// the same block j of the next pair.
template <int kMaxR>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kMaxR, kMinBlocks16>)
    column_pass(Args a) {
  extern __shared__ float4 smem_raw[];
  const int n = a.n, n1 = a.n1, n2 = a.n2;
  float2* buf0 = reinterpret_cast<float2*>(smem_raw);
  float2* buf1 = buf0 + padded(a.tile);
  float2* rts = buf1 + padded(a.tile);
  const int cols = min(a.tile / n1, n2);
  const int tiles = (n2 + cols - 1) / cols;
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
  float2* dst = a.scratch + static_cast<size_t>(tr) * n;
  load_roots(rts, a.tw, n1, n2);
  int ns = 1;
  for (int p = 0; p < a.plan1.n_pass; ++p) {
    const int r = a.plan1.radix[p];
    const Tile<true> in{p & 1 ? buf0 : buf1, n1, cols};
    const Tile<true> out{p & 1 ? buf1 : buf0, n1, cols};
    TILE_PASS_SWITCH(r, (column_step<R>(a, p, ns, in, out, rts, s, kc,
                                           k, tile * cols, dst)),
                     (column_step<kAnyRadix>(a, p, ns, in, out, rts, s, kc,
                                             k, tile * cols, dst)));
    __syncthreads();
    ns *= r;
  }
}

// Pass p < P - 1 of the row FFTs (length N2 over the tile's rows): the
// first reads the scratch rows from global memory.
template <int R>
__device__ __forceinline__ void row_step(
    const Args& a, int p, int ns, const Tile<false>& in,
    const Tile<false>& out, const float2* __restrict__ rts,
    const float2* __restrict__ src, int rows_left) {
  const int len = a.n2, count = in.count;
  const auto global = [&](int t, int i) {
    return t < rows_left ? src[t * len + i] : make_float2(0.0f, 0.0f);
  };
  const auto shared = [&](int t, int i) { return in.at(t, i); };
  const auto store = [&](int t, int i, float2 v) { out.at(t, i) = v; };
  if constexpr (R > kMaxFixedRadix) {
    // R stands for every radix above 31: the generic pass's, a.plan2's.
    const int r = a.plan2.radix[p];
    if (p == 0) {
      generic_tile_pass<false>(len, count, ns, r, true, in, rts, global,
                               store);
    } else {
      generic_tile_pass<false>(len, count, ns, r, false, in, rts, shared,
                               store);
    }
  } else if (p == 0) {
    pass<R, false>(len, count, ns, rts, global, store);
  } else {
    pass<R, false>(len, count, ns, rts, shared, store);
  }
}

// The last pass of the row FFTs (ns = m = N2 / R): output k2 = j + q m of
// butterfly (t, j), its magnitude added to acc[it R + q] for the thread's
// butterflies w = threadIdx.x + it kThreads (the same every transform).
template <int R, int kAcc>
__device__ __forceinline__ void row_last(
    const Args& a, const Tile<false>& in, const float2* __restrict__ rts,
    const float2* __restrict__ src, int rows_left, float (&acc)[kAcc]) {
  const int len = a.n2, count = in.count;
  const int m = len / R;
  const int items = m * count;
  const Div by(m);
  const auto global = [&](int t, int i) {
    return t < rows_left ? src[t * len + i] : make_float2(0.0f, 0.0f);
  };
  const auto shared = [&](int t, int i) { return in.at(t, i); };
#pragma unroll
  for (int it = 0; it < kItems<R>; ++it) {
    const int w = threadIdx.x + it * kThreads;
    if (w < items) {
      int t, j;
      item<false>(w, by, count, m, t, j);
      float2 v[R];
      if (a.plan2.n_pass == 1) {
        gather<R>(v, global, rts, t, j, j, m, m);
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

// The sums of row_last to sums[t N2 + k2] (shared memory).
template <int R, int kAcc>
__device__ __forceinline__ void row_sums(const Args& a, int count,
                                         const float (&acc)[kAcc],
                                         float* sums) {
  const int m = a.n2 / R;
  const int items = m * count;
  const Div by(m);
#pragma unroll
  for (int it = 0; it < kItems<R>; ++it) {
    const int w = threadIdx.x + it * kThreads;
    if (w < items) {
      int t, j;
      item<false>(w, by, count, m, t, j);
#pragma unroll
      for (int q = 0; q < R; ++q) sums[t * a.n2 + j + q * m] = acc[it * R + q];
    }
  }
}

// (b) Block (tile, pair): R = tile / N2 rows from row0 of the pair's nc
// transforms, in order; the map's R x N2 points stored k1 fastest.
template <int kMaxR>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kMaxR, kMinBlocks16>)
    row_pass(Args a) {
  extern __shared__ float4 smem_raw[];
  const int n = a.n, n1 = a.n1, n2 = a.n2;
  float2* buf0 = reinterpret_cast<float2*>(smem_raw);
  float2* buf1 = buf0 + padded(a.tile);
  float2* rts = buf1 + padded(a.tile);
  const int rows = min(a.tile / n2, n1);
  const int tiles = (n1 + rows - 1) / rows;
  const int local = blockIdx.x / tiles;
  const int tile = blockIdx.x - local * tiles;
  const int row0 = tile * rows;
  const int rows_left = n1 - row0;
  const int n_pass = a.plan2.n_pass;
  const int r_last = a.plan2.radix[n_pass - 1];
  load_roots(rts, a.tw, n2, n1);
  float acc[acc_points(kMaxR)];
#pragma unroll
  for (int i = 0; i < acc_points(kMaxR); ++i) acc[i] = 0.0f;
  for (int jb = 0; jb < a.nc; ++jb) {
    const float2* src = a.scratch +
        (static_cast<size_t>(local) * a.nc + jb) * n +
        static_cast<size_t>(row0) * n2;
    int ns = 1;
    for (int p = 0; p + 1 < n_pass; ++p) {
      const int r = a.plan2.radix[p];
      const Tile<false> in{p & 1 ? buf0 : buf1, n2, rows};
      const Tile<false> out{p & 1 ? buf1 : buf0, n2, rows};
      TILE_PASS_SWITCH(r, (row_step<R>(a, p, ns, in, out, rts, src,
                                          rows_left)),
                       (row_step<kAnyRadix>(a, p, ns, in, out, rts, src,
                                            rows_left)));
      __syncthreads();
      ns *= r;
    }
    const Tile<false> last{n_pass & 1 ? buf1 : buf0, n2, rows};
    TILE_PASS_SWITCH(r_last, (row_last<R>(a, last, rts, src, rows_left,
                                          acc)), {});
    __syncthreads();   // the next transform's first pass overwrites bufs
  }
  float* sums = reinterpret_cast<float*>(buf0);
  TILE_PASS_SWITCH(r_last, (row_sums<R>(a, rows, acc, sums)), {});
  __syncthreads();
  const int pair = a.pair0 + local;
  const int c = pair / a.n_bins;
  const int bin = a.order[pair - c * a.n_bins];
  float* dst = a.out + (static_cast<size_t>(c) * a.n_bins + bin) * n;
  const float scale = 1.0f / static_cast<float>(n);
  const Div by_rows(rows);
  for (int e = threadIdx.x; e < rows * n2; e += kThreads) {
    const int k2 = by_rows(e);
    const int t = e - k2 * rows;
    if (t < rows_left) dst[row0 + t + n1 * k2] = sums[t * n2 + k2] * scale;
  }
}

template <int kMaxR>
int launch_column(const Args& args, long long blocks, cudaStream_t stream) {
  const size_t smem = (2 * padded(args.tile) + args.n1) * sizeof(float2);
  const cudaError_t err = cudaFuncSetAttribute(
      column_pass<kMaxR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  column_pass<kMaxR><<<static_cast<unsigned>(blocks), kThreads, smem,
                       stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int kMaxR>
int launch_row(const Args& args, long long blocks, cudaStream_t stream) {
  const size_t smem = (2 * padded(args.tile) + args.n2) * sizeof(float2);
  const cudaError_t err = cudaFuncSetAttribute(
      row_pass<kMaxR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  row_pass<kMaxR><<<static_cast<unsigned>(blocks), kThreads, smem,
                    stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

int launch_pass(bool column, int variant, const Args& args,
                long long blocks, cudaStream_t stream) {
  if (blocks < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (column) {
    return variant == 10 ? launch_column<10>(args, blocks, stream)
         : variant == 13 ? launch_column<13>(args, blocks, stream)
         : variant == 16 ? launch_column<16>(args, blocks, stream)
         : variant == 31 ? launch_column<31>(args, blocks, stream)
                         : launch_column<kAnyRadix>(args, blocks, stream);
  }
  return variant == 10 ? launch_row<10>(args, blocks, stream)
       : variant == 13 ? launch_row<13>(args, blocks, stream)
       : variant == 16 ? launch_row<16>(args, blocks, stream)
       : variant == 31 ? launch_row<31>(args, blocks, stream)
                       : launch_row<kAnyRadix>(args, blocks, stream);
}

}  // namespace

extern "C" const char* sydr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// spec [n_ph, n_ch, nc, n], code [n_ch, n], tw [n] complex64; shift /
// phase / order [n_bins] int32 (order: a permutation of the bins, the
// order their pairs run in within a channel: by phase, so that the bins
// of one phase read its spectrum rows from L2 in turn); scratch
// [chunk_pairs, nc, n] complex64; out [n_ch, n_bins, n] f32; all on the
// device. n = n1 n2 with 2 <= n1 <= 1024,
// n1 <= n2 <= 4096; radices1 / radices2: host arrays of the sub-plans
// (n_pass1, n_pass2 radices of product n1, n2). The n_ch n_bins (channel,
// bin) pairs run in chunks of chunk_pairs, two launches each, all queued
// on `stream`.
extern "C" int pcps_bins_twostep_launch(
    const void* spec, const void* code, const void* tw, const void* shift,
    const void* phase, const void* order, int n_ch, int nc, int n, int n1,
    const int* radices1,
    int n_pass1, const int* radices2, int n_pass2, int n_bins, void* scratch,
    int chunk_pairs, void* out, void* stream) {
  if (n_ch < 1 || nc < 1 || n_bins < 1 || chunk_pairs < 1 || n1 < 2 ||
      n1 > kMaxN1 || n % n1 != 0 || n / n1 < n1 || n / n1 > kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args;
  int max1 = 0, max2 = 0;
  int bad = sub_plan(radices1, n_pass1, n1, false, &args.plan1, &max1);
  if (bad == 0) {
    bad = sub_plan(radices2, n_pass2, n / n1, true, &args.plan2, &max2);
  }
  if (bad != 0) return bad;
  args.spec = static_cast<const float2*>(spec);
  args.code = static_cast<const float2*>(code);
  args.tw = static_cast<const float2*>(tw);
  args.shift = static_cast<const int*>(shift);
  args.phase = static_cast<const int*>(phase);
  args.order = static_cast<const int*>(order);
  args.n_ch = n_ch;
  args.nc = nc;
  args.n = n;
  args.n1 = n1;
  args.n2 = n / n1;
  args.n_bins = n_bins;
  args.scratch = static_cast<float2*>(scratch);
  args.out = static_cast<float*>(out);
  args.tile = tile_points(n1, args.n2,
                          max1 == kAnyRadix || max2 == kAnyRadix ||
                              has_radix16(args.plan1) ||
                              has_radix16(args.plan2));
  args.block_major = 2LL * nc * n * sizeof(float2) > kL2Bytes / 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = args.tile / n1 < args.n2 ? args.tile / n1 : args.n2;
  const int rows = args.tile / args.n2 < n1 ? args.tile / args.n2 : n1;
  const long long col_tiles = (args.n2 + cols - 1) / cols;
  const long long row_tiles = (n1 + rows - 1) / rows;
  const int pairs = n_ch * n_bins;
  for (int p0 = 0; p0 < pairs; p0 += chunk_pairs) {
    const int count = pairs - p0 < chunk_pairs ? pairs - p0 : chunk_pairs;
    args.pair0 = p0;
    int err = launch_pass(true, max1, args,
                          col_tiles * count * static_cast<long long>(nc), st);
    if (err == 0) err = launch_pass(false, max2, args, row_tiles * count, st);
    if (err != 0) return err;
  }
  return 0;
}
