// K2 pcps_bins, cluster entry: the radix FFT of pcps_bins.cu for a code
// period n whose transform does not fit one block, run by a thread-block
// cluster of C = 2, 4 or 8 blocks that pool their shared memory.
//
// Replaces the Pallas kernel sydr_tpu/ops/acq_kernel.py (_kernel, launched by
// pcps_fused_bins), as pcps_bins.cu does: for bin b with plan entry
// (k_b, p_b) and channel c,
//
//   out[c, b, :] = sum_j | IDFT_n( S[p_b, c, j, :] * roll(K[c], k_b) ) |.
//
// One block of pcps_bins.cu holds two ping-pong buffers of n complex
// points (16 n bytes), so the H100's 227 KB a block end it at n = 14,528,
// and a plan with a prime radix (or a generic pass) ends at 512 threads x
// 16 points, n = 8192: 9722 = 2 x 4861 takes C = 2, 26,500 = 2^2 5^3 53
// C = 4, 65,498 = 2 x 32,749 C = 8.
// The front ends' code periods above that (16,368 at 16.368 Msps, 20,000,
// 25,000, 40,920 at 40.92 Msps, ...) run here. The wrapper
// (acq_kernel.cluster_size) takes the smallest C whose per-block share
// fits those limits: C = 2 at n = 12,276, 16,368, 20,000 and 25,000,
// C = 4 at 20,460 to 50,000, C = 8 at 40,920 and 65,536; every 31-smooth
// n up to 65,536 fits within C = 8 (the portable cluster size). The
// smallest C because fewer blocks mean fewer points crossing SMs and a
// cheaper barrier: at n = 16368, 8 ch x 101 bins x 10 blocks, C = 2 ran
// 2.97 ms, C = 4 4.02 and C = 8 4.07 (tools/torch_kernel_variants.py
// --k2 --n 16368, NVIDIA H100 80GB HBM3, 700.00 W), against 3.99 for
// torch.fft.ifft alone over the pre-made product; at n = 40920 (C = 8
// only) 12.34 ms against 11.76.
//
// Layout: each block holds a slice of both buffers, S = ceil(n / C)
// points each (16 S bytes): global point i lives in the block of rank
// i / S at offset i mod S. A pass's butterflies are cut into C contiguous
// chunks of ceil(m / C), one a block, and a block reads and writes its
// points wherever they live through distributed shared memory (mapa +
// ld/st.shared::cluster; i / S by a multiply-high). With contiguous chunks
// the first pass's stores (out[j R + q]) and the early passes' (ns small)
// stay in the block and only the loads cross SMs; the loads of every
// pass, in[j + q n/r], are spread over the whole cluster. A cluster
// barrier (barrier.cluster arrive + wait, release / acquire) takes the
// place of __syncthreads() between passes; one more comes first, so that
// no block stores into a block that has not started, and the one after
// the last pass keeps every block alive until no other reads its slices.
//
// Unchanged from pcps_bins.cu: the plan, the twiddle table and its integer
// indices, the butterflies (pcps_fft.cuh), the first pass with the fused
// spectrum product and rolled code, the last pass's outputs in registers
// (a thread owns the same points for every non-coherent block) and their
// coalesced store: each block stores its own chunk of the map; the
// generic pass of a radix above 31 (pcps_fft.cuh), its fold and sum items
// cut over the blocks, a cluster barrier between its two steps. So
// acq_kernel.stockham_ifft_ref describes this arithmetic too. The kernel
// variants are pcps_bins.cu's five (1024 threads without a prime radix;
// 256 and 512 with one; 256 and 512 with a radix above 31), chosen from
// the plan and the per-block thread count.
//
// A generic pass reads each of its points about R / 16 times (once for
// every kGenericPairs output pairs), and where those points live is the
// whole cluster: at C blocks (C - 1) / C of those reads cross SMs, where
// a fixed radix reads each point once. n = 4070 ran 1.8x / 2.4x / 4.5x
// its one-block time on 2 / 4 / 8 blocks, 8140 1.5x / 2.0x / 2.7x
// (NVIDIA H100 80GB HBM3, tools/torch_kernel_variants.py --k2 --n 4070
// 8140).
//
// Bound on the H100: operations, as pcps_bins.cu (the map's 5 n log2 n +
// 10 n flops a transform at the f32 rate); in practice every point of
// every pass crosses the SM-to-SM network about (C - 1) / C of the time,
// and a cluster's blocks wait for each other at every pass.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pcps_fft.cuh"

namespace {

// Arrive (release) and wait (acquire): every block's shared-memory
// stores before it are visible to every block's loads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n\t"
      "barrier.cluster.wait.aligned;" ::: "memory");
}

// One ping-pong buffer spread over the cluster: point i at rank i / S,
// offset i mod S, at the same shared-memory offset in every block.
struct Spread {
  uint32_t base;    // the buffer's shared-memory address in this block
  uint32_t s;       // S, points a block
  uint32_t magic;   // i / S as a multiply-high: exact for i * S < 2^32

  __device__ __forceinline__ uint32_t at(int i) const {
    const uint32_t u = static_cast<uint32_t>(i);
    const uint32_t rank = __umulhi(u, magic);
    uint32_t a;
    asm("mapa.shared::cluster.u32 %0, %1, %2;"
        : "=r"(a) : "r"(base + (u - rank * s) * 8u), "r"(rank));
    return a;
  }
  __device__ __forceinline__ float2 load(int i) const {
    float2 v;
    asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
                 : "=f"(v.x), "=f"(v.y) : "r"(at(i)));
    return v;
  }
  __device__ __forceinline__ void store(int i, float2 v) const {
    asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};"
                 :: "r"(at(i)), "f"(v.x), "f"(v.y) : "memory");
  }
  static __device__ __forceinline__ void sync() { cluster_sync(); }
};

// Pass 0 (ns = 1, no twiddles), fused with the spectrum product: reads
// global memory, writes out[j R + q].
template <int R>
__device__ __forceinline__ void first_pass(const float2* __restrict__ s,
                                           const float2* __restrict__ kc,
                                           int k, int n, const Spread& out,
                                           const Chunk& ch) {
  const int m = n / R;
  for (int j = ch.lo + threadIdx.x; j < ch.hi; j += blockDim.x) {
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = j + r * m;
      int src = i - k;
      if (src < 0) src += n;
      v[r] = cmul(__ldg(s + i), __ldg(kc + src));
    }
    butterfly<R>(v);
#pragma unroll
    for (int r = 0; r < R; ++r) out.store(j * R + r, v[r]);
  }
}

// A pass between the first and the last.
template <int R>
__device__ __forceinline__ void middle_pass(const Spread& in,
                                            const Spread& out,
                                            const float2* __restrict__ tw,
                                            int n, int ns, const Chunk& ch) {
  const int m = n / R;
  const int tstride = m / ns;   // n / (ns R)
  const unsigned magic = 0xFFFFFFFFu / static_cast<unsigned>(ns) + 1u;
  for (int j = ch.lo + threadIdx.x; j < ch.hi; j += blockDim.x) {
    const int hi = static_cast<int>(__umulhi(static_cast<unsigned>(j), magic));
    const int k = j - hi * ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = in.load(j + r * m);
    const int t1 = k * tstride;
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(tw + r * t1));
    butterfly<R>(v);
    const int o = hi * ns * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) out.store(o + r * ns, v[r]);
  }
}

// The last pass: magnitudes added to the thread's accumulators.
template <int R, int kAcc>
__device__ __forceinline__ void last_pass(const Spread& in,
                                          const float2* __restrict__ tw,
                                          int n, const Chunk& ch,
                                          float (&acc)[kAcc]) {
  constexpr int kIters = kAcc / R;
  const int m = n / R;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = ch.lo + threadIdx.x + it * blockDim.x;
    if (j < ch.hi) {
      float2 v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = in.load(j + r * m);
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(tw + r * j));
      butterfly<R>(v);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[it * R + r] += sqrtf(v[r].x * v[r].x + v[r].y * v[r].y);
      }
    }
  }
}

template <int R, int kAcc>
__device__ __forceinline__ void store_map(const float (&acc)[kAcc], int n,
                                          const Chunk& ch, float scale,
                                          float* __restrict__ dst) {
  constexpr int kIters = kAcc / R;
  const int m = n / R;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = ch.lo + threadIdx.x + it * blockDim.x;
    if (j < ch.hi) {
#pragma unroll
      for (int r = 0; r < R; ++r) dst[j + r * m] = acc[it * R + r] * scale;
    }
  }
}

// One cluster per (bin, channel): blockIdx.x = bin * C + rank.
template <int kMaxT, int kAcc, bool kPrimes, bool kGeneric>
__global__ void __launch_bounds__(kMaxT) pcps_bins_cluster_kernel(
    const float2* __restrict__ spec, const float2* __restrict__ code,
    const float2* __restrict__ tw, const int* __restrict__ shift,
    const int* __restrict__ phase, int n_ch, int nc, int n, int n_bins,
    Plan plan, int slice, float* __restrict__ out) {
  extern __shared__ float4 smem_raw[];
  int rank, ranks, bin;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(ranks));
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(bin));
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t s = static_cast<uint32_t>(slice);
  const uint32_t magic = 0xFFFFFFFFu / s + 1u;
  const Spread buf0{base, s, magic};
  const Spread buf1{base + s * 8u, s, magic};

  const int c = blockIdx.y;
  int k = shift[bin] % n;
  if (k < 0) k += n;
  const int p = phase[bin];
  const int r_first = plan.radix[0];
  const int r_last = plan.radix[plan.n_pass - 1];
  const float2* kc = code + static_cast<size_t>(c) * n;
  const Chunk first(n / r_first, rank, ranks);
  const Chunk last(n / r_last, rank, ranks);

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

  cluster_sync();   // every block of the cluster runs before any store
  for (int j = 0; j < nc; ++j) {
    const float2* s_row =
        spec + ((static_cast<size_t>(p) * n_ch + c) * nc + j) * n;
    SYDR_RADIX_SWITCH(r_first, first_pass<R>(s_row, kc, k, n, buf0, first));
    cluster_sync();
    Spread in = buf0;
    Spread other = buf1;
    int ns = r_first;
    for (int ps = 1; ps + 1 < plan.n_pass; ++ps) {
      const int r = plan.radix[ps];
      const Chunk mid(n / r, rank, ranks);
      SYDR_MIDDLE_SWITCH(r, middle_pass<R>(in, other, tw, n, ns, mid),
                         generic_pass(in, other, tw, n, ns, r, rank, ranks));
      cluster_sync();
      const Spread t = in;
      in = other;
      other = t;
      ns *= r;
    }
    SYDR_RADIX_SWITCH(r_last, (last_pass<R, kAcc>(in, tw, n, last, acc)));
    // The next block's passes overwrite both buffers; after the last, no
    // block may exit while another still reads its slices.
    cluster_sync();
  }

  float* dst = out + (static_cast<size_t>(c) * n_bins + bin) * n;
  const float scale = 1.0f / static_cast<float>(n);
  SYDR_RADIX_SWITCH(r_last,
                    (store_map<R, kAcc>(acc, n, last, scale, dst)));
}

// Launch one variant on a grid of (n_bins C, n_ch) in clusters of C, or,
// with max_clusters, ask how many such clusters the card runs at once
// (cudaOccupancyMaxActiveClusters) and launch nothing.
template <int kMaxT, int kAcc, bool kPrimes, bool kGeneric>
int launch_variant(const float2* spec, const float2* code, const float2* tw,
                   const int* shift, const int* phase, int n_ch, int nc,
                   int n, int n_bins, const Plan& plan, int threads,
                   int cluster, float* out, cudaStream_t stream,
                   int* max_clusters) {
  const int r_last = plan.radix[plan.n_pass - 1];
  const int slice = (n + cluster - 1) / cluster;
  const int last_chunk = (n / r_last + cluster - 1) / cluster;
  if (threads > kMaxT || last_chunk > (kAcc / r_last) * threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(slice) * 2 * sizeof(float2);
  auto* kernel = pcps_bins_cluster_kernel<kMaxT, kAcc, kPrimes, kGeneric>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_bins * cluster, n_ch);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) {
    return static_cast<int>(cudaOccupancyMaxActiveClusters(
        max_clusters, reinterpret_cast<const void*>(kernel), &cfg));
  }
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, kernel, spec, code, tw, shift, phase, n_ch, nc, n, n_bins, plan,
      slice, out);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* spec, const void* code, const void* tw,
             const void* shift, const void* phase, int n_ch, int nc, int n,
             const int* radices, int n_pass, int threads, int cluster,
             int n_bins, void* out, void* stream, int* max_clusters) {
  Plan plan;
  bool primes, generic;
  const int bad = parse_plan(radices, n_pass, n, &plan, &primes, &generic);
  if (bad != 0) return bad;
  if (threads < 32 || threads % 32 != 0 ||
      (cluster != 2 && cluster != 4 && cluster != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // A slice of at least 2 points, and i * S < 2^32 for Spread's division.
  const long long slice = (n + cluster - 1) / cluster;
  if (slice < 2 || slice * n >= (1LL << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float2* s = static_cast<const float2*>(spec);
  const float2* kc = static_cast<const float2*>(code);
  const float2* t = static_cast<const float2*>(tw);
  const int* sh = static_cast<const int*>(shift);
  const int* ph = static_cast<const int*>(phase);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!primes) {
    return launch_variant<1024, kAccSmall, false, false>(
        s, kc, t, sh, ph, n_ch, nc, n, n_bins, plan, threads, cluster, o, st,
        max_clusters);
  }
  if (generic) {
    if (threads <= 256) {
      return launch_variant<256, kAccPrime, true, true>(
          s, kc, t, sh, ph, n_ch, nc, n, n_bins, plan, threads, cluster, o,
          st, max_clusters);
    }
    return launch_variant<512, kAccPrime, true, true>(
        s, kc, t, sh, ph, n_ch, nc, n, n_bins, plan, threads, cluster, o, st,
        max_clusters);
  }
  if (threads <= 256) {
    return launch_variant<256, kAccPrime, true, false>(
        s, kc, t, sh, ph, n_ch, nc, n, n_bins, plan, threads, cluster, o, st,
        max_clusters);
  }
  return launch_variant<512, kAccPrime, true, false>(
      s, kc, t, sh, ph, n_ch, nc, n, n_bins, plan, threads, cluster, o, st,
      max_clusters);
}

}  // namespace

extern "C" const char* sydr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The arguments of pcps_bins.cu's pcps_bins_launch, plus cluster (2, 4 or
// 8 blocks a transform); threads is per block, and the last pass's
// ceil(n / r_last / cluster) butterflies must fit floor(kAcc / r_last)
// per thread.
extern "C" int pcps_bins_cluster_launch(
    const void* spec, const void* code, const void* tw, const void* shift,
    const void* phase, int n_ch, int nc, int n, const int* radices,
    int n_pass, int threads, int cluster, int n_bins, void* out,
    void* stream) {
  return dispatch(spec, code, tw, shift, phase, n_ch, nc, n, radices,
                  n_pass, threads, cluster, n_bins, out, stream, nullptr);
}

// cudaOccupancyMaxActiveClusters for the launch that the same n, plan,
// threads and cluster would make: written to *max_clusters; launches
// nothing.
extern "C" int pcps_bins_cluster_occupancy(int n, const int* radices,
                                           int n_pass, int threads,
                                           int cluster, int* max_clusters) {
  return dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, n,
                  radices, n_pass, threads, cluster, 1, nullptr, nullptr,
                  max_clusters);
}
