// The mixed-radix Stockham FFT's building blocks, shared by K2's two
// radix entries: pcps_bins.cu (one block a transform) and
// pcps_bins_cluster.cu (a cluster of 2, 4 or 8 blocks a transform, for a
// code period whose buffers outgrow one block's shared memory). Both run
// the same arithmetic: these butterflies (radices 2, 3, 4, 5, 10 = 2 x 5
// and the odd primes 7 to 31, inverse sign, roots as float64 literals
// rounded once), the generic pass of an odd radix above 31 (a runtime
// value: the prime factors of n above the largest butterfly), the same
// plan and the same integer twiddle indices, so
// acq_kernel.stockham_ifft_ref describes either. See pcps_bins.cu's header
// for the passes and their design.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxPasses = 16;
// The largest radix with a butterfly in registers; a plan's radices above
// it (odd, between its first and last pass) run generic_pass.
constexpr int kMaxFixedRadix = 31;
// Output points a thread holds in the last pass (its accumulators), by
// kernel variant: floor(kAcc / r) butterflies of the last radix r, so
// n / r <= floor(kAcc / r) * threads.
constexpr int kAccSmall = 21;   // radices up to 10: n <= 20 threads
constexpr int kAccPrime = 32;   // with prime radices up to 31

struct Plan {
  int radix[kMaxPasses];
  int n_pass;
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// i * a
__device__ __forceinline__ float2 mul_i(float2 a) {
  return make_float2(-a.y, a.x);
}

// v <- DFT_R(v) with the inverse sign: v[q] = sum_r v[r] e^{+2 pi i q r / R}.
template <int R>
__device__ __forceinline__ void butterfly(float2 (&v)[R]);

// Radix 1, the ends of a plan whose n has no factor up to 31 (1517 =
// 37 x 41): the first pass only forms the product, the last only its
// magnitude.
template <>
__device__ __forceinline__ void butterfly<1>(float2 (&)[1]) {}

template <>
__device__ __forceinline__ void butterfly<2>(float2 (&v)[2]) {
  const float2 a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}

template <>
__device__ __forceinline__ void butterfly<3>(float2 (&v)[3]) {
  constexpr float kSin = 0.8660254037844386;   // sin(2 pi / 3)
  const float2 t1 = cadd(v[1], v[2]);
  const float2 t2 = make_float2(v[0].x - 0.5f * t1.x, v[0].y - 0.5f * t1.y);
  const float2 d = csub(v[1], v[2]);
  const float2 t3 = mul_i(make_float2(kSin * d.x, kSin * d.y));
  v[0] = cadd(v[0], t1);
  v[1] = cadd(t2, t3);
  v[2] = csub(t2, t3);
}

template <>
__device__ __forceinline__ void butterfly<4>(float2 (&v)[4]) {
  const float2 s02 = cadd(v[0], v[2]);
  const float2 d02 = csub(v[0], v[2]);
  const float2 s13 = cadd(v[1], v[3]);
  const float2 d13 = mul_i(csub(v[1], v[3]));
  v[0] = cadd(s02, s13);
  v[1] = cadd(d02, d13);
  v[2] = csub(s02, s13);
  v[3] = csub(d02, d13);
}

template <>
__device__ __forceinline__ void butterfly<5>(float2 (&v)[5]) {
  constexpr float kC1 = 0.30901699437494745;    // cos(2 pi / 5)
  constexpr float kC2 = -0.8090169943749475;    // cos(4 pi / 5)
  constexpr float kS1 = 0.9510565162951535;     // sin(2 pi / 5)
  constexpr float kS2 = 0.5877852522924731;     // sin(4 pi / 5)
  const float2 t1 = cadd(v[1], v[4]);
  const float2 t2 = cadd(v[2], v[3]);
  const float2 t3 = csub(v[1], v[4]);
  const float2 t4 = csub(v[2], v[3]);
  const float2 m1 = make_float2(v[0].x + kC1 * t1.x + kC2 * t2.x,
                                v[0].y + kC1 * t1.y + kC2 * t2.y);
  const float2 m2 = make_float2(v[0].x + kC2 * t1.x + kC1 * t2.x,
                                v[0].y + kC2 * t1.y + kC1 * t2.y);
  const float2 n1 = mul_i(make_float2(kS1 * t3.x + kS2 * t4.x,
                                      kS1 * t3.y + kS2 * t4.y));
  const float2 n2 = mul_i(make_float2(kS2 * t3.x - kS1 * t4.x,
                                      kS2 * t3.y - kS1 * t4.y));
  v[0] = cadd(v[0], cadd(t1, t2));
  v[1] = cadd(m1, n1);
  v[2] = cadd(m2, n2);
  v[3] = csub(m2, n2);
  v[4] = csub(m1, n1);
}

// Roots of unity e^{+2 pi i e / 10}, e < 5, of the radix-10 butterfly.
__constant__ float2 kRoots10[5] = {
    {1.0f, 0.0f},
    {0.8090169943749475f, 0.5877852522924731f},
    {0.30901699437494745f, 0.9510565162951535f},
    {-0.30901699437494734f, 0.9510565162951536f},
    {-0.8090169943749473f, 0.5877852522924732f}};

// DFT of length 10 = A B in registers (Cooley-Tukey, A = 2, B = 5): B
// butterflies of length A over the points B n1 + n2, the roots w^{n2 k1},
// then A butterflies of length B; output k1 + A k2. Every index is a
// compile-time constant.
template <>
__device__ __forceinline__ void butterfly<10>(float2 (&v)[10]) {
  constexpr int A = 2, B = 5;
  float2 y[B][A];
#pragma unroll
  for (int n2 = 0; n2 < B; ++n2) {
    float2 t[A];
#pragma unroll
    for (int n1 = 0; n1 < A; ++n1) t[n1] = v[B * n1 + n2];
    butterfly<A>(t);
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) {
      y[n2][k1] = n2 * k1 == 0 ? t[k1] : cmul(t[k1], kRoots10[n2 * k1]);
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

// Roots of unity e^{+2 pi i e / r}, e < r, of the prime butterflies
// (float64 values rounded once).
__constant__ float2 kRoots7[7] = {
    {1.0f, 0.0f},
    {0.6234898018587336f, 0.7818314824680298f},
    {-0.22252093395631434f, 0.9749279121818236f},
    {-0.900968867902419f, 0.43388373911755823f},
    {-0.9009688679024191f, -0.433883739117558f},
    {-0.2225209339563146f, -0.9749279121818236f},
    {0.6234898018587334f, -0.7818314824680299f}};
__constant__ float2 kRoots11[11] = {
    {1.0f, 0.0f},
    {0.8412535328311812f, 0.5406408174555976f},
    {0.41541501300188644f, 0.9096319953545183f},
    {-0.142314838273285f, 0.9898214418809328f},
    {-0.654860733945285f, 0.7557495743542583f},
    {-0.9594929736144974f, 0.28173255684142967f},
    {-0.9594929736144975f, -0.2817325568414294f},
    {-0.6548607339452852f, -0.7557495743542582f},
    {-0.14231483827328523f, -0.9898214418809327f},
    {0.41541501300188605f, -0.9096319953545186f},
    {0.8412535328311812f, -0.5406408174555974f}};
__constant__ float2 kRoots13[13] = {
    {1.0f, 0.0f},
    {0.8854560256532099f, 0.4647231720437685f},
    {0.5680647467311559f, 0.8229838658936564f},
    {0.120536680255323f, 0.992708874098054f},
    {-0.35460488704253545f, 0.9350162426854148f},
    {-0.7485107481711012f, 0.6631226582407952f},
    {-0.970941817426052f, 0.23931566428755768f},
    {-0.9709418174260521f, -0.23931566428755743f},
    {-0.7485107481711013f, -0.663122658240795f},
    {-0.3546048870425359f, -0.9350162426854147f},
    {0.1205366802553232f, -0.992708874098054f},
    {0.5680647467311548f, -0.822983865893657f},
    {0.88545602565321f, -0.4647231720437684f}};
__constant__ float2 kRoots17[17] = {
    {1.0f, 0.0f},
    {0.9324722294043558f, 0.3612416661871529f},
    {0.7390089172206591f, 0.6736956436465572f},
    {0.4457383557765383f, 0.8951632913550623f},
    {0.09226835946330202f, 0.9957341762950345f},
    {-0.2736629900720829f, 0.961825643172819f},
    {-0.6026346363792563f, 0.7980172272802396f},
    {-0.850217135729614f, 0.5264321628773561f},
    {-0.9829730996839018f, 0.18374951781657037f},
    {-0.9829730996839018f, -0.18374951781657012f},
    {-0.8502171357296141f, -0.5264321628773558f},
    {-0.6026346363792572f, -0.7980172272802389f},
    {-0.2736629900720831f, -0.961825643172819f},
    {0.09226835946330243f, -0.9957341762950345f},
    {0.4457383557765377f, -0.8951632913550626f},
    {0.7390089172206585f, -0.6736956436465578f},
    {0.9324722294043558f, -0.36124166618715303f}};
__constant__ float2 kRoots19[19] = {
    {1.0f, 0.0f},
    {0.9458172417006346f, 0.32469946920468346f},
    {0.7891405093963936f, 0.6142127126896678f},
    {0.5469481581224269f, 0.8371664782625285f},
    {0.24548548714079924f, 0.9694002659393304f},
    {-0.08257934547233227f, 0.9965844930066698f},
    {-0.4016954246529694f, 0.9157733266550574f},
    {-0.6772815716257409f, 0.7357239106731318f},
    {-0.879473751206489f, 0.4759473930370737f},
    {-0.9863613034027223f, 0.16459459028073403f},
    {-0.9863613034027224f, -0.16459459028073378f},
    {-0.8794737512064893f, -0.4759473930370731f},
    {-0.6772815716257411f, -0.7357239106731316f},
    {-0.40169542465296904f, -0.9157733266550576f},
    {-0.08257934547233274f, -0.9965844930066698f},
    {0.2454854871407988f, -0.9694002659393305f},
    {0.5469481581224266f, -0.8371664782625288f},
    {0.7891405093963939f, -0.6142127126896674f},
    {0.9458172417006346f, -0.32469946920468373f}};
__constant__ float2 kRoots23[23] = {
    {1.0f, 0.0f},
    {0.9629172873477992f, 0.2697967711570243f},
    {0.8544194045464886f, 0.5195839500354336f},
    {0.6825531432186541f, 0.730835964278124f},
    {0.4600650377311522f, 0.8878852184023752f},
    {0.20345601305263375f, 0.9790840876823229f},
    {-0.06824241336467088f, 0.9976687691905392f},
    {-0.33487961217098616f, 0.9422609221188205f},
    {-0.5766803221148671f, 0.8169698930104421f},
    {-0.7757112907044197f, 0.631087944326053f},
    {-0.917211301505453f, 0.3984010898462414f},
    {-0.9906859460363306f, 0.1361666490962471f},
    {-0.9906859460363308f, -0.1361666490962464f},
    {-0.9172113015054529f, -0.39840108984624156f},
    {-0.7757112907044198f, -0.6310879443260528f},
    {-0.5766803221148672f, -0.816969893010442f},
    {-0.3348796121709864f, -0.9422609221188204f},
    {-0.06824241336467046f, -0.9976687691905393f},
    {0.2034560130526333f, -0.979084087682323f},
    {0.4600650377311516f, -0.8878852184023756f},
    {0.6825531432186542f, -0.730835964278124f},
    {0.8544194045464886f, -0.5195839500354336f},
    {0.962917287347799f, -0.2697967711570252f}};
__constant__ float2 kRoots29[29] = {
    {1.0f, 0.0f},
    {0.9766205557100867f, 0.21497044021102407f},
    {0.907575419670957f, 0.4198891015602646f},
    {0.7960930657056438f, 0.6051742151937652f},
    {0.6473862847818277f, 0.7621620551276365f},
    {0.46840844069979015f, 0.8835120444460229f},
    {0.26752833852922075f, 0.963549992519223f},
    {0.05413890858541761f, 0.9985334138511238f},
    {-0.16178199655276473f, 0.9868265225415261f},
    {-0.37013815533991423f, 0.9289767198167915f},
    {-0.5611870653623823f, 0.8276889981568906f},
    {-0.7259954919231306f, 0.6876994588534235f},
    {-0.8568571761675893f, 0.5155538571770216f},
    {-0.9476531711828025f, 0.3193015301359798f},
    {-0.9941379571543596f, 0.10811901842394192f},
    {-0.9941379571543597f, -0.10811901842394124f},
    {-0.9476531711828025f, -0.31930153013597995f},
    {-0.8568571761675892f, -0.5155538571770218f},
    {-0.7259954919231311f, -0.6876994588534231f},
    {-0.5611870653623825f, -0.8276889981568905f},
    {-0.37013815533991445f, -0.9289767198167914f},
    {-0.16178199655276476f, -0.9868265225415261f},
    {0.0541389085854167f, -0.9985334138511239f},
    {0.2675283385292201f, -0.9635499925192231f},
    {0.4684084406997903f, -0.8835120444460228f},
    {0.6473862847818279f, -0.7621620551276362f},
    {0.796093065705644f, -0.6051742151937649f},
    {0.9075754196709569f, -0.41988910156026493f},
    {0.9766205557100867f, -0.21497044021102438f}};
__constant__ float2 kRoots31[31] = {
    {1.0f, 0.0f},
    {0.9795299412524945f, 0.20129852008866006f},
    {0.9189578116202306f, 0.39435585511331855f},
    {0.8207634412072763f, 0.5712682150947923f},
    {0.6889669190756866f, 0.7247927872291199f},
    {0.5289640103269624f, 0.8486442574947509f},
    {0.3473052528448203f, 0.9377521321470804f},
    {0.1514277775045767f, 0.9884683243281114f},
    {-0.05064916883871264f, 0.9987165071710528f},
    {-0.2506525322587204f, 0.9680771188662043f},
    {-0.4403941515576344f, 0.8978045395707416f},
    {-0.6121059825476626f, 0.7907757369376989f},
    {-0.7587581226927909f, 0.6513724827222223f},
    {-0.8743466161445821f, 0.48530196253108104f},
    {-0.9541392564000488f, 0.29936312297335804f},
    {-0.994869323391895f, 0.10116832198743272f},
    {-0.9948693233918952f, -0.10116832198743204f},
    {-0.9541392564000488f, -0.2993631229733582f},
    {-0.8743466161445822f, -0.4853019625310808f},
    {-0.7587581226927911f, -0.651372482722222f},
    {-0.6121059825476627f, -0.7907757369376986f},
    {-0.44039415155763423f, -0.8978045395707417f},
    {-0.2506525322587213f, -0.9680771188662041f},
    {-0.05064916883871355f, -0.9987165071710528f},
    {0.15142777750457667f, -0.9884683243281114f},
    {0.3473052528448203f, -0.9377521321470804f},
    {0.5289640103269624f, -0.848644257494751f},
    {0.6889669190756865f, -0.72479278722912f},
    {0.8207634412072763f, -0.5712682150947924f},
    {0.9189578116202306f, -0.3943558551133187f},
    {0.9795299412524943f, -0.20129852008866114f}};

// DFT of odd prime length R in its real-symmetric form (header): every
// root index is a compile-time constant once the loops are unrolled.
template <int R>
__device__ __forceinline__ void prime_butterfly(float2 (&v)[R],
                                                const float2* roots) {
  constexpr int H = (R - 1) / 2;
  float2 s[H], d[H];
  const float2 v0 = v[0];
  float2 sum = v0;
#pragma unroll
  for (int q = 0; q < H; ++q) {
    s[q] = cadd(v[q + 1], v[R - 1 - q]);
    d[q] = csub(v[q + 1], v[R - 1 - q]);
    sum = cadd(sum, s[q]);
  }
  v[0] = sum;
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float2 a = v0;
    float2 b = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int q = 1; q <= H; ++q) {
      const float2 w = roots[(k * q) % R];
      a.x += w.x * s[q - 1].x;
      a.y += w.x * s[q - 1].y;
      b.x += w.y * d[q - 1].x;
      b.y += w.y * d[q - 1].y;
    }
    v[k] = make_float2(a.x - b.y, a.y + b.x);       // A + i B
    v[R - k] = make_float2(a.x + b.y, a.y - b.x);   // A - i B
  }
}

#define SYDR_PRIME_BUTTERFLY(R_)                                         \
  template <>                                                            \
  __device__ __forceinline__ void butterfly<R_>(float2 (&v)[R_]) {       \
    prime_butterfly<R_>(v, kRoots##R_);                                  \
  }
SYDR_PRIME_BUTTERFLY(7)
SYDR_PRIME_BUTTERFLY(11)
SYDR_PRIME_BUTTERFLY(13)
SYDR_PRIME_BUTTERFLY(17)
SYDR_PRIME_BUTTERFLY(19)
SYDR_PRIME_BUTTERFLY(23)
SYDR_PRIME_BUTTERFLY(29)
SYDR_PRIME_BUTTERFLY(31)
#undef SYDR_PRIME_BUTTERFLY

// This block's share [lo, hi) of a pass's `count` work items: `ranks`
// contiguous chunks, one a block of the cluster (rank 0 of 1: all).
struct Chunk {
  int lo, hi;
  __device__ __forceinline__ Chunk(int count, int rank, int ranks) {
    const int size = (count + ranks - 1) / ranks;
    lo = rank * size;
    hi = min(count, lo + size);
  }
};

// Output pairs (q, R - q) of a generic pass that one work item makes:
// each point it reads serves all of them. At 8 ch x 101 bins x 10 blocks
// four ran 7-23% faster than two at every length measured (n = 1517 to
// 65231), and eight 4-32% faster than four but at n = 4070 (3% slower:
// 19 output pairs a butterfly fill 24 slots); NVIDIA H100 80GB HBM3,
// 700.00 W, tools/torch_kernel_variants.py --parent.
constexpr int kGenericPairs = 8;

// A pass of odd radix R > kMaxFixedRadix, a runtime value, between the
// first and the last pass. Its R inputs a butterfly do not fit a thread's
// registers, so it runs in two steps over the buffers, in the
// real-symmetric form of prime_butterfly (H = (R - 1) / 2, m = n / R):
//   fold: for butterfly j (k = j mod ns) and 1 <= r <= H, the twiddled
//         x_r = in[j + r m] tw[r k tstride] and x_{R-r} likewise, and in
//         their places s_r = x_r + x_{R-r}, d_r = x_r - x_{R-r};
//   sum:  outputs q and R - q of butterfly j, 0 <= q <= H, are A + i B
//         and A - i B with A = in[j] + sum_r cos(2 pi q r / R) s_r and
//         B = sum_r sin(2 pi q r / R) d_r, the root e^{+2 pi i q r / R}
//         read as tw[(q r mod R) m]: the index grows by q m < n a term
//         and wraps at n (q = 0 reads tw[0] = 1 throughout: A is
//         in[j] + sum_r s_r exactly, B is 0, and output R is not
//         stored). A work item is butterfly j and kGenericPairs
//         consecutive q.
// Every index is an exact integer below n (r k tstride < R m = n). An
// output point costs prime_butterfly's 2 H real multiply-adds, but about
// H / kGenericPairs point reads and H / 2 root reads, where a butterfly
// in registers reads one point. Items are cut over the blocks (Chunk)
// and strided over the threads with j fastest, so a warp reads
// consecutive points and, where m >= 32, the same roots. Buf is the
// buffers' accessor: load(i), store(i, v) and sync(), the barrier after
// which every store is seen by every thread that reads the buffer.
template <class Buf>
__device__ __forceinline__ void generic_pass(const Buf& in, const Buf& out,
                                             const float2* __restrict__ tw,
                                             int n, int ns, int R, int rank,
                                             int ranks) {
  constexpr int P = kGenericPairs;
  const int m = n / R;
  const int h = (R - 1) / 2;
  const int tstride = m / ns;
  const Chunk fold(m * h, rank, ranks);
  for (int t = fold.lo + threadIdx.x; t < fold.hi; t += blockDim.x) {
    const int r = t / m + 1;
    const int j = t - (r - 1) * m;
    const int e = (j % ns) * tstride;
    const int ia = j + r * m;
    const int ib = j + (R - r) * m;
    const float2 x = cmul(in.load(ia), __ldg(tw + r * e));
    const float2 y = cmul(in.load(ib), __ldg(tw + (R - r) * e));
    in.store(ia, cadd(x, y));
    in.store(ib, csub(x, y));
  }
  Buf::sync();
  const int groups = (h + P) / P;   // ceil((H + 1) / P)
  const Chunk sum(m * groups, rank, ranks);
  for (int t = sum.lo + threadIdx.x; t < sum.hi; t += blockDim.x) {
    const int q0 = t / m * P;
    const int j = t - q0 / P * m;
    const int k = j % ns;
    const int o = (j - k) * R + k;
    const float2 x0 = in.load(j);
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
      const float2 sr = in.load(j + r * m);
      const float2 dr = in.load(j + (R - r) * m);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        idx[p] += (q0 + p) * m;   // (q0 + p) m <= (H + P - 1) m < n
        if (idx[p] >= n) idx[p] -= n;
        const float2 w = __ldg(tw + idx[p]);
        a[p].x += w.x * sr.x;
        a[p].y += w.x * sr.y;
        b[p].x += w.y * dr.x;
        b[p].y += w.y * dr.y;
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int q = q0 + p;
      if (q > h) break;
      out.store(o + q * ns, make_float2(a[p].x - b[p].y, a[p].y + b[p].x));
      if (q > 0) {
        out.store(o + (R - q) * ns,
                  make_float2(a[p].x + b[p].y, a[p].y - b[p].x));
      }
    }
  }
}

// Fill plan from a host array of n_pass radices whose product is n: each
// from {2, 3, 4, 5, 10} or the odd primes 7..31, an odd radix above 31
// anywhere but first or last (generic_pass), radix 1 first or last only,
// and first only before a radix above 31 or as one of two passes (a
// templated middle pass needs ns >= 2). *primes says whether any radix is
// outside {2, 3, 4, 5, 10} (the kernel variants with the prime radices),
// *generic whether one is above 31 or 1 (the variants that also have the
// generic pass and radix 1). Returns cudaSuccess or cudaErrorInvalidValue.
inline int parse_plan(const int* radices, int n_pass, int n, Plan* plan,
                      bool* primes, bool* generic) {
  if (n_pass < 2 || n_pass > kMaxPasses || n < 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  plan->n_pass = n_pass;
  long long product = 1;
  *primes = false;
  *generic = false;
  for (int i = 0; i < kMaxPasses; ++i) {
    plan->radix[i] = i < n_pass ? radices[i] : 1;
    if (i < n_pass) {
      const int r = radices[i];
      const bool end = i == 0 || i == n_pass - 1;
      const bool small = (r >= 2 && r <= 5) || r == 10;
      const bool prime = r == 7 || r == 11 || r == 13 || r == 17 ||
                         r == 19 || r == 23 || r == 29 || r == 31;
      const bool wide = r > kMaxFixedRadix && r % 2 == 1 && !end;
      const bool one = r == 1 && end &&
                       (i > 0 || n_pass == 2 || radices[1] > kMaxFixedRadix);
      if (!small && !prime && !wide && !one) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      *primes = *primes || !small;
      *generic = *generic || wide || one;
      product *= r;
    }
  }
  return static_cast<int>(product == n ? cudaSuccess
                                       : cudaErrorInvalidValue);
}

}  // namespace

// Run `call` with R the compile-time value of the runtime radix r: the
// five-way switch the kernel had before there were prime radices (a wider
// switch compiles to a slower dispatch and cost the n = 2500 and n = 10000
// shapes 4%), behind a chain of comparisons for the prime radices in the
// kernel variants that have them (kPrimes). The variants for plans with a
// radix above 31 (kGeneric) add radix 1 (first or last pass only) after
// the primes, and SYDR_MIDDLE_SWITCH runs `generic` for a radix above 31
// (a middle pass only; a radix that reached the small switch's default
// would run as radix 10). Both are kept out of the other variants: in
// the prime variant of 256 threads they cost n = 4092 4.7% (NVIDIA H100
// 80GB HBM3).
#define SYDR_SMALL_SWITCH(r, call)                   \
  switch (r) {                                       \
    case 2: { constexpr int R = 2; call; } break;     \
    case 3: { constexpr int R = 3; call; } break;     \
    case 4: { constexpr int R = 4; call; } break;     \
    case 5: { constexpr int R = 5; call; } break;     \
    default: { constexpr int R = 10; call; } break;   \
  }
#define SYDR_PRIME_CASE(r, r_, call) \
  if (r == r_) { constexpr int R = r_; call; } else
#define SYDR_PRIME_CHAIN(r, call)                           \
  SYDR_PRIME_CASE(r, 31, call) SYDR_PRIME_CASE(r, 11, call)  \
  SYDR_PRIME_CASE(r, 7, call) SYDR_PRIME_CASE(r, 13, call)   \
  SYDR_PRIME_CASE(r, 17, call) SYDR_PRIME_CASE(r, 19, call)  \
  SYDR_PRIME_CASE(r, 23, call) SYDR_PRIME_CASE(r, 29, call)
#define SYDR_RADIX_SWITCH(r, call)                            \
  if constexpr (kGeneric) {                                   \
    SYDR_PRIME_CHAIN(r, call) SYDR_PRIME_CASE(r, 1, call)     \
    { SYDR_SMALL_SWITCH(r, call) }                            \
  } else if constexpr (kPrimes) {                             \
    SYDR_PRIME_CHAIN(r, call)                                 \
    { SYDR_SMALL_SWITCH(r, call) }                            \
  } else {                                                    \
    SYDR_SMALL_SWITCH(r, call)                                \
  }
#define SYDR_MIDDLE_SWITCH(r, call, generic)                  \
  if constexpr (kGeneric) {                                   \
    SYDR_PRIME_CHAIN(r, call)                                 \
    if (r > kMaxFixedRadix) { generic; }                      \
    else { SYDR_SMALL_SWITCH(r, call) }                       \
  } else {                                                    \
    SYDR_RADIX_SWITCH(r, call)                                \
  }
