// K2 pcps_bins: non-coherent PCPS correlation magnitudes for every
// (Doppler bin, channel) of the shift-theorem acquisition plan.
//
// Replaces the Pallas kernel sydr_tpu/ops/acq_kernel.py (_kernel, launched by
// pcps_fused_bins). For bin b with plan entry (k_b, p_b) and channel c:
//
//   out[c, b, :] = sum_j | IDFT_n( S[p_b, c, j, :] * roll(K[c], k_b) ) |
//
// over the nc non-coherent blocks j, where S are the per-phase block
// spectra and K the conjugate code spectrum (roll(K, k)[i] = K[(i-k) mod n]).
// The TPU kernel formed the inverse DFT as two matrix products (a four-step
// transform on the MXU, the chip having no complex type and no FFT); on this
// card that form reads 16 bytes of shared memory per multiply-add and sits
// at the shared-memory ceiling (pcps_bins_fourstep.cu keeps it for lengths
// with a prime factor above 31).
//
// This entry is a mixed-radix Stockham (autosort) FFT in shared memory, in
// float32 on the CUDA cores, for n = r_0 r_1 ... r_{P-1} with radices from
// {10, 5, 4, 3, 2} and the odd primes 7 to 31 (the wrapper's radix_plan:
// 10 10 5 5 at n = 2500, 10 10 10 10 at n = 10000, and 31 4 3 11 at
// n = 4092 = 2^2 3 11 31, the code period of every front end clocked at a
// multiple of 1.023 MHz). With ns the product of the radices already done,
// pass p takes for j < n / r
//
//   v[q]  = in[j + q n/r] * tw[q (j mod ns) n/(ns r)]          q < r
//   out[(j div ns) ns r + (j mod ns) + q ns] = DFT_r(v)[q]
//
// so every pass reads at stride n / r and writes at stride ns, and the last
// pass (ns r = n) ends in natural order. Twiddles come from one table
// tw[t] = e^{+2 pi i t / n}, built in float64 by the wrapper, at the exact
// integer index above (always below n), never from an f32 product of
// angles; the butterflies' own roots are float64 literals.
//
// A prime radix r >= 7 is the direct r-point DFT of the r inputs a thread
// holds in registers, in its real-symmetric form: with s_q = v[q] + v[r-q]
// and d_q = v[q] - v[r-q] for q <= (r-1)/2, outputs k and r - k are
// A_k +- i B_k, A_k = v[0] + sum_q cos(2 pi k q / r) s_q, B_k = sum_q
// sin(2 pi k q / r) d_q: (r-1)^2 real multiply-adds for r complex points
// (29 a point at r = 31, 9 at r = 11) where the four-step entry spends
// 4 (n1 + n2) = 512 at n = 4092, every operand in a register or the
// constant bank. Its loops are fully unrolled, so a thread needs some 4 r
// registers; the kernel is compiled three times, by the block's largest
// size: 1024 threads (64 registers, radices up to 10 only, as before the
// prime radices existed), 512 and 256 threads (128 and 255 registers) for
// plans with a prime radix, chosen at the launch from the plan and the
// thread count.
//
// Bound on the H100: operations. Each input byte once is 97 MB at the
// session shape (32 ch x 101 bins x n = 2500; 0.03 ms of HBM time), while
// 32,320 transforms of ~5 n log2 n + 10 n flops are ~5 GFLOP (0.08 ms at
// the f32 rate). In practice a pass costs about as much in shared-memory
// and L1 traffic (points in and out, one twiddle a point) as in
// arithmetic, so the design cuts both:
//   * one block per (bin, channel) walks the nc blocks; the spectrum
//     product with the rolled code is fused into the first pass's load
//     (the spectrum row is shared by the ~10 bins of its phase through
//     L2), so no product ever reaches memory;
//   * radix 10 = 2 x 5 in registers (Cooley-Tukey inside the butterfly,
//     its inner roots compile-time constants): 4 passes at n = 2500 and at
//     n = 10000 where radices 4 and 5 take 5 and 6, each pass less saving
//     a barrier, 16 n bytes of shared-memory traffic and n twiddles;
//   * two ping-pong buffers of n complex are all the shared memory (16 n
//     bytes: 40 KB at n = 2500, 4 blocks of 256 threads an SM; 160 KB at
//     n = 10000, one block of 1024 threads an SM, one thread per
//     radix-10 butterfly of a pass);
//   * the last pass keeps its outputs in registers: a thread owns the same
//     n / threads output points for every block j, so magnitude and the
//     non-coherent sum never touch shared memory, the 1/n scale is one
//     multiply at the store, and the map is stored coalesced in natural
//     order;
//   * j mod ns by a multiply-high with a per-pass reciprocal instead of an
//     integer division.
// Tried on the card and not kept: 16-byte loads of the spectrum row (two
// butterflies a thread in the first pass: the registers they need spill
// under the 64 a thread has at 1024 threads), the twiddle table's first
// half in shared memory, radix 16. Tensor cores are not used: TF32 keeps
// ~10 mantissa bits and the map is held to 1e-4 of its maximum.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxPasses = 16;
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

// Pass 0 (ns = 1, no twiddles), fused with the spectrum product: reads
// global memory, writes out[j R + q].
template <int R>
__device__ __forceinline__ void first_pass(const float2* __restrict__ s,
                                           const float2* __restrict__ kc,
                                           int k, int n,
                                           float2* __restrict__ out) {
  const int m = n / R;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
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
    for (int r = 0; r < R; ++r) out[j * R + r] = v[r];
  }
}

// A pass between the first and the last: shared memory to shared memory.
template <int R>
__device__ __forceinline__ void middle_pass(const float2* __restrict__ in,
                                            float2* __restrict__ out,
                                            const float2* __restrict__ tw,
                                            int n, int ns) {
  const int m = n / R;
  const int tstride = m / ns;   // n / (ns R)
  // j / ns as a multiply-high: exact for j * ns < 2^32 (ns >= 2 here).
  const unsigned magic = 0xFFFFFFFFu / static_cast<unsigned>(ns) + 1u;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int hi = static_cast<int>(__umulhi(static_cast<unsigned>(j), magic));
    const int k = j - hi * ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = in[j + r * m];
    const int t1 = k * tstride;
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(tw + r * t1));
    butterfly<R>(v);
    float2* o = out + hi * ns * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) o[r * ns] = v[r];
  }
}

// The last pass (ns = n / R, so j mod ns = j and the output index is
// j + q n/R): magnitudes added to the thread's accumulators.
template <int R, int kAcc>
__device__ __forceinline__ void last_pass(const float2* __restrict__ in,
                                          const float2* __restrict__ tw,
                                          int n, float (&acc)[kAcc]) {
  constexpr int kIters = kAcc / R;
  const int m = n / R;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = threadIdx.x + it * blockDim.x;
    if (j < m) {
      float2 v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = in[j + r * m];
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
                                          float scale,
                                          float* __restrict__ dst) {
  constexpr int kIters = kAcc / R;
  const int m = n / R;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int j = threadIdx.x + it * blockDim.x;
    if (j < m) {
#pragma unroll
      for (int r = 0; r < R; ++r) dst[j + r * m] = acc[it * R + r] * scale;
    }
  }
}

// Run `call` with R the compile-time value of the runtime radix r: the
// five-way switch the kernel had before there were prime radices (a wider
// switch compiles to a slower dispatch and cost the n = 2500 and n = 10000
// shapes 4%), behind a chain of comparisons for the prime radices in the
// kernel variants that have them.
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
#define SYDR_RADIX_SWITCH(r, call)                            \
  if constexpr (kPrimes) {                                    \
    SYDR_PRIME_CASE(r, 31, call) SYDR_PRIME_CASE(r, 11, call)  \
    SYDR_PRIME_CASE(r, 7, call) SYDR_PRIME_CASE(r, 13, call)   \
    SYDR_PRIME_CASE(r, 17, call) SYDR_PRIME_CASE(r, 19, call)  \
    SYDR_PRIME_CASE(r, 23, call) SYDR_PRIME_CASE(r, 29, call)  \
    { SYDR_SMALL_SWITCH(r, call) }                            \
  } else {                                                    \
    SYDR_SMALL_SWITCH(r, call)                                \
  }

// kMaxT: the largest block (it sets the registers a thread may have);
// kAcc: the accumulators a thread holds; kPrimes: with the prime radices.
template <int kMaxT, int kAcc, bool kPrimes>
__global__ void __launch_bounds__(kMaxT) pcps_bins_kernel(
    const float2* __restrict__ spec, const float2* __restrict__ code,
    const float2* __restrict__ tw, const int* __restrict__ shift,
    const int* __restrict__ phase, int n_ch, int nc, int n, int n_bins,
    Plan plan, float* __restrict__ out) {
  extern __shared__ float4 smem_raw[];
  float2* buf0 = reinterpret_cast<float2*>(smem_raw);
  float2* buf1 = buf0 + n;

  const int bin = blockIdx.x;
  const int c = blockIdx.y;
  int k = shift[bin] % n;
  if (k < 0) k += n;
  const int p = phase[bin];
  const int r_first = plan.radix[0];
  const int r_last = plan.radix[plan.n_pass - 1];
  const float2* kc = code + static_cast<size_t>(c) * n;

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

  for (int j = 0; j < nc; ++j) {
    const float2* s =
        spec + ((static_cast<size_t>(p) * n_ch + c) * nc + j) * n;
    SYDR_RADIX_SWITCH(r_first, first_pass<R>(s, kc, k, n, buf0));
    __syncthreads();
    float2* in = buf0;
    float2* other = buf1;
    int ns = r_first;
    for (int ps = 1; ps + 1 < plan.n_pass; ++ps) {
      const int r = plan.radix[ps];
      SYDR_RADIX_SWITCH(r, middle_pass<R>(in, other, tw, n, ns));
      __syncthreads();
      float2* t = in;
      in = other;
      other = t;
      ns *= r;
    }
    SYDR_RADIX_SWITCH(r_last, (last_pass<R, kAcc>(in, tw, n, acc)));
    __syncthreads();   // the next block's passes overwrite both buffers
  }

  float* dst = out + (static_cast<size_t>(c) * n_bins + bin) * n;
  const float scale = 1.0f / static_cast<float>(n);
  SYDR_RADIX_SWITCH(r_last, (store_map<R, kAcc>(acc, n, scale, dst)));
}

// Launch one variant of the kernel; its shared memory is above the 48 KB
// a kernel gets unasked from n = 3073 on.
template <int kMaxT, int kAcc, bool kPrimes>
int launch_variant(const float2* spec, const float2* code, const float2* tw,
                   const int* shift, const int* phase, int n_ch, int nc,
                   int n, int n_bins, const Plan& plan, int threads,
                   float* out, cudaStream_t stream) {
  const int r_last = plan.radix[plan.n_pass - 1];
  if (threads > kMaxT || n / r_last > (kAcc / r_last) * threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(n) * 2 * sizeof(float2);
  const cudaError_t err = cudaFuncSetAttribute(
      pcps_bins_kernel<kMaxT, kAcc, kPrimes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pcps_bins_kernel<kMaxT, kAcc, kPrimes>
      <<<dim3(n_bins, n_ch), threads, smem, stream>>>(
          spec, code, tw, shift, phase, n_ch, nc, n, n_bins, plan, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* sydr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// spec [n_ph, n_ch, nc, n] complex64, code [n_ch, n]
// complex64, tw [n] complex64, shift / phase [n_bins] int32 (device), out
// [n_ch, n_bins, n]; radices: host array of n_pass >= 2 radices from
// {2, 3, 4, 5, 10} and the odd primes 7..31 whose product is n; threads: a
// multiple of 32, at most 1024 without a prime radix (n <= 20 threads) and
// 512 with one (n / r_last <= floor(32 / r_last) threads).
extern "C" int pcps_bins_launch(
    const void* spec, const void* code, const void* tw, const void* shift,
    const void* phase, int n_ch, int nc, int n, const int* radices,
    int n_pass, int threads, int n_bins, void* out, void* stream) {
  if (n_pass < 2 || n_pass > kMaxPasses || n < 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan plan;
  plan.n_pass = n_pass;
  long long product = 1;
  bool primes = false;
  for (int i = 0; i < kMaxPasses; ++i) {
    plan.radix[i] = i < n_pass ? radices[i] : 1;
    if (i < n_pass) {
      const int r = radices[i];
      const bool small = (r >= 2 && r <= 5) || r == 10;
      const bool prime = r == 7 || r == 11 || r == 13 || r == 17 ||
                         r == 19 || r == 23 || r == 29 || r == 31;
      if (!small && !prime) return static_cast<int>(cudaErrorInvalidValue);
      primes = primes || prime;
      product *= r;
    }
  }
  if (product != n) return static_cast<int>(cudaErrorInvalidValue);
  if (threads < 32 || threads % 32 != 0) {
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
    return launch_variant<1024, kAccSmall, false>(
        s, kc, t, sh, ph, n_ch, nc, n, n_bins, plan, threads, o, st);
  }
  if (threads <= 256) {
    return launch_variant<256, kAccPrime, true>(
        s, kc, t, sh, ph, n_ch, nc, n, n_bins, plan, threads, o, st);
  }
  return launch_variant<512, kAccPrime, true>(
      s, kc, t, sh, ph, n_ch, nc, n, n_bins, plan, threads, o, st);
}
