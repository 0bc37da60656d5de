"""K2 ``pcps_bins``: the per-bin PCPS chain (spectrum product -> inverse
DFT -> magnitude -> non-coherent sum) for every (Doppler bin, channel).

Replaces ``sydr_tpu.ops.acq_kernel.pcps_fused_bins`` (Pallas ``_kernel``).
On CUDA tensors :func:`pcps_bins` launches one of four hand-written
entries, chosen from the code period ``n`` alone (:func:`kernel_for`):

* ``csrc/pcps_bins.cu`` (:data:`KERNEL`), a mixed-radix Stockham FFT in
  one block's shared memory (radices 10, 5, 4, 3, 2, the odd primes 7 to
  31, and a generic pass for each prime factor above 31;
  :func:`radix_plan`), where the transform fits one block
  (:func:`cluster_size` 1): 2500, 5000, 10000, 2048, the code periods of
  the front ends clocked at a multiple of 1.023 MHz, 2046, 4092 =
  2^2 * 3 * 11 * 31, 8184, and 4070 = 2 * 5 * 11 * 37;
* ``csrc/pcps_bins_cluster.cu`` (:data:`CLUSTER_KERNEL`), the same FFT
  on a thread-block cluster of 2, 4 or 8 blocks that pool their shared
  memory, for the other 31-smooth ``n`` up to 65,536 (16368 at 16.368
  Msps, 20000, 25000, 40920, 65536), 38 5-smooth ``n`` above it (80000,
  100000) and the ``n`` with a generic pass on a cluster of 2 (8193 to
  16384 points);
* ``csrc/pcps_bins_twostep.cu`` (:data:`TWOSTEP_KERNEL`), the FFT of
  length n in two passes through global memory, n = N1 * N2
  (:func:`twostep_split`), its sub-FFTs the radix entries' butterflies,
  radix 8 and 16 and a generic pass over tiles in shared memory
  (:func:`sub_plan`), for every other ``n``
  up to 2^20 whose prime factors are at most 31 (66000, 70000 at 70
  Msps, 122880, 245520 at 245.52 Msps, 2^20), the ``n`` with a generic
  pass that a cluster of 4 or 8 would run (26500 = 2^2 * 5^3 * 53), and
  the ``n`` above 65,536 whose largest prime factor is at most
  :data:`TWOSTEP_MAX_PRIME` (99375 = 3 * 5^4 * 53 at 99.375 Msps);
* ``csrc/pcps_bins_bluestein.cu`` (:data:`BLUESTEIN_KERNEL`), Bluestein's
  chirp convolution at a 13-smooth length M just above 2n - 1
  (:func:`bluestein_lengths`) on the two-step entry's tile FFTs through
  global memory, for every other ``n`` up to 2^20 that is not prime
  (65538 = 2 * 3^2 * 11 * 331, 131074 = 2 * 65537, 9722 = 2 * 4861,
  65498 = 2 * 32749).

A prime ``n``, or one above 2^20, raises ``ValueError`` from
:func:`kernel_for` before anything is launched.
:func:`pcps_bins_ref` is the plain PyTorch version (``torch.fft.ifft`` of
the product, ``abs``, sum), used on CPU tensors; there is no fallback from
a kernel to it or from one kernel to another.
:func:`stockham_ifft_ref` walks the radix entries' passes, strides and
integer twiddle indices in PyTorch (and the tile FFT's sub-plans,
:func:`sub_plan`), :func:`twostep_ifft_ref` and
:func:`bluestein_ifft_ref` the other entries' steps, for the tests of that
arithmetic.
"""

from __future__ import annotations

import bisect
import ctypes
import functools
import math

import numpy as np
import torch

from sydr_tpu_torch.ops import native

_VP = ctypes.c_void_p
_INT = ctypes.c_int
KERNEL = native.CudaKernel(
    "pcps_bins.cu", "pcps_bins_launch",
    [_VP] * 5 + [_INT] * 3 + [ctypes.POINTER(_INT)] + [_INT] * 3 + [_VP, _VP])
CLUSTER_KERNEL = native.CudaKernel(
    "pcps_bins_cluster.cu", "pcps_bins_cluster_launch",
    [_VP] * 5 + [_INT] * 3 + [ctypes.POINTER(_INT)] + [_INT] * 4 + [_VP, _VP])
TWOSTEP_KERNEL = native.CudaKernel(
    "pcps_bins_twostep.cu", "pcps_bins_twostep_launch",
    [_VP] * 6 + [_INT] * 4 + [ctypes.POINTER(_INT), _INT] * 2
    + [_INT, _VP, _INT, _VP, _VP])
BLUESTEIN_KERNEL = native.CudaKernel(
    "pcps_bins_bluestein.cu", "pcps_bins_bluestein_launch",
    [_VP] * 8 + [_INT] * 5 + [ctypes.POINTER(_INT), _INT] * 2
    + [_INT, _VP, _INT, _VP, _VP])

# Bins per batch of the plain version: bounds its [bins, ch, nc, n]
# complex64 intermediates (8 x 32 x 10 x 2500 x 8 B = 51 MB each at the
# session shape).
REF_BIN_CHUNK = 8


def balanced_factors(n: int) -> tuple[int, int]:
    """Factor n = n1 * n2 with n1 <= n2 as close to sqrt(n) as possible;
    raises ``ValueError`` for a prime n above 64, in the words of the JAX
    package's ``_balanced_factors`` (the refusal that both packages
    share: :func:`kernel_for` applies it)."""
    f = math.isqrt(n)
    while f >= 1:
        if n % f == 0:
            best = (f, n // f)
            break
        f -= 1
    if best[0] == 1 and n > 64:
        raise ValueError(f"N={n} has no useful factorisation (prime?)")
    return best


PRIME_RADICES = (31, 29, 23, 19, 17, 13, 11, 7)
# Radices of the kernel variant without prime radices (1024 threads).
SMALL_RADICES = (2, 3, 4, 5, 10)
# The radices of the tile FFT (csrc/pcps_tile.cuh), whose butterflies add
# radix 8 and radix 16 to the radix entries' (their small switch, widened,
# cost those entries 4%: pcps_fft.cuh).
TILE_RADICES = SMALL_RADICES + (8, 16) + PRIME_RADICES
# The H100's shared memory a block (227 KB) and the points a block of each
# FFT variant holds in the last pass: 1024 threads x 20 points without a
# prime radix (kAccSmall), 512 x 16 with one (kAccPrime: the registers of a
# wide butterfly cap the block at 512 threads).
BLOCK_SMEM_BYTES = 232_448
SMALL_BLOCK_POINTS = 1024 * 20
PRIME_BLOCK_POINTS = 512 * 16
# Blocks a transform: 1 is csrc/pcps_bins.cu, the others a cluster of
# csrc/pcps_bins_cluster.cu (8 is the portable maximum).
CLUSTER_SIZES = (1, 2, 4, 8)
# The global-memory entries take n up to 2^20; the Bluestein entry's
# convolution length M (below 2^22) splits as the two-step entry's n
# does.
BLUESTEIN_MAX_N = 1 << 20
# The tile FFT of the global-memory entries (csrc/pcps_tile.cuh): columns
# of N1 (or M1) <= 1024 points (at least 4 of its 4096-point tile) and
# rows of N2 (or M2) <= 4096 (at least one).
TWOSTEP_MAX_N1 = 1 << 10
TWOSTEP_MAX_N2 = 1 << 12
# A 31-smooth n's split with fewer passes than JAX's balanced one
# (twostep_split) takes a radix-8 or radix-16 pass, keeps its rows to the
# smaller tile's 2048 points and fills at least 9/10 of its tiles
# (tile_fill).
TWOSTEP_FEWER_MAX_N2 = 1 << 11
TWOSTEP_MIN_FILL = 0.9
# The prime factors of the Bluestein entry's convolution length M
# (bluestein_lengths): radices of the tile FFT's variants with 4 blocks an
# SM (none above 13); and its window: M from 2n - 1 up to 1/50 (2%) above.
BLUESTEIN_PRIMES = (2, 3, 5, 7, 11, 13)
BLUESTEIN_WINDOW = 50
# The scratch of the global-memory entries (a transform's M or n complex64,
# nc transforms a (bin, channel) pair) holds as many pairs as fit in 512
# MB, and always one (:func:`scratch_chunk_pairs`).
SCRATCH_BYTES = 512 << 20
# Routing of an n with a prime factor above 31 (kernel_for): the radix
# entries keep a plan with a generic pass whose largest prime factor is at
# most GENERIC_MAX_PRIME on one block or a cluster smaller than
# TWOSTEP_MIN_CLUSTER; the two-step entry takes the larger clusters' n and
# the n above RADIX_MAX_N (the largest cluster's 65,536 points) whose
# largest prime factor is at most TWOSTEP_MAX_PRIME; the Bluestein entry
# the rest.
GENERIC_MAX_PRIME = 233
TWOSTEP_MIN_CLUSTER = 4
RADIX_MAX_N = 1 << 16
TWOSTEP_MAX_PRIME = 257


# The primes up to 1024 (the square root of 2^20): the trial divisors of
# prime_factors before the odd numbers above them.
_SMALL_PRIMES = tuple(p for p in range(2, 1025)
                      if all(p % q for q in range(2, math.isqrt(p) + 1)))


def prime_factors(n: int) -> list[int]:
    """The prime factors of ``n``, with multiplicity, ascending."""
    out = []
    for p in _SMALL_PRIMES:
        if p * p > n:
            break
        while n % p == 0:
            out.append(p)
            n //= p
    else:
        p = _SMALL_PRIMES[-1] + 2
        while p * p <= n:
            while n % p == 0:
                out.append(p)
                n //= p
            p += 2
    return out + [n] if n > 1 else out


def radix_plan(n: int) -> tuple[int, ...]:
    """Radices of the FFT kernels' passes, in order, whose product is
    ``n``: factors from {10, 4, 2, 3, 5}, the odd primes 7 to 31, and each
    prime factor above 31 (with multiplicity), which runs as a generic
    pass. Every pair (2, 5) becomes one radix-10 pass (a 2 x 5 butterfly
    in registers: a pass less to synchronise and to move through shared
    memory).

    Order of the radices up to 31: the largest prime radix first (the
    first pass has no twiddles), then tens, fours, a two, threes and
    fives, and the other prime radices last, largest first: of the 24
    orders of (31, 11, 4, 3) at n = 4092 the card ran (31, 4, 3, 11)
    fastest, 10% ahead of both primes first and 20% ahead of radix 31 last
    (``tools/torch_kernel_variants.py``); without a prime radix the order
    is the one that measured fastest before there were any.

    The radices above 31, largest first, come right before the last pass:
    never first (the first pass reads the spectrum product from global
    memory, which a generic pass would read R times) and never last (the
    last pass keeps floor(32 / R) butterflies a thread in registers, none
    for R > 32). Of the orders that keep them in the middle, the card ran
    (10, 10, 53, 5) fastest at n = 26500 and (10, 10, 53, 10) at 53000,
    3-7% ahead of 53 second, and the two orders of 4070, 1517, 9722 and
    16370 within about 1%; at 8140 = 2^2 x 5 x 11 x 37 (11, 37, 2, 10) led
    the rule's (11, 10, 37, 2) by 2.6% (``tools/torch_kernel_variants.py``,
    NVIDIA H100 80GB HBM3, 700.00 W). An ``n`` whose radices up to 31
    make one pass ends in a radix-1 pass (only the magnitude: 2 x 4861 is
    (2, 4861, 1)); one with none begins in one too (only the product:
    37 x 41 is (1, 41, 37, 1)).

    Raises ``ValueError`` for an ``n`` with fewer than two prime factors
    or fewer than two passes (10, 4): whether a block or a cluster takes
    the plan is :func:`cluster_size`'s question."""
    factors = prime_factors(n)
    if len(factors) < 2:
        raise ValueError(f"n={n}: the FFT kernel needs two passes or more")
    count = {p: factors.count(p) for p in (2, 3, 5) + PRIME_RADICES}
    generic = sorted((p for p in factors if p > PRIME_RADICES[0]),
                     reverse=True)
    primes = [p for p in PRIME_RADICES for _ in range(count[p])]
    tens = min(count[2], count[5])
    twos = count[2] - tens
    plan = (primes[:1] + [10] * tens + [4] * (twos // 2) + [2] * (twos % 2)
            + [3] * count[3] + [5] * (count[5] - tens) + primes[1:])
    if generic:
        head, tail = ((plan[:-1], plan[-1:]) if len(plan) > 1
                      else (plan or [1], [1]))
        plan = head + generic + tail
    if len(plan) < 2:
        raise ValueError(f"n={n}: the FFT kernel needs two passes or more")
    return tuple(plan)


def has_prime_radix(plan: tuple[int, ...]) -> bool:
    """Whether ``plan`` takes the kernels' variants with the prime
    radices: any radix outside :data:`SMALL_RADICES` (7 to 31, a generic
    radix above 31, radix 1), as the C entry points decide."""
    return any(r not in SMALL_RADICES for r in plan)


def fft_threads(n: int, plan: tuple[int, ...] | None = None,
                cluster: int = 1) -> int:
    """Threads of an FFT-kernel block for ``plan`` (default
    ``radix_plan(n)``) when ``cluster`` blocks share the transform, in
    whole warps. A block holds ``s = ceil(n / cluster)`` points.

    Without a prime radix: one per radix-10 butterfly of its share
    (s / 10), between 128 and 1024. A block's two buffers take 16 s bytes
    of the SM's shared memory, so small n runs several blocks an SM (4 of
    256 threads at n = 2500) and large n one full block (1024 threads at
    n = 10000); a thread holds at most 20 output points.

    With a prime radix: s / 16, between 128 and 512 (256 at n = 4092). A
    wide butterfly lives in registers (the kernel variant for blocks of up
    to 256 threads takes 224 a thread and spills nothing; the one for up
    to 512 has 128 and spills), and a wide pass has few butterflies (132
    of radix 31 at n = 4092), so more threads would idle in it; 256 ran
    fastest at n = 4092, 128 at n = 2046 and 384-512 at n = 8184
    (``tools/torch_kernel_variants.py``).

    With a generic radix above 31: 512 from 2048 points a block, else
    128. The generic pass has about s / 16 work items of H = (R - 1) / 2
    steps each, and the variants' registers leave one block an SM at 192
    to 512 threads (two at 128): at 8 ch x 101 bins x 10 blocks 512 ran
    fastest at n = 4070 (0.67 ms against 0.74 at s / 16's 256), 26500,
    9722 and 16370, within 8% at 53000 and 65231 (256 and 384 ahead),
    and 128 fastest at n = 1517 (0.50 ms against 0.71 at 512), on an
    NVIDIA H100 80GB HBM3, 700.00 W.
    """
    plan = radix_plan(n) if plan is None else plan
    s = -(-n // cluster)
    if max(plan) > PRIME_RADICES[0]:
        return 512 if s >= 2048 else 128
    if has_prime_radix(plan):
        return min(512, max(128, 32 * -(-s // 512)))
    return min(1024, max(128, 32 * -(-s // 320)))


def block_fits(n: int, plan: tuple[int, ...], cluster: int,
               threads: int) -> bool:
    """Whether a block of ``threads`` that shares one transform of
    ``plan`` with ``cluster - 1`` others fits the card and its kernel
    variant: two buffers of ``ceil(n / cluster)`` points in
    :data:`BLOCK_SMEM_BYTES`, those points within the variant's block
    (:data:`SMALL_BLOCK_POINTS`, :data:`PRIME_BLOCK_POINTS`), at most
    1024 threads (512 with a prime radix), and its share of the last
    pass's butterflies within the threads' accumulators (the launchers'
    own test; a radix-1 last pass holds 32 points a thread). The generic
    passes need no more: they run in the same two buffers."""
    prime = has_prime_radix(plan)
    points, acc, max_threads = ((PRIME_BLOCK_POINTS, 32, 512) if prime
                                else (SMALL_BLOCK_POINTS, 21, 1024))
    share = -(-n // cluster)
    return (16 * share <= BLOCK_SMEM_BYTES and share <= points
            and threads <= max_threads
            and -(-(n // plan[-1]) // cluster) <= (acc // plan[-1]) * threads)


def fitting_cluster(n: int, plan: tuple[int, ...]) -> int | None:
    """The smallest of :data:`CLUSTER_SIZES` whose block of
    ``fft_threads`` fits (:func:`block_fits`), or None."""
    for c in CLUSTER_SIZES:
        if block_fits(n, plan, c, fft_threads(n, plan, c)):
            return c
    return None


def cluster_size(n: int, plan: tuple[int, ...] | None = None) -> int:
    """Blocks that share one transform of ``plan`` (default
    ``radix_plan(n)``): :func:`fitting_cluster`. C = 1 is the one-block
    kernel, unchanged; C = 2 at n = 9722, 12276, 16368, 20000 and 25000,
    C = 4 at 20460 to 50000 (26500 among them), C = 8 at 40920, 65498 and
    65536. Raises ``ValueError`` where C = 8 does not fit."""
    plan = radix_plan(n) if plan is None else plan
    cluster = fitting_cluster(n, plan)
    if cluster is not None:
        return cluster
    share = -(-n // CLUSTER_SIZES[-1])
    points = PRIME_BLOCK_POINTS if has_prime_radix(plan) \
        else SMALL_BLOCK_POINTS
    raise ValueError(
        f"n={n}: no K2 kernel on the card: a transform of {n} points needs "
        f"a cluster of more than {CLUSTER_SIZES[-1]} blocks ({16 * share} "
        f"bytes of buffers a block, at most {BLOCK_SMEM_BYTES}; {share} "
        f"points, at most {points})")


def tile_radix_plan(n: int) -> tuple[int, ...]:
    """Radices of a tile FFT of 31-smooth length ``n``, with the power of
    two left after the tens taken as 16s and then one 8, 4 or 2
    (``csrc/pcps_tile.cuh``'s radix-8 and radix-16 butterflies): the
    fewest passes over the tile's radices, since every 3, 5 and prime
    factor takes a pass of its own and a ten takes a 2 with its 5. The
    16s come first, then :func:`radix_plan`'s order (the largest prime
    radix, tens, the 8, 4 or 2, threes, fives and the other primes): a
    magnitude-summing last pass holds its accumulators beside the
    butterfly's points, and a radix-16 last pass or a radix 16 after a
    prime ran 2-7% slower (``tools/torch_kernel_variants.py --layouts``).
    1024 is (16, 16, 4) where radix 4 alone took five passes, 176 (16,
    11); 280 keeps (7, 10, 4)."""
    factors = prime_factors(n)
    count = {p: factors.count(p) for p in (2, 3, 5) + PRIME_RADICES}
    primes = [p for p in PRIME_RADICES for _ in range(count[p])]
    tens = min(count[2], count[5])
    twos = count[2] - tens
    rest = [2 ** (twos % 4)] if twos % 4 else []
    return tuple([16] * (twos // 4) + primes[:1] + [10] * tens + rest
                 + [3] * count[3] + [5] * (count[5] - tens) + primes[1:])


def sub_plan(n: int, row: bool = False) -> tuple[int, ...]:
    """Radices of a tile FFT of length ``n`` (``csrc/pcps_tile.cuh``: the
    sub-FFTs of the two-step and Bluestein entries): ``(n,)`` for a length
    that is one of the tile's radices (4, 10, 2, 3, 5, 8, 16, 7 to 31),
    else :func:`tile_radix_plan` for a 31-smooth length; for a length with
    prime factors above 31, those first (largest first, each a generic
    pass), then the sub-plan of the rest, and, where nothing is left in a
    ``row`` plan (whose last pass sums magnitudes in registers), a radix-1
    last pass (only the magnitude): 265 = 5 x 53 is (53, 5), a row of
    1517 = 37 x 41 (41, 37, 1)."""
    factors = prime_factors(n)
    generic = tuple(sorted((p for p in factors if p > PRIME_RADICES[0]),
                           reverse=True))
    if not generic:
        return (n,) if n in TILE_RADICES else tile_radix_plan(n)
    rest = n // math.prod(generic)
    return generic + (sub_plan(rest) if rest > 1 else (1,) if row else ())


def has_radix_plan(n: int) -> bool:
    """Whether ``n`` has a radix plan (:func:`radix_plan`): every ``n``
    with two prime factors or more but 4 and 10, whose radices make one
    pass."""
    try:
        radix_plan(n)
    except ValueError:
        return False
    return True


@functools.lru_cache(maxsize=8)
def twiddle_table(n: int, device) -> torch.Tensor:
    """``tw[t] = e^{+2 pi i t / n}`` complex64, from float64 angles; built
    once per ``(n, device)``."""
    t = torch.arange(n, dtype=torch.float64, device=device) \
        * (2.0 * math.pi / n)
    return torch.polar(torch.ones_like(t), t).to(torch.complex64)


def smooth_numbers(primes, limit: int) -> tuple[int, ...]:
    """Every number up to ``limit`` whose prime factors are in ``primes``,
    ascending."""
    out = [1]
    for p in primes:
        more = []
        for v in out:
            while v <= limit:
                more.append(v)
                v *= p
        out = more
    return tuple(sorted(out))


_BLUESTEIN_M = smooth_numbers(BLUESTEIN_PRIMES,
                              TWOSTEP_MAX_N1 * TWOSTEP_MAX_N2)
# The column lengths a split of such an M can take.
_COLUMN_LENGTHS = tuple(v for v in _BLUESTEIN_M if 2 <= v <= TWOSTEP_MAX_N1)


@functools.lru_cache(maxsize=None)
def _passes(length: int, row: bool = False) -> int:
    return len(sub_plan(length, row))


@functools.lru_cache(maxsize=None)
def tile_split(m: int) -> tuple[int, int]:
    """``(M1, M2)``, ``M = M1 * M2``, of a 13-smooth M for the tile FFT:
    columns M1 <= :data:`TWOSTEP_MAX_N1`, rows M2 <= :data:`TWOSTEP_MAX_N2`
    (both at least 2), the fewest passes of the two sub-plans
    (:func:`sub_plan`), then the most balanced (the least larger factor),
    then the shorter columns: at 8 ch x 101 bins x 10 blocks 2^17 = 256 x
    512 ran 34.41 ms where 512 x 256 ran 41.71 (n = 65498), 132496 = 208
    x 637 36.84 where 637 x 208 ran 50.66 (65538) and 2^15 = 128 x 256
    7.00 where 256 x 128 ran 7.15 (16370): a column pass reads W = tile /
    M1 columns of the product side by side, so long columns read short
    runs of global memory (NVIDIA H100 80GB HBM3, 700.00 W;
    ``tools/torch_kernel_variants.py --k2 --bluestein --layouts``; before
    the tile had radix 16 the longer columns led at 19500, 150 x 130 4.31
    ms against 130 x 150 4.57). Raises ``ValueError`` where none is (a
    prime M)."""
    best = None
    for m1 in _COLUMN_LENGTHS:
        if m % m1 == 0 and 2 <= m // m1 <= TWOSTEP_MAX_N2:
            key = (_passes(m1) + _passes(m // m1), max(m1, m // m1), m1)
            best = key if best is None or key < best else best
    if best is None:
        raise ValueError(f"M={m}: no split M1 x M2 with 2 <= M1 <= "
                         f"{TWOSTEP_MAX_N1} and 2 <= M2 <= {TWOSTEP_MAX_N2}")
    return best[2], m // best[2]


@functools.lru_cache(maxsize=1)
def _bluestein_keys() -> tuple[tuple[float, int], ...]:
    """``(passes, M)`` for each M of ``_BLUESTEIN_M``: the passes of its
    split (:func:`tile_split`), infinite where it has none."""
    keys = []
    for m in _BLUESTEIN_M:
        try:
            keys.append((sum(map(_passes, tile_split(m))), m))
        except ValueError:
            keys.append((math.inf, m))
    return tuple(keys)


def bluestein_lengths(n: int) -> tuple[int, int, int]:
    """``(M, M1, M2)`` of the Bluestein entry: of the 13-smooth M
    (:data:`BLUESTEIN_PRIMES`) from 2n - 1 up to 2% above it
    (:data:`BLUESTEIN_WINDOW`) that split (:func:`tile_split`), the one
    with the fewest passes, then the least; where none does (35 n below
    236), the least 13-smooth M >= 2n - 1 that splits. With the tile's
    radix-8 and radix-16 passes (:func:`tile_radix_plan`): 19712 = 176 x
    112 at n = 9722 (4 passes, where 19500 = 150 x 130 took 5), 2^15 =
    256 x 128 at 16370 (4, where 32955 = 195 x 169 took 5), 2^17 = 512 x
    256 at 65498 and 132496 = 637 x 208 at 65538 (5, where 133100 = 121 x
    1100 took 5), 199927 = 169 x 1183 at 99375, 265837 = 169 x 1573 at
    131074, 2^21 = 1024 x 2048 at 2^20 - 2 (6, where 2,100,000 = 1000 x
    2100 took 7). M stays below 2^22, the tile's largest split.

    The rule that ran fastest at 8 ch x 101 bins x 10 blocks (before the
    tile had radix 16): over n =
    9722, 16370, 65498, 65538, 99375 and 131074 its time over the fastest
    of nine rules has a geometric mean of 1.0020 (worst 1.012), the least
    7-smooth M split balanced 1.176 (worst 1.427): 4.31 / 8.04 / 40.55 /
    40.31 / 60.25 / 79.03 ms against that one's 5.02 / 8.31 / 40.06 /
    53.04 / 70.21 / 112.80 (M = 262440 = 2^3 3^8 5 at 131074 takes eleven
    passes, 265837 = 13^3 11^2 five); at 1 ch x 11 bins x 2 blocks, 1.103
    (worst 1.238), where the 7-smooth M within 2% with the fewest passes
    reads 1.060 (``tools/torch_kernel_variants.py --k2 --bluestein``,
    NVIDIA H100 80GB HBM3, 700.00 W)."""
    need = 2 * n - 1
    keys = _bluestein_keys()
    lo = bisect.bisect_left(_BLUESTEIN_M, need)
    hi = bisect.bisect_right(_BLUESTEIN_M, need + need // BLUESTEIN_WINDOW)
    passes, m = min(keys[lo:hi], default=(math.inf, 0))
    if passes == math.inf:
        m = next(m for passes, m in keys[lo:] if passes < math.inf)
    return (m, *tile_split(m))


def chirp_index(j, n: int):
    """``t = j^2 mod 2n`` for the int tensor ``j``, in int64 (exact: j^2 <
    2^41 for j below 2^20), the index of the chirp ``c_j = e^{+i pi j^2 /
    n}`` in :func:`chirp_table`; the kernel takes j^2 in 64 bits too."""
    j = j.to(torch.int64)
    return (j * j) % (2 * n)


@functools.lru_cache(maxsize=8)
def chirp_table(n: int, device) -> torch.Tensor:
    """``[2n]`` complex64 ``e^{+i pi t / n}``, from float64 angles; built
    once per ``(n, device)``."""
    t = torch.arange(2 * n, dtype=torch.float64, device=device) \
        * (math.pi / n)
    return torch.polar(torch.ones_like(t), t).to(torch.complex64)


@functools.lru_cache(maxsize=8)
def bluestein_filter(n: int, m1: int, m2: int, device) -> torch.Tensor:
    """``[M1, M2]`` complex64: the transform of the Bluestein filter
    ``b_j = conj(c_j)`` for ``|j| < n`` (``b_{M-j} = b_j``; zero between),
    ``B[k] = FFT_M(b)[k] / (M n)`` at ``M = M1 * M2`` (the convolution's
    1/M and ``torch.fft.ifft``'s 1/n folded in), stored at ``[k1, k2]``
    for ``k = k1 + M1 k2``: the order the entry's row pass reads. A
    constant of ``n`` and the split, built once per ``(n, M1, M2,
    device)`` in float64 on the host."""
    m = m1 * m2
    j = np.arange(n, dtype=np.int64)
    c = np.exp(1j * np.pi * ((j * j) % (2 * n)) / n)
    b = np.zeros(m, dtype=np.complex128)
    b[:n] = np.conj(c)
    b[m - n + 1:] = np.conj(c[1:])[::-1]
    big = np.fft.fft(b) / (m * n)
    return torch.from_numpy(np.ascontiguousarray(big.reshape(m2, m1).T)) \
        .to(torch.complex64).to(device)


@functools.lru_cache(maxsize=8)
def _plan_tensors(bin_shifts, device):
    shift = torch.tensor([k for k, _ in bin_shifts], dtype=torch.int32,
                         device=device)
    phase = torch.tensor([p for _, p in bin_shifts], dtype=torch.int32,
                         device=device)
    return shift, phase


@functools.lru_cache(maxsize=8)
def _bin_order(bin_shifts, device):
    """The bins sorted by phase (stable): the order in which the
    global-memory entries run a channel's (bin, channel) pairs, so that
    the bins of one phase read its spectrum rows in turn (from L2)."""
    phase = torch.tensor([p for _, p in bin_shifts], dtype=torch.int64)
    return torch.argsort(phase, stable=True).to(torch.int32).to(device)


# Roots a chunk of a generic radix's pass in stockham_ifft_ref holds (its
# [q, r, m] index tensor): the [r, r] root matrix of r = 32749 would be
# 8.6 GB.
REF_ROOT_CHUNK = 1 << 22


def stockham_ifft_ref(x, plan, tw):
    """Unnormalised inverse DFT of ``x [..., n]`` complex64 by the FFT
    kernels' own passes (``csrc/pcps_bins.cu`` and, on a cluster,
    ``csrc/pcps_bins_cluster.cu``), in PyTorch.

    With ``ns`` the product of the radices done so far, the pass of radix
    ``r`` reads ``v[q] = in[j + q * n/r]`` for ``j < n/r``, multiplies by
    ``tw[q * (j mod ns) * n/(ns*r)]`` (an exact integer index below n),
    takes the r-point inverse DFT and writes it to
    ``out[(j // ns) * ns*r + (j mod ns) + q * ns]``. A radix above 31 (the
    kernels' generic pass) takes its DFT in chunks of outputs q, each
    with the pass's fused index: output q of butterfly j is ``sum_p
    in[j + p * n/r] * tw[p * ((j mod ns) * n/(ns*r) + q * n/r) mod n]``,
    the twiddle and the root in one exact table index (the kernels
    twiddle first and pair p with r - p: the same sum, grouped otherwise).
    """
    n = x.shape[-1]
    if math.prod(plan) != n:
        raise ValueError(f"plan {plan} does not multiply to n={n}")
    ns = 1
    for r in plan:
        m = n // r
        j = torch.arange(m, device=x.device)
        k = j % ns
        q = torch.arange(r, device=x.device)
        v = x[..., (j[None, :] + q[:, None] * m)]             # [..., r, m]
        if r > PRIME_RADICES[0]:
            y = _generic_dft_ref(v, k * (m // ns), n, tw)
        else:
            idx = q[:, None] * (k * (m // ns))[None, :]       # [r, m] < n
            v = v * tw[idx]
            root = tw[(q[:, None] * q[None, :] * (n // r)) % n]   # [r, r]
            y = torch.einsum("pq,...qm->...pm", root, v)
        dest = ((j - k) * r + k)[None, :] + q[:, None] * ns   # [r, m]
        out = torch.empty_like(x)
        out[..., dest.reshape(-1)] = y.reshape(*y.shape[:-2], -1)
        x = out
        ns *= r
    return x


def _generic_dft_ref(v, twiddle, n, tw):
    """Outputs ``[..., r, m]`` of a generic pass of radix r over its inputs
    ``v [..., r, m]`` (``twiddle[j] = (j mod ns) * n/(ns*r)``), by the fused
    index, in chunks of outputs q."""
    r, m = v.shape[-2:]
    p = torch.arange(r, device=v.device)
    chunk = max(1, REF_ROOT_CHUNK // (r * m))
    ys = []
    for q0 in range(0, r, chunk):
        q = torch.arange(q0, min(r, q0 + chunk), device=v.device)
        base = twiddle[None, :] + q[:, None] * m              # [c, m] < n
        idx = (p[None, :, None] * base[:, None, :]) % n      # [c, r, m]
        ys.append(torch.einsum("...pm,cpm->...cm", v, tw[idx]))
    return torch.cat(ys, dim=-2)


def pcps_bins_ref(spectra, code_k, bin_shifts):
    """Plain PyTorch version of :func:`pcps_bins` (same arguments)."""
    n_ph, n_ch, nc, n = spectra.shape
    bin_shifts = tuple(map(tuple, bin_shifts))
    shift, phase = _plan_tensors(bin_shifts, spectra.device)
    idx = torch.remainder(
        torch.arange(n, device=spectra.device)[None, :]
        - shift.to(torch.int64)[:, None], n)              # [n_bins, n]
    maps = []
    for b0 in range(0, len(bin_shifts), REF_BIN_CHUNK):
        sl = slice(b0, b0 + REF_BIN_CHUNK)
        rolled = code_k[:, idx[sl]].permute(1, 0, 2)      # [nb, n_ch, n]
        prod = spectra[phase[sl].to(torch.int64)] * rolled[:, :, None, :]
        corr = torch.fft.ifft(prod, dim=-1)
        maps.append(corr.abs().sum(dim=2))                # [nb, n_ch, n]
    return torch.cat(maps).permute(1, 0, 2).contiguous()


def twostep_ifft_ref(x, n: int):
    """``torch.fft.ifft(x)`` of ``x [..., n]`` complex64 by the two-step
    entry's own steps (``csrc/pcps_bins_twostep.cu``), in PyTorch: the
    split n = N1 * N2 (:func:`twostep_split`; input j = N2 j1 + j2), the
    column transforms of length N1 over j1, the twiddle at its exact
    integer index ``k1 * j2`` below n, the row transforms of length N2
    (``torch.fft`` of length N1 and N2 stand for the kernel's tile FFTs,
    whose sub-plans :func:`stockham_ifft_ref` walks), and the output order
    ``k = k1 + N1 k2``."""
    if x.shape[-1] != n:
        raise ValueError(f"x has {x.shape[-1]} points, expected n={n}")
    n1, n2 = twostep_split(n)[:2]
    dev = x.device
    idx = torch.arange(n1, device=dev)[:, None] \
        * torch.arange(n2, device=dev)[None, :]              # [N1, N2] < n
    a = x.reshape(*x.shape[:-1], n1, n2)                     # [j1, j2]
    a = torch.fft.ifft(a, dim=-2, norm="forward") * twiddle_table(n, dev)[idx]
    a = torch.fft.ifft(a, dim=-1, norm="forward")            # [k1, k2]
    return a.transpose(-1, -2).reshape(*x.shape[:-1], n) / n


def bluestein_ifft_ref(x, n: int):
    """``torch.fft.ifft(x)`` of ``x [..., n]`` complex64 by the Bluestein
    entry's own steps (``csrc/pcps_bins_bluestein.cu``), in PyTorch: the
    chirp at its integer index (:func:`chirp_index`), the lengths and the
    split M = M1 * M2 (:func:`bluestein_lengths`; input j = j1 M2 + j2,
    its rows from ceil(n / M2) on zeros), the forward transform in the
    conjugate (the inverse sign of the tile butterflies on ``conj(x c)``:
    column transforms, the twiddle at its integer index ``k1 * j2`` below
    M, row transforms), the product ``conj(v) B`` with the filter in its
    ``[k1, k2]`` order (:func:`bluestein_filter`), the inverse row
    transforms, the same twiddle, the inverse column transforms
    (``torch.fft`` of length M1 and M2 stands for the kernel's tile FFTs),
    and the last chirp, which the kernel skips (``|c_k| = 1`` under the
    magnitude)."""
    if x.shape[-1] != n:
        raise ValueError(f"x has {x.shape[-1]} points, expected n={n}")
    m, m1, m2 = bluestein_lengths(n)
    dev = x.device
    chirp = chirp_table(n, dev)[chirp_index(torch.arange(n, device=dev), n)]
    tw = twiddle_table(m, dev)[torch.arange(m1, device=dev)[:, None]
                               * torch.arange(m2, device=dev)[None, :]]
    a = torch.zeros(*x.shape[:-1], m, dtype=torch.complex64, device=dev)
    a[..., :n] = (x * chirp).conj()
    a = a.reshape(*x.shape[:-1], m1, m2)                     # [j1, j2]
    a = torch.fft.ifft(a, dim=-2, norm="forward") * tw       # [k1, j2]
    a = torch.fft.ifft(a, dim=-1, norm="forward")            # [k1, k2]
    a = a.conj() * bluestein_filter(n, m1, m2, dev)
    a = torch.fft.ifft(a, dim=-1, norm="forward") * tw       # [k1, j2]
    a = torch.fft.ifft(a, dim=-2, norm="forward")            # [j1, j2]
    return a.reshape(*x.shape[:-1], m)[..., :n] * chirp


def bluestein_bins_ref(spectra, code_k, bin_shifts):
    """:func:`pcps_bins` by the Bluestein entry's steps: the product at
    the kernel's fused index (the bin's phase, the code read at ``i - k``
    wrapped into [0, n), ``k = shift mod n``), :func:`bluestein_ifft_ref`,
    the magnitude, and the nc blocks summed in order."""
    return _bins_ref(bluestein_ifft_ref, spectra, code_k, bin_shifts)


def twostep_bins_ref(spectra, code_k, bin_shifts):
    """:func:`pcps_bins` by the two-step entry's steps: the product at the
    kernel's fused index, :func:`twostep_ifft_ref`, the magnitude, and the
    nc blocks summed in order."""
    return _bins_ref(twostep_ifft_ref, spectra, code_k, bin_shifts)


def _bins_ref(ifft, spectra, code_k, bin_shifts):
    n = spectra.shape[-1]
    i = torch.arange(n, device=spectra.device)
    maps = []
    for k, p in bin_shifts:
        src = i - k % n
        src = torch.where(src < 0, src + n, src)
        mag = ifft(spectra[p] * code_k[:, None, src], n).abs()
        acc = mag[:, 0]
        for jb in range(1, mag.shape[1]):
            acc = acc + mag[:, jb]
        maps.append(acc)
    return torch.stack(maps, dim=1)                          # [ch, bins, n]


def radix_kernel_for(n: int):
    """The radix entry that takes ``n``'s plan and its launch arguments
    that depend on ``n`` alone: an FFT kernel with its plan (radices,
    their count, threads a block), on one block or, with the cluster size
    last, on a cluster (:func:`cluster_size`). Raises ``ValueError``
    where the plan fits no cluster of 8 blocks or fewer. The tools and
    tests launch it at any such ``n``; the wrapper at the ``n``
    :func:`kernel_for` routes to it."""
    plan = radix_plan(n)
    cluster = cluster_size(n, plan)
    shape = ((_INT * len(plan))(*plan), len(plan),
             fft_threads(n, plan, cluster))
    if cluster == 1:
        return KERNEL, shape
    return CLUSTER_KERNEL, (*shape, cluster)


def kernel_for(n: int):
    """The entry that ``n`` selects and its launch arguments that depend
    on ``n`` alone, p being n's largest prime factor:
    :func:`radix_kernel_for` where its plan fits a block or a cluster and
    p <= 31 (every 31-smooth n up to 65536 and 38 5-smooth n above it),
    or p <= :data:`GENERIC_MAX_PRIME` on one block or a cluster of 2
    (:data:`TWOSTEP_MIN_CLUSTER`); else the two-step entry
    (:func:`twostep_kernel_for`) for the other 31-smooth n up to 2^20, the
    n with p <= 233 that a radix plan would run on a cluster of 4 or 8,
    and the n above 65536 with p <= :data:`TWOSTEP_MAX_PRIME` whose split
    fits the tile; else the Bluestein entry with ``(M, M1, M2)``
    (:func:`bluestein_lengths`): every other n up to 2^20 that is not
    prime.

    The limits are where the other entry wins, at 8 ch x 101 bins x 10
    blocks (and, above 65536, at 1 ch x 11 bins x 2 blocks too; device
    times, ``tools/torch_kernel_variants.py --k2 --entries``, NVIDIA H100
    80GB HBM3, 700.00 W). Above 65536, the two-step entry's time over the
    Bluestein entry's at n ~ 10^5, by p: 0.37 / 0.43 at 37 (99900), 0.38 /
    0.42 at 41, 0.39 / 0.42 at 53 (99375), 0.42 / 0.43 at 71, 0.54 /
    0.62 at 97, 0.55 / 0.54 at 131, 0.59 / 0.60 at 157, 0.71 / 0.70 at
    193, 0.67 / 0.63 at 233, 0.74 / 0.69 at 257 (0.93 / 0.80 at 65792 =
    64 x 1028, 257 in the rows); 0.97 / 1.14 at 331 and 1.24 / 1.33 at
    409, both in the rows (99300, 99387). In the columns, at larger n (2
    ch x 101 x 10 / 1 x 11 x 2), 0.55 / 0.56 at 331, 0.85 / 0.88 at 409,
    0.93 / 0.87 at 521 and 1.03 / 0.96 at 641 (211840 to 461520): a limit
    for column splits is not set. Below 65536, the radix entries' time
    over the two-step entry's: on one block 0.76-1.01 (4070, 7860, 7950,
    6990: p = 37 to 233), on a cluster of 2 0.76-1.04 with p in the rows
    (13100, 13032, 13980: 131 to 233) and 1.31-1.40 in the columns
    (14800, 14550: 37, 97), on a cluster of 4 1.20-1.73 (26500 to 30144,
    p = 37 to 233), of 8 1.87-2.21 (52400 to 58875, 37 to 233); the
    Bluestein entry beat the radix entries by 10% or more only at 55920
    = 2^4 x 3 x 5 x 233 (radix / Bluestein 1.37, C = 8), which the
    two-step entry takes (0.62 of Bluestein), and lost to the two-step
    entry from p = 239 on only on a cluster's n (0.79 at 28680, 0.90 at
    25700; 1.10-1.11 on one block, 7170, 7710), where those n keep
    Bluestein. So :data:`GENERIC_MAX_PRIME` stays 233: radix / Bluestein
    read 0.35 at 37 (4070), 0.45-0.58 at 37-53, 0.58-0.80 at 73-97,
    0.63-0.94 at 131-157, 0.77-1.06 at 181 and 0.80-0.91 at 233 on the
    one-block and 2-block n.

    Raises ``ValueError`` for an ``n`` above 2^20, naming the limit, and
    for a prime (in :func:`balanced_factors`' words above 64)."""
    if n > BLUESTEIN_MAX_N:
        return bluestein_kernel_for(n)     # raises, naming the limit
    factors = prime_factors(n)
    if len(factors) < 2:
        balanced_factors(n)                # a prime above 64 raises
    p = max(factors, default=1)
    cluster = None
    if p <= GENERIC_MAX_PRIME:
        cluster = fitting_cluster(n, radix_plan(n))
        if cluster is not None and (p <= PRIME_RADICES[0]
                                    or cluster < TWOSTEP_MIN_CLUSTER):
            return radix_kernel_for(n)
    if p <= PRIME_RADICES[0]:
        return twostep_kernel_for(n)
    if p <= TWOSTEP_MAX_PRIME and (cluster is not None or n > RADIX_MAX_N):
        try:
            return twostep_kernel_for(n)
        except ValueError:                 # the split passes the tile
            pass
    return bluestein_kernel_for(n)


def tile_fill(n1: int, n2: int) -> float:
    """The share of the tile that the two-step entry's passes fill at the
    split N1 x N2 (the lesser of the column and the row pass): W = tile //
    N1 columns and R = tile // N2 rows of the tile that
    ``csrc/pcps_tile.cuh``'s ``tile_points`` gives (4096 points where a
    sub-plan has a generic or a radix-16 pass, where N2 > 2048 or 8 N1 >
    2048, else 2048)."""
    p1, p2 = sub_plan(n1), sub_plan(n2, row=True)
    full = (16 in p1 + p2 or max(p1 + p2) > PRIME_RADICES[0]
            or n2 > TWOSTEP_MAX_N2 // 2 or 8 * n1 > TWOSTEP_MAX_N2 // 2)
    tile = TWOSTEP_MAX_N2 if full else TWOSTEP_MAX_N2 // 2
    return min(min(tile // n1, n2) * n1, min(tile // n2, n1) * n2) / tile


def twostep_split(n: int) -> tuple[int, int, tuple, tuple]:
    """``(N1, N2, plan1, plan2)`` of the two-step entry at any ``n`` whose
    split fits the tile (N1 <= 1024 columns, N1 <= N2 <= 4096 rows), with
    the column and row sub-plans (:func:`sub_plan`), whatever n's largest
    prime factor (the tools time it beside the other entries).

    A 31-smooth n takes :func:`balanced_factors`, JAX's split (250 x 280
    at 70000), unless a split that takes a radix-8 or radix-16 pass, has
    rows of at most :data:`TWOSTEP_FEWER_MAX_N2` points and fills at
    least :data:`TWOSTEP_MIN_FILL` of its tiles (:func:`tile_fill`) takes
    fewer passes: then the most balanced of those with the fewest. Radix
    16 made such splits common, and each ran faster at both 8 ch x 101
    bins x 10 blocks (2 ch above 150,000) and 1 ch x 11 bins x 2 blocks:
    122880 = 256 x 480 15.56 / 0.0721 ms against 320 x 384's 19.29 /
    0.0813, 262144 = 256 x 1024 35.96 / 0.1483 against 42.00 / 0.1602,
    524288 = 256 x 2048 19.13 / 0.2910 against 22.48 / 0.2999, 163680 =
    341 x 480 8.29 / 0.166 against 9.02 / 0.177, 400000 = 500 x 800 16.06
    / 0.2442 against 18.59 / 0.2593. Where one lost at the small shape it
    is excluded: 2^20 = 256 x 4096 0.714 against 1024 x 1024's 0.621 (a
    4096-point row), 70000 = 100 x 700 0.0499 against 0.0423 (its rows
    fill 68% of the 2048-point tile). The fewer-pass splits without radix
    8 or 16 existed before them and are not taken: 70000 keeps JAX's
    split (70 x 1000 ran 8.55 / 0.0428 against 8.82 / 0.0425), 120000
    takes 250 x 480 (300 x 400 ran 19.95 / 0.0821 against 320 x 375's
    21.77 / 0.0835) (NVIDIA H100 80GB HBM3, 700.00 W;
    ``tools/torch_kernel_variants.py --twostep --layouts``).

    An n with a prime factor above 31 takes the split with the
    fewest generic radices in the rows, then the fewest passes, then the
    most balanced: the generic pass ran faster in the columns at every n
    measured at 8 ch x 101 bins x 10 blocks (25.02 ms at 99900 = 111 x
    900, plan (37, 3), against 29.50 at JAX's 300 x 333, (37, 3, 3) in
    the rows; 23.29 at 99375 = 265 x 375, (53, 5), against 31.53 at 125
    x 795; 44.63 at 100656 = 233 x 432 against 73.95 at 144 x 699;
    ``tools/torch_kernel_variants.py --twostep --layouts``, NVIDIA H100
    80GB HBM3, 700.00 W). Raises ``ValueError`` for an ``n`` above 2^20,
    a prime, or one with no split that fits (none is 31-smooth up to 2^20;
    2,354 with a largest prime factor of 37 to 233)."""
    if n > BLUESTEIN_MAX_N:
        raise ValueError(f"n={n}: no K2 kernel on the card above "
                         f"{BLUESTEIN_MAX_N} points (2^20)")
    n1, n2 = balanced_factors(n)
    factors = prime_factors(n)
    if factors[-1] <= PRIME_RADICES[0] and n2 <= TWOSTEP_MAX_N2:
        least = _passes(n1) + _passes(n2, True)
        for d in _divisors(factors):
            e = n // d
            if (2 <= d <= min(TWOSTEP_MAX_N1, e) and e <= TWOSTEP_FEWER_MAX_N2
                    and {8, 16} & {*sub_plan(d), *sub_plan(e, row=True)}
                    and tile_fill(d, e) >= TWOSTEP_MIN_FILL):
                key = (_passes(d) + _passes(e, True), e - d)
                if key < (least, n2 - n1):
                    least, n1, n2 = key[0], d, e
    elif factors[-1] > PRIME_RADICES[0]:
        best = None
        for d in _divisors(factors):
            e = n // d
            if 2 <= d <= min(TWOSTEP_MAX_N1, e) and e <= TWOSTEP_MAX_N2:
                wide = sum(p > PRIME_RADICES[0] for p in prime_factors(e))
                key = (wide, _passes(d) + _passes(e, True), e - d)
                if best is None or key < best[0]:
                    best = (key, d, e)
        if best is not None:
            n1, n2 = best[1:]
    if n1 > TWOSTEP_MAX_N1 or n2 > TWOSTEP_MAX_N2:
        raise ValueError(f"n={n} = {n1} x {n2}: the two-step entry takes "
                         f"N1 <= {TWOSTEP_MAX_N1}, N2 <= {TWOSTEP_MAX_N2}")
    return n1, n2, sub_plan(n1), sub_plan(n2, row=True)


def _divisors(factors) -> list[int]:
    """Every divisor of the product of ``factors`` (prime, ascending)."""
    out = [1]
    for p in sorted(set(factors)):
        out = [d * p ** k for d in out for k in range(factors.count(p) + 1)]
    return out


def twostep_kernel_for(n: int):
    """The two-step entry and its :func:`twostep_split`; the tests launch
    it at ``n`` that :func:`kernel_for` routes elsewhere. Raises
    ``ValueError`` where :func:`twostep_split` does, and for a prime
    factor above :data:`TWOSTEP_MAX_PRIME` (where the Bluestein entry is
    faster)."""
    split = twostep_split(n)
    if prime_factors(n)[-1] > TWOSTEP_MAX_PRIME:
        raise ValueError(f"n={n}: a prime factor above "
                         f"{TWOSTEP_MAX_PRIME}, no two-step plan")
    return TWOSTEP_KERNEL, split


def bluestein_kernel_for(n: int):
    """The Bluestein entry and ``(M, M1, M2)`` (:func:`bluestein_lengths`)
    at any ``n`` up to 2^20; the tools and tests launch it at ``n`` that
    :func:`kernel_for` routes elsewhere. Raises ``ValueError`` above
    2^20, naming the limit."""
    if n > BLUESTEIN_MAX_N:
        raise ValueError(f"n={n}: no K2 kernel on the card above "
                         f"{BLUESTEIN_MAX_N} points (2^20, the Bluestein "
                         f"entry's limit)")
    return BLUESTEIN_KERNEL, bluestein_lengths(n)


def cluster_occupancy(n: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` for the cluster launch of ``n``'s
    radix plan (:func:`radix_kernel_for`; on the current card; launches
    nothing)."""
    kernel, shape = radix_kernel_for(n)
    if kernel is not CLUSTER_KERNEL:
        raise ValueError(f"n={n} does not take the cluster kernel")
    fn = CLUSTER_KERNEL.entry(
        "pcps_bins_cluster_occupancy",
        [_INT, ctypes.POINTER(_INT)] + [_INT] * 3 + [ctypes.POINTER(_INT)])
    count = _INT(0)
    err = fn(n, *shape, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"pcps_bins_cluster_occupancy: CUDA error {err}: "
                           f"{CLUSTER_KERNEL.error_string(err)}")
    return count.value


class _DevicePointer:
    """A tensor passed to a C entry point as its device pointer
    (``_as_parameter_``), kept alive while the arguments are."""

    def __init__(self, tensor):
        self.tensor = tensor
        self._as_parameter_ = ctypes.c_void_p(tensor.data_ptr())


def scratch_chunk_pairs(pairs: int, nc: int, points: int) -> int:
    """(bin, channel) pairs a chunk of a global-memory entry (Bluestein:
    ``points`` = M, two-step: n): as many as :data:`SCRATCH_BYTES` holds
    at nc transforms of ``points`` complex64 each, at most ``pairs``, and
    at least one, so a chunk of one pair takes its nc x points x 8 bytes
    of scratch even where they pass the cap (the last launch sums a
    pair's nc blocks in one pass)."""
    return max(1, min(pairs, SCRATCH_BYTES // (nc * points * 8)))


def pcps_bins_launch_args(spectra, code_k, bin_shifts, entry=None):
    """Check the arguments of :func:`pcps_bins` (CUDA tensors), allocate
    its output (and the global-memory entries' scratch) and return
    ``(kernel, out, args)``: the entry that ``n`` selects
    (:func:`kernel_for`; or, for the tools and tests, ``entry="radix"``:
    :func:`radix_kernel_for`, ``"twostep"``: the two-step entry at
    :func:`twostep_split`, whatever n's largest prime factor,
    ``"bluestein"``: :func:`bluestein_kernel_for`) and the C arguments of
    its entry point."""
    dev = spectra.device
    if dev.type != "cuda":
        raise ValueError(f"pcps_bins: unsupported device {dev}")
    n_ph, n_ch, nc, n = spectra.shape
    c64 = torch.complex64
    native.check(spectra, "spectra", c64, (n_ph, n_ch, nc, n), dev)
    native.check(code_k, "code_k", c64, (n_ch, n), dev)
    bin_shifts = tuple(map(tuple, bin_shifts))
    if any(not 0 <= p < n_ph for _, p in bin_shifts):
        raise ValueError("pcps_bins: phase index out of range")
    kernel, shape = {None: kernel_for, "radix": radix_kernel_for,
                     "twostep": lambda n: (TWOSTEP_KERNEL, twostep_split(n)),
                     "bluestein": bluestein_kernel_for}[entry](n)
    shift, phase = _plan_tensors(bin_shifts, dev)
    out = torch.empty((n_ch, len(bin_shifts), n), dtype=torch.float32,
                      device=dev)
    tail = (len(bin_shifts), native.ptr(out), native.stream_of(out))
    if kernel is TWOSTEP_KERNEL:
        n1, _, plan1, plan2 = shape
        chunk = scratch_chunk_pairs(n_ch * len(bin_shifts), nc, n)
        scratch = _DevicePointer(
            torch.empty(chunk * nc * n, dtype=c64, device=dev))
        args = (native.ptr(spectra), native.ptr(code_k),
                native.ptr(twiddle_table(n, dev)), native.ptr(shift),
                native.ptr(phase), native.ptr(_bin_order(bin_shifts, dev)),
                n_ch, nc, n, n1,
                (_INT * len(plan1))(*plan1), len(plan1),
                (_INT * len(plan2))(*plan2), len(plan2), len(bin_shifts),
                scratch, chunk, *tail[1:])
        return kernel, out, args
    if kernel is BLUESTEIN_KERNEL:
        m, m1, m2 = shape
        plan1, plan2 = sub_plan(m1), sub_plan(m2)
        chunk = scratch_chunk_pairs(n_ch * len(bin_shifts), nc, m)
        scratch = _DevicePointer(
            torch.empty(chunk * nc * m, dtype=c64, device=dev))
        args = (native.ptr(spectra), native.ptr(code_k),
                native.ptr(chirp_table(n, dev)),
                native.ptr(bluestein_filter(n, m1, m2, dev)),
                native.ptr(twiddle_table(m, dev)), native.ptr(shift),
                native.ptr(phase), native.ptr(_bin_order(bin_shifts, dev)),
                n_ch, nc, n, m1, m2,
                (_INT * len(plan1))(*plan1), len(plan1),
                (_INT * len(plan2))(*plan2), len(plan2), len(bin_shifts),
                scratch, chunk, *tail[1:])
        return kernel, out, args
    head = (native.ptr(spectra), native.ptr(code_k),
            native.ptr(twiddle_table(n, dev)), native.ptr(shift),
            native.ptr(phase), n_ch, nc, n)
    return kernel, out, (*head, *shape, *tail)


def pcps_bins(spectra, code_k, bin_shifts):
    """Non-coherent correlation map ``[n_ch, n_bins, n]`` f32.

    Args:
        spectra: ``[n_ph, n_ch, nc, n]`` complex64 per-phase spectra of the
            nc non-coherent blocks (coherent blocks already summed).
        code_k: ``[n_ch, n]`` complex64 conjugate code spectra.
        bin_shifts: per output bin ``(k, phase_index)`` (``shift_plan``):
            bin b correlates ``spectra[phase_index]`` against
            ``roll(code_k, k)``.
    """
    if spectra.device.type == "cpu":
        return pcps_bins_ref(spectra, code_k, bin_shifts)
    kernel, out, args = pcps_bins_launch_args(spectra, code_k, bin_shifts)
    kernel.launch(*args)
    return out
