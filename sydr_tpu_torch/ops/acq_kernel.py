"""K2 ``pcps_bins``: the per-bin PCPS chain (spectrum product -> inverse
DFT -> magnitude -> non-coherent sum) for every (Doppler bin, channel).

Replaces ``sydr_tpu.ops.acq_kernel.pcps_fused_bins`` (Pallas ``_kernel``).
On CUDA tensors :func:`pcps_bins` launches one of three hand-written
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
  memory, for the other ``n`` up to 65,536 and 38 5-smooth ``n`` above
  it (16368 at 16.368 Msps, 20000, 25000, 26500 = 2^2 * 5^3 * 53, 40920,
  65536, 80000, 100000);
* ``csrc/pcps_bins_bluestein.cu`` (:data:`BLUESTEIN_KERNEL`), Bluestein's
  chirp convolution as power-of-two FFTs through global memory, for
  every other ``n`` up to 2^20 that is not prime (70000 at 70 Msps,
  65538 = 2 * 3^2 * 11 * 331, 122880, 245520) and for the ``n`` whose
  largest prime factor is above :data:`GENERIC_MAX_PRIME`, where the
  radix entries' generic pass costs p operations a point (9722 =
  2 * 4861, 65498 = 2 * 32749).

A prime ``n``, or one above 2^20, raises ``ValueError`` from
:func:`kernel_for` before anything is launched.
:func:`pcps_bins_ref` is the plain PyTorch version (``torch.fft.ifft`` of
the product, ``abs``, sum), used on CPU tensors; there is no fallback from
a kernel to it or from one kernel to another.
:func:`stockham_ifft_ref` walks the radix entries' passes, strides and
integer twiddle indices in PyTorch, :func:`bluestein_ifft_ref` the
Bluestein entry's steps, for the tests of that arithmetic.
"""

from __future__ import annotations

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
BLUESTEIN_KERNEL = native.CudaKernel(
    "pcps_bins_bluestein.cu", "pcps_bins_bluestein_launch",
    [_VP] * 7 + [_INT] * 6 + [_VP, _INT, _VP, _VP])

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
# The Bluestein entry (csrc/pcps_bins_bluestein.cu): n up to 2^20, so its
# convolution length M = M1 * M2 up to 2^21 with M1, M2 <= 2048; its
# scratch (M complex64 a transform, nc transforms a (bin, channel) pair)
# holds as many pairs as fit in 512 MB, and always one: a pair's nc x M x
# 8 bytes pass the cap from nc = 33 at M = 2^21.
BLUESTEIN_MAX_N = 1 << 20
BLUESTEIN_MAX_SUB = 1 << 11
BLUESTEIN_SCRATCH_BYTES = 512 << 20
# The largest prime factor that a plan with a generic pass keeps on the
# radix entries; above it the Bluestein entry (kernel_for).
GENERIC_MAX_PRIME = 233


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


def bluestein_lengths(n: int) -> tuple[int, int, int]:
    """``(M, M1, M2)`` of the Bluestein entry: the convolution length M,
    the least power of two >= 2 n - 1, and its split M = M1 * M2 with
    M1 = 2^floor(m / 2) <= M2 = 2^ceil(m / 2) (M = 2^m): 32768 = 128 x
    256 at n = 9722 and 16370, 131072 = 256 x 512 at 65498, 262144 =
    512 x 512 at 70000 and 122880, 2^21 = 1024 x 2048 at 2^20."""
    m = (2 * n - 2).bit_length()
    return 1 << m, 1 << (m // 2), 1 << (m - m // 2)


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
def bluestein_filter(n: int, device) -> torch.Tensor:
    """``[M1, M2]`` complex64: the transform of the Bluestein filter
    ``b_j = conj(c_j)`` for ``|j| < n`` (``b_{M-j} = b_j``; zero between),
    ``B[k] = FFT_M(b)[k] / (M n)`` (the convolution's 1/M and
    ``torch.fft.ifft``'s 1/n folded in), stored at ``[k1, k2]`` for
    ``k = k1 + M1 k2``: the order the entry's row step reads. A constant
    of ``n``, built once per ``(n, device)`` in float64 on the host."""
    m, m1, m2 = bluestein_lengths(n)
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


def bluestein_ifft_ref(x, n: int):
    """``torch.fft.ifft(x)`` of ``x [..., n]`` complex64 by the Bluestein
    entry's own steps (``csrc/pcps_bins_bluestein.cu``), in PyTorch: the
    chirp at its integer index (:func:`chirp_index`), the padding to M,
    the split M = M1 * M2 (:func:`bluestein_lengths`; input j = j1 M2 +
    j2) with its twiddle indices ``k1 * j2`` below M, the column and row
    transforms (``torch.fft`` of length M1 and M2 stand for the kernel's
    shared-memory FFTs), the filter in its ``[k1, k2]`` order
    (:func:`bluestein_filter`), the inverse steps, and the last chirp,
    which the kernel skips (``|c_k| = 1`` under the magnitude)."""
    if x.shape[-1] != n:
        raise ValueError(f"x has {x.shape[-1]} points, expected n={n}")
    m, m1, m2 = bluestein_lengths(n)
    dev = x.device
    chirp = chirp_table(n, dev)[chirp_index(torch.arange(n, device=dev), n)]
    tw = twiddle_table(m, dev)
    idx = torch.arange(m1, device=dev)[:, None] \
        * torch.arange(m2, device=dev)[None, :]              # [M1, M2] < M
    a = torch.zeros(*x.shape[:-1], m, dtype=torch.complex64, device=dev)
    a[..., :n] = x * chirp
    a = a.reshape(*x.shape[:-1], m1, m2)                     # [j1, j2]
    a = torch.fft.fft(a, dim=-2) * tw[idx].conj()            # [k1, j2]
    a = torch.fft.fft(a, dim=-1) * bluestein_filter(n, dev)  # [k1, k2]
    a = torch.fft.ifft(a, dim=-1, norm="forward") * tw[idx]  # [k1, j2]
    a = torch.fft.ifft(a, dim=-2, norm="forward")            # [j1, j2]
    return a.reshape(*x.shape[:-1], m)[..., :n] * chirp


def bluestein_bins_ref(spectra, code_k, bin_shifts):
    """:func:`pcps_bins` by the Bluestein entry's steps: the product at
    the kernel's fused index (the bin's phase, the code read at ``i - k``
    wrapped into [0, n), ``k = shift mod n``), :func:`bluestein_ifft_ref`,
    the magnitude, and the nc blocks summed in order."""
    n = spectra.shape[-1]
    i = torch.arange(n, device=spectra.device)
    maps = []
    for k, p in bin_shifts:
        src = i - k % n
        src = torch.where(src < 0, src + n, src)
        mag = bluestein_ifft_ref(spectra[p] * code_k[:, None, src], n).abs()
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
    on ``n`` alone: :func:`radix_kernel_for` where its plan fits a block
    or a cluster of 8 and ``n``'s largest prime factor is at most
    :data:`GENERIC_MAX_PRIME`, else the Bluestein entry with ``(M, M1,
    M2)`` (:func:`bluestein_lengths`). So every 31-smooth n up to 65536
    and the 38 5-smooth n above it that a cluster holds keep the radix
    entries; every other n that is not prime, up to 2^20, has the
    Bluestein entry.

    The threshold is where the Bluestein entry overtakes the radix
    entries' generic pass: at 8 ch x 101 bins x 10 blocks the radix
    entry's device time over the Bluestein entry's read 0.42 at p = 37
    (n = 4070), 0.58-0.67 at 41, 0.43-0.61 at 53, 0.44-0.73 from 73 to
    157, 0.88 / 0.94 / 0.96 / 0.96 / 0.97 at 181 / 193 / 227 / 229 /
    233, then 1.21 at 239 (1.43 at n = 478 = 2 x 239), 1.18 at 257, 1.40
    at 311, 1.71 at 409, 1.38 at 509, 8.65 at 1637 and 12.2 at 4861
    (``tools/torch_kernel_variants.py --k2 --entries``,
    NVIDIA H100 80GB HBM3, 700.00 W). One exception to the rule: n =
    65231 = 37 x 41 x 43, three generic passes, read 1.46 and stays on
    the radix entry.

    Raises ``ValueError`` for an ``n`` above 2^20, naming the limit, and
    for a prime (in :func:`balanced_factors`' words above 64)."""
    if n > BLUESTEIN_MAX_N:
        return bluestein_kernel_for(n)     # raises, naming the limit
    factors = prime_factors(n)
    if len(factors) < 2:
        balanced_factors(n)                # a prime above 64 raises
    if max(factors, default=1) <= GENERIC_MAX_PRIME:
        plan = radix_plan(n)
        if fitting_cluster(n, plan) is not None:
            return radix_kernel_for(n)
    return bluestein_kernel_for(n)


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


def bluestein_chunk_pairs(pairs: int, nc: int, m: int) -> int:
    """(bin, channel) pairs a chunk of the Bluestein entry: as many as
    :data:`BLUESTEIN_SCRATCH_BYTES` holds at nc transforms of M complex64
    each, at most ``pairs``, and at least one, so a chunk of one pair
    takes its nc x M x 8 bytes of scratch even where they pass the cap
    (the last launch sums a pair's nc blocks in one pass)."""
    return max(1, min(pairs, BLUESTEIN_SCRATCH_BYTES // (nc * m * 8)))


def pcps_bins_launch_args(spectra, code_k, bin_shifts, entry=None):
    """Check the arguments of :func:`pcps_bins` (CUDA tensors), allocate
    its output (and the Bluestein entry's scratch) and return ``(kernel,
    out, args)``: the entry that ``n`` selects (:func:`kernel_for`; or,
    for the tools and tests, ``entry="radix"``: :func:`radix_kernel_for`,
    ``entry="bluestein"``: :func:`bluestein_kernel_for`) and the C
    arguments of its entry point."""
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
                     "bluestein": bluestein_kernel_for}[entry](n)
    shift, phase = _plan_tensors(bin_shifts, dev)
    out = torch.empty((n_ch, len(bin_shifts), n), dtype=torch.float32,
                      device=dev)
    tail = (len(bin_shifts), native.ptr(out), native.stream_of(out))
    if kernel is BLUESTEIN_KERNEL:
        m, m1, m2 = shape
        chunk = bluestein_chunk_pairs(n_ch * len(bin_shifts), nc, m)
        scratch = _DevicePointer(
            torch.empty(chunk * nc * m, dtype=c64, device=dev))
        args = (native.ptr(spectra), native.ptr(code_k),
                native.ptr(chirp_table(n, dev)),
                native.ptr(bluestein_filter(n, dev)),
                native.ptr(twiddle_table(m, dev)), native.ptr(shift),
                native.ptr(phase), n_ch, nc, n, m1.bit_length() - 1,
                m2.bit_length() - 1, len(bin_shifts), scratch, chunk,
                *tail[1:])
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
