"""NTT-friendly prime generation and host-side exact arithmetic.

The whole framework works with RNS limbs that are primes ``p < 2**31``
(machine word = uint32; see DESIGN.md §1).  This module is host-side only
(pure Python ints / numpy): it generates prime chains, primitive roots and
CRT constants.  The reference uses SEAL's 36-60-bit primes
(``/root/reference/ringsnark/seal/seal_util.hpp:20-32``); we trade limb width
for limb count so every modular multiply fits 32-bit integer lanes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache

__all__ = [
    "is_prime",
    "find_ntt_primes",
    "primitive_root",
    "root_of_unity",
    "Prime",
    "make_prime",
    "crt_compose",
    "crt_decompose",
]

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all 64-bit ints)."""
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_ntt_primes(count: int, order: int, bits: int = 31, below: int | None = None) -> list[int]:
    """Find `count` primes p < 2**bits with p ≡ 1 (mod order), descending.

    `order` must be a power of two; every returned prime supports cyclic NTTs
    of any power-of-two size up to `order` and negacyclic NTTs up to order/2.
    """
    assert order & (order - 1) == 0, "order must be a power of two"
    assert bits <= 31, "limbs must fit uint32 with headroom (p < 2^31)"
    out: list[int] = []
    hi = below if below is not None else (1 << bits)
    # Largest k with k*order + 1 < hi
    k = (hi - 2) // order
    while k > 0 and len(out) < count:
        p = k * order + 1
        if p < (1 << (bits - 1)):
            break  # keep primes in [2^(bits-1), 2^bits) so Barrett shifts are uniform
        if is_prime(p):
            out.append(p)
        k -= 1
    if len(out) < count:
        raise ValueError(
            f"only found {len(out)} primes ≡ 1 mod {order} in [2^{bits-1}, 2^{bits})"
        )
    return out


@lru_cache(maxsize=None)
def primitive_root(p: int) -> int:
    """Smallest primitive root modulo prime p."""
    factors = _factorize(p - 1)
    for g in range(2, p):
        if all(pow(g, (p - 1) // f, p) != 1 for f in factors):
            return g
    raise ValueError(f"no primitive root for {p}")


def _factorize(n: int) -> list[int]:
    fs = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            fs.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


def root_of_unity(p: int, order: int) -> int:
    """A primitive `order`-th root of unity mod p (requires order | p-1)."""
    assert (p - 1) % order == 0, f"{order} does not divide {p}-1"
    g = primitive_root(p)
    w = pow(g, (p - 1) // order, p)
    # sanity: w has exact order `order`
    assert pow(w, order, p) == 1 and (order == 1 or pow(w, order // 2, p) != 1)
    return w


@dataclass(frozen=True)
class Prime:
    """A single RNS limb prime with precomputed reduction constants.

    Barrett: for p with bit-length b, mu = floor(2^(2b) / p).  Then for
    t < 2^(2b):  q = ((t >> (b-1)) * mu) >> (b+1),  r = t - q*p  ∈ [0, 3p).
    """

    value: int
    bits: int
    mu: int  # Barrett constant, fits in b+1 <= 32 bits... stored as u64
    root: int  # smallest primitive root of p

    def __post_init__(self):
        assert self.value < (1 << 31)


@lru_cache(maxsize=None)
def make_prime(p: int) -> Prime:
    assert is_prime(p)
    b = p.bit_length()
    mu = (1 << (2 * b)) // p
    return Prime(value=p, bits=b, mu=mu, root=primitive_root(p))


def crt_compose(residues: list[int], primes: list[int]) -> int:
    """CRT-compose residues into the unique x mod prod(primes)."""
    q = math.prod(primes)
    x = 0
    for r, p in zip(residues, primes):
        qi = q // p
        x = (x + r * qi * pow(qi, -1, p)) % q
    return x


def crt_decompose(x: int, primes: list[int]) -> list[int]:
    return [x % p for p in primes]
