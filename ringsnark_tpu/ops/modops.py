"""Vectorized modular arithmetic over RNS limbs (generic u64 path).

Residues are uint32 arrays; every limb prime p < 2^31 so 62-bit products fit
exactly in uint64.  Reduction is Barrett (no division in jitted code).  This
is the portable path used by all jnp code; the CUDA NTT kernels
(``native/ntt_cuda.cu``) use uint32 Shoup multiplies with a native
32x32->64 high word instead.

Replaces `seal::util::{add,sub,negate,multiply}_uint_mod` and
`barrett_reduce_64` (reference call-sites:
``/root/reference/ringsnark/seal_int/seal_ring.tcc:46-66``).

Conventions
-----------
* ``p`` (and the Barrett constants) broadcast against the data: for an array
  of shape ``[..., L, n]`` pass limb constants shaped ``[L, 1]``.
* All functions accept/return ``uint32`` unless noted.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = [
    "add_mod",
    "sub_mod",
    "neg_mod",
    "mul_mod",
    "mul_mod_u64",
    "barrett_reduce_u64",
    "pow_mod",
    "inv_mod",
]

_U32 = jnp.uint32
_U64 = jnp.uint64


def add_mod(a, b, p):
    """(a + b) mod p, elementwise; a,b < p < 2^31 so the u32 sum can't wrap."""
    s = a + b
    return jnp.where(s >= p, s - p, s).astype(_U32)


def sub_mod(a, b, p):
    d = a + p - b  # in [1, 2p); fits u32 since p < 2^31
    return jnp.where(d >= p, d - p, d).astype(_U32)


def neg_mod(a, p):
    return jnp.where(a == 0, a, p - a).astype(_U32)


def barrett_reduce_u64(t, p, mu, b):
    """Reduce t (uint64, t < 2^(2b)) mod p via Barrett.

    mu = floor(2^(2b)/p) as uint64, b = bit_length(p) (broadcastable arrays).
    """
    t = t.astype(_U64)
    q1 = t >> (b - 1).astype(_U64)
    q = (q1 * mu.astype(_U64)) >> (b + 1).astype(_U64)
    r = t - q * p.astype(_U64)
    p64 = p.astype(_U64)
    r = jnp.where(r >= p64, r - p64, r)
    r = jnp.where(r >= p64, r - p64, r)
    return r.astype(_U32)


def mul_mod(a, b, p, mu, pbits):
    """(a * b) mod p for a,b < p < 2^31."""
    t = a.astype(_U64) * b.astype(_U64)
    return barrett_reduce_u64(t, p, mu, pbits)


def mul_mod_u64(a, b, p):
    """(a * b) mod p using u64 remainder — host/test convenience, no Barrett."""
    return ((a.astype(_U64) * b.astype(_U64)) % p.astype(_U64)).astype(_U32)


def pow_mod(a, e, p, mu, pbits, ebits: int = 32):
    """a**e mod p, elementwise; e is a uint32/uint64 array of exponents.

    Fixed `ebits`-step square-and-multiply ladder (static under jit).
    """
    a = a.astype(_U32)
    e = e.astype(_U64)
    one = jnp.ones_like(a)

    def body(i, carry):
        acc, base = carry
        bit = ((e >> i.astype(_U64)) & _U64(1)).astype(jnp.bool_)
        acc = jnp.where(bit, mul_mod(acc, base, p, mu, pbits), acc)
        base = mul_mod(base, base, p, mu, pbits)
        return acc, base

    acc, _ = lax.fori_loop(0, ebits, body, (one, a))
    return acc


def inv_mod(a, p, mu, pbits):
    """a^(p-2) mod p (Fermat).  Caller must ensure a != 0 mod p."""
    return pow_mod(a, (p - 1).astype(_U64) - 1, p, mu, pbits)
