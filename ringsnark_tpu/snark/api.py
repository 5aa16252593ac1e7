"""Abstract ppzkSNARK API shape.

Mirrors `/root/reference/ringsnark/zk_proof_systems/r1cs_ppzksnark.hpp:
173-252`: `generator(cs) -> keypair(pk, vk)`, `prover(pk, x, w) -> proof`,
`verifier(vk, x, proof) -> bool`.  The reference also declares (but never
implements) processed-vk/online-verifier variants; here `verifier` is the
weak-IC designated-verifier check for both systems.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

__all__ = ["KeyPair", "SnarkParams", "make_params"]


@dataclass
class KeyPair:
    pk: Any
    vk: Any


@dataclass(frozen=True)
class SnarkParams:
    """Bundle of the contexts a proof system instance runs over."""

    ring: Any  # RingContext
    enc: Any  # EncodingContext
    domain_kind: str = "roots"
    use_modswitch: bool = True


def make_params(L: int, N: int, n_inner: int, max_terms: int, order: int,
                margin_bits: int = 10) -> SnarkParams:
    """Outer ring of L ~31-bit primes = 1 mod `order` at degree N (N = 1 is
    Z_q), and the inner BGV chain the noise planner sizes for inner products
    of `max_terms` terms; inner primes are = 1 mod 2N' and distinct from the
    outer ones."""
    from ..encoding import EncodingContext
    from ..encoding.noise import plan_inner_chain
    from ..ops.primes import find_ntt_primes
    from ..rings.context import default_context

    ring = default_context(L=L, N=N, order=order)
    L_inner, floor = plan_inner_chain(
        n_inner, 31, max_terms, margin_bits=margin_bits, dense=N > 1
    )
    inner, below = [], 1 << 31
    while len(inner) < L_inner:
        c = find_ntt_primes(1, 2 * n_inner, below=below)[0]
        below = c
        if c not in ring.primes:
            inner.append(c)
    enc = EncodingContext(ring=ring, n_inner=n_inner, inner_primes=tuple(inner),
                          floor_limbs=floor)
    return SnarkParams(ring=ring, enc=enc)
