"""Soundness amplification by independent repetition.

One ringGroth16/Rinocchio pass has Schwartz-Zippel soundness error
~ 2M/|E| per RNS limb, and every verifier check is limb-diagonal, so a
single proof's error against a general cheating prover is

    eps_1 = 2M / q_min          (the ONE limb where the statement is false)

— NOT (2M/q)^L: a statement false over Z_q = prod Z_{q_l} is only
guaranteed false in >= 1 limb, and the limbs where its projection is true
can be proven honestly.  (See DESIGN.md §12 for when the L-fold product
IS valid — limb-globally-false statement families — and a counterexample.)

K independent repetitions of the FULL proof (fresh trapdoor s, alpha, ...,
fresh encoding keys per repetition) amplify soundness to eps_1^K for ANY
statement: the failing limb must pass K independent evaluations.  With
31-bit limbs at M = 2^18 that is ~2^-12 per repetition — K = 3 reaches
~2^-36, K = 6 reaches ~2^-72, K = 11 past 2^-128.

The reference reaches deployable soundness differently — single 55-60-bit
SEAL limbs give eps_1 ~ 2^-36..-41 at 2^18 (`seal/seal_ring.hpp:72-88`
samples one s from Z_{q1}) — at the cost of 64-bit host arithmetic.  On
the accelerator, u32 limbs x K repetitions buy the same error with word-size ops; the
prover cost is exactly K x the one-limb cost, which is what the
multi-limb bench rows already measure (a repetition and an extra RNS limb
run the same kernels).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax

from ..relations.r1cs import CompiledR1CS
from .api import SnarkParams
from . import streamed as st
from . import groth16 as g16

__all__ = ["RepeatedProof", "soundness_err_log2", "prove_repeated",
           "verify_repeated"]


def soundness_err_log2(M: int, pbits: int, reps: int = 1) -> int:
    """log2 soundness error of `reps` independent proofs at degree-M QRP
    over limbs of `pbits`-bit primes: reps * (log2(2M) - log2(q_min))."""
    return reps * ((M.bit_length()) - (pbits - 1))


@dataclass
class RepeatedProof:
    """K independent (proof, vk) pairs for one statement."""

    proofs: list
    vks: list

    @property
    def reps(self) -> int:
        return len(self.proofs)

    def size_in_bits(self) -> int:
        return sum(p.size_in_bits() for p in self.proofs)


def prove_repeated(
    comp: CompiledR1CS,
    params: SnarkParams,
    primary,
    auxiliary,
    rng: np.random.Generator,
    key,
    reps: int,
    **stream_kwargs,
) -> RepeatedProof:
    """K independent streamed setup+prove passes (ringGroth16).

    Each repetition draws its own trapdoor and encoding keys from `rng`/
    `key`; soundness error = (2M/q_min)^K.
    """
    proofs, vks = [], []
    for r in range(reps):
        proof, vk, _ = st.stream_prove(
            comp, params, primary, auxiliary, rng,
            jax.random.fold_in(key, 7000 + r), **stream_kwargs,
        )
        proofs.append(proof)
        vks.append(vk)
    return RepeatedProof(proofs=proofs, vks=vks)


def verify_repeated(rp: RepeatedProof, primary) -> bool:
    """Accept iff every repetition verifies (`groth16.tcc:117-170` x K)."""
    return all(
        g16.verifier(vk, primary, proof)
        for proof, vk in zip(rp.proofs, rp.vks)
    )
