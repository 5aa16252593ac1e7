"""Quadratic Ring Programs (QRP): instance, evaluated instance, witness.

Mirrors `/root/reference/ringsnark/relations/arithmetic_programs/qrp/qrp.hpp:
49-219` (+.tcc).  Containers are duck-typed: the generic host path stores
lists of ring elements, the batched fast path stores `RingElem` batches
([len, L, n] arrays) in the same fields.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

__all__ = ["QRPInstance", "QRPInstanceEvaluation", "QRPWitness", "inner_product"]


def inner_product(a: list, b: list):
    """Sum of products, skipping zero terms (`qrp.tcc:37-57`)."""
    assert len(a) == len(b)
    acc = None
    for x, y in zip(a, b):
        if hasattr(y, "is_zero") and y.is_zero():
            continue
        term = x * y
        acc = term if acc is None else acc + term
    if acc is None:
        raise ValueError("inner product of all-zero vectors")
    return acc


@dataclass
class QRPInstance:
    """A/B/C in Lagrange basis as per-variable sparse maps (qrp.hpp:59-65)."""

    domain: Any
    num_variables: int
    degree: int
    num_inputs: int
    A_in_Lagrange_basis: list  # list over variables (incl. const) of {row: coeff}
    B_in_Lagrange_basis: list
    C_in_Lagrange_basis: list

    def is_satisfied(self, witness: "QRPWitness", rng=None) -> bool:
        """Probabilistic check at a random point (`qrp.tcc:115-153`)."""
        rng = rng or np.random.default_rng()
        t = self.domain.random_exceptional(rng)
        u = self.domain.evaluate_all_lagrange_polynomials(t)
        u = [u[i] for i in range(self.domain.m)]  # list or RingElem batch
        zero = t - t
        At, Bt, Ct = [], [], []
        for k in range(self.num_variables + 1):
            for M, out in (
                (self.A_in_Lagrange_basis, At),
                (self.B_in_Lagrange_basis, Bt),
                (self.C_in_Lagrange_basis, Ct),
            ):
                acc = zero
                for row, coeff in M[k].items():
                    acc = acc + u[row] * coeff
                out.append(acc)
        Zt = self.domain.compute_vanishing_polynomial(t)
        one = type(t).one(t.ctx)
        Ht, ti = [], one
        for _ in range(self.degree + 1):
            Ht.append(ti)
            ti = ti * t
        ev = QRPInstanceEvaluation(
            self.domain, self.num_variables, self.degree, self.num_inputs,
            t, At, Bt, Ct, Ht, Zt,
        )
        return ev.is_satisfied(witness)


@dataclass
class QRPInstanceEvaluation:
    """(At, Bt, Ct, Ht, Zt) at the point t (qrp.hpp:117-124)."""

    domain: Any
    num_variables: int
    degree: int
    num_inputs: int
    t: Any
    At: Any  # list[len nv+1] or RingElem batch [nv+1, L, n]
    Bt: Any
    Ct: Any
    Ht: Any  # list[len degree+1] or batch
    Zt: Any

    def is_satisfied(self, witness: "QRPWitness") -> bool:
        """ans_A*ans_B - ans_C == ans_H*Zt (`qrp.tcc:207-276`)."""
        if self.num_variables != witness.num_variables:
            return False
        if self.degree != witness.degree:
            return False
        if self.num_inputs != witness.num_inputs:
            return False
        w = list(witness.coefficients_for_ABCs)
        if self.num_variables != len(w):
            return False
        H = list(witness.coefficients_for_H)
        if self.degree + 1 != len(H):
            return False
        At, Bt, Ct, Ht = list(self.At), list(self.Bt), list(self.Ct), list(self.Ht)
        Zt = self.Zt
        if Zt != self.domain.compute_vanishing_polynomial(self.t):
            return False

        ans_A = At[0] + witness.d1 * Zt + inner_product(At[1:], w)
        ans_B = Bt[0] + witness.d2 * Zt + inner_product(Bt[1:], w)
        ans_C = Ct[0] + witness.d3 * Zt + inner_product(Ct[1:], w)
        ans_H = inner_product(Ht, H)
        return (ans_A * ans_B - ans_C) == (ans_H * Zt)


@dataclass
class QRPWitness:
    """Witness coefficients (qrp.hpp:171-181).

    `coefficients_for_ABCs` is the full variable assignment (without the
    constant); the io/mid coefficient vectors interpolate the primary-only /
    auxiliary-only constraint evaluations.  Unlike the reference
    (`r1cs_to_qrp.tcc:167-200`), the constant column is counted ONCE — in the
    io part — so A_io + A_mid equals the full A exactly (see DESIGN.md §8:
    the reference double-counts the constant in both halves, which breaks
    verification for circuits with constant terms in their LCs).
    """

    num_variables: int
    degree: int
    num_inputs: int
    d1: Any
    d2: Any
    d3: Any
    coefficients_for_ABCs: Any  # the variable assignment values
    coefficients_for_A_io: Any
    coefficients_for_B_io: Any
    coefficients_for_C_io: Any
    coefficients_for_A_mid: Any
    coefficients_for_B_mid: Any
    coefficients_for_C_mid: Any
    coefficients_for_Z: Any
    coefficients_for_H: Any
