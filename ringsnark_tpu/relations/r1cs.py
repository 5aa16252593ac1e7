"""R1CS constraint systems, compiled to CSR tensors for jitted evaluation.

Mirrors `/root/reference/ringsnark/relations/constraint_satisfaction_problems/
r1cs/r1cs.hpp:50-162` (+ `.tcc`): `R1CSConstraint{a,b,c}`,
`R1CSConstraintSystem` with primary/auxiliary sizes, `is_satisfied`,
`is_valid`, `add_constraint`, `swap_AB_if_beneficial` (density heuristic,
`r1cs.tcc:176-226`), serialization.

Accelerator twist: `compile()` lowers the three sparse matrices to COO index/coeff
arrays; `eval_matrices` is a jitted gather + segment-sum (the SpMV used by
the witness map and verifiers), batched over all three matrices at once.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.modops import mul_mod, barrett_reduce_u64
from ..rings.context import RingContext
from ..rings.elem import RingElem
from .variable import LinearCombination, ONE_INDEX

__all__ = ["R1CSConstraint", "R1CSConstraintSystem", "CompiledR1CS"]


class R1CSConstraint:
    """<a,(1,x)> * <b,(1,x)> = <c,(1,x)>  (r1cs.hpp:50-74)."""

    __slots__ = ("a", "b", "c")

    def __init__(self, a, b, c):
        self.a = LinearCombination(a) if not isinstance(a, LinearCombination) else a
        self.b = LinearCombination(b) if not isinstance(b, LinearCombination) else b
        self.c = LinearCombination(c) if not isinstance(c, LinearCombination) else c

    def __repr__(self):
        return f"({self.a!r}) * ({self.b!r}) = ({self.c!r})"


@dataclass
class R1CSConstraintSystem:
    primary_input_size: int = 0
    auxiliary_input_size: int = 0
    constraints: list = field(default_factory=list)
    # debug annotation maps (reference r1cs.hpp:135-138, DEBUG-gated there)
    constraint_annotations: dict = field(default_factory=dict)
    variable_annotations: dict = field(default_factory=dict)

    def num_inputs(self) -> int:
        return self.primary_input_size

    def num_variables(self) -> int:
        return self.primary_input_size + self.auxiliary_input_size

    def num_constraints(self) -> int:
        return len(self.constraints)

    def add_constraint(self, c: R1CSConstraint, annotation: str | None = None):
        if annotation is not None:
            self.constraint_annotations[len(self.constraints)] = annotation
        self.constraints.append(c)

    def is_valid(self) -> bool:
        if self.primary_input_size > self.num_variables():
            return False
        nv = self.num_variables() + 1
        return all(
            cons.a.is_valid(nv) and cons.b.is_valid(nv) and cons.c.is_valid(nv)
            for cons in self.constraints
        )

    def is_satisfied(self, primary_input: list, auxiliary_input: list) -> bool:
        """Host-path satisfaction check (r1cs.tcc:121-159).

        For compiled/batched checking use `CompiledR1CS.is_satisfied`.
        """
        assert len(primary_input) == self.num_inputs()
        assert len(primary_input) + len(auxiliary_input) == self.num_variables()
        full = list(primary_input) + list(auxiliary_input)
        one = _one_like(full)
        for idx, cons in enumerate(self.constraints):
            ares = cons.a.evaluate(full, one)
            bres = cons.b.evaluate(full, one)
            cres = cons.c.evaluate(full, one)
            if not (ares * bres == cres):
                return False
        return True

    def swap_AB_if_beneficial(self):
        """Swap a<->b in every constraint if B touches more variables than A
        (r1cs.tcc:176-226)."""
        touched_a, touched_b = set(), set()
        for cons in self.constraints:
            touched_a.update(t.index for t in cons.a.terms)
            touched_b.update(t.index for t in cons.b.terms)
        if len(touched_b) > len(touched_a):
            for cons in self.constraints:
                cons.a, cons.b = cons.b, cons.a

    def __eq__(self, other):
        return (
            isinstance(other, R1CSConstraintSystem)
            and self.primary_input_size == other.primary_input_size
            and self.auxiliary_input_size == other.auxiliary_input_size
            and all(
                ca.a == cb.a and ca.b == cb.b and ca.c == cb.c
                for ca, cb in zip(self.constraints, other.constraints)
            )
            and len(self.constraints) == len(other.constraints)
        )

    # ---- compilation -------------------------------------------------------

    def compile(self, ctx: RingContext) -> "CompiledR1CS":
        return CompiledR1CS.build(self, ctx)

    # ---- serialization (the reference declares but never implements
    # pk/vk/r1cs round-trips — SURVEY §5; here it is first-class) -----------

    def save(self, path: str):
        def lc_json(lc):
            return [
                [t.index, int(t.coeff) if isinstance(t.coeff, int) else None,
                 None if isinstance(t.coeff, int)
                 else np.asarray(t.coeff.res).tolist()]
                for t in lc.terms
            ]

        obj = {
            "primary_input_size": self.primary_input_size,
            "auxiliary_input_size": self.auxiliary_input_size,
            "constraints": [
                [lc_json(c.a), lc_json(c.b), lc_json(c.c)] for c in self.constraints
            ],
        }
        with open(path, "w") as f:
            json.dump(obj, f)

    @classmethod
    def load(cls, path: str, ctx: RingContext | None = None):
        with open(path) as f:
            obj = json.load(f)

        def lc_from(ts):
            lc = LinearCombination()
            from .variable import LinearTerm

            for idx, ic, rc in ts:
                if ic is not None:
                    lc.terms.append(LinearTerm(idx, ic))
                else:
                    assert ctx is not None, "ring coeffs need a ctx to load"
                    lc.terms.append(
                        LinearTerm(idx, RingElem(ctx, jnp.asarray(np.array(rc, dtype=np.uint32))))
                    )
            return lc

        cs = cls(obj["primary_input_size"], obj["auxiliary_input_size"])
        for a, b, c in obj["constraints"]:
            cs.constraints.append(R1CSConstraint(lc_from(a), lc_from(b), lc_from(c)))
        return cs


def _one_like(assignment):
    for v in assignment:
        return type(v).one(v.ctx)
    raise ValueError("cannot infer ring from empty assignment")


@dataclass(frozen=True)
class CompiledR1CS:
    """COO form of the three R1CS matrices over a concrete ring.

    rows/cols: int32[nnz] per matrix (column 0 = constant 1);
    coeffs: uint32[nnz, L, nc] with nc ∈ {1, N}.
    """

    ctx: RingContext
    num_constraints: int
    num_variables: int  # excluding the constant
    primary_input_size: int
    rows: tuple  # (rows_a, rows_b, rows_c)
    cols: tuple
    coeffs: tuple

    @classmethod
    def build(cls, cs: R1CSConstraintSystem, ctx: RingContext) -> "CompiledR1CS":
        rows, cols, coeffs = [], [], []
        for which in ("a", "b", "c"):
            r, c_, co = [], [], []
            for i, cons in enumerate(cs.constraints):
                for t in getattr(cons, which).terms:
                    r.append(i)
                    c_.append(t.index)
                    co.append(
                        t.coeff
                        if isinstance(t.coeff, RingElem)
                        else RingElem.scalar(ctx, t.coeff)
                    )
            rows.append(jnp.asarray(np.array(r, dtype=np.int32)))
            cols.append(jnp.asarray(np.array(c_, dtype=np.int32)))
            coeffs.append(
                RingElem.stack(co).res
                if co
                else jnp.zeros((0, ctx.L, 1), dtype=jnp.uint32)
            )
        return cls(
            ctx=ctx,
            num_constraints=cs.num_constraints(),
            num_variables=cs.num_variables(),
            primary_input_size=cs.primary_input_size,
            rows=tuple(rows),
            cols=tuple(cols),
            coeffs=tuple(coeffs),
        )

    def eval_matrices(self, full_assignment_with_one, num_rows: int | None = None):
        """Evaluate (A·z, B·z, C·z) where z includes the leading constant 1.

        full_assignment_with_one: uint32[1+num_variables, L, n].
        Returns three arrays uint32[num_rows, L, n'] — the per-constraint LC
        values (the SpMV in SURVEY §2.1 "linear algebra over formal vars").
        """
        ctx = self.ctx
        m = num_rows if num_rows is not None else self.num_constraints
        outs = []
        for rows, cols, coeffs in zip(self.rows, self.cols, self.coeffs):
            gathered = full_assignment_with_one[cols]  # [nnz, L, n]
            prods = mul_mod(gathered, coeffs, ctx.p, ctx.mu, ctx.pbits)
            # segment-sum with lazy reduction: residues < 2^31, so u64 sums
            # stay exact for < 2^31 terms per row; one Barrett at the end.
            acc = jax.ops.segment_sum(
                prods.astype(jnp.uint64), rows, num_segments=m
            )
            outs.append(barrett_reduce_u64(acc, ctx.p, ctx.mu, ctx.pbits))
        return tuple(outs)

    def is_satisfied(self, full_assignment_with_one) -> bool:
        az, bz, cz = self.eval_matrices(full_assignment_with_one)
        ab = mul_mod(az, bz, self.ctx.p, self.ctx.mu, self.ctx.pbits)
        return bool(np.all(np.asarray(ab) == np.asarray(cz)))


def _comp_flatten(c: CompiledR1CS):
    return (c.rows, c.cols, c.coeffs), (
        c.ctx, c.num_constraints, c.num_variables, c.primary_input_size,
    )


def _comp_unflatten(aux, children):
    rows, cols, coeffs = children
    ctx, m, nv, pi = aux
    return CompiledR1CS(
        ctx=ctx, num_constraints=m, num_variables=nv, primary_input_size=pi,
        rows=tuple(rows), cols=tuple(cols), coeffs=tuple(coeffs),
    )


# pytree: jitted kernels take a CompiledR1CS as a traced argument
jax.tree_util.register_pytree_node(CompiledR1CS, _comp_flatten, _comp_unflatten)
