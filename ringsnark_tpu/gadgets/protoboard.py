"""Protoboard: circuit builder producing R1CS + assignment.

Mirrors `/root/reference/ringsnark/gadgetlib/protoboard.hpp:28-87` (+.tcc):
variable index 0 is the constant 1 (`protoboard.tcc:17-26`), allocations
initially count as auxiliary (`protoboard.tcc:34-45`), `set_input_sizes`
re-partitions primary/auxiliary by index prefix (`protoboard.tcc:142-146`).

Batched additions: `full_assignment_batch()` materializes the assignment
(with the leading constant) as one `RingElem` batch for the jitted pipeline.
"""

from __future__ import annotations

from ..relations.r1cs import R1CSConstraint, R1CSConstraintSystem, CompiledR1CS
from ..rings.context import RingContext
from ..rings.elem import RingElem
from .pb_variable import PBVariable, PBLinearCombination

__all__ = ["Protoboard"]


class Protoboard:
    def __init__(self, ctx: RingContext):
        self.ctx = ctx
        self.constant_term = RingElem.one(ctx)
        self.values: list = []  # per-variable, excluding the constant
        self.lc_values: list = []
        self.constraint_system = R1CSConstraintSystem()
        self.constraint_system.variable_annotations[0] = "ONE"
        self.next_free_var = 1  # account for constant-1 term
        self.next_free_lc = 0

    # ---- allocation --------------------------------------------------------

    def allocate_var_index(self, annotation: str = "") -> int:
        if annotation:
            self.constraint_system.variable_annotations[self.next_free_var] = annotation
        self.constraint_system.auxiliary_input_size += 1
        self.values.append(RingElem.zero(self.ctx))
        idx = self.next_free_var
        self.next_free_var += 1
        return idx

    def allocate_lc_index(self) -> int:
        self.lc_values.append(RingElem.zero(self.ctx))
        idx = self.next_free_lc
        self.next_free_lc += 1
        return idx

    # ---- values ------------------------------------------------------------

    def val(self, var: PBVariable) -> RingElem:
        assert var.index <= len(self.values)
        return self.constant_term if var.index == 0 else self.values[var.index - 1]

    def set_val(self, var: PBVariable, value: RingElem):
        assert var.index > 0, "cannot assign the constant"
        if not isinstance(value, RingElem):
            value = RingElem.scalar(self.ctx, int(value))
        self.values[var.index - 1] = value

    def lc_val(self, lc: PBLinearCombination) -> RingElem:
        if lc.is_variable:
            return self.val(PBVariable(lc.index))
        return self.lc_values[lc.index]

    def set_lc_val(self, lc: PBLinearCombination, value: RingElem):
        assert not lc.is_variable
        self.lc_values[lc.index] = value

    def values_list(self):
        return self.values

    def one_value(self) -> RingElem:
        return self.constant_term

    def clear_values(self):
        self.values = [RingElem.zero(self.ctx) for _ in self.values]

    # ---- constraints -------------------------------------------------------

    def add_r1cs_constraint(self, constraint: R1CSConstraint, annotation: str = ""):
        self.constraint_system.add_constraint(constraint, annotation or None)

    def augment_variable_annotation(self, var: PBVariable, postfix: str):
        anns = self.constraint_system.variable_annotations
        prev = anns.get(var.index, "")
        anns[var.index] = (prev + " " + postfix).strip()

    # ---- queries -----------------------------------------------------------

    def num_constraints(self) -> int:
        return self.constraint_system.num_constraints()

    def num_inputs(self) -> int:
        return self.constraint_system.num_inputs()

    def num_variables(self) -> int:
        return self.next_free_var - 1

    def set_input_sizes(self, primary_input_size: int):
        assert primary_input_size <= self.num_variables()
        self.constraint_system.primary_input_size = primary_input_size
        self.constraint_system.auxiliary_input_size = (
            self.num_variables() - primary_input_size
        )

    # ---- extraction --------------------------------------------------------

    def full_variable_assignment(self) -> list:
        return list(self.values)

    def primary_input(self) -> list:
        return self.values[: self.num_inputs()]

    def auxiliary_input(self) -> list:
        return self.values[self.num_inputs():]

    def get_constraint_system(self) -> R1CSConstraintSystem:
        return self.constraint_system

    def compile(self) -> CompiledR1CS:
        return self.constraint_system.compile(self.ctx)

    def full_assignment_batch(self) -> RingElem:
        """[1 + num_variables, L, n] batch: constant 1 followed by values."""
        return RingElem.stack([self.constant_term] + self.values)

    def is_satisfied(self) -> bool:
        return self.compile().is_satisfied(self.full_assignment_batch().res)
