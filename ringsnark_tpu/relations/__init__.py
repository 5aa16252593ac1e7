"""Statement data structures: variables, linear combinations, R1CS, QRP.

Mirrors the reference layer L3 (`/root/reference/ringsnark/relations/`) with a
Accelerator twist: constraint systems compile to CSR index/coefficient arrays so that
constraint evaluation is a jitted gather + segment-sum instead of per-object
loops.
"""

from .variable import Variable, LinearTerm, LinearCombination  # noqa: F401
from .r1cs import R1CSConstraint, R1CSConstraintSystem  # noqa: F401
