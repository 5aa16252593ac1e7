"""Proof systems: Rinocchio and ringGroth16 over rings.

Mirrors the reference's `ringsnark/zk_proof_systems/` on top of the
accelerator-native ring/encoding/reduction layers.
"""

from .api import KeyPair  # noqa: F401
from . import rinocchio  # noqa: F401
from . import groth16  # noqa: F401
