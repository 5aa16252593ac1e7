"""ringsnark-tpu: a ring-SNARK proving framework for accelerators.

From-scratch JAX/XLA implementation (CUDA NTT kernels on NVIDIA GPUs) of the capabilities of
zkFHE/ringSNARK (see SURVEY.md): the Rinocchio and ringGroth16 proof systems
over the rings Z_q, Z_q^N and Z_q[X]/(X^N+1) with composite RNS modulus q,
a protoboard/gadget frontend, the R1CS->QRP reduction, and batched
BGV-symmetric linear-homomorphic encodings.

The package enables 64-bit JAX types at import: RNS residues are uint32 but
the jnp modular arithmetic uses uint64 intermediates.
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"
