"""Ring backends: R_q = Z_q[X]/(X^N+1) in slot form, and the Z_q integer ring.

Accelerator-native replacement for the reference's SEAL-backed ring layer
(`/root/reference/ringsnark/seal/seal_ring.hpp`,
`/root/reference/ringsnark/seal_int/seal_ring.hpp`).
"""

from .context import RingContext  # noqa: F401
from .elem import RingElem  # noqa: F401
