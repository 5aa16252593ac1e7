"""Linear-only homomorphic encodings E(.) — batched symmetric BGV over RNS.

Accelerator-native replacement for the reference's SEAL-backed `EncodingElem`
(`/root/reference/ringsnark/seal/seal_ring.hpp:216-409`): one BGV context per
outer RNS limb becomes a leading array axis; encode/decode/add/mul-plain/
modswitch/inner-product are batched jnp kernels.
"""

from .context import EncodingContext, SecretKey, keygen  # noqa: F401
from .encoding import Encoding, DecodingError, encode, decode, inner_product  # noqa: F401
