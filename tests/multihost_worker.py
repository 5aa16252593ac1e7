"""Worker for the 2-process (simulated 2-host) sharded-prover test.

Each process owns 4 virtual CPU devices; the global ('limb','data') mesh is
laid out so the **data axis crosses the process boundary** — the CRS
inner-product psum therefore rides the cross-process (Gloo) link, the
CPU-land analog of a network hop between accelerator hosts (BASELINE configs 3-5).
Both processes independently compute the single-process proof and assert the
cross-host proof is bit-identical.

Usage: python multihost_worker.py <proc_id> <n_procs> <port>
"""

import os
import sys

proc = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.config.update("jax_enable_x64", True)
jax.distributed.initialize(
    coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=proc
)

import numpy as np
from jax.sharding import Mesh

from ringsnark_tpu.rings.context import default_context
from ringsnark_tpu.encoding import EncodingContext, Encoding
from ringsnark_tpu.snark.api import SnarkParams
from ringsnark_tpu.snark import groth16
from ringsnark_tpu.models.synthetic import build_synthetic_square_chain
from ringsnark_tpu.ops.primes import find_ntt_primes
from ringsnark_tpu.parallel.sharded import groth16_prove_sharded

assert jax.device_count() == 4 * nproc and jax.local_device_count() == 4

# --- deterministic setup, identical on every process -----------------------
ring = default_context(L=2, N=4, order=1 << 12)
inner, below = [], 1 << 31
while len(inner) < 3:
    c = find_ntt_primes(1, 64, below=below)[0]
    below = c
    if c not in ring.primes:
        inner.append(c)
ectx = EncodingContext(ring=ring, n_inner=32, inner_primes=tuple(inner))
params = SnarkParams(ring=ring, enc=ectx)
rng = np.random.default_rng(0)
comp, primary, aux = build_synthetic_square_chain(ring, 16, rng)
kp = groth16.generator(comp, params, rng, jax.random.key(0))

# local single-process reference proof
ref = groth16.prover(kp.pk, primary, aux)
assert groth16.verifier(kp.vk, primary, ref)

# --- cross-host mesh: data axis spans the process boundary -----------------
# global device order is [p0d0..p0d3, p1d0..p1d3]; interleave so each 'limb'
# row holds devices of BOTH processes along 'data'.
devs = np.array(jax.devices()).reshape(nproc, 2, 2).transpose(1, 0, 2)
mesh = Mesh(devs.reshape(2, 2 * nproc), ("limb", "data"))
assert {d.process_index for d in mesh.devices[0]} == set(range(nproc))

# pk encodings -> host numpy so device_put can lay them out globally
for name in ("alpha", "beta", "s_pows", "gamma_io", "delta_mid", "delta_ts"):
    e = getattr(kp.pk, name)
    if e is not None:
        e.c0 = np.asarray(e.c0)
        e.c1 = np.asarray(e.c1)

proof = groth16_prove_sharded(kp.pk, primary, aux, mesh)


from jax.experimental import multihost_utils as _mh


def fetch(a):
    """Full host copy of a (possibly sharded) global array."""
    if getattr(a, "is_fully_addressable", True):
        return np.asarray(a)
    return np.asarray(_mh.process_allgather(a, tiled=True))


for side in ("A", "B", "C"):
    got, want = getattr(proof, side), getattr(ref, side)
    assert (fetch(got.c0) == np.asarray(want.c0)).all(), f"{side}.c0 diverged"
    assert (fetch(got.c1) == np.asarray(want.c1)).all(), f"{side}.c1 diverged"
    assert got.level == want.level

proof_local = groth16.Proof(
    A=Encoding(ectx, fetch(proof.A.c0), fetch(proof.A.c1), proof.A.level),
    B=Encoding(ectx, fetch(proof.B.c0), fetch(proof.B.c1), proof.B.level),
    C=Encoding(ectx, fetch(proof.C.c0), fetch(proof.C.c1), proof.C.level),
)
assert groth16.verifier(kp.vk, primary, proof_local)
print(f"MULTIHOST_OK p{proc}", flush=True)
