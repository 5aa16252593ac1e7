"""Synthetic large-scale R1CS instances built directly as arrays.

The protoboard object layer is fine up to ~2^12 constraints; benchmark-scale
instances (2^14..2^18, BASELINE configs 3-5) construct the COO matrices and
assignment batch directly in numpy, bypassing per-term Python objects.

Circuit: independent multiplication gates x_{3i} * x_{3i+1} = x_{3i+2}
(one constraint each), first `num_public` gate outputs public.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..relations.r1cs import CompiledR1CS
from ..rings.context import RingContext
from ..rings.elem import RingElem
from ..ops.modops import mul_mod

__all__ = ["build_synthetic_mul_chain", "build_synthetic_square_chain"]


def build_synthetic_mul_chain(
    ctx: RingContext,
    num_constraints: int,
    rng: np.random.Generator,
    num_public_gates: int = 1,
):
    """Returns (compiled_r1cs, primary RingElem batch, auxiliary RingElem batch).

    Variables (1-based): gate i uses a_i = x_{3i+1}, b_i = x_{3i+2},
    c_i = x_{3i+3}.  Primary variables must be an index prefix, so public
    gates come first and all their wires are public.
    """
    m = num_constraints
    nv = 3 * m
    rows = np.arange(m, dtype=np.int32)
    cols_a = (3 * rows + 1).astype(np.int32)
    cols_b = (3 * rows + 2).astype(np.int32)
    cols_c = (3 * rows + 3).astype(np.int32)
    ones = jnp.ones((m, ctx.L, 1), dtype=jnp.uint32)

    # assignment: random a, b; c = a*b  (slot-form arrays [m, L, n])
    n = ctx.N
    a_vals = np.stack(
        [rng.integers(0, p, (m, n), dtype=np.uint64) for p in ctx.primes], axis=1
    ).astype(np.uint32)
    b_vals = np.stack(
        [rng.integers(0, p, (m, n), dtype=np.uint64) for p in ctx.primes], axis=1
    ).astype(np.uint32)
    c_vals = np.asarray(
        mul_mod(jnp.asarray(a_vals), jnp.asarray(b_vals), ctx.p, ctx.mu, ctx.pbits)
    )

    # interleave into the variable order x_1..x_{3m}
    assign = np.empty((nv, ctx.L, n), dtype=np.uint32)
    assign[0::3] = a_vals
    assign[1::3] = b_vals
    assign[2::3] = c_vals

    primary_size = 3 * num_public_gates
    comp = CompiledR1CS(
        ctx=ctx,
        num_constraints=m,
        num_variables=nv,
        primary_input_size=primary_size,
        rows=(jnp.asarray(rows), jnp.asarray(rows), jnp.asarray(rows)),
        cols=(jnp.asarray(cols_a), jnp.asarray(cols_b), jnp.asarray(cols_c)),
        coeffs=(ones, ones, ones),
    )
    primary = RingElem(ctx, jnp.asarray(assign[:primary_size]))
    auxiliary = RingElem(ctx, jnp.asarray(assign[primary_size:]))
    return comp, primary, auxiliary


def _device_square_chain(ctx: RingContext, x0: np.ndarray, nv: int):
    """[nv, L, n] squaring-chain assignment computed on device.

    Row i is x0^(2^i) slot-wise.  Exponents are reduced mod (p-1) on host
    (Fermat), then applied as a masked product over the 31 squared-basis
    arrays.  Exact for slot value 0 only when the reduced exponent is never
    0, i.e. when p-1 is NOT a power of two (asserted below; a Fermat prime
    limb would make a zero slot compute the empty product 1).  Avoids both
    a host-to-device transfer of the full assignment and a length-nv
    lax.scan compile.
    """
    import jax.numpy as jnp

    for q in ctx.primes:
        assert (q - 1) & (q - 2), (
            f"limb {q}: q-1 is a power of two (Fermat prime); the reduced "
            "exponent 2^i mod (q-1) can hit 0 and break zero slots"
        )
    L, n = x0.shape
    p, mu, pb = ctx.p, ctx.mu, ctx.pbits
    exps = np.zeros((nv, L), dtype=np.uint64)
    for l, q in enumerate(ctx.primes):
        e = 1
        for i in range(nv):
            exps[i, l] = e
            e = (e * 2) % (q - 1)
    nbits = max(int(q).bit_length() for q in ctx.primes)

    # squared bases x0^(2^b): [nbits, L, n] — tiny; computed eagerly once
    bases = [jnp.asarray(x0)]
    for b in range(1, nbits):
        bases.append(mul_mod(bases[-1], bases[-1], p, mu, pb))
    bases = jnp.stack(bases)

    @jax.jit
    def chunk_fn(bits_c):  # [rows, L, nbits] uint32 -> [rows, L, n]
        acc = None
        for b in range(nbits):
            term = jnp.where(
                bits_c[:, :, b, None] == 1, bases[b][None], jnp.uint32(1)
            )
            acc = term if acc is None else mul_mod(acc, term, p, mu, pb)
        return acc

    # row chunks under one jit each (same shapes -> one compile): an eager
    # form materializes ~31 full-size intermediates
    bits = np.stack(
        [((exps >> np.uint64(b)) & np.uint64(1)).astype(np.uint32)
         for b in range(nbits)], axis=-1,
    )  # [nv, L, nbits]
    rows = max(1, min(nv, (64 << 20) // max(1, L * n * 4)))
    pad = (-nv) % rows
    if pad:
        bits = np.concatenate([bits, bits[:pad]], axis=0)
    outs = [
        chunk_fn(jnp.asarray(bits[lo : lo + rows]))
        for lo in range(0, bits.shape[0], rows)
    ]
    acc = jnp.concatenate(outs, axis=0)[:nv] if len(outs) > 1 else outs[0][:nv]
    return acc


def build_synthetic_square_chain(
    ctx: RingContext,
    num_constraints: int,
    rng: np.random.Generator,
    num_public: int = 1,
):
    """Returns (compiled_r1cs, primary, auxiliary) for the squaring chain
    x_{i+1} * x_{i+1} = x_{i+2} (constraint i, 0-based; variables 1-based).

    The CRS-minimal prover benchmark shape: num_variables = M + 1 (vs 3M for
    the mul chain), so the groth16 CRS is ~3(M+1) encodings.
    """
    m = num_constraints
    nv = m + 1
    rows = np.arange(m, dtype=np.int32)
    cols_a = (rows + 1).astype(np.int32)
    cols_c = (rows + 2).astype(np.int32)
    ones = jnp.ones((m, ctx.L, 1), dtype=jnp.uint32)

    n = ctx.N
    x0 = np.stack(
        [rng.integers(0, p, n, dtype=np.uint64) for p in ctx.primes]
    ).astype(np.uint32)
    if nv * ctx.L * n * 4 > (64 << 20):
        # Rq scale: [nv, L, n] is hundreds of MB.  Generate on device
        # instead of shipping a host build: row i = x0^(2^i) as a batched
        # modpow with host-reduced exponents (2^i mod (p-1) per limb) — 31
        # unrolled squarings + 31 masked multiplies, no length-nv scan.
        assign = _device_square_chain(ctx, x0, nv)
    else:
        # host numpy chain (slot form -> elementwise square mod p per limb):
        # no length-nv lax.scan to compile; <1s even at 2^18 and
        # bit-identical (p < 2^31 so x*x fits u64).
        assign = np.empty((nv, ctx.L, n), dtype=np.uint32)
        assign[0] = x0
        primes = np.asarray(ctx.primes, dtype=np.uint64).reshape(ctx.L, 1)
        x = x0.astype(np.uint64)
        for i in range(1, nv):
            x = (x * x) % primes
            assign[i] = x.astype(np.uint32)
    comp = CompiledR1CS(
        ctx=ctx,
        num_constraints=m,
        num_variables=nv,
        primary_input_size=num_public,
        rows=(jnp.asarray(rows), jnp.asarray(rows), jnp.asarray(rows)),
        cols=(jnp.asarray(cols_a), jnp.asarray(cols_a), jnp.asarray(cols_c)),
        coeffs=(ones, ones, ones),
    )
    primary = RingElem(ctx, jnp.asarray(assign[:num_public]))
    auxiliary = RingElem(ctx, jnp.asarray(assign[num_public:]))
    return comp, primary, auxiliary
