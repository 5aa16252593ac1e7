"""Data-sharded streamed-prover chunk: the Rq 2^16+/multi-chip schedule.

The streamed provers (snark/streamed.py) are bounded on one chip by the
witness/CRS row vectors (~5.4 GiB/limb at Rq 2^15; 2x per doubling of M).
The scale-out axis is 'data' (DESIGN.md §5): shard the chunk's row axis
across devices — each device encodes its row shard, regenerates its c1
slabs (the PRNG slab index is offset by the shard's global position, so
every slab's randomness matches the unsharded kernel), and runs the local
u64-lazy MAC scan; ONE [L', N'] u64 psum per inner product crosses the
mesh.  The u64 partial sums are exact and order-independent, so the
reduced result is BIT-IDENTICAL to the single-device kernel
(asserted in tests/test_parallel.py and exercised by
`__graft_entry__.dryrun_multichip`).

Communication per chunk: n_pts * 2 psums of [L, L', N'] u64 — at the
reference shape (L'=4, N'=16384) that is ~1 MiB per inner product;
everything else is device-local.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..encoding import Encoding
from ..encoding.context import EncodingContext, SecretKey
from ..ops.modops import barrett_reduce_u64
from ..snark import seeded as sd

__all__ = ["stream_chunk_ip_sharded"]


def stream_chunk_ip_sharded(
    mesh: Mesh,
    ectx: EncodingContext,
    sk: SecretKey,
    rows,  # [chunk, L, n] CRS ring rows (chunk % (D*slab) == 0)
    pts: list,  # [chunk, L, n] coefficient batches
    key,
    slab: int,
) -> list:
    """Encode-and-MAC one streamed chunk with rows sharded over 'data'.

    Each device encodes rows[d*local : (d+1)*local] under slab keys
    fold_in(key, d*nslab_local + i) — exactly the slabs the unsharded
    `encode_seeded` + `_seeded_mac_kernel` pair would produce — then psums
    the exact u64 accumulators.  Returns level-0 partial-sum Encodings,
    bit-identical to the single-device chunk.
    """
    D = mesh.shape["data"]
    chunk = rows.shape[0]
    assert chunk % (D * slab) == 0, (chunk, D, slab)
    ns_local = chunk // (D * slab)
    n_pts = len(pts)

    row_spec = P("data")
    rep = P()
    rows_sh = jax.device_put(rows, NamedSharding(mesh, row_spec))
    pts_sh = [
        jax.device_put(pt, NamedSharding(mesh, row_spec)) for pt in pts
    ]

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(row_spec, tuple([row_spec] * n_pts)),
        out_specs=tuple([(rep, rep)] * n_pts),
    )
    def body(rows_loc, pts_loc):
        d = jax.lax.axis_index("data")
        slab0 = d * ns_local
        # local encode: same per-slab kernel as encode_seeded, slab keys
        # offset to the shard's global slab ids
        dense = ectx.ring.N > 1
        data_loc = (
            sd._pre_ntt_kernel.__wrapped__(ectx, rows_loc)
            if dense else rows_loc
        )
        c0s = []
        for i in range(ns_local):
            c0s.append(
                sd._encode_slab_kernel.__wrapped__(
                    ectx, sk.s_ntt,
                    data_loc[i * slab : (i + 1) * slab],
                    jax.random.fold_in(key, slab0 + i), dense,
                )
            )
        c0_loc = jnp.concatenate(c0s, axis=0) if len(c0s) > 1 else c0s[0]
        pts_in = tuple(
            sd._pre_ntt_kernel.__wrapped__(ectx, pt) if dense else pt
            for pt in pts_loc
        )
        mode = "dense" if dense else "u64"
        accs = sd._mac_accs_u64(
            ectx, c0_loc, key, pts_in, slab, mode, slab0=slab0,
            vary_axes=("data",),
        )
        return tuple(
            (
                jax.lax.psum(a0, "data"),
                jax.lax.psum(a1, "data"),
            )
            for a0, a1 in accs
        )

    accs = body(rows_sh, tuple(pts_sh))
    p, mu, b = ectx.inner_consts(0)
    return [
        Encoding(
            ectx,
            barrett_reduce_u64(a0, p, mu, b),
            barrett_reduce_u64(a1, p, mu, b),
            0,
        )
        for a0, a1 in accs
    ]
