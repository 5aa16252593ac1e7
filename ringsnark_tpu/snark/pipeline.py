"""Single-graph jitted prover cores.

The object-level provers in rinocchio.py/groth16.py orchestrate a handful of
jitted kernels; these pipelines fuse the whole prover (witness map + all
encoding inner products) into ONE jit-compiled function of raw arrays — the
unit the benches, the sharded multi-device path (parallel/) and the
compile checks of `__graft_entry__.py` use.

Statics: (domain, enc_ctx, use_modswitch).  CRS and assignments are pytrees
of arrays, so sharding annotations on the inputs propagate through the whole
graph under GSPMD.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..encoding.context import EncodingContext
from ..encoding.encoding import Encoding, inner_product
from ..reductions.r1cs_to_qrp import _witness_map_kernel
from ..relations.r1cs import CompiledR1CS
from ..rings.elem import RingElem
from ..utils.domain import RootsDomain

__all__ = ["groth16_core", "groth16_ip_core", "groth16_proof_levels",
           "rinocchio_core", "PAD_QUANTUM"]

# Inner-product batches are zero-padded to a multiple of this so the batch
# axis is evenly shardable over the 'data' mesh axis (zero coefficients make
# padded terms exact no-ops).  Single-chip and sharded paths use the same
# padding, so proofs are bit-identical across mesh sizes up to PAD_QUANTUM.
PAD_QUANTUM = 8


def _pad_len(n: int) -> int:
    return -(-n // PAD_QUANTUM) * PAD_QUANTUM


def _pad_batch(arr, target: int):
    if arr.shape[0] == target:
        return arr
    pad = [(0, target - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return jnp.pad(arr, pad)


def _ip_levels(ectx: EncodingContext, B: int, use_modswitch: bool) -> int:
    """Static result level of inner_product for a batch of size B."""
    max_level = max(ectx.L_inner - ectx.floor_limbs, 0)
    if not use_modswitch or max_level == 0:
        return 0
    return max_level


def groth16_proof_levels(ectx: EncodingContext, use_modswitch: bool):
    lvl = _ip_levels(ectx, 0, use_modswitch)
    return (lvl, lvl, lvl)


@partial(jax.jit, static_argnames=("M", "ectx", "ums"))
def groth16_ip_core(
    crs: dict,
    a_full, b_full, H,
    aux_values,
    M: int,
    ectx: EncodingContext,
    ums: bool,
):
    """The inner-product half of the prover (post witness map) as one jitted
    graph — shared by the single-chip core and the coeff-sharded prover
    (which runs its witness map under a shard_map first)."""
    ctx = ectx.ring
    B = _pad_len(M + 1)

    def enc(pair, n: int):
        c0, c1 = pair
        return Encoding(ectx, _pad_batch(c0, n), _pad_batch(c1, n), 0)

    def ip(e, arr, n):
        return inner_product(
            e, RingElem(ctx, _pad_batch(arr, n)), use_modswitch=ums
        )

    sp = enc(crs["s_pows"], B)
    alpha_1 = Encoding(ectx, crs["alpha"][0], crs["alpha"][1], 0)
    beta_1 = Encoding(ectx, crs["beta"][0], crs["beta"][1], 0)
    a_enc = ip(sp, a_full, B) + alpha_1
    b_enc = ip(sp, b_full, B) + beta_1
    c_enc = ip(enc(crs["delta_ts"], B), H, B)
    if aux_values is not None and aux_values.shape[0] > 0:
        Ba = _pad_len(aux_values.shape[0])
        c_enc = c_enc + ip(enc(crs["delta_mid"], Ba), aux_values, Ba)

    return (
        (a_enc.c0, a_enc.c1),
        (b_enc.c0, b_enc.c1),
        (c_enc.c0, c_enc.c1),
    )


@partial(jax.jit, static_argnames=("domain", "ectx", "ums"))
def groth16_core(
    comp: CompiledR1CS,
    crs: dict,
    z_full, z_io, z_mid,
    aux_values,  # uint32[n_aux, L, n] (n_aux may be 0)
    domain: RootsDomain,
    ectx: EncodingContext,
    ums: bool,
):
    """The full ringGroth16 prover as one jitted graph.

    crs: {"s_pows": (c0, c1), "delta_ts": (c0, c1), "delta_mid": (c0, c1)|None,
          "alpha": (c0, c1), "beta": (c0, c1)}
    Returns ((A_c0, A_c1), (B_c0, B_c1), (C_c0, C_c1)) — levels are static,
    see `groth16_proof_levels`.
    """
    ctx = comp.ctx
    zero = jnp.zeros((ctx.L, 1), dtype=jnp.uint32)
    (a_io, b_io, c_io, a_mid, b_mid, c_mid, Z, H) = _witness_map_kernel(
        comp, z_full, z_io, z_mid, zero, zero, zero, domain
    )
    from ..ops.modops import add_mod

    a_full = add_mod(a_io, a_mid, ctx.p)
    b_full = add_mod(b_io, b_mid, ctx.p)
    return groth16_ip_core(
        crs, a_full, b_full, H, aux_values, domain.m, ectx, ums
    )


@partial(jax.jit, static_argnames=("domain", "ectx", "ums", "use_zk"))
def rinocchio_core(
    comp: CompiledR1CS,
    crs: dict,  # {"s_pows": (c0,c1), "alpha_s_pows": (c0,c1), "beta_prods": (c0,c1)|None}
    z_full, z_io, z_mid,
    aux_values,
    d1r, d2r, d3r,
    domain: RootsDomain,
    ectx: EncodingContext,
    ums: bool,
    use_zk: bool,
):
    """The Rinocchio prover's 8 main proof elements as one jitted graph
    (F's d-shift terms use single fresh encodings and stay in the object
    layer)."""
    ctx = comp.ctx
    (a_io, b_io, c_io, a_mid, b_mid, c_mid, Z, H) = _witness_map_kernel(
        comp, z_full, z_io, z_mid, d1r, d2r, d3r, domain
    )
    M = domain.m
    B = _pad_len(M + 1)
    from ..ops.modops import sub_mod

    def enc(pair, n: int):
        c0, c1 = pair
        return Encoding(ectx, _pad_batch(c0, n), _pad_batch(c1, n), 0)

    def ip(e, arr, n):
        return inner_product(
            e, RingElem(ctx, _pad_batch(arr, n)), use_modswitch=ums
        )

    def shifted(coeffs, dr):
        head = sub_mod(coeffs[0], dr, ctx.p)[None]
        tail = jnp.broadcast_to(dr[None], (1, *coeffs.shape[1:]))
        return jnp.concatenate([head, coeffs[1:], tail], axis=0)

    sp, asp = enc(crs["s_pows"], B), enc(crs["alpha_s_pows"], B)
    if use_zk:
        a_vec, b_vec, c_vec = (
            shifted(a_mid, d1r), shifted(b_mid, d2r), shifted(c_mid, d3r)
        )
        outs = [
            ip(sp, a_vec, B), ip(asp, a_vec, B),
            ip(sp, b_vec, B), ip(asp, b_vec, B),
            ip(sp, c_vec, B), ip(asp, c_vec, B),
        ]
    else:
        outs = [
            ip(sp, a_mid, B), ip(asp, a_mid, B),
            ip(sp, b_mid, B), ip(asp, b_mid, B),
            ip(sp, c_mid, B), ip(asp, c_mid, B),
        ]
    outs.append(ip(sp, H, B))
    outs.append(ip(asp, H, B))
    f = None
    if aux_values is not None and aux_values.shape[0] > 0:
        Ba = _pad_len(aux_values.shape[0])
        f = ip(enc(crs["beta_prods"], Ba), aux_values, Ba)
    res = tuple((o.c0, o.c1) for o in outs)
    return res, (None if f is None else (f.c0, f.c1))
