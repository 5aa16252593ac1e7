"""Seeded-CRS ringGroth16: HBM-resident c0, PRNG-regenerated c1, scan MAC.

The north-star configuration (2^16..2^18 constraints) makes the CRS the
memory problem: each E(s^i) is a full inner ciphertext, so even c0 alone is
gigabytes.  Three design moves make large M fit a single chip (DESIGN.md §8):

* **seeded ciphertexts** — in symmetric BGV the second component c1 = a is
  uniform, so it is stored as a PRNG key and regenerated on device inside the
  prover kernel (SEAL ships the same trick for its public keys /
  serializable ciphertexts).  Halves CRS residency and host<->device bytes.
* **slab scan** — the prover's inner products run as a `lax.scan` over fixed
  slabs of the CRS batch axis, so peak memory is one slab of temporaries,
  not the 4D product array.  The lazy u64 accumulation is exact, and the
  canonical Barrett reduction at the end makes the result bit-identical to
  the unseeded `encoding.inner_product` path regardless of slab size.
* **level-0 accumulation** — see `encoding.inner_product`: the modswitch
  schedule runs once on the final sums, never per term.

Mirrors the CRS/proof structure of `/root/reference/ringsnark/
zk_proof_systems/groth16/groth16.tcc:5-115`; the streaming layout replaces
the reference's in-RAM `vector<EncT>` CRS.

PRNG convention: slab i of an encoding batch draws its randomness from
`fold_in(key, i)`, split exactly as `bgv._encrypt_kernel` splits — so c1 of
slab i is `_sample_uniform(ctx, split(fold_in(key, i))[0], (slab,))`.  Any
typed key impl works; the benches and chip_smoke.py pass
`jax.random.key(seed, impl='threefry2x32')`.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..encoding import Encoding, encode, keygen
from ..encoding.bgv import (
    _encrypt_from_m,
    _encrypt_kernel,
    _lift_centered,
    _sample_uniform,
    plain_to_inner_ntt,
)
from ..encoding.context import EncodingContext
from ..ops.modops import mul_mod, add_mod, barrett_reduce_u64
from ..reductions.r1cs_to_qrp import (
    r1cs_to_qrp_instance_map_with_evaluation,
    _pa_batches,
    prover_witness_map_chunked,
)
from ..relations.r1cs import CompiledR1CS
from ..rings.elem import RingElem
from ..utils.domain import RootsDomain
from ..utils.poly_arr import ring_batch_scale
from .api import KeyPair, SnarkParams
from .groth16 import Proof, VerificationKey
from .pipeline import groth16_proof_levels

__all__ = [
    "SeededEncoding",
    "SeededProvingKey",
    "encode_seeded",
    "seeded_inner_product",
    "generator_seeded",
    "prover_seeded",
]

DEFAULT_SLAB = 4096


def _slab_c1_key(key, i):
    """The c1 (= uniform a) key for slab i, matching _encrypt_kernel's split."""
    return jax.random.split(jax.random.fold_in(key, i))[0]


@dataclass
class SeededEncoding:
    """A CRS encoding batch with only c0 materialized.

    c0: uint32[B_pad, L, L', N'] (B_pad a multiple of `slab`); c1 of slab i is
    regenerated from the key (see module docstring).  `batch` is the true
    (unpadded) length; padded rows are encryptions of 0 and are always paired
    with zero plaintext coefficients in the MACs.
    """

    ctx: EncodingContext
    c0: Any
    key: Any
    slab: int
    batch: int
    level: int = 0

    @property
    def nslab(self) -> int:
        return self.c0.shape[0] // self.slab

    def expand(self) -> Encoding:
        """Materialize the full (c0, c1) Encoding — tests / small scales."""
        c1 = _expand_c1(self.ctx, self.key, self.slab, self.nslab)
        return Encoding(
            self.ctx, self.c0[: self.batch], c1[: self.batch], self.level
        )

    def size_in_bits(self) -> int:
        """Stored size: c0 only (c1 is the key)."""
        return self.ctx.size_in_bits(self.batch, self.level) // 2


@partial(jax.jit, static_argnames=("ctx", "slab", "nslab"))
def _expand_c1(ctx: EncodingContext, key, slab: int, nslab: int):
    def step(_, i):
        return None, _sample_uniform(ctx, _slab_c1_key(key, i), (slab,))

    _, c1 = jax.lax.scan(step, None, jnp.arange(nslab))
    return c1.reshape(nslab * slab, ctx.L, ctx.L_inner, ctx.n_inner)


def _pad_slab(arr, slab: int):
    B = arr.shape[0]
    tgt = -(-B // slab) * slab
    if tgt == B:
        return arr
    return jnp.pad(arr, [(0, tgt - B)] + [(0, 0)] * (arr.ndim - 1))


@partial(jax.jit, static_argnames=("ctx", "dense"))
def _encode_slab_kernel(ctx: EncodingContext, s_ntt, data_i, key,
                        dense: bool):
    """c0 of one slab (c1 discarded — regenerated from the key by the MAC)."""
    if dense:
        c0, _c1 = _encrypt_from_m(ctx, s_ntt, data_i, key)
    else:
        c0, _c1 = _encrypt_kernel(ctx, s_ntt, data_i, key)
    return c0


def _encode_seeded_kernel(ctx: EncodingContext, s_ntt, data_pad, key,
                          slab: int, nslab: int):
    # Python loop over slabs, ONE jitted per-slab kernel reused: one small
    # compiled program, and device memory holds one slab's encryption
    # temporaries at a time; dispatches queue asynchronously, so the loop
    # adds no sync.  Slab i draws from fold_in(key, i) — c1 regeneration in
    # the MAC is bit-identical.
    #
    # dense rings: data_pad is the PRE-TRANSFORMED [B, L, L', N'] operand
    # (see `_pre_ntt_kernel`); scalar path: the raw [B, L, 1] slot batch
    # (the NTT-free broadcast happens inside the kernel, so the full
    # [B, L, L', N'] plaintext operand is never materialized in HBM).
    dense = ctx.ring.N > 1
    c0s = [
        _encode_slab_kernel(
            ctx, s_ntt, data_pad[i * slab : (i + 1) * slab],
            jax.random.fold_in(key, i), dense,
        )
        for i in range(nslab)
    ]
    return jnp.concatenate(c0s, axis=0) if len(c0s) > 1 else c0s[0]


def encode_seeded(
    ctx: EncodingContext, sk, rs: RingElem, key, slab: int = DEFAULT_SLAB
) -> SeededEncoding:
    """Encrypt a RingElem batch slab-by-slab, keeping only c0 (+ the key)."""
    slots = rs.res
    B = slots.shape[0]
    slab = min(slab, max(8, B))
    slots_pad = _pad_slab(slots, slab)
    nslab = slots_pad.shape[0] // slab
    data_pad = _pre_ntt_kernel(ctx, slots_pad) if ctx.ring.N > 1 else slots_pad
    c0 = _encode_seeded_kernel(ctx, sk.s_ntt, data_pad, key, slab, nslab)
    return SeededEncoding(ctx=ctx, c0=c0, key=key, slab=slab, batch=B)


# ---------------------------------------------------------------------------
# scan MAC
# ---------------------------------------------------------------------------
#
# u64-emulated Barrett products with exact u64 lazy sums, for any plaintext
# shape.  Two modes share the scan body: "u64" takes plaintext slots and
# transforms each term inside the scan (scalar Z_q plaintexts need no
# transform: `plain_to_inner_ntt` broadcasts them); "dense" takes the
# pre-transformed [B, L, L', N'] operand of the polynomial rings.


@partial(jax.jit, static_argnames=("ctx", "slab", "mode"))
def _seeded_mac_kernel(ctx: EncodingContext, c0, key, pts, slab: int,
                       mode: str = "u64"):
    """sum_i E_i * r_i at level 0 for several plaintext batches sharing one
    CRS.

    c0: [B_pad, L, L', N']; pts: tuple of [B_pad, L, n] slot arrays (zero
    rows beyond each true batch).  Returns tuple of (acc0, acc1) uint32
    [L, L', N'] — bit-identical to Encoding.sum_batch of the expanded path
    (canonical residues; u64 sums exact for B < 2^33).
    """
    p, mu, b = ctx.inner_consts(0)
    accs = _mac_accs_u64(ctx, c0, key, pts, slab, mode)
    return tuple(
        (
            barrett_reduce_u64(a0, p, mu, b),
            barrett_reduce_u64(a1, p, mu, b),
        )
        for a0, a1 in accs
    )


def _mac_accs_u64(ctx, c0, key, pts, slab: int, mode: str, slab0=None,
                  vary_axes=None):
    """The u64-lazy scan accumulators BEFORE the final Barrett.

    Exposed separately so the data-sharded streamed path can psum the exact
    u64 partial sums across devices and reduce once (bit-identical to one
    device for total batches < 2^33).  `slab0` (traced scalar, default 0)
    offsets the PRNG slab index so a device holding rows [lo, hi) of the
    global batch regenerates exactly the same c1 slabs as the unsharded
    kernel (DESIGN.md §5 'data' axis).
    """
    B_pad = c0.shape[0]
    nslab = B_pad // slab
    Lp = ctx.L_inner
    c0r = c0.reshape(nslab, slab, *c0.shape[1:])
    ptsr = tuple(pt.reshape(nslab, slab, *pt.shape[1:]) for pt in pts)
    p, mu, b = ctx.inner_consts(0)
    base = 0 if slab0 is None else slab0

    def step_u64(accs, xs):
        i, c0s = xs[0], xs[1]
        pt_slabs = xs[2:]
        c1s = _sample_uniform(ctx, _slab_c1_key(key, base + i), (slab,))
        out = []
        for (a0, a1), pt_slots in zip(accs, pt_slabs):
            if mode == "dense":
                ptntt = pt_slots  # already [S, L, L', N'] operand form
            else:
                ptntt = plain_to_inner_ntt(ctx, pt_slots)  # [S, L, L', N']
            pr0 = mul_mod(c0s, ptntt, p, mu, b)
            pr1 = mul_mod(c1s, ptntt, p, mu, b)
            out.append(
                (
                    a0 + jnp.sum(pr0.astype(jnp.uint64), axis=0),
                    a1 + jnp.sum(pr1.astype(jnp.uint64), axis=0),
                )
            )
        return tuple(out), None

    zero = jnp.zeros((ctx.L, Lp, ctx.n_inner), dtype=jnp.uint64)
    if vary_axes:  # under shard_map the carry must be device-varying
        zero = jax.lax.pcast(zero, vary_axes, to="varying")
    init = tuple((zero, zero) for _ in range(len(pts)))
    accs, _ = jax.lax.scan(step_u64, init, (jnp.arange(nslab), c0r) + ptsr)
    return accs


@partial(jax.jit, static_argnames=("ctx",))
def _pre_ntt_kernel(ctx: EncodingContext, slots):
    return plain_to_inner_ntt(ctx, slots, level=0)


def seeded_inner_product(
    senc: SeededEncoding, pts: list, use_modswitch: bool = True
) -> list:
    """Inner products of one seeded CRS batch against several plaintext
    coefficient batches ([B, L, n] arrays); same schedule/result as
    `encoding.inner_product` on the expanded CRS."""
    ctx = senc.ctx
    B_pad = senc.c0.shape[0]

    def pad_to(arr):
        # coefficient batches may be shorter than the CRS batch (e.g. the
        # degree-M A/B polynomials have M coefficients vs M+1 powers of s);
        # zero rows make the extra CRS terms exact no-ops.
        assert arr.shape[0] <= B_pad, (arr.shape, senc.c0.shape)
        if arr.shape[0] == B_pad:
            return arr
        return jnp.pad(
            arr, [(0, B_pad - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
        )

    pts_pad = tuple(pad_to(p.astype(jnp.uint32)) for p in pts)
    mode = "u64"
    if ctx.ring.N > 1:
        # dense (poly-ring) plaintexts: hoist the per-term NTTs out of the
        # scan into one batched transform
        pts_pad = tuple(_pre_ntt_kernel(ctx, p_) for p_ in pts_pad)
        mode = "dense"
    accs = _seeded_mac_kernel(ctx, senc.c0, senc.key, pts_pad, senc.slab, mode)
    outs = []
    max_level = max(ctx.L_inner - ctx.floor_limbs, 0) if use_modswitch else 0
    for a0, a1 in accs:
        e = Encoding(ctx, a0, a1, 0)
        for _ in range(max_level):
            e = e.modswitch()
        outs.append(e)
    return outs


# ---------------------------------------------------------------------------
# generator / prover
# ---------------------------------------------------------------------------


@dataclass
class SeededProvingKey:
    """groth16 CRS with the three big batches seeded (groth16.hpp:10-48)."""

    compiled: CompiledR1CS
    domain: RootsDomain
    params: SnarkParams
    alpha: Encoding
    beta: Encoding
    s_pows: SeededEncoding
    gamma_io: Encoding
    delta_mid: Optional[SeededEncoding]
    delta_ts: SeededEncoding
    pk_enc: Any = None
    constraint_system: Any = None

    def size_in_bits(self) -> int:
        total = self.alpha.size_in_bits() + self.beta.size_in_bits()
        total += self.gamma_io.size_in_bits()
        for e in (self.s_pows, self.delta_mid, self.delta_ts):
            if e is not None:
                total += e.size_in_bits()
        return total


def generator_seeded(
    cs,
    params: SnarkParams,
    rng: np.random.Generator,
    key,
    slab: int = DEFAULT_SLAB,
) -> KeyPair:
    """Trusted setup with seeded CRS batches (`groth16.tcc:5-67` semantics)."""
    ctx = params.ring
    if isinstance(cs, CompiledR1CS):
        comp, cs_obj = cs, None
        n_constraints = comp.num_constraints
        primary_size = comp.primary_input_size
        n_aux = comp.num_variables - primary_size
    else:
        comp, cs_obj = cs.compile(ctx), cs
        n_constraints = cs.num_constraints()
        primary_size = cs.primary_input_size
        n_aux = cs.auxiliary_input_size
    domain = RootsDomain(ctx, max(n_constraints, 1))
    s = RingElem.random_exceptional_element(ctx, rng, domain)
    qrp = r1cs_to_qrp_instance_map_with_evaluation(comp, s, domain)

    pk_enc, sk_enc = keygen(params.enc, rng)
    alpha = RingElem.random_invertible_element(ctx, rng)
    beta = RingElem.random_invertible_element(ctx, rng)
    gamma = RingElem.random_invertible_element(ctx, rng)
    delta = RingElem.random_invertible_element(ctx, rng)
    gamma_inv = gamma.inverse()
    delta_inv = delta.inverse()

    s_pows_ring = qrp.Ht  # [M+1, L, 1]
    delta_ts_ring = ring_batch_scale(
        ring_batch_scale(s_pows_ring, qrp.Zt), delta_inv
    )
    combo = (
        ring_batch_scale(qrp.At, beta)
        + ring_batch_scale(qrp.Bt, alpha)
        + qrp.Ct
    )
    n_io = primary_size + 1
    gamma_io_ring = ring_batch_scale(RingElem(ctx, combo.res[:n_io]), gamma_inv)

    keys = jax.random.split(key, 6)
    alpha_enc = encode(params.enc, sk_enc, RingElem.stack([alpha]), keys[0])[0]
    beta_enc = encode(params.enc, sk_enc, RingElem.stack([beta]), keys[1])[0]
    s_pows = encode_seeded(params.enc, sk_enc, s_pows_ring, keys[2], slab)
    gamma_io = encode(params.enc, sk_enc, gamma_io_ring, keys[3])
    delta_mid = None
    if n_aux > 0:
        delta_mid_ring = ring_batch_scale(
            RingElem(ctx, combo.res[n_io:]), delta_inv
        )
        delta_mid = encode_seeded(params.enc, sk_enc, delta_mid_ring, keys[4], slab)
    delta_ts = encode_seeded(params.enc, sk_enc, delta_ts_ring, keys[5], slab)

    pk = SeededProvingKey(
        compiled=comp, domain=domain, params=params,
        alpha=alpha_enc, beta=beta_enc, s_pows=s_pows, gamma_io=gamma_io,
        delta_mid=delta_mid, delta_ts=delta_ts, pk_enc=pk_enc,
        constraint_system=cs_obj,
    )
    vk = VerificationKey(pk=pk, s=s, alpha=alpha, beta=beta, gamma=gamma,
                         delta=delta, sk_enc=sk_enc)
    return KeyPair(pk=pk, vk=vk)


def prover_seeded(
    pk: SeededProvingKey,
    primary_input,
    auxiliary_input,
    rng: np.random.Generator | None = None,
) -> Proof:
    """Prove (`groth16.tcc:69-115`, non-ZK like the reference): witness map
    (one jit) + two scan-MAC passes (s_pows shared by A and B; delta_ts + H
    and delta_mid + aux) + the final modswitch chain."""
    ctx = pk.params.ring
    ectx = pk.params.enc
    ums = pk.params.use_modswitch
    # lazy prover-mode witness map (3 of 9 SpMV+iNTT legs by linearity;
    # see reductions.r1cs_to_qrp.prover_witness_map_chunked)
    p_res, a_res = _pa_batches(ctx, primary_input, auxiliary_input)
    (a_full, b_full, H) = prover_witness_map_chunked(
        pk.compiled, p_res, a_res, pk.domain
    )

    A_ip, B_ip = seeded_inner_product(pk.s_pows, [a_full, b_full], ums)
    (C_ip,) = seeded_inner_product(pk.delta_ts, [H], ums)
    a_enc = A_ip + pk.alpha
    b_enc = B_ip + pk.beta
    c_enc = C_ip
    aux_arr = a_res if a_res.shape[0] > 0 else None
    if aux_arr is not None and pk.delta_mid is not None:
        (mid_ip,) = seeded_inner_product(pk.delta_mid, [aux_arr], ums)
        c_enc = c_enc + mid_ip
    return Proof(A=a_enc, B=b_enc, C=c_enc)
