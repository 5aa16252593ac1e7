"""Rinocchio: designated-verifier zkSNARK for ring arithmetic.

Mirrors `/root/reference/ringsnark/zk_proof_systems/rinocchio/rinocchio.tcc`
(protocol of Ganesh–Nitulescu–Soria-Vazquez, eprint 2021/322, per the
companion spec docs/Rinocchio.pdf): CRS of encoded s-powers and lincheck
terms, 9-element proof (A, A', B, B', C, C', D, D', F), 6 verifier checks.

Batched design: all CRS vectors are single `Encoding`/`RingElem` batches; the
prover's 10 OpenMP-section inner products (`rinocchio.tcc:106-163`) become
batched multiply-accumulate kernels with the staged modswitch schedule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import jax

from ..encoding import Encoding, encode, decode, inner_product, keygen
from ..reductions.r1cs_to_qrp import (
    r1cs_to_qrp_instance_map_with_evaluation,
    r1cs_to_qrp_witness_map,
)
from ..relations.r1cs import R1CSConstraintSystem, CompiledR1CS
from ..rings.elem import RingElem
from ..utils.domain import RootsDomain
from ..utils.poly_arr import ring_batch_scale
from .api import KeyPair, SnarkParams

__all__ = ["ProvingKey", "VerificationKey", "ProcessedVerificationKey", "Proof",
           "generator", "prover", "verifier", "verifier_process", "online_verifier"]


@dataclass
class ProvingKey:
    """CRS (rinocchio.hpp:10-58).  `alpha_rv_ts`..`ry_ys` are carried for
    CRS-shape parity though unused by this prover (reference marks them
    "Unused?", rinocchio.hpp:18-19)."""

    constraint_system: R1CSConstraintSystem
    compiled: CompiledR1CS
    domain: RootsDomain
    params: SnarkParams
    s_pows: Encoding  # [M+1] E(s^i)
    alpha_s_pows: Encoding  # [M+1] E(alpha s^i)
    beta_prods: Optional[Encoding]  # [aux] E(beta(r_v v_k + r_w w_k + r_y y_k)(s))
    beta_rv_ts: Optional[Encoding]  # E(beta Z(s) r_v)
    beta_rw_ts: Optional[Encoding]
    beta_ry_ts: Optional[Encoding]
    alpha_rv_ts: Optional[Encoding]
    alpha_rw_ts: Optional[Encoding]
    alpha_ry_ts: Optional[Encoding]
    rv_vs: Optional[Encoding]
    rw_ws: Optional[Encoding]
    ry_ys: Optional[Encoding]
    pk_enc: Any = None

    def size_in_bits(self) -> int:
        total = 0
        for e in (self.s_pows, self.alpha_s_pows, self.beta_prods,
                  self.beta_rv_ts, self.beta_rw_ts, self.beta_ry_ts,
                  self.alpha_rv_ts, self.alpha_rw_ts, self.alpha_ry_ts,
                  self.rv_vs, self.rw_ws, self.ry_ys):
            if e is not None:
                total += e.size_in_bits()
        return total


@dataclass
class VerificationKey:
    """Designated-verifier key: trapdoors + decoding key (rinocchio.hpp:61-97)."""

    pk: ProvingKey
    s: RingElem
    alpha: RingElem
    beta: RingElem
    r_v: RingElem
    r_w: RingElem
    r_y: RingElem
    sk_enc: Any

    def size_in_bits(self) -> int:
        return self.pk.size_in_bits()


@dataclass
class Proof:
    """9 encodings (rinocchio.hpp:117-146); F is None when there are no
    auxiliary inputs (non-ZK mode, rinocchio.tcc:177-185 / 200-205)."""

    A: Encoding
    A_prime: Encoding
    B: Encoding
    B_prime: Encoding
    C: Encoding
    C_prime: Encoding
    D: Encoding
    D_prime: Encoding
    F: Optional[Encoding]

    def size_in_bits(self) -> int:
        total = 0
        for e in (self.A, self.A_prime, self.B, self.B_prime, self.C,
                  self.C_prime, self.D, self.D_prime, self.F):
            if e is not None:
                total += e.size_in_bits()
        return total


def generator(
    cs: R1CSConstraintSystem,
    params: SnarkParams,
    rng: np.random.Generator,
    key,
) -> KeyPair:
    """Trusted setup (`rinocchio.tcc:5-72`)."""
    ctx = params.ring
    domain = RootsDomain(ctx, max(cs.num_constraints(), 1))
    comp = cs.compile(ctx)
    s = RingElem.random_exceptional_element(ctx, rng, domain)
    qrp = r1cs_to_qrp_instance_map_with_evaluation(comp, s, domain)

    pk_enc, sk_enc = keygen(params.enc, rng)

    alpha = RingElem.random_invertible_element(ctx, rng)
    r_v = RingElem.random_invertible_element(ctx, rng)
    r_w = RingElem.random_invertible_element(ctx, rng)
    r_y = r_v * r_w
    beta = RingElem.random_nonzero_element(ctx, rng)

    s_pows_ring = qrp.Ht  # [M+1, L, 1] — the monomials 1, s, ..., s^M
    alpha_s_pows_ring = ring_batch_scale(s_pows_ring, alpha)

    n_aux = cs.auxiliary_input_size
    keys = jax.random.split(key, 8)
    s_pows = encode(params.enc, sk_enc, s_pows_ring, keys[0])
    alpha_s_pows = encode(params.enc, sk_enc, alpha_s_pows_ring, keys[1])

    beta_prods = rv_vs = rw_ws = ry_ys = None
    if n_aux > 0:
        aux_slice = slice(cs.primary_input_size + 1, cs.num_variables() + 1)
        At_aux = RingElem(ctx, qrp.At.res[aux_slice])
        Bt_aux = RingElem(ctx, qrp.Bt.res[aux_slice])
        Ct_aux = RingElem(ctx, qrp.Ct.res[aux_slice])
        rv_vs_ring = ring_batch_scale(At_aux, r_v)
        rw_ws_ring = ring_batch_scale(Bt_aux, r_w)
        ry_ys_ring = ring_batch_scale(Ct_aux, r_y)
        lincheck = ring_batch_scale(rv_vs_ring + rw_ws_ring + ry_ys_ring, beta)
        beta_prods = encode(params.enc, sk_enc, lincheck, keys[2])
        rv_vs = encode(params.enc, sk_enc, rv_vs_ring, keys[3])
        rw_ws = encode(params.enc, sk_enc, rw_ws_ring, keys[4])
        ry_ys = encode(params.enc, sk_enc, ry_ys_ring, keys[5])

    beta_Zt = beta * qrp.Zt
    alpha_Zt = alpha * qrp.Zt
    shift_terms = RingElem.stack(
        [beta_Zt * r_v, beta_Zt * r_w, beta_Zt * r_y,
         alpha_Zt * r_v, alpha_Zt * r_w, alpha_Zt * r_y]
    )
    shifts = encode(params.enc, sk_enc, shift_terms, keys[6])

    pk = ProvingKey(
        constraint_system=cs,
        compiled=comp,
        domain=domain,
        params=params,
        s_pows=s_pows,
        alpha_s_pows=alpha_s_pows,
        beta_prods=beta_prods,
        beta_rv_ts=shifts[0],
        beta_rw_ts=shifts[1],
        beta_ry_ts=shifts[2],
        alpha_rv_ts=shifts[3],
        alpha_rw_ts=shifts[4],
        alpha_ry_ts=shifts[5],
        rv_vs=rv_vs,
        rw_ws=rw_ws,
        ry_ys=ry_ys,
        pk_enc=pk_enc,
    )
    vk = VerificationKey(pk=pk, s=s, alpha=alpha, beta=beta,
                         r_v=r_v, r_w=r_w, r_y=r_y, sk_enc=sk_enc)
    return KeyPair(pk=pk, vk=vk)


def prover(
    pk: ProvingKey,
    primary_input: list,
    auxiliary_input: list,
    rng: np.random.Generator | None = None,
) -> Proof:
    """Prove (`rinocchio.tcc:75-190`).

    ZK auto-disables when there are no auxiliary inputs
    (`rinocchio.tcc:81-90`).
    """
    ctx = pk.params.ring
    rng = rng or np.random.default_rng()
    use_zk = len(auxiliary_input) > 0
    zero = RingElem.zero(ctx)
    d1 = RingElem.random_invertible_element(ctx, rng) if use_zk else zero
    d2 = RingElem.random_invertible_element(ctx, rng) if use_zk else zero
    d3 = RingElem.random_invertible_element(ctx, rng) if use_zk else zero

    # The ZK shifts d*Z are folded into the inner-product coefficient vectors
    # (Z = X^M - 1 → [a_0 - d, a_1, ..., a_{M-1}, d]).  The reference instead
    # multiplies the finished (noisy) E(Z(s)) by d (`rinocchio.tcc:167-174`)
    # and leaves this fold as a TODO (`rinocchio.tcc:166`); folding keeps
    # every ciphertext-plaintext multiply on fresh CRS encodings — essential
    # for the 31-bit-limb noise budget and two inner products cheaper.
    #
    # Structure: slot-chunked witness map + per-IP jitted inner products.
    # (The former single-graph `pipeline.rinocchio_core` form remains for the
    # sharded path, but at dense reference shapes — logreg, N=2048 — its one
    # mega-program crashed the remote compiler; the 8 main IPs here share two
    # compiled shapes, so this splits compile cost without warm-time loss.)
    import jax.numpy as jnp
    from ..ops.modops import sub_mod
    from ..reductions.r1cs_to_qrp import (
        _assignment_batches,
        witness_map_kernel_chunked,
    )
    from ..encoding.encoding import inner_product

    ectx = pk.params.enc
    ums = pk.params.use_modswitch
    full, io, mid = _assignment_batches(ctx, primary_input, auxiliary_input)
    (a_io, b_io, c_io, a_mid, b_mid, c_mid, Z, H) = witness_map_kernel_chunked(
        pk.compiled, full.res, io.res, mid.res, d1.res, d2.res, d3.res,
        pk.domain,
    )

    def shifted(coeffs, dr):
        head = sub_mod(coeffs[0], dr, ctx.p)[None]
        tail = jnp.broadcast_to(dr[None], (1, *coeffs.shape[1:])).astype(
            jnp.uint32
        )
        return jnp.concatenate([head, coeffs[1:], tail], axis=0)

    if use_zk:
        vecs = [shifted(a_mid, d1.res), shifted(b_mid, d2.res),
                shifted(c_mid, d3.res), H]
    else:
        vecs = [a_mid, b_mid, c_mid, H]

    B = pk.s_pows.c0.shape[0]

    def pad(arr):
        if arr.shape[0] == B:
            return arr
        return jnp.pad(
            arr, [(0, B - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
        )

    encs = []
    for v in vecs:
        ve = RingElem(ctx, pad(v))
        encs.append(inner_product(pk.s_pows, ve, ums))
        encs.append(inner_product(pk.alpha_s_pows, ve, ums))
    a_enc, alpha_a_enc, b_enc, alpha_b_enc, c_enc, alpha_c_enc, d_enc, alpha_d_enc = encs

    f_enc = None
    if pk.beta_prods is not None and auxiliary_input:
        aux_arr = RingElem.stack(list(auxiliary_input))
        f_enc = inner_product(pk.beta_prods, aux_arr, ums)
        if use_zk:
            # F shift terms multiply single FRESH encodings (level 0)
            f_enc = f_enc + d1 * pk.beta_rv_ts
            f_enc = f_enc + d2 * pk.beta_rw_ts
            f_enc = f_enc + d3 * pk.beta_ry_ts

    return Proof(A=a_enc, A_prime=alpha_a_enc, B=b_enc, B_prime=alpha_b_enc,
                 C=c_enc, C_prime=alpha_c_enc, D=d_enc, D_prime=alpha_d_enc,
                 F=f_enc)


@dataclass
class ProcessedVerificationKey:
    """io-independent verifier precomputation.

    The reference *declares* processed-vk/online-verifier variants but never
    implements them (`r1cs_ppzksnark.hpp:189-252`); here the O(M + nnz)
    instance evaluation at s is done once and reused across verifications.
    """

    vk: VerificationKey
    qrp: Any  # QRPInstanceEvaluation at s


def verifier_process(vk: VerificationKey) -> ProcessedVerificationKey:
    qrp = r1cs_to_qrp_instance_map_with_evaluation(
        vk.pk.compiled, vk.s, vk.pk.domain
    )
    return ProcessedVerificationKey(vk=vk, qrp=qrp)


def verifier(
    vk: VerificationKey,
    primary_input,
    proof: Proof,
) -> bool:
    """Designated verifier (`rinocchio.tcc:193-295`): decode the proof
    elements and run the 6 checks."""
    return online_verifier(verifier_process(vk), primary_input, proof)


def online_verifier(
    pvk: ProcessedVerificationKey,
    primary_input,
    proof: Proof,
) -> bool:
    vk = pvk.vk
    pk = vk.pk
    ctx = pk.params.ring
    enc_ctx = pk.params.enc
    domain = pk.domain

    V_mid = decode(enc_ctx, vk.sk_enc, proof.A)
    V_mid_p = decode(enc_ctx, vk.sk_enc, proof.A_prime)
    W_mid = decode(enc_ctx, vk.sk_enc, proof.B)
    W_mid_p = decode(enc_ctx, vk.sk_enc, proof.B_prime)
    Y_mid = decode(enc_ctx, vk.sk_enc, proof.C)
    Y_mid_p = decode(enc_ctx, vk.sk_enc, proof.C_prime)
    H = decode(enc_ctx, vk.sk_enc, proof.D)
    H_p = decode(enc_ctx, vk.sk_enc, proof.D_prime)
    aux_present = proof.F is not None
    L_beta = decode(enc_ctx, vk.sk_enc, proof.F) if aux_present else None

    qrp = pvk.qrp

    # L = beta (r_v V_mid + r_w W_mid + r_y Y_mid)
    Lc = (V_mid * vk.r_v + W_mid * vk.r_w + Y_mid * vk.r_y) * vk.beta

    # io terms at s: direct weighted sum over the io rows of the processed
    # vk's QRP evaluation (linear in the basis evals — bit-identical to the
    # reference's interpolate-then-evaluate route, `rinocchio.tcc:230-254`,
    # see groth16._io_eval_kernel).
    from .groth16 import _io_terms_at_s

    n_io = pk.compiled.primary_input_size + 1
    v_io, w_io, y_io = _io_terms_at_s(qrp, ctx, n_io, primary_input)

    P = (V_mid + v_io) * (W_mid + w_io) - (Y_mid + y_io)

    res = True
    if V_mid_p != V_mid * vk.alpha:
        res = False
    if W_mid_p != W_mid * vk.alpha:
        res = False
    if Y_mid_p != Y_mid * vk.alpha:
        res = False
    if H_p != H * vk.alpha:
        res = False
    if aux_present and Lc != L_beta:
        res = False
    if P != H * qrp.Zt:
        res = False
    return res
