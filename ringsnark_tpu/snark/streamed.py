"""Streamed ringGroth16 prover: limb-phased x row-chunked CRS generation.

The seeded CRS at 2^18 constraints is ~13 GiB *per outer limb* of c0, and
a resident CRS outgrows one device's memory as L and M grow.  Two
independent phase axes make any L fit a single device (and map 1:1 onto
several devices, one limb group each):

* **outer-limb phasing** — RNS limbs never interact anywhere in the
  prover (they only meet at decode/CRT, `DESIGN.md` §5), so an L-limb
  proof is exactly L independent single-limb proofs whose ciphertexts
  concatenate along the limb axis.  Each limb pass reuses the SAME
  compiled L=1 kernels, so L=2 costs ~2x the L=1 wall clock.
* **row chunking** — within one limb, each CRS phase (s_pows /
  delta_ts / delta_mid) is generated and consumed in fixed-shape row
  blocks; partial inner products accumulate at level 0 and the
  modswitch chain runs once on the final sums, so the result is
  bit-identical to the unchunked schedule.  All chunks of all phases
  share ONE static shape, so the whole streamed prover compiles 1 encode
  kernel + 2 MAC kernels total.

Two further moves bound device memory:

* **chunk-regenerated CRS rings** — the s_pows / delta_ts (groth16) and
  s_pows / alpha_s_pows (rinocchio) ring vectors are pure functions of
  the trapdoor s: row i is s^i times a fixed scale.  They are never
  materialized at (M+1) rows; each chunk's rows are generated on device
  as `spow_table * carry` with `carry *= s^chunk` between chunks
  (exact: modular products are associative).  This removes 2 of the
  ~7 full-size vectors from residency.
* **bounded lookahead** — the phase loop dispatches all chunks
  asynchronously; a throttling sync every `throttle` chunks keeps at most
  ~throttle+1 chunk buffers in flight (dispatch-time allocation would
  otherwise queue a whole phase of c0 chunks in device memory), and ONE
  "stream" section is recorded per phase.  `StreamRecord(profile=True)`
  syncs per chunk instead, to attribute time to encode ("setup") and MAC
  ("prove").

Mirrors the CRS/proof semantics of `/root/reference/ringsnark/
zk_proof_systems/groth16/groth16.tcc:5-115`; the reference holds the
whole `vector<EncT>` CRS in RAM and has no streaming analog.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial as _partial
from typing import Any, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..encoding import Encoding, encode, keygen
from ..encoding.context import EncodingContext, SecretKey
from ..ops.modops import add_mod, mul_mod
from ..reductions.r1cs_to_qrp import (
    eval_instance_arrays,
    mod_powers_device,
    _assignment_batches,
    prover_witness_map_chunked,
    witness_map_kernel_chunked,
)
from ..relations.r1cs import CompiledR1CS
from ..rings.context import RingContext
from ..rings.elem import RingElem
from ..utils.domain import RootsDomain
from .api import SnarkParams
from .groth16 import Proof, VerificationKey
from . import seeded as sd

__all__ = [
    "limb_ring",
    "limb_enc_context",
    "limb_params",
    "limb_secret_key",
    "limb_slice",
    "StreamRecord",
    "stream_prove",
    "stream_prove_rinocchio",
    "plan_chunks",
]


# ---------------------------------------------------------------------------
# limb slicing
# ---------------------------------------------------------------------------


def limb_ring(ctx: RingContext, l: int) -> RingContext:
    """The single-limb sub-ring Z_{q_l}[X]/(X^N+1)."""
    return RingContext(primes=(ctx.primes[l],), N=ctx.N)


def limb_enc_context(ectx: EncodingContext, l: int) -> EncodingContext:
    """The encoding context of outer limb l (plain modulus t_l = q_l).

    The reference builds one SEAL context per limb (`seal_ring.hpp:270-306`);
    this is that object, recovered from the stacked-axis representation.
    """
    return EncodingContext(
        ring=limb_ring(ectx.ring, l),
        n_inner=ectx.n_inner,
        inner_primes=ectx.inner_primes,
        error_stddev=ectx.error_stddev,
        floor_limbs=ectx.floor_limbs,
    )


def limb_params(params: SnarkParams, l: int) -> SnarkParams:
    return SnarkParams(
        ring=limb_ring(params.ring, l),
        enc=limb_enc_context(params.enc, l),
        use_modswitch=params.use_modswitch,
    )


def limb_secret_key(ectx_l: EncodingContext, sk: SecretKey, l: int) -> SecretKey:
    return SecretKey(
        ctx=ectx_l, s_ntt=sk.s_ntt[l : l + 1], s_coeffs=sk.s_coeffs[l : l + 1]
    )


def limb_slice(ctx_l: RingContext, res, l: int):
    """Slice the limb axis (-2) of a slot array: [*, L, n] -> [*, 1, n]."""
    return res[..., l : l + 1, :]


def limb_compiled(comp: CompiledR1CS, l: int) -> CompiledR1CS:
    """Limb-l view of a compiled R1CS (coefficients limb-sliced)."""
    ctx_l = limb_ring(comp.ctx, l)
    return CompiledR1CS(
        ctx=ctx_l,
        num_constraints=comp.num_constraints,
        num_variables=comp.num_variables,
        primary_input_size=comp.primary_input_size,
        rows=comp.rows,
        cols=comp.cols,
        coeffs=tuple(limb_slice(ctx_l, c, l) for c in comp.coeffs),
    )


# ---------------------------------------------------------------------------
# chunk planning
# ---------------------------------------------------------------------------


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def plan_chunks(B: int, phase_rows: int, slab: int) -> tuple[int, int]:
    """(nchunks, chunk) with chunk a multiple of slab, nchunks*chunk >= B.

    Split B rows into ~B/phase_rows equal chunks; each chunk holds
    ceil(B/nchunks) rows rounded up to a whole number of slabs.  All phases
    of all limbs use the same (nchunks, chunk), so the streamed prover
    compiles each kernel once; padding waste is bounded by ~slab/B +
    rounding (<= ~6% at the bench shapes).
    """
    nchunks = max(1, round(B / phase_rows))
    rows_per_chunk = _ceil_div(B, nchunks)
    chunk = _ceil_div(rows_per_chunk, slab) * slab
    while nchunks * chunk < B:  # round() may undershoot nchunks by one
        nchunks += 1
    return nchunks, chunk


# ---------------------------------------------------------------------------
# timing record
# ---------------------------------------------------------------------------


@dataclass
class StreamRecord:
    """Per-section wall-clock for the streamed provers.

    Kinds: "setup" (trapdoor/instance algebra + small encodes), "prove"
    (witness map, finalize), "stream" (the chunked CRS-encode + MAC phase
    loops — generation and consumption are interleaved and only separable
    by paying a sync per chunk).  With `profile=True` the phase loops sync
    per chunk and record "setup"/"prove" sections instead.  Each timed
    section ends in `jax.block_until_ready` when `sync` is set."""

    sync: bool = True
    profile: bool = False
    events: list = field(default_factory=list)  # (kind, name, seconds)

    def total(self, kind: str) -> float:
        return sum(dt for k, _, dt in self.events if k == kind)

    def add(self, kind: str, name: str, dt: float):
        self.events.append((kind, name, dt))

    def _sync(self, *arrays):
        if self.sync:
            jax.block_until_ready([a for a in arrays if a is not None])


# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------


def _pad_rows(arr, target: int):
    if arr.shape[0] == target:
        return arr
    return jnp.pad(arr, [(0, target - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1))


@_partial(jax.jit, static_argnames=("ctx",))
def _mul_res(ctx, a, b):
    """Broadcast modular product of two residue arrays of the ring."""
    return mul_mod(a, b, ctx.p, ctx.mu, ctx.pbits)


@_partial(jax.jit, static_argnames=("ctx", "count"))
def _spow_table(ctx, s_res, count: int):
    """([1, s, ..., s^(count-1)], s^count) as residue arrays."""
    pows = mod_powers_device(s_res, count + 1, ctx)
    return pows[:count], pows[count]


@_partial(jax.jit, static_argnames=("domain", "n_io"))
def _g16_stream_crs(comp, domain, s_res, alpha, beta, gamma_inv, delta_inv,
                    n_io: int):
    """gamma_io / delta_mid ring vectors + Zt*delta^-1, one program.

    At/Bt/Ct stay XLA temporaries (at Rq 2^15 each is ~1 GiB); the r4 path
    additionally materialized Ht and delta_ts at (M+1) rows — both are now
    regenerated per chunk from s (`groth16.tcc:5-67` CRS contents).
    """
    ctx = comp.ctx
    At, Bt, Ct, Zt = eval_instance_arrays(comp, s_res, domain)
    p, mu, b = ctx.p, ctx.mu, ctx.pbits
    combo = add_mod(
        add_mod(mul_mod(At, beta, p, mu, b), mul_mod(Bt, alpha, p, mu, b), p),
        Ct, p,
    )
    gamma_io = mul_mod(combo[:n_io], gamma_inv, p, mu, b)
    delta_mid = mul_mod(combo[n_io:], delta_inv, p, mu, b)
    zt_dinv = mul_mod(Zt, delta_inv, p, mu, b)
    return gamma_io, delta_mid, zt_dinv


@_partial(jax.jit, static_argnames=("domain", "n_io"))
def _rin_stream_crs(comp, domain, s_res, beta, r_v, r_w, r_y,
                    n_io: int):
    """beta lincheck vector + Zt, one program (see _g16_stream_crs);
    alpha_s_pows rows are regenerated per chunk as alpha * s^i."""
    ctx = comp.ctx
    At, Bt, Ct, Zt = eval_instance_arrays(comp, s_res, domain)
    p, mu, b = ctx.p, ctx.mu, ctx.pbits
    lin = add_mod(
        add_mod(mul_mod(At[n_io:], r_v, p, mu, b),
                mul_mod(Bt[n_io:], r_w, p, mu, b), p),
        mul_mod(Ct[n_io:], r_y, p, mu, b), p,
    )
    lincheck = mul_mod(lin, beta, p, mu, b)
    return lincheck, Zt


def _as_batch(ctx: RingContext, x) -> RingElem:
    """A RingElem batch from a RingElem or a (possibly empty) list."""
    if isinstance(x, RingElem):
        return x
    if x:
        return RingElem.stack(list(x))
    return RingElem(ctx, jnp.zeros((0, ctx.L, ctx.N), dtype=jnp.uint32))


# ---------------------------------------------------------------------------
# the phase loop shared by both streamed provers
# ---------------------------------------------------------------------------

# chunks in flight before a throttling sync: bounds the device memory held
# by queued (not-yet-executed) chunk dispatches to ~(throttle+1) c0 chunks
DEFAULT_THROTTLE = 2


def _run_phases(
    params_l: SnarkParams,
    sk_l: SecretKey,
    phases: list,
    nchunks: int,
    chunk: int,
    slab: int,
    spow_l,
    s_step_l,
    rec: StreamRecord,
    limb_tag: int,
    throttle: int = DEFAULT_THROTTLE,
) -> dict:
    """Encode-and-MAC every chunk of every phase for one limb.

    phases: list of (name, src, pts) with src either ("mat", rows_res)
    — a materialized [B_pad, 1, n] ring vector — or ("pow", scale0_res):
    chunk ci's rows are spow_l * (scale0 * s^(ci*chunk)), regenerated on
    device.  Returns {name: [level-0 partial-sum Encodings]}.
    """
    ctx_l, ectx_l = params_l.ring, params_l.enc

    def rows_at(x, lo):
        # slice-and-pad: inputs need not be padded to nchunks*chunk rows —
        # a short (or empty — jax clamps out-of-range slices) final slice
        # is zero-padded here, which is bit-identical to slicing a
        # zero-padded vector but never materializes the full padded copy
        # (at Rq 2^16 the padded aux/delta_mid copies alone were ~4.5 GiB)
        sl = x[lo:lo + chunk]
        return sl if sl.shape[0] == chunk else _pad_rows(sl, chunk)

    partials: dict[str, list] = {}
    for name, (kind, src), pts, enc_key in phases:
        tp = time.perf_counter()
        accs = None
        carry = src if kind == "pow" else None
        for ci in range(nchunks):
            lo = ci * chunk
            if kind == "pow":
                rows_chunk = _mul_res(ctx_l, spow_l, carry)
                if ci + 1 < nchunks:
                    carry = _mul_res(ctx_l, carry, s_step_l)
            else:
                rows_chunk = rows_at(src, lo)
            if rec.profile:
                t0 = time.perf_counter()
            senc = sd.encode_seeded(
                ectx_l, sk_l, RingElem(ctx_l, rows_chunk),
                jax.random.fold_in(enc_key, ci), slab,
            )
            if rec.profile:
                rec._sync(senc.c0)
                rec.add("setup", f"limb{limb_tag}:{name}+{lo}",
                        time.perf_counter() - t0)
                t0 = time.perf_counter()
            outs = sd.seeded_inner_product(
                senc, [rows_at(pt, lo) for pt in pts],
                use_modswitch=False,
            )
            accs = outs if accs is None else [
                a + b for a, b in zip(accs, outs)
            ]
            if rec.profile:
                rec._sync(*[o.c0 for o in accs])
                rec.add("prove", f"limb{limb_tag}:{name}+{lo}",
                        time.perf_counter() - t0)
            elif (ci + 1) % throttle == 0 and ci + 1 < nchunks:
                # memory throttle, not a timing point: it waits even when
                # the record does not time sections
                jax.block_until_ready(accs[0].c0)
            del senc
        partials[name] = accs
        if not rec.profile:
            rec._sync(*[o.c0 for o in accs])
            rec.add("stream", f"limb{limb_tag}:{name}",
                    time.perf_counter() - tp)
    return partials


def _finish_modswitch(e: Encoding, max_level: int) -> Encoding:
    for _ in range(max_level):
        e = e.modswitch()
    return e


# ---------------------------------------------------------------------------
# the streamed groth16 prover
# ---------------------------------------------------------------------------


def stream_prove(
    comp: CompiledR1CS,
    params: SnarkParams,
    primary,
    auxiliary,
    rng: np.random.Generator,
    key,
    *,
    slab: int = 4096,
    phase_rows: int = 1 << 16,
    record: Optional[StreamRecord] = None,
    trapdoor: Optional[tuple] = None,
    sk_enc: Optional[SecretKey] = None,
    limb_tag: Optional[int] = None,
    throttle: int = DEFAULT_THROTTLE,
):
    """Setup + prove with the CRS never fully resident (`groth16.tcc:5-115`).

    Returns (proof, vk, record).  vk carries a CRS-less SeededProvingKey
    stub (the verifier needs only compiled/domain/params).  `trapdoor` =
    (s, alpha, beta, gamma, delta) full-L RingElems and `sk_enc` may be
    injected for cross-path tests; by default both are sampled from `rng`
    exactly like `seeded.generator_seeded`.
    """
    rec = record if record is not None else StreamRecord(sync=False)
    ctx = params.ring
    ectx = params.enc
    L = ctx.L
    M = max(comp.num_constraints, 1)
    n_io = comp.primary_input_size + 1

    if L > 1 and ctx.N > 1:
        # fully limb-local streaming for dense multi-limb rings: recurse per
        # limb with the sliced compiled system and injected trapdoor/sk, so
        # the GB-scale witness/CRS vectors only ever exist at one limb
        # (every table and kernel is limb-diagonal; the per-limb
        # RootsDomain's tables equal the limb slice of the full-L domain's
        # because roots are derived per prime — exactness is asserted by the
        # decode-equality tests).
        t0 = time.perf_counter()
        domain = RootsDomain(ctx, M)
        if trapdoor is None:
            s = RingElem.random_exceptional_element(ctx, rng, domain)
        else:
            s, alpha, beta, gamma, delta = trapdoor
        if sk_enc is None:
            _, sk_enc = keygen(ectx, rng)
        if trapdoor is None:
            alpha = RingElem.random_invertible_element(ctx, rng)
            beta = RingElem.random_invertible_element(ctx, rng)
            gamma = RingElem.random_invertible_element(ctx, rng)
            delta = RingElem.random_invertible_element(ctx, rng)
        rec.add("setup", "common", time.perf_counter() - t0)

        primary_b = _as_batch(ctx, primary)
        aux_b = _as_batch(ctx, auxiliary)
        elems = []
        gio = []
        for l in range(L):
            comp_l = limb_compiled(comp, l)
            params_l = limb_params(params, l)
            ctx_l = params_l.ring
            td_l = tuple(
                RingElem(ctx_l, limb_slice(ctx_l, x.res, l))
                for x in (s, alpha, beta, gamma, delta)
            )
            proof_l, vk_l, rec = stream_prove(
                comp_l, params_l,
                RingElem(ctx_l, limb_slice(ctx_l, primary_b.res, l)),
                RingElem(ctx_l, limb_slice(ctx_l, aux_b.res, l)),
                rng, jax.random.fold_in(key, 1000 + l),
                slab=slab, phase_rows=phase_rows, record=rec,
                trapdoor=td_l,
                sk_enc=limb_secret_key(params_l.enc, sk_enc, l),
                limb_tag=l, throttle=throttle,
            )
            elems.append(proof_l)
            gio.append(vk_l.pk.gamma_io)
            del proof_l, vk_l

        def catP(idx):
            encs = [getattr(p, idx) for p in elems]
            lvl = encs[0].level
            return Encoding(
                ectx,
                jnp.concatenate([e.c0 for e in encs], axis=0),
                jnp.concatenate([e.c1 for e in encs], axis=0),
                lvl,
            )

        proof = Proof(A=catP("A"), B=catP("B"), C=catP("C"))
        gamma_io = Encoding(
            ectx,
            jnp.concatenate([g.c0 for g in gio], axis=1),
            jnp.concatenate([g.c1 for g in gio], axis=1),
            0,
        )
        pk = sd.SeededProvingKey(
            compiled=comp, domain=domain, params=params, alpha=None,
            beta=None, s_pows=None, gamma_io=gamma_io, delta_mid=None,
            delta_ts=None,
        )
        vk = VerificationKey(pk=pk, s=s, alpha=alpha, beta=beta, gamma=gamma,
                             delta=delta, sk_enc=sk_enc)
        return proof, vk, rec

    # ---- common setup (full L): trapdoor, instance algebra ----------------
    t0 = time.perf_counter()
    # sampling order matches seeded.generator_seeded exactly, so the same
    # seeded rng yields the same trapdoor/sk across both paths (tests rely
    # on this for decode-equality)
    domain = RootsDomain(ctx, M)
    if trapdoor is None:
        s = RingElem.random_exceptional_element(ctx, rng, domain)
    else:
        s, alpha, beta, gamma, delta = trapdoor
    if sk_enc is None:
        _, sk_enc = keygen(ectx, rng)
    if trapdoor is None:
        alpha = RingElem.random_invertible_element(ctx, rng)
        beta = RingElem.random_invertible_element(ctx, rng)
        gamma = RingElem.random_invertible_element(ctx, rng)
        delta = RingElem.random_invertible_element(ctx, rng)
    gamma_io_res, delta_mid_res, zt_dinv_res = _g16_stream_crs(
        comp, domain, s.res, alpha.res, beta.res,
        gamma.inverse().res, delta.inverse().res, n_io,
    )
    gamma_io_ring = RingElem(ctx, gamma_io_res)
    rec._sync(delta_mid_res, zt_dinv_res)
    rec.add("setup", "common", time.perf_counter() - t0)

    # ---- chunk plan (needed by the witness map's fused row padding) -------
    # one (nchunks, chunk) plan shared by every phase of every limb
    # (delta_mid has num_variables - primary rows, which can exceed M+1
    # for wide circuits like the mul chain)
    n_aux = comp.num_variables - comp.primary_input_size
    B_max = max(domain.m + 1, n_aux)
    nchunks, chunk = plan_chunks(B_max, phase_rows, slab)
    B_pad = nchunks * chunk
    ums = params.use_modswitch
    max_level = max(ectx.L_inner - ectx.floor_limbs, 0) if ums else 0

    # ---- witness map (full L, slot-chunked for Rq program size) -----------
    t0 = time.perf_counter()
    # lazy prover-mode map: z_full assembled per slot chunk from the
    # primary/aux arrays; the full/io/mid batches (~2.1 GiB EACH at
    # Rq 2^16 — their eager materialization OOM'd the first rq16 attempt)
    # never exist, only 3 of the 9 SpMV+iNTT legs run (linearity), and the
    # outputs are assembled in place via donated slot updates (holding all
    # slot-chunk pieces next to the assembling outputs was ~7 GiB — the
    # third rq16 OOM).  No row vector is padded to the chunk plan here:
    # `_run_phases.rows_at` zero-pads the final short chunk slice on the
    # fly, bit-identically (padded full-size copies were ~4.5 GiB more).
    primary_b = _as_batch(ctx, primary)
    aux_res = _as_batch(ctx, auxiliary).res
    (a_full, b_full, H) = prover_witness_map_chunked(
        comp, primary_b.res, aux_res, domain,
    )
    rec._sync(a_full, b_full, H)
    rec.add("prove", "witness_map", time.perf_counter() - t0)
    # per-chunk power table: chunk rows of s^i and the chunk step s^chunk
    spow, s_step = _spow_table(ctx, s.res, chunk)

    limb_proofs = []  # (A, B, C) per limb, Encoding over the 1-limb ctx
    gamma_io_parts = []
    for l in range(L):
        lt = limb_tag if limb_tag is not None else l
        params_l = limb_params(params, l)
        ctx_l, ectx_l = params_l.ring, params_l.enc
        sk_l = limb_secret_key(ectx_l, sk_enc, l)
        keys = jax.random.split(jax.random.fold_in(key, l), 8)

        t0 = time.perf_counter()
        alpha_enc = encode(
            ectx_l, sk_l, RingElem(ctx_l, limb_slice(ctx_l, alpha.res, l)[None]),
            keys[0],
        )[0]
        beta_enc = encode(
            ectx_l, sk_l, RingElem(ctx_l, limb_slice(ctx_l, beta.res, l)[None]),
            keys[1],
        )[0]
        gamma_io_parts.append(
            encode(
                ectx_l, sk_l,
                RingElem(ctx_l, limb_slice(ctx_l, gamma_io_ring.res, l)),
                keys[2],
            )
        )
        rec._sync(alpha_enc.c0, gamma_io_parts[-1].c0)
        rec.add("setup", f"limb{lt}:small", time.perf_counter() - t0)

        # the three streaming phases: (name, source, pts, key).  ones/zt_dinv
        # seeds the regenerated s^i rows; delta_mid rows are materialized.
        ones_l = jnp.broadcast_to(
            RingElem.one(ctx_l).res, limb_slice(ctx_l, s.res, l).shape
        ).astype(jnp.uint32)
        phases = [
            ("s_pows", ("pow", ones_l),
             [limb_slice(ctx_l, a_full, l),
              limb_slice(ctx_l, b_full, l)], keys[3]),
            ("delta_ts", ("pow", limb_slice(ctx_l, zt_dinv_res, l)),
             [limb_slice(ctx_l, H, l)], keys[4]),
        ]
        if n_aux > 0:
            phases.append(
                ("delta_mid", ("mat", limb_slice(ctx_l, delta_mid_res, l)),
                 [limb_slice(ctx_l, aux_res, l)], keys[5])
            )
        partials = _run_phases(
            params_l, sk_l, phases, nchunks, chunk, slab,
            limb_slice(ctx_l, spow, l), limb_slice(ctx_l, s_step, l),
            rec, lt, throttle=throttle,
        )

        # final modswitch chains + proof assembly for this limb
        t0 = time.perf_counter()
        finals = {
            name: [_finish_modswitch(e, max_level) for e in accs]
            for name, accs in partials.items()
        }
        A_l = finals["s_pows"][0] + alpha_enc
        B_l = finals["s_pows"][1] + beta_enc
        C_l = finals["delta_ts"][0]
        if "delta_mid" in finals:
            C_l = C_l + finals["delta_mid"][0]
        rec._sync(A_l.c0, B_l.c0, C_l.c0)
        rec.add("prove", f"limb{lt}:finalize", time.perf_counter() - t0)
        limb_proofs.append((A_l, B_l, C_l))

    # ---- assemble the full-L proof and vk ---------------------------------
    def cat(idx: int) -> Encoding:
        encs = [lp[idx] for lp in limb_proofs]
        lvl = encs[0].level
        assert all(e.level == lvl for e in encs)
        return Encoding(
            ectx,
            jnp.concatenate([e.c0 for e in encs], axis=0),
            jnp.concatenate([e.c1 for e in encs], axis=0),
            lvl,
        )

    proof = Proof(A=cat(0), B=cat(1), C=cat(2))
    gamma_io = Encoding(
        ectx,
        jnp.concatenate([g.c0 for g in gamma_io_parts], axis=1),
        jnp.concatenate([g.c1 for g in gamma_io_parts], axis=1),
        0,
    )
    pk = sd.SeededProvingKey(
        compiled=comp, domain=domain, params=params, alpha=None, beta=None,
        s_pows=None, gamma_io=gamma_io, delta_mid=None, delta_ts=None,
    )
    vk = VerificationKey(pk=pk, s=s, alpha=alpha, beta=beta, gamma=gamma,
                         delta=delta, sk_enc=sk_enc)
    return proof, vk, rec


# ---------------------------------------------------------------------------
# streamed Rinocchio
# ---------------------------------------------------------------------------


def _cat_limbs(ectx, encs):
    lvl = encs[0].level
    assert all(e.level == lvl for e in encs)
    return Encoding(
        ectx,
        jnp.concatenate([e.c0 for e in encs], axis=0),
        jnp.concatenate([e.c1 for e in encs], axis=0),
        lvl,
    )


def _shifted_rows(coeffs, dr, ctx):
    """[a_0 - d, a_1, ..., a_{M-1}, d]: the d*Z fold (Z = X^M - 1) that puts
    the ZK shift INSIDE the inner-product coefficient vector (the
    reference's own TODO, `rinocchio.tcc:166`; see rinocchio.prover)."""
    from ..ops.modops import sub_mod

    head = sub_mod(coeffs[0], dr, ctx.p)[None]
    tail = jnp.broadcast_to(dr[None], (1, *coeffs.shape[1:])).astype(jnp.uint32)
    return jnp.concatenate([head, coeffs[1:], tail], axis=0)


def stream_prove_rinocchio(
    comp: CompiledR1CS,
    params: SnarkParams,
    primary,
    auxiliary,
    rng: np.random.Generator,
    key,
    *,
    slab: int = 4096,
    phase_rows: int = 1 << 16,
    record: Optional[StreamRecord] = None,
    throttle: int = DEFAULT_THROTTLE,
):
    """Streamed Rinocchio setup + prove (`rinocchio.tcc:5-190` semantics).

    Same limb-phasing / row-chunking as `stream_prove`; the CRS here is ~2x
    groth16's (s_pows + alpha_s_pows + beta_prods) and the prover runs 10
    inner products (9 against the two seeded s-power batches, F against
    beta_prods), so this is the configuration that most needs streaming —
    the resident prover tops out near 2^14 per chip.  Both s-power CRS
    phases are chunk-regenerated from s (alpha_s_pows = alpha * s^i).
    Sampling order matches `rinocchio.generator` + `rinocchio.prover` so a
    same-seed rng yields identical trapdoor and proof plaintexts (tests
    rely on this).

    Returns (proof, vk, record); vk carries a CRS-less ProvingKey stub.
    """
    from .rinocchio import Proof as RProof
    from .rinocchio import ProvingKey as RProvingKey
    from .rinocchio import VerificationKey as RVerificationKey

    rec = record if record is not None else StreamRecord(sync=False)
    ctx = params.ring
    ectx = params.enc
    L = ctx.L
    M = max(comp.num_constraints, 1)
    n_io = comp.primary_input_size + 1
    n_aux = comp.num_variables - comp.primary_input_size
    use_zk = n_aux > 0

    # ---- common setup (full L) -- rng order mirrors rinocchio.generator ---
    t0 = time.perf_counter()
    domain = RootsDomain(ctx, M)
    s = RingElem.random_exceptional_element(ctx, rng, domain)
    _, sk_enc = keygen(ectx, rng)
    alpha = RingElem.random_invertible_element(ctx, rng)
    r_v = RingElem.random_invertible_element(ctx, rng)
    r_w = RingElem.random_invertible_element(ctx, rng)
    r_y = r_v * r_w
    beta = RingElem.random_nonzero_element(ctx, rng)
    lincheck_res, Zt_res = _rin_stream_crs(
        comp, domain, s.res, beta.res, r_v.res, r_w.res, r_y.res, n_io,
    )
    beta_prods_res = lincheck_res if use_zk else None
    beta_Zt = beta * RingElem(ctx, Zt_res)
    shift_terms = RingElem.stack(
        [beta_Zt * r_v, beta_Zt * r_w, beta_Zt * r_y]
    )  # the 3 F-shift CRS terms actually used by the prover
    rec._sync(lincheck_res)
    rec.add("setup", "common", time.perf_counter() - t0)

    # ---- witness map (full L) --------------------------------------------
    t0 = time.perf_counter()
    if use_zk:
        d1 = RingElem.random_invertible_element(ctx, rng)
        d2 = RingElem.random_invertible_element(ctx, rng)
        d3 = RingElem.random_invertible_element(ctx, rng)
    else:
        d1 = d2 = d3 = RingElem.zero(ctx)
    full, io, mid = _assignment_batches(ctx, primary, auxiliary)
    (a_mid, b_mid, c_mid, H) = witness_map_kernel_chunked(
        comp, full.res, io.res, mid.res, d1.res, d2.res, d3.res, domain,
        outputs="mid",
    )
    if use_zk:
        a_vec = _shifted_rows(a_mid, d1.res, ctx)
        b_vec = _shifted_rows(b_mid, d2.res, ctx)
        c_vec = _shifted_rows(c_mid, d3.res, ctx)
    else:
        a_vec, b_vec, c_vec = a_mid, b_mid, c_mid
    del a_mid, b_mid, c_mid, full, io, mid
    aux_res = _as_batch(ctx, auxiliary).res
    rec._sync(a_vec, H)
    rec.add("prove", "witness_map", time.perf_counter() - t0)

    # ---- per-limb streamed CRS + the 10 inner products --------------------
    B_max = max(domain.m + 1, n_aux)
    nchunks, chunk = plan_chunks(B_max, phase_rows, slab)
    B_pad = nchunks * chunk
    ums = params.use_modswitch
    max_level = max(ectx.L_inner - ectx.floor_limbs, 0) if ums else 0

    # no full-size padded copies: `_run_phases.rows_at` zero-pads the
    # final short chunk slice on the fly (see stream_prove)
    spow, s_step = _spow_table(ctx, s.res, chunk)

    limb_elems: list[list[Encoding]] = []  # 9 proof elements per limb (+F)
    for l in range(L):
        params_l = limb_params(params, l)
        ctx_l, ectx_l = params_l.ring, params_l.enc
        sk_l = limb_secret_key(ectx_l, sk_enc, l)
        keys = jax.random.split(jax.random.fold_in(key, l), 8)

        t0 = time.perf_counter()
        shifts_l = encode(
            ectx_l, sk_l,
            RingElem(ctx_l, limb_slice(ctx_l, shift_terms.res, l)), keys[0],
        )
        rec._sync(shifts_l.c0)
        rec.add("setup", f"limb{l}:small", time.perf_counter() - t0)

        main_pts = [
            limb_slice(ctx_l, v, l) for v in (a_vec, b_vec, c_vec, H)
        ]
        ones_l = jnp.broadcast_to(
            RingElem.one(ctx_l).res, limb_slice(ctx_l, s.res, l).shape
        ).astype(jnp.uint32)
        phases = [
            ("s_pows", ("pow", ones_l), main_pts, keys[1]),
            ("alpha_s_pows", ("pow", limb_slice(ctx_l, alpha.res, l)),
             main_pts, keys[2]),
        ]
        if use_zk:
            phases.append(
                ("beta_prods", ("mat", limb_slice(ctx_l, beta_prods_res, l)),
                 [limb_slice(ctx_l, aux_res, l)], keys[3])
            )
        partials = _run_phases(
            params_l, sk_l, phases, nchunks, chunk, slab,
            limb_slice(ctx_l, spow, l), limb_slice(ctx_l, s_step, l),
            rec, l, throttle=throttle,
        )

        t0 = time.perf_counter()
        elems = []
        # proof order: A, A', B, B', C, C', D, D' (rinocchio.hpp:117-146)
        for i in range(4):
            for name in ("s_pows", "alpha_s_pows"):
                elems.append(_finish_modswitch(partials[name][i], max_level))
        f_l = None
        if use_zk:
            f = _finish_modswitch(partials["beta_prods"][0], max_level)
            # F shift terms multiply single FRESH encodings (level 0)
            for i, d in enumerate((d1, d2, d3)):
                d_l = RingElem(ctx_l, limb_slice(ctx_l, d.res, l))
                f = f + d_l * shifts_l[i]
            f_l = f
        elems.append(f_l)
        rec._sync(elems[0].c0)
        rec.add("prove", f"limb{l}:finalize", time.perf_counter() - t0)
        limb_elems.append(elems)

    names = ("A", "A_prime", "B", "B_prime", "C", "C_prime", "D", "D_prime")
    cat = {
        n: _cat_limbs(ectx, [le[i] for le in limb_elems])
        for i, n in enumerate(names)
    }
    F = (
        _cat_limbs(ectx, [le[8] for le in limb_elems]) if use_zk else None
    )
    proof = RProof(F=F, **cat)
    pk = RProvingKey(
        constraint_system=None, compiled=comp, domain=domain, params=params,
        s_pows=None, alpha_s_pows=None, beta_prods=None, beta_rv_ts=None,
        beta_rw_ts=None, beta_ry_ts=None, alpha_rv_ts=None, alpha_rw_ts=None,
        alpha_ry_ts=None, rv_vs=None, rw_ws=None, ry_ys=None,
    )
    vk = RVerificationKey(pk=pk, s=s, alpha=alpha, beta=beta, r_v=r_v,
                          r_w=r_w, r_y=r_y, sk_enc=sk_enc)
    return proof, vk, rec
