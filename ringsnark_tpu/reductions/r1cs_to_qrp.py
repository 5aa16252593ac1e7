"""R1CS -> QRP reduction: instance map, evaluated instance map, witness map.

Mirrors `/root/reference/ringsnark/reductions/r1cs_to_qrp/r1cs_to_qrp.tcc`
with the O(m^2) interpolation/multiplication/division cluster replaced by
NTTs over the roots-of-unity domain (SURVEY §3.2 "arithmetization hot
block"):

* constraint evaluation (x3 assignments)  -> batched COO SpMV
* `interpolate` x9                        -> inverse NTT (size M)
* `multiply(aA, aB)` + `divide_by_Z`      -> zero-padded size-2M NTTs +
  upper-half quotient extraction (Z = X^M - 1, exact division)
* ZK patch (d2*A + d1*B - d3) + d1*d2*Z   -> fused elementwise ops

Deviation from the reference (documented in relations/qrp.QRPWitness): the
io/mid split counts the constant column once (io side); the reference
evaluates both shortened assignments with constant=1
(`r1cs_to_qrp.tcc:167-200`), double-counting it.

A generic host-path (`*_generic`) mirrors the reference's control flow with
list-based polynomials for cross-validation on any domain/element type.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import ntt as _ntt
from ..ops.modops import mul_mod, sub_mod, add_mod, neg_mod, barrett_reduce_u64
from ..relations.qrp import QRPInstance, QRPInstanceEvaluation, QRPWitness
from ..relations.r1cs import CompiledR1CS, R1CSConstraintSystem
from ..rings.elem import RingElem
from ..utils import poly as _poly
from ..utils.domain import RootsDomain, get_evaluation_domain

__all__ = [
    "r1cs_to_qrp_instance_map",
    "r1cs_to_qrp_instance_map_with_evaluation",
    "eval_instance_arrays",
    "r1cs_to_qrp_witness_map",
    "r1cs_to_qrp_witness_map_generic",
    "mod_powers_device",
    "prover_witness_map_chunked",
    "witness_map_kernel_chunked",
]


def mod_powers_device(t_res, count: int, ctx):
    """[1, t, ..., t^(count-1)] as uint32[count, L, 1], log(count) jnp steps."""
    pw = jnp.broadcast_to(
        jnp.ones_like(t_res)[None], (1, *t_res.shape)
    )  # [1, L, 1] of ones
    cur = 1
    while cur < count:
        # t^cur = last power * t
        step = mul_mod(pw[cur - 1], t_res, ctx.p, ctx.mu, ctx.pbits)  # t^cur
        nxt = mul_mod(pw, step[None], ctx.p, ctx.mu, ctx.pbits)
        pw = jnp.concatenate([pw, nxt], axis=0)
        cur = pw.shape[0]
    return pw[:count]


# ---------------------------------------------------------------------------
# instance maps
# ---------------------------------------------------------------------------


def r1cs_to_qrp_instance_map(cs: R1CSConstraintSystem, domain) -> QRPInstance:
    """Scatter constraint coefficients into Lagrange-basis maps
    (`r1cs_to_qrp.tcc:26-58`)."""
    nv = cs.num_variables()
    A = [dict() for _ in range(nv + 1)]
    B = [dict() for _ in range(nv + 1)]
    C = [dict() for _ in range(nv + 1)]
    for i, cons in enumerate(cs.constraints):
        for M, lc in ((A, cons.a), (B, cons.b), (C, cons.c)):
            for term in lc.terms:
                d = M[term.index]
                d[i] = d[i] + term.coeff if i in d else term.coeff
    return QRPInstance(domain, nv, domain.m, cs.num_inputs(), A, B, C)


def r1cs_to_qrp_instance_map_with_evaluation(
    comp: CompiledR1CS, t: RingElem, domain: RootsDomain
) -> QRPInstanceEvaluation:
    """Evaluate the QRP instance at t (`r1cs_to_qrp.tcc:76-116`), fast path.

    At[k] = sum_i u_i * A[i,k] — a transposed SpMV with u = Lagrange values,
    one segment-sum per matrix.  Returns batched At/Bt/Ct ([nv+1, L, nc]),
    Ht ([M+1, L, 1]) and Zt.  One jitted graph per shape signature.
    """
    ctx = comp.ctx
    At, Bt, Ct, Ht, Zt = _instance_eval_kernel(comp, t.res, domain)
    return QRPInstanceEvaluation(
        domain, comp.num_variables, domain.m, comp.primary_input_size,
        t, RingElem(ctx, At), RingElem(ctx, Bt), RingElem(ctx, Ct),
        RingElem(ctx, Ht), RingElem(ctx, Zt),
    )


def eval_instance_arrays(comp, t_res, domain):
    """(At, Bt, Ct, Zt) arrays at t — the SpMV part of the instance map.

    Not jitted itself: composes into larger jitted programs (the streamed
    provers fuse it with the CRS ring algebra so At/Bt/Ct stay XLA
    temporaries and Ht is never materialized — its rows are regenerated
    per chunk from s instead).
    """
    ctx = comp.ctx
    t = RingElem(ctx, t_res)
    u = domain.evaluate_all_lagrange_polynomials(t).res  # [M, L, 1]
    Zt = domain.compute_vanishing_polynomial(t)

    outs = []
    for rows, cols, coeffs in zip(comp.rows, comp.cols, comp.coeffs):
        gathered = u[rows]  # [nnz, L, 1]
        prods = mul_mod(gathered, coeffs, ctx.p, ctx.mu, ctx.pbits)
        acc = jax.ops.segment_sum(
            prods.astype(jnp.uint64), cols, num_segments=comp.num_variables + 1
        )
        outs.append(barrett_reduce_u64(acc, ctx.p, ctx.mu, ctx.pbits))
    At, Bt, Ct = outs
    return At, Bt, Ct, Zt.res


@partial(jax.jit, static_argnames=("domain",))
def _instance_eval_kernel(comp, t_res, domain):
    ctx = comp.ctx
    At, Bt, Ct, Zt = eval_instance_arrays(comp, t_res, domain)
    Ht = mod_powers_device(t_res, domain.m + 1, ctx)
    return At, Bt, Ct, Ht, Zt


# ---------------------------------------------------------------------------
# witness map — fast path
# ---------------------------------------------------------------------------


def _pa_batches(ctx, primary, auxiliary):
    """(p_res, a_res) assignment arrays, each [rows, L, n] at a common
    slot width — the inputs of `prover_witness_map_chunked` (no full/io/mid
    materialization).  Accepts RingElem batches or lists of RingElem."""
    p_res = primary.res if isinstance(primary, RingElem) else (
        RingElem.stack(list(primary)).res if primary
        else jnp.zeros((0, ctx.L, 1), dtype=jnp.uint32)
    )
    a_res = auxiliary.res if isinstance(auxiliary, RingElem) else (
        RingElem.stack(list(auxiliary)).res if auxiliary
        else jnp.zeros((0, ctx.L, 1), dtype=jnp.uint32)
    )
    return p_res, a_res


def _assignment_batches(ctx, primary, auxiliary):
    """(full, io, mid) assignment batches, each [1+nv, L, n].

    io  = [1,  primary, 0...];  mid = [0, 0..., auxiliary]  (constant counted
    once, on the io side — see module docstring).  Inputs are lists of
    RingElem (frontend path) or RingElem batches (array path for
    benchmark-scale instances).
    """
    if isinstance(primary, RingElem) or isinstance(auxiliary, RingElem):
        p_res = primary.res if isinstance(primary, RingElem) else (
            RingElem.stack(list(primary)).res if primary
            else jnp.zeros((0, ctx.L, 1), dtype=jnp.uint32)
        )
        a_res = auxiliary.res if isinstance(auxiliary, RingElem) else (
            RingElem.stack(list(auxiliary)).res if auxiliary
            else jnp.zeros((0, ctx.L, 1), dtype=jnp.uint32)
        )
        n = max(p_res.shape[-1], a_res.shape[-1], 1)
        p_res = jnp.broadcast_to(p_res, (*p_res.shape[:-1], n))
        a_res = jnp.broadcast_to(a_res, (*a_res.shape[:-1], n))
        one = jnp.broadcast_to(
            RingElem.one(ctx).res, (1, ctx.L, n)
        ).astype(jnp.uint32)
        zs_p = jnp.zeros_like(p_res)
        zs_a = jnp.zeros_like(a_res)
        z1 = jnp.zeros_like(one)
        full = RingElem(ctx, jnp.concatenate([one, p_res, a_res], axis=0))
        io = RingElem(ctx, jnp.concatenate([one, p_res, zs_a], axis=0))
        mid = RingElem(ctx, jnp.concatenate([z1, zs_p, a_res], axis=0))
        return full, io, mid
    one = RingElem.one(ctx)
    zero = RingElem.zero(ctx)
    np_, na = len(primary), len(auxiliary)
    full = RingElem.stack([one] + list(primary) + list(auxiliary))
    io = RingElem.stack([one] + list(primary) + [zero] * na)
    mid = RingElem.stack([zero] * (1 + np_) + list(auxiliary))
    # common slot dim: an all-scalar batch (e.g. mid with no aux wires)
    # must match the dense batches, or the slot-chunked witness map slices
    # it to zero-width chunks past the first
    n = max(full.res.shape[-1], io.res.shape[-1], mid.res.shape[-1])
    if n > 1:
        full, io, mid = (
            RingElem(ctx, jnp.broadcast_to(b.res, (*b.res.shape[:-1], n)))
            for b in (full, io, mid)
        )
    return full, io, mid


def _interp(domain: RootsDomain, evals_bln):
    """[M, L, n] domain-order evals -> [M, L, n] coefficients (via iNTT)."""
    x = jnp.transpose(evals_bln, (2, 1, 0))  # [n, L, M]
    c = domain.interpolate_arr(x)
    return jnp.transpose(c, (2, 1, 0))


def r1cs_to_qrp_witness_map(
    comp: CompiledR1CS,
    primary: list,
    auxiliary: list,
    d1: RingElem,
    d2: RingElem,
    d3: RingElem,
    domain: RootsDomain,
) -> QRPWitness:
    """Batched jitted witness map (`r1cs_to_qrp.tcc:148-259` semantics).

    One jit-compiled graph per (shape, domain) signature: 9 SpMVs + 9 iNTTs +
    the size-2M product/quotient + the ZK patch.
    """
    ctx = comp.ctx
    full, io, mid = _assignment_batches(ctx, primary, auxiliary)
    arrs = _witness_map_kernel(
        comp, full.res, io.res, mid.res, d1.res, d2.res, d3.res, domain
    )
    (a_io, b_io, c_io, a_mid, b_mid, c_mid, Z, H) = arrs

    def wrap(arr):
        return RingElem(ctx, arr)

    return QRPWitness(
        num_variables=comp.num_variables,
        degree=domain.m,
        num_inputs=comp.primary_input_size,
        d1=d1, d2=d2, d3=d3,
        coefficients_for_ABCs=RingElem.stack(list(primary) + list(auxiliary))
        if (primary or auxiliary)
        else RingElem(ctx, jnp.zeros((0, ctx.L, 1), dtype=jnp.uint32)),
        coefficients_for_A_io=wrap(a_io),
        coefficients_for_B_io=wrap(b_io),
        coefficients_for_C_io=wrap(c_io),
        coefficients_for_A_mid=wrap(a_mid),
        coefficients_for_B_mid=wrap(b_mid),
        coefficients_for_C_mid=wrap(c_mid),
        coefficients_for_Z=wrap(Z),
        coefficients_for_H=wrap(H),
    )


@partial(jax.jit, donate_argnums=(0,))
def _slot_update(out, piece, lo):
    """out[..., lo:lo+piece_width] = piece, donating (reusing) out's
    buffer — the chunked witness map's incremental assembly step."""
    zero = jnp.int32(0)
    return jax.lax.dynamic_update_slice(out, piece, (zero, zero, lo))


def _comp_slot_slice(comp, lo, slot_chunk):
    """Slot-slice a CompiledR1CS: dense per-slot constraint coefficients
    (e.g. the in-circuit-NTT LC, whose coefficients are full ring elements)
    chunk alongside the assignments; scalar (nc == 1) coefficients
    broadcast."""
    if all(c.shape[-1] == 1 for c in comp.coeffs):
        return comp
    return CompiledR1CS(
        ctx=comp.ctx,
        num_constraints=comp.num_constraints,
        num_variables=comp.num_variables,
        primary_input_size=comp.primary_input_size,
        rows=comp.rows,
        cols=comp.cols,
        coeffs=tuple(
            c if c.shape[-1] == 1 else c[..., lo:lo + slot_chunk]
            for c in comp.coeffs
        ),
    )


def prover_witness_map_chunked(comp, p_res, a_res, domain,
                               slot_chunk: int = 128,
                               out_rows: int | None = None):
    """(a_full, b_full, H) for the non-ZK prover, assembled per slot chunk.

    Peak-residency form of `witness_map_kernel_chunked(outputs="prover")`:
    the [1+nv, L, n] full/io/mid assignment batches (each ~2.1 GiB at
    Rq 2^16 — `_assignment_batches` materialized all three plus their
    zero-padding temporaries) never exist.  Each slot chunk's z_full is
    concatenated from the primary/auxiliary slot slices on the fly, so
    device residency is inputs + the three outputs.  Bit-identical to the
    eager path (slots never interact; eval_matrices is linear in z).

    `out_rows`: zero-pad each output's row axis to this count during
    assembly — the streamed prover's chunk plan needs padded vectors, and
    padding the small per-chunk pieces avoids a second full-size copy.
    """
    ctx = comp.ctx
    n = max(p_res.shape[-1], a_res.shape[-1], 1)

    def widen(x):
        if x.shape[-1] == n:
            return x
        assert x.shape[-1] == 1, (x.shape, n)
        return jnp.broadcast_to(x, (*x.shape[:-1], n))

    def rpad(x):
        if out_rows is None or x.shape[0] >= out_rows:
            return x
        return jnp.pad(
            x, ((0, out_rows - x.shape[0]),) + ((0, 0),) * (x.ndim - 1)
        )

    one_w = jnp.broadcast_to(
        RingElem.one(ctx).res, (1, ctx.L, n)
    ).astype(jnp.uint32)
    p_w, a_w = widen(p_res), widen(a_res)
    zero = jnp.zeros((ctx.L, 1), dtype=jnp.uint32)

    if n <= slot_chunk:
        z_full = jnp.concatenate([one_w, p_w, a_w], axis=0)
        outs = _witness_map_kernel(comp, z_full, None, None, zero, zero,
                                   zero, domain, "prover")
        return tuple(rpad(x) for x in outs)
    assert n % slot_chunk == 0, (n, slot_chunk)

    # donated in-place slot assembly: holding every chunk's pieces for a
    # final concatenate keeps ~2x the output footprint live (at Rq 2^16
    # that is the difference between fitting device memory or not); instead each
    # piece is written into its slot range of a preallocated output whose
    # buffer is donated, so peak residency is outputs + one piece set
    out = None
    for lo in range(0, n, slot_chunk):
        z_c = jnp.concatenate(
            [one_w[..., lo:lo + slot_chunk], p_w[..., lo:lo + slot_chunk],
             a_w[..., lo:lo + slot_chunk]], axis=0,
        )
        pieces = [rpad(x) for x in _witness_map_kernel(
            _comp_slot_slice(comp, lo, slot_chunk), z_c, None, None,
            zero, zero, zero, domain, "prover",
        )]
        if out is None:
            out = [
                jnp.zeros((*pc.shape[:-1], n), pc.dtype) for pc in pieces
            ]
        lo_arr = jnp.int32(lo)
        out = [
            _slot_update(o, pc, lo_arr) for o, pc in zip(out, pieces)
        ]
    return tuple(out)


def witness_map_kernel_chunked(comp, z_full, z_io, z_mid, d1r, d2r, d3r,
                               domain, slot_chunk: int = 128,
                               outputs: str = "all"):
    """_witness_map_kernel over slot-axis chunks (Rq rings).

    The witness map is independent per slot, and its temporaries scale
    with n: at Rq n = 8192 each [n, L, 2M] transform operand is n/slot_chunk
    times a chunk's.  Chunking the slot axis bounds device memory to one
    chunk's temporaries and compiles ONE smaller program, reused.
    Bit-identical to the unchunked kernel (slots never interact).

    d1r/d2r/d3r are [L, 1] broadcast constants or [L, n] per-slot vectors
    (poly-ring ZK); per-slot vectors are sliced alongside the assignments.

    `outputs` trims what is materialized (at Rq 2^15 each full-size output
    is ~1 GiB and the full 8-tuple plus its chunk pieces OOM'd HBM):
      "all"    -> (a_io, b_io, c_io, a_mid, b_mid, c_mid, Z, H)
      "prover" -> (a_full, b_full, H)        [groth16 streaming]
      "mid"    -> (a_mid, b_mid, c_mid, H)   [rinocchio streaming]
    """
    n = z_full.shape[-1]
    for d in (d1r, d2r, d3r):
        assert d.shape[-1] in (1, n), (d.shape, n)
    if n <= slot_chunk:
        return _witness_map_kernel(comp, z_full, z_io, z_mid, d1r, d2r, d3r,
                                   domain, outputs)
    assert n % slot_chunk == 0, (n, slot_chunk)

    def dsl(d, lo):
        return d if d.shape[-1] == 1 else d[..., lo:lo + slot_chunk]

    parts = [
        list(_witness_map_kernel(
            _comp_slot_slice(comp, lo, slot_chunk),
            z_full[..., lo:lo + slot_chunk],
            z_io[..., lo:lo + slot_chunk],
            z_mid[..., lo:lo + slot_chunk], dsl(d1r, lo), dsl(d2r, lo),
            dsl(d3r, lo), domain, outputs,
        ))
        for lo in range(0, n, slot_chunk)
    ]
    n_out = len(parts[0])
    z_idx = 6 if outputs == "all" else None
    out = []
    for i in range(n_out):
        if i == z_idx:  # Z is a slot-independent [M+1, L, 1] constant
            out.append(parts[0][i])
        else:
            out.append(jnp.concatenate([p[i] for p in parts], axis=-1))
            for p_ in parts:  # free each piece as soon as it is consumed
                p_[i] = None
    return tuple(out)


@partial(jax.jit, static_argnames=("domain", "outputs"))
def _witness_map_kernel(comp, z_full, z_io, z_mid, d1r, d2r, d3r, domain,
                        outputs: str = "all"):
    ctx = comp.ctx
    M = domain.m

    # (1) constraint evaluations on the domain (rows beyond num_constraints
    # are zero — padding constraints 0*0=0).  "prover" mode needs only the
    # full assignment: eval_matrices is linear in z and io + mid = full, so
    # a_io + a_mid == interp(eval(full)) bit-exactly — 3 SpMVs + 3 iNTTs
    # instead of 9 + 9, and z_io/z_mid may be None.
    evals = {}
    srcs = (
        (("full", z_full),)
        if outputs == "prover"
        else (("full", z_full), ("io", z_io), ("mid", z_mid))
    )
    for name, z in srcs:
        evals[name] = comp.eval_matrices(z, num_rows=M)  # 3 x [M, L, n]

    # (2) interpolate to coefficients: 9 inverse NTTs
    coeffs = {
        name: tuple(_interp(domain, e) for e in evals[name]) for name in evals
    }
    aA, aB, aC = coeffs["full"]

    # (3+4+5) H = upper-half of coeffs(A*B): size-2M NTT convolution.
    # (A*B - C) is divisible by Z = X^M - 1 for a satisfied witness, and C
    # (deg < M) never touches the quotient's source coefficients (DESIGN §3).
    if M > 1:
        plan2 = _ntt.get_plan(ctx.primes, 2 * M)
        af = jnp.transpose(aA, (2, 1, 0))  # [n, L, M]
        bf = jnp.transpose(aB, (2, 1, 0))
        pad = ((0, 0),) * (af.ndim - 1) + ((0, M),)
        af2 = _ntt.cyclic_ntt_rev(jnp.pad(af, pad), plan2)
        bf2 = _ntt.cyclic_ntt_rev(jnp.pad(bf, pad), plan2)
        prod = _ntt.cyclic_intt_nat(
            mul_mod(af2, bf2, plan2.p, plan2.mu, plan2.pbits), plan2
        )  # [n, L, 2M] coefficients of A*B
        h_main = jnp.transpose(prod[..., M:], (2, 1, 0))  # [M, L, n], q_{M-1}=0
    else:
        # M == 1: A,B constants; A*B - C = q * (X - x_0) requires q = 0
        h_main = jnp.zeros_like(aA)

    # (6) patch: (d2*A + d1*B - d3) + d1*d2*Z   (r1cs_to_qrp.tcc:229-235)
    p_, mu_, b_ = ctx.p, ctx.mu, ctx.pbits
    patch = add_mod(
        mul_mod(aA, d2r, p_, mu_, b_),
        mul_mod(aB, d1r, p_, mu_, b_),
        p_,
    )  # [M, L, n]
    H = add_mod(h_main, patch, p_)
    d1d2 = mul_mod(d1r, d2r, p_, mu_, b_)  # [L, 1]
    n = H.shape[-1]
    head = sub_mod(sub_mod(H[0], d3r, p_), d1d2, p_)  # H[0] - d3 - d1*d2
    tail = jnp.broadcast_to(d1d2, (1, ctx.L, n)).astype(jnp.uint32)  # + d1*d2*X^M
    H = jnp.concatenate([head[None], H[1:], tail], axis=0)  # [M+1, L, n]

    # Z = X^M - 1 as a coefficient batch [M+1, L, 1]
    negone = neg_mod(jnp.ones((1, ctx.L, 1), dtype=jnp.uint32), p_)
    zeros = jnp.zeros((M - 1, ctx.L, 1), dtype=jnp.uint32)
    ones = jnp.ones((1, ctx.L, 1), dtype=jnp.uint32)
    Z = jnp.concatenate([negone, zeros, ones], axis=0)

    if outputs == "prover":
        return (aA, aB, H)
    a_io, b_io, c_io = coeffs["io"]
    a_mid, b_mid, c_mid = coeffs["mid"]
    if outputs == "mid":
        return (a_mid, b_mid, c_mid, H)
    return (a_io, b_io, c_io, a_mid, b_mid, c_mid, Z, H)


# ---------------------------------------------------------------------------
# witness map — generic host path (reference control flow, any ring/domain)
# ---------------------------------------------------------------------------


def r1cs_to_qrp_witness_map_generic(
    cs: R1CSConstraintSystem,
    primary: list,
    auxiliary: list,
    d1, d2, d3,
    domain,
) -> QRPWitness:
    """List-based witness map mirroring `r1cs_to_qrp.tcc:148-259` (with the
    corrected constant-column split)."""
    one = type(d1).one(d1.ctx)
    zero = one - one
    m = domain.m
    xs = [domain.get_domain_element(i) for i in range(m)]
    full = list(primary) + list(auxiliary)

    def eval_rows(assignment, const):
        rows = {"a": [], "b": [], "c": []}
        for cons in cs.constraints:
            for key, lc in (("a", cons.a), ("b", cons.b), ("c", cons.c)):
                rows[key].append(lc.evaluate(assignment, const))
        for key in rows:
            rows[key] += [zero] * (m - len(rows[key]))
        return rows

    mid_assign = [zero] * len(primary) + list(auxiliary)
    io_assign = list(primary) + [zero] * len(auxiliary)
    ev_mid = eval_rows(mid_assign, zero)  # constant column NOT in mid
    ev_io = eval_rows(io_assign, one)
    ev_full = eval_rows(full, one)

    a_mid = _poly.interpolate(xs, ev_mid["a"])
    b_mid = _poly.interpolate(xs, ev_mid["b"])
    c_mid = _poly.interpolate(xs, ev_mid["c"])
    a_io = _poly.interpolate(xs, ev_io["a"])
    b_io = _poly.interpolate(xs, ev_io["b"])
    c_io = _poly.interpolate(xs, ev_io["c"])
    aA = _poly.interpolate(xs, ev_full["a"])
    aB = _poly.interpolate(xs, ev_full["b"])
    aC = _poly.interpolate(xs, ev_full["c"])

    Z = domain.vanishing_polynomial()

    H = [zero] * (m + 1)
    for i in range(m):
        H[i] = d2 * aA[i] + d1 * aB[i]
    H[0] = H[0] - d3
    H = domain.add_poly_Z(d1 * d2, H)

    min_C = [-c for c in aC]
    prod = _poly.multiply(aA, aB)
    diff = _poly.add(prod, min_C)
    H_tmp = domain.divide_by_Z(diff)
    for i in range(min(len(H), len(H_tmp))):
        H[i] = H[i] + H_tmp[i]

    return QRPWitness(
        num_variables=cs.num_variables(),
        degree=m,
        num_inputs=cs.num_inputs(),
        d1=d1, d2=d2, d3=d3,
        coefficients_for_ABCs=full,
        coefficients_for_A_io=a_io,
        coefficients_for_B_io=b_io,
        coefficients_for_C_io=c_io,
        coefficients_for_A_mid=a_mid,
        coefficients_for_B_mid=b_mid,
        coefficients_for_C_mid=c_mid,
        coefficients_for_Z=Z,
        coefficients_for_H=H,
    )
