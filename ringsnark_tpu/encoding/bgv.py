"""Core batched BGV-symmetric operations on raw arrays.

Everything operates on ciphertext component arrays shaped
``uint32[*batch, L, L'_lvl, N']`` (L outer limbs = independent schemes,
L'_lvl inner RNS limbs at the current level, N' inner degree) kept in
inner-NTT (evaluation) form, and plaintext slot arrays ``[*batch, L, n]``.

Replaces SEAL's Encryptor/Decryptor/Evaluator usage in
`/root/reference/ringsnark/seal/seal_ring.tcc:324-548`.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import ntt as _ntt
from ..ops.modops import add_mod, sub_mod, neg_mod, mul_mod, barrett_reduce_u64
from .context import EncodingContext, SecretKey

__all__ = [
    "plain_to_inner_ntt",
    "encrypt",
    "decrypt_to_slots",
    "decrypt_to_slots_exact",
    "ct_add",
    "ct_mul_plain",
    "modswitch",
]


def _slots_to_plain_coeffs(ctx: EncodingContext, slots):
    """[*, L, n] outer slot values -> plaintext coefficients mod t_i [*, L, N'].

    The batch-encoding step (`seal_ring.tcc:349-353`): place the n outer slot
    values into the first n inner slots (zero beyond) and inverse-NTT mod t_i.
    """
    # scalar ring elems (n == 1) are all-slots constants: broadcast to N first
    N = ctx.ring.N
    slots = jnp.broadcast_to(slots, (*slots.shape[:-1], N))
    padded = jnp.pad(slots, [(0, 0)] * (slots.ndim - 1) + [(0, ctx.n_inner - N)])
    return _ntt.negacyclic_intt_nat(padded, ctx.plain_plan)


def _lift_centered(ctx: EncodingContext, pt_coeffs, level: int):
    """Centered lift of plaintext coeffs (mod t_i) into each inner limb.

    [*, L, N'] -> [*, L, L'_lvl, N'].  v > t/2 maps to v - t ≡ v - t + Q_j.
    """
    t = jnp.asarray(ctx.t_np)[:, None]  # [L, 1]
    Q = ctx.inner_consts(level)[0][:, 0]  # [L'_lvl]
    v = pt_coeffs[..., :, None, :]  # [*, L, 1, N']
    t_ = t[:, None, :]  # [L, 1, 1]
    big = v > (t_ >> 1)
    Qb = Q[None, :, None]  # [1, L', 1]
    lifted = jnp.where(big, v + Qb - t_, v)
    # v <= t/2 may still exceed Q_j when t_i > Q_j: one conditional subtract
    lifted = jnp.where(lifted >= Qb, lifted - Qb, lifted)
    return lifted.astype(jnp.uint32)


def plain_to_inner_ntt(ctx: EncodingContext, slots, level: int = 0):
    """Outer slot values -> inner-NTT plaintext operand [*, L, L'_lvl, N'].

    Scalar fast path (N == 1, the Z_q integer backend): the value is encoded
    as the CONSTANT polynomial (all inner slots equal) instead of the
    slot-0 embedding.  The NTT form of a constant is the constant itself, so
    the prover's ct x pt hot loop needs ZERO transforms per term — the
    per-term plaintext-NTT storm that dominates the reference's
    `multiply_plain` (`seal_int/seal_ring.tcc:108-121`) disappears, and the
    noise growth factor drops from ~N'*t/2 (dense poly) to |v| <= t/2.
    Decode is unchanged: every slot of the result carries the value.
    """
    if ctx.ring.N == 1 and slots.shape[-1] == 1:
        lifted = _lift_centered(ctx, slots, level)  # [*, L, L', 1]
        return jnp.broadcast_to(lifted, (*lifted.shape[:-1], ctx.n_inner))
    coeffs = _slots_to_plain_coeffs(ctx, slots)
    lifted = _lift_centered(ctx, coeffs, level)
    return _ntt.negacyclic_ntt_rev(lifted, ctx.inner_plan(level))


def _sample_uniform(ctx: EncodingContext, key, batch_shape):
    """Uniform element of R_Q in NTT form: independent uniform residues.

    jax.random.randint draws 64 bits per uint32 output and reduces the
    double-width value mod the span, so the residue bias is ~Q/2^64 ≈ 2^-33
    per coefficient — the standard negligible-bias regime (SEAL's rejection
    sampler is exactly uniform; the distance is cryptographically
    irrelevant for the public c1 = a component).
    """
    Qs = ctx.inner_primes
    keys = jax.random.split(key, len(Qs))
    cols = [
        jax.random.randint(
            k, (*batch_shape, ctx.L, ctx.n_inner), 0, int(Q), dtype=jnp.uint32
        )
        for k, Q in zip(keys, Qs)
    ]
    return jnp.stack(cols, axis=-2)  # [*, L, L', N']


def _cbd_k(stddev: float) -> int:
    """Centered-binomial parameter with variance k/2 >= stddev^2."""
    return max(1, int(np.ceil(2.0 * stddev * stddev)))


def _sample_error_ntt(ctx: EncodingContext, key, batch_shape):
    """Centered-binomial error poly (variance k/2, k = ceil(2*sigma^2)),
    per inner limb, NTT form.

    Deviation from SEAL's clipped discrete Gaussian: CBD matches the target
    variance (sigma=3.2 -> k=21, sigma_cbd=3.24) and is the standard
    Gaussian replacement in lattice schemes (Kyber/NewHope), and costs two
    popcounts per coefficient where `jax.random.normal` runs an erfinv
    chain.  |e| <= k << Q_j, so the per-limb residue is a conditional
    add."""
    k = _cbd_k(ctx.error_stddev)
    # k > 32 (sigma > 4) draws multiple uint32 words per side; the last
    # word is masked to the remaining k mod 32 bits
    n_words = -(-k // 32)
    shape = (*batch_shape, ctx.L, ctx.n_inner)
    u = jax.random.bits(key, (2, n_words, *shape), dtype=jnp.uint32)
    last_mask = jnp.uint32((1 << (k - 32 * (n_words - 1))) - 1)
    masks = jnp.concatenate(
        [
            jnp.full((n_words - 1,), 0xFFFFFFFF, dtype=jnp.uint32),
            last_mask[None],
        ]
    ).reshape(n_words, *([1] * len(shape)))
    pops = jnp.sum(
        jax.lax.population_count(u & masks).astype(jnp.int32), axis=1
    )
    e = pops[0] - pops[1]
    Q = jnp.asarray(ctx.Q_np.astype(np.int32))[:, None]  # [L', 1]
    e_ = e[..., :, None, :]  # [*, L, 1, N'] — broadcasts against Q [L', 1]
    res = jnp.where(e_ < 0, e_ + Q, e_).astype(jnp.uint32)
    return _ntt.negacyclic_ntt_rev(res, ctx.inner_plan(0))


def encrypt(ctx: EncodingContext, sk: SecretKey, slots, key):
    """Symmetric BGV encryption of a batch of outer-slot vectors.

    slots: uint32[*batch, L, n] -> (c0, c1): uint32[*batch, L, L', N'] with
    c1 = a,  c0 = -(a . s) + t*e + m   so that c0 + c1.s = m + t*e (mod Q).
    """
    return _encrypt_kernel(ctx, sk.s_ntt, slots, key)


@partial(jax.jit, static_argnames=("ctx",))
def _encrypt_kernel(ctx: EncodingContext, s_ntt, slots, key):
    m = plain_to_inner_ntt(ctx, slots, level=0)
    return _encrypt_from_m(ctx, s_ntt, m, key)


def _encrypt_from_m(ctx: EncodingContext, s_ntt, m, key):
    """Encrypt with the plaintext already in inner-NTT operand form
    [*, L, L', N'] (lets callers hoist the plaintext NTTs out of scan
    bodies — transform-inside-scan programs hang this environment's remote
    compiler, and a batched pre-NTT is faster anyway)."""
    batch_shape = m.shape[:-3]
    k_a, k_e = jax.random.split(key)
    a = _sample_uniform(ctx, k_a, batch_shape)
    e = _sample_error_ntt(ctx, k_e, batch_shape)
    p, mu, b = ctx.inner_consts(0)
    # limb-constant broadcast: arrays are [*, L, L', N'], consts [L', 1]
    As = mul_mod(a, s_ntt, p, mu, b)
    te = mul_mod(e, ctx.t_mod_Q, p, mu, b)
    c0 = add_mod(sub_mod(m, As, p), te, p)
    return c0, a


@partial(jax.jit, static_argnames=("ctx", "level"))
def ct_add(ctx: EncodingContext, ct_a, ct_b, level: int):
    p = ctx.inner_consts(level)[0]
    return (
        add_mod(ct_a[0], ct_b[0], p),
        add_mod(ct_a[1], ct_b[1], p),
    )


@partial(jax.jit, static_argnames=("ctx", "level"))
def ct_mul_plain(ctx: EncodingContext, ct, slots, level: int):
    """ct * plain(slot values) — pointwise in NTT form
    (`seal_ring.tcc:509-548` multiply_plain)."""
    pt = plain_to_inner_ntt(ctx, slots, level)
    p, mu, b = ctx.inner_consts(level)
    return (
        mul_mod(ct[0], pt, p, mu, b),
        mul_mod(ct[1], pt, p, mu, b),
    )


@partial(jax.jit, static_argnames=("ctx", "level"))
def modswitch(ctx: EncodingContext, ct, level: int):
    """Drop the last inner limb: (c - d)/Q_last with d ≡ c (mod Q_last),
    d ≡ 0 (mod t_i), |d| small.  Returns ciphertext at level+1.

    Scales the plaintext by Q_last^{-1} mod t_i — tracked by
    `EncodingContext.correction_factor` and undone at decode (the reference
    relies on SEAL's internal BGV correction factor).
    """
    primes = ctx.level_primes(level)
    Q_last = primes[-1]
    plan = ctx.inner_plan(level)
    plan_next = ctx.inner_plan(level + 1)
    p_next, mu_next, b_next = ctx.inner_consts(level + 1)

    out = []
    t = jnp.asarray(ctx.t_np.astype(np.int64))[:, None]  # [L, 1]
    # per outer limb: Q_last^{-1} mod t_i
    qinv_t = jnp.asarray(
        np.array(
            [pow(Q_last, -1, t_i) for t_i in ctx.ring.primes], dtype=np.int64
        )
    )[:, None]
    for comp in ct:
        coeffs = _ntt.negacyclic_intt_nat(comp, plan)  # [*, L, L', N']
        r = coeffs[..., -1, :].astype(jnp.int64)  # [*, L, N'] mod Q_last
        r_c = jnp.where(r > (Q_last >> 1), r - Q_last, r)  # centered
        # u = (-r_c) * Q_last^{-1} mod t, centered
        u = (-r_c % t) * qinv_t % t
        u_c = jnp.where(u > (t >> 1), u - t, u)
        d = r_c + Q_last * u_c  # |d| <= Q_last*(t+1)/2 — fits int64
        rest = coeffs[..., :-1, :].astype(jnp.int64)  # [*, L, L'-1, N']
        Qs = jnp.asarray(np.array(primes[:-1], dtype=np.int64))[:, None]
        num = (rest - d[..., None, :]) % Qs  # (c_j - d) mod Q_j
        qlast_inv = jnp.asarray(
            np.array([pow(Q_last, -1, Q) for Q in primes[:-1]], dtype=np.uint64)
        )[:, None]
        scaled = barrett_reduce_u64(
            num.astype(jnp.uint64) * qlast_inv, p_next, mu_next, b_next
        )
        out.append(_ntt.negacyclic_ntt_rev(scaled, plan_next))
    return tuple(out)


@partial(jax.jit, static_argnames=("ctx", "level"))
def _ct_s_coeffs(ctx: EncodingContext, s_ntt, c0, c1, level: int):
    """Coefficient form of c0 + c1*s at the given level: [*, L, L'_lvl, N']."""
    plan = ctx.inner_plan(level)
    p, mu, b = ctx.inner_consts(level)
    s = s_ntt[..., : len(ctx.level_primes(level)), :]
    cts = add_mod(c0, mul_mod(c1, s, p, mu, b), p)
    return _ntt.negacyclic_intt_nat(cts, plan)


def decrypt_to_slots(ctx: EncodingContext, sk: SecretKey, ct, level: int):
    """Decrypt -> (slot values uint32[*, L, N'], noise budget bits [*, L]).

    Device-side RNS decryption: CRT interpolation computes the centered value
    mod t without big integers —
        c(s) = sum_j y_j * (Q/Q_j) - v*Q  with  y_j = c_j * (Q/Q_j)^{-1} mod Q_j,
        v = round(sum_j y_j / Q_j)
    where v (and the centering indicator / noise magnitude) come from a
    float64 sum — exact here because valid ciphertexts keep sum frac far from
    the 0.5 boundary (|c(s)| << Q/2; the same margin the budget check
    enforces).  Noise budget mirrors the reference's
    `invariant_noise_budget(...) <= 0` -> decoding_error semantics
    (`seal_ring.tcc:446-454`).  `decrypt_to_slots_exact` is the big-int
    oracle used to cross-validate this path in tests.
    """
    slots, budget = _decrypt_device(
        ctx, sk.s_ntt, ct[0], ct[1], level
    )
    return np.asarray(slots), np.asarray(budget)


@partial(jax.jit, static_argnames=("ctx", "level"))
def _decrypt_device(ctx: EncodingContext, s_ntt, c0, c1, level: int):
    primes = ctx.level_primes(level)
    Lp = len(primes)
    coeffs = _ct_s_coeffs(ctx, s_ntt, c0, c1, level)  # [*, L, L', N']

    Q = 1
    for q in primes:
        Q = Q * q
    # y_j = c_j * (Q/Q_j)^{-1} mod Q_j
    inv_np = np.array(
        [pow(Q // qj, -1, qj) for qj in primes], dtype=np.uint64
    )[:, None]
    pj, muj, bj = ctx.inner_consts(level)
    y = barrett_reduce_u64(coeffs.astype(jnp.uint64) * inv_np, pj, muj, bj)

    # v = round(sum_j y_j / Q_j); frac = sum - v in [-0.5, 0.5)
    fr = jnp.sum(
        y.astype(jnp.float64) / np.array(primes, dtype=np.float64)[:, None],
        axis=-2,
    )  # [*, L, N']
    v = jnp.round(fr)
    resid = fr - v  # c(s)/Q in [-0.5, 0.5)

    # noise budget: log2((Q/2) / |c(s)|) = -1 - log2(max |resid|)
    absr = jnp.max(jnp.abs(resid), axis=-1)  # [*, L]
    budget = jnp.floor(-1.0 - jnp.log2(jnp.maximum(absr, 2.0**-62))).astype(
        jnp.int64
    )

    # centered(c(s)) mod t = sum_j y_j*(Q/Q_j mod t) - v*(Q mod t)  (mod t)
    t_np = ctx.t_np  # [L]
    Mj_mod_t = np.array(
        [[(Q // qj) % int(t) for qj in primes] for t in t_np], dtype=np.uint64
    )  # [L, L']
    Q_mod_t = np.array([Q % int(t) for t in t_np], dtype=np.uint64)  # [L]
    tvec = t_np.astype(np.uint64)  # [L]
    # per-product reduction mod t (u64 exact: y, Mj_mod_t < 2^31), lazy sum
    m_terms = (y.astype(jnp.uint64) * Mj_mod_t[:, :, None]) % tvec[:, None, None]
    acc = jnp.sum(m_terms, axis=-2)  # [*, L, N'] — < L' * t < 2^36
    v_term = (v.astype(jnp.uint64) * Q_mod_t[:, None]) % tvec[:, None]
    m = (acc + tvec[:, None] - v_term) % tvec[:, None]

    # undo the modswitch correction factor
    corr = ctx.correction_factor(level)
    inv_corr = np.array(
        [pow(int(c), -1, int(t_i)) for c, t_i in zip(corr, ctx.ring.primes)],
        dtype=np.uint64,
    )
    m = (m * inv_corr[:, None]) % tvec[:, None]
    m_coeffs = m.astype(jnp.uint32)

    slots = _ntt.negacyclic_ntt_rev(m_coeffs, ctx.plain_plan)
    return slots, budget


def decrypt_to_slots_exact(ctx: EncodingContext, sk: SecretKey, ct, level: int):
    """Big-int oracle decryption (host); cross-validates _decrypt_device."""
    primes = ctx.level_primes(level)
    coeffs = np.asarray(_ct_s_coeffs(ctx, sk.s_ntt, ct[0], ct[1], level))

    # CRT-compose, centered
    Q = 1
    for q in primes:
        Q = Q * q
    comp = np.zeros(coeffs.shape[:-2] + coeffs.shape[-1:], dtype=object)
    for j, qj in enumerate(primes):
        Mj = Q // qj
        cj = int(pow(Mj, -1, qj))
        comp += coeffs[..., j, :].astype(object) * (Mj * cj)
    comp %= Q
    centered = np.where(comp > Q // 2, comp - Q, comp)  # objects, centered

    # noise budget (bits): floor(log2((Q/2) / |c(s)|_inf)) via exact ints
    absmax = np.abs(centered).max(axis=-1)  # [*, L], Python ints
    budget = np.array(
        [((Q // 2) // max(int(x), 1)).bit_length() - 1 for x in absmax.flat],
        dtype=np.int64,
    ).reshape(absmax.shape)

    # message = centered mod t, then undo the modswitch correction factor
    t = ctx.t_np.astype(object)  # [L]
    tb = t[(None,) * (centered.ndim - 2) + (slice(None), None)]
    m = centered % tb  # [*, L, N'] objects in [0, t)
    corr = ctx.correction_factor(level)
    inv_corr = np.array(
        [pow(int(c), -1, int(t_i)) for c, t_i in zip(corr, ctx.ring.primes)],
        dtype=object,
    )
    m = (m * inv_corr[(None,) * (centered.ndim - 2) + (slice(None), None)]) % tb
    m_coeffs = m.astype(np.uint64).astype(np.uint32)

    # plaintext coefficients -> slots (forward NTT mod t_i)
    slots = _ntt.negacyclic_ntt_rev(jnp.asarray(m_coeffs), ctx.plain_plan)
    return np.asarray(slots), budget
