"""The Encoding API: E(.) with encode/decode/add/mul-by-ring/inner_product.

Mirrors the reference `EncodingElem` surface
(`/root/reference/ringsnark/seal/seal_ring.hpp:216-409`); a "vector of
encodings" is one `Encoding` with a leading batch axis, so the prover's
inner products are fused multiply-accumulate kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..rings.elem import RingElem
from . import bgv
from .context import EncodingContext, SecretKey

__all__ = ["Encoding", "DecodingError", "encode", "decode", "inner_product"]


class DecodingError(Exception):
    """Noise budget exhausted (reference `decoding_error`,
    `seal_ring.tcc:446-454`)."""


class Encoding:
    """A batch of encodings: ciphertext components [*batch, L, L'_lvl, N'].

    `level` counts modswitches applied (static); the implied plaintext
    correction factor lives in `EncodingContext.correction_factor(level)`.
    """

    __slots__ = ("ctx", "c0", "c1", "level")

    def __init__(self, ctx: EncodingContext, c0, c1, level: int = 0):
        self.ctx = ctx
        self.c0 = c0
        self.c1 = c1
        self.level = level

    # ---- shape -------------------------------------------------------------

    @property
    def batch_shape(self):
        return self.c0.shape[:-3]

    def __len__(self):
        assert self.batch_shape
        return self.c0.shape[0]

    def __getitem__(self, idx):
        return Encoding(self.ctx, self.c0[idx], self.c1[idx], self.level)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def is_zero_ct(self) -> bool:
        """Transparent-zero check (host)."""
        return bool(np.all(np.asarray(self.c0) == 0)) and bool(
            np.all(np.asarray(self.c1) == 0)
        )

    # ---- homomorphic ops ---------------------------------------------------

    def __add__(self, other: "Encoding") -> "Encoding":
        assert self.ctx == other.ctx
        a, b = self, other
        while a.level < b.level:
            a = a.modswitch()
        while b.level < a.level:
            b = b.modswitch()
        c0, c1 = bgv.ct_add(a.ctx, (a.c0, a.c1), (b.c0, b.c1), a.level)
        return Encoding(a.ctx, c0, c1, a.level)

    def __mul__(self, r) -> "Encoding":
        """Encoding * RingElem (ciphertext-plaintext multiply)."""
        assert isinstance(r, RingElem)
        c0, c1 = bgv.ct_mul_plain(self.ctx, (self.c0, self.c1), r.res, self.level)
        return Encoding(self.ctx, c0, c1, self.level)

    __rmul__ = __mul__

    def modswitch(self) -> "Encoding":
        assert self.level + 1 < self.ctx.L_inner, "no more limbs to drop"
        c0, c1 = bgv.modswitch(self.ctx, (self.c0, self.c1), self.level)
        return Encoding(self.ctx, c0, c1, self.level + 1)

    def sum_batch(self) -> "Encoding":
        """Sum over the leading batch axis (lazy u64 accumulate + Barrett)."""
        from ..ops.modops import barrett_reduce_u64

        p, mu, b = self.ctx.inner_consts(self.level)
        c0 = barrett_reduce_u64(jnp.sum(self.c0.astype(jnp.uint64), axis=0), p, mu, b)
        c1 = barrett_reduce_u64(jnp.sum(self.c1.astype(jnp.uint64), axis=0), p, mu, b)
        return Encoding(self.ctx, c0, c1, self.level)

    def __eq__(self, other):
        if not isinstance(other, Encoding):
            return NotImplemented
        return (
            self.level == other.level
            and bool(np.array_equal(np.asarray(self.c0), np.asarray(other.c0)))
            and bool(np.array_equal(np.asarray(self.c1), np.asarray(other.c1)))
        )

    def size_in_bits(self) -> int:
        batch = int(np.prod(self.batch_shape)) if self.batch_shape else 1
        return self.ctx.size_in_bits(batch, self.level)

    @classmethod
    def zero(cls, ctx: EncodingContext, batch_shape=(), level: int = 0) -> "Encoding":
        """The explicit transparent-zero encoding (valid encryption of 0 with
        zero noise; replaces the reference's SEAL exception dance,
        `seal_ring.tcc:493-504`)."""
        shape = (*batch_shape, ctx.L, ctx.L_inner - level, ctx.n_inner)
        z = jnp.zeros(shape, dtype=jnp.uint32)
        return cls(ctx, z, z, level)


# Residues per encode call (2^22 = 16 MiB per ciphertext component): a
# batch past it is encrypted in chunks, so every large batch reuses ONE
# compiled per-chunk kernel instead of compiling a program per batch size,
# and device memory holds one chunk's encryption temporaries at a time.
_ENCODE_CHUNK_ELEMS = 1 << 22


def encode(ctx: EncodingContext, sk: SecretKey, rs: RingElem, key) -> Encoding:
    """Encrypt a RingElem batch ([B, L, n] slots) under the per-limb keys.

    Batched kernel (vs the reference's per-element OpenMP loop,
    `seal_ring.tcc:336-357`), chunked along the batch axis (see
    `_ENCODE_CHUNK_ELEMS`); chunk i draws its randomness
    from `fold_in(key, i)` (one chunk encrypts with `key` itself, so small
    batches are unchanged).  `key` is a jax PRNG key.
    """
    slots = rs.broadcast_to_poly().res if rs.res.shape[-1] != ctx.ring.N else rs.res
    if slots.ndim < 3:  # single element [L, n]
        c0, c1 = bgv.encrypt(ctx, sk, slots, key)
        return Encoding(ctx, c0, c1, 0)
    B = slots.shape[0]
    per_row = ctx.L * ctx.L_inner * ctx.n_inner
    chunk = max(8, _ENCODE_CHUNK_ELEMS // per_row)
    if B <= chunk:
        c0, c1 = bgv.encrypt(ctx, sk, slots, key)
        return Encoding(ctx, c0, c1, 0)
    # pad to a whole number of chunks: one compiled kernel, reused; padded
    # rows are discarded after (their randomness is never observed)
    import jax

    B_pad = -(-B // chunk) * chunk
    if B_pad != B:
        slots = jnp.pad(
            slots, [(0, B_pad - B)] + [(0, 0)] * (slots.ndim - 1)
        )
    c0s, c1s = [], []
    for i in range(B_pad // chunk):
        c0, c1 = bgv.encrypt(
            ctx, sk, slots[i * chunk : (i + 1) * chunk],
            jax.random.fold_in(key, i),
        )
        c0s.append(c0)
        c1s.append(c1)
    c0 = jnp.concatenate(c0s, axis=0)[:B]
    c1 = jnp.concatenate(c1s, axis=0)[:B]
    return Encoding(ctx, c0, c1, 0)


def decode(ctx: EncodingContext, sk: SecretKey, e: Encoding) -> RingElem:
    """Decrypt one encoding back to a RingElem (noise-budget checked).

    Mirrors `seal_ring.tcc:435-477`: budget <= 0 raises DecodingError; the
    all-zero (transparent) ciphertext decodes to zero.
    """
    slots, budget = bgv.decrypt_to_slots(ctx, sk, (e.c0, e.c1), e.level)
    if not e.is_zero_ct() and (budget <= 0).any():
        raise DecodingError(
            f"noise budget exhausted: min budget {int(budget.min())} <= 0"
        )
    n = ctx.ring.N
    return RingElem(ctx.ring, jnp.asarray(slots[..., :n]))


def inner_product(
    a: Encoding,
    b: RingElem,
    use_modswitch: bool = True,
) -> Encoding:
    """sum_i E_i * r_i over the leading batch axis.

    Deviation from the reference's staged-modswitch schedule
    (`seal_ring.tcc:361-433`, which switches every TERM once after its
    plain-multiply plus the running sum at checkpoints): here the whole
    batch is multiply-accumulated at level 0 and only the FINAL sum is
    switched down to the floor.  This dominates on both axes (DESIGN.md §7):

    * noise — per-term switching yields B*(e/Q_drop + e_switch); switching
      the sum yields B*e/Q_drop + e_switch, i.e. the switch-rounding noise
      enters once instead of B times;
    * compute — the per-term switch costs ~2*L' NTTs per term (the round-1
      prover's dominant cost at scale); switching one ciphertext is
      O(L'*N' log N') TOTAL, so the hot loop is a pure multiply-accumulate.

    The result level equals the reference schedule's (the floor), so proof
    sizes match.  The lazy u64 accumulation is exact and order-independent,
    making the sum bit-identical under any 'data'-axis sharding.
    """
    ctx = a.ctx
    B = len(a)
    assert b.res.shape[0] == B
    acc = (a * b).sum_batch()
    if not use_modswitch:
        return acc
    # With 31-bit limbs and a 31-bit plain modulus, at least `floor_limbs`
    # (>= 2) limbs must remain for noise headroom; the deepest usable level:
    max_level = max(ctx.L_inner - ctx.floor_limbs, 0)
    for _ in range(max_level):
        acc = acc.modswitch()
    return acc
