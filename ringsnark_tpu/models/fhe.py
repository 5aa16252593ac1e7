"""Minimal outer-level symmetric BGV over ring elements.

The vFHE workloads prove statements ABOUT ciphertexts of an outer FHE scheme
whose ciphertext components live in R_q — i.e. they are `RingElem`s.  The
reference uses SEAL for this outer scheme (e.g.
`benchmarks/bench_mul_SEAL.cpp:56-86`); here a self-contained implementation
over the device ring layer, used to generate authentic circuit values and for
the FHE-side benchmark comparison points
(`bench_logistic_regression_inference.cpp:277-313`).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..rings.context import RingContext
from ..rings.elem import RingElem

__all__ = ["OuterBGV"]


class OuterBGV:
    """Symmetric BGV with plaintext modulus T over the ring context's R_q.

    Ciphertexts are tuples of RingElems in slot form (matching SEAL's
    is_ntt_form invariant).  No relinearization: ct*ct yields 3 components,
    exactly what the ct-mul circuit proves.
    """

    def __init__(self, ctx: RingContext, log_t: int, rng: np.random.Generator):
        assert ctx.N > 1, "outer BGV needs a polynomial ring"
        self.ctx = ctx
        self.T = 1 << log_t
        self.rng = rng
        # ternary secret
        s_coeffs = rng.integers(-1, 2, size=ctx.N).astype(np.int64)
        self.s_coeffs = s_coeffs
        arr = np.stack([(s_coeffs % p).astype(np.uint32) for p in ctx.primes])
        self.s = RingElem.from_coeffs(ctx, arr)

    def _small_poly(self, bound: int) -> tuple[RingElem, np.ndarray]:
        c = self.rng.integers(-bound, bound + 1, size=self.ctx.N).astype(np.int64)
        arr = np.stack([(c % p).astype(np.uint32) for p in self.ctx.primes])
        return RingElem.from_coeffs(self.ctx, arr), c

    def encrypt(self, m_coeffs: list[int]) -> tuple[RingElem, RingElem]:
        """Encrypt an integer-coefficient plaintext (< T): (c0, c1)."""
        assert all(0 <= int(v) < self.T for v in m_coeffs)
        ctx = self.ctx
        a = RingElem.random_element(ctx, self.rng)
        e, _ = self._small_poly(6)
        m = RingElem.from_int_coeffs(ctx, m_coeffs)
        c0 = -(a * self.s) + RingElem.scalar(ctx, self.T) * e + m
        return c0, a

    def encrypt_batch(self, m_coeffs, key=None) -> tuple[RingElem, RingElem]:
        """Encrypt B plaintexts at once: [B, N] integers < T ->
        (c0, c1) RingElem batches [B, L, N].

        One batched NTT + one fused arithmetic dispatch instead of B
        per-element pipelines; this is the batched analog of the
        reference's omp-for encrypt loop (`seal_ring.tcc:336-357`).
        With `key` (a jax PRNG key) the a/e randomness is sampled ON
        DEVICE, so no host-generated randomness crosses to the device.
        `m_coeffs` may be a device array.  The randomness stream differs
        from sequential `encrypt` calls either way; the distribution is
        identical.
        """
        import jax

        ctx = self.ctx
        m_coeffs = jnp.asarray(m_coeffs, dtype=jnp.int64)
        B, N = m_coeffs.shape
        assert N == ctx.N
        ps_np = np.array(ctx.primes, dtype=np.int64)[None, :, None]  # [1,L,1]
        if key is None:
            a_res = np.stack(
                [
                    self.rng.integers(0, p, (B, N), dtype=np.int64)
                    for p in ctx.primes
                ],
                axis=1,
            ).astype(np.uint32)  # [B, L, N]
            e_int = jnp.asarray(self.rng.integers(-6, 7, size=(B, 1, N)))
        else:
            ka, ke = jax.random.split(key)
            cols = [
                jax.random.randint(k, (B, N), 0, int(p), dtype=jnp.uint32)
                for k, p in zip(
                    jax.random.split(ka, ctx.L), ctx.primes
                )
            ]
            a_res = jnp.stack(cols, axis=1)
            e_int = jax.random.randint(ke, (B, 1, N), -6, 7, dtype=jnp.int32)
        e_res = jnp.asarray(
            (e_int.astype(jnp.int64) % ps_np), dtype=jnp.uint32
        )
        m_res = (m_coeffs[:, None, :] % ps_np).astype(jnp.uint32)
        a = RingElem(ctx, jnp.asarray(a_res))
        e = RingElem.from_coeffs(
            ctx, jnp.broadcast_to(e_res, (B, ctx.L, N))
        )
        m = RingElem.from_coeffs(
            ctx, jnp.broadcast_to(m_res, (B, ctx.L, N))
        )
        c0 = -(a * self.s) + RingElem.scalar(ctx, self.T) * e + m
        return c0, a

    @staticmethod
    def multiply(ct1, ct2) -> tuple[RingElem, RingElem, RingElem]:
        """(z0, z1, z2) = (x0, x1) * (y0, y1) — no relinearization."""
        x0, x1 = ct1
        y0, y1 = ct2
        return (x0 * y0, x0 * y1 + x1 * y0, x1 * y1)

    def decrypt(self, ct) -> list[int]:
        """Decrypt a 2- or 3-component ciphertext to integer coefficients."""
        ctx = self.ctx
        acc = ct[0]
        s_pow = RingElem.one(ctx)
        for comp in ct[1:]:
            s_pow = s_pow * self.s
            acc = acc + comp * s_pow
        coeffs = np.asarray(acc.to_coeffs())  # [L, N]
        q = ctx.q
        out = []
        for j in range(ctx.N):
            v = ctx.from_rns(coeffs[:, j])
            if v > q // 2:
                v -= q
            out.append(v % self.T)
        return out
