"""Ring elements as struct-of-arrays pytrees in slot form.

Accelerator-native replacement for the reference's
`RingElem = variant<uint64_t, SealPoly>` (`seal/seal_ring.hpp:26`): the
scalar/poly variant becomes a broadcastable trailing axis of size 1 or N, and
a "vector<RingElem>" becomes a leading batch axis, so protocol inner loops
are fused array ops.

Shape convention: ``res: uint32[*batch, L, n]`` with ``n ∈ {1, N}``.
Slot form uses the bit-reversed-evaluation labeling of ops/ntt.py; constants
are all-slots-equal, matching `seal_ring.tcc:265-277` (constant → diagonal).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.modops import add_mod, sub_mod, neg_mod, mul_mod, inv_mod, pow_mod
from ..ops.ntt import negacyclic_ntt_rev, negacyclic_intt_nat
from .context import RingContext

__all__ = ["RingElem"]


class RingElem:
    """An element (or batch of elements) of R = Z_q[X]/(X^N+1) or Z_q.

    Immutable value semantics; arithmetic is elementwise in slot form.
    Registered as a jax pytree so jitted functions can take/return it.
    """

    __slots__ = ("ctx", "res")

    def __init__(self, ctx: RingContext, res):
        self.ctx = ctx
        self.res = res  # uint32[*batch, L, n]

    # ---- constructors -----------------------------------------------------

    @classmethod
    def scalar(cls, ctx: RingContext, value: int) -> "RingElem":
        """The ring constant `value` (represented with broadcast slot axis)."""
        return cls(ctx, jnp.asarray(ctx.to_rns(int(value))[:, None]))

    @classmethod
    def zero(cls, ctx: RingContext) -> "RingElem":
        return cls.scalar(ctx, 0)

    @classmethod
    def one(cls, ctx: RingContext) -> "RingElem":
        return cls.scalar(ctx, 1)

    @classmethod
    def from_slots(cls, ctx: RingContext, slots) -> "RingElem":
        slots = jnp.asarray(slots, dtype=jnp.uint32)
        assert slots.shape[-2] == ctx.L and slots.shape[-1] in (1, ctx.N)
        return cls(ctx, slots)

    @classmethod
    def from_coeffs(cls, ctx: RingContext, coeffs) -> "RingElem":
        """Build from coefficient form [..., L, N] (applies forward NTT)."""
        coeffs = jnp.asarray(coeffs, dtype=jnp.uint32)
        if ctx.N == 1:
            return cls(ctx, coeffs)
        return cls(ctx, negacyclic_ntt_rev(coeffs, ctx.ntt_plan))

    @classmethod
    def from_int_coeffs(cls, ctx: RingContext, int_coeffs: Iterable[int]) -> "RingElem":
        """Build from a list of integer coefficients (host helper)."""
        cs = list(int_coeffs)
        assert len(cs) <= ctx.N
        arr = np.zeros((ctx.L, ctx.N), dtype=np.uint32)
        for j, c in enumerate(cs):
            arr[:, j] = ctx.to_rns(c)
        return cls.from_coeffs(ctx, arr)

    # ---- sampling (host-side numpy RNG; setup randomness is secret and
    # host-resident, mirroring seal_ring.hpp:72-118) ------------------------

    @classmethod
    def random_element(cls, ctx: RingContext, rng: np.random.Generator) -> "RingElem":
        res = np.stack(
            [rng.integers(0, p, ctx.N, dtype=np.uint64) for p in ctx.primes]
        ).astype(np.uint32)
        return cls(ctx, jnp.asarray(res))

    @classmethod
    def random_invertible_element(
        cls, ctx: RingContext, rng: np.random.Generator
    ) -> "RingElem":
        # uniform over invertible elements == independent uniform nonzero slots
        res = np.stack(
            [rng.integers(1, p, ctx.N, dtype=np.uint64) for p in ctx.primes]
        ).astype(np.uint32)
        return cls(ctx, jnp.asarray(res))

    @classmethod
    def random_nonzero_element(
        cls, ctx: RingContext, rng: np.random.Generator
    ) -> "RingElem":
        while True:
            e = cls.random_element(ctx, rng)
            if not e.is_zero():
                return e

    @classmethod
    def random_exceptional_element(
        cls, ctx: RingContext, rng: np.random.Generator, domain=None
    ) -> "RingElem":
        """A random scalar suitable as the secret evaluation point.

        With a domain, delegates to ``domain.random_exceptional`` (which
        guarantees s - x_i invertible for every domain point).  Without one,
        mirrors the reference (`seal_ring.hpp:72-88`): a uniform integer in
        [2, q_1).
        """
        if domain is not None:
            return domain.random_exceptional(rng)
        return cls.scalar(ctx, int(rng.integers(2, ctx.primes[0])))

    # ---- shape / variant queries ------------------------------------------

    @property
    def is_scalar(self) -> bool:
        return self.res.shape[-1] == 1

    @property
    def is_poly(self) -> bool:
        return self.res.shape[-1] != 1

    @property
    def batch_shape(self) -> tuple:
        return self.res.shape[:-2]

    def broadcast_to_poly(self) -> "RingElem":
        if self.res.shape[-1] == self.ctx.N:
            return self
        return RingElem(
            self.ctx, jnp.broadcast_to(self.res, (*self.res.shape[:-1], self.ctx.N))
        )

    # ---- arithmetic --------------------------------------------------------

    def _coerce(self, other) -> "RingElem":
        if isinstance(other, RingElem):
            assert other.ctx == self.ctx
            return other
        if isinstance(other, (int, np.integer)):
            return RingElem.scalar(self.ctx, int(other))
        return NotImplemented

    def __add__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        return RingElem(self.ctx, add_mod(self.res, o.res, self.ctx.p))

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        return RingElem(self.ctx, sub_mod(self.res, o.res, self.ctx.p))

    def __rsub__(self, other):
        o = self._coerce(other)
        return RingElem(self.ctx, sub_mod(o.res, self.res, self.ctx.p))

    def __mul__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        c = self.ctx
        return RingElem(c, mul_mod(self.res, o.res, c.p, c.mu, c.pbits))

    __rmul__ = __mul__

    def __neg__(self):
        return RingElem(self.ctx, neg_mod(self.res, self.ctx.p))

    def __truediv__(self, other):
        o = self._coerce(other)
        return self * o.inverse()

    def inverse(self) -> "RingElem":
        """Per-slot modular inverse.  Caller must ensure invertibility."""
        c = self.ctx
        return RingElem(c, inv_mod(self.res, c.p, c.mu, c.pbits))

    def pow(self, e: int) -> "RingElem":
        c = self.ctx
        ebits = max(int(e).bit_length(), 1)
        earr = jnp.full((c.L, 1), np.uint64(e), dtype=jnp.uint64)
        return RingElem(c, pow_mod(self.res, earr, c.p, c.mu, c.pbits, ebits=ebits))

    # ---- predicates (host-side) -------------------------------------------

    def is_zero(self) -> bool:
        return bool(np.all(np.asarray(self.res) == 0))

    def is_invertible(self) -> bool:
        return bool(np.all(np.asarray(self.res) != 0))

    def __eq__(self, other):
        if isinstance(other, (int, np.integer)):
            other = RingElem.scalar(self.ctx, int(other))
        if not isinstance(other, RingElem):
            return NotImplemented
        a, b = np.asarray(self.res), np.asarray(other.res)
        a, b = np.broadcast_arrays(a, b)
        return self.ctx == other.ctx and bool((a == b).all())

    def __hash__(self):
        return hash((self.ctx, np.asarray(self.res).tobytes()))

    # ---- conversions -------------------------------------------------------

    def to_coeffs(self):
        """Coefficient form, uint32[..., L, N]."""
        if self.ctx.N == 1:
            return self.broadcast_to_poly().res
        return negacyclic_intt_nat(self.broadcast_to_poly().res, self.ctx.ntt_plan)

    def to_int(self) -> int:
        """CRT-composed integer value — scalar (n==1, no batch) elements only."""
        r = np.asarray(self.res)
        assert r.shape == (self.ctx.L, 1)
        return self.ctx.from_rns(r[:, 0])

    # ---- batching ----------------------------------------------------------

    @staticmethod
    def stack(elems: list["RingElem"]) -> "RingElem":
        """Stack a list into a batch, promoting scalars to a common slot axis.

        Dispatch-frugal for long mixed lists: the naive form issued one
        broadcast per element plus one enormous stack — ~4100 device
        dispatches per prove/verify for the wide-io circuits (in-circuit
        NTT: 4096 scalar wires + 1 dense).  Elements are bucketed by
        shape, each bucket stacked in <=256-operand groups, broadcast
        ONCE per bucket, concatenated, and restored to input order with a
        single gather — tens of dispatches total, identical result.
        """
        assert elems
        ctx = elems[0].ctx
        n = max(e.res.shape[-1] for e in elems)

        def grouped_stack(arrs):
            if len(arrs) <= 256:
                return jnp.stack(arrs)
            return jnp.concatenate(
                [jnp.stack(arrs[i : i + 256])
                 for i in range(0, len(arrs), 256)],
                axis=0,
            )

        shapes = {e.res.shape for e in elems}
        if len(shapes) == 1:
            out = grouped_stack([e.res for e in elems])
            if out.shape[-1] != n:
                out = jnp.broadcast_to(out, (*out.shape[:-1], n))
            return RingElem(ctx, out)

        buckets: dict = {}
        for idx, e in enumerate(elems):
            buckets.setdefault(e.res.shape, []).append((idx, e.res))
        parts, order = [], []
        for shape, items in buckets.items():
            idxs, arrs = zip(*items)
            g = grouped_stack(list(arrs))  # [k, *shape]
            if shape[-1] != n:
                g = jnp.broadcast_to(g, (*g.shape[:-1], n))
            parts.append(g)
            order.extend(idxs)
        res = jnp.concatenate(parts, axis=0)
        inv = np.argsort(np.array(order))
        return RingElem(ctx, res[jnp.asarray(inv)])

    def __getitem__(self, idx) -> "RingElem":
        return RingElem(self.ctx, self.res[idx])

    def __len__(self):
        assert self.batch_shape, "not a batch"
        return self.res.shape[0]

    def __iter__(self):
        # explicit iterator: jax clamps out-of-bounds concrete indices, so the
        # implicit __getitem__ sequence protocol would never terminate
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        r = np.asarray(self.res)
        if r.shape[-1] == 1 and r.ndim == 2:
            return f"RingElem({self.to_int()})"
        return f"RingElem(shape={r.shape}, L={self.ctx.L}, N={self.ctx.N})"


def _flatten(e: RingElem):
    return (e.res,), e.ctx


def _unflatten(ctx, children):
    return RingElem(ctx, children[0])


jax.tree_util.register_pytree_node(RingElem, _flatten, _unflatten)
