"""Batched cyclic / negacyclic NTT over RNS limbs.

Replaces the reference's SEAL `ntt_inplace` / `small_ntt_tables` usage and the
O(m^2) interpolation cluster (`/root/reference/ringsnark/util/polynomials.tcc:10-43`,
`util/evaluation_domain.tcc:21-60`) with O(M log M) transforms.

Layout: data shaped ``[..., L, M]`` (L = RNS limbs, M = transform size, a power
of two).  Per-limb twiddles are stacked along the leading L axis.

Ordering convention (bit-reversal-free, Harvey/SEAL style):

* ``cyclic_ntt_rev``: decimation-in-frequency, natural coefficients in →
  **bit-reversed** evaluation order out: output index j holds the evaluation
  at ``w^bitrev(j)``.
* ``cyclic_intt_nat``: decimation-in-time, bit-reversed evaluations in →
  natural coefficients out (scaled by M^-1).

All slot-form data in the framework uses the bit-reversed evaluation labeling,
so no permutation gathers are ever materialized; the mapping slot j ↦
evaluation point is exposed via ``NTTPlan.eval_points`` for the evaluation
domain and tests.

Two implementations share these conventions bit for bit: the plain path
(``plain_*``: one XLA pass per butterfly stage, any backend) and, on the GPU,
the fused CUDA kernel of ``ops/ntt_gpu.py``.  ``ntt_route(platform, M)`` alone
decides which one a transform takes.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from . import primes as _primes
from .modops import add_mod, sub_mod, mul_mod

__all__ = [
    "NTTPlan",
    "get_plan",
    "cyclic_ntt_rev",
    "cyclic_intt_nat",
    "negacyclic_ntt_rev",
    "negacyclic_intt_nat",
    "bitrev_indices",
    "ntt_route",
    "routes_taken",
    "MAX_FUSED_M",
    "plain_cyclic_ntt_rev",
    "plain_cyclic_intt_nat",
    "plain_negacyclic_ntt_rev",
    "plain_negacyclic_intt_nat",
]


def bitrev_indices(M: int) -> np.ndarray:
    bits = M.bit_length() - 1
    idx = np.arange(M, dtype=np.int64)
    out = np.zeros_like(idx)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def _mod_powers(w: int, n: int, p: int) -> np.ndarray:
    """[1, w, w^2, ..., w^(n-1)] mod p as uint32, via log(n) numpy doublings."""
    pw = np.array([1], dtype=np.uint64)
    while len(pw) < n:
        step = pow(int(w), len(pw), int(p))
        pw = np.concatenate([pw, (pw * step) % p])
    return pw[:n].astype(np.uint32)


@dataclass(frozen=True)
class NTTPlan:
    """Precomputed tables for size-M (neg)acyclic NTTs over a prime chain.

    Hashable/static: jnp arrays are stored in tuples; jitted functions close
    over the plan rather than threading it as a traced argument.
    """

    primes: tuple[int, ...]
    M: int
    # broadcast-ready limb constants, shape [L, 1]
    p: object = field(hash=False, compare=False)
    mu: object = field(hash=False, compare=False)
    pbits: object = field(hash=False, compare=False)
    # forward DIF stage twiddles: tuple over stages (d = M/2 .. 1) of [L, d]
    fwd_tw: tuple = field(hash=False, compare=False)
    # inverse DIT stage twiddles: tuple over stages (d = 1 .. M/2) of [L, d]
    inv_tw: tuple = field(hash=False, compare=False)
    minv: object = field(hash=False, compare=False)  # [L, 1]
    psi: object = field(hash=False, compare=False)  # [L, M] or None
    psi_inv_scaled: object = field(hash=False, compare=False)  # [L, M] * M^-1 or None
    # host-side tables
    w_np: tuple[int, ...] = field(hash=False, compare=False)  # per-limb M-th root
    eval_points_np: object = field(hash=False, compare=False)  # [L, M] uint32: w^bitrev(j)

    @property
    def L(self) -> int:
        return len(self.primes)


@lru_cache(maxsize=None)
def get_plan(primes: tuple[int, ...], M: int, negacyclic: bool = False) -> NTTPlan:
    assert M & (M - 1) == 0 and M >= 2
    L = len(primes)
    for p in primes:
        order = 2 * M if negacyclic else M
        assert (p - 1) % order == 0, f"prime {p} lacks order-{order} roots"

    p_np = np.array(primes, dtype=np.uint32)
    pr = [_primes.make_prime(p) for p in primes]
    mu_np = np.array([x.mu for x in pr], dtype=np.uint64)
    bits_np = np.array([x.bits for x in pr], dtype=np.uint32)

    ws = [_primes.root_of_unity(p, M) for p in primes]
    w_pows = np.stack([_mod_powers(w, M, p) for w, p in zip(ws, primes)])  # [L, M]
    winv_pows = np.stack(
        [_mod_powers(pow(w, p - 2, p), M, p) for w, p in zip(ws, primes)]
    )

    logM = M.bit_length() - 1
    fwd_tw = []
    for s in range(logM):
        d = M >> (s + 1)
        stride = M // (2 * d)
        fwd_tw.append(np.ascontiguousarray(w_pows[:, : d * stride : stride]))  # [L, d]
    inv_tw = []
    for s in range(logM):
        d = 1 << s
        stride = M // (2 * d)
        inv_tw.append(np.ascontiguousarray(winv_pows[:, : d * stride : stride]))

    minv_np = np.array([pow(M, p - 2, p) for p in primes], dtype=np.uint32)

    psi = psi_inv_scaled = None
    if negacyclic:
        psis = [_primes.root_of_unity(p, 2 * M) for p in primes]
        # choose psi with psi^2 = w so the twist matches the cyclic tables
        psis2 = []
        for psi_c, w, p in zip(psis, ws, primes):
            if pow(psi_c, 2, p) == w:
                psis2.append(psi_c)
            else:
                # find k odd with psi^k matching: psi^2 has order M, both are
                # primitive M-th roots, so w = (psi^2)^k for some k; re-root.
                k = _dlog_pow2(pow(psi_c, 2, p), w, p, M)
                psis2.append(pow(psi_c, k, p))
                assert pow(psis2[-1], 2, p) == w
        psi_pows = np.stack([_mod_powers(s, M, p) for s, p in zip(psis2, primes)])
        psiinv_pows = np.stack(
            [_mod_powers(pow(s, p - 2, p), M, p) for s, p in zip(psis2, primes)]
        )
        psiinv_scaled = (psiinv_pows.astype(np.uint64) * minv_np[:, None]) % p_np[
            :, None
        ].astype(np.uint64)
        psi = psi_pows
        psi_inv_scaled = psiinv_scaled.astype(np.uint32)

    br = bitrev_indices(M)
    eval_points = w_pows[:, br]  # [L, M]: point for slot j

    # all tables are numpy (constants under jit; see rings/context.py note)
    return NTTPlan(
        primes=primes,
        M=M,
        p=p_np[:, None],
        mu=mu_np[:, None],
        pbits=bits_np[:, None],
        fwd_tw=tuple(fwd_tw),
        inv_tw=tuple(inv_tw),
        minv=minv_np[:, None],
        psi=psi,
        psi_inv_scaled=psi_inv_scaled,
        w_np=tuple(ws),
        eval_points_np=eval_points,
    )


def _dlog_pow2(base: int, target: int, p: int, order: int) -> int:
    """Solve base^k = target mod p where base has power-of-two order (small)."""
    x = 1
    for k in range(order):
        if x == target:
            return k
        x = x * base % p
    raise ValueError("discrete log not found")


def _c(arr, extra_dims: int):
    """Reshape a [L, d] limb-constant for broadcasting over extra block dims."""
    return arr.reshape(arr.shape[0], *([1] * extra_dims), arr.shape[1])


# ---------------------------------------------------------------------------
# plain path: one XLA pass per butterfly stage
# ---------------------------------------------------------------------------


def plain_cyclic_ntt_rev(x, plan: NTTPlan):
    """Forward cyclic NTT on the plain path; natural in, bit-reversed out."""
    M = plan.M
    batch = x.shape[:-1]  # (..., L)
    p, mu, b = plan.p, plan.mu, plan.pbits
    p3, mu3, b3 = p[..., None, :], mu[..., None, :], b[..., None, :]
    for s, tw in enumerate(plan.fwd_tw):
        d = M >> (s + 1)
        xr = x.reshape(*batch, M // (2 * d), 2, d)
        a_, b_ = xr[..., 0, :], xr[..., 1, :]
        na = add_mod(a_, b_, p3)
        nb_ = mul_mod(sub_mod(a_, b_, p3), tw[:, None, :], p3, mu3, b3)
        x = jnp.stack([na, nb_], axis=-2).reshape(*batch, M)
    return x


def plain_cyclic_intt_nat(x, plan: NTTPlan, scale: bool = True):
    """Inverse cyclic NTT on the plain path; bit-reversed in, natural out."""
    M = plan.M
    batch = x.shape[:-1]
    p, mu, b = plan.p, plan.mu, plan.pbits
    p3, mu3, b3 = p[..., None, :], mu[..., None, :], b[..., None, :]
    for s, tw in enumerate(plan.inv_tw):
        d = 1 << s
        xr = x.reshape(*batch, M // (2 * d), 2, d)
        a_, b_ = xr[..., 0, :], xr[..., 1, :]
        t = mul_mod(b_, tw[:, None, :], p3, mu3, b3)
        x = jnp.stack([add_mod(a_, t, p3), sub_mod(a_, t, p3)], axis=-2)
        x = x.reshape(*batch, M)
    if scale:
        x = mul_mod(x, plan.minv, p, mu, b)
    return x


def plain_negacyclic_ntt_rev(x, plan: NTTPlan):
    """Negacyclic forward NTT on the plain path: psi twist then cyclic."""
    assert plan.psi is not None, "plan built without negacyclic=True"
    x = mul_mod(x, plan.psi, plan.p, plan.mu, plan.pbits)
    return plain_cyclic_ntt_rev(x, plan)


def plain_negacyclic_intt_nat(y, plan: NTTPlan):
    """Negacyclic inverse on the plain path: cyclic inverse, then the
    psi^-1 twist with M^-1 folded in."""
    assert plan.psi_inv_scaled is not None
    x = plain_cyclic_intt_nat(y, plan, scale=False)
    return mul_mod(x, plan.psi_inv_scaled, plan.p, plan.mu, plan.pbits)


# ---------------------------------------------------------------------------
# route choice
# ---------------------------------------------------------------------------

# Longest row the fused route transforms in one thread block: 2^14 uint32
# residues are 64 KiB of shared memory, so three blocks share an SM.  This
# covers every ring degree the provers use (outer N and inner N' <= 16384);
# longer rows are the witness map's, where few rows make the split pay.
MAX_FUSED_M = 1 << 14


def ntt_route(platform: str, m: int) -> str:
    """How a size-m transform runs on `platform` (a jax backend name).

    "fused": the CUDA row kernel of ops/ntt_gpu.py, whole rows in shared
             memory;
    "split": the four-step M = R * Mi through the GPU kernels: a column pass
             (the stages pairing whole rows), then the row kernel on rows of
             Mi = ntt_gpu.split_inner(M);
    "xla":   the plain path, one XLA pass per stage (every non-GPU backend).
    """
    if platform != "gpu":
        return "xla"
    return "fused" if m <= MAX_FUSED_M else "split"


# (route, M, kind) -> transforms traced since the last `routes_taken(reset=True)`
_ROUTES: Counter = Counter()


def routes_taken(reset: bool = False) -> dict:
    """Which route each traced transform took, as {(route, M, kind): count}."""
    out = dict(_ROUTES)
    if reset:
        _ROUTES.clear()
    return out


def _kernel(x, plan: NTTPlan, inverse: bool, negacyclic: bool,
            scale: bool = True):
    """The routed transform, or None when the plain path applies."""
    route = ntt_route(jax.default_backend(), plan.M)
    kind = ("inv" if inverse else "fwd") + ("-nega" if negacyclic else "-cyc")
    _ROUTES[(route, plan.M, kind)] += 1
    if route == "xla":
        return None
    from . import ntt_gpu

    inner = None if route == "fused" else ntt_gpu.split_inner(plan.M)
    return ntt_gpu.transform(x, plan, inverse=inverse, negacyclic=negacyclic,
                             scale=scale, inner_m=inner)


def cyclic_ntt_rev(x, plan: NTTPlan):
    """Forward cyclic NTT along the last axis; natural in, bit-reversed out."""
    out = _kernel(x, plan, inverse=False, negacyclic=False)
    return plain_cyclic_ntt_rev(x, plan) if out is None else out


def cyclic_intt_nat(x, plan: NTTPlan, scale: bool = True):
    """Inverse cyclic NTT along the last axis; bit-reversed in, natural out
    (scaled by M^-1 unless `scale` is False)."""
    out = _kernel(x, plan, inverse=True, negacyclic=False, scale=scale)
    return plain_cyclic_intt_nat(x, plan, scale) if out is None else out


def negacyclic_ntt_rev(x, plan: NTTPlan):
    """Negacyclic forward NTT: psi-twist then cyclic; natural in, rev out."""
    assert plan.psi is not None, "plan built without negacyclic=True"
    out = _kernel(x, plan, inverse=False, negacyclic=True)
    return plain_negacyclic_ntt_rev(x, plan) if out is None else out


def negacyclic_intt_nat(y, plan: NTTPlan):
    """Negacyclic inverse NTT: cyclic inverse then psi^-1 twist (M^-1 folded)."""
    assert plan.psi_inv_scaled is not None
    out = _kernel(y, plan, inverse=True, negacyclic=True)
    return plain_negacyclic_intt_nat(y, plan) if out is None else out
