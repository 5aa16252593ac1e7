"""Coefficient-sharded (neg)acyclic NTT over a device-mesh axis.

The reference's `ntt_inplace` is single-core shared-memory
(SURVEY.md §2.3, `/root/reference/` SEAL backend call-sites at
`ringsnark/seal/seal_ring.tcc` / `microbench.cpp:148-159`); this module is the
multi-device scale-out equivalent: the transform's coefficient axis is sharded
over a mesh axis and the first ``log2(D)`` butterfly stages exchange blocks
with their partner device via ``lax.ppermute`` (NVLink peer traffic between GPUs), after
which all remaining stages are device-local and reuse the single-device NTT
(``ops.ntt``, routed by ``ntt_route``).

Why this decomposition is exact: with DIF stage ``s`` pairing elements at
distance ``d = M >> (s+1)``, a block layout of ``Mc = M/D`` contiguous
coefficients per device makes stages with ``d >= Mc`` pure block exchanges
(partner = ``device_index XOR d/Mc``), and every later stage both fits inside
a block and uses stage twiddles ``w_M^(M/(2d)·j)`` identical to those of a
size-``Mc`` transform — so the local remainder IS the single-device kernel.
The inverse (DIT) mirrors this: local size-``Mc`` inverse first, then
``log2(D)`` exchange stages, then the global ``M^-1`` / psi^-1 scaling.

Ordering conventions match ``ops/ntt.py`` exactly (natural in → bit-reversed
out; bit-reversed in → natural out), with storage block-sharded along the
mesh axis; results are bit-identical to the single-device path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..ops.modops import add_mod, sub_mod, mul_mod
from ..ops.ntt import NTTPlan, get_plan, cyclic_ntt_rev, cyclic_intt_nat

__all__ = ["sharded_ntt", "make_sharded_ntt"]


def _axis_size(mesh, axis: str) -> int:
    return mesh.shape[axis]


def _tw_slice(tw, offset, width: int):
    """Device-local [L, width] slice of a stage twiddle table [L, d]."""
    return lax.dynamic_slice_in_dim(jnp.asarray(tw), offset, width, axis=1)


def _fwd_local(xl, plan: NTTPlan, local_plan: NTTPlan, D: int, axis: str):
    """Per-device body of the forward cyclic NTT (natural in, rev out)."""
    M, Mc = plan.M, plan.M // D
    idx = lax.axis_index(axis)
    p, mu, b = plan.p, plan.mu, plan.pbits
    k = D.bit_length() - 1
    for s in range(k):
        d = M >> (s + 1)
        pd = d // Mc  # partner distance in devices
        other = lax.ppermute(
            xl, axis, perm=[(i, i ^ pd) for i in range(D)]
        )
        is_hi = ((idx // pd) % 2).astype(jnp.bool_)
        # lo holds a (new a = a + b); hi holds b (new b = (a - b) * tw)
        off = (idx * Mc) % d
        tw = _tw_slice(plan.fwd_tw[s], off, Mc)
        lo_val = add_mod(xl, other, p)
        hi_val = mul_mod(sub_mod(other, xl, p), tw, p, mu, b)
        xl = jnp.where(is_hi, hi_val, lo_val)
    return cyclic_ntt_rev(xl, local_plan)


def _inv_local(xl, plan: NTTPlan, local_plan: NTTPlan, D: int, axis: str,
               negacyclic: bool):
    """Per-device body of the inverse NTT (rev in, natural out, scaled)."""
    M, Mc = plan.M, plan.M // D
    idx = lax.axis_index(axis)
    p, mu, b = plan.p, plan.mu, plan.pbits
    logM = M.bit_length() - 1
    logMc = Mc.bit_length() - 1
    xl = cyclic_intt_nat(xl, local_plan, scale=False)
    for s in range(logMc, logM):
        d = 1 << s
        pd = d // Mc
        other = lax.ppermute(
            xl, axis, perm=[(i, i ^ pd) for i in range(D)]
        )
        is_hi = ((idx // pd) % 2).astype(jnp.bool_)
        off = (idx * Mc) % d
        tw = _tw_slice(plan.inv_tw[s], off, Mc)
        # lo: new a = a + b*tw (b received); hi: new b = a - b*tw (a received)
        t_lo = mul_mod(other, tw, p, mu, b)
        t_hi = mul_mod(xl, tw, p, mu, b)
        lo_val = add_mod(xl, t_lo, p)
        hi_val = sub_mod(other, t_hi, p)
        xl = jnp.where(is_hi, hi_val, lo_val)
    if negacyclic:
        scale = _tw_slice(plan.psi_inv_scaled, idx * Mc, Mc)
    else:
        scale = plan.minv
    return mul_mod(xl, scale, p, mu, b)


def make_sharded_ntt(plan: NTTPlan, mesh, axis: str = "coeff",
                     negacyclic: bool = True, inverse: bool = False,
                     spec: P | None = None):
    """Build a jittable sharded transform for data ``[..., L, M]`` whose last
    axis is sharded over ``mesh[axis]``.  Pass ``spec`` (a full
    ``PartitionSpec`` ending in ``axis``) to keep batch axes sharded over
    other mesh axes; by default they are replicated."""
    D = _axis_size(mesh, axis)
    M = plan.M
    assert M % D == 0 and (M // D) >= 2, (D, M)
    if negacyclic:
        assert plan.psi is not None, "plan built without negacyclic=True"
    local_plan = get_plan(plan.primes, M // D, negacyclic=False)

    def body(xl):
        if negacyclic and not inverse:
            idx = lax.axis_index(axis)
            psi = _tw_slice(plan.psi, idx * (M // D), M // D)
            xl = mul_mod(xl, psi, plan.p, plan.mu, plan.pbits)
        if inverse:
            return _inv_local(xl, plan, local_plan, D, axis, negacyclic)
        return _fwd_local(xl, plan, local_plan, D, axis)

    # one shard_map wrapper per (ndim-derived) spec, so eager repeated calls
    # hit JAX's trace cache instead of rebuilding the closure every time
    _wrappers: dict = {}

    def call(x):
        sp = spec if spec is not None else P(*([None] * (x.ndim - 1) + [axis]))
        assert len(sp) and sp[-1] == axis, sp
        f = _wrappers.get(sp)
        if f is None:
            f = jax.shard_map(body, mesh=mesh, in_specs=sp, out_specs=sp)
            _wrappers[sp] = f
        return f(x)

    return call


def sharded_ntt(x, plan: NTTPlan, mesh, axis: str = "coeff",
                negacyclic: bool = True, inverse: bool = False):
    """One-shot convenience wrapper around :func:`make_sharded_ntt`."""
    return make_sharded_ntt(plan, mesh, axis, negacyclic, inverse)(x)
