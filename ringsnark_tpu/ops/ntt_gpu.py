"""Fused NTT on the GPU: the CUDA kernel of ``native/ntt_cuda.cu`` via jax.ffi.

One thread block transforms one row of up to ``ntt.MAX_FUSED_M`` residues in
shared memory: the row crosses device memory twice, where the plain path
(``ntt.plain_*``) reads and writes it once per stage.  Longer rows take the
four-step split M = R * Mi: the plain path's first log2(R) stages (pairs at
distance >= Mi), then the kernel on the R contiguous rows of size Mi, whose
remaining stages are exactly a size-Mi transform with root w^R.

Results are bit-identical to the plain path (same orderings, canonical
residues).  ``rows_reference`` is the kernel's algorithm in jnp, table for
table; the CPU tests check it, and so the tables and the split, against the
plain path, and the GPU tests check the kernel against both.

The library is built from source at first use into ``native/build/`` (or by
``make -C native cuda``) with the CUDA toolkit's ``nvcc`` for ``sm_90a``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from .modops import add_mod, sub_mod
from .ntt import NTTPlan, _mod_powers, get_plan

__all__ = ["KernelTables", "kernel_tables", "transform", "split_inner",
           "rows_reference", "cols_reference", "build_library"]

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libringsnark_ntt_cuda.so")
_ROWS_TARGET = "ringsnark_ntt_rows"
_COLS_TARGET = "ringsnark_ntt_cols"


def _shoup(vals: np.ndarray, primes: np.ndarray) -> np.ndarray:
    """floor(v * 2^32 / p) per limb row (v < p < 2^31)."""
    v = vals.astype(np.uint64)
    return ((v << np.uint64(32)) // primes.astype(np.uint64)[:, None]).astype(
        np.uint32
    )


@dataclass(frozen=True)
class KernelTables:
    """Per-limb [L, m] tables of the row kernel (numpy: constants under jit).

    Flat stage twiddles: entry d-1+i holds w^(i*m/(2d)) (forward) or
    w^-(i*m/(2d)) (inverse) for stage half-width d; entry m-1 is unused.
    Each table has its Shoup companion floor(t * 2^32 / p)."""

    primes: tuple[int, ...]
    m: int
    p: object = field(hash=False, compare=False)  # uint32[L]
    fwd: object = field(hash=False, compare=False)
    fwd_sh: object = field(hash=False, compare=False)
    inv: object = field(hash=False, compare=False)
    inv_sh: object = field(hash=False, compare=False)


def _flat_twiddles(w: int, m: int, p: int) -> np.ndarray:
    pw = _mod_powers(w, max(m // 2, 1), p)
    tbl = np.zeros(m, dtype=np.uint32)
    d = 1
    while d < m:
        tbl[d - 1 : 2 * d - 1] = pw[np.arange(d) * (m // (2 * d))]
        d *= 2
    return tbl


@lru_cache(maxsize=None)
def kernel_tables(primes: tuple[int, ...], m: int,
                  roots: tuple[int, ...]) -> KernelTables:
    """Tables for size-m rows whose primitive m-th roots are `roots`."""
    p = np.array(primes, dtype=np.uint32)
    fwd = np.stack([_flat_twiddles(w, m, q) for w, q in zip(roots, primes)])
    inv = np.stack(
        [_flat_twiddles(pow(w, q - 2, q), m, q) for w, q in zip(roots, primes)]
    )
    return KernelTables(primes=primes, m=m, p=p, fwd=fwd, fwd_sh=_shoup(fwd, p),
                        inv=inv, inv_sh=_shoup(inv, p))


@lru_cache(maxsize=None)
def _scale_rows(primes: tuple[int, ...], m: int, kind: str):
    """(rows, shoup) [L, m] for the per-position factor `kind`: "psi" (the
    negacyclic forward twist), "psi_inv" (its inverse with m^-1 folded in)
    or "minv" (the cyclic inverse's m^-1)."""
    p = np.array(primes, dtype=np.uint32)
    if kind == "minv":
        minv = np.array([pow(m, q - 2, q) for q in primes], dtype=np.uint32)
        rows = np.repeat(minv[:, None], m, axis=1)
    else:
        plan = get_plan(primes, m, negacyclic=True)
        rows = plan.psi if kind == "psi" else plan.psi_inv_scaled
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    return rows, _shoup(rows, p)


def rows_reference(x, tw, tw_sh, scale, scale_sh, primes, *, inverse: bool,
                   pre: bool, post: bool, rows_per_limb: int):
    """The kernel's algorithm in jnp, on the same arguments as the kernel.

    x: uint32[rows, m]; row r belongs to limb (r // rows_per_limb) % L.
    Shoup products with a 32x32->64 high word, exactly as `__umulhi`."""
    L = len(primes)
    m = x.shape[-1]
    xr = x.reshape(-1, L, rows_per_limb, m)
    p = jnp.asarray(primes, dtype=jnp.uint32)[:, None, None]

    def limb(t):  # [L, k] -> broadcast over [B, L, R, ..., k]
        return jnp.asarray(t)[:, None, :]

    def shoup(a, w, w_sh, pp):
        q = ((a.astype(jnp.uint64) * w_sh.astype(jnp.uint64)) >> 32).astype(
            jnp.uint32
        )
        r = a * w - q * pp
        return jnp.where(r >= pp, r - pp, r)

    if pre:
        xr = shoup(xr, limb(scale), limb(scale_sh), p)
    log_m = m.bit_length() - 1
    p5 = p[..., None]
    for st in range(log_m):
        lg = st if inverse else log_m - 1 - st
        d = 1 << lg
        v = xr.reshape(*xr.shape[:-1], m // (2 * d), 2, d)
        a, b = v[..., 0, :], v[..., 1, :]
        w = jnp.asarray(tw)[:, None, None, d - 1 : 2 * d - 1]
        w_sh = jnp.asarray(tw_sh)[:, None, None, d - 1 : 2 * d - 1]
        if inverse:
            t = shoup(b, w, w_sh, p5)
            na, nb = add_mod(a, t, p5), sub_mod(a, t, p5)
        else:
            na, nb = add_mod(a, b, p5), shoup(sub_mod(a, b, p5), w, w_sh, p5)
        xr = jnp.stack([na, nb], axis=-2).reshape(xr.shape)
    if post:
        xr = shoup(xr, limb(scale), limb(scale_sh), p)
    return xr.reshape(x.shape)


def build_library() -> str:
    """Compile native/ntt_cuda.cu (if stale) and return the library path."""
    src = os.path.join(_NATIVE_DIR, "ntt_cuda.cu")
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(src)):
        return _LIB_PATH
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    subprocess.run(
        ["make", "-C", _NATIVE_DIR, "cuda", f"NVCC={nvcc}",
         f"JAX_FFI_INCLUDE={jax.ffi.include_dir()}"],
        check=True,
    )
    return _LIB_PATH


@lru_cache(maxsize=1)
def _register() -> None:
    lib = ctypes.cdll.LoadLibrary(build_library())
    for target, fn in ((_ROWS_TARGET, lib.RingsnarkNttRows),
                       (_COLS_TARGET, lib.RingsnarkNttCols)):
        jax.ffi.register_ffi_target(target, jax.ffi.pycapsule(fn),
                                    platform="CUDA")


# elements of one column tile of the outer pass (32 KiB of shared memory)
COL_TILE = 1 << 13


def split_inner(m: int) -> int:
    """Row length Mi of the four-step split of a size-m transform: the
    balanced M = R * Mi (Mi >= R), so that both passes have parallelism even
    for the witness map's few long rows."""
    return 1 << ((m.bit_length() - 1 + 1) // 2)


def cols_reference(x, tw, tw_sh, scale, scale_sh, primes, *, inverse: bool,
                   pre: bool, post: bool, inner_m: int, cols: int):
    """The column kernel's algorithm in jnp (the tile width `cols` only
    partitions the work; it does not change the result).

    x: uint32[outer, M] viewed as [R, Mi] (Mi = inner_m), outer row o of
    limb o % L; runs the stages that pair whole rows, with the full-size
    flat twiddle tables [L, M]."""
    del cols
    L = len(primes)
    M = x.shape[-1]
    R = M // inner_m
    xr = x.reshape(-1, L, R, inner_m)
    p = jnp.asarray(primes, dtype=jnp.uint32)[:, None, None]

    def shoup(a, w, w_sh, pp):
        q = ((a.astype(jnp.uint64) * w_sh.astype(jnp.uint64)) >> 32).astype(
            jnp.uint32
        )
        r = a * w - q * pp
        return jnp.where(r >= pp, r - pp, r)

    def full(t):  # [L, M] -> [L, R, Mi]
        return jnp.asarray(t).reshape(L, R, inner_m)

    if pre:
        xr = shoup(xr, full(scale), full(scale_sh), p)
    log_r = R.bit_length() - 1
    p4 = p[..., None]  # [L, 1, 1, 1] against [.., L, pairs, dr, Mi]
    for st in range(log_r):
        lg = st if inverse else log_r - 1 - st
        dr = 1 << lg
        v = xr.reshape(*xr.shape[:-2], R // (2 * dr), 2, dr, inner_m)
        a, b = v[..., 0, :, :], v[..., 1, :, :]
        lo = dr * inner_m - 1
        w = jnp.asarray(tw)[:, lo : lo + dr * inner_m].reshape(L, 1, dr, inner_m)
        w_sh = jnp.asarray(tw_sh)[:, lo : lo + dr * inner_m].reshape(
            L, 1, dr, inner_m
        )
        if inverse:
            t = shoup(b, w, w_sh, p4)
            na, nb = add_mod(a, t, p4), sub_mod(a, t, p4)
        else:
            na, nb = add_mod(a, b, p4), shoup(sub_mod(a, b, p4), w, w_sh, p4)
        xr = jnp.stack([na, nb], axis=-3).reshape(xr.shape)
    if post:
        xr = shoup(xr, full(scale), full(scale_sh), p)
    return xr.reshape(x.shape)


def _ffi_call(target, x, *args, **attrs):
    _register()
    call = jax.ffi.ffi_call(
        target, jax.ShapeDtypeStruct(x.shape, jnp.uint32),
        vmap_method="broadcast_all",
    )
    return call(x, *args, **{k: np.int32(v) for k, v in attrs.items()})


def _ffi_rows(*args, **attrs):
    return _ffi_call(_ROWS_TARGET, *args, **attrs)


def _ffi_cols(*args, **attrs):
    return _ffi_call(_COLS_TARGET, *args, **attrs)


def transform(x, plan: NTTPlan, *, inverse: bool, negacyclic: bool,
              scale: bool = True, inner_m: int | None = None, rows_fn=None,
              cols_fn=None):
    """A transform of ops/ntt.py through the GPU kernels.

    x: [..., L, M] uint32.  inner_m=None transforms whole rows in the row
    kernel; otherwise the four-step split M = R * inner_m runs the column
    kernel (the stages that pair whole rows) and the row kernel on the R
    rows of inner_m.  rows_fn / cols_fn default to the CUDA kernels (the
    CPU tests pass `rows_reference` / `cols_reference`)."""
    rows_fn = rows_fn or _ffi_rows
    cols_fn = cols_fn or _ffi_cols
    M, L = plan.M, plan.L
    assert x.shape[-2:] == (L, M), (x.shape, L, M)
    x = x.astype(jnp.uint32)
    if x.size == 0:
        return x
    lead = x.shape[:-2]
    primes = plan.primes
    p_arr = np.array(primes, dtype=np.uint32)

    # the per-position factor: the negacyclic twist before a forward
    # transform, its inverse (m^-1 folded in) or m^-1 after an inverse one
    kind = None
    if negacyclic:
        kind = "psi_inv" if inverse else "psi"
    elif inverse and scale:
        kind = "minv"
    pre, post = kind == "psi", kind in ("psi_inv", "minv")

    def tables(kt, m):
        tw = (kt.inv, kt.inv_sh) if inverse else (kt.fwd, kt.fwd_sh)
        sc = _scale_rows(primes, m, kind) if kind else tw
        return (*tw, *sc, p_arr)

    if inner_m is None:
        kt = kernel_tables(primes, M, tuple(int(w) for w in plan.w_np))
        out = rows_fn(x.reshape(-1, M), *tables(kt, M), inverse=inverse,
                      pre=pre, post=post, rows_per_limb=1)
        return out.reshape(*lead, L, M)

    R = M // inner_m
    assert R >= 2 and M == R * inner_m, (M, inner_m)
    full = kernel_tables(primes, M, tuple(int(w) for w in plan.w_np))
    roots = tuple(pow(int(w), R, q) for w, q in zip(plan.w_np, primes))
    inner = kernel_tables(primes, inner_m, roots)
    tw = (inner.inv, inner.inv_sh) if inverse else (inner.fwd, inner.fwd_sh)
    cols = max(1, min(inner_m, COL_TILE // R))

    def outer_pass(v, pre_, post_):
        return cols_fn(v.reshape(-1, M), *tables(full, M), inverse=inverse,
                       pre=pre_, post=post_, inner_m=inner_m, cols=cols)

    def inner_pass(v):
        return rows_fn(v.reshape(-1, inner_m), *tw, *tw, p_arr,
                       inverse=inverse, pre=False, post=False,
                       rows_per_limb=R)

    if inverse:
        out = outer_pass(inner_pass(x), False, post)
    else:
        out = inner_pass(outer_pass(x, pre, False))
    return out.reshape(*lead, L, M)
