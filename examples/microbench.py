"""Primitive timings on the default JAX device.

Port of `/root/reference/microbench.cpp`: NTT, scalar*ring, ring+ring,
ring*ring, encode+encrypt, decrypt+decode — with [TIME] lines per primitive
and the analytic Rinocchio proof size (microbench.cpp:200-211).

Run: python examples/microbench.py [--N 8192] [--L 6]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp

from ringsnark_tpu.rings.context import default_context
from ringsnark_tpu.rings.elem import RingElem
from ringsnark_tpu.encoding import EncodingContext, keygen, encode, decode
from ringsnark_tpu.ops import ntt as nttm
from ringsnark_tpu.ops.primes import find_ntt_primes
from ringsnark_tpu.utils.profiling import ntt_roofline

SEC_PARAM = 128  # microbench.cpp:20-24
NOISE_BITS = 45  # LMSS21 noise-flooding estimate (carried for parity)


def _time(fn, *args, iters=10, warmup=True):
    if warmup:
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main(N: int, L: int, n_inner: int, L_inner: int):
    ring = default_context(L=L, N=N, order=max(1 << 15, 4 * N))
    rng = np.random.default_rng(0)
    a = RingElem.random_element(ring, rng)
    b = RingElem.random_element(ring, rng)
    s = RingElem.scalar(ring, 123456789)

    plan = ring.ntt_plan
    fwd = jax.jit(lambda v: nttm.negacyclic_ntt_rev(v, plan))
    x = a.res
    dt = _time(fwd, x)
    print(f"[TIME] NTT        {dt*1e6:10.1f} us   (N={N}, {L} limbs)")
    rf = ntt_roofline(N, L, 1, dt)
    print(f"       {rf['int_ops_per_s']/1e9:.1f} Gint-ops/s, "
          f"{rf['min_bytes'] / dt / 1e9:.1f} GB/s (one read + one write)")

    mul = jax.jit(lambda u, v: (u * v).res)
    add = jax.jit(lambda u, v: (u + v).res)
    print(f"[TIME] A x R      {_time(mul, s, a)*1e6:10.1f} us")
    print(f"[TIME] R + R      {_time(add, a, b)*1e6:10.1f} us")
    print(f"[TIME] R x R      {_time(mul, a, b)*1e6:10.1f} us")

    inner, below = [], 1 << 31
    while len(inner) < L_inner:
        c = find_ntt_primes(1, 2 * n_inner, below=below)[0]
        below = c
        if c not in ring.primes:
            inner.append(c)
    ectx = EncodingContext(ring=ring, n_inner=n_inner, inner_primes=tuple(inner))
    _, sk = keygen(ectx, rng)
    batch = RingElem.stack([a])
    key = jax.random.PRNGKey(0)

    enc_fn = lambda: encode(ectx, sk, batch, key).c0
    t0 = time.perf_counter()
    jax.block_until_ready(enc_fn())
    t0 = time.perf_counter()
    for _ in range(5):
        out = enc_fn()
    jax.block_until_ready(out)
    print(f"[TIME] 1 Enc      {(time.perf_counter()-t0)/5*1e6:10.1f} us")

    e = encode(ectx, sk, batch, key)
    t0 = time.perf_counter()
    for _ in range(3):
        decode(ectx, sk, e[0])
    print(f"[TIME] 1 Dec      {(time.perf_counter()-t0)/3*1e6:10.1f} us")

    # analytic 9-element Rinocchio proof size (microbench.cpp:207-210)
    proof_bits = 9 * 2 * L * L_inner * n_inner * 31
    print(f"[SIZE] Rinocchio proof (analytic): {proof_bits} bits "
          f"= {proof_bits/8/1024:.1f} KiB")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=8192)
    ap.add_argument("--L", type=int, default=6)
    ap.add_argument("--n-inner", type=int, default=2048)
    ap.add_argument("--L-inner", type=int, default=4)
    args = ap.parse_args()
    main(args.N, args.L, args.n_inner, args.L_inner)
