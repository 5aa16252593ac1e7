"""Standalone measured full CPU prover leg (no accelerator involved).

Runs native/cpu_prover.groth16_prover_cpu for a bench_prover-compatible
configuration on the host CPU only (jax forced to the CPU backend for the
table/plan machinery) and emits one JSON row.  Use on an otherwise idle
machine; pair with the matching GPU row of bench_prover.py for ratios.

Usage: python bench_cpu_full.py [--log-m 14] [--ring rq --N 8192
       --n-inner 16384] [--L 2] [--threads N] [--out file.json]
"""

import argparse
import json
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-m", type=int, default=14)
    ap.add_argument("--ring", choices=["zq", "rq"], default="zq")
    ap.add_argument("--N", type=int, default=8192)
    ap.add_argument("--n-inner", type=int, default=4096)
    ap.add_argument("--L", type=int, default=1)
    ap.add_argument("--margin", type=int, default=6)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from ringsnark_tpu.rings.context import default_context
    from ringsnark_tpu.encoding import EncodingContext
    from ringsnark_tpu.encoding.noise import plan_inner_chain
    from ringsnark_tpu.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu.native.cpu_prover import groth16_prover_cpu
    from ringsnark_tpu.ops.primes import find_ntt_primes
    from ringsnark_tpu.reductions.r1cs_to_qrp import _assignment_batches

    M = 1 << args.log_m
    N = 1 if args.ring == "zq" else args.N
    order = max(1 << (args.log_m + 2), 2 * args.n_inner, 4 * N)
    ring = default_context(L=args.L, N=N, order=order)
    L_inner, floor = plan_inner_chain(
        args.n_inner, 31, M + 1, margin_bits=args.margin, dense=(N > 1)
    )
    inner, below = [], 1 << 31
    while len(inner) < L_inner:
        c = find_ntt_primes(1, 2 * args.n_inner, below=below)[0]
        below = c
        if c not in ring.primes:
            inner.append(c)
    ectx = EncodingContext(
        ring=ring, n_inner=args.n_inner, inner_primes=tuple(inner),
        floor_limbs=floor,
    )
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    comp, primary, aux = build_synthetic_square_chain(ring, M, rng)
    full, _, _ = _assignment_batches(ring, primary, aux)
    z_np = np.asarray(full.res)
    aux_np = np.asarray(aux.res)
    print(f"[build] {time.perf_counter()-t0:.1f}s", file=sys.stderr, flush=True)

    timings, _ = groth16_prover_cpu(
        comp, ectx, z_np, aux_np, np.random.default_rng(11),
        threads=args.threads,
    )
    row = {
        "metric": f"cpu_full_prover_{args.ring}_2e{args.log_m}",
        "unit": "s",
        "value": timings["total_s"],
        "witness_map_s": timings["witness_map_s"],
        "mac_s": timings["mac_s"],
        "threads": timings["threads"],
        "config": {
            "M": M, "ring": args.ring, "N": N, "L": args.L,
            "n_inner": args.n_inner, "L_inner": L_inner,
        },
    }
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
