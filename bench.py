"""NTT throughput benchmark on one NVIDIA GPU.

Prints ONE JSON line:
  {"metric": "ntt_neg_8192_6limb", "value": <NTTs/s>, "unit": "ntt/s",
   "vs_baseline": <ratio vs the all-threads native C++ baseline>, ...}

One NTT op = a full 6-limb negacyclic forward transform of one degree-8192
polynomial.  Legs, each checked bit for bit against the others:
  * fused  — the routed transform (`ops.ntt.negacyclic_ntt_rev`: on the GPU
             the CUDA kernel of ops/ntt_gpu.py)
  * plain  — the plain XLA path (`ops.ntt.plain_negacyclic_ntt_rev`)
  * cpu    — native C++, 1 thread and all threads

Timing: warm calls of one jitted transform, each ended by
`jax.block_until_ready`; the best of REPS is kept.  Rates are set against
the device's published peaks (PEAKS below); a device missing from that
table, or no GPU at all, is an error.
"""

import json
import sys
import time

import numpy as np

# Published peaks by `jax.devices()[0].device_kind`.
#   hbm_GBps: NVIDIA H100 SXM5 data sheet, 3.35 TB/s.
#   int32_ops: 132 SMs x 64 INT32 lanes per SM (NVIDIA Hopper architecture
#     white paper: 4 partitions x 16 INT32 units) x 1.98 GHz, the maximum SM
#     clock `nvidia-smi --query-gpu=clocks.max.sm` reports for the card:
#     1.67e13 32-bit integer operations per second at full power.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_GBps": 3350.0, "int32_ops": 132 * 64 * 1.98e9},
}
REPS = 20


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from ringsnark_tpu import native
    from ringsnark_tpu.ops import ntt as nttm
    from ringsnark_tpu.ops.primes import find_ntt_primes
    from ringsnark_tpu.utils.cache import enable_compile_cache
    from ringsnark_tpu.utils.profiling import ntt_roofline

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform}")
    if dev.device_kind not in PEAKS:
        raise SystemExit(f"no published peaks for {dev.device_kind!r}")
    peak = PEAKS[dev.device_kind]
    enable_compile_cache()
    print(f"[bench] device: {dev.device_kind}", file=sys.stderr, flush=True)

    N, L, BATCH = 8192, 6, 32
    primes = tuple(find_ntt_primes(L, 1 << 21))
    plan = nttm.get_plan(primes, N, negacyclic=True)
    rng = np.random.default_rng(0)
    x_np = np.stack(
        [np.stack([rng.integers(0, q, N, dtype=np.uint64) for q in primes])
         for _ in range(BATCH)]
    ).astype(np.uint32)  # [BATCH, L, N]
    x = jnp.asarray(x_np)

    def measure(fn):
        f = jax.jit(lambda v: fn(v, plan))
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(x))
        compile_s = time.perf_counter() - t0
        best = float("inf")
        for _ in range(REPS):
            t0 = time.perf_counter()
            jax.block_until_ready(f(x))
            best = min(best, time.perf_counter() - t0)
        return best, out, compile_s

    legs = {}
    for name, fn in (("fused", nttm.negacyclic_ntt_rev),
                     ("plain", nttm.plain_negacyclic_ntt_rev),
                     ("fused_inv", nttm.negacyclic_intt_nat),
                     ("plain_inv", nttm.plain_negacyclic_intt_nat)):
        dt, out, comp = measure(fn)
        legs[name] = (dt, np.asarray(out))
        print(f"[bench] {name}: {dt*1e6:.1f} us per batch of {BATCH} "
              f"(compile {comp:.2f} s)", file=sys.stderr, flush=True)
    assert (legs["fused"][1] == legs["plain"][1]).all(), "fused != plain"
    assert (legs["fused_inv"][1] == legs["plain_inv"][1]).all(), (
        "fused inverse != plain inverse"
    )

    dt = legs["fused"][0]
    ntts_per_s = BATCH / dt
    rl = ntt_roofline(N, L, BATCH, dt)
    int_pct = 100 * rl["int_ops_per_s"] / peak["int32_ops"]
    hbm_pct = 100 * rl["min_bytes"] / dt / (peak["hbm_GBps"] * 1e9)
    print(f"[bench] fused: {ntts_per_s:.1f} ntt/s; {int_pct:.1f}% of the "
          f"int32 issue peak, {hbm_pct:.1f}% of HBM bandwidth (one read + "
          f"one write)", file=sys.stderr, flush=True)

    # --- CPU baselines: native C++, 1 thread and all threads ----------------
    base_batch = 4
    if not native.available():
        raise SystemExit("the native C++ library did not build")

    def run_native(threads):
        native.set_threads(threads)
        out = np.empty((base_batch, L, N), dtype=np.uint32)
        t0 = time.perf_counter()
        for l, p in enumerate(primes):
            out[:, l, :] = native.negacyclic_ntt(
                x_np[:base_batch, l, :], p, plan.w_np[l], int(plan.psi[l, 1])
            )
        return time.perf_counter() - t0, out

    n_thr = native.max_threads()  # before set_threads(1) caps the report
    dt_1core, base_out = run_native(1)
    dt_socket = min(run_native(n_thr)[0], run_native(n_thr)[0])
    assert (legs["fused"][1][:base_batch] == base_out).all(), (
        "GPU NTT != native C++ NTT"
    )
    ntts_1core = base_batch / dt_1core
    ntts_socket = base_batch / dt_socket
    print(f"[bench] cpu 1 thread: {ntts_1core:.1f} ntt/s; {n_thr} threads: "
          f"{ntts_socket:.1f} ntt/s", file=sys.stderr, flush=True)

    print(json.dumps({
        "metric": "ntt_neg_8192_6limb",
        "value": round(ntts_per_s, 2),
        "unit": "ntt/s",
        "vs_baseline": round(ntts_per_s / ntts_socket, 2),
        "vs_1core": round(ntts_per_s / ntts_1core, 2),
        "fused_us": round(dt * 1e6, 1),
        "plain_us": round(legs["plain"][0] * 1e6, 1),
        "fused_inv_us": round(legs["fused_inv"][0] * 1e6, 1),
        "plain_inv_us": round(legs["plain_inv"][0] * 1e6, 1),
        "int32_issue_pct": round(int_pct, 2),
        "hbm_pct": round(hbm_pct, 2),
        "cpu_threads": n_thr,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)


if __name__ == "__main__":
    main()
