"""Prover-scale benchmark: ringGroth16 end-to-end at synthetic R1CS sizes.

The north-star runner (BASELINE.md): Setup / Prove / Verify for a 2^logm-
constraint squaring-chain R1CS.  Two prover layouts:

* unphased (default): seeded-CRS resident prover (snark/seeded.py) — the
  whole c0 CRS stays in device memory (one limb of 2^16 fits one card).
* --phased: the limb-phased, row-chunked streamed prover
  (snark/streamed.py).  Three passes: cold (compile), warm un-profiled
  (the combined setup+prove wall — CRS encode and MACs interleave per
  chunk, synced once per phase), warm profiled (per-chunk syncs give the
  setup/prove split; n_profile_syncs counts the syncs it adds).

CPU baselines: (a) extrapolated — the native C++ (OpenMP) same-algorithm
MAC on a sample of slabs, scaled linearly (lower bound, witness map
excluded; dense rings charge the reference's per-term plaintext-NTT);
(b) --cpu-full — the MEASURED complete same-algorithm CPU prover
(native/cpu_prover.py: witness-map NTTs bit-exact vs the JAX kernel +
every MAC side x component x limb).

Timing: every timed section ends in `jax.block_until_ready`.

Usage: python bench_prover.py [--log-m 16] [--ring zq|rq] [--n-inner 4096]
       [--L 2] [--phased] [--prng rbg|threefry] [--out results.json]
"""

import argparse
import json
import sys
import time

import numpy as np


def _sync(*arrays):
    import jax

    jax.block_until_ready([a for a in arrays if a is not None])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-m", type=int, default=16)
    ap.add_argument("--system", choices=["groth16", "rinocchio"],
                    default="groth16",
                    help="rinocchio streams a ~2x CRS and 10 inner products "
                         "(phased mode only; `rinocchio.tcc:75-190`)")
    ap.add_argument("--ring", choices=["zq", "rq"], default="zq")
    ap.add_argument("--N", type=int, default=256, help="outer degree for rq")
    ap.add_argument("--n-inner", type=int, default=4096)
    ap.add_argument("--L", type=int, default=1,
                    help="outer limbs; soundness ~ (M/2^31)^L — L=1 is "
                         "kernel-characterization only, L>=2 is deployable")
    ap.add_argument("--slab", type=int, default=4096)
    ap.add_argument("--phased", action="store_true",
                    help="limb-phased streamed prover (any L on one device)")
    ap.add_argument("--phase-chunk", type=int, default=1 << 16,
                    help="phased mode: target CRS rows resident at a time")
    ap.add_argument("--throttle", type=int, default=2,
                    help="phased mode: chunks in flight before a memory-"
                         "throttling sync (1 = tightest, for Rq shapes)")
    ap.add_argument("--passes", type=int, default=3,
                    help="phased mode: pass 0 cold (compile), pass 1 warm "
                         "un-profiled (combined wall = headline), pass 2 "
                         "warm profiled (setup/prove split, sync-inflated)")
    ap.add_argument("--prng", choices=["threefry2x32", "rbg"],
                    default="threefry2x32",
                    help="PRNG of the seeded CRS (c1 is regenerated from it "
                         "inside the MAC scan)")
    ap.add_argument("--margin", type=int, default=10,
                    help="noise planner margin bits (worst-case headroom; "
                         "6 fits 2^16 and 4 fits 2^18 in L'=3 at N'=4096 — "
                         "validated empirically in tests/test_noise.py)")
    ap.add_argument("--cpu-slabs", type=int, default=4,
                    help="slabs to sample for the native CPU baseline")
    ap.add_argument("--skip-cpu", action="store_true")
    ap.add_argument("--cpu-full", action="store_true",
                    help="run the MEASURED full same-algorithm CPU prover "
                         "(native/cpu_prover.py: witness-map NTTs + every "
                         "MAC, OpenMP) instead of extrapolating — groth16 "
                         "only; ~minutes at 2^14, ~10 min at zq 2^18")
    ap.add_argument("--skip-warm-setup", action="store_true",
                    help="unphased: skip the second setup run")
    ap.add_argument("--cpu", action="store_true",
                    help="smoke-test on the CPU backend (default: the GPU)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from ringsnark_tpu.snark.api import make_params
    from ringsnark_tpu.snark import groth16
    from ringsnark_tpu.snark import seeded as sd
    from ringsnark_tpu.snark import streamed as st
    from ringsnark_tpu.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    M = 1 << args.log_m
    N = 1 if args.ring == "zq" else args.N
    params = make_params(
        L=args.L, N=N, n_inner=args.n_inner, max_terms=M + 1,
        order=max(1 << (args.log_m + 2), 2 * args.n_inner, 4 * N),
        margin_bits=args.margin,
    )
    ring, ectx = params.ring, params.enc
    L_inner, floor, inner = ectx.L_inner, ectx.floor_limbs, ectx.inner_primes
    dev = jax.devices()[0]
    crs_gb = 3 * (M + 1) * args.L * L_inner * args.n_inner * 4 / 2**30
    print(
        f"[cfg] M=2^{args.log_m} constraints, ring={args.ring} N={N} L={args.L}, "
        f"inner N'={args.n_inner} L'={L_inner} floor={floor}, "
        f"CRS c0 ~{crs_gb:.1f} GiB, device={dev}, phased={args.phased}",
        file=sys.stderr, flush=True,
    )

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    comp, primary, aux = build_synthetic_square_chain(ring, M, rng)
    _sync(aux.res)
    print(f"[build] circuit {time.perf_counter()-t0:.2f}s", file=sys.stderr, flush=True)

    if args.system == "rinocchio":
        assert args.phased, "rinocchio benches via the streamed prover only"
    key = jax.random.key(0, impl=args.prng)
    result = {
        "metric": f"{args.system}_prover_{args.ring}_2e{args.log_m}",
        "unit": "s",
        "config": {
            "M": M, "ring": args.ring, "N": N, "L": args.L,
            "n_inner": args.n_inner, "L_inner": L_inner, "floor": floor,
            "slab": args.slab, "phased": bool(args.phased),
            "device": str(dev),
        },
    }

    # soundness of the benched configuration (DESIGN.md §12): per-proof
    # error is 2M/q_min (the single failing limb); the L-fold product
    # applies to limb-globally-false statement families OR, for any
    # statement, to K=L independent repetitions — which cost exactly what
    # this L-limb row measures.
    min_pbits = min(int(p).bit_length() for p in ring.primes)
    per_limb = (args.log_m + 1) - (min_pbits - 1)
    sz_log2 = args.L * per_limb
    result["soundness_err_log2_single"] = per_limb
    result["soundness_err_log2"] = sz_log2
    print(f"[cfg] soundness ~2^{per_limb} per proof; ~2^{sz_log2} for "
          f"limb-global statements or K={args.L} repetitions "
          f"({args.L} limb(s) of {min_pbits} bits at M=2^{args.log_m}; "
          f"DESIGN §12)",
          file=sys.stderr, flush=True)

    if not args.phased:
        def setup(seed_rng):
            t0 = time.perf_counter()
            kp = sd.generator_seeded(comp, params, seed_rng, key, slab=args.slab)
            _sync(kp.pk.s_pows.c0, kp.pk.delta_ts.c0,
                  None if kp.pk.delta_mid is None else kp.pk.delta_mid.c0)
            return kp, time.perf_counter() - t0

        kp, setup_cold = setup(rng)
        setup_s = setup_cold
        if not args.skip_warm_setup:
            # identical static shapes -> fully warm; separates jit compile
            # time (the cold-warm gap) from the real setup work.  The cold
            # CRS is released first, so one CRS is live at a time.
            kp = None
            kp, setup_s = setup(np.random.default_rng(1))
        pk_bits = kp.pk.size_in_bits()
        print(f"[setup] {setup_s:.2f}s (cold incl. compile {setup_cold:.1f}s, "
              f"pk c0 {pk_bits/8/2**30:.2f} GiB)",
              file=sys.stderr, flush=True)

        def prove():
            t0 = time.perf_counter()
            proof = sd.prover_seeded(kp.pk, primary, aux)
            _sync(proof.A.c0, proof.A.c1, proof.B.c0, proof.B.c1,
                  proof.C.c0, proof.C.c1)
            return proof, time.perf_counter() - t0

        proof, prove_cold = prove()
        proof, prove_s = prove()
        print(f"[prove] {prove_s:.3f}s (cold incl. compile {prove_cold:.1f}s)",
              file=sys.stderr, flush=True)
        vk = kp.vk
        result.update(
            value=round(prove_s, 4),
            setup_s=round(setup_s, 2), setup_cold_s=round(setup_cold, 2),
            prove_cold_s=round(prove_cold, 2),
            proof_bits=proof.size_in_bits(), pk_c0_bits=pk_bits,
        )
    else:
        # ---- phased: limb-phased streamed prover ---------------------------
        # pass 0: cold (compile); pass 1: warm UN-profiled — the combined
        # setup+prove wall (CRS encode and MACs interleave; one sync per
        # phase); pass 2: warm PROFILED — per-chunk syncs give the
        # setup/prove attribution, an upper bound on each side
        # (n_profile_syncs is recorded).
        proof = vk = None
        warm_rec = prof_rec = None
        for p_i in range(max(2, args.passes)):
            if proof is not None:
                del proof, vk
            profile = p_i >= 2
            rec = st.StreamRecord(sync=True, profile=profile)
            t0 = time.perf_counter()
            stream_fn = (
                st.stream_prove if args.system == "groth16"
                else st.stream_prove_rinocchio
            )
            proof, vk, rec = stream_fn(
                comp, params, primary, aux, np.random.default_rng(p_i),
                jax.random.fold_in(key, p_i),
                slab=args.slab, phase_rows=args.phase_chunk, record=rec,
                throttle=args.throttle,
            )
            wall = time.perf_counter() - t0
            setup_p, prove_p = rec.total("setup"), rec.total("prove")
            stream_p = rec.total("stream")
            print(f"[pass {p_i}{' prof' if profile else ''}] "
                  f"setup {setup_p:.2f}s stream {stream_p:.2f}s "
                  f"prove {prove_p:.2f}s (wall {wall:.1f}s)",
                  file=sys.stderr, flush=True)
            if p_i == 0:
                result["combined_cold_s"] = round(wall, 2)
            elif not profile:
                warm_rec, warm_wall = rec, wall
            else:
                prof_rec = rec

        def agg_kind(rec_, kind):
            agg = {}
            for k, name, dt in rec_.events:
                if k != kind:
                    continue
                base = name.split("+")[0]
                agg[base] = agg.get(base, 0.0) + dt
            return {k: round(v, 2) for k, v in agg.items()}

        combined = (warm_rec.total("setup") + warm_rec.total("stream")
                    + warm_rec.total("prove"))
        result["combined_s"] = round(combined, 2)
        result["stream_s"] = round(warm_rec.total("stream"), 2)
        result["stream_breakdown"] = agg_kind(warm_rec, "stream")
        print(f"[warm] combined setup+prove {combined:.2f}s; stream "
              + " ".join(f"{k}={v:.2f}s"
                         for k, v in result["stream_breakdown"].items()),
              file=sys.stderr, flush=True)
        if prof_rec is not None:
            for kind in ("setup", "prove"):
                result[f"{kind}_breakdown"] = agg_kind(prof_rec, kind)
                print(f"[{kind} breakdown, profiled] " + " ".join(
                    f"{k}={v:.2f}s"
                    for k, v in result[f"{kind}_breakdown"].items()
                ), file=sys.stderr, flush=True)
            n_syncs = sum(1 for k, _, _ in prof_rec.events
                          if k in ("setup", "prove"))
            wmap = result["prove_breakdown"].get("witness_map", 0.0)
            result.update(
                value=round(prof_rec.total("prove"), 4),
                setup_s=round(prof_rec.total("setup"), 2),
                witness_map_s=round(wmap, 3),
                n_profile_syncs=n_syncs,
            )
        else:
            result["value"] = round(combined, 4)
        result["proof_bits"] = proof.size_in_bits()

    # ---- verify (shared): processed vk, then warm online verifies ---------
    from ringsnark_tpu.snark import rinocchio as rn
    system = groth16 if args.system == "groth16" else rn

    def verify_once(pvk):
        t0 = time.perf_counter()
        ok = system.online_verifier(pvk, primary, proof)
        return ok, time.perf_counter() - t0

    t0 = time.perf_counter()
    pvk = system.verifier_process(vk)
    _sync(pvk.qrp.At.res)
    process_s = time.perf_counter() - t0
    ok, verify_cold = verify_once(pvk)
    assert ok
    ok, verify_s = verify_once(pvk)
    assert ok
    print(f"[verify] {verify_s:.3f}s warm (cold incl. compile {verify_cold:.2f}s, "
          f"vk process {process_s:.2f}s) passed={ok}",
          file=sys.stderr, flush=True)
    result.update(verify_s=round(verify_s, 3),
                  verify_cold_s=round(verify_cold, 2),
                  verify_process_s=round(process_s, 2))

    # ---- native CPU baseline (same-algorithm MAC, sampled + scaled) --------
    if not args.skip_cpu:
        from ringsnark_tpu import native

        if native.available():
            native.set_threads(native.max_threads())
            S = args.slab
            n = L_inner * args.n_inner
            crng = np.random.default_rng(7)
            ct = crng.integers(0, inner[0], (S, n), dtype=np.uint64).astype(np.uint32)
            pt = crng.integers(0, inner[0], (S, n), dtype=np.uint64).astype(np.uint32)
            # warm + sample
            native.ip_accumulate(ct[:8], pt[:8], inner[0])
            t0 = time.perf_counter()
            for _ in range(args.cpu_slabs):
                native.ip_accumulate(ct, pt, inner[0])
            per_slab = (time.perf_counter() - t0) / args.cpu_slabs
            # full prover MAC: groth16 = 4 IP-sides (A, B over s_pows; H
            # over delta_ts; aux over delta_mid), rinocchio = 9 (4 vectors x
            # 2 s-power batches + F) -- x 2 components x L x (M+1) terms
            sides = 4 if args.system == "groth16" else 9
            n_slabs_total = sides * 2 * args.L * ((M + 1) / S)
            cpu_mac_s = per_slab * n_slabs_total
            detail = ""
            if N > 1:
                # dense rings: the reference's multiply_plain transforms the
                # plaintext to inner-NTT form per term per outer limb
                # (`seal/seal_ring.tcc:509-548`): L' size-N' NTTs per
                # (term, IP-side, outer limb).  Charge them at perfect
                # thread scaling — still a lower bound.
                from ringsnark_tpu.ops import ntt as _nttm

                nplan = _nttm.get_plan((inner[0],), args.n_inner,
                                       negacyclic=True)
                w_, psi_ = int(nplan.w_np[0]), int(nplan.psi[0, 1])
                x = crng.integers(0, inner[0], (1, args.n_inner),
                                  dtype=np.uint64).astype(np.uint32)
                native.negacyclic_ntt(x, inner[0], w_, psi_)
                reps = 64
                t0 = time.perf_counter()
                for _ in range(reps):
                    native.negacyclic_ntt(x, inner[0], w_, psi_)
                per_ntt = (time.perf_counter() - t0) / reps
                n_ntts = sides * args.L * (M + 1) * L_inner
                cpu_ntt_s = per_ntt * n_ntts / native.max_threads()
                detail = (f" + dense plain-NTT {cpu_ntt_s:.1f}s "
                          f"({per_ntt*1e6:.0f} us x {n_ntts} / "
                          f"{native.max_threads()} thr)")
                cpu_mac_s += cpu_ntt_s
                result["cpu_ntt_s"] = round(cpu_ntt_s, 2)
            print(
                f"[cpu] native MAC ({native.max_threads()} threads): "
                f"{per_slab*1e3:.1f} ms/slab -> full prover MAC ~{cpu_mac_s:.1f}s"
                f"{detail} (lower bound: witness map excluded; "
                f"{native.max_threads()} host threads)",
                file=sys.stderr, flush=True,
            )
            result["cpu_mac_s"] = round(cpu_mac_s, 2)
            result["cpu_threads"] = native.max_threads()
            result["vs_baseline"] = round(cpu_mac_s / result["value"], 2)

    if args.cpu_full and args.system == "groth16":
        from ringsnark_tpu.native.cpu_prover import groth16_prover_cpu
        from ringsnark_tpu.reductions.r1cs_to_qrp import _assignment_batches

        full_b, _, _ = _assignment_batches(ring, primary, aux)
        z_np = np.asarray(full_b.res)
        aux_np = np.asarray(aux.res if hasattr(aux, "res") else aux)
        del full_b
        timings, _ = groth16_prover_cpu(
            comp, ectx, z_np, aux_np, np.random.default_rng(11)
        )
        print(f"[cpu-full] measured full CPU prover "
              f"({timings['threads']} threads): witness map "
              f"{timings['witness_map_s']:.1f}s + MACs "
              f"{timings['mac_s']:.1f}s = {timings['total_s']:.1f}s",
              file=sys.stderr, flush=True)
        result["cpu_prover_s"] = timings["total_s"]
        result["cpu_prover_wm_s"] = timings["witness_map_s"]
        result["cpu_prover_threads"] = timings["threads"]
        result["vs_cpu_prover"] = round(
            timings["total_s"] / result["value"], 2
        )

    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(result) + "\n")


if __name__ == "__main__":
    main()
