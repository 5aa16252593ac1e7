"""Per-circuit Setup/Prove/Verify timings — the google-benchmark analog.

Mirrors the reference's four benchmark suites (SURVEY §2.2):
plaintext-check, ct-mul, in-circuit NTT, logistic-regression inference —
each built with authentic values, proved with Rinocchio and/or ringGroth16,
and timed.  Prints one JSON line per (circuit, system) plus [TIME] detail on
stderr.

``--preset reference`` pins each circuit to the reference's benchmark
configuration:
  plaintext-check: outer N=2048, inner N'=16384, logT=32
      (`benchmarks/bench_plaintext_check_SEAL.cpp:19-34`)
  ct-mul:          N=8192,  N'=16384  (`bench_mul_SEAL.cpp:38-49`)
  in-circuit NTT:  N=4096,  N'=16384  (`bench_ntt_SEAL.cpp:39-55`)
  logreg:          256 features, N=2048, N'=16384
      (`bench_logistic_regression_inference.cpp:92-125`)

Timing: every timed section ends in `jax.block_until_ready`.

Usage: python bench_circuits.py [--preset reference] [--circuit NAME]
       [--cpu] [--out results.json]
"""

import argparse
import json
import sys
import time

import numpy as np


def _sync(*arrays):
    import jax

    jax.block_until_ready([a for a in arrays if a is not None])


def _timed_verify(system, vk, pb, proof):
    import time as _t

    t0 = _t.perf_counter()
    ok = system.verifier(vk, pb.primary_input(), proof)
    return ok, _t.perf_counter() - t0


REFERENCE_SHAPES = {
    # circuit: (outer N, inner N', logT-or-None, features-or-None)
    "plaintext_check": (2048, 16384, 32, None),
    "ct_mul": (8192, 16384, 16, None),
    "incircuit_ntt": (4096, 16384, None, None),
    "logreg": (2048, 16384, 16, 256),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=256)
    ap.add_argument("--n-inner", type=int, default=1024)
    ap.add_argument("--features", type=int, default=32)
    ap.add_argument("--logT", type=int, default=16)
    ap.add_argument("--preset", choices=["custom", "reference"],
                    default="custom")
    ap.add_argument("--circuit", default=None,
                    help="run only this circuit (default: all four)")
    ap.add_argument("--system", default=None,
                    choices=[None, "rinocchio", "groth16"])
    ap.add_argument("--streamed", action="store_true",
                    help="prove via the limb-phased streamed provers "
                         "(snark/streamed.py) — the production path when the "
                         "resident CRS approaches HBM (logreg/rinocchio at "
                         "the reference shape is ~9 GiB)")
    ap.add_argument("--slab", type=int, default=1024)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend (default: the GPU)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from ringsnark_tpu.snark.api import make_params
    from ringsnark_tpu.snark import rinocchio, groth16
    from ringsnark_tpu.utils.cache import enable_compile_cache
    from ringsnark_tpu.models import (
        build_plaintext_check,
        build_ct_mul,
        build_incircuit_ntt,
        build_logreg_inference,
    )

    enable_compile_cache()
    builders = {
        "plaintext_check": lambda ring, rng, logT, nf: build_plaintext_check(
            ring, rng, log_t=logT
        ),
        "ct_mul": lambda ring, rng, logT, nf: build_ct_mul(
            ring, rng, log_t=logT
        ),
        "incircuit_ntt": lambda ring, rng, logT, nf: build_incircuit_ntt(
            ring, rng
        ),
        "logreg": lambda ring, rng, logT, nf: build_logreg_inference(
            ring, rng, num_features=nf, log_t=logT
        ),
    }

    names = [args.circuit] if args.circuit else list(builders)
    systems = {"rinocchio": rinocchio, "groth16": groth16}
    if args.system:
        systems = {args.system: systems[args.system]}
    dev = jax.devices()[0]

    for cname in names:
        if args.preset == "reference":
            N, n_inner, logT, nf = REFERENCE_SHAPES[cname]
            logT = logT or args.logT
            nf = nf or args.features
        else:
            N, n_inner, logT, nf = args.N, args.n_inner, args.logT, args.features
        max_terms = max(4 * nf + 8, N + 2, logT + 2)
        params = make_params(L=2, N=N, n_inner=n_inner, max_terms=max_terms,
                             order=max(1 << 14, 2 * n_inner, 4 * N))
        ring = params.ring
        print(
            f"[cfg] {cname}: N={N} L=2, N'={n_inner} "
            f"L'={params.enc.L_inner} floor={params.enc.floor_limbs} "
            f"device={dev}",
            file=sys.stderr, flush=True,
        )
        rng = np.random.default_rng(0)
        pb = builders[cname](ring, rng, logT, nf)
        assert pb.is_satisfied(), f"{cname} witness invalid"
        if args.streamed:
            from ringsnark_tpu.snark import streamed as st
            from ringsnark_tpu.rings.elem import RingElem

            comp = pb.get_constraint_system().compile(ring)
            primary = RingElem.stack(pb.primary_input())
            aux = (
                RingElem.stack(pb.auxiliary_input())
                if pb.auxiliary_input() else []
            )
            for sname, system in systems.items():
                fn = (st.stream_prove if sname == "groth16"
                      else st.stream_prove_rinocchio)
                proof = vk = None
                for p_i in range(2):
                    if proof is not None:
                        del proof, vk
                    rec = st.StreamRecord(sync=True)
                    proof, vk, rec = fn(
                        comp, params, primary, aux,
                        np.random.default_rng(p_i), jax.random.PRNGKey(p_i),
                        slab=args.slab, record=rec,
                    )
                    setup_s, prove_s = rec.total("setup"), rec.total("prove")
                    if p_i == 0:
                        setup_cold, prove_cold = setup_s, prove_s
                ok, verify_cold = _timed_verify(system, vk, pb, proof)
                assert ok, f"{cname}/{sname} streamed verification failed"
                ok, verify_s = _timed_verify(system, vk, pb, proof)
                print(
                    f"[TIME] {cname:>16s}/{sname:<9s} (streamed) setup "
                    f"{setup_s:7.2f}s (cold {setup_cold:.1f}s)  prove "
                    f"{prove_s:7.3f}s (cold {prove_cold:.1f}s)  verify "
                    f"{verify_s:6.2f}s (cold {verify_cold:.1f}s)  "
                    f"({pb.num_constraints()} constraints)",
                    file=sys.stderr, flush=True,
                )
                row = {
                    "metric": f"{cname}_{sname}",
                    "constraints": pb.num_constraints(),
                    "N": N, "n_inner": n_inner, "streamed": True,
                    "setup_s": round(setup_s, 3),
                    "setup_cold_s": round(setup_cold, 3),
                    "prove_s": round(prove_s, 4),
                    "prove_cold_s": round(prove_cold, 3),
                    "verify_s": round(verify_s, 3),
                    "verify_cold_s": round(verify_cold, 3),
                    "proof_bits": proof.size_in_bits(),
                    "device": str(dev),
                }
                print(json.dumps(row), flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(row) + "\n")
            systems_for_resident = {}
        else:
            systems_for_resident = systems
        for sname, system in systems_for_resident.items():
            t0 = time.perf_counter()
            kp = system.generator(
                pb.get_constraint_system(), params, rng, jax.random.PRNGKey(1)
            )
            _sync(kp.pk.s_pows.c0)
            setup_s = time.perf_counter() - t0

            def prove():
                t0 = time.perf_counter()
                proof = system.prover(
                    kp.pk, pb.primary_input(), pb.auxiliary_input(),
                    np.random.default_rng(7),
                )
                _sync(proof.A.c0, proof.B.c0, proof.C.c0)
                return proof, time.perf_counter() - t0

            proof, prove_cold = prove()
            proof, prove_s = prove()

            def verify():
                t0 = time.perf_counter()
                ok = system.verifier(kp.vk, pb.primary_input(), proof)
                return ok, time.perf_counter() - t0

            ok, verify_cold = verify()
            assert ok, f"{cname}/{sname} verification failed"
            ok, verify_s = verify()
            assert ok
            print(
                f"[TIME] {cname:>16s}/{sname:<9s} setup {setup_s:7.2f}s  "
                f"prove {prove_s:7.3f}s (cold {prove_cold:.1f}s)  "
                f"verify {verify_s:6.2f}s (cold {verify_cold:.1f}s)  "
                f"({pb.num_constraints()} constraints)",
                file=sys.stderr, flush=True,
            )
            row = {
                "metric": f"{cname}_{sname}",
                "constraints": pb.num_constraints(),
                "N": N, "n_inner": n_inner,
                "setup_s": round(setup_s, 3),
                "prove_s": round(prove_s, 4),
                "prove_cold_s": round(prove_cold, 3),
                "verify_s": round(verify_s, 3),
                "verify_cold_s": round(verify_cold, 3),
                "proof_bits": proof.size_in_bits(),
                "device": str(dev),
            }
            print(json.dumps(row), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")

        if cname == "logreg":
            # FHE-side comparison points, as the reference benches Keygen /
            # Eval / EncDec next to Setup/Prove/Verify
            # (`bench_logistic_regression_inference.cpp:277-313`)
            from ringsnark_tpu.models.fhe import OuterBGV
            from ringsnark_tpu.rings.elem import RingElem

            frng = np.random.default_rng(3)
            t0 = time.perf_counter()
            fhe = OuterBGV(ring, logT, frng)
            _sync(fhe.s.res)
            keygen_s = time.perf_counter() - t0

            # batched encrypt (fhe.encrypt_batch): 2*nf ciphertexts in two
            # dispatches instead of a per-element loop
            import jax.numpy as jnp

            # messages assembled on device (only the nf slot-0 values are
            # nonzero)
            base = jnp.zeros((nf, ring.N), dtype=jnp.int64)
            msgs1 = base.at[:, 0].set(jnp.arange(nf) % (1 << logT))
            msgs2 = base.at[:, 0].set((2 * jnp.arange(nf) + 1) % (1 << logT))
            ekey = jax.random.key(77, impl="threefry2x32")
            # warm (compile) pass with a different key, then the timed pass
            t0 = time.perf_counter()
            w0, w1 = fhe.encrypt_batch(msgs1, key=jax.random.fold_in(ekey, 9))
            _sync(w0.res)
            enc_cold_s = time.perf_counter() - t0
            del w0, w1
            t0 = time.perf_counter()
            c0_1, c1_1 = fhe.encrypt_batch(msgs1, key=ekey)
            c0_2, c1_2 = fhe.encrypt_batch(msgs2, key=jax.random.fold_in(ekey, 1))
            _sync(c0_1.res, c0_2.res)
            enc_s = time.perf_counter() - t0
            cts1 = [(c0_1[i], c1_1[i]) for i in range(nf)]
            cts2 = [(c0_2[i], c1_2[i]) for i in range(nf)]

            def fhe_eval():
                t0 = time.perf_counter()
                acc = [RingElem.zero(ring)] * 3
                for ct1, ct2 in zip(cts1, cts2):
                    z = OuterBGV.multiply(ct1, ct2)
                    acc = [a + b for a, b in zip(acc, z)]
                # degree-2 sigmoid: square the 3-component result
                sq = [
                    acc[0] * acc[0],
                    (acc[0] + acc[0]) * acc[1],
                    acc[0] * acc[2] + acc[0] * acc[2] + acc[1] * acc[1],
                    acc[1] * acc[2],
                    acc[2] * acc[2],
                ]
                _sync(sq[0].res, sq[4].res)
                return sq, time.perf_counter() - t0

            sq, eval_cold = fhe_eval()
            sq, eval_s = fhe_eval()

            t0 = time.perf_counter()
            msg = fhe.decrypt(
                (sq[0], sq[1], sq[2])  # decrypting a 3-component ct
            )
            dec_s = time.perf_counter() - t0
            print(
                f"[TIME] {cname:>16s}/fhe-side  keygen {keygen_s:6.3f}s  "
                f"enc({2*nf} cts) {enc_s:6.2f}s (cold {enc_cold_s:.1f}s)  eval {eval_s:6.2f}s "
                f"(cold {eval_cold:.1f}s)  dec {dec_s:6.2f}s",
                file=sys.stderr, flush=True,
            )
            row = {
                "metric": "logreg_fhe_side",
                "N": N, "features": nf,
                "fhe_keygen_s": round(keygen_s, 4),
                "fhe_enc_s": round(enc_s, 3),
                "fhe_enc_cold_s": round(enc_cold_s, 3),
                "fhe_enc_count": 2 * nf,
                "fhe_eval_s": round(eval_s, 4),
                "fhe_eval_cold_s": round(eval_cold, 3),
                "fhe_dec_s": round(dec_s, 3),
                "device": str(dev),
            }
            print(json.dumps(row), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
