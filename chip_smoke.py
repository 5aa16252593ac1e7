"""One-card smoke run of the ringSNARK provers on an NVIDIA GPU.

Drives the main path once, through the entry points a user calls, at sizes
the system's users run, and checks every result exactly:

  a. ntt     the fused GPU transform against the plain XLA transform and
             the native C++ oracle, at the shapes the provers use;
  b. mac     the streamed prover's scalar-plaintext MAC at the Z_q chunk
             shape against the native C++ inner product on one slab;
  c. logreg  Rinocchio setup -> prove -> verify on the reference logistic
             regression inference circuit (256 features, N=2048, N'=16384);
  d. zq16    streamed ringGroth16 over Z_q, M=2^16, L=2 (witness map bit-exact
             against the native oracle);
  e. rq14    streamed ringGroth16 over Z_q[X]/(X^8192+1), N'=16384, M=2^14.

Each proof must verify and each proof against a flipped public input must be
refused.  Times are host wall clock around work that ends in
`jax.block_until_ready`: cold includes compilation, warm is a second run.
The script exits non-zero when JAX finds no GPU, and when any phase fails.

Usage:
  python chip_smoke.py                  # phases a-e on one card
  python chip_smoke.py --phases ntt,mac # a subset
  python chip_smoke.py --compare-plain  # d and e also with the plain NTT
  python chip_smoke.py --four-cards     # only the multi-device path, 4 cards

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from ringsnark_tpu import native  # noqa: E402
from ringsnark_tpu.ops import ntt as nttm  # noqa: E402
from ringsnark_tpu.ops.primes import find_ntt_primes  # noqa: E402
from ringsnark_tpu.utils.cache import enable_compile_cache  # noqa: E402

# (label, negacyclic, M, L, batch): the outer ring N=8192 L=6; the R_q inner
# slab (N'=16384, L'=4, 1024 rows); the Z_q inner slab (N'=4096, L'=3, 4096
# rows); the Z_q 2^18 witness map's size-2M cyclic transform.
NTT_SHAPES = (
    ("outer N=8192 L=6", True, 8192, 6, 32),
    ("R_q slab N'=16384 L'=4", True, 16384, 4, 1024),
    ("Z_q slab N'=4096 L'=3", True, 4096, 3, 4096),
    ("witness 2M=2^19 L=3", False, 1 << 19, 3, 1),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, from a child process off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def peak_bytes() -> int | None:
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def timed(fn, *args, reps: int = 3):
    """(cold s, warm s (best of reps), result) of fn(*args), fully synced."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    cold = time.perf_counter() - t0
    warm = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        warm = min(warm, time.perf_counter() - t0)
    return cold, warm, out


def same(a, b) -> bool:
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def log_routes(phase: str) -> None:
    for (route, m, kind), n in sorted(nttm.routes_taken(reset=True).items()):
        log(f"[{phase}] route {kind} M={m}: {route} (x{n} traced)")


def _uniform(key, shape, moduli):
    """uint32 residues below the per-limb moduli along axis -2."""
    hi = jnp.asarray(moduli, dtype=jnp.uint32)[:, None]
    return jax.random.randint(key, shape, 0, hi, dtype=jnp.uint32)


# ---------------------------------------------------------------------------
# a. ntt
# ---------------------------------------------------------------------------


def phase_ntt(shapes=NTT_SHAPES, oracle_rows: int = 2, reps: int = 5):
    """Routed transform vs plain transform (==) and vs the native oracle."""
    key = jax.random.key(11)
    for i, (label, neg, M, L, B) in enumerate(shapes):
        ps = tuple(find_ntt_primes(L, 2 * M))
        plan = nttm.get_plan(ps, M, negacyclic=neg)
        if neg:
            fwd, inv = nttm.negacyclic_ntt_rev, nttm.negacyclic_intt_nat
            pfwd, pinv = nttm.plain_negacyclic_ntt_rev, nttm.plain_negacyclic_intt_nat
        else:
            fwd, inv = nttm.cyclic_ntt_rev, nttm.cyclic_intt_nat
            pfwd, pinv = nttm.plain_cyclic_ntt_rev, nttm.plain_cyclic_intt_nat
        x = _uniform(jax.random.fold_in(key, i), (B, L, M), ps)
        ck, wk, y = timed(jax.jit(lambda v: fwd(v, plan)), x, reps=reps)
        cp, wp, y_plain = timed(jax.jit(lambda v: pfwd(v, plan)), x, reps=reps)
        assert same(y, y_plain), f"{label}: forward differs from the plain path"
        cki, wki, back = timed(jax.jit(lambda v: inv(v, plan)), y, reps=reps)
        cpi, wpi, back_plain = timed(jax.jit(lambda v: pinv(v, plan)), y,
                                     reps=reps)
        assert same(back, back_plain), f"{label}: inverse differs from plain"
        assert same(back, x), f"{label}: inverse(forward(x)) != x"

        xs = np.asarray(x[:oracle_rows])
        ys = np.asarray(y[:oracle_rows])
        for l, p in enumerate(ps):
            w = int(plan.w_np[l])
            if neg:
                want = native.negacyclic_ntt(xs[:, l], p, w, int(plan.psi[l, 1]))
            else:
                want = native.cyclic_ntt(xs[:, l], p, w)
            assert np.array_equal(want, ys[:, l]), f"{label}: native oracle"
        route = nttm.ntt_route(jax.default_backend(), M)
        log(f"[ntt] {label} batch={B}: route={route}  fwd {wk*1e6:.1f} us "
            f"(plain {wp*1e6:.1f} us)  inv {wki*1e6:.1f} us (plain "
            f"{wpi*1e6:.1f} us)  per batch, warm; cold fwd {ck:.2f} s "
            f"(plain {cp:.2f} s)")
    log_routes("ntt")


# ---------------------------------------------------------------------------
# b. mac
# ---------------------------------------------------------------------------


def phase_mac(rows: int = 65536, slab: int = 4096, n_inner: int = 4096,
              L_inner: int = 3, reps: int = 3):
    """The scalar-plaintext scan MAC on one streamed chunk: two plaintexts
    against one seeded CRS chunk; the first slab against the native oracle."""
    from ringsnark_tpu.encoding import EncodingContext
    from ringsnark_tpu.rings.context import default_context
    from ringsnark_tpu.snark import seeded as sd

    ring = default_context(L=1, N=1, order=1 << 20)
    inner = tuple(
        q for q in find_ntt_primes(L_inner + 1, 2 * n_inner)
        if q not in ring.primes
    )[:L_inner]
    ectx = EncodingContext(ring=ring, n_inner=n_inner, inner_primes=inner,
                           floor_limbs=1)
    key = jax.random.key(5, impl="threefry2x32")
    c0 = _uniform(jax.random.key(6), (rows, 1, L_inner, n_inner), inner)
    pts = tuple(
        _uniform(jax.random.key(7 + i), (rows, 1, 1), ring.primes)
        for i in range(2)
    )

    def mac(c0_, pts_):
        return sd._seeded_mac_kernel(ectx, c0_, key, pts_, slab)

    cold, warm, _ = timed(mac, c0, pts, reps=reps)
    log(f"[mac] {rows} rows, slab {slab}, L'={L_inner}, N'={n_inner}, "
        f"2 plaintexts: warm {warm*1e3:.2f} ms (cold {cold:.2f} s)")

    # the first slab alone, against the native C++ inner product
    one = mac(c0[:slab], tuple(p[:slab] for p in pts))
    c1 = np.asarray(sd._expand_c1(ectx, key, slab, 1))
    c0s = np.asarray(c0[:slab])
    t = ring.primes[0]
    for i, pt in enumerate(pts):
        pt_np = np.asarray(pt[:slab, 0, 0])
        for j, q in enumerate(inner):
            w = native.lift_rows(pt_np, t, q)
            for comp, c in ((0, c0s), (1, c1)):
                want = native.ip_accumulate_scalar(c[:, 0, j, :], w, q)
                got = np.asarray(one[i][comp][0, j])
                assert np.array_equal(want, got), f"mac pt{i} limb{j} c{comp}"
    log("[mac] first slab == native inner product")


# ---------------------------------------------------------------------------
# c. logreg
# ---------------------------------------------------------------------------


def phase_logreg(features: int = 256, N: int = 2048, n_inner: int = 16384,
                 log_t: int = 16):
    """Rinocchio on the reference logistic-regression inference circuit."""
    from ringsnark_tpu.models import build_logreg_inference
    from ringsnark_tpu.rings.elem import RingElem
    from ringsnark_tpu.snark import rinocchio
    from ringsnark_tpu.snark.api import make_params

    params = make_params(
        L=2, N=N, n_inner=n_inner,
        max_terms=max(4 * features + 8, N + 2, log_t + 2),
        order=max(1 << 14, 2 * n_inner, 4 * N),
    )
    ring = params.ring
    rng = np.random.default_rng(0)
    pb = build_logreg_inference(ring, rng, num_features=features, log_t=log_t)
    assert pb.is_satisfied()
    cs = pb.get_constraint_system()
    primary, aux = pb.primary_input(), pb.auxiliary_input()

    def run(seed):
        r = np.random.default_rng(seed)
        t0 = time.perf_counter()
        kp = rinocchio.generator(cs, params, r, jax.random.key(seed))
        jax.block_until_ready(kp.pk.s_pows.c0)
        t1 = time.perf_counter()
        proof = rinocchio.prover(kp.pk, primary, aux, r)
        jax.block_until_ready(proof.A.c0)
        t2 = time.perf_counter()
        ok = rinocchio.verifier(kp.vk, primary, proof)
        t3 = time.perf_counter()
        return kp, proof, ok, (t1 - t0, t2 - t1, t3 - t2)

    _, _, ok_cold, cold = run(1)
    assert ok_cold, "logreg: cold proof refused"
    kp, proof, ok, warm = run(2)
    assert ok, "logreg: proof refused"
    bad = list(primary)
    bad[0] = bad[0] + RingElem.one(ring)
    assert not rinocchio.verifier(kp.vk, bad, proof), "logreg: flipped input"
    log(f"[logreg] {pb.num_constraints()} constraints, N={N}, N'={n_inner} "
        f"L'={params.enc.L_inner}: setup {warm[0]:.3f} s, prove {warm[1]:.3f} "
        f"s, verify {warm[2]:.3f} s warm (cold {cold[0]:.1f} / {cold[1]:.1f} "
        f"/ {cold[2]:.1f} s); verify True, flipped input False")
    log_routes("logreg")


# ---------------------------------------------------------------------------
# d/e. streamed ringGroth16
# ---------------------------------------------------------------------------


def _streamed_groth16(tag: str, log_m: int, N: int, n_inner: int, L: int,
                      margin: int, slab: int = 4096, native_check: bool = False,
                      compare_plain: bool = False):
    from ringsnark_tpu.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu.reductions.r1cs_to_qrp import (
        _assignment_batches,
        prover_witness_map_chunked,
    )
    from ringsnark_tpu.rings.elem import RingElem
    from ringsnark_tpu.snark import groth16
    from ringsnark_tpu.snark import streamed as st
    from ringsnark_tpu.snark.api import make_params
    from ringsnark_tpu.utils.domain import RootsDomain

    M = 1 << log_m
    params = make_params(
        L=L, N=N, n_inner=n_inner, max_terms=M + 1,
        order=max(1 << (log_m + 2), 2 * n_inner, 4 * N), margin_bits=margin,
    )
    ring = params.ring
    comp, primary, aux = build_synthetic_square_chain(
        ring, M, np.random.default_rng(0)
    )
    key = jax.random.key(0, impl="threefry2x32")

    if native_check:
        domain = RootsDomain(ring, M)
        a_full, b_full, H = jax.block_until_ready(
            prover_witness_map_chunked(comp, primary.res, aux.res, domain)
        )
        full = np.asarray(_assignment_batches(ring, primary, aux)[0].res)
        plan_M = nttm.get_plan(ring.primes, M)
        plan_2M = nttm.get_plan(ring.primes, 2 * M)
        for l, p in enumerate(ring.primes):
            coo = [
                (np.asarray(comp.rows[k]), np.asarray(comp.cols[k]),
                 np.asarray(comp.coeffs[k])[:, l, 0])
                for k in range(2)
            ]
            na, nb, nh = native.g16_witness_map(
                coo[0], coo[1], full[:, l, 0], M, p,
                int(plan_M.w_np[l]), int(plan_2M.w_np[l]),
            )
            assert np.array_equal(na[:, 0], np.asarray(a_full)[:, l, 0])
            assert np.array_equal(nb[:, 0], np.asarray(b_full)[:, l, 0])
            assert np.array_equal(nh[:, 0], np.asarray(H)[:, l, 0])
        del a_full, b_full, H
        log(f"[{tag}] witness map (a_full, b_full, H) == native oracle, "
            f"{L} limbs")

    def run(seed):
        rec = st.StreamRecord(sync=True)
        t0 = time.perf_counter()
        proof, vk, rec = st.stream_prove(
            comp, params, primary, aux, np.random.default_rng(seed),
            jax.random.fold_in(key, seed), slab=slab, record=rec,
        )
        jax.block_until_ready((proof.A.c0, proof.B.c0, proof.C.c0))
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok = groth16.verifier(vk, primary, proof)
        return proof, vk, ok, wall, time.perf_counter() - t0, rec

    def both():
        proof, vk, ok, cold, vcold, _ = run(0)
        assert ok, f"{tag}: cold proof refused"
        del proof, vk
        proof, vk, ok, warm, vwarm, rec = run(1)
        assert ok, f"{tag}: proof refused"
        bad = RingElem(ring, (primary + RingElem.one(ring)).res)
        assert not groth16.verifier(vk, bad, proof), f"{tag}: flipped input"
        return cold, warm, vcold, vwarm, rec

    cold, warm, vcold, vwarm, rec = both()
    log(f"[{tag}] M=2^{log_m} N={N} L={L} N'={n_inner} "
        f"L'={params.enc.L_inner}: setup+prove {warm:.3f} s warm "
        f"(cold {cold:.1f} s; witness map {rec.total('prove'):.3f} s, "
        f"stream {rec.total('stream'):.3f} s), verify {vwarm:.3f} s "
        f"(cold {vcold:.1f} s); verify True, flipped input False")
    log_routes(tag)
    if compare_plain:
        real_route = nttm.ntt_route
        nttm.ntt_route = lambda platform, m: "xla"
        jax.clear_caches()
        try:
            pcold, pwarm, _, pvwarm, _ = both()
        finally:
            nttm.ntt_route = real_route
            jax.clear_caches()
            nttm.routes_taken(reset=True)
        log(f"[{tag}] plain NTT everywhere: setup+prove {pwarm:.3f} s warm "
            f"(cold {pcold:.1f} s), verify {pvwarm:.3f} s; fused kernel: "
            f"{warm:.3f} s, verify {vwarm:.3f} s")


def phase_zq16(compare_plain: bool = False, log_m: int = 16):
    _streamed_groth16("zq16", log_m=log_m, N=1, n_inner=4096, L=2, margin=6,
                      native_check=True, compare_plain=compare_plain)


def phase_rq14(compare_plain: bool = False, log_m: int = 14):
    _streamed_groth16("rq14", log_m=log_m, N=8192, n_inner=16384, L=2,
                      margin=10, compare_plain=compare_plain)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def _spread(arr, n: int) -> str:
    """Check that arr's shards sit on n distinct devices, none holding all."""
    devs = {s.device for s in arr.addressable_shards}
    assert len(devs) == n, f"shards on {len(devs)} devices, want {n}"
    full = arr.size
    sizes = [s.data.size for s in arr.addressable_shards]
    assert all(sz < full for sz in sizes), "a device holds the whole array"
    return f"{len(devs)} devices, shard {sizes[0]} of {full} elements"


def phase_four_cards(log_m: int = 16, chunk: int = 65536, slab: int = 4096,
                     ntt_m: int = 1 << 19):
    """The multi-device path against one device, bit for bit."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ringsnark_tpu.encoding import keygen
    from ringsnark_tpu.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu.parallel import (
        groth16_prove_sharded,
        make_mesh,
        make_sharded_ntt,
        shard_groth16_inputs,
        stream_chunk_ip_sharded,
    )
    from ringsnark_tpu.rings.elem import RingElem
    from ringsnark_tpu.snark import groth16
    from ringsnark_tpu.snark import seeded as sd
    from ringsnark_tpu.snark.api import make_params

    devs = jax.devices()
    assert len(devs) >= 4, f"need 4 devices, have {len(devs)}"

    # 1. sharded groth16 prover on a (limb=2, data=2) mesh
    M = 1 << log_m
    params = make_params(L=2, N=1, n_inner=4096, max_terms=M + 1,
                         order=max(1 << (log_m + 2), 8192), margin_bits=6)
    ring = params.ring
    comp, primary, aux = build_synthetic_square_chain(
        ring, M, np.random.default_rng(0)
    )
    t0 = time.perf_counter()
    kp = groth16.generator(comp, params, np.random.default_rng(1),
                           jax.random.key(1, impl="threefry2x32"))
    jax.block_until_ready(kp.pk.s_pows.c0)
    log(f"[4cards] groth16 setup M=2^{log_m} L=2: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    one = groth16.prover(kp.pk, primary, aux)
    jax.block_until_ready(one.A.c0)
    t_one = time.perf_counter() - t0
    mesh = make_mesh(4, limb=2)
    placed = shard_groth16_inputs(kp.pk, mesh)  # the prover's own placement
    where = _spread(placed["s_pows"][0], 4)
    del placed
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        sharded = groth16_prove_sharded(kp.pk, primary, aux, mesh)
        jax.block_until_ready(sharded.A.c0)
        times.append(time.perf_counter() - t0)
    for name in ("A", "B", "C"):
        a, b = getattr(one, name), getattr(sharded, name)
        assert same(a.c0, b.c0) and same(a.c1, b.c1), f"sharded proof {name}"
    assert groth16.verifier(kp.vk, primary, sharded), "sharded proof refused"
    log(f"[4cards] groth16_prove_sharded (limb=2, data=2): == one-device "
        f"proof, verifies; CRS s_pows c0 on {where}; prove {times[1]:.3f} s "
        f"warm (cold {times[0]:.1f} s), one device {t_one:.1f} s cold")
    del kp, one, sharded

    # 2. data-sharded streamed chunk (encode + MAC + psum)
    ectx = params.enc
    _, sk = keygen(ectx, np.random.default_rng(19))
    lp = ring.primes[:1]
    from ringsnark_tpu.snark import streamed as st

    ectx1 = st.limb_enc_context(ectx, 0)
    sk1 = st.limb_secret_key(ectx1, sk, 0)
    rows = _uniform(jax.random.key(20), (chunk, 1, 1), lp)
    pts = [_uniform(jax.random.key(21 + i), (chunk, 1, 1), lp) for i in range(2)]
    skey = jax.random.key(13, impl="threefry2x32")
    dmesh = Mesh(np.array(devs[:4]), ("data",))
    got = jax.block_until_ready(
        stream_chunk_ip_sharded(dmesh, ectx1, sk1, rows, pts, skey, slab)
    )
    t0 = time.perf_counter()
    got = stream_chunk_ip_sharded(dmesh, ectx1, sk1, rows, pts, skey, slab)
    jax.block_until_ready([g.c0 for g in got])
    t_sh = time.perf_counter() - t0
    senc = sd.encode_seeded(ectx1, sk1, RingElem(st.limb_ring(ring, 0), rows),
                            skey, slab)
    want = sd.seeded_inner_product(senc, pts, use_modswitch=False)
    for g, w in zip(got, want):
        assert same(g.c0, w.c0) and same(g.c1, w.c1), "sharded chunk differs"
    log(f"[4cards] stream_chunk_ip_sharded ({chunk} rows, 4-way data): == "
        f"one-device encode_seeded + seeded_inner_product; {t_sh*1e3:.1f} ms "
        f"warm")
    del senc, got, want

    # 3. coefficient-sharded NTT
    ps = tuple(find_ntt_primes(3, 2 * ntt_m))
    plan = nttm.get_plan(ps, ntt_m, negacyclic=True)
    cmesh = Mesh(np.array(devs[:4]), ("coeff",))
    x = _uniform(jax.random.key(30), (3, ntt_m), ps)
    xs = jax.device_put(x, NamedSharding(cmesh, P(None, "coeff")))
    where = _spread(xs, 4)
    fwd = jax.jit(make_sharded_ntt(plan, cmesh, negacyclic=True))
    inv = jax.jit(make_sharded_ntt(plan, cmesh, negacyclic=True, inverse=True))
    y = jax.block_until_ready(fwd(xs))
    t0 = time.perf_counter()
    y = jax.block_until_ready(fwd(xs))
    t_fwd = time.perf_counter() - t0
    back = jax.block_until_ready(inv(y))
    assert same(back, x), "sharded NTT round trip"
    assert same(y, jax.jit(lambda v: nttm.negacyclic_ntt_rev(v, plan))(x)), (
        "sharded NTT differs from one device"
    )
    log(f"[4cards] make_sharded_ntt M=2^{ntt_m.bit_length() - 1} L=3 (4-way "
        f"coeff, input on {where}): forward == one device, inverse(forward) "
        f"== input; forward {t_fwd*1e6:.1f} us warm")


# ---------------------------------------------------------------------------

PHASES = {
    "ntt": phase_ntt,
    "mac": phase_mac,
    "logreg": phase_logreg,
    "zq16": phase_zq16,
    "rq14": phase_rq14,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--compare-plain", action="store_true",
                    help="also run zq16/rq14 with the plain NTT everywhere")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device path (needs 4 GPUs)")
    args = ap.parse_args(argv)
    if args.four_cards:
        # the one-device reference holds the whole resident CRS (~38 GiB at
        # M=2^16, L=2) beside the sharded copy: give the one process on each
        # card more than JAX's default three quarters of its memory
        os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.9")

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    if not native.available():
        print("chip_smoke: the native oracle library did not build",
              file=sys.stderr)
        return 2
    cache = enable_compile_cache()
    log(f"[card] {card_line()}")
    log(f"[jax] {jax.__version__}, {len(jax.devices())} x {dev.device_kind}, "
        f"compile cache {cache}")
    count = 1
    if args.four_cards:
        phases = [("four_cards", phase_four_cards)]
        count = 4
    else:
        names = [n for n in args.phases.split(",") if n]
        phases = [(n, PHASES[n]) for n in names]
    for name, fn in phases:
        t0 = time.perf_counter()
        if name in ("zq16", "rq14"):
            fn(compare_plain=args.compare_plain)
        else:
            fn()
        log(f"[{name}] phase done in {time.perf_counter() - t0:.1f} s, "
            f"peak device bytes {peak_bytes()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
