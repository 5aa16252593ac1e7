"""Seeded-CRS groth16: expand-equivalence, scan-MAC bit-exactness, e2e."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ringsnark_tpu.rings.context import default_context
from ringsnark_tpu.rings.elem import RingElem
from ringsnark_tpu.encoding import EncodingContext, encode, decode, inner_product
from ringsnark_tpu.models.synthetic import (
    build_synthetic_mul_chain,
    build_synthetic_square_chain,
)
from ringsnark_tpu.ops.primes import find_ntt_primes
from ringsnark_tpu.snark import groth16
from ringsnark_tpu.snark.api import SnarkParams
from ringsnark_tpu.snark.seeded import (
    SeededEncoding,
    encode_seeded,
    generator_seeded,
    prover_seeded,
    seeded_inner_product,
)


def _params(N=1, L=2, L_inner=4, n_inner=32, order=1 << 10):
    ring = default_context(L=L, N=N, order=order)
    inner, below = [], 1 << 31
    while len(inner) < L_inner:
        c = find_ntt_primes(1, 2 * n_inner, below=below)[0]
        below = c
        if c not in ring.primes:
            inner.append(c)
    ectx = EncodingContext(ring=ring, n_inner=n_inner, inner_primes=tuple(inner))
    return SnarkParams(ring=ring, enc=ectx)


@pytest.mark.parametrize("N", [1, 8])
def test_seeded_ip_matches_expanded(N):
    params = _params(N=N)
    ectx = params.enc
    rng = np.random.default_rng(3)
    from ringsnark_tpu.encoding import keygen

    _, sk = keygen(ectx, rng)
    B = 19  # deliberately not a slab multiple
    msgs = RingElem.stack(
        [RingElem.random_element(ectx.ring, rng) for _ in range(B)]
    )
    coefs = RingElem.stack(
        [RingElem.random_element(ectx.ring, rng) for _ in range(B)]
    )
    senc = encode_seeded(ectx, sk, msgs, jax.random.PRNGKey(7), slab=8)
    assert senc.c0.shape[0] == 24 and senc.batch == B

    expanded = senc.expand()
    got = seeded_inner_product(senc, [coefs.res])[0]
    want = inner_product(expanded, coefs)
    assert got.level == want.level
    assert (np.asarray(got.c0) == np.asarray(want.c0)).all()
    assert (np.asarray(got.c1) == np.asarray(want.c1)).all()
    # and the value decodes correctly
    acc = RingElem.zero(ectx.ring)
    for i in range(B):
        acc = acc + msgs[i] * coefs[i]
    assert decode(ectx, sk, got) == acc.broadcast_to_poly()


@pytest.mark.slow
def test_seeded_ip_dense_reference_scale():
    """Dense (Rq) seeded inner product at a reference-scale inner ring
    (N'=4096, the shape class of `bench_mul_SEAL.cpp:38-49`): exercises the
    hoisted plaintext-NTT dense MAC path where the per-term NTT volume
    dominates (VERDICT r2 weak #7 — previously only covered at N=8/N'=32)."""
    params = _params(N=256, L=1, L_inner=3, n_inner=4096, order=1 << 13)
    ectx = params.enc
    rng = np.random.default_rng(11)
    from ringsnark_tpu.encoding import keygen

    _, sk = keygen(ectx, rng)
    B = 9
    msgs = RingElem.stack(
        [RingElem.random_element(ectx.ring, rng) for _ in range(B)]
    )
    coefs = RingElem.stack(
        [RingElem.random_element(ectx.ring, rng) for _ in range(B)]
    )
    senc = encode_seeded(ectx, sk, msgs, jax.random.PRNGKey(5), slab=4)
    got = seeded_inner_product(senc, [coefs.res])[0]
    want = inner_product(senc.expand(), coefs)
    assert (np.asarray(got.c0) == np.asarray(want.c0)).all()
    assert (np.asarray(got.c1) == np.asarray(want.c1)).all()
    acc = RingElem.zero(ectx.ring)
    for i in range(B):
        acc = acc + msgs[i] * coefs[i]
    assert decode(ectx, sk, got) == acc.broadcast_to_poly()


@pytest.mark.parametrize(
    "builder",
    [
        pytest.param(build_synthetic_mul_chain, marks=pytest.mark.slow),
        build_synthetic_square_chain,
    ],
)
def test_seeded_prover_matches_expanded_prover(builder):
    params = _params(N=1, L=2)
    rng = np.random.default_rng(0)
    comp, primary, aux = builder(params.ring, 8, rng)
    kp = generator_seeded(comp, params, rng, jax.random.PRNGKey(1), slab=8)

    proof_seeded = prover_seeded(kp.pk, primary, aux)
    assert groth16.verifier(kp.vk, primary, proof_seeded)

    # expand the seeded CRS into an in-core ProvingKey: the fused single-jit
    # prover must produce the bit-identical proof
    pk = kp.pk
    full_pk = groth16.ProvingKey(
        constraint_system=None, compiled=pk.compiled, domain=pk.domain,
        params=pk.params, alpha=pk.alpha, beta=pk.beta,
        s_pows=pk.s_pows.expand(), gamma_io=pk.gamma_io,
        delta_mid=None if pk.delta_mid is None else pk.delta_mid.expand(),
        delta_ts=pk.delta_ts.expand(), pk_enc=pk.pk_enc,
    )
    proof_full = groth16.prover(full_pk, primary, aux)
    for a, b in ((proof_seeded.A, proof_full.A), (proof_seeded.B, proof_full.B),
                 (proof_seeded.C, proof_full.C)):
        assert a.level == b.level
        assert (np.asarray(a.c0) == np.asarray(b.c0)).all()
        assert (np.asarray(a.c1) == np.asarray(b.c1)).all()


def test_scalar_mac_matches_native():
    """The scalar-plaintext scan MAC equals the native C++ inner product of
    the expanded ciphertexts with the lifted plaintexts."""
    from ringsnark_tpu import native
    from ringsnark_tpu.encoding import keygen
    from ringsnark_tpu.snark.seeded import _seeded_mac_kernel

    params = _params(N=1, L=1)
    ectx = params.enc
    rng = np.random.default_rng(13)
    _, sk = keygen(ectx, rng)
    B, slab = 24, 8
    msgs = RingElem.stack(
        [RingElem.random_element(ectx.ring, rng) for _ in range(B)]
    )
    pts = tuple(
        RingElem.stack(
            [RingElem.random_element(ectx.ring, rng) for _ in range(B)]
        ).res
        for _ in range(2)
    )
    senc = encode_seeded(ectx, sk, msgs, jax.random.PRNGKey(17), slab=slab)
    got = _seeded_mac_kernel(ectx, senc.c0, senc.key, pts, slab)
    full = senc.expand()
    t = ectx.ring.primes[0]
    for i, pt in enumerate(pts):
        for j, q in enumerate(ectx.inner_primes):
            w = native.lift_rows(np.asarray(pt[:, 0, 0]), t, q)
            for k, c in enumerate((full.c0, full.c1)):
                want = native.ip_accumulate_scalar(
                    np.asarray(c[:, 0, j, :]), w, q
                )
                assert (np.asarray(got[i][k][0, j]) == want).all()


def test_square_chain_satisfied():
    params = _params(N=1, L=2)
    rng = np.random.default_rng(5)
    comp, primary, aux = build_synthetic_square_chain(params.ring, 16, rng)
    z = jnp.concatenate(
        [jnp.ones((1, params.ring.L, 1), jnp.uint32), primary.res, aux.res]
    )
    az, bz, cz = comp.eval_matrices(z, num_rows=16)
    from ringsnark_tpu.ops.modops import mul_mod

    prod = mul_mod(az, bz, params.ring.p, params.ring.mu, params.ring.pbits)
    assert (np.asarray(prod) == np.asarray(cz)).all()


def test_scalar_constant_poly_fast_path():
    """N=1 plaintexts ride the constant-polynomial encoding: every inner slot
    carries the value and ct x pt needs no NTT (bgv.plain_to_inner_ntt)."""
    params = _params(N=1, L=2)
    ectx = params.enc
    rng = np.random.default_rng(11)
    from ringsnark_tpu.encoding import keygen
    from ringsnark_tpu.encoding.bgv import plain_to_inner_ntt

    _, sk = keygen(ectx, rng)
    v = RingElem.random_element(ectx.ring, rng)
    pt = plain_to_inner_ntt(ectx, v.res)
    # constant polynomial: identical residue in every inner slot
    assert (np.asarray(pt) == np.asarray(pt[..., :1])).all()
    enc = encode(ectx, sk, RingElem.stack([v]), jax.random.PRNGKey(2))
    w = RingElem.random_element(ectx.ring, rng)
    prod = decode(ectx, sk, (enc * w)[0])
    assert prod == (v * w).broadcast_to_poly()
