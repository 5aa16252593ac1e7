"""The GPU NTT route: kernel tables, split and wrapper on the CPU through the
kernels' jnp reference models; the CUDA kernels themselves on a GPU."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ringsnark_tpu.ops import ntt as nttm
from ringsnark_tpu.ops import ntt_gpu
from ringsnark_tpu.ops import primes as pr


def _data(ps, M, B=3, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack(
        [np.stack([rng.integers(0, q, M, dtype=np.uint64) for q in ps])
         for _ in range(B)]
    ).astype(np.uint32)


def _plain(x, plan, inverse, negacyclic, scale=True):
    if negacyclic:
        f = nttm.plain_negacyclic_intt_nat if inverse else nttm.plain_negacyclic_ntt_rev
        return f(x, plan)
    if inverse:
        return nttm.plain_cyclic_intt_nat(x, plan, scale)
    return nttm.plain_cyclic_ntt_rev(x, plan)


def _reference(x, plan, inverse, negacyclic, inner_m=None, scale=True):
    return ntt_gpu.transform(
        x, plan, inverse=inverse, negacyclic=negacyclic, scale=scale,
        inner_m=inner_m, rows_fn=ntt_gpu.rows_reference,
        cols_fn=ntt_gpu.cols_reference,
    )


@pytest.mark.parametrize("M", [256, 4096])
@pytest.mark.parametrize("negacyclic", [False, True], ids=["cyclic", "nega"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_row_kernel_model_matches_plain(inverse, negacyclic, M):
    """The row kernel's algorithm and tables == the plain transform."""
    ps = tuple(pr.find_ntt_primes(2, 2 * M))
    plan = nttm.get_plan(ps, M, negacyclic=negacyclic)
    x = jnp.asarray(_data(ps, M))
    got = _reference(x, plan, inverse, negacyclic)
    want = _plain(x, plan, inverse, negacyclic)
    assert (np.asarray(got) == np.asarray(want)).all()


@pytest.mark.parametrize("M,inner", [(256, 16), (512, 32), (1024, 256)])
def test_split_model_matches_plain(M, inner):
    """Four-step split (column pass + row kernel), all four kinds, and the
    unscaled cyclic inverse the sharded NTT composes with."""
    ps = tuple(pr.find_ntt_primes(2, 2 * M))
    x = jnp.asarray(_data(ps, M, seed=1))
    for negacyclic in (False, True):
        plan = nttm.get_plan(ps, M, negacyclic=negacyclic)
        for inverse in (False, True):
            got = _reference(x, plan, inverse, negacyclic, inner_m=inner)
            want = _plain(x, plan, inverse, negacyclic)
            assert (np.asarray(got) == np.asarray(want)).all(), (
                negacyclic, inverse
            )
    plan = nttm.get_plan(ps, M)
    got = _reference(x, plan, True, False, inner_m=inner, scale=False)
    want = _plain(x, plan, True, False, scale=False)
    assert (np.asarray(got) == np.asarray(want)).all()


def test_wrapper_shapes():
    """Leading batch axes are flattened and restored; empty input passes."""
    ps = tuple(pr.find_ntt_primes(3, 128))
    plan = nttm.get_plan(ps, 64, negacyclic=True)
    x = jnp.asarray(_data(ps, 64, B=6)).reshape(2, 3, 3, 64)
    got = _reference(x, plan, False, True)
    assert got.shape == x.shape and got.dtype == jnp.uint32
    want = _plain(x, plan, False, True)
    assert (np.asarray(got) == np.asarray(want)).all()
    empty = jnp.zeros((0, 3, 64), jnp.uint32)
    assert _reference(empty, plan, True, True).shape == (0, 3, 64)


def test_kernel_tables():
    """Flat twiddles: entry d-1+i is w^(i*m/(2d)); Shoup companions exact."""
    p = pr.find_ntt_primes(1, 64)[0]
    plan = nttm.get_plan((p,), 32)
    w = int(plan.w_np[0])
    kt = ntt_gpu.kernel_tables((p,), 32, (w,))
    d = 1
    while d < 32:
        for i in range(d):
            e = pow(w, i * (32 // (2 * d)), p)
            assert kt.fwd[0, d - 1 + i] == e
            assert kt.inv[0, d - 1 + i] == pow(e, p - 2, p)
            assert kt.fwd_sh[0, d - 1 + i] == (e << 32) // p
        d *= 2


@pytest.mark.parametrize(
    "platform,m,route",
    [("cpu", 1 << 12, "xla"), ("cpu", 1 << 19, "xla"), ("gpu", 2, "fused"),
     ("gpu", nttm.MAX_FUSED_M, "fused"),
     ("gpu", 2 * nttm.MAX_FUSED_M, "split"), ("gpu", 1 << 19, "split")],
)
def test_route_choice(platform, m, route):
    assert nttm.ntt_route(platform, m) == route


def test_split_shape_and_cpu_dispatch():
    """The split is balanced (Mi >= R, both powers of two), and on the CPU
    the public transforms take the plain path."""
    for log_m in range(15, 22):
        m = 1 << log_m
        mi = ntt_gpu.split_inner(m)
        assert m % mi == 0 and mi >= m // mi >= 2
        assert m // mi * min(mi, ntt_gpu.COL_TILE // (m // mi)) <= (1 << 15)
    ps = tuple(pr.find_ntt_primes(1, 64))
    plan = nttm.get_plan(ps, 32, negacyclic=True)
    x = jnp.asarray(_data(ps, 32, B=1))
    nttm.routes_taken(reset=True)
    y = nttm.negacyclic_ntt_rev(x, plan)
    assert nttm.routes_taken(reset=True) == {("xla", 32, "fwd-nega"): 1}
    assert (np.asarray(y) == np.asarray(_plain(x, plan, False, True))).all()


@pytest.mark.gpu
@pytest.mark.parametrize("M", [64, 4096, 16384, 1 << 17])
def test_cuda_kernels_match_plain(gpu, M):
    """The CUDA kernels (fused and split routes) == the plain path."""
    ps = tuple(pr.find_ntt_primes(2, 2 * M))
    x = jnp.asarray(_data(ps, M, B=5))
    for negacyclic in (False, True):
        plan = nttm.get_plan(ps, M, negacyclic=negacyclic)
        fwd = nttm.negacyclic_ntt_rev if negacyclic else nttm.cyclic_ntt_rev
        inv = nttm.negacyclic_intt_nat if negacyclic else nttm.cyclic_intt_nat
        y = jax.jit(lambda v: fwd(v, plan))(x)
        assert (np.asarray(y) == np.asarray(_plain(x, plan, False, negacyclic))).all()
        back = jax.jit(lambda v: inv(v, plan))(y)
        assert (np.asarray(back) == np.asarray(x)).all()
