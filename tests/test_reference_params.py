"""Cross-checks at the reference's exact parameters.

The reference's oracle worksheet (`/root/reference/docs/qrp.sage:3-7`) uses
the 3-limb modulus q1=0xffffee001, q2=0xffffc4001, q3=0x1ffffe0001 (36/37-bit
primes — beyond the 31-bit device fast path, handled exactly by the Python-int
oracle ring) and builds a toy QRP by Newton interpolation over Z_q1.  These
tests replay that math with our generic algorithms:

* Newton divided-difference interpolation == our master-polynomial
  `interpolate` (`polynomials.tcc:10-43`),
* the QRP identity V·W - Y = H·Z for the sage circuit
  (c5 = c3·c4; c6 = (c1+c2)·c5) on the reference-style integer domain.

Also mirrors the reference's gtest suites: `interpolation_test.cpp:29-83`
(interpolate∘eval round-trip + Lagrange vs Horner at 20 off-domain points)
and `division_test.cpp:28-49` (divide(multiply(q, x), x) == q at n=110).
"""

import numpy as np
import pytest

from ringsnark_tpu.rings.oracle import OracleContext, OracleElem
from ringsnark_tpu.rings.context import default_context
from ringsnark_tpu.rings.elem import RingElem
from ringsnark_tpu.utils import poly as _poly
from ringsnark_tpu.utils.domain import IntegerDomain

Q1, Q2, Q3 = 0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001


@pytest.fixture(scope="module")
def oc():
    return OracleContext((Q1, Q2, Q3))


def _newton_interpolate(xs, ys):
    """Divided-difference Newton interpolation (qrp.sage:12-30)."""
    n = len(xs)
    coef = list(ys)
    for j in range(1, n):
        for i in range(n - 1, j - 1, -1):
            coef[i] = (coef[i] - coef[i - 1]) / (xs[i] - xs[i - j])
    # expand newton form to monomial coefficients
    one = type(xs[0]).one(xs[0].ctx)
    zero = one - one
    poly = [zero]
    basis = [one]
    for k in range(n):
        while len(poly) < len(basis):
            poly.append(zero)
        for i, b in enumerate(basis):
            poly[i] = poly[i] + coef[k] * b
        basis = _poly.multiply(basis, [-xs[k], one])
    return poly


def test_newton_equals_master_polynomial_interpolation(oc):
    rng = np.random.default_rng(0)
    n = 7
    xs = [OracleElem(oc, i) for i in range(n)]
    ys = [OracleElem(oc, int(rng.integers(0, Q1))) for _ in range(n)]
    a = _newton_interpolate(xs, ys)
    b = _poly.interpolate(xs, ys)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x == y


def test_sage_circuit_qrp_identity(oc):
    """The qrp.sage circuit with concrete wire values: V*W - Y = H*Z."""
    # wiring predicates over 2 constraints (qrp.sage:49-76):
    v = [[0, 1], [0, 1], [1, 0], [0, 0], [0, 0], [0, 0]]
    w = [[0, 0], [0, 0], [0, 0], [1, 0], [0, 1], [0, 0]]
    y = [[0, 0], [0, 0], [0, 0], [0, 0], [1, 0], [0, 1]]
    # concrete satisfying wires: c5 = c3*c4, c6 = (c1+c2)*c5
    rng = np.random.default_rng(1)
    c = [OracleElem(oc, int(rng.integers(1, Q1))) for _ in range(4)]
    c.append(c[2] * c[3])
    c.append((c[0] + c[1]) * c[4])

    dom = IntegerDomain(oc, 2, elem_cls=OracleElem)
    xs = dom.elements()
    zero = OracleElem(oc, 0)

    def interp(col):
        return _poly.interpolate(xs, [OracleElem(oc, col[0]), OracleElem(oc, col[1])])

    V = [zero, zero]
    W = [zero, zero]
    Y = [zero, zero]
    for k in range(6):
        vk, wk, yk = interp(v[k]), interp(w[k]), interp(y[k])
        V = [V[i] + c[k] * vk[i] for i in range(2)]
        W = [W[i] + c[k] * wk[i] for i in range(2)]
        Y = [Y[i] + c[k] * yk[i] for i in range(2)]

    Z = dom.vanishing_polynomial()
    num = _poly.add(_poly.multiply(V, W), [-t for t in Y])
    H = _poly.divide(num, Z)
    # exactness: num == H*Z
    recon = _poly.multiply(H, Z)
    for a, b in zip(recon, num):
        assert a == b
    # and at a random point
    t = dom.random_exceptional(np.random.default_rng(2))
    lhs = _poly.eval_poly(V, t) * _poly.eval_poly(W, t) - _poly.eval_poly(Y, t)
    rhs = _poly.eval_poly(H, t) * dom.compute_vanishing_polynomial(t)
    assert lhs == rhs


@pytest.mark.parametrize(
    "ring", ["oracle", pytest.param("device", marks=pytest.mark.slow)]
)  # the device variant re-runs the same math through per-op RingElem dispatch
# (~1 min of tiny jits); RingElem arithmetic is covered by test_rings.py.
def test_interpolation_roundtrip_reference_style(ring, oc):
    """interpolation_test.cpp:29-83 over both ring types."""
    rng = np.random.default_rng(3)
    n = 12
    if ring == "oracle":
        xs = [OracleElem(oc, i) for i in range(n)]
        ys = [OracleElem(oc, int(rng.integers(0, Q1))) for _ in range(n)]
        dom = IntegerDomain(oc, n, elem_cls=OracleElem)
        mk = lambda v: OracleElem(oc, int(v))
    else:
        ctx = default_context(L=2, N=1, order=1 << 12)
        xs = [RingElem.scalar(ctx, i) for i in range(n)]
        ys = [RingElem.random_element(ctx, rng) for _ in range(n)]
        dom = IntegerDomain(ctx, n)
        mk = lambda v: RingElem.scalar(ctx, int(v))
    coeffs = _poly.interpolate(xs, ys)
    for x, y in zip(xs, ys):
        assert _poly.eval_poly(coeffs, x) == y
    # Lagrange-basis evaluation vs direct Horner at 20 off-domain points
    for k in range(20):
        t = mk(n + 1 + 7 * k)
        lag = dom.evaluate_all_lagrange_polynomials(t)
        via = lag[0] * ys[0]
        for j in range(1, n):
            via = via + lag[j] * ys[j]
        assert via == _poly.eval_poly(coeffs, t)


@pytest.mark.parametrize("ring", ["oracle", "device"])
def test_division_reference_style(ring, oc):
    """division_test.cpp:28-49: divide(multiply(q, x), x) == q, n = 110."""
    n = 110
    if ring == "oracle":
        q = [OracleElem(oc, 3 * i + 1) for i in range(n)]
        x = [OracleElem(oc, 7 * i + 2) for i in range(5)]
    else:
        ctx = default_context(L=2, N=1, order=1 << 12)
        q = [RingElem.scalar(ctx, 3 * i + 1) for i in range(n)]
        x = [RingElem.scalar(ctx, 7 * i + 2) for i in range(5)]
    prod = _poly.multiply(q, x)
    got = _poly.divide(prod, x)
    assert len(got) == n
    for a, b in zip(got, q):
        assert a == b
