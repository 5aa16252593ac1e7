"""CPU rehearsal of chip_smoke.py: every phase function at a tiny size (on
the CPU the transforms take the plain path), and the refusal to run without
a GPU."""

import importlib.util
import os

import pytest

_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_refuses_without_gpu(smoke, capsys):
    assert smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_phase_ntt(smoke):
    smoke.phase_ntt(shapes=(("nega", True, 64, 2, 3), ("cyc", False, 128, 2, 2)),
                    reps=1)


def test_phase_mac(smoke):
    smoke.phase_mac(rows=64, slab=16, n_inner=32, L_inner=3, reps=1)


def test_phase_logreg(smoke):
    smoke.phase_logreg(features=2, N=8, n_inner=64)


def test_phase_zq(smoke):
    smoke.phase_zq16(log_m=4)


def test_phase_rq_with_plain_comparison(smoke):
    smoke._streamed_groth16("rq", log_m=3, N=4, n_inner=32, L=2, margin=10,
                            slab=8, compare_plain=True)


def test_phase_four_devices(smoke):
    smoke.phase_four_cards(log_m=4, chunk=64, slab=8, ntt_m=64)
