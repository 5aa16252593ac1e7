"""Simulated multi-host (2-process) sharded prover — BASELINE configs 3-5.

Spawns two OS processes, each owning 4 virtual CPU devices, joined through
`jax.distributed` with Gloo collectives.  The global mesh's 'data' axis
spans the process boundary, so the CRS inner-product reduction crosses the
host-to-host link (the CPU analog of a network hop between accelerator hosts).  The workers assert the
cross-host proof is bit-identical to the single-process proof and verifies.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow  # ~1 min: spawns 2 OS processes, each compiling the full
# sharded prover; unique DCN-analog coverage — run with RINGSNARK_SLOW=1.
def test_two_process_prover_bit_identical():
    port = _free_port()
    env = dict(os.environ)
    # the workers pick their own XLA_FLAGS/backend; drop conftest's forcing
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(_WORKER)))
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=570)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert f"MULTIHOST_OK p{i}" in out
