import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend,port", [("jnp", 57633),
                                          ("pallas", 57634),
                                          ("wavefront", 57635)])
def test_two_process_distributed_render_and_grad(backend, port):
    """Full multi-host code path on one machine: 2 processes x 4 virtual
    devices via jax.distributed — sharded render, process_allgather, and the
    cross-process gradient psum, all compared against single-process
    results (tools/multiprocess_demo.py).  Parametrized over the three
    render backends (pallas in the Pallas interpreter, training through
    jnp) so the wavefront's custom-VJP cotangent psum crosses a REAL
    process boundary too."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # the demo sets its own device count
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "multiprocess_demo.py"),
         "--port", str(port), "--backend", backend],
        capture_output=True, text=True, timeout=540, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "MULTIPROCESS_OK" in out.stdout, out.stdout
