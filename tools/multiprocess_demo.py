"""Multi-host validation on one machine: N local processes, each owning a
slice of virtual CPU devices, joined via jax.distributed — the same code
path a multi-host deployment uses (coordinator + per-process device mesh +
global shard_map + process_allgather).

Run (driver): python tools/multiprocess_demo.py
Worker mode (internal): ... --worker <rank> --procs <n> --port <p>
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def worker(rank: int, procs: int, port: int, backend: str = "jnp") -> int:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=procs, process_id=rank)

    import numpy as np

    from raytpu.config import RenderConfig
    from raytpu.parallel.mesh import gather_image, make_mesh
    from raytpu.render import render_sharded
    from raytpu.scene import default_scene
    from raytpu.trace import render_image

    assert jax.process_count() == procs
    mesh = make_mesh()  # all global devices (procs * 4)
    cfg = RenderConfig(width=64, height=32, max_depth=2, alias_factor=1)
    scene = default_scene()
    # The pallas forward kernel runs in the Pallas interpreter on CPU.
    img = render_sharded(scene, cfg, mesh, backend=backend,
                         interpret=backend == "pallas")
    full = gather_image(img)

    # Distributed training step with the selected backend inside the
    # shard_map body (pallas is forward-only, so it trains through jnp):
    # the scene-parameter gradient psum crosses the process boundary.
    # The jnp backend pins exactness; wavefront pins that its custom-VJP
    # cotangents survive a REAL process boundary (the single-process
    # 8-device tests cannot catch a cross-process-only collective bug).
    import jax.numpy as jnp

    from raytpu.grad import (loss_and_grad, loss_and_grad_sharded,
                             loss_and_grad_wavefront)

    grad_backend = "jnp" if backend == "pallas" else backend
    target = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
    dist_loss, dist_grads = loss_and_grad_sharded(scene, cfg, target, mesh,
                                                  backend=grad_backend)

    if rank == 0:
        ref = np.asarray(render_image(scene, cfg))
        diff = float(np.abs(full - ref).max())
        # Kernel backends are separately compiled programs: near-threshold
        # branch flips allow a few full-magnitude pixel outliers (the
        # repo-wide contract, tests/test_pallas._compare).
        scale = max(float(ref.max()), 1e-30)
        if backend == "jnp":
            assert diff < 1e-6, diff
        else:
            d = np.abs(full - ref)
            outliers = float((d.max(axis=-1) > 1e-3 * scale).mean())
            assert outliers <= 0.005, outliers
        print(f"gathered {full.shape} over {procs} processes x "
              f"{jax.local_device_count()} devices; max diff vs "
              f"single-process render: {diff:.2e}")

        if grad_backend == "wavefront":
            local_loss, local_grads = loss_and_grad_wavefront(scene, cfg,
                                                              target)
        else:
            local_loss, local_grads = loss_and_grad(scene, cfg, target)
        gdiff = 0.0
        for a, b in zip(jax.tree_util.tree_leaves(dist_grads),
                        jax.tree_util.tree_leaves(local_grads)):
            gs = max(float(jnp.max(jnp.abs(b))), 1e-12)
            gdiff = max(gdiff, float(jnp.max(jnp.abs(a - b))) / gs)
        print(f"distributed grad vs single-process ({grad_backend}): loss diff "
              f"{abs(float(dist_loss) - float(local_loss)):.2e}, "
              f"max rel grad diff {gdiff:.2e}")
        # jnp: identical math modulo psum order; wavefront: same-family
        # comparison with the reassociation-tolerant bound the
        # single-process tests use.
        assert gdiff < (1e-6 if grad_backend == "jnp" else 2e-3), gdiff
        print("MULTIPROCESS_OK")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--port", type=int, default=57621)
    ap.add_argument("--backend", default="jnp",
                    choices=["jnp", "pallas", "wavefront"],
                    help="render backend inside the shard_map body (the "
                         "pallas kernel runs in the Pallas interpreter; "
                         "it trains through jnp)")
    args = ap.parse_args()
    if args.worker is not None:
        return worker(args.worker, args.procs, args.port, args.backend)

    procs = []
    for rank in range(args.procs):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(rank),
             "--procs", str(args.procs), "--port", str(args.port),
             "--backend", args.backend],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    ok = True
    for rank, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            ok = False
        tagged = [l for l in out.splitlines()
                  if "MULTIPROCESS_OK" in l or "diff" in l or "Error" in l]
        for line in tagged:
            print(f"[rank {rank}] {line}")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
