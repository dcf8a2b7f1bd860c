"""Benchmark: one JSON line of on-card times for the driver.

Runs on one GPU and fails (nonzero exit, no result line) without one.
Every time is the best of a few warm calls that end in
jax.block_until_ready; the first call of each shape compiles and is
reported apart as `*_first_call_s`.  A "ray" is a camera ray (pixel x
alias^2), the reference's one-work-item-per-pixel accounting; the full
bounce tree traces 2^(depth+1)-1 nodes per camera ray.

Cells:
  * config 3 (640x480, depth 4, default scene): forward through
    backend="auto", and forward+backward (loss + scene gradients) through
    the training resolver — the headline `value` is its rate;
  * golden (800x600, depth 5, 3x3 AA): forward+backward;
  * config 5 (random_scene(256, seed=3), 1920x1080, depth 6): forward
    through backend="auto", with its dropped-ray count.

The line also carries the card's name and power limit as nvidia-smi
gives them, and the device as JAX reports it.
"""

import json
import subprocess
import sys
import time


def _best(fn, reps):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return out, first, best


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU; JAX found {dev.platform}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]

    import jax.numpy as jnp

    from raytpu.config import BENCH_CONFIGS
    from raytpu.grad import loss_and_grad_sharded
    from raytpu.parallel.mesh import make_mesh
    from raytpu.render import render_single, resolve_backend
    from raytpu.scene import default_scene, random_scene
    from raytpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    mesh1 = make_mesh([dev])
    scene = default_scene()
    result = {}

    cfg = BENCH_CONFIGS["config3"]
    _, first, fwd = _best(lambda: render_single(scene, cfg), 5)
    result.update(config3_fwd_s=fwd, config3_fwd_first_call_s=first,
                  config3_fwd_backend=resolve_backend("auto", scene, cfg))

    def step(c):
        target = jnp.zeros((c.num_pixels, 3), jnp.float32)
        return lambda: loss_and_grad_sharded(scene, c, target, mesh1)

    _, first, step3 = _best(step(cfg), 3)
    result.update(
        config3_fwd_bwd_s=step3, config3_fwd_bwd_first_call_s=first,
        config3_fwd_bwd_backend=resolve_backend("auto", scene, cfg,
                                                train=True))
    gcfg = BENCH_CONFIGS["golden"]
    _, first, gstep = _best(step(gcfg), 2)
    result.update(golden_fwd_bwd_s=gstep, golden_fwd_bwd_first_call_s=first)

    c5, s5 = BENCH_CONFIGS["config5"], random_scene(256, seed=3)
    (_, info), first, t5 = _best(
        lambda: render_single(s5, c5, return_info=True, on_drop="raise"), 1)
    result.update(config5_fwd_s=t5, config5_fwd_first_call_s=first,
                  config5_dropped=info["dropped"],
                  config5_backend=resolve_backend("auto", s5, c5))

    print(json.dumps({
        "metric": "Mrays/s fwd+bwd 640x480 depth-4 (config 3, one GPU)",
        "value": cfg.rays_per_frame / step3 / 1e6,
        "unit": "Mrays/s",
        **result,
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
