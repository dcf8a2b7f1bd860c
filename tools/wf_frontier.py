"""Config-5 wavefront (chunk, capacity) frontier probe, forward or train
step, on the GPU.

For each (chunk_rays, capacity_factor) point: compile, run one warm
config-5 frame (1920x1080 d6 N256 alias 3; `--ad` times the training step
loss_and_grad_wavefront instead), and report seconds and the dropped-ray
counter.  The zero-drop point with the best time is a candidate for
render.WF_AUTO_CHUNK / WF_AUTO_LADDER; a point that drops also biases
training gradients, so only zero-drop points qualify.

Usage: python tools/wf_frontier.py [--ad] --points 524288:0.9375 ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", nargs="+",
                    default=["524288:0.9375", "524288:1.25", "262144:0.9375",
                             "1048576:0.9375"])
    ap.add_argument("--ad", action="store_true",
                    help="probe the training step instead of the forward")
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from raytpu.config import BENCH_CONFIGS
    from raytpu.grad import loss_and_grad_wavefront
    from raytpu.kernels.wavefront import render_pixels_wavefront
    from raytpu.scene import random_scene
    from raytpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cfg = BENCH_CONFIGS["config5"]
    scene = random_scene(256, seed=args.seed)
    target = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
    results = []
    for pt in args.points:
        ch_s, cap_s = pt.split(":")
        chunk, cap = int(ch_s), float(cap_s)

        def fn():
            if args.ad:
                _, grads, info = loss_and_grad_wavefront(
                    scene, cfg, target, chunk_rays=chunk,
                    capacity_factor=cap, on_drop="ignore", return_info=True)
                return jax.block_until_ready(grads), info["dropped"]
            img, info = render_pixels_wavefront(
                scene, cfg, chunk_rays=chunk, capacity_factor=cap,
                return_info=True)
            return jax.block_until_ready(img), int(info["dropped"])

        t0 = time.perf_counter()
        fn()  # compile
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, dropped = fn()
        dt = time.perf_counter() - t0
        rec = {"chunk": chunk, "cap": cap, "ad": args.ad, "s": dt,
               "dropped": dropped, "first_call_s": t_compile}
        results.append(rec)
        print(json.dumps(rec), flush=True)
    best = min((r for r in results if r["dropped"] == 0),
               key=lambda r: r["s"], default=None)
    print(json.dumps({"best_zero_drop": best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
