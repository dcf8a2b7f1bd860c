"""A float64 witness for the GPU's float32 frames and gradients.

Two renders of one frame by separately compiled float32 programs disagree
on some pixels, and chip_smoke.py holds each pair to a limit.  This tool
shows where those limits come from: the GPU's float32 outputs are saved,
and the jnp tracer recomputes the same pixels and gradients in float64.

    python tools/card_witness.py card OUT       # on the GPU
    python tools/card_witness.py witness OUT    # afterwards, on the CPU

`card` renders on the GPU, in float32, the pixels chip_smoke.py compares:
config 5 (a strided strip), golden and random_scene(64) at 640x480 d2
(strided strips) through the jnp tracer, the forward kernel and the
wavefront, and the 160x120 d3 gradients through the wavefront and jnp
autodiff.  It also counts the wavefront's dropped rays in each of the
four block-sharded and interleaved config-5 windows that a four-GPU
render_sharded gives its devices, at the rungs of the capacity ladder,
and times one training step at config 2 through jnp autodiff and through
the wavefront.  Everything lands in OUT (strips.npz, grads.npz, a JSON
report).

`witness` reruns the jnp tracer on the same pixel ids with x64 enabled
(scene, camera rays and every intermediate in float64), then reports each
float32 output against the float64 one and each pair of float32 outputs
against each other, with the frame contract's numbers (share of pixels
off by more than 1e-2 x the image max; mean error over the max).  For
pixels where two float32 outputs disagree it says which of them is off
the float64 render, and for the config-5 strip it re-renders in float32
with the 1e-5 root epsilon (raytracer.h:86) raised to 1e-3, on every ray
and on shadow rays alone: what that removes from the float32/float64 gap
comes from roots just above the epsilon, i.e. rays leaving a surface that
hit it again.
"""

from __future__ import annotations

import argparse
import dataclasses
import concurrent.futures as cf
import json
import os
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from raytpu.config import BENCH_CONFIGS, RenderConfig  # noqa: E402
from raytpu.scene import default_scene, random_scene  # noqa: E402
from raytpu.trace import render_pixels  # noqa: E402

# Pixel strides of the saved strips (config 5's strip is every 8th pixel
# of chip_smoke's strided eighth, so its jnp program is chip_smoke's).
C5_STRIDE, STRIDE = 64, 4
SMALL_GRAD = RenderConfig(width=160, height=120, max_depth=3, alias_factor=1)
RANDOM64 = RenderConfig(width=640, height=480, max_depth=2)
# The config-5 sub-strip the epsilon experiment re-renders on the CPU.
MECH_STRIDE = 256


def frames():
    return {
        "config5": (random_scene(256, seed=3), BENCH_CONFIGS["config5"],
                    C5_STRIDE),
        "golden": (default_scene(), BENCH_CONFIGS["golden"], STRIDE),
        "random64": (random_scene(64), RANDOM64, STRIDE),
    }


# chip_smoke.py's jitted strip render (same function, same program).
_render_pixels = jax.jit(render_pixels, static_argnums=1)


def _strip(img, gid):
    return np.asarray(img).reshape(-1, 3)[np.asarray(gid)]


def card(out):
    from raytpu.grad import loss_and_grad, loss_and_grad_wavefront
    from raytpu.kernels.trace_pallas import render_image_pallas
    from raytpu.kernels.wavefront import render_pixels_wavefront
    from raytpu.render import (WF_AUTO_CHUNK, WF_AUTO_LADDER, render_single)
    from raytpu.trace import render_image
    from raytpu.utils.compile_cache import enable_compile_cache

    assert jax.devices()[0].platform == "gpu", jax.devices()
    enable_compile_cache()
    os.makedirs(out, exist_ok=True)
    jobs = {}
    for name, (scene, cfg, stride) in frames().items():
        gid = jnp.arange(0, cfg.num_pixels, stride, dtype=jnp.int32)
        jobs[name + "_gid"] = lambda g=gid: g
        if name == "config5":
            eighth = jnp.arange(0, cfg.num_pixels, 8, dtype=jnp.int32)
            jobs[name + "_jnp"] = (lambda s=scene, c=cfg, e=eighth:
                                   _render_pixels(s, c, e)[::8])
        else:
            jobs[name + "_jnp"] = (lambda s=scene, c=cfg, g=gid:
                                   _strip(render_image(s, c), g))
        jobs[name + "_kernel"] = (lambda s=scene, c=cfg, g=gid:
                                  _strip(render_image_pallas(s, c), g))
        jobs[name + "_wavefront"] = (lambda s=scene, c=cfg, g=gid: _strip(
            render_single(s, c, backend="wavefront", on_drop="raise"), g))

    scene = default_scene()
    target = np.asarray(render_image(scene, SMALL_GRAD)).reshape(-1, 3) * 1.2
    jobs["grad_jnp"] = lambda: loss_and_grad(scene, SMALL_GRAD, target)
    jobs["grad_wavefront"] = lambda: loss_and_grad_wavefront(
        scene, SMALL_GRAD, target, chunk_rays=8192)

    # Dropped rays per four-GPU window of config 5: block windows are
    # contiguous quarters (offset s*per), interleaved ones the strided
    # sets {s + 4j} — what render_sharded hands each device.
    s5, c5, _ = frames()["config5"]
    per = -(-c5.num_pixels // 4)
    for stride, rungs in ((1, WF_AUTO_LADDER[2:4]),
                          (4, WF_AUTO_LADDER[:2])):
        for r in rungs:
            def drops(r=r, stride=stride):
                return [int(render_pixels_wavefront(
                    s5, c5, chunk_rays=WF_AUTO_CHUNK, capacity_factor=r,
                    offset=s if stride > 1 else s * per, count=per,
                    shard_stride=stride, return_info=True)[1]["dropped"])
                    for s in range(4)]
            jobs[f"drops stride={stride} capacity={r}"] = drops

    c2 = BENCH_CONFIGS["config2"]
    t2 = jnp.zeros((c2.num_pixels, 3), jnp.float32)
    steps = {"config2 jnp autodiff": lambda: loss_and_grad(scene, c2, t2),
             "config2 wavefront": lambda: loss_and_grad_wavefront(
                 scene, c2, t2)}
    jobs.update(steps)

    # Every job once, on threads: the compiles overlap.  Single-device
    # programs without collectives, so concurrent launches are safe.
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        futs = {k: pool.submit(_first_call, f) for k, f in jobs.items()}
        res, first = {}, {}
        for k, fut in futs.items():
            res[k], first[k] = fut.result()
    report = {"card": _card_line(), "first_pass_s": time.perf_counter() - t0,
              "first_call_s (compile included, compiles overlapping)": first}
    # Timed after every compile has finished.
    for k, f in steps.items():
        best = float("inf")
        for _ in range(3):
            t = time.perf_counter()
            jax.block_until_ready(f())
            best = min(best, time.perf_counter() - t)
        report[k + " step_s"] = best
    report.update({k: v for k, v in res.items() if k.startswith("drops")})
    np.savez(os.path.join(out, "strips.npz"), **{
        k: np.asarray(v) for k, v in res.items()
        if k.split("_")[0] in frames() and not k.startswith("drops")})
    flat = {"target": target}
    for k in ("grad_jnp", "grad_wavefront"):
        loss, grads = res[k]
        flat[k + "/loss"] = np.asarray(loss)
        for path, g in jax.tree_util.tree_leaves_with_path(grads):
            flat[k + "/" + jax.tree_util.keystr(path)] = np.asarray(g)
    np.savez(os.path.join(out, "grads.npz"), **flat)
    with open(os.path.join(out, "card.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))


def _first_call(fn):
    t = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t


def _card_line():
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def contract(got, want):
    """The frame contract's numbers, plus which pixels are off."""
    scale = max(float(np.abs(want).max()), 1e-30)
    d = np.abs(got - want)
    off = d.max(axis=-1) > 1e-2 * scale
    return off, dict(outliers=float(off.mean()),
                     mean_rel=float(d.mean() / scale))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                  tree)


def witness(out):
    from raytpu.grad import loss_and_grad
    import raytpu.ops.geometry as geometry
    import raytpu.ops.shading as shading

    strips = dict(np.load(os.path.join(out, "strips.npz")))
    report = {}
    for name, (scene, cfg, _) in frames().items():
        gid = strips[name + "_gid"]
        # Small chunks bound the CPU's memory (values do not depend on it).
        cfg = dataclasses.replace(cfg, chunk_pixels=1024)
        t = time.perf_counter()
        with jax.enable_x64(True):
            w = np.asarray(_render_pixels(_f64(scene), cfg, jnp.asarray(gid)))
        rows = {"f64_s": time.perf_counter() - t, "pixels": int(gid.size)}
        f32 = {k: strips[f"{name}_{k}"] for k in ("jnp", "kernel",
                                                   "wavefront")}
        offs = {}
        for k, v in f32.items():
            offs[k], rows[k + " vs f64"] = contract(v, w)
        for a, b in (("wavefront", "jnp"), ("kernel", "jnp"),
                     ("kernel", "wavefront")):
            dis, rows[f"{a} vs {b}"] = contract(f32[a], f32[b])
            n = max(int(dis.sum()), 1)
            rows[f"{a} vs {b}"].update({
                f"of those, {a} off f64": float((dis & offs[a]).sum() / n),
                f"of those, {b} off f64": float((dis & offs[b]).sum() / n)})
        for k in f32:
            off = offs[k]
            rows[k + " vs f64"]["brighter_share"] = float(
                (f32[k].sum(-1) > w.sum(-1))[off].mean()) if off.any() else 0.0
        if name == "config5":
            sub = np.arange(0, gid.size, MECH_STRIDE // C5_STRIDE)
            g = jnp.asarray(gid[sub])
            orig = geometry.ray_sphere_t

            def wide_eps(*a):
                with mock.patch.object(geometry, "K_RAY_EPS",
                                       np.float32(1e-3)):
                    return orig(*a)
            for label, patch in (
                    ("f32 eps 1e-5", None),
                    ("f32 eps 1e-3 all rays", (geometry, "K_RAY_EPS",
                                               np.float32(1e-3))),
                    ("f32 eps 1e-3 shadow rays", (shading, "ray_sphere_t",
                                                  wide_eps))):
                jax.clear_caches()
                if patch is None:
                    v = _render_pixels(scene, cfg, g)
                else:
                    with mock.patch.object(*patch):
                        v = _render_pixels(scene, cfg, g)
                rows[f"cpu {label} vs f64 (1/{MECH_STRIDE} strip)"] = (
                    contract(np.asarray(v), w[sub])[1])
            jax.clear_caches()
        report[name] = rows
        print(name, json.dumps(rows, indent=1), flush=True)

    grads = dict(np.load(os.path.join(out, "grads.npz")))
    scene = default_scene()
    with jax.enable_x64(True):
        l64, g64 = loss_and_grad(_f64(scene), SMALL_GRAD,
                                 jnp.asarray(grads["target"], jnp.float64))
        g64 = {jax.tree_util.keystr(p): np.asarray(g) for p, g in
               jax.tree_util.tree_leaves_with_path(g64)}
    rows = {"loss f64": float(l64)}
    for k in ("grad_jnp", "grad_wavefront"):
        rows[f"loss {k}"] = float(grads[k + "/loss"])
    for a, b in (("grad_wavefront", "grad_jnp"), ("grad_jnp", "f64"),
                 ("grad_wavefront", "f64")):
        rel = {}
        for leaf, want in g64.items():
            x = grads[a + "/" + leaf]
            y = want if b == "f64" else grads[b + "/" + leaf]
            rel[leaf] = float(np.abs(x - y).max()
                              / max(float(np.abs(y).max()), 1e-30))
        rows[f"{a} vs {b}"] = dict(worst=max(rel.values()), **rel)
    report["grads 160x120 d3"] = rows
    print("grads", json.dumps(rows, indent=1), flush=True)
    with open(os.path.join(out, "witness.json"), "w") as f:
        json.dump(report, f, indent=1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("card", "witness"))
    ap.add_argument("out")
    args = ap.parse_args()
    (card if args.mode == "card" else witness)(args.out)


if __name__ == "__main__":
    main()
