"""Bring-up check on the GPU: the tracer's render and fit paths, end to end,
through the entry points a user calls, at full size.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the sharded paths only

Phases (one card):
  card      — JAX must see a GPU; prints `nvidia-smi` name and power limit
              (queried from a child process that stays off JAX).
  golden    — the reference scene at 800x600, depth 5, 3x3 AA through
              render_single(backend="auto") and through the CLI
              (`raytpu.cli.main -o`), each against the jnp tracer on the
              card; and the jnp tracer on the card against the repo's CPU
              golden (tests/goldens/default_160x120_d4_linear.npy).
  kernel    — the fused forward kernel ("pallas", compiled through Triton)
              against the jnp tracer at golden, config 3 (640x480 d4),
              config 2 (320x240 d2) and random_scene(64) at 640x480 d2,
              with both times.
  wavefront — random_scene(256, seed=3), 1920x1080, depth 6, 3x3 AA (config
              5) through render_single(backend="auto"), so the wavefront:
              zero dropped rays, and agreement with the jnp full-tree render
              on a strided eighth of the pixels; and the wavefront at golden
              against the jnp tracer.
  fit       — three fit_scene steps at golden (finite losses).
  grads     — one loss_and_grad_wavefront step at config 5 (zero drops);
              wavefront gradients against jnp autodiff at 160x120 d3 (one
              sample per pixel).

The phases run twice.  First all at once, on threads, so that their
compiles overlap; every check holds in this pass too, and it prints
nothing.  Then one after another, warm, printing their numbers: every time
printed is taken while nothing else runs.

With --four: render_sharded at golden and config 5, and
loss_and_grad_sharded at config 2 (the "auto" training backend, so the
wavefront), over a 1-D mesh of four GPUs with block and interleaved
sharding, each against one card.

Two renders of one frame by separately compiled float32 programs disagree
on some pixels: XLA:GPU fuses, contracts FMAs and orders sums differently
in each, and a ray whose root sits near the 1e-5 epsilon, or a near-tangent
ray, takes another branch with a full-magnitude effect on its pixel.  The
contract for two renders of one frame (tests/test_pallas.py): at most 1% of
pixels off by more than 1e-2 x the image max, and a mean error below 1e-3 x
max.  Three comparisons take wider limits, each set between its reading on
the card and the reading of a float64 witness (tools/card_witness.py: the
jnp tracer in float64 on the same pixels; numbers in PERF.md):

  random_scene(64) at 640x480 d2: 5% of pixels, mean 3e-3 x max (the
    large-N contract of test_pallas.test_256_spheres_matches_jnp).  Kernel
    vs jnp measures 1.1%, wavefront vs jnp 2.4%; every float32 path is
    off the float64 render on 12% of pixels.
  config 5: 8% of pixels, mean 3e-3 x max.  Wavefront vs jnp measures
    5.0% (mean 1.3e-3); every float32 path, the jnp tracer included, is
    off the float64 render on 23% of pixels (mean 6.4e-2).  Refracted rays
    start at their hit point, and at random_scene's 40-unit coordinates
    float32 puts a root on that same surface just past the 1e-5 epsilon; with the epsilon at 1e-3 float32 meets float64 on
    all but 0.02% of pixels.  Where two float32 paths disagree, both are
    off the float64 render (95% of such pixels).
  Gradients at 160x120 d3, leaf by leaf over the leaf's largest entry:
    2e-2 (2e-3 on the CPU, tests/test_wavefront.py).  Wavefront vs jnp
    autodiff measures 7.3e-3; either against float64 autodiff, 0.19.  The
    losses: 3% (measured 1.6%; each float32 loss is up to 1.2% off the
    float64 one).

Every phase raises on failure, and no failure is passed over (--four runs
all its cells, then raises with every one that failed).  The last line of
standard output is the JSON result, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import subprocess
import sys
import tempfile
import time

FRAME = dict(frac=0.01, mean=1e-3)
FRAME_LARGE_N = dict(frac=0.05, mean=3e-3)
FRAME_CONFIG5 = dict(frac=0.08, mean=3e-3)
GRAD_TOL_CARD = 2e-2
# Relative loss gap between two float32 paths at 160x120 d3: a flipped
# pixel's squared error against a 1.2x target is ~36x a kept pixel's.
LOSS_TOL_CARD = 3e-2
# Block-sharded config 5: the first capacity rung at which every one of
# the four contiguous windows renders with zero drops, measured on the card
# (tools/card_witness.py; PERF.md).  A window holding the frame's hot strip
# needs more than the frame average, so the ladder's first rungs drop.
BLOCK_C5_CAPACITY = 2.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def compare(got, want, frac, mean):
    """Frame contract (module docstring); returns the measured numbers."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all(), "non-finite pixels"
    scale = max(float(np.abs(want).max()), 1e-30)
    d = np.abs(got - want).reshape(-1, got.shape[-1])
    stats = dict(outliers=float((d.max(axis=-1) > 1e-2 * scale).mean()),
                 mean_rel=float(d.mean() / scale))
    assert stats["outliers"] <= frac and stats["mean_rel"] < mean, stats
    return stats


def compare_grads(got, want, tol):
    """Leaf by leaf: max |got - want| over the leaf's largest |want|.
    Returns (worst, per-leaf dict)."""
    import jax
    import numpy as np

    rels = {}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all(), jax.tree_util.keystr(path)
        rels[jax.tree_util.keystr(path)] = (
            float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30))
    assert max(rels.values()) <= tol, rels
    return max(rels.values()), {k: f"{v:.2e}" for k, v in rels.items()}


def compare_loss(got, want, tol):
    gap = abs(float(got) - float(want)) / abs(float(want))
    assert gap <= tol, (float(got), float(want))
    return gap


def cfg(name):
    """The frames the phases share beside raytpu.config.BENCH_CONFIGS."""
    from raytpu.config import RenderConfig

    return dict(
        # The repo's CPU golden (tests/goldens/default_160x120_d4_*).
        small_golden=RenderConfig(width=160, height=120, max_depth=4),
        random64=RenderConfig(width=640, height=480, max_depth=2),
        # One sample per pixel: XLA's jnp autodiff compiles one bounce
        # tree per sample, and nine would dominate the compile time.
        small_grad=RenderConfig(width=160, height=120, max_depth=3,
                                alias_factor=1),
    )[name]


def timed(fn, reps=3):
    """(result, best of `reps` warm calls in seconds) after one call."""
    import jax

    out = jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return out, best


def say(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def quiet(phase, **kw):
    pass


def phase_golden(say, repo):
    import numpy as np

    import jax
    from raytpu.cli import main as cli_main
    from raytpu.config import BENCH_CONFIGS
    from raytpu.image import read_ppm, tone_map
    from raytpu.render import render_single, resolve_backend
    from raytpu.scene import default_scene
    from raytpu.trace import render_image

    scene, golden = default_scene(), BENCH_CONFIGS["golden"]
    ref, t_ref = timed(lambda: render_image(scene, golden))
    img, t_img = timed(lambda: render_single(scene, golden))
    say("golden", backend=resolve_backend("auto", scene, golden),
        auto_s=f"{t_img:.6f}", jnp_s=f"{t_ref:.6f}",
        **compare(img, ref, **FRAME))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "golden.ppm")
        assert cli_main(["--width", str(golden.width),
                         "--height", str(golden.height),
                         "--max-depth", str(golden.max_depth),
                         "--alias-factor", str(golden.alias_factor),
                         "-o", out]) == 0
        cli_img = read_ppm(out)
    # The CLI writes the tone-mapped 8-bit image: compare bytes.
    want = tone_map(np.asarray(ref)).astype(np.int32)
    diff = np.abs(cli_img.astype(np.int32) - want)
    say("golden", cli="-o", bytes_exact=float((diff == 0).mean()),
        within_2=float((diff <= 2).mean()))
    assert (diff.max(axis=-1) > 2).mean() <= FRAME["frac"]

    cpu_golden = np.load(os.path.join(repo, "tests", "goldens",
                                      "default_160x120_d4_linear.npy"))
    on_card = np.asarray(jax.block_until_ready(
        render_image(scene, cfg("small_golden"))))
    d = np.abs(on_card - cpu_golden)
    scale = float(np.abs(cpu_golden).max())
    say("golden", vs_cpu_golden="160x120 d4", max_rel=float(d.max() / scale),
        **compare(on_card, cpu_golden, **FRAME))


def phase_kernel(say):
    from raytpu.config import BENCH_CONFIGS
    from raytpu.kernels.trace_pallas import render_image_pallas
    from raytpu.scene import default_scene, random_scene
    from raytpu.trace import render_image

    cells = [("golden", default_scene(), BENCH_CONFIGS["golden"], FRAME),
             ("config3", default_scene(), BENCH_CONFIGS["config3"], FRAME),
             ("config2", default_scene(), BENCH_CONFIGS["config2"], FRAME),
             ("random64", random_scene(64), cfg("random64"), FRAME_LARGE_N)]
    for name, scene, frame, tol in cells:
        ref, t_ref = timed(lambda: render_image(scene, frame))
        out, t_k = timed(lambda: render_image_pallas(scene, frame))
        say("kernel", cell=name, kernel_s=f"{t_k:.6f}",
            xla_jnp_s=f"{t_ref:.6f}", **compare(out, ref, **tol))


def phase_wavefront(say):
    import jax
    import jax.numpy as jnp

    from raytpu.config import BENCH_CONFIGS
    from raytpu.render import render_single
    from raytpu.scene import default_scene, random_scene
    from raytpu.trace import render_image, render_pixels

    scene, c5 = random_scene(256, seed=3), BENCH_CONFIGS["config5"]
    (img, info), t_w = timed(
        lambda: render_single(scene, c5, return_info=True, on_drop="raise"),
        reps=1)
    assert info["dropped"] == 0, info
    gid = jnp.arange(0, c5.num_pixels, 8, dtype=jnp.int32)
    render_strip = jax.jit(render_pixels, static_argnums=1)
    ref, t_ref = timed(lambda: render_strip(scene, c5, gid), reps=1)
    say("wavefront", cell="config5", backend="wavefront",
        dropped=info["dropped"],
        wf_opts=json.dumps(info["wf_opts"]).replace(" ", ""),
        wavefront_s=f"{t_w:.3f}", jnp_eighth_s=f"{t_ref:.3f}",
        **compare(img.reshape(-1, 3)[gid], ref, **FRAME_CONFIG5))

    # The same path on a scene whose float32 renders agree closely.
    scene, golden = default_scene(), BENCH_CONFIGS["golden"]
    (img, info), t_w = timed(lambda: render_single(
        scene, golden, backend="wavefront", return_info=True,
        on_drop="raise"), reps=1)
    say("wavefront", cell="golden", dropped=info["dropped"],
        wavefront_s=f"{t_w:.4f}",
        **compare(img, render_image(scene, golden), **FRAME))


def phase_fit(say):
    import numpy as np

    from raytpu.config import BENCH_CONFIGS
    from raytpu.grad import fit_scene
    from raytpu.render import resolve_backend
    from raytpu.scene import default_scene
    from raytpu.trace import render_image

    scene, golden = default_scene(), BENCH_CONFIGS["golden"]
    target = render_image(scene, golden).reshape(-1, 3) * 1.1
    steps = []
    t0 = time.perf_counter()
    _, losses = fit_scene(scene, golden, target, steps=3,
                          callback=lambda *_: steps.append(
                              time.perf_counter()))
    assert all(np.isfinite(losses)), losses
    say("fit", cell="golden fit_scene",
        backend=resolve_backend("auto", scene, golden, train=True),
        losses=losses, first_step_s=f"{steps[0] - t0:.4f}",
        step_s=f"{(steps[-1] - steps[0]) / 2:.4f}")


def phase_grads(say):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytpu.config import BENCH_CONFIGS
    from raytpu.grad import loss_and_grad, loss_and_grad_wavefront
    from raytpu.scene import default_scene, random_scene
    from raytpu.trace import render_image

    scene, c5 = random_scene(256, seed=3), BENCH_CONFIGS["config5"]
    target = jnp.zeros((c5.num_pixels, 3), jnp.float32)
    (loss, grads, info), t_w = timed(
        lambda: loss_and_grad_wavefront(scene, c5, target, return_info=True),
        reps=1)
    assert info["dropped"] == 0 and np.isfinite(float(loss)), info
    assert all(np.isfinite(np.asarray(g)).all()
               for g in jax.tree_util.tree_leaves(grads))
    say("grads", cell="config5 loss_and_grad_wavefront", loss=float(loss),
        dropped=info["dropped"], step_s=f"{t_w:.3f}")

    scene, small = default_scene(), cfg("small_grad")
    target = render_image(scene, small).reshape(-1, 3) * 1.2
    lw, gw = loss_and_grad_wavefront(scene, small, target, chunk_rays=8192)
    lj, gj = loss_and_grad(scene, small, target)
    worst, leaves = compare_grads(gw, gj, GRAD_TOL_CARD)
    say("grads", cell="160x120 d3 wavefront vs jnp", **leaves)
    say("grads", cell="160x120 d3 wavefront vs jnp",
        loss_wavefront=float(lw), loss_jnp=float(lj),
        loss_gap=f"{compare_loss(lw, lj, LOSS_TOL_CARD):.2e}",
        worst_leaf_rel=f"{worst:.2e}")


def phase_four(say, small=False):
    """The sharded paths, one cell at a time (their programs hold
    collectives, so they never run concurrently).  Every cell runs; the
    phase then raises with each cell that failed."""
    import jax

    from raytpu.config import BENCH_CONFIGS, RenderConfig
    from raytpu.grad import (loss_and_grad, loss_and_grad_sharded,
                             loss_and_grad_wavefront)
    from raytpu.parallel.mesh import make_mesh
    from raytpu.render import (WF_AUTO_CHUNK, render_sharded, render_single,
                               resolve_backend)
    from raytpu.scene import default_scene, random_scene

    devices = jax.devices()
    assert len(devices) == 4, devices
    mesh = make_mesh(devices)
    golden, c5, c2 = (BENCH_CONFIGS[k] for k in ("golden", "config5",
                                                 "config2"))
    if small:      # a rehearsal on four virtual CPU devices
        golden, c5, c2 = (
            RenderConfig(width=32, height=24, max_depth=c.max_depth,
                         alias_factor=c.alias_factor) for c in (golden, c5,
                                                                 c2))
    scene = default_scene()

    def grads(interleave):
        # Training through the resolver's choice ("auto": the wavefront on
        # the GPU) against one card's single-device step.
        target = render_single(scene, c2).reshape(-1, 3) * 1.1
        backend = resolve_backend("auto", scene, c2, train=True)
        one = (loss_and_grad_wavefront if backend == "wavefront"
               else loss_and_grad)
        l1, g1 = one(scene, c2, target)
        (l4, g4, info), t4 = timed(lambda: loss_and_grad_sharded(
            scene, c2, target, mesh, interleave=interleave,
            return_info=True), reps=1)
        assert info["dropped"] == 0, info
        worst, _ = compare_grads(g4, g1, GRAD_TOL_CARD)
        say("four", op="loss_and_grad_sharded", cell="config2",
            backend=backend, interleave=interleave, loss_one=float(l1),
            loss_four=float(l4),
            loss_gap=f"{compare_loss(l4, l1, LOSS_TOL_CARD):.2e}",
            worst_leaf_rel=f"{worst:.2e}", four_card_s=f"{t4:.4f}")

    def render(name, scene, frame, tol, interleave, wf_opts=None):
        one, _ = render_single(scene, frame, return_info=True,
                               on_drop="raise")
        (img, info), t4 = timed(lambda: render_sharded(
            scene, frame, mesh, interleave=interleave, wf_opts=wf_opts,
            return_info=True, on_drop="raise"), reps=1)
        assert info["dropped"] == 0, info
        say("four", op="render_sharded", cell=name,
            backend=resolve_backend("auto", scene, frame),
            interleave=interleave,
            wf_opts=json.dumps(info.get("wf_opts")).replace(" ", ""),
            four_card_s=f"{t4:.4f}", **compare(img, one, **tol))

    s5 = random_scene(256, seed=3)
    cells = [
        lambda: render("config5", s5, c5, FRAME_CONFIG5, True),
        lambda: render("config5", s5, c5, FRAME_CONFIG5, False,
                       dict(chunk_rays=WF_AUTO_CHUNK,
                            capacity_factor=BLOCK_C5_CAPACITY)),
        lambda: grads(False),
        lambda: grads(True),
        lambda: render("golden", scene, golden, FRAME, False),
        lambda: render("golden", scene, golden, FRAME, True),
    ]
    failed = []
    for i, cell in enumerate(cells):
        try:
            cell()
        except Exception as e:      # re-raised below, with every failure
            say("four", cell_index=i, failed=repr(e)[:500])
            failed.append(e)
    if failed:
        raise RuntimeError(f"{len(failed)} four-card cells failed: "
                           f"{failed!r}"[:4000])


def one_card(repo):
    """Both passes over the one-card phases (module docstring)."""
    phases = [("golden", lambda s: phase_golden(s, repo)),
              ("kernel", phase_kernel), ("wavefront", phase_wavefront),
              ("fit", phase_fit), ("grads", phase_grads)]
    t = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=len(phases)) as pool:
        for fut in [pool.submit(fn, quiet) for _, fn in phases]:
            fut.result()
    say("phase", name="first pass (all phases at once, compiles included)",
        seconds=f"{time.perf_counter() - t:.1f}")
    for name, fn in phases:
        t = time.perf_counter()
        fn(say)
        say("phase", name=name, seconds=f"{time.perf_counter() - t:.1f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded render and "
                         "gradient phase")
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devices[0].platform}",
              file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "raytpu")):
        print(f"chip_smoke: no raytpu package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, repo)
    from raytpu.utils.compile_cache import enable_compile_cache

    print(card_line(), flush=True)
    say("card", card=card_line().replace(" ", "_"),
        devices=len(devices), kind=devices[0].device_kind.replace(" ", "_"),
        compile_cache=enable_compile_cache())
    t0 = time.perf_counter()
    if args.four:
        phase_four(say)
    else:
        one_card(repo)
    say("done", seconds=f"{time.perf_counter() - t0:.1f}",
        peak_bytes=devices[0].memory_stats().get("peak_bytes_in_use"))
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
