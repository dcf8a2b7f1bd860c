"""Render drivers: single-device jit, multi-device shard_map, timing.

This is the reference host driver (main.cpp:94-508) rebuilt for JAX: scene
construction is a pytree (raytpu.scene), "kernel launch geometry"
(main.cpp:296-334) becomes a pixel-axis sharding over a device mesh, the
blocking buffer uploads/readbacks become jax device placement, and the
wall-clock timing around enqueue+finish (main.cpp:352-374) becomes
block_until_ready timing with a rays/s derivation.

Compute backends share one semantics contract:
  * "jnp"       — the XLA-fused breadth-first tracer (raytpu.trace); runs
                  anywhere, is the differentiable dense path.
  * "pallas"    — the fused depth-first forward kernel
                  (raytpu.kernels.trace_pallas), compiled through Triton for
                  the GPU; forward only.
  * "wavefront" — the jnp level body + sorted ray compaction
                  (raytpu.kernels.wavefront); the large-scene/deep-depth
                  path, forward and training, plain XLA on any platform.
  * "auto"      — see resolve_backend.
"""

from __future__ import annotations

import functools
import time
import warnings

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from raytpu.config import RenderConfig
from raytpu.parallel.mesh import PIXEL_AXIS, make_mesh
from raytpu.trace import render_image, render_pixels


# Dense/wavefront crossover in per-ray tree work N x 2^depth: the wavefront
# renders scenes at or above it, the forward kernel those below.  The value
# carries over from the earlier accelerator; on the GPU it is checked only
# at its two ends (config 3 and config 5, PERF.md).
_WF_MIN_WORK = 512          # spheres * 2^depth at the crossover

BACKENDS = ("jnp", "pallas", "wavefront")


def _wf_wins(n_spheres: int, depth: int) -> bool:
    return n_spheres * (2 ** depth) >= _WF_MIN_WORK


def resolve_backend(backend: str = "auto", scene=None,
                    cfg: RenderConfig | None = None, *, train: bool = False,
                    interpret: bool = False) -> str:
    """Resolve a backend name to the path that will run — the one backend
    resolver for rendering (render_single/render_sharded) and training
    (`train=True`: loss_and_grad_sharded/fit_scene).

    "auto" on the GPU: for rendering, the wavefront for scenes at or past
    the N x 2^depth crossover (_WF_MIN_WORK, needs `scene` and `cfg`) and
    the fused forward kernel ("pallas") below it; for training, the
    wavefront (XLA autodiff of the jnp tracer's full tree measured 2.2x
    slower at config 3 and compiles 2.3x longer — PERF.md).  "jnp" on
    every other platform.

    "pallas" is a GPU kernel: asked for on another platform it raises,
    unless the caller asks for the Pallas interpreter with
    `interpret=True`.  It has no backward, so training with it raises."""
    if backend == "auto":
        if jax.default_backend() != "gpu":
            return "jnp"
        if train or (scene is not None and cfg is not None
                     and _wf_wins(scene.spheres.pos.shape[0],
                                  cfg.max_depth)):
            return "wavefront"
        return "pallas"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "pallas":
        if train:
            raise ValueError("the 'pallas' backend is a forward kernel with "
                             "no backward; train with 'jnp' or 'wavefront'")
        if not interpret and jax.default_backend() != "gpu":
            raise RuntimeError(
                f"the 'pallas' backend compiles for the GPU, and the "
                f"platform is {jax.default_backend()!r}; pass "
                f"interpret=True to run it in the Pallas interpreter")
    return backend


# Auto-capacity ladders for the wavefront backend: start at the tuned
# zero-drop frontier and escalate on any drop — rendering is stateless, so
# the retry is exact.  The frontier is scene-dependent, which is why the
# aggressive first rung is safe ONLY with the drop-triggered retry; 4.0 is
# the "any scene" backstop.  An explicit capacity_factor in wf_opts
# disables the ladder (single attempt, user owns the tradeoff).  The chunk
# sizes and rungs were tuned on the earlier accelerator and are not
# measured on the GPU yet.
WF_AUTO_CHUNK = 1 << 19
WF_AUTO_LADDER = (0.9375, 1.0625, 1.25, 2.0, 4.0)


def _wf_auto_trials(wf_opts: dict | None):
    """Resolve wavefront tuning to a list of option dicts to try in order
    (rendering and training share one ladder).

    No explicit capacity_factor -> the auto ladder (tuned-frontier first,
    escalating on drops); explicit capacity_factor -> exactly that, one
    attempt."""
    o = dict(wf_opts or {})
    if "capacity_factor" in o:
        return [o]
    o.setdefault("chunk_rays", WF_AUTO_CHUNK)
    return [dict(o, capacity_factor=c) for c in WF_AUTO_LADDER]


def _warn_escalate(n: int, tried: dict, nxt: dict):
    warnings.warn(
        f"wavefront auto-capacity: {n} live rays dropped at "
        f"capacity_factor={tried['capacity_factor']}; retrying at "
        f"{nxt['capacity_factor']} (the zero-drop frontier is "
        f"scene-dependent — see BASELINE.md)", RuntimeWarning, stacklevel=3)


class DroppedRaysError(RuntimeError):
    """Live rays exceeded the wavefront's per-level capacity and were
    dropped — the image is missing their contribution.  Raise the
    capacity_factor (or chunk_rays) until the drop count is zero."""


def _report_drops(dropped, on_drop: str) -> int:
    """Concretize the wavefront drop counter and report it loudly.

    Round 3 shipped a tuning (256K chunks x capacity 1.5) that silently
    lost 0.56% of live rays — only bench.py's counter caught it.  Every
    user-facing render path now routes through here: `on_drop` is
    "warn" (default), "raise" (strict), or "ignore"."""
    n = int(dropped)
    if n > 0 and on_drop == "raise":
        raise DroppedRaysError(
            f"wavefront dropped {n} live rays (per-level capacity "
            f"overflow); increase capacity_factor or chunk_rays")
    if n > 0 and on_drop == "warn":
        warnings.warn(
            f"wavefront dropped {n} live rays (per-level capacity "
            f"overflow) — the image is missing their light; increase "
            f"capacity_factor or chunk_rays", RuntimeWarning, stacklevel=3)
    return n


def render_single(scene, cfg: RenderConfig, backend: str = "auto",
                  wf_opts: dict | None = None, return_info: bool = False,
                  on_drop: str = "warn", interpret: bool = False):
    """One-device full-frame render -> (H, W, 3), or (image, info) with
    `return_info` where info = {'dropped': int}.

    `wf_opts`: wavefront-backend tuning knobs passed straight to
    render_pixels_wavefront (chunk_rays / capacity_factor / eager_sort);
    ignored by the other backends.  Without an explicit capacity_factor
    the wavefront runs the AUTO ladder: tuned-frontier capacity first, and
    on any drop the frame is re-rendered at the next escalation
    (stateless, so the retry is exact — WF_AUTO_LADDER).  Wavefront
    renders that still drop live rays after the ladder warn by default —
    `on_drop` in {"warn", "raise", "ignore"}.  `interpret` runs the
    "pallas" kernel in the Pallas interpreter (see resolve_backend)."""
    backend = resolve_backend(backend, scene, cfg, interpret=interpret)
    if backend == "pallas":
        from raytpu.kernels import render_image_pallas

        img = render_image_pallas(scene, cfg, interpret=interpret)
        info = dict(dropped=0)
    elif backend == "wavefront":
        from raytpu.kernels import render_image_wavefront

        trials = _wf_auto_trials(wf_opts)
        for i, o in enumerate(trials):
            img, info = render_image_wavefront(scene, cfg,
                                               return_info=True, **o)
            n = int(info["dropped"])
            if n == 0 or i + 1 == len(trials):
                break
            _warn_escalate(n, o, trials[i + 1])
        # The resolved tuning rides out so a caller rendering many frames
        # of the same scene can pass it back as wf_opts and skip the
        # ladder's dropped attempts next time.
        info = dict(info, dropped=_report_drops(n, on_drop), wf_opts=o)
    else:
        img = render_image(scene, cfg)
        info = dict(dropped=0)
    return (img, info) if return_info else img


@functools.lru_cache(maxsize=32)
def _sharded_render_fn(cfg: RenderConfig, mesh, backend: str,
                       interpret: bool, wf_opts: tuple = (),
                       stride: int = 1):
    """Compile one sharded render: pixel ids sharded over the mesh's
    pixel axis, scene replicated, zero collectives (pixels independent).

    `stride` 1 = contiguous pixel blocks per device; `stride` = mesh size
    gives each device the INTERLEAVED set {shard + j*stride} — hot strips
    (up to 2x live-ray load under block sharding, BASELINE.md round-4
    shard-balance study) then average out across devices.  `interpret`
    (the pallas kernel in the Pallas interpreter) and `wf_opts` (the
    wavefront tuning dict as a sorted item tuple) are part of the cache
    key."""

    def body(scene, gid):
        # Every backend returns (pixels, dropped[1]) so the driver can
        # surface the wavefront drop counter; the other backends never
        # drop, and `0 * gid[:1]` keeps the zero device-varying for the
        # jnp path's vma check.
        zero_drop = jnp.zeros((1,), jnp.int32) + 0 * gid[:1]
        if backend == "pallas":
            from raytpu.kernels import render_pixels_pallas
            return render_pixels_pallas(scene, cfg, interpret=interpret,
                                        offset=gid[0], stride=stride,
                                        count=gid.shape[0]), zero_drop
        if backend == "wavefront":
            from raytpu.kernels import render_pixels_wavefront
            pix, info = render_pixels_wavefront(
                scene, cfg, offset=gid[0], shard_stride=stride,
                count=gid.shape[0], return_info=True, **dict(wf_opts))
            return pix, info["dropped"].reshape(1)
        return render_pixels(scene, cfg, gid), zero_drop

    # check_vma=False: pallas_call outputs carry no varying-axis metadata,
    # which the default checker rejects; the jnp body is unaffected either
    # way (equality with the single-device render is pinned by tests).
    fn = jax.shard_map(body, mesh=mesh, in_specs=(P(), P(PIXEL_AXIS)),
                   out_specs=(P(PIXEL_AXIS), P(PIXEL_AXIS)),
                   check_vma=(backend == "jnp"))
    return jax.jit(fn)


def render_sharded(scene, cfg: RenderConfig, mesh=None, backend: str = "auto",
                   wf_opts: dict | None = None, return_info: bool = False,
                   on_drop: str = "warn", interleave: bool = False,
                   interpret: bool = False):
    """Render the frame with the pixel grid sharded across all devices.

    Pads the pixel count up to a multiple of the mesh size by re-rendering
    the last pixel (discarded), so any image size works on any mesh.
    `interleave` gives each device the strided pixel set {shard + j*mesh}
    instead of a contiguous block: per-device live-ray load is then the
    frame average instead of up-to-2x on hot strips (BASELINE.md round-4
    shard-balance study) — bit-identical output (pixels are independent;
    one reshape-transpose reassembles the frame).
    With `return_info`, returns (image, {'dropped': int}) — the summed
    per-shard wavefront drop counters.  Without an explicit
    capacity_factor the wavefront backend runs the auto-capacity ladder
    (escalate + re-render on drops, see render_single); residual drops
    warn/raise per `on_drop`.  `interpret` as in render_single.
    """
    if mesh is None:
        mesh = make_mesh()
    backend = resolve_backend(backend, scene, cfg, interpret=interpret)
    n = int(mesh.devices.size)
    p = cfg.num_pixels
    per = -(-p // n)
    i = jnp.arange(per * n, dtype=jnp.int32)
    if interleave and n > 1:
        # Shard s's block holds pixels {s + k*n}: gid[s*per + k].
        gid = jnp.minimum(i // per + (i % per) * n, p - 1)
    else:
        gid = jnp.minimum(i, p - 1)
    stride = n if interleave and n > 1 else 1
    trials = (_wf_auto_trials(wf_opts) if backend == "wavefront"
              else [dict(wf_opts or {})])
    for t, o in enumerate(trials):
        out, drops = _sharded_render_fn(cfg, mesh, backend, interpret,
                                        tuple(sorted(o.items())), stride)(
            scene, gid)
        nd = int(jnp.sum(drops)) if backend == "wavefront" else 0
        if nd == 0 or t + 1 == len(trials):
            break
        _warn_escalate(nd, o, trials[t + 1])
    if interleave and n > 1:
        # Row s*per + k holds pixel s + k*n; the transpose puts row q at
        # pixel q (pad duplicates land past p and are sliced off).
        out = out.reshape(n, per, 3).transpose(1, 0, 2).reshape(-1, 3)
    img = out[:p].reshape(cfg.height, cfg.width, 3)
    dropped = _report_drops(nd, on_drop) if (backend == "wavefront"
                                             or return_info) else 0
    info = dict(dropped=dropped)
    if backend == "wavefront":
        info["wf_opts"] = o       # resolved tuning (see render_single)
    return (img, info) if return_info else img


def render_timed(scene, cfg: RenderConfig, mesh=None, warmup: int = 1,
                 iters: int = 3, backend: str = "auto",
                 wf_opts: dict | None = None, on_drop: str = "warn",
                 interleave: bool = False):
    """Render and time it (compile excluded via warmup), returning
    (image, stats).  Mrays/s counts camera rays (pixels * alias^2), the
    same accounting as the reference's per-work-item model; `traced_rays`
    additionally counts every node of the 2^depth bounce tree.  stats
    always includes `dropped` (wavefront live rays lost to capacity
    overflow — 0 means the frame is exact; nonzero warns/raises per
    `on_drop`)."""
    if mesh is not None:
        fn = lambda s: render_sharded(s, cfg, mesh, backend, wf_opts=wf_opts,
                                      return_info=True, on_drop=on_drop,
                                      interleave=interleave)
    else:
        fn = lambda s: render_single(s, cfg, backend, wf_opts=wf_opts,
                                     return_info=True, on_drop=on_drop)

    def run(s):
        img, info = fn(s)
        return jax.block_until_ready(img), info

    for _ in range(max(warmup, 0)):
        img, info = run(scene)
    times = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        img, info = run(scene)
        times.append(time.perf_counter() - t0)
    dt = min(times)
    primary = cfg.rays_per_frame
    tree = (2 ** (cfg.max_depth + 1) - 1) * primary
    stats = dict(
        seconds=dt,
        primary_rays=primary,
        traced_rays=tree,
        mrays_per_s=primary / dt / 1e6,
        traced_mrays_per_s=tree / dt / 1e6,
        backend=resolve_backend(backend, scene, cfg),
        dropped=int(info["dropped"]),
        times=times,
    )
    return img, stats
