"""Differentiable rendering: losses, the sharded training step, the
gradient-fit task, and the finite-difference checker.

The reference has no gradients at all — differentiability w.r.t. sphere
positions/radii, material colours/opacity/IOR and light parameters is the
headline capability this framework adds (BASELINE.json north star), enabled
by the mask-based clean tracer (raytpu.trace).  Non-differentiable events
are handled as:

  * closest-hit selection / shadow visibility / significance cutoffs:
    piecewise-constant selections — `jnp.where` gives the correct
    sub-gradient almost everywhere (zero across the discontinuity itself);
  * sqrt/div at masked lanes: guarded (double-where) so reverse-mode AD
    never sees NaN/Inf;
  * total internal reflection: reflection factor saturates at 1 (clamped),
    gradient zero at the clamp.

Finite-difference checks must avoid sampling exactly at those measure-zero
discontinuities; `finite_difference_check` reports per-leaf agreement so a
test can assert on well-behaved coordinates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from raytpu.config import RenderConfig
from raytpu.parallel.mesh import PIXEL_AXIS, make_mesh
from raytpu.trace import render_pixels


def image_loss(scene, cfg: RenderConfig, target_flat, gid=None):
    """Mean-squared error between the rendered pixels and a target.

    target_flat: (P, 3) linear-colour target (same tone-map-free space the
    tracer produces).  With `gid`, only that pixel block is rendered and
    compared against target_flat[gid], with the mean over the block.
    """
    if gid is None:
        gid = jnp.arange(cfg.num_pixels, dtype=jnp.int32)
        target = target_flat
    else:
        target = target_flat[gid]
    pred = render_pixels(scene, cfg, gid)
    err = pred - target
    return jnp.mean(err * err)


@functools.partial(jax.jit, static_argnames=("cfg",))
def loss_and_grad(scene, cfg: RenderConfig, target_flat):
    """Single-device loss + gradient w.r.t. every scene leaf (jnp autodiff)."""
    return jax.value_and_grad(image_loss)(scene, cfg, target_flat)


def exposure_image_loss(scene, cfg: RenderConfig, target_flat, gid=None):
    """MSE against a TONE-MAPPED target (e.g. a decoded golden PPM) with
    the exposure profiled out in closed form.

    The reference's PPM writer maps linear colour c to
    trunc(min(1, c) * 255 / maxColourVal) (main.cpp:66-80) — a global
    scale by the image max plus 8-bit truncation.  Dividing the byte
    target by 255 leaves target ≈ pred / maxColourVal, i.e. the target
    equals the linear render up to ONE unknown global exposure e (the
    clamp is inactive at this scene's ~1e-4 radiance scale and the
    truncation is ≤1/255 noise).  Rather than learning e as a parameter,
    the least-squares optimum e* = <pred,t>/<pred,pred> is substituted
    differentiably — the loss is then invariant to the render's global
    scale and measures pure shape mismatch, which is what fitting scene
    geometry against a quantized golden needs (BASELINE config 4 against
    the real testPPM.ppm — examples/fit_golden_scene.py).

    `target_flat`: (P, 3) byte-target / 255.  With `gid`, only that
    pixel subset is rendered and compared (minibatch fit at exact camera
    positions — cheaper than a full 800x600 render per step)."""
    if gid is None:
        gid = jnp.arange(cfg.num_pixels, dtype=jnp.int32)
        target = target_flat
    else:
        target = target_flat[gid]
    pred = render_pixels(scene, cfg, gid)
    e = jnp.sum(pred * target) / (jnp.sum(pred * pred) + 1e-30)
    r = e * pred - target
    return jnp.mean(r * r)


def loss_and_grad_wavefront(scene, cfg: RenderConfig, target_flat,
                            chunk_rays: int = 1 << 17,
                            capacity_factor: float = 2.0,
                            on_drop: str = "raise",
                            return_info: bool = False):
    """Loss + gradients via the differentiable wavefront tracer — the
    large-scene/deep-depth training path (XLA autodiff through the jnp
    level bodies; dead subtrees dropped at per-ray granularity).

    `capacity_factor` is the same frame-time lever as in
    render_pixels_wavefront — the AD scan carries the same level arrays
    — but a factor that drops rays biases the GRADIENT too (dropped
    subtrees contribute zero cotangent, and the bias is INVISIBLE in the
    loss value), so the drop counter is enforced here on every call:
    `on_drop` defaults to "raise" (a crashed step beats a silently
    biased gradient — the same fail-fast stance as the reference's
    checkError, err_code.h).  The zero-drop frontier is scene-dependent
    and *moves as geometry updates during a fit* (BASELINE.md round-4
    capacity study), which is exactly why the forward counter alone is
    not enough.  fit_scene auto-escalates capacity on drops.

    With `return_info`, returns (loss, grads, {'dropped': int})."""
    from raytpu.render import _report_drops

    (loss, dropped), grads = _loss_and_grad_wavefront(
        scene, cfg, target_flat, chunk_rays, capacity_factor)
    n = _report_drops(dropped, on_drop)
    if return_info:
        return loss, grads, dict(dropped=n)
    return loss, grads


@functools.partial(jax.jit, static_argnames=("cfg", "chunk_rays",
                                             "capacity_factor"))
def _loss_and_grad_wavefront(scene, cfg: RenderConfig, target_flat,
                             chunk_rays, capacity_factor=2.0):
    from raytpu.kernels.wavefront import render_pixels_wavefront

    def loss(s):
        img, info = render_pixels_wavefront(s, cfg, chunk_rays=chunk_rays,
                                            capacity_factor=capacity_factor,
                                            ad=True, return_info=True)
        err = img - target_flat
        # The drop counter rides value_and_grad as aux so no AD caller
        # can lose it (a dropped ray biases the gradient silently).
        return jnp.mean(err * err), info["dropped"]

    return jax.value_and_grad(loss, has_aux=True)(scene)


@functools.lru_cache(maxsize=16)
def _sharded_grad_fn(cfg: RenderConfig, mesh, backend: str = "jnp",
                     interleave: bool = False, wf_opts: tuple = ()):
    """Compile the distributed gradient.

    The forward render is shard_mapped (pixels block-sharded, scene
    replicated, no collectives); differentiating *through* the shard_map
    makes JAX insert the one collective this framework needs — a psum of the
    scene-parameter cotangents over the pixel axis — which XLA's scheduler
    can overlap with the backward bounce tree.

    backend="wavefront" puts the differentiable wavefront tracer inside the
    shard_map body (each shard renders/differentiates its own pixel window
    via the per-shard offset; large scenes / deep trees); "jnp" uses the
    XLA-autodiff dense tracer.  `wf_opts` is the wavefront tuning dict as a
    sorted item tuple (hashable cache key).

    Every backend's body returns (pixels, drop-count) and the compiled fn
    returns ((loss, total_dropped), grads): the wavefront per-shard drop
    counters ride out of the shard_map and are summed so the caller can
    enforce them (silently dropped rays bias the GRADIENT); the jnp
    backend never drops and ships exact zeros."""

    n = int(mesh.devices.size)
    stride = n if interleave and n > 1 else 1
    if backend == "wavefront":
        from raytpu.kernels.wavefront import render_pixels_wavefront

        per = cfg.num_pixels // n

        def body(scene, gid):
            pix, info = render_pixels_wavefront(
                scene, cfg, offset=gid[0], count=per, ad=True,
                shard_stride=stride, return_info=True, **dict(wf_opts))
            return pix, info["dropped"].reshape(1)

        render = jax.shard_map(body, mesh=mesh,
                               in_specs=(P(), P(PIXEL_AXIS)),
                               out_specs=(P(PIXEL_AXIS), P(PIXEL_AXIS)),
                               check_vma=False)
    else:
        def body(scene, gid):
            # `0 * gid[:1]` keeps the zero device-varying for the jnp
            # path's vma check (same trick as render._sharded_render_fn).
            return (render_pixels(scene, cfg, gid),
                    jnp.zeros((1,), jnp.int32) + 0 * gid[:1])

        render = jax.shard_map(body, mesh=mesh,
                               in_specs=(P(), P(PIXEL_AXIS)),
                               out_specs=(P(PIXEL_AXIS), P(PIXEL_AXIS)))

    def loss(scene, gid, target_flat):
        if interleave and n > 1:
            # The render comes back in shard-major order (shard s's block
            # holds its strided pixels {s + j*n}); permute the TARGET to
            # match — the mean is order-invariant, so the loss and the
            # scene gradients are exactly the block-sharded ones.
            per = cfg.num_pixels // n
            target_flat = (target_flat.reshape(per, n, -1)
                           .transpose(1, 0, 2)
                           .reshape(cfg.num_pixels, -1))
        pix, drops = render(scene, gid)
        err = pix - target_flat
        return jnp.mean(err * err), jnp.sum(drops)

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def loss_and_grad_sharded(scene, cfg: RenderConfig, target_flat, mesh=None,
                          backend: str = "auto", interleave: bool = False,
                          wf_opts: dict | None = None,
                          on_drop: str = "raise",
                          return_info: bool = False):
    """Distributed loss + gradient; scene replicated, pixels sharded.

    The pixel count must divide by the mesh size (pad the target upstream
    if needed).  `backend` resolves through render.resolve_backend with
    train=True: "auto" takes the wavefront on the GPU and XLA autodiff of
    the jnp tracer elsewhere.
    `interleave` gives each device the strided pixel set {shard + j*mesh}
    instead of a contiguous block (the same hot-strip load balancer as
    render_sharded; the loss permutes the target to match, so loss and
    gradients equal the block-sharded ones up to FP reassociation).
    `wf_opts`: wavefront tuning knobs (chunk_rays / capacity_factor)
    for the shard bodies.  Wavefront shards that drop live rays produce a
    BIASED gradient, so the summed per-shard drop counter is enforced:
    `on_drop` defaults to "raise" for training (see
    loss_and_grad_wavefront).  With `return_info`, returns
    (loss, grads, {'dropped': int}).
    """
    from raytpu.render import _report_drops, resolve_backend

    if mesh is None:
        mesh = make_mesh()
    n = int(mesh.devices.size)
    p = cfg.num_pixels
    if p % n:
        raise ValueError(f"{p} pixels not divisible by mesh size {n}")
    backend = resolve_backend(backend, scene, cfg, train=True)
    if interleave and n > 1:
        per = p // n
        i = jnp.arange(p, dtype=jnp.int32)
        gid = i // per + (i % per) * n      # shard s's block: {s + j*n}
    else:
        gid = jnp.arange(p, dtype=jnp.int32)
    (loss, dropped), grads = _sharded_grad_fn(
        cfg, mesh, backend, interleave,
        tuple(sorted((wf_opts or {}).items())))(scene, gid, target_flat)
    nd = _report_drops(dropped, on_drop)
    if return_info:
        return loss, grads, dict(dropped=nd)
    return loss, grads


def fit_scene(scene, cfg: RenderConfig, target_flat, steps: int = 100,
              learning_rate: float = 1e-2, mesh=None, optimizer=None,
              callback=None, trainable=None, backend: str = "auto",
              interleave: bool = False, wf_opts: dict | None = None,
              on_drop: str = "raise"):
    """Gradient-fit task (BASELINE config 4): optimise scene parameters to
    match a target image.  Returns (scene, losses).

    `trainable`: optional pytree with the Scene structure and a bool per
    leaf; gradients of False leaves are zeroed (fit only what you perturb —
    letting adam wander opacity/IOR freely destabilises the render).
    `backend` resolves through render.resolve_backend with train=True:
    "auto" takes the differentiable wavefront on the GPU and XLA autodiff
    of the jnp tracer elsewhere; "jnp" and "wavefront" force a path.  With a mesh, the chosen tracer runs inside the shard_map body
    and the scene cotangents are psum'd; `interleave` balances hot-strip
    load across the mesh (see loss_and_grad_sharded).

    Wavefront drop handling: a capacity overflow during a fit BIASES the
    gradient (the zero-drop frontier moves as the geometry updates), so
    every step's drop counter is enforced.  Without an explicit
    capacity_factor in `wf_opts` the fit runs the auto-capacity ladder
    (render.WF_AUTO_LADDER): tuned-frontier capacity first; a step that
    drops is DISCARDED and re-run at the escalated capacity (stateless,
    so the retry is exact), and the fit stays at that capacity.  Residual
    drops at the top of the ladder go through `on_drop` ("raise" by
    default — a crashed step beats a biased gradient)."""
    import optax

    from raytpu.render import (_report_drops, _warn_escalate,
                               _wf_auto_trials, resolve_backend)

    backend = resolve_backend(backend, scene, cfg, train=True)
    opt = optimizer if optimizer is not None else optax.adam(learning_rate)
    opt_state = opt.init(scene)
    # The auto-capacity ladder applies wherever a wavefront body might
    # run (only wavefront bodies ever report drops, so escalation on the
    # jnp backend simply never triggers).
    trials = _wf_auto_trials(wf_opts)
    cap_i = 0
    losses = []
    for step in range(steps):
        while True:
            cur = trials[cap_i]
            if mesh is not None:
                loss, grads, info = loss_and_grad_sharded(
                    scene, cfg, target_flat, mesh, backend=backend,
                    interleave=interleave, wf_opts=cur,
                    on_drop="ignore", return_info=True)
            elif backend == "wavefront":
                loss, grads, info = loss_and_grad_wavefront(
                    scene, cfg, target_flat, on_drop="ignore",
                    return_info=True, **cur)
            else:
                loss, grads = loss_and_grad(scene, cfg, target_flat)
                info = dict(dropped=0)
            if info["dropped"] == 0:
                break
            if cap_i + 1 == len(trials):
                # Top of the ladder (or explicit capacity): enforce.
                _report_drops(info["dropped"], on_drop)
                break
            _warn_escalate(info["dropped"], cur, trials[cap_i + 1])
            cap_i += 1           # discard the biased step, re-run
        if trainable is not None:
            grads = jax.tree_util.tree_map(
                lambda g, m: g if m else jnp.zeros_like(g), grads, trainable)
        updates, opt_state = opt.update(grads, opt_state, scene)
        scene = optax.apply_updates(scene, updates)
        losses.append(float(loss))
        if callback is not None:
            callback(step, losses[-1], scene)
    return scene, losses


def finite_difference_check(fn, pytree, eps: float = 1e-3, max_coords: int = 4):
    """Central-difference gradient check of scalar `fn` against jax.grad.

    Probes up to `max_coords` coordinates per leaf and returns a list of
    (path, index, analytic, numeric) tuples for the caller to assert on.
    """
    import numpy as np

    grads = jax.grad(fn)(pytree)
    leaves, treedef = jax.tree_util.tree_flatten(pytree)
    glaves = jax.tree_util.tree_leaves(grads)
    out = []
    for li, (leaf, gleaf) in enumerate(zip(leaves, glaves)):
        flat = np.asarray(leaf, np.float64).ravel()
        gflat = np.asarray(gleaf, np.float64).ravel()
        for ci in range(min(flat.size, max_coords)):
            def perturbed(delta):
                f = flat.copy()
                f[ci] += delta
                new_leaves = list(leaves)
                new_leaves[li] = jnp.asarray(
                    f.reshape(np.shape(leaf)), jnp.float32)
                return float(fn(jax.tree_util.tree_unflatten(treedef, new_leaves)))
            numeric = (perturbed(eps) - perturbed(-eps)) / (2 * eps)
            out.append((li, ci, float(gflat[ci]), numeric))
    return out
