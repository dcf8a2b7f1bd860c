"""The tracer: camera model, supersampling, and the fixed-depth bounce loop.

This replaces the reference's per-ray explicit stack machine (rayTrace,
raytracer.h:410-636) with a vectorized *breadth-first ray tree*: every
recursion level is one fully-vectorized batch over all live rays, doubling in
width each level (refraction child + reflection child per hit,
SURVEY.md section 3.2).  Instead of per-lane control flow there are lane
masks; instead of a LIFO "colourSum return register" there is the observation
that the recursion is affine — every node's matte/miss emission adds linearly
into the final pixel, so the tree can be summed level by level.

Termination semantics vs the reference: the reference's depth counter is
buggy (children always get depth 1, raytracer.h:527/:605) so its recursion is
really truncated by (a) silent push-drops on a 5/6-slot stack and (b) the
intensity cutoff.  The clean tracer keeps (b) exactly (isSignificant gates
both contributions and children) and replaces (a) with an explicit
`max_depth`; tests against the strict oracle establish the depth at which the
two agree on the golden scene.

Camera model: __kernel raytrace, raytrace_kernel.cl:908-968.  Pixel (ix, iy)
maps to world position ((ix - W/2)*xstep, (H/2 - iy)*ystep) on a 16x12 world
image plane; supersample (i, j) adds (j*sub*aspect on x, i*sub on y) where
sub = xstep/aliasFactor — the reference's positive-corner-biased pattern that
uses the *x* step for both axes, reproduced as-is.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from raytpu.config import RenderConfig
from raytpu.ops.geometry import closest_hit, normalize
from raytpu.ops.shading import is_significant, matte_light_sum, reflect, refract


def camera_rays(cfg: RenderConfig, sample_i, sample_j, gid=None):
    """Unit direction for pixels `gid` (default: all H*W) of supersample
    (i, j), shape (len(gid), 3).  `sample_i`/`sample_j` are ints or
    per-ray int arrays (the wavefront tracer mixes samples in one batch).

    Mirrors raytrace_kernel.cl:910-952 (see module docstring).  The camera
    sits at the origin with intensity (1,1,1).  Passing an explicit `gid`
    block lets a shard_map caller generate only its own pixel shard on
    device — the multi-chip analogue of the per-work-item gid math.

    The rays are float32, or float64 when JAX runs with x64 enabled (the
    double-precision witness of tools/card_witness.py).
    """
    f = jax.dtypes.canonicalize_dtype(jnp.float64).type
    w = f(cfg.width)
    h = f(cfg.height)
    xstep = f(cfg.image_world_width) / w
    ystep = f(cfg.image_world_height) / h
    aspect = f(cfg.image_world_width) / f(cfg.image_world_height)
    sub = xstep / f(cfg.alias_factor)

    if gid is None:
        gid = jnp.arange(cfg.num_pixels, dtype=jnp.int32)
    ix = (gid % cfg.width).astype(f)
    iy = (gid // cfg.width).astype(f)
    px = (ix - w * f(0.5)) * xstep
    py = (h * f(0.5) - iy) * ystep

    x = (px + jnp.asarray(sample_j, f) * sub) * aspect
    y = py + jnp.asarray(sample_i, f) * sub
    z = jnp.full_like(x, f(cfg.zoom))
    return normalize(jnp.stack([x, y, z], axis=-1))


def _gather_medium(spheres, bg, index):
    """Medium fields for rays whose next medium is sphere `index` (or the
    scene background where index == -1) — the targetMaterial lookup of
    calculateRefraction (raytracer.h:699-707)."""
    safe = jnp.maximum(index, 0)
    inside = (index >= 0)[..., None]
    matte = jnp.where(inside, spheres.matte[safe], bg.matte)
    ior = jnp.where(inside[..., 0], spheres.ior[safe], bg.ior)
    opacity = jnp.where(inside[..., 0], spheres.opacity[safe], bg.opacity)
    return matte, ior, opacity


def _trace_level(scene, origin, direction, intensity, medium, spawn: bool):
    """One bounce level: emissions for every ray in the batch, plus (if
    `spawn`) the refraction+reflection children, concatenated (2B rays).

    `medium` is the index of the sphere each ray travels through (-1 = the
    scene background); its matte/ior/opacity are gathered here, so a ray's
    state is (origin, direction, intensity, medium) and children carry the
    refraction target's index (refracted) or the parent's (reflected).

    Emission semantics (rayTrace stage 0, raytracer.h:454-550):
      miss  -> intensity * medium.matte  (background paint; note the
               reference *assigns* rather than accumulates at miss lanes —
               equivalent here because a missing node emits exactly once)
      hit   -> if the ray is significant and the material is not fully
               transparent: opacity * intensity * matte * sum-over-lights.
    Child semantics (stages 0-1, raytracer.h:494-536 and :552-615): both
    children exist only when transparency > 0; the refracted child carries
    transparency*(1-R)*I into the refraction target's medium; the reflected
    child carries ((transparency*R)*(1,1,1) + medium.opacity*gloss)*I — the
    reference's quirk of scaling the hit object's gloss by the *containing
    medium's* opacity — gated by its own significance test, travelling in the
    parent's medium.  Unspawned children carry exactly-zero intensity, which
    is what lets the wavefront tracer drop them.
    """
    spheres, lights, bg = scene.spheres, scene.lights, scene.bg
    med_matte, med_ior, med_opacity = _gather_medium(spheres, bg, medium)
    hit = closest_hit(origin, direction, spheres)
    sig = is_significant(intensity)
    live = hit.found & sig

    emission = jnp.where(hit.found[..., None], jnp.float32(0.0),
                         intensity * med_matte)

    mat_matte = spheres.matte[hit.index]
    mat_gloss = spheres.gloss[hit.index]
    opacity = spheres.opacity[hit.index]
    transparency = jnp.float32(1.0) - opacity

    light_sum = matte_light_sum(hit.point, hit.normal, spheres, lights)
    matte_gate = (live & (opacity > 0))[..., None]
    emission = emission + jnp.where(
        matte_gate, opacity[..., None] * intensity * mat_matte * light_sum,
        jnp.float32(0.0))

    if not spawn:
        return emission, None

    spawn_mask = live & (transparency > 0)

    # Refraction child (stage 0 push, raytracer.h:494-536).
    r_origin, r_dir, refl_factor, target_idx = refract(
        hit.point, hit.normal, direction, med_ior, spheres, bg)
    r_intensity = jnp.where(
        spawn_mask[..., None],
        (transparency * (jnp.float32(1.0) - refl_factor))[..., None] * intensity,
        jnp.float32(0.0))

    # Reflection child (stage 1, raytracer.h:552-615).
    refl_col = ((transparency * refl_factor)[..., None]
                + med_opacity[..., None] * mat_gloss) * intensity
    refl_gate = spawn_mask & is_significant(refl_col)
    g_origin, g_dir = reflect(direction, hit.normal, hit.point)
    g_intensity = jnp.where(refl_gate[..., None], refl_col, jnp.float32(0.0))

    cat = lambda a, b: jnp.concatenate([a, b], axis=0)
    children = (
        cat(r_origin, g_origin),
        cat(r_dir, g_dir),
        cat(r_intensity, g_intensity),
        cat(target_idx, medium),
    )
    return emission, children


def trace_rays(scene, origin, direction, intensity, max_depth: int):
    """Trace a flat batch of rays to `max_depth` bounce levels; returns the
    per-ray colour, shape (B, 3).  Rays start in the scene's background
    medium (the kernel's mock bgMaterial, raytrace_kernel.cl:939-942)."""
    b = direction.shape[0]
    origin = jnp.broadcast_to(origin, direction.shape).astype(jnp.float32)
    medium = jnp.full((b,), -1, jnp.int32)

    total = jnp.zeros((b, 3), jnp.float32)
    state = (origin, direction, intensity, medium)
    for level in range(max_depth + 1):
        emission, children = _trace_level(scene, *state, spawn=level < max_depth)
        # Sum this level's emissions back onto the original B rays: level d
        # holds 2^d contiguous copies of the B-ray batch.
        total = total + jnp.sum(emission.reshape(-1, b, 3), axis=0)
        state = children
    return total


def _render_gid_chunk(scene, gid, cfg: RenderConfig):
    """Render one chunk of pixel ids: loop the (static) supersample patterns,
    tracing each pattern's rays through the full bounce tree and averaging
    with the reference's 1/aliasFactor^2 weight (raytrace_kernel.cl:945-968)."""
    acc = jnp.zeros((gid.shape[0], 3), jnp.float32)
    origin = jnp.zeros((1, 3), jnp.float32)
    weight = jnp.float32(1.0 / cfg.samples_per_pixel)
    for i in range(cfg.alias_factor):
        for j in range(cfg.alias_factor):
            d = camera_rays(cfg, i, j, gid)
            colour = trace_rays(scene, origin, d, jnp.ones_like(d),
                                cfg.max_depth)
            acc = acc + weight * colour
    return acc


def render_pixels(scene, cfg: RenderConfig, gid):
    """Render an arbitrary flat block of pixel ids -> (B, 3) linear colour.

    Chunks the block with lax.map so the 2^depth ray tree's live memory stays
    bounded; this is also the per-shard body for the multi-chip driver
    (raytpu.render.render_sharded), where `gid` is one device's pixel shard.
    Under reverse-mode AD each chunk is rematerialized (jax.checkpoint), so
    the backward holds one chunk's residuals at a time instead of the whole
    frame's bounce trees.
    """
    b = gid.shape[0]
    chunk = min(cfg.chunk_pixels, b)
    num_chunks = -(-b // chunk)
    pad = num_chunks * chunk - b
    if pad:
        gid = jnp.concatenate([gid, jnp.zeros(pad, gid.dtype)])
    chunk_fn = jax.checkpoint(_render_gid_chunk, static_argnums=(2,))
    out = jax.lax.map(lambda g: chunk_fn(scene, g, cfg),
                      gid.reshape(num_chunks, chunk))
    return out.reshape(-1, 3)[:b]


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_image(scene, cfg: RenderConfig):
    """Render the full frame on one device: (H, W, 3) float32 linear colour.

    Equivalent of the per-pixel kernel + host readback (raytrace_kernel.cl:870
    + main.cpp:460-468).
    """
    gid = jnp.arange(cfg.num_pixels, dtype=jnp.int32)
    out = render_pixels(scene, cfg, gid)
    return out.reshape(cfg.height, cfg.width, 3)
