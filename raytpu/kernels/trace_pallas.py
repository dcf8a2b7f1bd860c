"""Fused dense forward kernel (Pallas, Triton route): camera -> bounce tree
-> pixel, one ray per lane.

This is the whole per-pixel OpenCL kernel (raytrace_kernel.cl:870-973) plus
the tracer it calls, fused into one GPU kernel:

  * Each program owns a 1-D block of BLOCK pixels; every elementwise op
    below is a (BLOCK,) vector op, one lane per ray.
  * The scene lives in one flat float32 table in global memory (12 x N
    sphere rows, 6 x L light rows, 5 background values); the per-sphere
    loops read it as block-uniform scalars, which stay in L1 — the GPU
    form of the kernel's cooperative __local copy (raytrace_kernel.cl:
    890-907) — and vectorize the reference's per-sphere loop
    (raytracer.h:161-190) over rays.
  * The fixed-depth bounce tree is walked DEPTH-FIRST, the reference GPU
    kernel's own order (an explicit per-ray stack, raytraceStack.h): the
    refracted child is followed at once and the reflected child is pushed
    onto a register stack of `depth` slots.  Live state is therefore
    depth x 14 floats per ray instead of a breadth-first level's 2^depth
    rays, and a subtree whose root is dead on every lane of the block is
    never entered (exact: dead rays carry exactly-zero intensity, so they
    emit and spawn exact zeros).
  * Supersampling: all alias^2 samples run in an in-kernel loop, summed
    into the pixel in registers.

The arithmetic mirrors raytpu.trace's clean semantics with one-ray-per-lane
scalar loops over spheres and lights; tests/test_pallas.py pins
kernel-vs-jnp agreement (allclose with few outliers — the programs are
compiled separately, so near-tangent lanes may flip branches).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from raytpu.config import RenderConfig

# Rays per program (a power of two, as Triton requires) and warps per
# program: one ray per thread keeps the depth-first stack in registers.
BLOCK = 128
NUM_WARPS = 4

# Scene table row layout: [pos_x, pos_y, pos_z, radius, matte_rgb x3,
# gloss_rgb x3, opacity, ior]
_S_PX, _S_PY, _S_PZ, _S_RAD = 0, 1, 2, 3
_S_MR, _S_MG, _S_MB = 4, 5, 6
_S_GR, _S_GG, _S_GB = 7, 8, 9
_S_OP, _S_IOR = 10, 11
SCENE_ROWS = 12
# Light rows: [pos_x, pos_y, pos_z, col_r, col_g, col_b]
LIGHT_ROWS = 6

_EPS_RAY = np.float32(1e-5)
_EPS_CONTAIN = np.float32(1e-6)
_EPS_FRESNEL = np.float32(1e-6)
_MAX_DIST = np.float32(1e3)
_BIG_T = np.float32(1e4)
_MIN_SIG = np.float32(1e-3)
_SHIFT = np.float32(0.01)
_TOL = np.float32(1e-3)

f32 = jnp.float32

# Sphere loops unroll statically up to this count (straight-line code for
# the small scenes the dense kernel serves) and become scf.for loops above
# it, which bounds the kernel's code size at large N.
UNROLL_SPHERES = 4


def _sqrt_pos(x):
    """sqrt(x) clamped at 0."""
    pos = x > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, f32(1.0))), f32(0.0))


def _sphere_loop(n, body, init):
    if n <= UNROLL_SPHERES:
        carry = init
        for i in range(n):
            carry = body(i, carry)
        return carry
    return jax.lax.fori_loop(0, n, body, init)


def _inv2a(a):
    """1 / (2a) with the reference's a==0 guard (raytracer.h:110-118) — the
    divide is per-RAY, not per-sphere, so callers hoist it out of their
    sphere loops and _ray_sphere_t multiplies (1-ulp different from the /
    form; all kernel-vs-jnp contracts are tolerance-based)."""
    return f32(1.0) / jnp.where(a == 0, f32(1.0), f32(2.0) * a)


def _ray_sphere_t(ox, oy, oz, dx, dy, dz, a, inv2a, cx, cy, cz, rad):
    """raySphere (raytracer.h:81-141) for one sphere, vectorized over rays."""
    px = ox - cx
    py = oy - cy
    pz = oz - cz
    b = f32(2.0) * (dx * px + dy * py + dz * pz)
    c = (px * px + py * py + pz * pz) - rad * rad
    radicand = b * b - f32(4.0) * a * c
    has_real = radicand >= 0
    root = _sqrt_pos(radicand)
    u0 = (-b + root) * inv2a
    u1 = (-b - root) * inv2a
    t0 = jnp.where(has_real & (u0 > _EPS_RAY), u0, _BIG_T)
    t1 = jnp.where(has_real & (u1 > _EPS_RAY), u1, _BIG_T)
    t = jnp.minimum(t0, t1)
    return t, t < _BIG_T


def _closest_hit(scene, n_spheres, ox, oy, oz, dx, dy, dz):
    """calcIntersection (raytracer.h:145-194): loop over spheres carrying the
    running minimum plus the winning sphere's fields (strict '<' keeps the
    lowest index on ties, matching the C loop order)."""
    a = dx * dx + dy * dy + dz * dz
    inv2a = _inv2a(a)
    shape = ox.shape
    big = jnp.full(shape, _MAX_DIST)
    zero = jnp.zeros(shape, f32)

    def body(i, carry):
        (min_t, found, cx, cy, cz, mr, mg, mb, gr, gg, gb, op, ior) = carry
        sx, sy, sz = scene[_S_PX, i], scene[_S_PY, i], scene[_S_PZ, i]
        t, ok = _ray_sphere_t(ox, oy, oz, dx, dy, dz, a, inv2a, sx, sy, sz,
                              scene[_S_RAD, i])
        better = ok & (t < min_t)
        sel = lambda new, old: jnp.where(better, new, old)
        return (sel(t, min_t), sel(f32(1.0), found),
                sel(sx, cx), sel(sy, cy), sel(sz, cz),
                sel(scene[_S_MR, i], mr), sel(scene[_S_MG, i], mg),
                sel(scene[_S_MB, i], mb),
                sel(scene[_S_GR, i], gr), sel(scene[_S_GG, i], gg),
                sel(scene[_S_GB, i], gb),
                sel(scene[_S_OP, i], op), sel(scene[_S_IOR, i], ior))

    init = (big, zero, zero, zero, zero,
            zero, zero, zero, zero, zero, zero, zero, zero)
    (min_t, found_m, cx, cy, cz, mr, mg, mb, gr, gg, gb, op, ior) = \
        _sphere_loop(n_spheres, body, init)
    hx = ox + min_t * dx
    hy = oy + min_t * dy
    hz = oz + min_t * dz
    nx, ny, nz = hx - cx, hy - cy, hz - cz
    n2 = nx * nx + ny * ny + nz * nz
    inv = jax.lax.rsqrt(jnp.where(n2 == 0, f32(1.0), n2))
    return dict(t=min_t, found=found_m > 0, hx=hx, hy=hy, hz=hz,
                nx=nx * inv, ny=ny * inv, nz=nz * inv,
                mr=mr, mg=mg, mb=mb, gr=gr, gg=gg, gb=gb, op=op, ior=ior)


def _shadow_blocked(scene, n_spheres, px, py, pz, lx, ly, lz, gap):
    """hasClearLineOfSight (raytracer.h:272-309), inverted: any sphere with a
    root t in (1e-5, 1000) and t^2 < |light - point|^2 blocks.

    Evaluated root-free: with a unit shadow direction and C =
    min(sqrt(gap), 1000), "smallest root > eps lies below C" is exactly
    "the upward parabola q(t) = a t^2 + b t + c has a root in (eps, C)",
    decidable from endpoint signs plus a vertex-in-interval test —
    (q(eps) < 0) XOR (q(C) < 0), or both positive with a real radicand and
    eps < -b/2a < C (division-free as 2a*eps < -b < 2a*C, a > 0).  One
    sqrt per (ray, light) instead of one per (ray, light, sphere); agrees
    with the root form except at ~1-ulp interval boundaries (the same
    measure-zero class as the FMA-contraction noise the kernel-vs-jnp
    tolerances already absorb)."""
    inv = jax.lax.rsqrt(jnp.where(gap == 0, f32(1.0), gap))
    dx, dy, dz = (lx - px) * inv, (ly - py) * inv, (lz - pz) * inv
    a = dx * dx + dy * dy + dz * dz
    cc = jnp.minimum(jnp.sqrt(gap), _MAX_DIST)
    c2 = cc * cc
    two_a_eps = f32(2.0) * a * _EPS_RAY
    two_a_c = f32(2.0) * a * cc

    def body(i, blocked):
        ex = px - scene[_S_PX, i]
        ey = py - scene[_S_PY, i]
        ez = pz - scene[_S_PZ, i]
        rad = scene[_S_RAD, i]
        b = f32(2.0) * (dx * ex + dy * ey + dz * ez)
        c = (ex * ex + ey * ey + ez * ez) - rad * rad
        q_eps = (a * _EPS_RAY + b) * _EPS_RAY + c
        q_c = a * c2 + b * cc + c
        neg_eps = q_eps < 0
        neg_c = q_c < 0
        radicand = b * b - f32(4.0) * a * c
        mb = -b
        vertex_in = (mb > two_a_eps) & (mb < two_a_c)
        hit = (neg_eps != neg_c) | (~neg_eps & ~neg_c & (radicand >= 0)
                                    & vertex_in)
        return jnp.where(hit, f32(1.0), blocked)

    mask = _sphere_loop(n_spheres, body, jnp.zeros(px.shape, f32))
    return mask > 0


def _matte_sum(scene, n_spheres, lights, n_lights, hx, hy, hz, nx, ny, nz):
    """calculateMatte (raytracer.h:313-367): static unroll over lights."""
    sr = jnp.zeros(hx.shape, f32)
    sg = jnp.zeros(hx.shape, f32)
    sb = jnp.zeros(hx.shape, f32)
    for l in range(n_lights):
        lx, ly, lz = lights[0, l], lights[1, l], lights[2, l]
        ex, ey, ez = lx - hx, ly - hy, lz - hz
        gap = ex * ex + ey * ey + ez * ez
        inv = jax.lax.rsqrt(jnp.where(gap == 0, f32(1.0), gap))
        incidence = nx * ex * inv + ny * ey * inv + nz * ez * inv
        blocked = _shadow_blocked(scene, n_spheres, hx, hy, hz, lx, ly, lz,
                                  gap)
        w = jnp.where(~blocked & (incidence > 0),
                      incidence / jnp.where(gap == 0, f32(1.0), gap),
                      f32(0.0))
        sr = sr + w * lights[3, l]
        sg = sg + w * lights[4, l]
        sb = sb + w * lights[5, l]
    return sr, sg, sb


def _primary_container(scene, n_spheres, px, py, pz):
    """primaryContainer (raytracer.h:245-270): first containing sphere's
    medium fields (matte rgb, ior, opacity) or the background's."""

    def body(i, carry):
        got, mr, mg, mb, ior, op = carry
        ex = px - scene[_S_PX, i]
        ey = py - scene[_S_PY, i]
        ez = pz - scene[_S_PZ, i]
        r = scene[_S_RAD, i] + _EPS_CONTAIN
        inside = (ex * ex + ey * ey + ez * ez <= r * r) & (got == 0)
        sel = lambda new, old: jnp.where(inside, new, old)
        return (sel(f32(1.0), got),
                sel(scene[_S_MR, i], mr), sel(scene[_S_MG, i], mg),
                sel(scene[_S_MB, i], mb), sel(scene[_S_IOR, i], ior),
                sel(scene[_S_OP, i], op))

    shape = px.shape
    zero = jnp.zeros(shape, f32)
    init = (zero, zero, zero, zero, jnp.ones(shape, f32), zero)
    got, mr, mg, mb, ior, op = _sphere_loop(n_spheres, body, init)
    return got > 0, mr, mg, mb, ior, op


def _fresnel(n1, n2, c1, c2):
    """polarisedReflection (raytracer.h:370-403), float32."""
    left = n1 * c1
    right = n2 * c2
    num = left - right
    den2 = (left + right) * (left + right)
    refl = jnp.minimum(
        num * num / jnp.where(den2 < _EPS_FRESNEL, f32(1.0), den2), f32(1.0))
    return jnp.where(den2 < _EPS_FRESNEL, f32(1.0), refl)


def _trace_level(scene, n_spheres, lights, n_lights, bg, state, spawn):
    """One bounce level on SoA ray state; mirrors raytpu.trace._trace_level
    (see its docstring for the reference-semantics map).  `scene`/`lights`
    are [row, i]-indexable tables, `bg` a dict of background-medium
    scalars.  Returns ((er, eg, eb), (refraction_child, reflection_child))
    — children None unless `spawn`."""
    (ox, oy, oz, dx, dy, dz, ir, ig, ib, mmr, mmg, mmb, mior, mop) = state
    hit = _closest_hit(scene, n_spheres, ox, oy, oz, dx, dy, dz)
    sig = (ir >= _MIN_SIG) | (ig >= _MIN_SIG) | (ib >= _MIN_SIG)
    live = hit["found"] & sig

    opacity = hit["op"]
    transparency = f32(1.0) - opacity

    miss = ~hit["found"]
    er = jnp.where(miss, ir * mmr, f32(0.0))
    eg = jnp.where(miss, ig * mmg, f32(0.0))
    eb = jnp.where(miss, ib * mmb, f32(0.0))
    mgate = live & (opacity > 0)
    sr, sg, sb = _matte_sum(scene, n_spheres, lights, n_lights,
                            hit["hx"], hit["hy"], hit["hz"],
                            hit["nx"], hit["ny"], hit["nz"])
    er = er + jnp.where(mgate, opacity * ir * hit["mr"] * sr, f32(0.0))
    eg = eg + jnp.where(mgate, opacity * ig * hit["mg"] * sg, f32(0.0))
    eb = eb + jnp.where(mgate, opacity * ib * hit["mb"] * sb, f32(0.0))
    emissions = (er, eg, eb)

    if not spawn:
        return emissions, None

    nx, ny, nz = hit["nx"], hit["ny"], hit["nz"]
    hx, hy, hz = hit["hx"], hit["hy"], hit["hz"]

    # --- Refraction (calculateRefraction, raytracer.h:642-815) ---
    dot_dn = dx * nx + dy * ny + dz * nz
    cos1 = jnp.where(dot_dn < f32(-1.0), f32(-1.0),
                     jnp.where(dot_dn > f32(1.0), f32(1.0), dot_dn))
    sin1 = _sqrt_pos(f32(1.0) - cos1 * cos1)
    probe_x = hx + _SHIFT * dx
    probe_y = hy + _SHIFT * dy
    probe_z = hz + _SHIFT * dz
    t_in, tmr, tmg, tmb, tior, top = _primary_container(
        scene, n_spheres, probe_x, probe_y, probe_z)
    tior_bg = jnp.where(t_in, tior, bg["ior"])
    tmop = jnp.where(t_in, top, bg["opacity"])
    tmmr = jnp.where(t_in, tmr, bg["matte_r"])
    tmmg = jnp.where(t_in, tmg, bg["matte_g"])
    tmmb = jnp.where(t_in, tmb, bg["matte_b"])

    ratio = mior / jnp.where(tior_bg == 0, f32(1.0), tior_bg)
    sin2 = ratio * sin1
    tir = (sin2 <= f32(-1.0)) | (sin2 >= f32(1.0))

    # solveQuadratic(1, 2 cos1, 1 - 1/ratio^2) with the TOL collapse
    # (algebra.h:22-65); a == 1 so only the radicand branch matters.
    qb = f32(2.0) * cos1
    ratio2 = ratio * ratio
    qc = f32(1.0) - f32(1.0) / jnp.where(ratio2 == 0, f32(1.0), ratio2)
    radicand = qb * qb - f32(4.0) * qc
    rad_zero = jnp.abs(radicand) < _TOL
    root = _sqrt_pos(radicand)
    dbl = -qb * f32(0.5)
    r0 = jnp.where(rad_zero, dbl, (-qb + root) * f32(0.5))
    r1 = jnp.where(rad_zero, dbl, (-qb - root) * f32(0.5))

    c0x, c0y, c0z = dx + r0 * nx, dy + r0 * ny, dz + r0 * nz
    c1x, c1y, c1z = dx + r1 * nx, dy + r1 * ny, dz + r1 * nz
    a0 = dx * c0x + dy * c0y + dz * c0z
    # With a single (collapsed) root, root 1 never competes.
    a1 = jnp.where(rad_zero, -jnp.inf, dx * c1x + dy * c1y + dz * c1z)
    floor = f32(-0.1)
    take0 = a0 > floor
    take1 = a1 > jnp.maximum(a0, floor)
    rdx = jnp.where(take1, c1x, jnp.where(take0, c0x, f32(0.0)))
    rdy = jnp.where(take1, c1y, jnp.where(take0, c0y, f32(0.0)))
    rdz = jnp.where(take1, c1z, jnp.where(take0, c0z, f32(0.0)))

    cos2 = _sqrt_pos(f32(1.0) - sin2 * sin2)
    cos2 = jnp.where(cos1 < 0, -cos2, cos2)
    rs = _fresnel(mior, tior_bg, cos1, cos2)
    rp = _fresnel(mior, tior_bg, cos2, cos1)
    factor = jnp.where(tir, f32(1.0), f32(0.5) * (rs + rp))

    spawn_m = live & (transparency > 0)
    rscale = jnp.where(spawn_m, transparency * (f32(1.0) - factor), f32(0.0))
    r_ir, r_ig, r_ib = rscale * ir, rscale * ig, rscale * ib

    # --- Reflection (stage 1, raytracer.h:552-615) ---
    pr = transparency * factor
    rcr = (pr + mop * hit["gr"]) * ir
    rcg = (pr + mop * hit["gg"]) * ig
    rcb = (pr + mop * hit["gb"]) * ib
    rsig = (rcr >= _MIN_SIG) | (rcg >= _MIN_SIG) | (rcb >= _MIN_SIG)
    ggate = spawn_m & rsig
    g_ir = jnp.where(ggate, rcr, f32(0.0))
    g_ig = jnp.where(ggate, rcg, f32(0.0))
    g_ib = jnp.where(ggate, rcb, f32(0.0))

    perp = f32(2.0) * (dx * nx + dy * ny + dz * nz)
    gx, gy, gz = dx - perp * nx, dy - perp * ny, dz - perp * nz
    g2 = gx * gx + gy * gy + gz * gz
    ginv = jax.lax.rsqrt(jnp.where(g2 == 0, f32(1.0), g2))
    gx, gy, gz = gx * ginv, gy * ginv, gz * ginv
    gox, goy, goz = hx + _SHIFT * gx, hy + _SHIFT * gy, hz + _SHIFT * gz

    refr = (hx, hy, hz, rdx, rdy, rdz, r_ir, r_ig, r_ib,
            tmmr, tmmg, tmmb, tior_bg, tmop)
    refl = (gox, goy, goz, gx, gy, gz, g_ir, g_ig, g_ib,
            mmr, mmg, mmb, mior, mop)
    return emissions, (refr, refl)


def _trace_tree(scene, n_spheres, lights, n_lights, bg, depth, dx, dy, dz):
    """Depth-first walk of one block's bounce tree; returns the un-weighted
    (r, g, b) pixel sums.

    The walk is a while loop over tree nodes in pre-order.  Each step runs
    the node at `level`: an inner node with a live lane runs the full level
    (emission + children), follows its refracted child and pushes its
    reflected child into stack slot `level` (bit `level` of `pending`); a
    leaf runs the emission only; a node dead on every lane is skipped, and
    with it its whole subtree.  After a leaf or a skip the deepest pending
    slot is popped.  `level` and `pending` are block-uniform scalars, so
    every branch is uniform across the block's lanes."""
    zero = jnp.zeros(dx.shape, f32)
    one = jnp.ones(dx.shape, f32)
    state0 = (zero, zero, zero, dx, dy, dz, one, one, one,
              zero + bg["matte_r"], zero + bg["matte_g"],
              zero + bg["matte_b"], zero + bg["ior"], zero + bg["opacity"])
    level_fn = functools.partial(_trace_level, scene, n_spheres, lights,
                                 n_lights, bg)
    if depth == 0:
        em, _ = level_fn(state0, spawn=False)
        return em

    def inner(st):
        em, (refr, refl) = level_fn(st, spawn=True)
        return em, refr, refl

    def leaf(st):
        em, _ = level_fn(st, spawn=False)
        return em, st, st

    def dead(st):
        return (zero, zero, zero), st, st

    def cond(carry):
        return carry[1] >= 0

    def body(carry):
        state, level, pending, stack, acc = carry
        alive = jnp.max(jnp.maximum(state[6],
                                    jnp.maximum(state[7], state[8]))) > 0
        # 0 = inner node, 1 = leaf, 2 = dead (int arithmetic: the Triton
        # lowering mistypes a select between integer constants).
        live_i = alive.astype(jnp.int32)
        branch = (live_i * (level >= depth).astype(jnp.int32)
                  + (1 - live_i) * 2)
        em, refr, refl = jax.lax.switch(branch, (inner, leaf, dead), state)
        acc = tuple(a + e for a, e in zip(acc, em))
        spawned = branch == 0
        # Push: the reflected child waits in slot `level`.
        stack = tuple(
            tuple(jnp.where(spawned & (level == k), r, s)
                  for r, s in zip(refl, slot))
            for k, slot in enumerate(stack))
        pending = jnp.where(spawned, pending | (1 << level), pending)
        # Pop: the deepest pending slot (-1 when the walk is done).
        top = jnp.int32(-1)
        for k in range(depth):
            top = jnp.where((pending >> k) & 1 == 1, k, top)
        popped = stack[0]
        for k in range(1, depth):
            popped = tuple(jnp.where(top == k, s, p)
                           for s, p in zip(stack[k], popped))
        state = tuple(jnp.where(spawned, r, p) for r, p in zip(refr, popped))
        pending = jnp.where(spawned, pending,
                            pending & ~(1 << jnp.maximum(top, 0)))
        level = jnp.where(spawned, level + 1,
                          jnp.where(top >= 0, top + 1, -1))
        return state, level, pending, stack, acc

    stack0 = tuple(tuple(zero for _ in state0) for _ in range(depth))
    carry = (state0, jnp.int32(0), jnp.int32(0), stack0, (zero, zero, zero))
    return jax.lax.while_loop(cond, body, carry)[4]


def _camera_dirs(cfg: RenderConfig, gid, si, sj):
    """Camera model (raytrace_kernel.cl:908-952) for an int32 gid block."""
    alias = cfg.alias_factor
    w, h = cfg.width, cfg.height
    # lax.rem/div (truncating) equal % and // here: every operand is
    # non-negative, and the Triton lowering takes them directly.
    ix = jax.lax.rem(gid, w).astype(f32)
    iy = jax.lax.div(gid, w).astype(f32)
    xstep = f32(cfg.image_world_width / w)
    ystep = f32(cfg.image_world_height / h)
    aspect = f32(cfg.image_world_width / cfg.image_world_height)
    sub = f32(cfg.image_world_width / w / alias)
    px = (ix - f32(w * 0.5)) * xstep
    py = (f32(h * 0.5) - iy) * ystep
    x = (px + sj.astype(f32) * sub) * aspect
    y = py + si.astype(f32) * sub
    z = jnp.full(gid.shape, f32(cfg.zoom))
    inv = jax.lax.rsqrt(x * x + y * y + z * z)
    return x * inv, y * inv, z * inv


class _Table:
    """[row, i] reads of a row-major (rows, n) table stored flat at `base`
    of a 1-D kernel ref; `i` may be a Python int or a traced loop index."""

    def __init__(self, ref, base: int, n: int):
        self.ref, self.base, self.n = ref, base, n

    def __getitem__(self, key):
        row, i = key
        return self.ref[self.base + row * self.n + i]


def _scene_table(scene):
    """The scene as one flat float32 table, padded to a power of two:
    [12 x N sphere rows | 6 x L light rows | 5 background values]."""
    sph = scene.spheres
    rows = [sph.pos[:, 0], sph.pos[:, 1], sph.pos[:, 2], sph.radius,
            sph.matte[:, 0], sph.matte[:, 1], sph.matte[:, 2],
            sph.gloss[:, 0], sph.gloss[:, 1], sph.gloss[:, 2],
            sph.opacity, sph.ior,
            scene.lights.pos[:, 0], scene.lights.pos[:, 1],
            scene.lights.pos[:, 2], scene.lights.col[:, 0],
            scene.lights.col[:, 1], scene.lights.col[:, 2],
            scene.bg.matte, jnp.stack([scene.bg.ior, scene.bg.opacity])]
    flat = jnp.concatenate([jnp.ravel(r).astype(f32) for r in rows])
    size = 1 << max(int(flat.shape[0]) - 1, 1).bit_length()
    return jnp.pad(flat, (0, size - flat.shape[0]))


def _make_kernel(cfg: RenderConfig, n_spheres: int, n_lights: int,
                 stride: int):
    alias = cfg.alias_factor
    total_pixels = cfg.num_pixels
    light_base = SCENE_ROWS * n_spheres
    bg_base = light_base + LIGHT_ROWS * n_lights

    def kernel(tbl_ref, off_ref, out_r, out_g, out_b):
        scene = _Table(tbl_ref, 0, n_spheres)
        lights = _Table(tbl_ref, light_base, n_lights)
        bg = dict(matte_r=tbl_ref[bg_base], matte_g=tbl_ref[bg_base + 1],
                  matte_b=tbl_ref[bg_base + 2], ior=tbl_ref[bg_base + 3],
                  opacity=tbl_ref[bg_base + 4])
        lane = jax.lax.broadcasted_iota(jnp.int32, (BLOCK,), 0)
        # stride > 1: this launch owns the INTERLEAVED pixel set
        # {offset + j*stride} — the per-shard form that balances the
        # frame's hot strips across devices (stride = mesh size, offset =
        # shard id).  Pad lanes past the frame re-render the last pixel.
        gid = off_ref[0] + (pl.program_id(0) * BLOCK + lane) * stride
        gid = jnp.minimum(gid, total_pixels - 1)

        def sample_body(s, acc):
            dx, dy, dz = _camera_dirs(cfg, gid, jax.lax.div(s, alias),
                                      jax.lax.rem(s, alias))
            em = _trace_tree(scene, n_spheres, lights, n_lights, bg,
                             cfg.max_depth, dx, dy, dz)
            return tuple(a + e for a, e in zip(acc, em))

        zero = jnp.zeros((BLOCK,), f32)
        acc = jax.lax.fori_loop(0, alias * alias, sample_body,
                                (zero, zero, zero))
        weight = f32(1.0 / (alias * alias))
        out_r[...] = acc[0] * weight
        out_g[...] = acc[1] * weight
        out_b[...] = acc[2] * weight

    return kernel


@functools.partial(jax.jit,
                   static_argnames=("cfg", "interpret", "count", "stride"))
def render_pixels_pallas(scene, cfg: RenderConfig, interpret: bool = False,
                         offset=0, count: int | None = None,
                         stride: int = 1):
    """Render the `count` pixels {offset + j*stride : j < count} with the
    fused kernel -> (count, 3) colours (stride 1 = a flat block, the
    default full frame).

    Sphere/light counts and every config knob are compile-time constants,
    as in the reference where they are kernel arguments resolved per launch
    (main.cpp:338-350).  `offset` is a traced scalar so a shard_map body
    can render its own pixel shard (count = pixels per device, offset =
    shard base; `stride` = mesh size for the interleaved sharding).
    `interpret` runs the kernel in the Pallas interpreter (for tests on
    the CPU); otherwise it compiles through Triton for the GPU.
    """
    if count is None:
        count = cfg.num_pixels
    n_spheres = scene.spheres.pos.shape[0]
    n_lights = scene.lights.pos.shape[0]
    blocks = -(-count // BLOCK)
    out_spec = pl.BlockSpec((BLOCK,), lambda b: (b,))
    r, g, b = pl.pallas_call(
        _make_kernel(cfg, n_spheres, n_lights, stride),
        grid=(blocks,),
        in_specs=[pl.no_block_spec, pl.no_block_spec],
        out_specs=(out_spec, out_spec, out_spec),
        out_shape=tuple(jax.ShapeDtypeStruct((blocks * BLOCK,), f32)
                        for _ in range(3)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="raytpu_dense_forward",
    )(_scene_table(scene), jnp.asarray(offset, jnp.int32).reshape(1))
    return jnp.stack([r, g, b], axis=-1)[:count]


def render_image_pallas(scene, cfg: RenderConfig, interpret: bool = False):
    """(H, W, 3) frame via the fused kernel."""
    out = render_pixels_pallas(scene, cfg, interpret=interpret)
    return out.reshape(cfg.height, cfg.width, 3)
