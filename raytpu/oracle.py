"""Strict reference-semantics oracle (numpy, float32, test-only).

This is an independent re-derivation of the reference's rayTrace stack
machine (raytracer.h:410-636) as a *recursion with a stack budget*, used to
validate the JAX tracers against the checked-in golden PPMs.  It reproduces
the reference bit-semantics including its bugs/UB, which the clean JAX path
deliberately fixes:

  * Stack-capacity truncation.  The reference's depth counter never grows
    (children are pushed with the root's depth + 1, raytracer.h:527/:605),
    so recursion actually terminates by silently dropping pushes on a full
    stack (raytraceStack.h:52-58; capacity 6 on CPU, 5 in the GPU kernel).
    Tracing the LIFO execution shows the exact equivalent recursion: a node
    running with `anc` ancestor resume-frames on the stack recurses normally
    while anc <= cap-2; at anc == cap-1 both its child pushes are dropped
    and the "colourSum return register" protocol double-counts the node's
    own partial colour — the node returns 2m, or 4m when its reflection
    colour is significant (m = its matte+miss emission).  anc >= cap is
    unreachable (children only spawn from anc <= cap-2).

  * The stale-colourSum quirk.  A ray that hits something but carries
    insignificant intensity leaves colourSum untouched (raytracer.h:458-460
    guard), so its parent absorbs whatever colourSum held at the child's
    pop — which is the parent's own partial colour.  In recursion form: such
    a child returns `parent_partial`.

  * NaN total-internal-reflection.  The TIR branch (raytracer.h:721-730)
    does not return; execution falls through to cosA2 = sqrt(1 - sinA2^2)
    = NaN, the Fresnel factors and the refracted intensity become NaN, and
    isSignificant(NaN) = false then prunes children; a NaN-intensity miss
    paints NaN*black = NaN into the pixel.  numpy reproduces all of this
    natively; this module is deliberately not NaN-safe.

  * Uninitialised background opacity.  Every bgMaterial in the reference
    (main.cpp:421-425 CPU, raytrace_kernel.cl:939-942 GPU,
    raytracer.h:694-697 inside calculateRefraction) sets matte/gloss/ior but
    never opacity, which is then read when scaling glossy reflections
    (raytracer.h:572-574).  It is a caller-provided parameter here; golden
    tests establish the value the reference binaries actually saw.

Float32 discipline: every operation follows the C operation order and width
(including the CPU build's double-precision Fresnel intermediates,
raytracer.h:380-384), so this oracle models the *CPU* golden.  numpy scalars
and arrays are kept float32 throughout; Python floats only ever appear as
weak scalars that do not promote.
"""

from __future__ import annotations

import numpy as np

F = np.float32
D = np.float64

K_RAY_EPS = F(1e-5)          # raytracer.h:86
K_MAX_RENDER_DIST = F(1e3)   # raytracer.h:156
K_SMALLEST_T = F(1e4)        # raytracer.h:119
K_CONTAIN_EPS = F(1e-6)      # raytracer.h:252
K_FRESNEL_EPS = F(1e-6)      # raytracer.h:376
K_MIN_INTENSITY = F(1e-3)    # raytracer.h:236
K_SMALL_SHIFT = F(0.01)      # raytracer.h:688, :831
TOL = F(1e-3)                # algebra.h:10
CPU_STACK_CAP = 6            # raytraceStack.h:10
GPU_STACK_CAP = 5            # raytrace_kernel.cl:58


class OracleScene:
    """Plain-numpy SoA copy of a raytpu.scene.Scene."""

    def __init__(self, scene, bg_opacity=None, fresnel_double=True):
        # fresnel_double: CPU builds widen the Fresnel intermediates to
        # double (raytracer.h:380-384); the GPU kernel stays float
        # (raytrace_kernel.cl:409-410).
        self.fresnel_double = fresnel_double
        sp = scene.spheres
        self.pos = np.asarray(sp.pos, F)
        self.radius = np.asarray(sp.radius, F)
        self.matte = np.asarray(sp.matte, F)
        self.gloss = np.asarray(sp.gloss, F)
        self.opacity = np.asarray(sp.opacity, F)
        self.ior = np.asarray(sp.ior, F)
        self.lpos = np.asarray(scene.lights.pos, F)
        self.lcol = np.asarray(scene.lights.col, F)
        self.bg_matte = np.asarray(scene.bg.matte, F)
        self.bg_ior = F(np.asarray(scene.bg.ior))
        self.bg_opacity = F(bg_opacity if bg_opacity is not None
                            else np.asarray(scene.bg.opacity))

    @property
    def count(self):
        return self.pos.shape[0]


def _dot(ax, ay, az, bx, by, bz):
    """vdot (vec.h:40): left-to-right float32 sum."""
    return (ax * bx + ay * by) + az * bz


def _significant(c):
    """isSignificant (raytracer.h:235-241); NaN channels compare false."""
    with np.errstate(invalid="ignore"):
        return (c[..., 0] >= K_MIN_INTENSITY) | (c[..., 1] >= K_MIN_INTENSITY) \
            | (c[..., 2] >= K_MIN_INTENSITY)


def _ray_sphere(o, d, centre, radius):
    """raySphere (raytracer.h:81-141) for one sphere over all lanes."""
    dispx = o[:, 0] - centre[0]
    dispy = o[:, 1] - centre[1]
    dispz = o[:, 2] - centre[2]
    a = _dot(d[:, 0], d[:, 1], d[:, 2], d[:, 0], d[:, 1], d[:, 2])
    b = F(2.0) * _dot(d[:, 0], d[:, 1], d[:, 2], dispx, dispy, dispz)
    c = _dot(dispx, dispy, dispz, dispx, dispy, dispz) - radius * radius
    rad = b * b - F(4.0) * a * c
    with np.errstate(invalid="ignore", divide="ignore"):
        root = np.sqrt(np.where(rad >= 0, rad, F(0.0)))
        denom = F(2.0) * a
        u0 = (-b + root) / denom
        u1 = (-b - root) / denom
        t = np.full_like(a, K_SMALLEST_T)
        ok0 = (rad >= 0) & (u0 > K_RAY_EPS) & (u0 < t)
        t = np.where(ok0, u0, t)
        ok1 = (rad >= 0) & (u1 > K_RAY_EPS) & (u1 < t)
        t = np.where(ok1, u1, t)
    return t, ok0 | ok1


def _calc_intersection(o, d, sc):
    """calcIntersection (raytracer.h:145-194): running strict-< minimum over
    spheres in index order, starting at kMaxRenderDist."""
    n = o.shape[0]
    min_t = np.full(n, K_MAX_RENDER_DIST, F)
    idx = np.full(n, -1, np.int32)
    found = np.zeros(n, bool)
    for i in range(sc.count):
        t, ok = _ray_sphere(o, d, sc.pos[i], sc.radius[i])
        better = ok & (t < min_t)
        min_t = np.where(better, t, min_t)
        idx = np.where(better, np.int32(i), idx)
        found |= better
    safe = np.maximum(idx, 0)
    point = o + min_t[:, None] * d
    centre = sc.pos[safe]
    nrm = point - centre
    with np.errstate(invalid="ignore", divide="ignore"):
        inv_len = F(1.0) / np.sqrt(_dot(nrm[:, 0], nrm[:, 1], nrm[:, 2],
                                        nrm[:, 0], nrm[:, 1], nrm[:, 2]))
    nrm = inv_len[:, None] * nrm
    dist = min_t[:, None] * d
    sq = _dot(dist[:, 0], dist[:, 1], dist[:, 2],
              dist[:, 0], dist[:, 1], dist[:, 2])
    return found, min_t, point, nrm, sq, safe


def _clear_line_of_sight(a, b, sc):
    """hasClearLineOfSight (raytracer.h:272-309)."""
    dirv = b - a
    gap = _dot(dirv[:, 0], dirv[:, 1], dirv[:, 2],
               dirv[:, 0], dirv[:, 1], dirv[:, 2])
    with np.errstate(invalid="ignore", divide="ignore"):
        inv = F(1.0) / np.sqrt(gap)
    ray_d = inv[:, None] * dirv
    found, _, _, _, sq, _ = _calc_intersection(a, ray_d, sc)
    return ~(found & (sq < gap))


def _calculate_matte(point, normal, sc):
    """calculateMatte (raytracer.h:313-367)."""
    total = np.zeros_like(point)
    for i in range(sc.lpos.shape[0]):
        lp = np.broadcast_to(sc.lpos[i], point.shape)
        clear = _clear_line_of_sight(point, lp, sc)
        dist = lp - point
        mag2 = _dot(dist[:, 0], dist[:, 1], dist[:, 2],
                    dist[:, 0], dist[:, 1], dist[:, 2])
        with np.errstate(invalid="ignore", divide="ignore"):
            inv = F(1.0) / np.sqrt(mag2)
        ldir = inv[:, None] * dist
        incidence = _dot(normal[:, 0], normal[:, 1], normal[:, 2],
                         ldir[:, 0], ldir[:, 1], ldir[:, 2])
        with np.errstate(invalid="ignore", divide="ignore"):
            intensity = incidence / mag2
        take = clear & (incidence > 0)
        total = total + np.where(take[:, None], intensity[:, None] * sc.lcol[i],
                                 F(0.0))
    return total


def _polarised_reflection(n1, n2, cos1, cos2, double_prec=True):
    """polarisedReflection (raytracer.h:370-403).  CPU builds widen the
    numerator/denominator to double mid-expression; the GPU kernel
    (raytrace_kernel.cl:399-432) stays in float throughout."""
    wide = D if double_prec else F
    left = n1 * cos1
    right = n2 * cos2
    num = (left - right).astype(wide)
    den = (left + right).astype(wide)
    den = den * den
    with np.errstate(invalid="ignore", divide="ignore"):
        refl = ((num * num) / den).astype(F)
    refl = np.where(refl > F(1.0), F(1.0), refl)
    return np.where(den < K_FRESNEL_EPS, F(1.0), refl)


def _primary_container(pt, sc):
    """primaryContainer (raytracer.h:245-270): first containing sphere."""
    idx = np.full(pt.shape[0], -1, np.int32)
    for i in range(sc.count):
        r = sc.radius[i] + K_CONTAIN_EPS
        dist = pt - sc.pos[i]
        inside = _dot(dist[:, 0], dist[:, 1], dist[:, 2],
                      dist[:, 0], dist[:, 1], dist[:, 2]) <= r * r
        idx = np.where(inside & (idx == -1), np.int32(i), idx)
    return idx


def _solve_quadratic(b, c):
    """solveQuadratic (algebra.h:22-65) specialised to a == 1 (its only
    in-tracer call site, raytracer.h:735-739): returns (roots[2], nroots).
    A negative non-"zero" radicand yields NaN roots, exactly like the C
    sqrt."""
    rad = b * b - F(4.0) * c
    rad_zero = np.abs(rad) < TOL
    with np.errstate(invalid="ignore"):
        root = np.sqrt(rad)
    dbl = -b / F(2.0)
    r0 = np.where(rad_zero, dbl, (-b + root) / F(2.0))
    r1 = np.where(rad_zero, dbl, (-b - root) / F(2.0))
    nroots = np.where(rad_zero, np.int32(1), np.int32(2))
    return np.stack([r0, r1], axis=-1), nroots


def _calculate_refraction(point, normal, d, intensity, med_ior, sc):
    """calculateRefraction (raytracer.h:642-815).  Returns
    (origin, dir, child_intensity, target_matte, target_ior, target_opacity,
    reflection_factor) — the factor is NaN under TIR, as in the C code where
    the fall-through overwrites the intended 1.0 (raytracer.h:726 vs :798)."""
    cos1_raw = _dot(d[:, 0], d[:, 1], d[:, 2],
                    normal[:, 0], normal[:, 1], normal[:, 2])
    cos1 = np.clip(cos1_raw, F(-1.0), F(1.0))
    clamped = (cos1_raw <= F(-1.0)) | (cos1_raw >= F(1.0))
    # C: sqrt(1.0 - (cosA1*cosA1)) — float product, double subtract/sqrt,
    # float assignment (raytracer.h:683).
    sin1 = np.sqrt(D(1.0) - (cos1 * cos1).astype(D)).astype(F)
    sin1 = np.where(clamped, F(0.0), sin1)

    probe = K_SMALL_SHIFT[()] * d + point
    cont = _primary_container(probe, sc)
    safe = np.maximum(cont, 0)
    inside = cont >= 0
    t_matte = np.where(inside[:, None], sc.matte[safe], F(0.0))
    t_ior = np.where(inside, sc.ior[safe], F(1.0))
    t_opacity = np.where(inside, sc.opacity[safe], sc.bg_opacity)

    ratio = med_ior / t_ior
    sin2 = ratio * sin1

    roots, nroots = _solve_quadratic(F(2.0) * cos1, F(1.0) - F(1.0) / (ratio * ratio))

    # Root choice: strict '>' against maxAlignment initialised to -0.1;
    # direction stays (0,0,0) if no root qualifies (raytracer.h:750-771).
    max_align = np.full_like(cos1, F(-0.1))
    refr_dir = np.zeros_like(d)
    for i in range(2):
        cand = d + roots[:, i : i + 1] * normal
        align = _dot(d[:, 0], d[:, 1], d[:, 2],
                     cand[:, 0], cand[:, 1], cand[:, 2])
        with np.errstate(invalid="ignore"):
            take = (align > max_align) & (nroots > i)
        max_align = np.where(take, align, max_align)
        refr_dir = np.where(take[:, None], cand, refr_dir)

    with np.errstate(invalid="ignore"):
        cos2 = np.sqrt(F(1.0) - sin2 * sin2)  # NaN under TIR, like the C sqrt
    cos2 = np.where(cos1 < 0, -cos2, cos2)

    rs = _polarised_reflection(med_ior, t_ior, cos1, cos2, sc.fresnel_double)
    rp = _polarised_reflection(med_ior, t_ior, cos2, cos1, sc.fresnel_double)
    factor = ((rs + rp).astype(D) * D(0.5)).astype(F)  # raytracer.h:798

    child_i = (F(1.0) - factor)[:, None] * intensity
    return point, refr_dir, child_i, t_matte, t_ior, t_opacity, factor


def _calculate_reflection(point, normal, d):
    """calculateReflection (raytracer.h:817-842)."""
    perp = F(2.0) * _dot(d[:, 0], d[:, 1], d[:, 2],
                         normal[:, 0], normal[:, 1], normal[:, 2])
    rd = d - perp[:, None] * normal
    with np.errstate(invalid="ignore", divide="ignore"):
        inv = F(1.0) / np.sqrt(_dot(rd[:, 0], rd[:, 1], rd[:, 2],
                                    rd[:, 0], rd[:, 1], rd[:, 2]))
        rd = inv[:, None] * rd
    origin = point + K_SMALL_SHIFT[()] * rd
    return origin, rd


def _trace(o, d, intensity, med_matte, med_ior, med_opacity, anc,
           parent_partial, sc, cap):
    """The stack machine as recursion-with-budget (see module docstring)."""
    found, _, point, normal, sq, idx = _calc_intersection(o, d, sc)
    sig = _significant(intensity)

    mat_matte = sc.matte[idx]
    mat_gloss = sc.gloss[idx]
    opacity = sc.opacity[idx]
    transparency = F(1.0) - opacity

    # Stage-0 emission (raytracer.h:463-484): colour starts at (0,0,0) for
    # every frame; opaque part adds opacity * I * matte * light-sum.
    calc = intensity * mat_matte
    calc = opacity[:, None] * calc
    calc = _calculate_matte(point, normal, sc) * calc
    m = np.where((found & sig & (opacity > 0))[:, None], calc, F(0.0))

    # Refraction (stage 0, raytracer.h:494-536): the incident ray passed in
    # carries transparency * I.
    refr_in_i = transparency[:, None] * intensity
    (r_o, r_d, r_i, tm, ti, to, factor) = _calculate_refraction(
        point, normal, d, refr_in_i, med_ior, sc)

    # Reflection colour (stage 1, raytracer.h:563-578).
    prod = transparency * factor
    refl_col = prod[:, None] * np.ones_like(intensity)
    refl_col = refl_col + med_opacity[:, None] * mat_gloss
    refl_col = intensity * refl_col
    refl_sig = _significant(refl_col)

    spawn = found & sig & (transparency > 0)

    if anc <= cap - 2:
        r1 = _trace(r_o, r_d, r_i, tm, ti, to, anc + 1, m, sc, cap)
        c = m + r1
        g_o, g_d = _calculate_reflection(point, normal, d)
        r2 = _trace(g_o, g_d, refl_col, med_matte, med_ior, med_opacity,
                    anc + 1, c, sc, cap)
        full = np.where(refl_sig[:, None], c + r2, c)
    else:
        # anc == cap-1: both pushes dropped; the colourSum protocol
        # double-counts m at stage 1 and again at stage 2 if the reflection
        # colour is significant.
        two_m = m + m
        full = np.where(refl_sig[:, None], two_m + two_m, two_m)

    miss_val = intensity * np.broadcast_to(med_matte, intensity.shape)
    out = np.where(
        ~found[:, None], miss_val,
        np.where(~sig[:, None], parent_partial,
                 np.where((transparency > 0)[:, None], full, m)))
    return out


def trace_oracle(scene, origins, dirs, cap=CPU_STACK_CAP, bg_opacity=None,
                 fresnel_double=True):
    """Trace a flat (B, 3) ray batch with strict reference semantics."""
    sc = OracleScene(scene, bg_opacity, fresnel_double)
    b = dirs.shape[0]
    o = np.broadcast_to(np.asarray(origins, F), (b, 3)).copy()
    d = np.asarray(dirs, F)
    intensity = np.ones((b, 3), F)
    med_matte = np.broadcast_to(sc.bg_matte, (b, 3)).copy()
    med_ior = np.full(b, sc.bg_ior, F)
    med_opacity = np.full(b, sc.bg_opacity, F)
    return _trace(o, d, intensity, med_matte, med_ior, med_opacity, 0,
                  np.zeros((b, 3), F), sc, cap)


def camera_dirs_oracle(cfg, sample_i, sample_j):
    """Float32-exact camera directions (raytrace_kernel.cl:908-952 /
    main.cpp:404-447): one (P, 3) array for supersample (i, j)."""
    w, h = np.int32(cfg.width), np.int32(cfg.height)
    xstep = F(cfg.image_world_width) / F(w)
    ystep = F(cfg.image_world_height) / F(h)
    aspect = F(cfg.image_world_width) / F(cfg.image_world_height)
    sub = xstep / F(cfg.alias_factor)
    gid = np.arange(w * h, dtype=np.int64)
    px = ((gid % w).astype(F) - F(w) * F(0.5)) * xstep
    py = (F(h) * F(0.5) - (gid // w).astype(F)) * ystep
    x = (px + F(sample_j) * sub) * aspect
    y = py + F(sample_i) * sub
    z = np.full_like(x, F(cfg.zoom))
    inv = F(1.0) / np.sqrt(_dot(x, y, z, x, y, z))
    return np.stack([x * inv, y * inv, z * inv], axis=-1)


def render_oracle(scene, cfg, cap=CPU_STACK_CAP, bg_opacity=None,
                  fresnel_double=True):
    """Full-frame strict render -> (H, W, 3) float32 linear colour.

    Defaults model the reference CPU build; the configuration that
    reproduces the repo's primary golden `testPPM.ppm` (a GPU render) is
    cap=5, bg_opacity=0.0, fresnel_double=False — established empirically
    (97.9%+ byte-exact, see tests/test_golden.py).
    """
    p = cfg.num_pixels
    acc = np.zeros((p, 3), F)
    weight = F(1.0) / F(cfg.alias_factor * cfg.alias_factor)
    origin = np.zeros(3, F)
    for i in range(cfg.alias_factor):
        for j in range(cfg.alias_factor):
            dirs = camera_dirs_oracle(cfg, i, j)
            col = trace_oracle(scene, origin, dirs, cap, bg_opacity,
                               fresnel_double)
            acc = acc + weight * col
    return acc.reshape(cfg.height, cfg.width, 3)
