"""Wavefront tracer: one jnp level body per bounce level + sorted ray
compaction.

The dense tracers trace the whole 2^depth bounce tree per camera ray, so
every ray pays for the *widest* level even when most of the tree is dead —
at BASELINE config 5 (256 spheres, 1920x1080, depth 6) only ~2-5% of
deep-level nodes are live (BASELINE.md "acceleration-structure study").
This module restructures the trace as a *wavefront* (the standard GPU
megakernel -> wavefront split):

  * each bounce level runs the jnp level body (raytpu.trace._trace_level)
    over flat SoA ray-state arrays (position/direction/intensity plus the
    medium as a sphere INDEX — see N_STATE); XLA fuses its per-ray
    reductions over spheres (closest hit, shadow any, container);
  * between levels, an XLA `lax.sort` co-sorts the child state by the key
    (dead << 30) | pixel_id — dead children (whose intensity the level
    body already zeroed *exactly*) sink to the tail, live children are
    grouped by pixel.  Compaction is therefore EXACT: a dropped ray carries
    intensity == 0 and could never have contributed (non-spawned,
    insignificant-reflection, and TIR children are all written as exact
    zeros).  The next level's work is bounded by the capacity, not by
    2^level;
  * each level's emissions fold into a per-pixel accumulator (the
    reference accumulates into a per-work-item colourSum register,
    raytrace_kernel.cl:944-966; with rays re-ordered across pixels the
    accumulator must be pixel-indexed instead).  Chunks enumerate rays
    PIXEL-MAJOR (ray -> (pixel = id // spp, sample = id % spp)), so a
    chunk covers chunk/spp distinct pixels: level 0 accumulates with a
    positional reshape-sum (no scatter), and compacted levels pre-reduce
    each pid's run with a segmented scan and scatter ONE element per
    distinct pixel (`_segsum_scatter`);
  * the frame is processed in fixed-capacity ray chunks under `lax.scan`,
    so live memory is O(capacity), not O(2^depth x rays).

Per-level ray capacity is static (XLA shapes): `capacity_factor` x chunk.
By default every spawn level compacts (`eager_sort`); with eager_sort off,
under-capacity levels skip the sort entirely and are bit-identical to an
unsorted wavefront.  Live rays past capacity are dropped *counted* —
`render_pixels_wavefront(..., return_info=True)` reports the total (live
rays per camera ray stay ~<= 1.2 at depth 6 on the BASELINE scenes
because the intensity cutoff kills children faster than the tree doubles).

Differentiable (`ad=True`): XLA autodiff runs through the level body; the
permutations (compaction, un-striping) and the segmented scatter carry
custom VJPs that apply the inverse permutation with one co-sort instead of
XLA's sort-VJP gathers.

Reference map: the level body is rayTrace's stage machine
(raytracer.h:410-636) — see raytpu.trace._trace_level; the wavefront
orchestration itself has no reference analogue (the OpenCL kernel is a
megakernel).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from raytpu.config import RenderConfig
from raytpu.trace import _trace_level, camera_rays

f32 = jnp.float32

# Flat SoA ray state: position(3) + direction(3) + intensity(3) + medium
# INDEX (f32; -1 = background).  The medium's value fields are gathered
# from the scene at each level, so the inter-level co-sort moves 11
# operands (key + 10 fields) instead of 15.
N_STATE = 10

_DEAD_BIT = np.int32(1 << 30)

# RAYTPU_WF_DEBUG=1 (or flipping this flag before tracing) arms runtime
# precondition checks on the wavefront glue — currently the
# _segsum_scatter max-run bound, whose violation is otherwise SILENT
# emission loss.  Checked at trace time, enforced at run time via
# jax.debug.callback; costs one extra scan over the ids, so it is a
# sanitizer mode, not a production default.
WF_DEBUG = bool(int(os.environ.get("RAYTPU_WF_DEBUG", "0")))


def _check_max_run(observed, bound):
    if int(observed) > int(bound):
        raise ValueError(
            f"_segsum_scatter precondition violated: observed live run "
            f"length {int(observed)} exceeds max_run={int(bound)} — run "
            f"totals would be silently under-reduced (emission lost)")


def _align_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _wf_level(scene, state, spawn: bool):
    """One bounce level over flat SoA rays: the jnp level body
    (raytpu.trace._trace_level) on the stacked (R, 3) views.  Returns
    ((er, eg, eb), children-or-None); children are [refraction rays |
    reflection rays], 2R each field."""
    stack = lambda a: jnp.stack(state[a:a + 3], axis=-1)
    em, ch = _trace_level(scene, stack(0), stack(3), stack(6),
                          state[9].astype(jnp.int32), spawn)
    em = tuple(em[:, c] for c in range(3))
    if not spawn:
        return em, None
    origin, direction, intensity, medium = ch
    children = tuple(a[:, k] for a in (origin, direction, intensity)
                     for k in range(3)) + (medium.astype(f32),)
    return em, children


def _compact(children, pid, cap: int):
    """Sort children by (dead, pixel) and keep the first `cap`.

    Dead rays (intensity exactly zero — see module docstring for why that
    mask is exact) sink to the tail; live rays group by pixel, keeping the
    scatter indices sorted.  Returns (state, pid, n_dropped_live, n_kept).

    The permutation moves every field through the sort itself (an
    11-operand co-sort: key + the 10 state fields), all operands 1-D."""
    ir, ig, ib = children[6], children[7], children[8]
    alive = (ir != 0) | (ig != 0) | (ib != 0)
    key = jnp.where(alive, jnp.int32(0), _DEAD_BIT) | pid
    # The pid needs no payload slot of its own: it IS the key's low 30
    # bits (one fewer sorted operand).
    out = jax.lax.sort((key,) + children, num_keys=1, is_stable=False)
    state = tuple(o[:cap] for o in out[1:1 + N_STATE])
    n_alive = jnp.sum(alive.astype(jnp.int32))
    dropped = jnp.maximum(n_alive - jnp.int32(cap), 0)
    n_kept = jnp.minimum(n_alive, jnp.int32(cap))
    # Dead entries inside the kept prefix: clamp their pid to the last pixel
    # so the kept pid sequence stays sorted for the scatter (their emissions
    # and intensities are exact zeros, so the target pixel is irrelevant).
    kept_key = out[0][:cap]
    kept_alive = kept_key < _DEAD_BIT
    new_pid = jnp.where(kept_alive, kept_key & jnp.int32(0x3FFFFFFF),
                        jnp.int32(0x3FFFFFFF))
    return state, new_pid, dropped, n_kept


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _compact_ad(children, pid, cap: int):
    """_compact for the differentiable wavefront: same primal, but the
    backward applies the INVERSE permutation with one co-sort instead of
    XLA's sort-VJP (per-field gathers).  Semantics: the kept prefix's
    cotangents travel back to the children's original positions;
    dropped/dead-tail children get exact zeros (their primal contribution
    was zero by the compaction-exactness lemma)."""
    return _compact(children, pid, cap)


def _compact_ad_fwd(children, pid, cap: int):
    r2 = children[0].shape[0]
    ir, ig, ib = children[6], children[7], children[8]
    alive = (ir != 0) | (ig != 0) | (ib != 0)
    key = jnp.where(alive, jnp.int32(0), _DEAD_BIT) | pid
    iota = jnp.arange(r2, dtype=jnp.int32)
    out = jax.lax.sort((key,) + children + (iota,), num_keys=1,
                       is_stable=False)
    state = tuple(o[:cap] for o in out[1:1 + N_STATE])
    perm = out[1 + N_STATE]            # sorted position -> original index
    n_alive = jnp.sum(alive.astype(jnp.int32))
    dropped = jnp.maximum(n_alive - jnp.int32(cap), 0)
    n_kept = jnp.minimum(n_alive, jnp.int32(cap))
    kept_key = out[0][:cap]
    kept_alive = kept_key < _DEAD_BIT
    new_pid = jnp.where(kept_alive, kept_key & jnp.int32(0x3FFFFFFF),
                        jnp.int32(0x3FFFFFFF))
    return (state, new_pid, dropped, n_kept), (perm,)


def _compact_ad_bwd(cap: int, res, cts):
    (perm,) = res
    d_state = cts[0]                   # 10 float arrays, length cap
    r2 = perm.shape[0]
    pad = r2 - cap
    padded = tuple(jnp.concatenate([d, jnp.zeros((pad,), d.dtype)])
                   for d in d_state)
    # Route each kept slot's cotangent back to its original child index:
    # co-sort by the forward permutation (all keys distinct, so the
    # unstable sort is still the exact inverse permutation).
    inv = jax.lax.sort((perm,) + padded, num_keys=1, is_stable=False)
    d_children = inv[1:]
    d_pid = np.zeros((r2,), jax.dtypes.float0)
    return d_children, d_pid


_compact_ad.defvjp(_compact_ad_fwd, _compact_ad_bwd)


# Prefix granularity for the compacted-level scatter: the live prefix
# length is rounded up to a multiple of r/_SCATTER_SEGS and only that
# prefix is scattered (lax.switch over the static lengths).
_SCATTER_SEGS = 8


def _scatter_emissions(acc, em, pid, npix: int, sorted_ids: bool,
                       n_live=None):
    """acc[c][pid] += em[c], three 1-D scatter-adds.

    With `n_live` (compacted levels: _compact sinks dead rays to the tail
    and counts the kept live prefix), a lax.switch picks the smallest
    static prefix >= n_live out of _SCATTER_SEGS granularities and
    scatters only that.

    The skip is gated on ray LIVENESS, not on emissions being zero: a
    live ray can emit exact zeros (black matte) while its emission still
    carries a nonzero cotangent into the scene parameters (d em / d matte
    = intensity != 0).  A zero-INTENSITY ray's emission, by the module's
    exactness lemma, is identically zero as a function — every partial is
    where-blocked or intensity-scaled — so the dropped dead tail is
    gradient-exact as well (its cotangent path vanishes with the primal:
    lax.switch routes the unselected branches' cotangents as zeros)."""
    safe = jnp.minimum(pid, jnp.int32(npix - 1))
    r = safe.shape[0]

    def scat_prefix(n):
        if n == 0:
            return lambda a, e: a

        def f(a, e):
            return tuple(
                x.at[safe[:n]].add(y[:n], indices_are_sorted=sorted_ids)
                for x, y in zip(a, e))
        return f

    if n_live is None or r % _SCATTER_SEGS:
        return scat_prefix(r)(acc, em)
    step = r // _SCATTER_SEGS
    idx = jnp.minimum((n_live + step - 1) // step,
                      jnp.int32(_SCATTER_SEGS))
    return jax.lax.switch(idx,
                          [scat_prefix(k * step)
                           for k in range(_SCATTER_SEGS + 1)], acc, em)


def _scatter_window(acc, em, start, npix: int):
    """Emission accumulation for rays i mapping to pixel (start + i) %
    npix — contiguous mod npix — as a dynamic_update_slice into a zero
    extension plus a wrap fold, all dense vector adds.  Exact for
    tail-clamped rays too: their intensity (hence emission) is exactly
    zero, so placing those zeros at the unclamped positions changes
    nothing."""
    chunk = em[0].shape[0]
    s0 = jnp.remainder(jnp.asarray(start, jnp.int32), jnp.int32(npix))
    wraps = chunk // npix + 2
    outs = []
    for a, x in zip(acc, em):
        ext = jnp.zeros((wraps * npix,), jnp.float32)
        ext = jax.lax.dynamic_update_slice(ext, x, (s0,))
        outs.append(a + ext.reshape(wraps, npix).sum(axis=0))
    return tuple(outs)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5))
def _segsum_scatter(acc, em, pid, npix: int, prefix: int, max_run: int = 0):
    """acc[c][pid] += em[c] for PID-SORTED rays, via exact segmented
    pre-reduction: one level's rays cover at most `prefix` distinct pixels
    (pixel-major chunks: chunk // samples_per_pixel), so summing each
    pid-run first and scattering ONE element per run cuts the scattered
    element count ~spp x live-fraction-fold.

    Stages (all 1-D ops):
      1. log2(r) roll/compare/add steps: run-inclusive sums (the run's
         LAST element holds the run total);
      2. boundary mask pid[i] != pid[i+1]; non-boundaries and the dead
         tail (pid 0x3FFFFFFF, exact-zero sums) get sort key 2^30;
      3. one 4-operand co-sort brings the <= `prefix` run totals to a
         sorted prefix;
      4. scatter-add exactly `prefix` elements (clamped key, zero values
         past the live runs — exact).

    Exactness: per-pixel totals equal the plain scatter's up to FP
    reassociation (the run sum is a shifted-adds tree instead of the
    scatter's sequential order — the scatter's own ordering is
    unspecified anyway, and every wavefront contract is tolerance-based).

    Backward: the map em -> acc is linear with transpose d_em[i] =
    d_acc[pid[i]].  The forward saves the <= prefix boundary (key,
    original position) pairs, and the backward gathers d_acc at just
    those, scatters the values onto the run-LAST positions, and BACKFILLS
    each run with the same bounded doubling scan the forward uses (see
    _segsum_scatter_bwd).  Declared via custom_vjp so autodiff never
    differentiates through the sort.

    HARD PRECONDITIONS (callers MUST guarantee; violations are silent):
      * pid is sorted ascending with the dead tail at 0x3FFFFFFF, and no
        live run is longer than `max_run` — longer runs are silently
        under-reduced (emission mass lost).  The wavefront's pixel-major
        descent guarantees spp * 2^level; WF_DEBUG asserts it.
      * dead-tail rays (pid >= npix) must carry emissions that are
        IDENTICALLY-ZERO FUNCTIONS of the scene (not merely zero values):
        the backward's npix-1 clamp hands them d_acc[npix-1] as
        cotangent, which is only correct because their primal emission
        is zero with zero derivative (the wavefront's compaction-
        exactness lemma).  A caller without that invariant gets silently
        wrong gradients for the tail rays."""
    return _segsum_scatter_impl(acc, em, pid, npix, prefix, max_run,
                                need_res=False)[0]


def _segsum_scatter_impl(acc, em, pid, npix: int, prefix: int,
                         max_run: int, need_res: bool = True):
    """Shared primal: returns (updated acc, (bkey, bpos)) where
    bkey/bpos are the compacted boundary keys and their ORIGINAL
    positions (prefix-length) — the backward's seed set (see
    _segsum_scatter_bwd)."""
    r = pid.shape[0]
    bound = min(max_run, r) if max_run > 0 else r
    steps = max(1, (bound - 1).bit_length())
    idx = jnp.arange(r, dtype=jnp.int32)
    if WF_DEBUG and bound < r:
        is_start = (idx == 0) | (pid != jnp.roll(pid, 1))
        last_start = jax.lax.cummax(jnp.where(is_start, idx, 0))
        live = pid < (jnp.int32(1) << 29)
        runlen = jnp.where(live, idx - last_start + 1, 0)
        jax.debug.callback(_check_max_run, jnp.max(runlen),
                           jnp.int32(bound))
    e = list(em)
    for k in range(steps):
        sh = 1 << k
        ok = (pid == jnp.roll(pid, sh)) & (idx >= sh)
        e = [x + jnp.where(ok, jnp.roll(x, sh), f32(0.0)) for x in e]
    last = (pid != jnp.roll(pid, -1)) | (idx == r - 1)
    key = jnp.where(last, pid, jnp.int32(1) << 30)
    bs = tuple(jnp.where(last, x, f32(0.0)) for x in e)
    # Positions ride the boundary compaction as f32 (exact: r < 2^24) —
    # only when the caller is the AD fwd.
    pos = (idx.astype(f32),) if need_res else ()
    srt = jax.lax.sort((key,) + bs + pos, num_keys=1, is_stable=False)
    bkey = srt[0][:prefix]
    kp = jnp.minimum(bkey, jnp.int32(npix - 1))
    vops = srt[1:-1] if need_res else srt[1:]
    res = ((bkey, srt[-1][:prefix].astype(jnp.int32))
           if need_res else None)
    return (tuple(a.at[kp].add(x[:prefix], indices_are_sorted=True)
                  for a, x in zip(acc, vops)), res)


def _segsum_scatter_fwd(acc, em, pid, npix: int, prefix: int,
                        max_run: int = 0):
    out, (bkey, bpos) = _segsum_scatter_impl(acc, em, pid, npix, prefix,
                                             max_run)
    return out, (pid, bkey, bpos)


def _segsum_scatter_bwd(npix: int, prefix: int, max_run: int, res, d_acc):
    """Transpose d_em[i] = d_acc[pid[i]] without an r-length per-field
    gather: d_em is piecewise-constant over pid runs, so gather d_acc at
    just the <= prefix saved boundaries, scatter the values onto the
    run-LAST positions, and backfill each run right-to-left with the same
    bounded doubling scan the forward uses.  Entries whose run was never
    seeded cannot exist under the sortedness precondition (every run's
    last is a boundary in the prefix); non-boundary prefix slots carry
    dead keys (>= 2^30) and are dropped.  Dead-run boundaries (pid
    0x3FFFFFFF) seed d_acc[npix-1] — covered by the
    identically-zero-emissions precondition."""
    pid, bkey, bpos = res
    r = pid.shape[0]
    ok = bkey < (jnp.int32(1) << 30)
    safe_k = jnp.minimum(bkey, jnp.int32(npix - 1))
    pos_safe = jnp.where(ok, bpos, jnp.int32(r))       # OOB -> dropped
    vals = tuple(d[safe_k] for d in d_acc)             # short gathers
    seeded = [jnp.zeros((r,), f32).at[pos_safe].set(v, mode="drop")
              for v in vals]
    has = jnp.zeros((r,), f32).at[pos_safe].set(f32(1.0), mode="drop")
    bound = min(max_run, r) if max_run > 0 else r
    steps = max(1, (bound - 1).bit_length())
    idx = jnp.arange(r, dtype=jnp.int32)
    for k in range(steps):
        sh = 1 << k
        same = (pid == jnp.roll(pid, -sh)) & (idx < r - sh)
        adopt = (has == 0) & same
        seeded = [jnp.where(adopt, jnp.roll(v, -sh), v) for v in seeded]
        has = jnp.where(adopt, jnp.roll(has, -sh), has)
    d_pid = np.zeros(pid.shape, jax.dtypes.float0)
    return d_acc, tuple(seeded), d_pid


_segsum_scatter.defvjp(_segsum_scatter_fwd, _segsum_scatter_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3))
def _unstripe(acc, ws: int, stride: int, npix: int):
    """Slot-space accumulator -> pixel order, once per frame.

    Chunks take STRIDED pixel sets (chunk c owns pixels {c + k*stride}),
    so every chunk sees frame-average liveness instead of a hot
    horizontal strip (BASELINE.md round-4 study: contiguous chunks needed
    capacity 2.0 where striding runs 1.5 drop-free).  Accumulation happens
    in chunk-contiguous SLOT space (slot = c*ws + k, what level 0's
    reshape-sum and the segsum scatter naturally produce); this one
    4-operand co-sort maps slots to pixels (pixel of slot = c + k*stride —
    all distinct, so the unstable sort is the exact permutation), and pad
    slots (pixel >= npix, always zero) sort to the sliced-off tail.

    Backward: the permutation's transpose is the inverse permutation —
    one more co-sort keyed by the forward's destination."""
    nslots = ws * stride
    slot = jnp.arange(nslots, dtype=jnp.int32)
    p = slot // ws + (slot % ws) * stride
    srt = jax.lax.sort((p,) + tuple(acc), num_keys=1, is_stable=False)
    return tuple(x[:npix] for x in srt[1:])


def _unstripe_fwd(acc, ws: int, stride: int, npix: int):
    return _unstripe(acc, ws, stride, npix), None


def _unstripe_bwd(ws: int, stride: int, npix: int, _res, d_out):
    nslots = ws * stride
    pad = nslots - npix
    dp = tuple(jnp.concatenate([d, jnp.zeros((pad,), d.dtype)])
               for d in d_out)
    # d_acc[slot] = d_pixel[p_of_slot]: co-sort the cotangents by the
    # slot each pixel came from (slot of pixel p = (p % stride)*ws +
    # p//stride, all distinct).
    p = jnp.arange(nslots, dtype=jnp.int32)
    slot_of_p = (p % stride) * ws + p // stride
    inv = jax.lax.sort((slot_of_p,) + dp, num_keys=1, is_stable=False)
    return (inv[1:],)


_unstripe.defvjp(_unstripe_fwd, _unstripe_bwd)


@functools.partial(jax.jit, static_argnames=(
    "cfg", "chunk_rays", "capacity_factor", "eager_sort", "count", "ad",
    "shard_stride"))
def _render_wavefront_impl(scene, cfg: RenderConfig, chunk_rays: int,
                           capacity_factor: float, eager_sort: bool,
                           offset=0, count=None, ad: bool = False,
                           shard_stride: int = 1):
    # Pixel window [offset, offset + npix): the full frame by default, or
    # one device's pixel shard (offset may be traced — it is the shard's
    # first global pixel id inside shard_map).  All sorting and
    # accumulation run on window-local pixel ids; only the camera needs
    # the global id.
    npix = cfg.num_pixels if count is None else count
    if npix >= int(_DEAD_BIT):
        raise ValueError("wavefront sort key packs pixel ids into 30 bits")
    spp = cfg.samples_per_pixel
    total = npix * spp
    # PIXEL-MAJOR, STRIDED ray order: chunk c owns pixels {c + k*n_chunks}
    # for k in [0, ws), all spp samples of a pixel adjacent (ray ->
    # (k = id//spp - c*ws, sample = id % spp)).  Pixel-major bounds every
    # level's distinct-accumulator-id count by ws = chunk/spp (the
    # _segsum_scatter prefix), makes level 0's accumulation a plain
    # reshape-sum, and keeps the spp near-identical AA rays together.
    # The STRIDE gives every chunk frame-average liveness (see _unstripe).
    # Accumulation runs on chunk-contiguous SLOT ids (slot = id // spp);
    # _unstripe maps slots to pixels once at the end.  Chunks align to
    # spp so the (ws, spp) reshape divides.
    chunk = _align_up(min(chunk_rays, total), spp)
    ws = chunk // spp
    # int() so a float factor (e.g. 2.0) cannot poison the static slice
    # bounds downstream in _compact.
    cap = max(int(capacity_factor * chunk), 1)
    n_chunks = -(-total // chunk)
    nslots = n_chunks * ws
    if nslots >= int(_DEAD_BIT):
        raise ValueError("wavefront sort key packs slot ids into 30 bits")
    offset = jnp.int32(offset)

    def trace_chunk(carry, start):
        acc, dropped = carry
        c_idx = start // chunk                   # this chunk's stripe
        k = jnp.arange(chunk, dtype=jnp.int32) // spp   # stripe-local
        slot = start // spp + k                  # chunk-contiguous acc id
        gpid = c_idx + k * n_chunks              # window-local pixel id
        # Stripe pixels past the window (k*n_chunks overshoot) carry zero
        # intensity: their emissions are exact zeros wherever their slots
        # land.
        in_range = gpid < npix
        gpid = jnp.minimum(gpid, npix - 1)
        sample = jnp.arange(chunk, dtype=jnp.int32) % spp
        # shard_stride > 1: this call owns the INTERLEAVED frame pixels
        # {offset + j*shard_stride} (offset = shard id, stride = mesh
        # size) — the sharding that balances hot strips across devices.
        # The frame clamp re-renders the last pixel on pad lanes so
        # out-of-frame ids cannot stay live and eat capacity.
        gp = jnp.minimum(offset + gpid * shard_stride,
                         cfg.num_pixels - 1)
        d = camera_rays(cfg, sample // cfg.alias_factor,
                        sample % cfg.alias_factor, gp)
        zero = jnp.zeros((chunk,), f32)
        one = jnp.where(in_range, f32(1.0), f32(0.0))
        # Camera rays start in the background medium: index -1.
        state = (zero, zero, zero, d[:, 0], d[:, 1], d[:, 2], one, one, one,
                 zero + f32(-1.0))

        # slot ids are sorted only when they came out of _compact (the
        # no-sort branch interleaves [refraction | reflection] halves);
        # sorted levels take the segmented-reduction accumulator.
        sid = slot
        sid_sorted = False
        # Every ray of this chunk — at EVERY level — maps to one of the
        # chunk's ws slots [w0, w0+ws), so all levels accumulate into a
        # ws-sized WINDOW and the slot accumulator is touched once per
        # chunk (a window slice-add at the end).
        w0 = start // spp
        accw = None
        for level in range(cfg.max_depth + 1):
            spawn = level < cfg.max_depth
            em, children = _wf_level(scene, state, spawn)
            if level == 0:
                # Camera rays: window slots are positional — the window
                # IS the (ws, spp) reshape-sum.  Out-of-range rays carry
                # exactly-zero emissions.
                accw = tuple(x.reshape(ws, spp).sum(axis=1) for x in em)
            elif sid_sorted:
                # Post-compaction levels: slot-sorted, <= ws distinct
                # live slots — segmented pre-reduction, then a static
                # ws-length scatter (see _segsum_scatter).  Dead rays'
                # window-local ids stay huge (sid 0x3FFFFFFF) and clamp
                # onto zero values — exact.
                accw = _segsum_scatter(accw, em, sid - w0, ws,
                                       min(ws, sid.shape[0]),
                                       spp * 2 ** level)
            else:
                # Unsorted fallback (eager_sort off while children fit
                # capacity): plain scatter, bit-identical to an unsorted
                # wavefront.
                accw = _scatter_emissions(accw, em, sid - w0, ws,
                                          sorted_ids=False)
            if not spawn:
                break
            r = state[0].shape[0]
            sid2 = jnp.concatenate([sid, sid])
            if 2 * r <= cap and not eager_sort:
                state, sid = children, sid2      # fits: no sort, no drops
                sid_sorted = False
            else:
                keep = min(2 * r, cap)
                compact = _compact_ad if ad else _compact
                state, sid, ndrop, _ = compact(children, sid2, keep)
                sid_sorted = True
                dropped = dropped + ndrop
        # Fold the window into the slot accumulator: one ws-slice
        # read-add-write.
        acc = tuple(
            jax.lax.dynamic_update_slice(
                a, jax.lax.dynamic_slice(a, (w0,), (ws,)) + w, (w0,))
            for a, w in zip(acc, accw))
        return (acc, dropped), None

    acc0 = tuple(jnp.zeros((nslots,), jnp.float32) for _ in range(3))
    starts = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    # Under reverse AD the scan would otherwise save every chunk's full
    # per-level residual set; checkpointing the body re-runs each chunk's
    # forward during the backward sweep instead.
    body = jax.checkpoint(trace_chunk) if ad else trace_chunk
    (acc, dropped), _ = jax.lax.scan(body, (acc0, jnp.int32(0)), starts)
    if n_chunks > 1:
        acc = _unstripe(acc, ws, n_chunks, npix)
    else:
        acc = tuple(a[:npix] for a in acc)       # identity stripe
    weight = f32(1.0 / cfg.samples_per_pixel)
    return jnp.stack(acc, axis=-1) * weight, dropped


def render_pixels_wavefront(scene, cfg: RenderConfig,
                            chunk_rays: int = 1 << 18,
                            capacity_factor: float = 2.0,
                            eager_sort: bool = True,
                            return_info: bool = False,
                            offset=0, count=None, ad: bool = False,
                            shard_stride: int = 1):
    """Wavefront render of the `count` frame pixels
    {offset + j*shard_stride : j < count} -> (count, 3) linear colour
    (the full frame by default; `shard_stride` = mesh size + offset =
    shard id is the interleaved per-device form that balances hot strips
    across devices).

    With `ad`, the render is differentiable w.r.t. every scene leaf (XLA
    autodiff through the level bodies, custom VJPs on the permutations) —
    see raytpu.grad.loss_and_grad_wavefront.

    `chunk_rays` bounds live memory (camera rays per scan step).
    `capacity_factor` x chunk_rays is the per-level live-ray capacity;
    shrinking it shrinks every level array and is the other frame-time
    lever.  Since the STRIDED chunk->pixel assignment every chunk sees
    frame-average liveness (not a hot pixel strip), so the zero-drop
    frontier does not depend on chunk size.  Always check `return_info`'s
    counter when tuning — capacity needs are scene-dependent.  2.0 stays
    the default contract.
    `eager_sort` compacts at EVERY spawn level (even when the children fit
    capacity), so each level's work is bounded by the capacity; with it
    off, under-capacity levels skip the sort and are bit-identical to an
    unsorted wavefront.  `offset`/`count` select a pixel window — the
    per-shard form for render_sharded (offset may be a traced scalar;
    count must be static).  With `return_info`, also returns
    {'dropped': <int32 device scalar>} — live rays past capacity; it stays
    a device scalar so the call works under jit/shard_map — int() it
    outside jit before serializing."""
    img, dropped = _render_wavefront_impl(
        scene, cfg, chunk_rays=chunk_rays, capacity_factor=capacity_factor,
        eager_sort=eager_sort, offset=offset, count=count, ad=ad,
        shard_stride=shard_stride)
    if return_info:
        return img, dict(dropped=dropped)
    return img


def render_image_wavefront(scene, cfg: RenderConfig, **kw):
    """(H, W, 3) frame via the wavefront tracer."""
    out = render_pixels_wavefront(scene, cfg, **kw)
    if isinstance(out, tuple):
        img, info = out
        return img.reshape(cfg.height, cfg.width, 3), info
    return out.reshape(cfg.height, cfg.width, 3)
