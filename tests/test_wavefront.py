"""Wavefront tracer vs the dense jnp tracer.

The wavefront level body IS raytpu.trace._trace_level, but the two paths
are separately compiled programs with different shapes and fusion
contexts, so XLA's FMA-contraction choices may differ and near-threshold
branches (tangent hits, significance cutoffs) can flip with
full-magnitude per-pixel effect.  The contract is therefore the repo's
standard allclose-with-few-outliers (same as test_pallas._compare), plus a
strict zero-drop check.  The drop counter is exercised with a scene
engineered to overflow the per-level capacity.
"""

import numpy as np

import raytpu
from raytpu.config import RenderConfig
from raytpu.kernels.wavefront import render_pixels_wavefront
from raytpu.render import render_single, render_sharded
from raytpu.scene import build_scene, default_scene, make_material, random_scene


def _assert_matches_dense(scene, cfg, frac_tol=0.005, **wf_kw):
    ref = np.asarray(raytpu.render_image(scene, cfg)).reshape(-1, 3)
    out, info = render_pixels_wavefront(scene, cfg, return_info=True,
                                        **wf_kw)
    out = np.asarray(out)
    assert info["dropped"] == 0
    assert np.isfinite(out).all()
    scale = max(ref.max(), 1e-30)
    d = np.abs(out - ref)
    outliers = (d.max(axis=-1) > 1e-3 * scale).mean()
    assert outliers <= frac_tol, f"outlier fraction {outliers}"
    assert d.mean() < 1e-4 * scale, f"mean abs diff {d.mean()} vs {scale}"


def test_wavefront_matches_dense_multichunk():
    # chunk smaller than the frame: exercises the scan over chunks AND the
    # sort-compaction path (children overflow capacity from level 1 on).
    cfg = RenderConfig(width=64, height=48, max_depth=3, alias_factor=2)
    _assert_matches_dense(default_scene(), cfg, chunk_rays=4096,
                          capacity_factor=2)


def test_wavefront_matches_dense_large_n():
    # 24 spheres, depth 4: the per-ray sphere reductions at a deep tree.
    cfg = RenderConfig(width=64, height=48, max_depth=4, alias_factor=1)
    _assert_matches_dense(random_scene(24, num_lights=2), cfg,
                          chunk_rays=4096, capacity_factor=2)


def test_wavefront_single_chunk_no_sort():
    # Whole frame in one chunk with ample capacity and eager_sort off: the
    # no-sort path (bit-identical to an unsorted wavefront).
    cfg = RenderConfig(width=32, height=24, max_depth=2, alias_factor=1)
    _assert_matches_dense(default_scene(), cfg, chunk_rays=1 << 20,
                          capacity_factor=1 << (2 + 1), eager_sort=False)


def test_wavefront_eager_sort_matches_no_sort():
    # eager_sort only reorders rays between levels; emissions are summed
    # per pixel either way, so the two modes agree to float-sum
    # reassociation (the scatter adds in a different order).
    cfg = RenderConfig(width=64, height=48, max_depth=3, alias_factor=1)
    scene = default_scene()
    a = np.asarray(render_pixels_wavefront(scene, cfg, eager_sort=True))
    b = np.asarray(render_pixels_wavefront(scene, cfg, eager_sort=False))
    scale = max(b.max(), 1e-30)
    assert np.abs(a - b).max() < 1e-4 * scale


def test_wavefront_branch_flip_contract():
    # 80x60 at the default alias 3: the resolution where the dense kernel
    # flips ~3 near-threshold pixels against the jnp tracer — pins the
    # wavefront's outlier contract on the same frame.
    cfg = RenderConfig(width=80, height=60, max_depth=2)
    _assert_matches_dense(default_scene(), cfg, chunk_rays=1 << 20)


def test_wavefront_counts_dropped_rays():
    # A frame-filling transparent sphere (it subtends more than the very
    # wide camera frustum: corner-ray tan ~3.06, sphere tan ~7) spawns two
    # live children per camera ray; with capacity_factor=1 the per-level
    # capacity equals the chunk, so half the live children must be dropped
    # — and counted.
    mat = make_material(0.3, (0.2, 0.4, 0.6), (0.9, 0.9, 0.9),
                        opacity=0.0, ior=1.5)
    scene = build_scene(
        sphere_specs=[((0.0, 0.0, -10.0), 9.9, mat)],
        light_specs=[((10.0, 30.0, 10.0), (0.5, 0.5, 0.5))],
    )
    cfg = RenderConfig(width=128, height=64, max_depth=2, alias_factor=1)
    _, info = render_pixels_wavefront(scene, cfg, chunk_rays=256,
                                      capacity_factor=1, return_info=True)
    assert info["dropped"] > 0


def test_render_single_wavefront_backend():
    cfg = RenderConfig(width=32, height=24, max_depth=2, alias_factor=1)
    scene = default_scene()
    img = np.asarray(render_single(scene, cfg, backend="wavefront"))
    ref = np.asarray(render_single(scene, cfg, backend="pallas",
                                   interpret=True))
    assert img.shape == (24, 32, 3)
    scale = max(ref.max(), 1e-30)
    d = np.abs(img - ref)
    assert (d.max(axis=-1) > 1e-3 * scale).mean() <= 0.005
    assert d.mean() < 1e-4 * scale


def test_wavefront_grads_match_dense_kernel():
    # The differentiable wavefront (XLA autodiff through the jnp level
    # bodies + custom VJPs on the sort/scatter glue) must agree with XLA
    # autodiff of the dense jnp tracer — the same level body, so the same
    # gradients up to float reassociation.  Multi-chunk + sort-active +
    # 24 spheres at depth 3.
    import jax.numpy as jnp
    import jax.tree_util as jtu

    from raytpu.grad import loss_and_grad, loss_and_grad_wavefront

    cfg = RenderConfig(width=64, height=48, max_depth=3, alias_factor=1)
    scene = random_scene(24, num_lights=2, seed=5)
    target = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
    lw, gw = loss_and_grad_wavefront(scene, cfg, target, chunk_rays=1024)
    lp, gp = loss_and_grad(scene, cfg, target)
    np.testing.assert_allclose(float(lw), float(lp), rtol=1e-6)
    for (pa, a), (pb, b) in zip(jtu.tree_leaves_with_path(gw),
                                jtu.tree_leaves_with_path(gp)):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-12)
        assert np.abs(a - b).max() <= 2e-3 * scale, jtu.keystr(pa)


def test_auto_backend_crossover(monkeypatch):
    # "auto" on the GPU picks the wavefront once per-ray tree work crosses
    # the N x 2^depth boundary, the dense forward kernel below it; on
    # other platforms it stays jnp.
    import raytpu.render as R
    deep = RenderConfig(width=8, height=8, max_depth=6, alias_factor=1)
    big = random_scene(256)
    assert R.resolve_backend("auto", big, deep) == "jnp"  # on CPU
    monkeypatch.setattr(R.jax, "default_backend", lambda: "gpu")
    assert R.resolve_backend("auto", big, deep) == "wavefront"
    # 3 spheres at depth 6: 192 < 512 — dense territory.
    assert R.resolve_backend("auto", default_scene(), deep) == "pallas"
    shallow = RenderConfig(width=8, height=8, max_depth=2, alias_factor=1)
    # 256 x 4 = 1024: past the crossover.
    assert R.resolve_backend("auto", big, shallow) == "wavefront"
    mid = random_scene(64)
    d4 = RenderConfig(width=8, height=8, max_depth=4, alias_factor=1)
    assert R.resolve_backend("auto", mid, d4) == "wavefront"   # 1024
    assert R.resolve_backend("auto", mid, shallow) == "pallas"  # 256
    assert R.resolve_backend("auto", random_scene(16), d4) == "pallas"
    assert R.resolve_backend("auto") == "pallas"  # no scene info


def test_render_sharded_wavefront_matches_single():
    # Each device runs its own wavefront loop over its pixel window
    # (offset/count), zero collectives; the stitched frame must equal the
    # single-device wavefront render up to boundary branch flips (the
    # shards are separately compiled programs at different shapes).
    cfg = RenderConfig(width=64, height=48, max_depth=2, alias_factor=1)
    scene = default_scene()
    single = np.asarray(render_single(scene, cfg, backend="wavefront"))
    sharded = np.asarray(render_sharded(scene, cfg, backend="wavefront"))
    scale = max(single.max(), 1e-30)
    d = np.abs(sharded - single)
    assert (d.max(axis=-1) > 1e-3 * scale).mean() <= 0.005
    assert d.mean() < 1e-4 * scale


def test_sharded_wavefront_grads_match_single_device():
    # The large-scene distributed training path: the differentiable
    # wavefront inside the shard_map body (per-shard pixel window), scene
    # cotangents psum'd by the shard_map transpose.  Must agree with the
    # single-device wavefront gradients (same kernel family).
    import jax
    import jax.numpy as jnp
    import jax.tree_util as jtu

    from raytpu.grad import (_sharded_grad_fn, loss_and_grad_sharded,
                             loss_and_grad_wavefront)
    from raytpu.parallel.mesh import make_mesh

    # The differentiated wavefront (checkpoint + scan, shard_mapped below)
    # is the heaviest compile in the suite, and XLA:CPU has segfaulted
    # compiling it ONLY with ~100 tests' accumulated jit caches in the
    # process (reproducibly at this position, never in isolation).
    # Dropping the caches first keeps the suite green; the functional
    # behavior is identical.
    jax.clear_caches()
    _sharded_grad_fn.cache_clear()

    cfg = RenderConfig(width=32, height=8, max_depth=2, alias_factor=1)
    scene = random_scene(12, num_lights=2, seed=7)
    target = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
    l1, g1 = loss_and_grad_wavefront(scene, cfg, target)
    mesh = make_mesh(jax.devices()[:4])
    l2, g2 = loss_and_grad_sharded(scene, cfg, target, mesh,
                                   backend="wavefront")
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for (pa, a), (_, b) in zip(jtu.tree_leaves_with_path(g1),
                               jtu.tree_leaves_with_path(g2)):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(float(np.abs(a).max()), 1e-12)
        assert np.abs(a - b).max() <= 2e-3 * scale, jtu.keystr(pa)


def test_interleaved_sharded_wavefront_grads_match_block():
    # The wavefront + interleave training path (shard_stride through the
    # AD scan): loss and scene gradients must match the block sharding —
    # the mean and the psum'd cotangents are order-invariant, so only FP
    # reassociation separates them (ADVICE r4: this path had no test).
    import jax
    import jax.numpy as jnp
    import jax.tree_util as jtu

    from raytpu.grad import _sharded_grad_fn, loss_and_grad_sharded
    from raytpu.parallel.mesh import make_mesh

    jax.clear_caches()
    _sharded_grad_fn.cache_clear()

    cfg = RenderConfig(width=32, height=8, max_depth=2, alias_factor=1)
    scene = random_scene(12, num_lights=2, seed=7)
    target = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
    # A non-flat target so the interleave's target permutation carries
    # real signal (a constant target would hide a permutation bug).
    target = target + jnp.arange(cfg.num_pixels,
                                 dtype=jnp.float32)[:, None] * 1e-6
    mesh = make_mesh(jax.devices()[:4])
    l1, g1 = loss_and_grad_sharded(scene, cfg, target, mesh,
                                   backend="wavefront")
    l2, g2 = loss_and_grad_sharded(scene, cfg, target, mesh,
                                   backend="wavefront", interleave=True)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for (pa, a), (_, b) in zip(jtu.tree_leaves_with_path(g1),
                               jtu.tree_leaves_with_path(g2)):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(float(np.abs(a).max()), 1e-12)
        assert np.abs(a - b).max() <= 2e-3 * scale, jtu.keystr(pa)


def test_segsum_debug_mode_catches_overlong_runs():
    # WF_DEBUG sanitizer (ADVICE r4): a run longer than max_run silently
    # under-reduces without it; with it armed the violation raises.
    import jax
    import jax.numpy as jnp

    import raytpu.kernels.wavefront as wf

    acc = tuple(jnp.zeros((8,), jnp.float32) for _ in range(3))
    ids = np.full(64, 0x3FFFFFFF, np.int32)
    ids[:12] = 2                      # one 12-long run, bound is 4
    em = tuple(jnp.asarray(np.where(ids < 8, 1.0, 0.0), jnp.float32)
               for _ in range(3))
    pid = jnp.asarray(ids)
    old = wf.WF_DEBUG
    wf.WF_DEBUG = True
    try:
        with np.testing.assert_raises(Exception):
            out = wf._segsum_scatter(acc, em, pid, 8, 8, 4)
            jax.block_until_ready(out)
    finally:
        wf.WF_DEBUG = old
    # And a conforming call passes with the sanitizer armed.
    wf.WF_DEBUG = True
    try:
        out = wf._segsum_scatter(acc, em, pid, 8, 8, 16)
        np.testing.assert_allclose(np.asarray(out[0])[2], 12.0, rtol=1e-6)
    finally:
        wf.WF_DEBUG = old


def test_fit_scene_wavefront_backend_converges():
    # fit_scene(backend="wavefront"): the large-scene training loop end to
    # end.  Recover a perturbed matte colour — the
    # same smooth-parameter setup as examples/fit_scene.py, incl. the
    # scale-appropriate adam eps (the linear image is ~1e-4 scale).
    import dataclasses

    import jax
    import jax.numpy as jnp
    import optax

    from raytpu.grad import fit_scene
    from raytpu.trace import render_pixels

    cfg = RenderConfig(width=16, height=8, max_depth=1, alias_factor=1)
    truth = default_scene()
    gid = jnp.arange(cfg.num_pixels, dtype=jnp.int32)
    target = render_pixels(truth, cfg, gid)
    start = dataclasses.replace(
        truth, spheres=dataclasses.replace(
            truth.spheres, matte=truth.spheres.matte * 0.7))
    trainable = jax.tree_util.tree_map(lambda _: False, truth)
    trainable = dataclasses.replace(
        trainable, spheres=dataclasses.replace(trainable.spheres,
                                               matte=True))
    _, losses = fit_scene(start, cfg, target, steps=8,
                          backend="wavefront", trainable=trainable,
                          optimizer=optax.adam(3e-2, eps=1e-16))
    assert losses[-1] < 0.5 * losses[0]


def test_wavefront_black_matte_grads_not_dropped():
    # The segmented scatter skip must gate on ray LIVENESS, not on the
    # emissions being zero: a live ray with black matte emits exact zeros
    # whose cotangent into d(matte) is nonzero (d em/d matte = intensity).
    # With the old emission-magnitude gate this scene lost 99.9% of the
    # matte gradient (bounce levels silently skipped).
    import dataclasses

    import jax.numpy as jnp

    from raytpu.grad import loss_and_grad, loss_and_grad_wavefront

    cfg = RenderConfig(width=64, height=8, max_depth=3, alias_factor=1)
    s = random_scene(24, num_lights=2, seed=5)
    sph = dataclasses.replace(
        s.spheres, matte=jnp.zeros_like(s.spheres.matte),
        opacity=jnp.full_like(s.spheres.opacity, 0.5))
    s = dataclasses.replace(s, spheres=sph)
    target = jnp.ones((cfg.num_pixels, 3), jnp.float32) * 1e-4
    _, gw = loss_and_grad_wavefront(s, cfg, target, chunk_rays=1024)
    _, gp = loss_and_grad(s, cfg, target)
    a, b = np.asarray(gw.spheres.matte), np.asarray(gp.spheres.matte)
    scale = max(float(np.abs(b).max()), 1e-20)
    assert np.abs(a - b).max() <= 1e-3 * scale


def test_scatter_window_matches_plain_scatter():
    """_scatter_window (level 0's dense window-add replacement for the
    scatter) equals acc[pid] += em for pid = (start + i) % npix, for
    chunks smaller and larger than the pixel count and any start."""
    import jax.numpy as jnp

    from raytpu.kernels.wavefront import _scatter_window

    rng = np.random.default_rng(7)
    for npix, chunk, start in ((100, 64, 0), (100, 64, 87), (48, 256, 5),
                               (33, 97, 200)):
        em = tuple(jnp.asarray(rng.standard_normal(chunk), jnp.float32)
                   for _ in range(3))
        acc0 = tuple(jnp.asarray(rng.standard_normal(npix), jnp.float32)
                     for _ in range(3))
        got = _scatter_window(acc0, em, jnp.int32(start), npix)
        pid = (start + np.arange(chunk)) % npix
        for g, a, e in zip(got, acc0, em):
            want = np.asarray(a).copy()
            np.add.at(want, pid, np.asarray(e))
            np.testing.assert_allclose(np.asarray(g), want, rtol=1e-6,
                                       atol=1e-6)


def test_scatter_emissions_prefix_switch_exact():
    """The live-prefix switch scatter equals the full scatter whenever the
    tail past n_live carries exactly-zero emissions (the compaction
    invariant), at every switch granularity including 0 and full."""
    import jax.numpy as jnp

    from raytpu.kernels.wavefront import _SCATTER_SEGS, _scatter_emissions

    rng = np.random.default_rng(8)
    r, npix = 4 * _SCATTER_SEGS * 8, 50
    pid = jnp.asarray(np.sort(rng.integers(0, npix, r)), jnp.int32)
    acc0 = tuple(jnp.asarray(rng.standard_normal(npix), jnp.float32)
                 for _ in range(3))
    for n_live in (0, 1, r // _SCATTER_SEGS - 3, r // 2, r - 1, r):
        em_np = rng.standard_normal((3, r)).astype(np.float32)
        em_np[:, n_live:] = 0.0  # the compaction invariant
        em = tuple(jnp.asarray(e) for e in em_np)
        got = _scatter_emissions(acc0, em, pid, npix, sorted_ids=True,
                                 n_live=jnp.int32(n_live))
        want = _scatter_emissions(acc0, em, pid, npix, sorted_ids=True)
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w))


def test_segsum_scatter_matches_plain_scatter():
    """_segsum_scatter (segmented pre-reduction + short scatter) must equal
    a plain scatter-add for sorted ids with bounded run lengths, including
    a dead tail (id 0x3FFFFFFF, zero values) and fewer live runs than the
    static prefix.  Also pins the backward: d_em[i] = d_acc[pid[i]]."""
    import jax
    import jax.numpy as jnp

    from raytpu.kernels.wavefront import _segsum_scatter

    rng = np.random.default_rng(7)
    r, npix, max_run = 1024, 64, 8
    # Sorted ids with random run lengths in [1, max_run], dead tail.
    ids = []
    p = 0
    while len(ids) < r - 100 and p < npix:
        ids.extend([p] * int(rng.integers(1, max_run + 1)))
        p += int(rng.integers(1, 3))
    ids = ids[: r - 100] + [0x3FFFFFFF] * (r - len(ids[: r - 100]))
    pid = jnp.asarray(np.asarray(ids, np.int32))
    em = tuple(
        jnp.asarray(np.where(np.asarray(ids) < npix,
                             rng.normal(size=r), 0.0).astype(np.float32))
        for _ in range(3))
    acc = tuple(jnp.asarray(rng.normal(size=npix).astype(np.float32))
                for _ in range(3))

    got = _segsum_scatter(acc, em, pid, npix, min(npix, r),
                          max_run)
    safe = jnp.minimum(pid, npix - 1)
    want = tuple(a.at[safe].add(jnp.where(pid < npix, x, 0.0))
                 for a, x in zip(acc, em))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)

    # Backward: linear map, transpose d_em[i] = d_acc[pid[i]] — realized
    # since round 5 as boundary-gather + run backfill (no r-length
    # gather).  LIVE ids must read their channel weight exactly; dead
    # ids are a documented don't-care (identically-zero emissions): the
    # backfill reaches max_run from the dead run's end (where it reads
    # the npix-1 clamp, like the old gather) and leaves the rest zero.
    def f(em_):
        out = _segsum_scatter(acc, em_, pid, npix, min(npix, r), max_run)
        return sum(jnp.sum(o * (i + 1.0)) for i, o in enumerate(out))

    g_em = jax.grad(f)(em)
    dead = np.asarray(ids) >= npix
    for c, g in enumerate(g_em):
        g = np.asarray(g)
        np.testing.assert_allclose(g[~dead], c + 1.0, rtol=1e-6)
        assert np.all((g[dead] == 0.0) | np.isclose(g[dead], c + 1.0))
