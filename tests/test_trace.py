import jax
import jax.numpy as jnp
import numpy as np

from raytpu.config import RenderConfig
from raytpu.oracle import render_oracle, trace_oracle
from raytpu.scene import default_scene, single_sphere_scene
from raytpu.trace import camera_rays, render_image, trace_rays


def test_camera_rays_match_oracle_exactly():
    from raytpu.oracle import camera_dirs_oracle
    cfg = RenderConfig(width=32, height=24)
    for i, j in [(0, 0), (1, 2), (2, 1)]:
        ours = np.asarray(camera_rays(cfg, i, j))
        ref = camera_dirs_oracle(cfg, i, j)
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)


def test_depth0_single_sphere_matches_oracle():
    # Opaque matte sphere: no recursion at all, so clean == strict.
    scene = single_sphere_scene()
    cfg = RenderConfig(width=32, height=32, max_depth=0, alias_factor=1)
    d = np.asarray(camera_rays(cfg, 0, 0))
    ours = np.asarray(trace_rays(scene, jnp.zeros((1, 3)), jnp.asarray(d),
                                 jnp.ones((d.shape[0], 3)), 0))
    ref = trace_oracle(scene, np.zeros(3), d)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-8)


def test_default_scene_close_to_strict_oracle():
    # Full scene with reflection/refraction: the clean fixed-depth tracer
    # should agree with the strict stack-machine oracle except on the
    # truncation/TIR quirk lanes (SURVEY.md section 3.2).
    scene = default_scene(bg_opacity=0.0)
    cfg = RenderConfig(width=48, height=36, max_depth=4, alias_factor=1)
    ours = np.asarray(render_image(scene, cfg))
    ref = render_oracle(scene, cfg, cap=5)
    ref = np.where(np.isnan(ref), 0.0, ref)
    denom = np.maximum(np.abs(ref), 1e-6)
    rel = np.abs(ours - ref) / denom
    # At least 97% of channel values within 2% of the strict oracle.
    assert (rel < 0.02).mean() > 0.97, f"agreement {(rel < 0.02).mean()}"


def test_render_image_shape_dtype_finite():
    scene = default_scene()
    cfg = RenderConfig(width=16, height=8, max_depth=2, alias_factor=2,
                       chunk_pixels=64)
    img = jax.block_until_ready(render_image(scene, cfg))
    assert img.shape == (8, 16, 3)
    assert img.dtype == jnp.float32
    assert np.isfinite(np.asarray(img)).all()


def test_render_deterministic():
    scene = default_scene()
    cfg = RenderConfig(width=16, height=8, max_depth=2, alias_factor=1)
    a = np.asarray(render_image(scene, cfg))
    b = np.asarray(render_image(scene, cfg))
    np.testing.assert_array_equal(a, b)


def test_chunking_invariance():
    # chunk_pixels is a memory knob only — values must not change.
    scene = default_scene()
    base = RenderConfig(width=20, height=10, max_depth=2, alias_factor=1,
                        chunk_pixels=200)
    small = RenderConfig(width=20, height=10, max_depth=2, alias_factor=1,
                         chunk_pixels=37)  # forces padding too
    a = np.asarray(render_image(scene, base))
    b = np.asarray(render_image(scene, small))
    np.testing.assert_array_equal(a, b)


def test_opaque_scene_strict_equals_clean():
    # With every sphere opaque there is no recursion at all (transparency
    # gates both children, raytracer.h:494-536), so the strict stack-machine
    # semantics and the clean bounce loop coincide exactly; only float op
    # order separates the implementations.
    from raytpu.scene import build_scene, make_material
    rng = np.random.default_rng(11)
    specs = []
    for _ in range(6):
        pos = rng.uniform(-8, 8, 3)
        pos[2] = -rng.uniform(5, 15)
        mat = make_material(0.0, rng.uniform(0.1, 1.0, 3), (0, 0, 0),
                            opacity=1.0, ior=1.5)
        specs.append((pos, rng.uniform(0.5, 2.5), mat))
    lights = [(rng.uniform(-30, 30, 3), rng.uniform(0.2, 0.8, 3))
              for _ in range(3)]
    scene = build_scene(specs, lights)
    cfg = RenderConfig(width=64, height=48, max_depth=3, alias_factor=1)
    clean = np.asarray(render_image(scene, cfg))
    strict = render_oracle(scene, cfg, cap=5)
    # Different f32 op order can flip discrete shadow/hit decisions on a few
    # boundary pixels; everything else must agree tightly.
    close = np.isclose(clean, strict, rtol=1e-4, atol=1e-9)
    assert close.mean() > 0.99, f"agreement {close.mean()}"


def test_float64_render_under_x64():
    # With x64 enabled, a float64 scene renders in float64 end to end (the
    # camera rays and the quadratic solver included): the precision witness
    # of tools/card_witness.py.  It meets the float32 render under the
    # frame contract of tests/test_pallas.py.
    cfg = RenderConfig(width=32, height=24, max_depth=3, alias_factor=1)
    f32 = np.asarray(render_image(default_scene(), cfg))
    with jax.enable_x64(True):
        s64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     default_scene())
        img = render_image(s64, cfg)
        assert img.dtype == jnp.float64
        assert camera_rays(cfg, 0, 0).dtype == jnp.float64
    img = np.asarray(img)
    scale = np.abs(img).max()
    d = np.abs(f32 - img)
    assert (d.max(axis=-1) > 1e-2 * scale).mean() <= 0.01
    assert d.mean() < 1e-3 * scale
