"""The fused forward kernel (Pallas, Triton route) vs the jnp tracer, in the
Pallas interpreter on CPU.

The two paths share semantics but not float op order, so edge pixels can
flip discrete branches (closest-hit ties, shadow boundaries, significance
cutoffs).  The contract is allclose-with-few-outliers, same as the
reference's own CPU/GPU relationship (SURVEY.md section 3.3); on-card
agreement is checked by chip_smoke.py.
"""

import numpy as np
import pytest

from raytpu.config import RenderConfig
from raytpu.kernels.trace_pallas import (BLOCK, render_image_pallas,
                                         render_pixels_pallas)
from raytpu.scene import default_scene, random_scene, single_sphere_scene
from raytpu.trace import render_image


def _compare(scene, cfg, frac_tol=0.01, mean_tol=1e-3):
    k = np.asarray(render_image_pallas(scene, cfg, interpret=True))
    j = np.asarray(render_image(scene, cfg))
    assert np.isfinite(k).all()
    scale = max(float(np.abs(j).max()), 1e-12)
    d = np.abs(k - j)
    outliers = (d.max(axis=-1) > 1e-2 * scale).mean()
    assert outliers <= frac_tol, f"outlier fraction {outliers}"
    assert d.mean() < mean_tol * scale, \
        f"mean abs diff {d.mean()} vs scale {scale}"


def test_single_sphere_depth0_exact():
    cfg = RenderConfig(width=64, height=32, max_depth=0, alias_factor=1)
    _compare(single_sphere_scene(), cfg, frac_tol=0.0)


def test_default_scene_depths():
    for depth in (0, 1, 3):
        cfg = RenderConfig(width=64, height=32, max_depth=depth,
                           alias_factor=1)
        _compare(default_scene(), cfg)


def test_default_scene_supersampled():
    cfg = RenderConfig(width=64, height=32, max_depth=2, alias_factor=3)
    _compare(default_scene(), cfg)


def test_nonaligned_pixel_count():
    # 50x17 = 850 pixels: not a multiple of the BLOCK-ray program,
    # exercises the padded tail block.
    cfg = RenderConfig(width=50, height=17, max_depth=1, alias_factor=1)
    _compare(default_scene(), cfg)


def test_many_spheres():
    cfg = RenderConfig(width=64, height=16, max_depth=1, alias_factor=1)
    _compare(random_scene(32, seed=3), cfg)


def test_256_spheres_matches_jnp():
    """BASELINE config-5 sphere count through the kernel's looped sphere
    path, vs the jnp tracer.

    Tolerances are looser than _compare's: a 256-sphere scene at a small
    frame is nearly all silhouette/shadow boundaries, and the kernel and the
    tracer are separately-compiled programs whose FMA-contraction choices
    flip hit/shadow decisions on near-tangent pixels — ~2% of pixels at
    <= 1e-3 absolute.  The mean-error bound still catches any systematic
    large-N defect."""
    cfg = RenderConfig(width=64, height=8, max_depth=1, alias_factor=1)
    scene = random_scene(256, seed=3)
    k = np.asarray(render_image_pallas(scene, cfg, interpret=True))
    j = np.asarray(render_image(scene, cfg))
    assert np.isfinite(k).all()
    scale = max(float(np.abs(j).max()), 1e-12)
    d = np.abs(k - j)
    assert (d.max(axis=-1) > 1e-2 * scale).mean() <= 0.05
    assert d.mean() < 3e-3 * scale, f"mean {d.mean()} vs scale {scale}"


def test_bg_opacity_flows_through():
    cfg = RenderConfig(width=32, height=16, max_depth=2, alias_factor=1)
    a = np.asarray(render_image_pallas(default_scene(0.0), cfg, interpret=True))
    b = np.asarray(render_image_pallas(default_scene(1.0), cfg, interpret=True))
    assert np.abs(a - b).max() > 0  # the UB knob must change glossy pixels


def _scene_of(n):
    if n == 1:
        return single_sphere_scene()
    if n == 3:
        return default_scene()
    return random_scene(n, seed=3)


@pytest.mark.parametrize("n_spheres", [1, 3, 17, 64])
@pytest.mark.parametrize("depth", [0, 2, 5])
def test_depth_first_walk_matches_jnp(depth, n_spheres):
    """The depth-first tree walk (register stack, dead-subtree skip) at
    depth 0 (no walk), 2 and 5, and sphere counts on both sides of the
    unrolled/looped sphere loop (UNROLL_SPHERES), against the jnp tracer's
    breadth-first tree.  The 64-sphere frame is silhouette-heavy and takes
    the large-N tolerance of test_256_spheres_matches_jnp (near-tangent
    flips; the parent revision's kernel measured 1.4% outliers and a
    3e-3 relative mean on the same frames)."""
    cfg = RenderConfig(width=64, height=16, max_depth=depth, alias_factor=1)
    if n_spheres >= 64:
        _compare(_scene_of(n_spheres), cfg, frac_tol=0.05, mean_tol=3e-3)
    else:
        _compare(_scene_of(n_spheres), cfg)


@pytest.mark.parametrize("count", [1, BLOCK - 1, BLOCK + 1, 3 * BLOCK + 5])
def test_ray_counts_not_dividing_the_block(count):
    """Any pixel count: the tail program re-renders the last frame pixel
    on its pad lanes, and the wrapper slices them off."""
    cfg = RenderConfig(width=40, height=12, max_depth=2, alias_factor=2)
    scene = default_scene()
    full = np.asarray(render_pixels_pallas(scene, cfg, interpret=True))
    part = np.asarray(render_pixels_pallas(scene, cfg, interpret=True,
                                           count=count))
    assert part.shape == (count, 3)
    np.testing.assert_array_equal(part, full[:count])


@pytest.mark.parametrize("offset,stride", [(7, 1), (3, 4), (0, 3)])
def test_offset_stride_shard_contract(offset, stride):
    """render_pixels_pallas renders exactly the pixels
    {offset + j*stride : j < count} (the per-shard form of the sharded
    driver), clamping past-the-frame ids to the last pixel."""
    cfg = RenderConfig(width=40, height=12, max_depth=2, alias_factor=1)
    scene = default_scene()
    full = np.asarray(render_pixels_pallas(scene, cfg, interpret=True))
    count = -(-(cfg.num_pixels - offset) // stride)
    part = np.asarray(render_pixels_pallas(scene, cfg, interpret=True,
                                           offset=offset, count=count,
                                           stride=stride))
    ids = np.minimum(offset + np.arange(count) * stride, cfg.num_pixels - 1)
    np.testing.assert_array_equal(part, full[ids])
