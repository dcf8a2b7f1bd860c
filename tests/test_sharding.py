import jax
import numpy as np
import pytest

from raytpu.config import RenderConfig
from raytpu.parallel.mesh import describe_devices, make_mesh
from raytpu.render import render_image, render_sharded, render_timed
from raytpu.scene import default_scene


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8, describe_devices()


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_sharded_matches_single_device(ndev):
    scene = default_scene()
    cfg = RenderConfig(width=40, height=20, max_depth=3, alias_factor=1)
    mesh = make_mesh(jax.devices()[:ndev])
    ours = np.asarray(render_sharded(scene, cfg, mesh))
    ref = np.asarray(render_image(scene, cfg))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-9)


def test_sharded_nondivisible_pixel_count():
    # 17x3 = 51 pixels over 8 devices: padding path.
    scene = default_scene()
    cfg = RenderConfig(width=17, height=3, max_depth=1, alias_factor=1)
    mesh = make_mesh()
    ours = np.asarray(render_sharded(scene, cfg, mesh))
    ref = np.asarray(render_image(scene, cfg))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_pallas_matches_single_device(ndev):
    # The sharded Pallas path (per-shard `offset=gid[0]` wiring and the
    # check_vma=False escape hatch, raytpu/render.py) under the CPU mesh:
    # the kernel runs in the Pallas interpreter, so this exercises the real
    # shard_map + pallas_call composition end to end.
    scene = default_scene()
    cfg = RenderConfig(width=64, height=8, max_depth=2, alias_factor=1)
    mesh = make_mesh(jax.devices()[:ndev])
    ours = np.asarray(render_sharded(scene, cfg, mesh, backend="pallas",
                                     interpret=True))
    ref = np.asarray(render_image(scene, cfg))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)


def test_render_timed_stats():
    scene = default_scene()
    cfg = RenderConfig(width=16, height=8, max_depth=1, alias_factor=1)
    img, stats = render_timed(scene, cfg, warmup=1, iters=2)
    assert img.shape == (8, 16, 3)
    assert stats["primary_rays"] == 16 * 8
    assert stats["mrays_per_s"] > 0


@pytest.mark.parametrize("backend", ["jnp", "pallas", "wavefront"])
def test_interleaved_sharding_matches_block(backend):
    # Interleaved sharding (each device owns the strided pixel set
    # {shard + j*mesh} — the hot-strip load balancer, BASELINE.md round-4
    # shard-balance study) must reassemble to exactly the single-device
    # frame on every backend.  51 pixels over 8 devices also exercises
    # the pad-duplicate slicing under the reshape-transpose reassembly.
    scene = default_scene()
    cfg = RenderConfig(width=17, height=3, max_depth=2, alias_factor=1)
    mesh = make_mesh()
    ours = np.asarray(render_sharded(scene, cfg, mesh, backend=backend,
                                     interleave=True,
                                     interpret=backend == "pallas"))
    ref = np.asarray(render_image(scene, cfg))
    tol = dict(rtol=1e-5, atol=1e-7) if backend != "jnp" else \
        dict(rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(ours, ref, **tol)


def test_interleaved_wavefront_multichunk():
    # Wide frame so each shard's wavefront runs multiple chunks: the
    # shard_stride camera mapping composes with the chunk striping and
    # the slot-space accumulate.  Interleaving re-partitions rays across
    # chunks, so per-pixel sums reassociate (the same noise class as the
    # eager-sort contract, tests/test_wavefront.py) — compare against the
    # block-sharded wavefront with a scale-relative bound.
    scene = default_scene()
    cfg = RenderConfig(width=128, height=16, max_depth=3, alias_factor=1)
    mesh = make_mesh(jax.devices()[:4])
    wf_opts = dict(chunk_rays=256, capacity_factor=2.0)
    ours = np.asarray(render_sharded(scene, cfg, mesh, backend="wavefront",
                                     interleave=True, wf_opts=wf_opts))
    ref = np.asarray(render_sharded(scene, cfg, mesh, backend="wavefront",
                                    interleave=False, wf_opts=wf_opts))
    scale = max(ref.max(), 1e-30)
    assert np.abs(ours - ref).max() < 1e-4 * scale


@pytest.mark.parametrize("interpret", [True, False])
def test_dryrun_multichip(interpret):
    # The multi-device dry run over four virtual devices: the kernel render
    # runs in the interpreter only when asked; otherwise "auto" resolves to
    # the jnp tracer on the CPU (and to the compiled kernel on a GPU mesh).
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(4, interpret=interpret)
