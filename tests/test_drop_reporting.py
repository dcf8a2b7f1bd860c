"""The wavefront drop counter is surfaced on every user path.

Round 3 shipped a tuning (256K chunks x capacity 1.5) that silently lost
0.56% of live rays — only bench.py's counter caught it (BASELINE.md
working-set study).  These tests pin the fix: render_single/render_sharded
warn (or raise) on dropped live rays, render_timed stats and the CLI
--time JSON always carry `dropped`, and `--strict-drops` turns a lossy
render into a nonzero exit.
"""

import json

import numpy as np
import pytest

from raytpu.cli import main as cli_main
from raytpu.config import RenderConfig
from raytpu.render import (DroppedRaysError, render_single, render_timed)
from raytpu.scene import build_scene, default_scene, make_material

# A frame-filling transparent sphere spawns two live children per camera
# ray; capacity_factor=1 gives per-level capacity == chunk, so half the
# live children must be dropped (same construction as
# test_wavefront.test_wavefront_counts_dropped_rays).
_OVERFLOW_WF = dict(chunk_rays=256, capacity_factor=1)


def _overflow_scene():
    mat = make_material(0.3, (0.2, 0.4, 0.6), (0.9, 0.9, 0.9),
                        opacity=0.0, ior=1.5)
    return build_scene(
        sphere_specs=[((0.0, 0.0, -10.0), 9.9, mat)],
        light_specs=[((10.0, 30.0, 10.0), (0.5, 0.5, 0.5))],
    )


def test_render_single_warns_on_drops():
    cfg = RenderConfig(width=128, height=64, max_depth=2, alias_factor=1)
    with pytest.warns(RuntimeWarning, match="dropped .* live rays"):
        img, info = render_single(_overflow_scene(), cfg,
                                  backend="wavefront",
                                  wf_opts=_OVERFLOW_WF, return_info=True)
    assert info["dropped"] > 0
    assert img.shape == (64, 128, 3)


def test_render_single_raises_under_strict():
    cfg = RenderConfig(width=128, height=64, max_depth=2, alias_factor=1)
    with pytest.raises(DroppedRaysError):
        render_single(_overflow_scene(), cfg, backend="wavefront",
                      wf_opts=_OVERFLOW_WF, on_drop="raise")


def test_render_timed_stats_include_dropped():
    cfg = RenderConfig(width=128, height=64, max_depth=2, alias_factor=1)
    with pytest.warns(RuntimeWarning):
        _, stats = render_timed(_overflow_scene(), cfg, warmup=0, iters=1,
                                backend="wavefront", wf_opts=_OVERFLOW_WF)
    assert stats["dropped"] > 0
    # A clean config reports zero through the same field.
    cfg2 = RenderConfig(width=32, height=24, max_depth=1, alias_factor=1)
    _, stats2 = render_timed(default_scene(), cfg2, warmup=0, iters=1,
                             backend="jnp")
    assert stats2["dropped"] == 0


def test_cli_time_json_has_dropped(capsys):
    rc = cli_main(["--width", "32", "--height", "24", "--max-depth", "1",
                   "--alias-factor", "1", "--time", "--backend", "jnp"])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "dropped" in stats
    assert stats["dropped"] == 0


def test_loss_and_grad_wavefront_raises_on_drops():
    # The AD path (round-5 guard): dropped rays bias the GRADIENT with no
    # visible symptom in the loss, so training defaults to fail-fast.
    import jax.numpy as jnp

    from raytpu.grad import loss_and_grad_wavefront

    cfg = RenderConfig(width=128, height=64, max_depth=2, alias_factor=1)
    scene = _overflow_scene()
    target = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
    with pytest.raises(DroppedRaysError):
        loss_and_grad_wavefront(scene, cfg, target, **_OVERFLOW_WF)
    # return_info + on_drop="ignore" surfaces the count instead.
    loss, grads, info = loss_and_grad_wavefront(
        scene, cfg, target, on_drop="ignore", return_info=True,
        **_OVERFLOW_WF)
    assert info["dropped"] > 0
    assert np.isfinite(float(loss))


def test_loss_and_grad_sharded_wavefront_raises_on_drops():
    # Per-shard drop counters ride out of the shard_map, are summed, and
    # enforced — the distributed-training half of the same guard.
    import jax
    import jax.numpy as jnp

    from raytpu.grad import loss_and_grad_sharded
    from raytpu.parallel.mesh import make_mesh

    # 256x64 over 2 shards: each shard's window overflows capacity 1.0.
    cfg = RenderConfig(width=256, height=64, max_depth=2, alias_factor=1)
    scene = _overflow_scene()
    target = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
    mesh = make_mesh(jax.devices()[:2])
    with pytest.raises(DroppedRaysError):
        loss_and_grad_sharded(scene, cfg, target, mesh,
                              backend="wavefront", wf_opts=_OVERFLOW_WF)
    loss, grads, info = loss_and_grad_sharded(
        scene, cfg, target, mesh, backend="wavefront",
        wf_opts=_OVERFLOW_WF, on_drop="ignore", return_info=True)
    assert info["dropped"] > 0
    assert np.isfinite(float(loss))


def test_render_single_auto_ladder_ends_drop_free():
    # No explicit capacity_factor -> the auto ladder: the tuned-frontier
    # start drops on this scene, escalates (with a warning), and the final
    # frame is drop-free — the retry is exact because rendering is
    # stateless.
    cfg = RenderConfig(width=128, height=64, max_depth=2, alias_factor=1)
    with pytest.warns(RuntimeWarning, match="auto-capacity"):
        img, info = render_single(_overflow_scene(), cfg,
                                  backend="wavefront",
                                  wf_opts=dict(chunk_rays=256),
                                  return_info=True, on_drop="raise")
    assert info["dropped"] == 0
    assert img.shape == (64, 128, 3)


def test_fit_scene_detects_drops_mid_fit_and_escalates():
    # A fit whose geometry overflows the tuned-frontier capacity must
    # DETECT the drop (not silently train on a biased gradient), discard
    # the step, and re-run at escalated capacity; with an explicit
    # too-tight capacity it must raise instead.
    import jax.numpy as jnp
    import optax

    from raytpu.grad import fit_scene

    cfg = RenderConfig(width=128, height=64, max_depth=2, alias_factor=1)
    scene = _overflow_scene()
    target = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
    with pytest.raises(DroppedRaysError):
        fit_scene(scene, cfg, target, steps=1, backend="wavefront",
                  optimizer=optax.adam(1e-3), wf_opts=_OVERFLOW_WF)
    with pytest.warns(RuntimeWarning, match="auto-capacity"):
        _, losses = fit_scene(scene, cfg, target, steps=2,
                              backend="wavefront",
                              optimizer=optax.adam(1e-3),
                              wf_opts=dict(chunk_rays=256))
    assert len(losses) == 2 and all(np.isfinite(l) for l in losses)


def test_cli_strict_drops_exits_nonzero(tmp_path, capsys):
    # An over-tight capacity factor under --strict-drops must fail loudly,
    # not write a silently-darkened image.
    from raytpu.scene_io import save_scene
    scene_path = str(tmp_path / "overflow.json")
    save_scene(_overflow_scene(), scene_path)
    rc = cli_main(["--width", "128", "--height", "64", "--max-depth", "2",
                   "--alias-factor", "1", "--backend", "wavefront",
                   "--scene-file", scene_path, "--chunk-rays", "256",
                   "--capacity-factor", "1", "--strict-drops"])
    assert rc == 3
    assert "dropped" in capsys.readouterr().err
