"""Backend choice, the refusal to run a kernel where it cannot compile,
the compile-cache directory rule, and chip_smoke.py's refusal to run
without a GPU."""

import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import pytest

import raytpu.render as R
from raytpu.config import RenderConfig
from raytpu.scene import default_scene, random_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHALLOW = RenderConfig(width=8, height=8, max_depth=2, alias_factor=1)
DEEP = RenderConfig(width=8, height=8, max_depth=6, alias_factor=1)


@pytest.mark.parametrize("n_spheres,cfg,train,want", [
    (3, SHALLOW, False, "pallas"),
    (3, DEEP, False, "pallas"),        # 3 x 64 = 192 < 512
    (3, DEEP, True, "wavefront"),      # training: the wavefront on the GPU
    (256, SHALLOW, False, "wavefront"),
    (256, DEEP, True, "wavefront"),
    (64, SHALLOW, False, "pallas"),    # 64 x 4 = 256 < 512
    (64, SHALLOW, True, "wavefront"),  # below the crossover, still trains
])
def test_auto_on_gpu(monkeypatch, n_spheres, cfg, train, want):
    monkeypatch.setattr(R.jax, "default_backend", lambda: "gpu")
    scene = default_scene() if n_spheres == 3 else random_scene(n_spheres)
    assert R.resolve_backend("auto", scene, cfg, train=train) == want


@pytest.mark.parametrize("train", [False, True])
def test_auto_off_gpu_is_jnp(train):
    assert R.resolve_backend("auto", random_scene(256), DEEP,
                             train=train) == "jnp"


def test_kernel_backend_on_cpu_raises_without_interpret():
    cfg = RenderConfig(width=8, height=8, max_depth=1, alias_factor=1)
    with pytest.raises(RuntimeError, match="interpret=True"):
        R.render_single(default_scene(), cfg, backend="pallas")
    with pytest.raises(RuntimeError, match="interpret=True"):
        R.render_sharded(default_scene(), cfg, backend="pallas")
    img = R.render_single(default_scene(), cfg, backend="pallas",
                          interpret=True)
    assert img.shape == (8, 8, 3)


def test_training_with_the_forward_kernel_raises():
    from raytpu.grad import fit_scene, loss_and_grad_sharded

    cfg = RenderConfig(width=8, height=8, max_depth=1, alias_factor=1)
    target = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
    with pytest.raises(ValueError, match="no backward"):
        loss_and_grad_sharded(default_scene(), cfg, target,
                              backend="pallas")
    with pytest.raises(ValueError, match="no backward"):
        fit_scene(default_scene(), cfg, target, steps=1, backend="pallas")


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        R.resolve_backend("mosaic")


def _cache_dir_in_child(env_dir):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = ("import jax; from raytpu.utils.compile_cache import "
            "enable_compile_cache as e; p = e(); "
            "print(p); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_compile_cache_uses_the_environment_variable(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir_in_child(want) == [want, want]


def test_compile_cache_defaults_to_the_checkout():
    want = os.path.join(REPO, ".jax_cache")
    assert _cache_dir_in_child(None) == [want, want]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    """chip_smoke.py exits nonzero and prints no result line when JAX finds
    no GPU — from the checkout, and from a directory that holds the script
    and nothing else of the repository."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
