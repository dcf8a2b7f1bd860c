"""Golden-image tests against the reference's checked-in renders.

The repo's primary golden is testPPM.ppm — the output main.cpp actually
writes (main.cpp:501), produced by the GPU kernel path.  The strict oracle
reproduces it at ~98% byte-exact with cap=5 (the GPU stack capacity,
raytrace_kernel.cl:58) and background-medium opacity 0.0 (the uninitialised
bgMaterial field read as zeroed private memory); the residual is GPU-compiler
float contraction.  testPPM_CPU.ppm / testPPM_GPU.ppm are renders of *older*
code revisions and only match loosely (established empirically — see
tools/fit_golden.py and the SURVEY.md section 3.3 divergences).
"""

import numpy as np
import pytest

from raytpu.config import RenderConfig
from raytpu.image import read_ppm
from raytpu.oracle import camera_dirs_oracle, trace_oracle
from raytpu.scene import default_scene

GOLDEN_PATH = "/root/reference/raytracer_gamma/testPPM.ppm"
F = np.float32

# Rows 242-246 bracket the image's global-max pixel (the green sphere's
# brightest point), so a subset render containing them reproduces the
# normalising maxColourVal exactly.
ROWS = sorted(set(np.linspace(0, 599, 12).astype(int).tolist())
              | {242, 243, 244, 245, 246})


def _render_rows(rows, cfg, scene, cap):
    sel = (np.asarray(rows)[:, None] * cfg.width
           + np.arange(cfg.width)[None, :]).ravel()
    acc = np.zeros((sel.size, 3), F)
    w = F(1.0) / F(cfg.alias_factor**2)
    for i in range(cfg.alias_factor):
        for j in range(cfg.alias_factor):
            dirs = camera_dirs_oracle(cfg, i, j)[sel]
            acc += w * trace_oracle(scene, np.zeros(3, F), dirs, cap=cap,
                                    fresnel_double=False)
    return acc.reshape(len(rows), cfg.width, 3)


@pytest.fixture(scope="module")
def golden(reference_renders):
    return read_ppm(GOLDEN_PATH)


def test_strict_oracle_matches_testppm(golden):
    cfg = RenderConfig()
    scene = default_scene(bg_opacity=0.0)
    img = _render_rows(ROWS, cfg, scene, cap=5)

    # Reference tone map with the subset max (== global max by row choice).
    finite = img[~np.isnan(img)]
    maxv = max(float(finite.max()), 0.0) or 1.0
    clamped = np.where(np.isnan(img), 1.0, np.minimum(img, 1.0))
    ours = (clamped * 255.0 / maxv).astype(np.int64) & 0xFF

    ref = golden[ROWS].astype(np.int64)
    err = np.abs(ours - ref)
    per_pix = err.max(axis=-1)
    exact = (per_pix == 0).mean()
    # Full-frame stats are exact=0.979/mae=0.028; this row subset leans into
    # the hard bright-green-sphere rows, so thresholds are a bit looser.
    assert exact > 0.95, f"byte-exact fraction {exact:.4f}"
    assert err.mean() < 0.2, f"byte MAE {err.mean():.4f}"
    assert (per_pix > 5).mean() < 0.02


def test_wrong_stack_capacity_does_not_match(golden):
    # Sanity check that the golden comparison has teeth: the CPU-header
    # stack capacity (6) visibly diverges from testPPM.ppm.
    cfg = RenderConfig()
    scene = default_scene(bg_opacity=0.0)
    rows = ROWS[:6] + [242, 243, 244, 245, 246]
    img = _render_rows(sorted(set(rows)), cfg, scene, cap=6)
    finite = img[~np.isnan(img)]
    maxv = max(float(finite.max()), 0.0) or 1.0
    clamped = np.where(np.isnan(img), 1.0, np.minimum(img, 1.0))
    ours = (clamped * 255.0 / maxv).astype(np.int64) & 0xFF
    ref = golden[sorted(set(rows))].astype(np.int64)
    err = np.abs(ours - ref)
    assert err.mean() > 0.5  # clearly worse than the cap=5 match (~1.4)


def test_cpu_golden_2_is_byte_identical_to_cpu_golden(reference_renders):
    """testPPM_CPU_2.ppm == testPPM_CPU.ppm byte-for-byte (measured,
    tools/fit_old_goldens.py) — the CPU-golden pin
    (test_native.test_native_cpu_golden_pinned) covers both artifacts."""
    a = read_ppm("/root/reference/raytracer_gamma/testPPM_CPU.ppm")
    b = read_ppm("/root/reference/raytracer_gamma/testPPM_CPU_2.ppm")
    np.testing.assert_array_equal(a, b)


def test_old_gpu_goldens_are_one_family(reference_renders):
    """testPPM_2.ppm and testPPM_GPU.ppm agree at 97.8% byte-exact with
    each other (one older-revision render family) while both sit at only
    ~91.6% against testPPM.ppm — the inventory split the best-known-match
    pins below rely on (tools/fit_old_goldens.py)."""
    t2 = read_ppm("/root/reference/raytracer_gamma/testPPM_2.ppm").astype(int)
    tg = read_ppm("/root/reference/raytracer_gamma/testPPM_GPU.ppm").astype(int)
    bp = np.abs(t2 - tg).max(axis=-1)
    assert (bp == 0).mean() > 0.94  # 0.950 per-pixel (0.978 per-channel)


def test_old_gpu_goldens_pinned(reference_renders):
    """Best-known-match regression pin for testPPM_2 / testPPM_GPU
    (VERDICT round-3 item 5): they are renders of an OLDER code revision
    (the diff vs testPPM concentrates on the transparent/glossy spheres,
    ~2x darker in the old renders; the closest single-mutation hypothesis
    — transparency applied twice to the refracted child — reaches 0.90
    exact, so the old code differed structurally).  The best any
    stock strict-semantics config reaches is cap=5 / bg_opacity=0 / float
    Fresnel at 0.885-0.887 byte-exact, mae ~3.1 (full sweep in
    tools/fit_old_goldens.py).  This pin keeps that match from
    regressing."""
    from raytpu.image import tone_map
    from raytpu.native import render_native
    scene = default_scene(bg_opacity=0.0)
    cfg = RenderConfig()
    img = render_native(scene, cfg, cap=5, fresnel_double=False)
    ours = tone_map(img).astype(int)
    for name in ("testPPM_2", "testPPM_GPU"):
        golden = read_ppm(
            f"/root/reference/raytracer_gamma/{name}.ppm").astype(int)
        err = np.abs(ours - golden)
        by_pix = err.max(axis=-1)
        assert (by_pix == 0).mean() > 0.87, \
            f"{name}: {(by_pix == 0).mean():.4f}"
        assert err.mean() < 3.5, f"{name}: MAE {err.mean():.4f}"
