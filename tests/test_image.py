import numpy as np

from raytpu.image import max_colour_value, read_ppm, tone_map, write_ppm


def test_tone_map_clamp_before_scale():
    # The reference clamps to 1.0 BEFORE dividing by the max (main.cpp:71-76),
    # so a max above 1 darkens everything.
    img = np.asarray([[[2.0, 1.0, 0.5]]], np.float32)
    out = tone_map(img)  # max = 2.0
    # channel 0: min(1,2)*255/2 = 127.5 -> 127 (truncation)
    assert out.tolist() == [[[127, 127, 63]]]


def test_tone_map_nan_is_one():
    img = np.asarray([[[np.nan, 0.5, 1.0]]], np.float32)
    out = tone_map(img)  # NaN skipped by max scan -> max=1
    assert out.tolist() == [[[255, 127, 255]]]


def test_tone_map_small_max_rescales_up():
    img = np.asarray([[[1e-4, 5e-5, 0.0]]], np.float32)
    out = tone_map(img)
    assert out[0, 0, 0] == 255
    assert out[0, 0, 1] in (127, 128)
    assert out[0, 0, 2] == 0


def test_max_colour_value_guard():
    assert max_colour_value(np.zeros((2, 2, 3), np.float32)) == 1.0


def test_ppm_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((7, 5, 3)).astype(np.float32)
    path = tmp_path / "x.ppm"
    write_ppm(img, path)
    back = read_ppm(path)
    assert back.shape == (7, 5, 3)
    np.testing.assert_array_equal(back, tone_map(img))


def test_read_reference_golden(reference_renders):
    g = read_ppm("/root/reference/raytracer_gamma/testPPM_CPU.ppm")
    assert g.shape == (600, 800, 3)


def test_cli_compare_ppms(tmp_path):
    """The --compare CLI (the reference's own 'render both and compare'
    test strategy as a command) reports exactness stats; identical files
    are fully byte-exact, a 1-byte change is counted."""
    import json

    import numpy as np

    from raytpu.cli import compare_ppms, main
    from raytpu.image import read_ppm, write_ppm

    img = np.linspace(0, 1, 2 * 3 * 3, dtype=np.float32).reshape(2, 3, 3)
    a = str(tmp_path / "a.ppm")
    b = str(tmp_path / "b.ppm")
    write_ppm(img, a)
    raw = read_ppm(a)
    raw2 = raw.copy()
    raw2[0, 0, 0] = (int(raw2[0, 0, 0]) + 3) % 256
    hdr = f"P6\n{raw.shape[1]} {raw.shape[0]}\n255\n".encode()
    with open(b, "wb") as f:
        f.write(hdr + raw2.tobytes())

    same = compare_ppms(a, a)
    assert same["byte_exact"] == 1.0 and same["mismatching_pixels"] == 0
    stats = compare_ppms(a, b)
    assert stats["mismatching_pixels"] == 1
    assert stats["max_abs"] == 3
    assert 0 < stats["byte_exact"] < 1
    assert main(["--compare", a, b]) == 0  # prints JSON, exits 0
    import io
    from contextlib import redirect_stdout

    c = str(tmp_path / "c.ppm")
    write_ppm(img[:1], c)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(["--compare", a, c])
    assert rc == 2 and "error" in json.loads(buf.getvalue())
