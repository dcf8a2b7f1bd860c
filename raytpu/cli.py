"""Command-line driver: the reference's main() + its unused device-picker
CLI (main.cpp:94-508, device_picker.h:70-119) as a real argparse program.

Examples:
  python -m raytpu.cli -o out.ppm                      # golden 800x600 render
  python -m raytpu.cli --width 640 --height 480 --max-depth 4 --time
  python -m raytpu.cli --scene random --num-spheres 256 --sharded
  python -m raytpu.cli --list-devices
  python -m raytpu.cli --oracle -o strict.ppm          # strict numpy oracle
"""

from __future__ import annotations

import argparse
import json
import sys

from raytpu.config import RenderConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytpu", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--zoom", type=float, default=-4.0)
    p.add_argument("--alias-factor", type=int, default=3)
    p.add_argument("--max-depth", type=int, default=5)
    p.add_argument("--chunk-pixels", type=int, default=8192)
    p.add_argument("--scene", choices=["default", "single", "random"],
                   default="default")
    p.add_argument("--scene-file", default=None,
                   help="load the scene from a JSON file (raytpu.scene_io); "
                        "overrides --scene")
    p.add_argument("--save-scene", default=None,
                   help="write the active scene as JSON and continue")
    p.add_argument("--num-spheres", type=int, default=64,
                   help="sphere count for --scene random")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bg-opacity", type=float, default=0.0,
                   help="background-medium opacity (undefined in the "
                        "reference; see raytpu.scene.Medium)")
    p.add_argument("-o", "--output", default=None, help="output PPM path")
    p.add_argument("--sharded", action="store_true",
                   help="shard the pixel grid over all devices")
    p.add_argument("--interleave", action="store_true",
                   help="with --sharded: give each device the strided "
                        "pixel set {shard + j*mesh} instead of a "
                        "contiguous block — balances hot-strip live-ray "
                        "load (up to 2x under block sharding); output "
                        "is bit-identical")
    p.add_argument("--oracle", action="store_true",
                   help="render with the strict numpy oracle (slow)")
    p.add_argument("--oracle-cap", type=int, default=5,
                   help="oracle trace-stack capacity (5 = the GPU build "
                        "that produced testPPM.ppm; 6 = the CPU build)")
    p.add_argument("--fresnel-double", action="store_true",
                   help="oracle uses double-precision Fresnel intermediates "
                        "(the reference CPU build, raytracer.h:380-381); "
                        "default float matches the GPU golden")
    p.add_argument("--time", action="store_true", dest="timeit",
                   help="print timing/Mrays/s stats as JSON")
    p.add_argument("--backend", choices=["auto", "jnp", "pallas", "wavefront"],
                   default="auto",
                   help="compute path: the fused GPU forward kernel "
                        "(pallas), the wavefront tracer, or the XLA-fused "
                        "jnp tracer (auto on the GPU: wavefront when "
                        "spheres x 2^depth >= 512, else pallas; jnp on "
                        "other platforms)")
    p.add_argument("--chunk-rays", type=int, default=None,
                   help="wavefront backend: camera rays per scan chunk "
                        "(bounds live memory; default: the auto ladder's "
                        "tuned 512K)")
    p.add_argument("--capacity-factor", type=float, default=None,
                   help="wavefront backend: per-level live-ray capacity as "
                        "a multiple of chunk-rays.  Default: the AUTO "
                        "ladder — tuned zero-drop frontier first, "
                        "escalate + re-render on any drop.  An explicit "
                        "value disables the ladder; live rays past it are "
                        "dropped, counted, and reported — a warning by "
                        "default, 'dropped' in the --time JSON, an error "
                        "under --strict-drops)")
    p.add_argument("--strict-drops", action="store_true",
                   help="exit with an error if the wavefront drops any "
                        "live rays (capacity overflow) instead of warning")
    p.add_argument("--list-devices", action="store_true")
    p.add_argument("--device", type=int, default=None,
                   help="render on a single specific device index "
                        "(the reference's unused --device picker, "
                        "device_picker.h:70-119)")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (overrides any platform "
                        "auto-registration)")
    p.add_argument("--compare", nargs=2, metavar=("A.ppm", "B.ppm"),
                   default=None,
                   help="compare two PPM images and print diff stats as "
                        "JSON (the reference project's whole test strategy "
                        "— 'render the scene using GPGPU or the CPU and "
                        "compare the results', README.md:4 — as a command); "
                        "all other options are ignored")
    return p


def compare_ppms(path_a: str, path_b: str) -> dict:
    """Byte-level diff stats between two P6 PPMs (any size; sizes must
    match).  The stats mirror the repo's golden-test metrics so CLI
    comparisons and CI agree: byte_exact fraction, within-1 fraction, MAE
    and max over 8-bit channel values, plus the mismatching-pixel count."""
    import numpy as np

    from raytpu.image import read_ppm
    a = read_ppm(path_a).astype(np.int32)
    b = read_ppm(path_b).astype(np.int32)
    if a.shape != b.shape:
        return {"error": f"size mismatch: {a.shape} vs {b.shape}"}
    diff = np.abs(a - b)
    pix_mismatch = int((diff.reshape(-1, 3).max(axis=1) > 0).sum())
    return {
        "shape": list(a.shape),
        "byte_exact": round(float((diff == 0).mean()), 6),
        "within_1": round(float((diff <= 1).mean()), 6),
        "mae": round(float(diff.mean()), 4),
        "max_abs": int(diff.max()),
        "mismatching_pixels": pix_mismatch,
        "total_pixels": int(a.shape[0] * a.shape[1]),
    }


def make_scene(args):
    import dataclasses

    import jax.numpy as jnp

    from raytpu import scene as S
    if args.scene_file:
        from raytpu.scene_io import load_scene
        return load_scene(args.scene_file)
    if args.scene == "single":
        built = S.single_sphere_scene()
    elif args.scene == "random":
        built = S.random_scene(args.num_spheres, seed=args.seed)
    else:
        built = S.default_scene()
    # --bg-opacity applies to every generated scene (it is the reference-UB
    # knob; scene files carry their own value).
    bg = dataclasses.replace(built.bg,
                             opacity=jnp.float32(args.bg_opacity))
    return dataclasses.replace(built, bg=bg)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.compare:
        stats = compare_ppms(*args.compare)
        print(json.dumps(stats))
        return 2 if "error" in stats else 0

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from raytpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    if args.list_devices:
        from raytpu.parallel.mesh import describe_devices
        print(describe_devices())
        return 0

    cfg = RenderConfig(width=args.width, height=args.height, zoom=args.zoom,
                       alias_factor=args.alias_factor, max_depth=args.max_depth,
                       chunk_pixels=args.chunk_pixels)
    scene = make_scene(args)
    if args.save_scene:
        from raytpu.scene_io import save_scene
        save_scene(scene, args.save_scene)
        print(f"wrote {args.save_scene}")

    if args.device is not None:
        import jax
        devices = jax.devices()
        if not 0 <= args.device < len(devices):
            print(f"error: device {args.device} not in [0, {len(devices)})",
                  file=sys.stderr)
            return 2
        scene = jax.device_put(scene, devices[args.device])

    wf_opts = {k: v for k, v in (("chunk_rays", args.chunk_rays),
                                 ("capacity_factor", args.capacity_factor))
               if v is not None}

    on_drop = "raise" if args.strict_drops else "warn"
    from raytpu.render import DroppedRaysError
    try:
        if args.oracle:
            from raytpu.oracle import render_oracle
            img = render_oracle(scene, cfg, cap=args.oracle_cap,
                                fresnel_double=args.fresnel_double)
        elif args.timeit:
            from raytpu.parallel.mesh import make_mesh
            from raytpu.render import render_timed
            mesh = make_mesh() if args.sharded else None
            img, stats = render_timed(scene, cfg, mesh, backend=args.backend,
                                      wf_opts=wf_opts, on_drop=on_drop,
                                      interleave=args.interleave)
            stats_out = {k: v for k, v in stats.items() if k != "times"}
            print(json.dumps(stats_out))
        else:
            import jax
            if args.sharded:
                from raytpu.render import render_sharded
                img = jax.block_until_ready(
                    render_sharded(scene, cfg, backend=args.backend,
                                   wf_opts=wf_opts, on_drop=on_drop,
                                   interleave=args.interleave))
            else:
                from raytpu.render import render_single
                img = jax.block_until_ready(
                    render_single(scene, cfg, backend=args.backend,
                                  wf_opts=wf_opts, on_drop=on_drop))
    except DroppedRaysError as e:
        print(f"error: {e}", file=sys.stderr)
        return 3

    if args.output:
        import numpy as np

        from raytpu.image import write_ppm
        write_ppm(np.asarray(img), args.output)
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
