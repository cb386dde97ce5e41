"""Command-line interface of the PyTorch port (counterpart of
`lidar_brdf_tpu/cli.py`, with the same commands, arguments and outputs).

The reference has no CLI (GUI only, SURVEY.md §1); this provides the
scripted equivalent:

    python -m lidar_brdf_tpu_torch.cli simulate --scene path/to/dir_or_obj \\
        --sensor hdl64e --out cloud.ply [--config cfg.json] [--wavelength N]

    python -m lidar_brdf_tpu_torch.cli presets
    python -m lidar_brdf_tpu_torch.cli config-template > cfg.json

`simulate` and `render-overlays` run on the card; ``--device cpu`` runs
them on the plain PyTorch path instead (without a card, the default
raises).  The JAX CLI's `_enable_compile_cache` (a persistent XLA
compilation cache) has no counterpart: the port compiles its kernels once
per checkout into `build/kernels/`.  Errors in the input exit with 2.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _load_scene(path: str):
    from .io import obj as obj_mod
    from .io import synthetic
    if path == ":demo:":
        return synthetic.terrain_with_boxes(np.random.default_rng(0),
                                            num_boxes=12)
    if os.path.isdir(path):
        return obj_mod.load_scene_dir(path)
    return obj_mod.load_obj_scene(path)


def cmd_simulate(args) -> int:
    from .api import simulate_spectral
    from .core.config import SensorConfig, get_preset
    from .io.materials import MaterialLibrary
    from .io.ply import AsyncPlyWriter

    if args.config:
        with open(args.config) as fh:
            cfg = SensorConfig.from_json(fh.read())
    elif args.sensor:
        cfg = get_preset(args.sensor)
    else:
        cfg = SensorConfig()
    if args.wavelength is not None:
        cfg = cfg.with_(wavelength_nm=(args.wavelength, args.wavelength))
    if args.max_returns is not None:
        cfg = cfg.with_(max_returns=args.max_returns)
    if args.rays_pulse is not None:
        cfg = cfg.with_(rays_per_pulse=args.rays_pulse)
    if args.als_path:
        # waypoints JSON: either [[x, y], ...] canvas points or
        # {"points": [[x, y], ...], "canvas_size": [w, h]}
        import json as _json
        with open(args.als_path) as fh:
            data = _json.load(fh)
        points = data["points"] if isinstance(data, dict) else data
        canvas = (tuple(data.get("canvas_size", (1.0, 1.0)))
                  if isinstance(data, dict) else (1.0, 1.0))
        cfg = cfg.with_(
            als_manual_path=tuple(tuple(float(c) for c in p) for p in points),
            als_manual_canvas_size=canvas)

    scene = _load_scene(args.scene)
    print(f"scene: {scene.num_faces} faces, {scene.num_components} components",
          file=sys.stderr)
    library = MaterialLibrary.default(args.refractive_index_dir)
    if args.brdf_dir:
        # RGL/EPFL measured BRDFs (*.bsdf tensor files or database.npz)
        library = library.with_measured(args.brdf_dir)
    t0 = time.perf_counter()
    clouds = simulate_spectral(scene, cfg, library, device=args.device)
    dt = time.perf_counter() - t0

    base, ext = os.path.splitext(args.out)
    ext = ext or ".ply"
    paths = {wl: (args.out if len(clouds) == 1 else f"{base}_{wl}{ext}")
             for wl in clouds}
    with AsyncPlyWriter() as writer:   # overlap compaction/IO across files
        for wl, cloud in clouds.items():
            writer.submit(paths[wl], cloud)
        counts = writer.join()
    total = 0
    for (wl, _), n in zip(clouds.items(), counts):
        total += n
        print(f"wrote {n} points -> {paths[wl]}", file=sys.stderr)
    print(f"simulated {total} points in {dt:.2f}s", file=sys.stderr)
    return 0


def cmd_presets(_args) -> int:
    from .core.config import SENSOR_PRESETS
    for name, cfg in SENSOR_PRESETS.items():
        kind = cfg.lidar_type.name
        print(f"{name:12s} {kind:22s} channels={cfg.channels:3d} "
              f"maxRange={cfg.max_range:g}m returns={cfg.max_returns}")
    return 0


def cmd_config_template(_args) -> int:
    from .core.config import SensorConfig
    print(SensorConfig().to_json())
    return 0


def cmd_render_ortho(args) -> int:
    """Top-down orthographic backdrop for drawing TLS/ALS paths against
    (the reference's aerial canvas view, `LiDARScene.cpp:118-163`)."""
    from . import viz
    scene = _load_scene(args.scene)
    info = viz.render_ortho(scene, args.out, mode=args.mode, size=args.size)
    print(f"wrote {info['path']} ({info['canvas_size'][0]}x"
          f"{info['canvas_size'][1]}); canvas px -> world: "
          f"world = px / canvas_size * {info['world_size']} + "
          f"{info['world_min']} (feed px paths to tls_path_from_canvas / "
          f"--als-path with canvas_size={info['canvas_size']})")
    return 0


def cmd_render_overlays(args) -> int:
    """Debug overlay PNG: rays + BVH boxes + beam cone + max-range disc
    over a simulated cloud (the reference viewer's overlay draws,
    `LiDARScene.cpp:269-330` + Draw* classes)."""
    from . import viz
    from .api import build_rays, build_scene_bvh, simulate
    from .core.config import SensorConfig, get_preset

    if args.config:
        with open(args.config) as fh:
            cfg = SensorConfig.from_json(fh.read())
    elif args.sensor:
        cfg = get_preset(args.sensor)
    else:
        cfg = SensorConfig()
    scene = _load_scene(args.scene)
    bvh = build_scene_bvh(scene)
    rays = build_rays(cfg, scene, device=args.device)
    cloud = simulate(scene, cfg, bvh=bvh, rays=rays, device=args.device)
    out = viz.render_overlays(scene, cloud, cfg, args.out, bvh=bvh,
                              rays=rays, num_rays=args.num_rays,
                              bvh_depth=args.bvh_depth)
    print(f"wrote {out}", file=sys.stderr)
    return 0


def _add_device(parser) -> None:
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the scan runs (default: the card)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lidar_brdf_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("simulate", help="run a simulation, write PLY")
    ps.add_argument("--scene", required=True,
                    help=".obj file, scene directory, or :demo:")
    ps.add_argument("--sensor", help="hardware preset name (see `presets`)")
    ps.add_argument("--config", help="SensorConfig JSON file")
    ps.add_argument("--out", default="cloud.ply")
    ps.add_argument("--wavelength", type=int)
    ps.add_argument("--max-returns", type=int, dest="max_returns")
    ps.add_argument("--rays-pulse", type=int, dest="rays_pulse")
    ps.add_argument("--refractive-index-dir", dest="refractive_index_dir")
    ps.add_argument("--brdf-dir", dest="brdf_dir",
                    help="directory of RGL/EPFL *.bsdf measured BRDFs")
    ps.add_argument("--als-path", dest="als_path",
                    help="JSON file of user-drawn ALS flight waypoints "
                         "(canvas points; reference path-drawing canvas)")
    _add_device(ps)
    ps.set_defaults(fn=cmd_simulate)

    pp = sub.add_parser("presets", help="list sensor presets")
    pp.set_defaults(fn=cmd_presets)

    pc = sub.add_parser("config-template", help="print default config JSON")
    pc.set_defaults(fn=cmd_config_template)

    po = sub.add_parser("render-ortho",
                        help="top-down PNG backdrop for path drawing")
    po.add_argument("--scene", required=True,
                    help=".obj file, scene directory, or :demo:")
    po.add_argument("--out", default="ortho.png")
    po.add_argument("--mode", default="kad",
                    choices=("kad", "semantic", "asprs", "height"))
    po.add_argument("--size", type=int, default=512)
    po.set_defaults(fn=cmd_render_ortho)

    pv = sub.add_parser("render-overlays",
                        help="debug PNG: rays, BVH boxes, beam cone, "
                             "max-range disc over a simulated cloud")
    pv.add_argument("--scene", required=True,
                    help=".obj file, scene directory, or :demo:")
    pv.add_argument("--sensor", help="hardware preset name")
    pv.add_argument("--config", help="SensorConfig JSON file")
    pv.add_argument("--out", default="overlays.png")
    pv.add_argument("--num-rays", type=int, default=200, dest="num_rays")
    pv.add_argument("--bvh-depth", type=int, default=4, dest="bvh_depth")
    _add_device(pv)
    pv.set_defaults(fn=cmd_render_overlays)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except (KeyError, FileNotFoundError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
