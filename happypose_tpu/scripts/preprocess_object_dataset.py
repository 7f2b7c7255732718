"""Object-dataset preprocessing: scale / pointclouds / stats / subsets.

Parity targets (the MegaPose mesh-preparation pipeline,
/root/reference/happypose/pose_estimators/megapose/scripts/):
- make_shapenet_ply_scaled.py / make_gso_meshes.py — rescale meshes to a
  canonical size and save renderer-ready copies  -> `scale`
- make_shapenet_pointclouds.py — sample per-object point clouds -> `pointclouds`
- make_shapenet_statistics.py — per-mesh stats (vertex/face counts,
  extents) used to filter bad assets -> `stats`
- make_shapenet_subsets.py / make_gso_subsets.py — write object-subset
  lists from stats filters -> `subset`

All subcommands walk a directory of .ply/.obj meshes (recursively) and are
renderer-agnostic: the on-device rasterizer consumes meshes directly, so no
panda3d/urdf conversion step exists here.

Usage:
  python -m happypose_tpu.scripts.preprocess_object_dataset scale \
      --in-dir meshes/ --out-dir meshes_scaled/ --target-diameter 0.1
  ... pointclouds --in-dir meshes/ --out-dir pc/ --n-points 2000
  ... stats --in-dir meshes/ --out stats.json
  ... subset --stats stats.json --max-faces 20000 --out subset.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from happypose_tpu.utils.logging import get_logger

logger = get_logger(__name__)

MESH_SUFFIXES = (".ply", ".obj")


def _iter_meshes(in_dir: Path):
    from happypose_tpu.meshes.io import load_mesh

    for path in sorted(in_dir.rglob("*")):
        if path.suffix.lower() in MESH_SUFFIXES:
            yield path.relative_to(in_dir), load_mesh(path)


def cmd_scale(args) -> int:
    from happypose_tpu.meshes.io import save_ply

    args.out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for rel, mesh in _iter_meshes(args.in_dir):
        if args.target_diameter is not None:
            d = mesh.diameter
            s = args.target_diameter / d if d > 0 else 1.0
        else:
            s = args.scale
        out = args.out_dir / rel.with_suffix(".ply")
        out.parent.mkdir(parents=True, exist_ok=True)
        save_ply(out, mesh.scaled(s))
        n += 1
    logger.info(f"scaled {n} meshes -> {args.out_dir}")
    return 0


def cmd_pointclouds(args) -> int:
    args.out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(args.seed)
    n = 0
    for rel, mesh in _iter_meshes(args.in_dir):
        v = mesh.vertices
        if len(v) >= args.n_points:
            idx = rng.choice(len(v), args.n_points, replace=False)
        else:
            idx = np.concatenate(
                [np.arange(len(v)),
                 rng.choice(len(v), args.n_points - len(v), replace=True)]
            )
        out = args.out_dir / rel.with_suffix(".npz")
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            out, points=v[idx].astype(np.float32),
            normals=mesh.vertex_normals[idx].astype(np.float32),
        )
        n += 1
    logger.info(f"wrote {n} pointclouds -> {args.out_dir}")
    return 0


def cmd_stats(args) -> int:
    stats = {}
    for rel, mesh in _iter_meshes(args.in_dir):
        lo = mesh.vertices.min(0)
        hi = mesh.vertices.max(0)
        stats[str(rel)] = {
            "n_vertices": int(len(mesh.vertices)),
            "n_faces": int(len(mesh.faces)),
            "diameter": float(mesh.diameter),
            "extents": (hi - lo).tolist(),
            "has_colors": mesh.vertex_colors is not None,
        }
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(stats, indent=1))
    logger.info(f"stats for {len(stats)} meshes -> {args.out}")
    return 0


def cmd_subset(args) -> int:
    stats = json.loads(args.stats.read_text())
    keep = []
    for name, s in stats.items():
        if args.max_faces is not None and s["n_faces"] > args.max_faces:
            continue
        if args.max_vertices is not None and s["n_vertices"] > args.max_vertices:
            continue
        if args.min_diameter is not None and s["diameter"] < args.min_diameter:
            continue
        if args.max_diameter is not None and s["diameter"] > args.max_diameter:
            continue
        if args.require_colors and not s["has_colors"]:
            continue
        keep.append(name)
    if args.n_objects is not None:
        keep = keep[: args.n_objects]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(keep, indent=1))
    logger.info(f"subset: {len(keep)}/{len(stats)} meshes -> {args.out}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("scale")
    ps.add_argument("--in-dir", type=Path, required=True)
    ps.add_argument("--out-dir", type=Path, required=True)
    g = ps.add_mutually_exclusive_group(required=True)
    g.add_argument("--scale", type=float)
    g.add_argument("--target-diameter", type=float,
                   help="uniform-rescale every mesh to this diameter (m)")
    ps.set_defaults(fn=cmd_scale)

    pp = sub.add_parser("pointclouds")
    pp.add_argument("--in-dir", type=Path, required=True)
    pp.add_argument("--out-dir", type=Path, required=True)
    pp.add_argument("--n-points", type=int, default=2000)
    pp.add_argument("--seed", type=int, default=0)
    pp.set_defaults(fn=cmd_pointclouds)

    pt = sub.add_parser("stats")
    pt.add_argument("--in-dir", type=Path, required=True)
    pt.add_argument("--out", type=Path, required=True)
    pt.set_defaults(fn=cmd_stats)

    pu = sub.add_parser("subset")
    pu.add_argument("--stats", type=Path, required=True)
    pu.add_argument("--out", type=Path, required=True)
    pu.add_argument("--max-faces", type=int, default=None)
    pu.add_argument("--max-vertices", type=int, default=None)
    pu.add_argument("--min-diameter", type=float, default=None)
    pu.add_argument("--max-diameter", type=float, default=None)
    pu.add_argument("--require-colors", action="store_true")
    pu.add_argument("--n-objects", type=int, default=None)
    pu.set_defaults(fn=cmd_subset)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
