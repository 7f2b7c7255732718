"""Record a synthetic multi-object BOP-format dataset with the on-device
renderer and the domain-randomized scene engine.

Parity target: the reference's synthetic data generation — pybullet
`BopRecordingScene` (cosypose/recording/bop_recording_scene.py:26-271) and
the BlenderProc PBR pipeline (megapose/scripts/generate_shapenet_pbr.py) —
re-imagined without external engines. `SceneSynthesizer` samples resting
poses (projected-gravity solver), spherical cameras, randomized
lights/materials/backgrounds; `BatchedSceneRecorder` renders, shades
(shadow-map + specular), composites and annotates whole batches of frames
in one jitted device call (round 2's per-frame path was ~2 s/frame; this
records thousands of frames per minute on one chip). Frames are written
in BOP layout so every downstream loader works unchanged.

Usage:
  python -m happypose_tpu.scripts.record_synthetic_dataset \
      --models-dir <bop>/models --out-dir /tmp/synth --n-frames 2048
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from happypose_tpu.utils.logging import get_logger

logger = get_logger(__name__)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--models-dir", type=Path, default=None,
                   help="BOP models dir; defaults to built-in debug meshes")
    p.add_argument("--builtin-set", choices=("debug", "r03"), default="debug",
                   help="built-in object set when --models-dir is absent: "
                        "'debug' (sphere+box) or 'r03' (4 objects incl. the "
                        "reference's shipped bottle mesh, decimated)")
    p.add_argument("--out-dir", type=Path, required=True)
    p.add_argument("--n-frames", type=int, default=20)
    p.add_argument("--n-objects-interval", type=int, nargs=2, default=(2, 4))
    p.add_argument("--proba-falling", type=float, default=0.5)
    p.add_argument("--resolution", type=int, nargs=2, default=(240, 320))
    p.add_argument("--batch-scenes", type=int, default=16,
                   help="scenes rendered per device call")
    p.add_argument("--no-domain-rand", action="store_true")
    p.add_argument("--no-border-check", action="store_true")
    p.add_argument("--no-floor", action="store_true",
                   help="drop the shadow-receiving ground plane")
    p.add_argument("--no-shadows", action="store_true")
    p.add_argument("--max-faces", type=int, default=0,
                   help="decimate meshes above this face count (keeps the "
                        "fast tile-major kernel path)")
    p.add_argument("--textures-on-objects", action="store_true",
                   help="give every object a procedural texture "
                        "(ref: textures_on_objects)")
    p.add_argument("--randomize-object-textures", action="store_true",
                   help="re-randomize object textures every device batch "
                        "(appearance DR; canonical models keep their own)")
    p.add_argument("--blur-sigma-max", type=float, default=None,
                   help="cap the per-scene depth-of-field blur sigma "
                        "(default keeps the config interval; 0 disables — "
                        "at 120x160 training resolution the default 1.2px "
                        "blur erases small-object texture detail)")
    p.add_argument("--noise-std-max", type=float, default=None,
                   help="cap the per-scene sensor-noise std (0 disables)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--write-models", action="store_true",
                   help="also write <out-dir>/models in BOP layout")
    p.add_argument("--wds", action="store_true",
                   help="also write <out-dir>/wds tar shards (the training "
                        "pipeline's streaming format, ref WebSceneDataset)")
    p.add_argument("--wds-only", action="store_true",
                   help="write ONLY the wds shards (no BOP png tree) - "
                        "for large streaming-training recordings")
    p.add_argument("--shard-size", type=int, default=64)
    args = p.parse_args(argv)

    from happypose_tpu.datasets.bop import SceneObservation, write_bop_scene
    from happypose_tpu.datasets.scene_record import BatchedSceneRecorder
    from happypose_tpu.datasets.scene_synth import SceneSynthConfig
    from happypose_tpu.meshes.database import MeshDataBase
    from happypose_tpu.meshes.io import (
        decimate_mesh, load_mesh, make_box_mesh, make_cylinder_mesh,
        make_random_texture, make_uv_sphere, position_colored,
    )

    if args.models_dir:
        from happypose_tpu.datasets.bop import BOPObjectDataset

        mesh_db = BOPObjectDataset(args.models_dir).mesh_db
    elif args.builtin_set == "r03":
        # Round-3 training object set (TRAINING_NOTES.md "Round-3
        # dataset"): 4 objects with rotation-observable appearance —
        # textured UV sphere, position-colored box + cylinder, and the
        # reference's shipped bottle mesh (mm units) decimated to the
        # tile-major kernel budget with a procedural texture over its
        # shipped UVs.
        rs = np.random.RandomState(args.seed + 101)
        sphere = make_uv_sphere(0.04, 24, 32, with_uv=True)
        sphere.texture = make_random_texture(rs, 128)
        meshes = {
            "obj_000001": sphere,
            "obj_000002": position_colored(
                make_box_mesh((0.035, 0.025, 0.045))),
            "obj_000003": position_colored(
                make_cylinder_mesh(0.022, 0.07)),
        }
        scales = {}
        bottle = Path("/root/reference/tests/data/obj_000001.ply")
        if bottle.is_file():
            m = decimate_mesh(load_mesh(bottle), 1700)
            if m.vertex_uv is not None:
                m.texture = make_random_texture(rs, 128)
            meshes["obj_000004"] = m
            scales["obj_000004"] = 0.001
        mesh_db = MeshDataBase(meshes=meshes, scales=scales)
    else:
        mesh_db = MeshDataBase(meshes={
            # dense enough that baked vertex colors (write_bop_models)
            # retain texture detail
            "obj_000001": make_uv_sphere(0.04, 24, 32, with_uv=True),
            "obj_000002": make_box_mesh((0.035, 0.025, 0.045)),
        })
    if args.max_faces:
        for label, m in mesh_db.meshes.items():
            if len(m.faces) > args.max_faces:
                mesh_db.meshes[label] = decimate_mesh(m, args.max_faces)
    if args.textures_on_objects:
        rs = np.random.RandomState(args.seed)
        for label in mesh_db.labels:
            m = mesh_db.meshes[label]
            if m.vertex_uv is not None:
                m.texture = make_random_texture(rs, 128)
    if args.write_models:
        from happypose_tpu.datasets.bop import write_bop_models

        write_bop_models(args.out_dir / "models", mesh_db)
        logger.info(f"wrote models to {args.out_dir}/models")
    if args.n_frames <= 0:
        return 0

    H, W = args.resolution
    cfg = SceneSynthConfig(
        n_objects_interval=tuple(args.n_objects_interval),
        proba_falling=args.proba_falling,
        resolution=(H, W),
        border_check=not args.no_border_check,
        domain_randomization=not args.no_domain_rand,
    )
    if args.blur_sigma_max is not None:
        cfg.blur_sigma_interval = (0.0, args.blur_sigma_max)
    if args.noise_std_max is not None:
        cfg.noise_std_interval = (0.0, args.noise_std_max)
    rec = BatchedSceneRecorder(
        mesh_db, cfg, seed=args.seed, batch_scenes=args.batch_scenes,
        floor=not args.no_floor, shadows=not args.no_shadows,
        randomize_object_textures=args.randomize_object_textures,
    )
    t0 = time.time()
    recorded = rec.record(args.n_frames, progress_every=16)
    dt = time.time() - t0
    frames = []
    for f in recorded:
        frames.append(SceneObservation(
            rgb=f.rgb, K=f.K, depth=f.depth, obj_labels=f.labels,
            # BOP scene_gt is camera-frame (cam_R_m2c); world alignment
            # goes to scene_camera via TWC (cam_R_w2c)
            TWO=f.TCO, bboxes=f.bboxes, visib_fract=f.visib_fract,
            scene_id=0, view_id=len(frames), TWC=f.TWC,
        ))
    if not args.wds_only:
        write_bop_scene(args.out_dir, 0, frames)
    if args.wds or args.wds_only:
        from happypose_tpu.datasets.web_scene_dataset import (
            write_scene_ds_as_wds,
        )

        shards = write_scene_ds_as_wds(
            frames, args.out_dir / "wds", shard_size=args.shard_size
        )
        logger.info(f"wrote {len(shards)} wds shards")
    logger.info(
        f"wrote {len(frames)} frames to {args.out_dir}/000000 "
        f"({dt:.1f}s render = {len(frames) / max(dt, 1e-9):.1f} frames/s)"
    )
    return 0


if __name__ == "__main__":
    from happypose_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
