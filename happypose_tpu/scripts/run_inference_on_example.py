"""Run the full pose pipeline on an example scene and save visualizations.

Parity target: /root/reference/happypose/pose_estimators/megapose/scripts/
run_inference_on_example.py — load an example observation + mesh, run
detections -> coarse -> refiner, save predicted poses (json) and overlay
images.

Without a downloaded example, `--make-example` first synthesizes one with
the framework's own renderer (the test strategy: hermetic fixtures).

Usage:
  python -m happypose_tpu.scripts.run_inference_on_example \
      --example-dir /tmp/example --make-example --model megapose-RGB
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from happypose_tpu.utils.logging import get_logger

logger = get_logger(__name__)


def make_example(example_dir: Path) -> None:
    """Synthesize an example: a mesh dir + one rendered observation."""
    import jax.numpy as jnp

    from happypose_tpu.datasets.bop import SceneObservation, write_bop_scene
    from happypose_tpu.meshes.io import make_box_mesh, make_uv_sphere, save_ply
    from happypose_tpu.meshes.database import MeshDataBase
    from happypose_tpu.ops.renderers import get_renderer

    models = example_dir / "models"
    models.mkdir(parents=True, exist_ok=True)
    save_ply(models / "obj_000001.ply",
             make_uv_sphere(radius=40.0, n_lat=16, n_lon=24))
    save_ply(models / "obj_000002.ply", make_box_mesh((35.0, 25.0, 45.0)))
    (models / "models_info.json").write_text(json.dumps({
        "1": {"diameter": 80.0,
              "symmetries_continuous": [{"axis": [0, 0, 1],
                                         "offset": [0, 0, 0]}]},
        "2": {"diameter": 123.7},
    }))

    db = MeshDataBase(meshes={
        "obj_000001": make_uv_sphere(radius=0.04, n_lat=16, n_lon=24),
        "obj_000002": make_box_mesh((0.035, 0.025, 0.045)),
    })
    assets = db.render_assets()
    H, W = 240, 320
    K = np.eye(3, dtype=np.float32)
    K[0, 0] = K[1, 1] = 400.0
    K[0, 2], K[1, 2] = W / 2, H / 2
    TCO = np.eye(4, dtype=np.float32)
    TCO[:3, 3] = [0.01, -0.02, 0.5]
    out = get_renderer()(
        assets, jnp.asarray([1], jnp.int32), jnp.asarray(TCO)[None],
        jnp.asarray(K)[None], resolution=(H, W),
    )
    mask = np.asarray(out.mask[0])
    ys, xs = np.where(mask)
    obs = SceneObservation(
        rgb=(np.asarray(out.rgb[0]) * 255).astype(np.uint8),
        K=K, depth=np.asarray(out.depth[0]),
        obj_labels=["obj_000002"], TWO=TCO[None],
        bboxes=np.asarray([[xs.min(), ys.min(), xs.max(), ys.max()]],
                          np.float32),
        visib_fract=np.asarray([1.0]), scene_id=0, view_id=0,
    )
    write_bop_scene(example_dir / "scene", 0, [obs])
    logger.info(f"example written to {example_dir}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--example-dir", type=Path, required=True)
    parser.add_argument("--make-example", action="store_true")
    parser.add_argument("--model", default="megapose-RGB")
    parser.add_argument("--so3-grid", type=int, default=72)
    parser.add_argument("--out-dir", type=Path, default=None)
    args = parser.parse_args(argv)

    if args.make_example:
        make_example(args.example_dir)

    from happypose_tpu.datasets.bop import BOPObjectDataset, BOPSceneDataset
    from happypose_tpu.inference.types import DetectionBatch, ObservationBatch
    from happypose_tpu.utils.load_model import NAMED_MODELS, load_named_model
    import dataclasses

    obj_ds = BOPObjectDataset(args.example_dir / "models")
    scene_ds = BOPSceneDataset(args.example_dir / "scene")
    obs = scene_ds[0]

    # small SO(3) grid for quick runs
    spec = NAMED_MODELS[args.model]
    NAMED_MODELS[args.model] = dataclasses.replace(
        spec,
        inference_cfg=dataclasses.replace(
            spec.inference_cfg, SO3_grid_size=args.so3_grid,
            bsz_images=min(spec.inference_cfg.bsz_images, args.so3_grid),
        ),
    )
    estimator = load_named_model(args.model, obj_ds.mesh_db)

    ob = ObservationBatch.from_numpy(obs.rgb, obs.K)
    det = DetectionBatch.from_numpy(
        obs.bboxes, obj_ds.mesh_db.ids_of(obs.obj_labels)
    )
    logger.info("running inference pipeline ...")
    results = estimator.run_inference_pipeline(ob, det)
    final = results["final"]
    valid = np.asarray(final.valid)
    poses = np.asarray(final.poses)[valid]
    obj_ids = np.asarray(final.obj_ids)[valid]

    out_dir = args.out_dir or (args.example_dir / "outputs")
    out_dir.mkdir(parents=True, exist_ok=True)
    records = [
        {"label": obj_ds.mesh_db.labels[int(o)], "TWO": p.tolist()}
        for o, p in zip(obj_ids, poses)
    ]
    (out_dir / "object_data.json").write_text(json.dumps(records, indent=1))

    # overlay visualization with our renderer
    import jax.numpy as jnp
    from PIL import Image

    from happypose_tpu.ops.renderers import get_renderer
    from happypose_tpu.visualization import make_contour_overlay, make_pose_overlay

    assets = obj_ds.mesh_db.render_assets()
    render = get_renderer()(
        assets, jnp.asarray(obj_ids, jnp.int32), jnp.asarray(poses),
        jnp.asarray(np.tile(obs.K[None], (len(poses), 1, 1))),
        resolution=obs.rgb.shape[:2],
    )
    overlay = obs.rgb
    for i in range(len(poses)):
        overlay = make_pose_overlay(
            overlay, np.asarray(render.rgb[i]), np.asarray(render.mask[i])
        )
        overlay = make_contour_overlay(overlay, np.asarray(render.mask[i]))
    Image.fromarray(overlay).save(out_dir / "all_results.png")

    # 3D scene export (meshcat-viewer equivalent): predicted objects in the
    # camera frame + the camera at the origin, as a standalone .glb
    from happypose_tpu.visualization.gltf_export import export_scene_glb

    export_scene_glb(
        out_dir / "scene.glb", obj_ds.mesh_db,
        [obj_ds.mesh_db.labels[int(o)] for o in obj_ids], poses,
        camera_poses=np.eye(4)[None],
    )
    logger.info(
        f"wrote {out_dir}/object_data.json, all_results.png, scene.glb"
    )
    return 0


if __name__ == "__main__":
    from happypose_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
