"""End-to-end accuracy demo: full MegaPose pipeline at the reference's
test tolerance on held-out synthetic scenes of a real (BOP-class) mesh.

Pipeline (parity: megapose/inference/pose_estimator.py:516-668):
SO(3)-grid coarse classification -> top-K hypotheses -> N-iteration
render-and-compare refinement -> coarse re-scoring -> top-1; the success
metric is the reference's end-to-end test tolerance
`‖log6(T⁻¹·T̂)‖ < 0.3` (tests/test_cosypose_inference.py:119-128).

Needs a trained refiner and (optionally) a trained coarse classifier from
`run_pose_training` on the SAME `--synth-set`/`--mesh-files` registry.
Without a coarse run dir the pipeline runs the CosyPose flavor
(detection-box zup+autodepth init -> refiner), i.e. a refiner-only demo.

Usage:
  python -m happypose_tpu.scripts.run_accuracy_demo \
      --refiner-dir /tmp/refiner --coarse-dir /tmp/coarse \
      --synth-set textured --mesh-files <mesh.ply> \
      --out /tmp/demo.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from happypose_tpu.utils.logging import get_logger

logger = get_logger(__name__)


def _load_variables(run_dir: Path, template):
    """Model variables out of a training run's saved state."""
    from happypose_tpu.utils.checkpoint import load_checkpoint

    return load_checkpoint(run_dir, {
        "params": template["params"],
        "batch_stats": template.get("batch_stats", {}),
    })[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--refiner-dir", type=Path, required=True)
    p.add_argument("--coarse-dir", type=Path, default=None)
    p.add_argument("--synth-set", default="textured")
    p.add_argument("--mesh-files", type=Path, nargs="*", default=None)
    p.add_argument("--max-faces", type=int, default=0)
    p.add_argument("--n-scenes", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--image-size", type=int, nargs=2, default=(120, 160))
    p.add_argument("--so3-grid", type=int, default=576)
    p.add_argument("--n-hypotheses", type=int, default=5)
    p.add_argument("--n-refiner-iterations", type=int, default=5)
    p.add_argument("--only-labels", nargs="*", default=None,
                   help="restrict eval scenes to these labels (e.g. mesh0 "
                        "to score only the real mesh, not the symmetric "
                        "sphere)")
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from happypose_tpu.inference.pose_estimator import PoseEstimator
    from happypose_tpu.inference.types import (
        DetectionBatch, InferenceConfig, ObservationBatch,
    )
    from happypose_tpu.lib3d.camera import (
        masked_boxes_from_uv, project_points_robust,
    )
    from happypose_tpu.lib3d.rotations import geodesic_distance, log_SE3_norm
    from happypose_tpu.models import PosePredictor, PosePredictorConfig
    from happypose_tpu.training.synth_data import (
        make_synth_batch, make_synth_mesh_db,
    )


    db = make_synth_mesh_db(
        args.synth_set, args.mesh_files, max_faces=args.max_faces
    )
    assets = db.render_assets()
    bm = db.batched(n_points=256)
    H, W = args.image_size
    K1 = jnp.asarray([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1.0]])

    def build_model(run_dir, predict_logits):
        cfg_saved = json.loads((run_dir / "config.json").read_text())
        cfg = PosePredictorConfig(
            backbone=cfg_saved.get("backbone", "wide_resnet18"),
            render_size=tuple(cfg_saved.get("render_size", (120, 160))),
            compute_dtype="bfloat16" if cfg_saved.get("bf16") else "float32",
            predict_pose_update=not predict_logits,
            predict_rendered_views_logits=predict_logits,
        )
        model = PosePredictor(cfg)
        b0 = make_synth_batch(
            jax.random.PRNGKey(0), assets, K1, n_objects=len(db.labels),
            batch_size=2, resolution=(H, W),
        )
        tmpl = jax.jit(model.init)(
            jax.random.PRNGKey(0), b0.images, b0.K, b0.obj_ids, b0.TCO_gt,
            assets, bm.select(b0.obj_ids),
        )
        return model, _load_variables(run_dir, tmpl)

    refiner = build_model(args.refiner_dir, predict_logits=False)
    coarse = (
        build_model(args.coarse_dir, predict_logits=True)
        if args.coarse_dir is not None
        else None
    )

    cfg = InferenceConfig(
        n_refiner_iterations=args.n_refiner_iterations,
        n_pose_hypotheses=args.n_hypotheses,
        SO3_grid_size=args.so3_grid,
    )
    estimator = PoseEstimator(
        refiner=refiner, coarse=coarse, assets=assets, meshes=bm, cfg=cfg
    )

    only_ids = (
        None if args.only_labels is None
        else np.asarray([db.id_of(l) for l in args.only_labels], np.int32)
    )

    all_log6, all_rot, all_trans, all_add = [], [], [], []
    n_batches = -(-args.n_scenes // args.batch_size)
    for b in range(n_batches):
        forced = None
        if only_ids is not None:
            rs = np.random.RandomState(args.seed + b)
            forced = jnp.asarray(
                only_ids[rs.randint(0, len(only_ids), args.batch_size)]
            )
        batch = make_synth_batch(
            jax.random.PRNGKey(args.seed + b), assets, K1,
            n_objects=len(db.labels), batch_size=args.batch_size,
            resolution=(H, W), force_obj_ids=forced,
        )
        obs = ObservationBatch(rgb=batch.images, K=batch.K)
        # gt detections: projected-point boxes (the reference's gt-detection
        # eval mode, prediction_runner.py:98-105)
        inst = bm.select(batch.obj_ids)
        uv = project_points_robust(inst.points, batch.K, batch.TCO_gt)
        boxes = masked_boxes_from_uv(uv, inst.points_mask)
        det = DetectionBatch.from_numpy(
            boxes=np.asarray(boxes),
            obj_ids=np.asarray(batch.obj_ids),
            batch_im_ids=np.arange(args.batch_size),
        )
        results = estimator.run_inference_pipeline(obs, det)
        final = results["final"]
        # final is top-1 per group: recover per-image rows
        keep = np.asarray(final.valid)
        poses = np.asarray(final.poses)[keep]
        im_ids = np.asarray(final.batch_im_ids)[keep]
        gt = np.asarray(batch.TCO_gt)[im_ids]
        T = jnp.asarray(poses)
        G = jnp.asarray(gt)
        all_log6.append(np.asarray(log_SE3_norm(T, G)))
        all_rot.append(
            np.asarray(geodesic_distance(T[:, :3, :3], G[:, :3, :3]))
            * 180.0 / np.pi
        )
        all_trans.append(
            np.asarray(jnp.linalg.norm(T[:, :3, 3] - G[:, :3, 3], axis=-1))
        )
        from happypose_tpu.lib3d.distances import compute_ADD_L1_loss

        inst_k = bm.select(jnp.asarray(np.asarray(batch.obj_ids)[im_ids]))
        all_add.append(
            np.asarray(
                compute_ADD_L1_loss(G, T, inst_k.points, inst_k.points_mask)
            )
        )
        logger.info(
            f"batch {b}: median log6 "
            f"{float(np.median(all_log6[-1])):.3f}"
        )

    log6 = np.concatenate(all_log6)
    summary = {
        "n_scenes": int(log6.size),
        "tolerance": 0.3,
        "frac_within_tolerance": float((log6 < 0.3).mean()),
        "log6_median": float(np.median(log6)),
        "log6_mean": float(log6.mean()),
        "rot_deg_median": float(np.median(np.concatenate(all_rot))),
        "trans_m_median": float(np.median(np.concatenate(all_trans))),
        "add_m_median": float(np.median(np.concatenate(all_add))),
        "so3_grid": args.so3_grid,
        "n_hypotheses": args.n_hypotheses,
        "n_refiner_iterations": args.n_refiner_iterations,
        "coarse": args.coarse_dir is not None,
    }
    logger.info(json.dumps(summary, indent=1))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    from happypose_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
