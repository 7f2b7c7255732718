"""Standalone held-out evaluation of the coarse hypothesis classifier.

Parity target: the coarse model's role in the pipeline — score
detection x SO(3)-grid hypotheses and keep top-K
(/root/reference/happypose/pose_estimators/megapose/models/pose_rigid.py:96-181
views_logits head; inference/pose_estimator.py:327-485). The pipeline only
needs a near-true viewpoint to SURVIVE into the top-K, so the quality
metric here is symmetry-aware rotation recall@K: for each GT object
(GT bbox detection), score the full grid, and check whether any of the
top-K hypotheses is within --rot-thresh degrees of the GT rotation (min
over the object's symmetries). `best_achievable` reports the grid's own
covering error on the same samples — the floor no classifier can beat.

Usage:
  python -m happypose_tpu.scripts.eval_coarse_checkpoint \
      --coarse-dir <run_dir> --split-dir <bop_split> --models-dir <models> \
      --out eval_coarse.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from happypose_tpu.utils.logging import get_logger

logger = get_logger(__name__)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--coarse-dir", type=Path, required=True)
    p.add_argument("--split-dir", type=Path, required=True)
    p.add_argument("--models-dir", type=Path, required=True)
    p.add_argument("--so3-grid", type=int, default=576)
    p.add_argument("--n-frames", type=int, default=0, help="0 = all")
    p.add_argument("--rot-thresh-deg", type=float, default=30.0)
    p.add_argument("--min-visib", type=float, default=0.3)
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)

    import dataclasses

    import jax
    import jax.numpy as jnp

    from happypose_tpu.datasets.bop import BOPObjectDataset, BOPSceneDataset
    from happypose_tpu.inference.pose_estimator import PoseEstimator
    from happypose_tpu.inference.types import (
        DetectionBatch, InferenceConfig, ObservationBatch,
    )
    from happypose_tpu.models import PosePredictorConfig

    obj_ds = BOPObjectDataset(args.models_dir)
    mesh_db = obj_ds.mesh_db
    scene_ds = BOPSceneDataset(args.split_dir)
    c = json.loads((args.coarse_dir / "config.json").read_text())
    coarse_cfg = PosePredictorConfig(
        backbone=c.get("backbone", "wide_resnet18"),
        render_size=tuple(c.get("render_size", (120, 160))),
        compute_dtype="bfloat16" if c.get("bf16") else "float32",
        predict_pose_update=False,
        predict_rendered_views_logits=True,
    )
    icfg = dataclasses.replace(
        InferenceConfig(), SO3_grid_size=args.so3_grid,
    )
    assets = mesh_db.render_assets()
    meshes = mesh_db.batched(n_points=256)

    from happypose_tpu.models import PosePredictor
    from happypose_tpu.utils.checkpoint import load_checkpoint

    model = PosePredictor(coarse_cfg)
    B = 1
    img0 = jnp.zeros((B, 3, 240, 320))
    K0 = jnp.broadcast_to(
        jnp.asarray([[600.0, 0, 160], [0, 600.0, 120], [0, 0, 1]]), (B, 3, 3)
    )
    ids0 = jnp.zeros((B,), jnp.int32)
    T0 = jnp.broadcast_to(jnp.eye(4), (B, 4, 4)).at[:, 2, 3].set(0.5)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(1), img0, K0, ids0, T0, assets,
        meshes.select(ids0),
    )
    variables, _ = load_checkpoint(args.coarse_dir, variables)
    estimator = PoseEstimator(
        refiner=None, coarse=(model, variables), assets=assets,
        meshes=meshes, cfg=icfg,
    )
    M = int(estimator.SO3_grid.shape[0])
    grid_R = np.asarray(estimator.SO3_grid)  # [M, 3, 3]

    n_frames = len(scene_ds) if args.n_frames == 0 else min(
        args.n_frames, len(scene_ds)
    )
    label_to_id = mesh_db.label_to_id

    # symmetry rotations per mesh-db object id
    sym_R, sym_mask = {}, {}
    bm_all = meshes.select(
        jnp.arange(len(mesh_db.labels), dtype=jnp.int32)
    )
    sym_all = np.asarray(bm_all.symmetries)[..., :3, :3]  # [n_obj, S, 3, 3]
    symm_all = np.asarray(bm_all.symmetries_mask)

    per_det = []
    for fi in range(n_frames):
        obs = scene_ds[fi]
        if obs.obj_labels is None:
            continue
        keep = [
            j for j, label in enumerate(obs.obj_labels)
            if label in label_to_id
            and (obs.visib_fract is None
                 or obs.visib_fract[j] >= args.min_visib)
        ]
        if not keep:
            continue
        D = len(keep)
        img = jnp.asarray(
            np.moveaxis(obs.rgb.astype(np.float32) / 255.0, -1, 0)
        )[None]
        ob = ObservationBatch(rgb=img, K=jnp.asarray(obs.K)[None])
        det = DetectionBatch(
            boxes=jnp.asarray(
                np.stack([obs.bboxes[j] for j in keep]).astype(np.float32)
            ),
            obj_ids=jnp.asarray(
                [label_to_id[obs.obj_labels[j]] for j in keep], jnp.int32
            ),
            batch_im_ids=jnp.zeros((D,), jnp.int32),
            instance_ids=jnp.arange(D, dtype=jnp.int32),
            scores=jnp.ones((D,), jnp.float32),
            valid=jnp.ones((D,), bool),
        )
        # pad to a fixed detection budget: ONE compiled coarse program for
        # the whole split (per-frame D variation would compile one program
        # per distinct D)
        Dp = 8
        det = DetectionBatch.pad(det, Dp)
        coarse = estimator.forward_coarse_jit(ob, det)
        logits = np.asarray(coarse.coarse_logits).reshape(Dp, M)[:D]

        for d, j in enumerate(keep):
            R_gt = obs.TWO[j][:3, :3]
            oid = label_to_id[obs.obj_labels[j]]
            Rs = sym_all[oid][symm_all[oid]]  # [S, 3, 3]
            # symmetry-aware geodesic distance of every grid rotation
            # trace(R_hyp^T (R_gt Rs)) -> angle; min over symmetries
            R_eq = np.einsum("ij,sjk->sik", R_gt, Rs)  # [S, 3, 3]
            tr = np.einsum("mji,sjk->msik", grid_R, R_eq)
            tr = np.trace(tr, axis1=2, axis2=3)  # [M, S]
            ang = np.degrees(
                np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))
            ).min(axis=1)  # [M]
            order = np.argsort(-logits[d])
            per_det.append({
                "frame": fi,
                "label": obs.obj_labels[j],
                "best_achievable_deg": float(ang.min()),
                "top1_deg": float(ang[order[0]]),
                "top5_deg": float(ang[order[:5]].min()),
                "rank_of_best": int(np.where(
                    order == int(np.argmin(ang)))[0][0]),
            })
        if (fi + 1) % 16 == 0:
            logger.info(f"{fi + 1}/{n_frames} frames, "
                        f"{len(per_det)} detections")

    t = args.rot_thresh_deg
    arr = lambda k: np.asarray([r[k] for r in per_det])
    summary = {
        "n_detections": len(per_det),
        "so3_grid": M,
        "rot_thresh_deg": t,
        "best_achievable_med_deg": float(np.median(arr("best_achievable_deg"))),
        "top1_recall": float(np.mean(arr("top1_deg") < t)),
        "top5_recall": float(np.mean(arr("top5_deg") < t)),
        "top1_med_deg": float(np.median(arr("top1_deg"))),
        "top5_med_deg": float(np.median(arr("top5_deg"))),
        "rank_of_best_med": float(np.median(arr("rank_of_best"))),
    }
    logger.info(json.dumps(summary, indent=1))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"summary": summary, "per_detection": per_det}, indent=1
        ))
    return 0


if __name__ == "__main__":
    from happypose_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
