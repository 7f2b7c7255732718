"""Evaluate a pose pipeline on a BOP split; write metrics + BOP csv.

Parity target: /root/reference/happypose/pose_estimators/megapose/scripts/
run_full_megapose_eval.py:54-231 + evaluation/evaluation.py:79-277 (one
(dataset, detection_type) setting per invocation; multi-process sharding via
--rank/--n-replicas).

Usage:
  python -m happypose_tpu.scripts.run_eval \
      --split-dir <bop>/test --models-dir <bop>/models \
      --model megapose-RGB --detections gt --out-dir /tmp/eval
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np

from happypose_tpu.utils.logging import get_logger

logger = get_logger(__name__)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--split-dir", type=Path, required=True)
    p.add_argument("--models-dir", type=Path, required=True)
    p.add_argument("--model", default="megapose-RGB")
    p.add_argument(
        "--detections", choices=["gt", "detector", "external"], default="gt",
        help="detection source: dataset GT boxes, a trained detector run "
             "(--detector-run), or a BOP-format detections json "
             "(--external-detections) — the reference's detection_type "
             "in {gt, detector, exte}",
    )
    p.add_argument("--detector-run", type=Path, default=None,
                   help="run dir from run_detector_training")
    p.add_argument("--detection-th", type=float, default=0.3)
    p.add_argument("--external-detections", type=Path, default=None,
                   help="BOP-challenge-format detections json (e.g. CNOS)")
    p.add_argument("--targets", type=Path, default=None,
                   help="test_targets_bop19.json — filters external "
                        "detections to the per-frame best per target")
    p.add_argument("--so3-grid", type=int, default=None)
    p.add_argument("--n-refiner-iterations", type=int, default=None)
    p.add_argument("--n-pose-hypotheses", type=int, default=None)
    p.add_argument("--checkpoints", type=Path, default=None,
                   help="dir containing refiner/ and coarse/ run dirs")
    p.add_argument("--out-dir", type=Path, required=True)
    p.add_argument("--bop19", action="store_true",
                   help="also compute official BOP19 VSD/MSSD/MSPD AR "
                        "(VSD needs the split's depth images)")
    p.add_argument("--vsd-render-size", type=int, nargs=2, default=None,
                   metavar=("H", "W"), help="downscale VSD depth renders")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--n-replicas", type=int, default=1)
    p.add_argument("--max-frames", type=int, default=None,
                   help="truncate the split (smoke runs / wall-time bounds)")
    args = p.parse_args(argv)

    from happypose_tpu.datasets.bop import BOPObjectDataset, BOPSceneDataset
    from happypose_tpu.evaluation.bop_export import save_bop_csv
    from happypose_tpu.evaluation.meters import PoseErrorMeter
    from happypose_tpu.evaluation.prediction_runner import (
        PredictionRunner, run_eval,
    )
    from happypose_tpu.utils.load_model import NAMED_MODELS, load_named_model

    obj_ds = BOPObjectDataset(args.models_dir)
    scene_ds = BOPSceneDataset(args.split_dir, load_depth=args.bop19)
    logger.info(f"{len(scene_ds)} frames, {len(obj_ds.labels)} objects")

    if args.model == "from-checkpoints":
        # build the spec from the run dirs' own configs
        from happypose_tpu.utils.load_model import spec_from_checkpoints

        if args.checkpoints is None:
            p.error("--model from-checkpoints requires --checkpoints")
        dirs = {
            kind: args.checkpoints / kind
            for kind in ("refiner", "coarse")
            if (args.checkpoints / kind).exists()
        }
        NAMED_MODELS["from-checkpoints"] = spec_from_checkpoints(dirs)
    spec = NAMED_MODELS[args.model]
    icfg = spec.inference_cfg
    if args.so3_grid:
        icfg = dataclasses.replace(
            icfg, SO3_grid_size=args.so3_grid,
            bsz_images=min(icfg.bsz_images, args.so3_grid),
        )
    if args.n_refiner_iterations:
        icfg = dataclasses.replace(
            icfg, n_refiner_iterations=args.n_refiner_iterations
        )
    if args.n_pose_hypotheses:
        icfg = dataclasses.replace(
            icfg, n_pose_hypotheses=args.n_pose_hypotheses
        )
    NAMED_MODELS[args.model] = dataclasses.replace(spec, inference_cfg=icfg)

    ckpt_dirs = None
    if args.checkpoints:
        ckpt_dirs = {}
        for kind in ("refiner", "coarse"):
            d = args.checkpoints / kind
            if d.exists():
                ckpt_dirs[kind] = d
    estimator = load_named_model(
        args.model, obj_ds.mesh_db, checkpoint_dirs=ckpt_dirs
    )

    detector = None
    external = None
    if args.detections == "detector":
        from happypose_tpu.utils.load_model import load_detector

        if args.detector_run is None:
            p.error("--detections detector requires --detector-run")
        detector = load_detector(args.detector_run, len(obj_ds.labels))
    elif args.detections == "external":
        from happypose_tpu.evaluation.bop_export import (
            keep_best_detections, load_bop_targets, load_external_detections,
        )

        if args.external_detections is None:
            p.error("--detections external requires --external-detections")
        external = load_external_detections(args.external_detections)
        if args.targets:
            external = keep_best_detections(
                external, load_bop_targets(args.targets)
            )
        # PredictionRunner resolves labels via the mesh db
        external = {
            k: {
                "boxes": d["boxes"],
                "labels": d["labels"],
                "scores": d["scores"],
            }
            for k, d in external.items()
        }

    runner = PredictionRunner(
        scene_ds=scene_ds, estimator=estimator, mesh_db=obj_ds.mesh_db,
        detection_type=args.detections, rank=args.rank,
        n_replicas=args.n_replicas, detector=detector,
        detection_th=args.detection_th, external_detections=external,
        max_frames=args.max_frames,
    )
    meter = PoseErrorMeter(
        meshes=estimator.meshes, is_symmetric=obj_ds.is_symmetric
    )
    bop19_ev = None
    if args.bop19:
        from happypose_tpu.evaluation.bop19 import Bop19Evaluator

        bop19_ev = Bop19Evaluator(
            meshes=obj_ds.mesh_db.batched(n_points=512),
            assets=obj_ds.mesh_db.render_assets(),
            vsd_resolution=(
                tuple(args.vsd_render_size) if args.vsd_render_size else None
            ),
        )
    summary = run_eval(runner, meter, bop19_evaluator=bop19_ev)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    (args.out_dir / f"summary_rank{args.rank}.json").write_text(
        json.dumps(summary, indent=1, default=float)
    )
    logger.info(json.dumps(summary, default=float))

    # BOP csv of the final predictions
    preds = runner.get_predictions()["final"]
    if preds:
        poses = np.concatenate([r["poses"] for r in preds])
        save_bop_csv(
            args.out_dir / f"preds_rank{args.rank}.csv",
            poses,
            np.concatenate(
                [[int(obj_ds.mesh_db.labels[i].split("_")[-1])
                  for i in r["obj_ids"]] for r in preds]
            ),
            np.concatenate([[r["scene_id"]] * len(r["poses"]) for r in preds]),
            np.concatenate([[r["view_id"]] * len(r["poses"]) for r in preds]),
            np.concatenate([r["scores"] for r in preds]),
        )
    return 0


if __name__ == "__main__":
    from happypose_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
