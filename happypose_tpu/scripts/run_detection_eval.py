"""Standalone detector evaluation on a BOP split: mAP + COCO export.

Parity target: /root/reference/happypose/pose_estimators/cosypose/cosypose/
scripts/run_detection_eval.py — evaluate a trained detector over a scene
dataset, report AP/mAP@IoU against the GT boxes, and export the raw
detections (COCO-format json, the `convert_results_to_coco` analog).

Usage:
  python -m happypose_tpu.scripts.run_detection_eval \
      --split-dir <bop>/test --models-dir <bop>/models \
      --detector-run /runs/det --out-dir /tmp/det_eval
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
    p.add_argument("--split-dir", type=Path, required=True)
    p.add_argument("--models-dir", type=Path, required=True)
    p.add_argument("--detector-run", type=Path, required=True)
    p.add_argument("--detection-th", type=float, default=0.3)
    p.add_argument("--iou-threshold", type=float, default=0.5)
    p.add_argument("--min-visib-fract", type=float, default=0.05,
                   help="GT below this visibility doesn't count toward "
                        "recall (matched predictions aren't penalized)")
    p.add_argument("--one-instance-per-class", action="store_true")
    p.add_argument("--max-detections", type=int, default=32)
    p.add_argument("--out-dir", type=Path, required=True)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--n-replicas", type=int, default=1)
    args = p.parse_args(argv)

    from happypose_tpu.datasets.bop import BOPObjectDataset, BOPSceneDataset
    from happypose_tpu.datasets.samplers import DistributedSceneSampler
    from happypose_tpu.evaluation.coco_export import (
        detections_to_coco, save_coco_json,
    )
    from happypose_tpu.evaluation.detection_meters import DetectionMeter
    from happypose_tpu.evaluation.prediction_runner import PredictionRunner
    from happypose_tpu.utils.load_model import load_detector

    obj_ds = BOPObjectDataset(args.models_dir)
    scene_ds = BOPSceneDataset(args.split_dir)
    detector = load_detector(args.detector_run, len(obj_ds.labels))
    logger.info(
        f"{len(scene_ds)} frames, {len(obj_ds.labels)} classes, "
        f"detector from {args.detector_run}"
    )

    # reuse the runner's resolution handling + box back-mapping
    runner = PredictionRunner(
        scene_ds=scene_ds, estimator=None, mesh_db=obj_ds.mesh_db,
        detection_type="detector", detector=detector,
        detection_th=args.detection_th,
        one_instance_per_class=args.one_instance_per_class,
        max_detections=args.max_detections,
    )
    meter = DetectionMeter(
        iou_threshold=args.iou_threshold, visib_gt_min=args.min_visib_fract
    )
    coco = []
    sampler = DistributedSceneSampler(
        len(scene_ds), args.n_replicas, args.rank, shuffle=False
    )
    for idx in sampler:
        obs = scene_ds[idx]
        if obs.obj_labels is None:
            continue
        det = runner._detections_from_detector(obs)
        if det is None:
            boxes = np.zeros((0, 4), np.float32)
            ids = np.zeros((0,), int)
            scores = np.zeros((0,), np.float32)
        else:
            boxes = np.asarray(det.boxes)
            ids = np.asarray(det.obj_ids)
            scores = np.asarray(det.scores)
        meter.add(
            pred_boxes=boxes, pred_labels=ids, pred_scores=scores,
            gt_boxes=obs.bboxes,
            gt_labels=obj_ds.mesh_db.ids_of(obs.obj_labels),
            gt_visib_fract=obs.visib_fract,
        )
        coco.extend(
            detections_to_coco(
                boxes, scores,
                np.asarray(
                    [int(obj_ds.mesh_db.labels[i].split("_")[-1])
                     for i in ids]
                ),
                np.full(len(boxes), obs.scene_id),
                np.full(len(boxes), obs.view_id),
            )
        )

    summary = meter.summary()
    args.out_dir.mkdir(parents=True, exist_ok=True)
    (args.out_dir / f"summary_rank{args.rank}.json").write_text(
        json.dumps(summary, indent=1, default=float)
    )
    save_coco_json(args.out_dir / f"detections_rank{args.rank}.json", coco)
    logger.info(json.dumps(summary, default=float))
    return 0


if __name__ == "__main__":
    from happypose_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
