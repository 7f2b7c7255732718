"""Multi-view scene reconstruction for a user-provided scenario.

Parity target: /root/reference/happypose/pose_estimators/cosypose/cosypose/
scripts/run_custom_scenario.py:110-231 — given single-view pose candidates
(BOP csv), per-view camera intrinsics (scene_camera.json), and the object
models, run CosyPose stage 2+3 (RANSAC candidate matching + object-level
bundle adjustment), apply 3D NMS, and write the fused scene + reprojected
per-view poses.

Scenario dir layout (same as the reference's custom_scenarios/<id>/):
  candidates.csv      BOP-format csv: scene_id, im_id, obj_id, score, R, t
  scene_camera.json   {"<view_id>": {"cam_K": [9 floats]}, ...}
  models/             BOP models dir (obj_XXXXXX.ply + models_info.json)

Outputs in <scenario>/results/:
  scene.json          {"objects": [{label, score, TWO}], "cameras":
                       [{view_id, TWC, K}]}
  poses.csv           BOP csv of the fused objects reprojected per view

Usage:
  python -m happypose_tpu.scripts.run_custom_scenario \
      --scenario <dir> [--sv-score-th 0.3] [--nms-th 0.04]
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
    p.add_argument("--scenario", type=Path, required=True)
    p.add_argument("--sv-score-th", type=float, default=0.3,
                   help="score filter on single-view candidates")
    p.add_argument("--n-symmetries-rot", type=int, default=64,
                   help="discretization of continuous symmetries")
    p.add_argument("--ransac-n-iter", type=int, default=200)
    p.add_argument("--ransac-dist-threshold", type=float, default=0.02)
    p.add_argument("--n-min-inliers", type=int, default=3)
    p.add_argument("--ba-n-iter", type=int, default=10)
    p.add_argument("--ba-solver", choices=["dense", "schur"], default="dense")
    p.add_argument("--nms-th", type=float, default=0.04)
    args = p.parse_args(argv)

    from happypose_tpu.datasets.bop import BOPObjectDataset
    from happypose_tpu.evaluation.bop_export import load_bop_csv, save_bop_csv
    from happypose_tpu.multiview.ransac import MultiviewCandidates
    from happypose_tpu.multiview.scene_predictor import (
        MultiviewScenePredictor, nms3d,
    )

    cand = load_bop_csv(args.scenario / "candidates.csv")
    scene_ids = np.unique(cand["scene_ids"])
    if len(scene_ids) != 1:
        p.error("candidates.csv must contain a single scene")
    view_ids = np.unique(cand["view_ids"])
    logger.info(f"{len(cand['poses'])} candidates in {len(view_ids)} views")

    cameras = json.loads((args.scenario / "scene_camera.json").read_text())
    K = np.stack(
        [
            np.asarray(cameras[str(int(v))]["cam_K"], np.float64).reshape(3, 3)
            for v in view_ids
        ]
    )

    obj_ds = BOPObjectDataset(args.scenario / "models")
    mesh_db = obj_ds.mesh_db
    meshes = mesh_db.batched(n_points=256, n_sym=args.n_symmetries_rot)
    labels = [f"obj_{int(o):06d}" for o in cand["obj_ids"]]
    obj_ids = mesh_db.ids_of(labels)
    # dense per-candidate view index for the predictor
    vmap = {int(v): i for i, v in enumerate(view_ids)}
    cands = MultiviewCandidates(
        poses=cand["poses"].astype(np.float32),
        view_ids=np.asarray([vmap[int(v)] for v in cand["view_ids"]]),
        obj_ids=np.asarray(obj_ids),
        scores=cand["scores"].astype(np.float32),
        K=K.astype(np.float32),
    )

    predictor = MultiviewScenePredictor(
        meshes=meshes,
        score_th=args.sv_score_th,
        n_ransac_iter=args.ransac_n_iter,
        dist_threshold=args.ransac_dist_threshold,
        n_min_inliers=args.n_min_inliers,
        ba_n_iterations=args.ba_n_iter,
        ba_solver=args.ba_solver,
    )
    state = predictor.predict_scene_state(cands, K.astype(np.float32))
    if state is None:
        logger.info("no multi-view consistent objects found")
        return 1

    keep = nms3d(state.TWO, state.obj_scores, th=args.nms_th)
    logger.info(
        f"reconstructed {len(keep)} objects over {len(state.view_ids)} views "
        f"(ba_loss={state.ba_loss:.4f})"
    )

    results = args.scenario / "results"
    results.mkdir(exist_ok=True)
    scene = {
        "objects": [
            {
                "label": mesh_db.labels[int(state.obj_ids[i])],
                "score": float(state.obj_scores[i]),
                "TWO": state.TWO[i].tolist(),
            }
            for i in keep
        ],
        "cameras": [
            {
                "view_id": int(view_ids[int(v)]),
                "TWC": state.TWC[i].tolist(),
                "K": K[int(v)].tolist(),
            }
            for i, v in enumerate(state.view_ids)
        ],
    }
    (results / "scene.json").write_text(json.dumps(scene, indent=1))

    # reproject fused objects into each view -> BOP csv
    rows_T, rows_obj, rows_scene, rows_view, rows_score = [], [], [], [], []
    per_view = state.predictions_per_view()
    for v_dense, pred in per_view.items():
        for i in keep:
            rows_T.append(pred["TCO"][i])
            label = mesh_db.labels[int(pred["obj_ids"][i])]
            rows_obj.append(int(label.split("_")[-1]))
            rows_scene.append(int(scene_ids[0]))
            rows_view.append(int(view_ids[int(v_dense)]))
            rows_score.append(float(pred["scores"][i]))
    save_bop_csv(
        results / "poses.csv",
        np.asarray(rows_T), np.asarray(rows_obj), np.asarray(rows_scene),
        np.asarray(rows_view), np.asarray(rows_score),
    )
    logger.info(f"wrote {results / 'scene.json'} and {results / 'poses.csv'}")
    return 0


if __name__ == "__main__":
    from happypose_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
