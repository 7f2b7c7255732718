"""Measure refinement quality of a trained refiner checkpoint.

Generates held-out synthetic scenes, perturbs the ground-truth poses with
the training noise model, refines, and reports pose errors before/after
(translation, rotation, ADD, and the reference's `log6` magnitude — its
end-to-end test metric, tests/test_cosypose_inference.py:119).

Usage:
  python -m happypose_tpu.scripts.eval_refiner_checkpoint \
      --run-dir /tmp/refiner --n-batches 8 --n-iterations 3
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
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--n-batches", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--n-iterations", type=int, default=3)
    p.add_argument("--image-size", type=int, nargs=2, default=(120, 160))
    p.add_argument("--seed", type=int, default=12345)
    p.add_argument("--split-dir", type=Path, default=None,
                   help="evaluate on a BOP split (held-out recorded "
                        "frames) instead of synth scenes")
    p.add_argument("--models-dir", type=Path, default=None,
                   help="BOP models dir (required with --split-dir)")
    p.add_argument("--out", type=Path, default=None,
                   help="also write the summary json here")
    p.add_argument("--init-mode", choices=["noise", "grid"], default="noise",
                   help="initial poses: gt + training noise (the training "
                        "distribution) or nearest-SO(3)-grid rotation with "
                        "autodepth translation from the projected gt bbox "
                        "(the coarse->refiner hand-off distribution the "
                        "pipeline actually feeds)")
    p.add_argument("--so3-grid", type=int, default=576)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from happypose_tpu.lib3d.rotations import geodesic_distance, log_SE3_norm
    from happypose_tpu.lib3d.distances import compute_ADD_L1_loss
    from happypose_tpu.lib3d.transforms import add_pose_noise
    from happypose_tpu.models import PosePredictor, PosePredictorConfig
    from happypose_tpu.training.synth_data import (
        make_synth_batch, make_synth_mesh_db,
    )

    cfg_saved = json.loads((args.run_dir / "config.json").read_text())

    split_batches = None
    if args.split_dir is not None:
        # held-out BOP split: refine noised GT of recorded frames
        from happypose_tpu.datasets.bop import (
            BOPObjectDataset, BOPSceneDataset,
        )
        from happypose_tpu.datasets.pose_dataset import PoseDataset

        db = BOPObjectDataset(args.models_dir).mesh_db
        scene_ds = BOPSceneDataset(args.split_dir, cache_frames=True)
        pose_ds = PoseDataset(
            scene_ds, db, batch_size=args.batch_size,
            resolution=tuple(args.image_size),
            apply_rgb_augmentation=False, seed=args.seed,
        )
        it = iter(pose_ds)
        split_batches = lambda _b: next(it)
    else:
        # rebuild the exact mesh registry the checkpoint was trained on
        db = make_synth_mesh_db(
            cfg_saved.get("synth_set", "debug"),
            cfg_saved.get("mesh_files") or None,
            max_faces=int(cfg_saved.get("max_faces") or 0),
        )
    assets = db.render_assets()
    bm = db.batched(n_points=256)
    H, W = args.image_size
    K1 = jnp.asarray([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1.0]])

    cfg = PosePredictorConfig(
        backbone=cfg_saved.get("backbone", "wide_resnet18"),
        render_size=tuple(cfg_saved.get("render_size", (120, 160))),
        compute_dtype="bfloat16" if cfg_saved.get("bf16") else "float32",
    )
    model = PosePredictor(cfg)
    if split_batches is not None:
        batch0 = split_batches(0)
    else:
        batch0 = make_synth_batch(
            jax.random.PRNGKey(0), assets, K1, n_objects=len(db.labels),
            batch_size=args.batch_size, resolution=(H, W),
        )
    inst0 = bm.select(batch0.obj_ids)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), batch0.images, batch0.K, batch0.obj_ids,
        batch0.TCO_gt, assets, inst0,
    )
    # restore only model variables from the training state
    from happypose_tpu.utils.checkpoint import load_checkpoint

    variables, _ = load_checkpoint(args.run_dir, {
        "params": variables["params"],
        "batch_stats": variables.get("batch_stats", {}),
    })

    grid_R = None
    if args.init_mode == "grid":
        from happypose_tpu.lib3d.so3_grid import load_SO3_grid

        grid_R = jnp.asarray(load_SO3_grid(args.so3_grid))

    @jax.jit
    def refine(batch, rng):
        inst = bm.select(batch.obj_ids)
        if args.init_mode == "grid":
            from happypose_tpu.lib3d.pose_init import (
                TCO_init_from_boxes_autodepth_with_R,
            )
            from happypose_tpu.lib3d.transforms import transform_pts

            # nearest grid rotation = the best hypothesis the coarse stage
            # can hand the refiner (plain angle, so the before/after
            # geodesic metrics below stay directly interpretable)
            tr = jnp.einsum("mji,bji->bm", grid_R, batch.TCO_gt[:, :3, :3])
            ang = jnp.arccos(jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0))  # [B, M]
            R_init = grid_R[jnp.argmin(ang, axis=-1)]
            # autodepth translation from the projected gt bbox
            pts_c = transform_pts(batch.TCO_gt, inst.points)  # [B, P, 3]
            uv = jnp.einsum("bij,bpj->bpi", batch.K, pts_c)
            uv = uv[..., :2] / jnp.maximum(uv[..., 2:3], 1e-6)
            big = 1e6
            mask = inst.points_mask[..., None]
            boxes = jnp.concatenate([
                jnp.min(jnp.where(mask, uv, big), axis=1),
                jnp.max(jnp.where(mask, uv, -big), axis=1),
            ], axis=-1)
            TCO_init = TCO_init_from_boxes_autodepth_with_R(
                boxes, inst.points, batch.K, R_init, inst.points_mask
            )
        else:
            TCO_init = add_pose_noise(rng, batch.TCO_gt)
        out = model.apply(
            variables, batch.images, batch.K, batch.obj_ids, TCO_init,
            assets, inst, n_iterations=args.n_iterations,
        )
        return TCO_init, out.TCO_output[-1]

    stats = {"t_before": [], "t_after": [], "r_before": [], "r_after": [],
             "log6_before": [], "log6_after": [], "add_before": [],
             "add_after": []}
    for b in range(args.n_batches):
        rngs = jax.random.split(jax.random.PRNGKey(args.seed + b), 2)
        if split_batches is not None:
            batch = split_batches(b)
        else:
            batch = make_synth_batch(
                rngs[0], assets, K1, n_objects=len(db.labels),
                batch_size=args.batch_size, resolution=(H, W),
            )
        TCO_init, TCO_ref = refine(batch, rngs[1])
        gt = batch.TCO_gt
        inst = bm.select(batch.obj_ids)
        for tag, T in (("before", TCO_init), ("after", TCO_ref)):
            stats[f"t_{tag}"].append(
                np.asarray(jnp.linalg.norm(T[:, :3, 3] - gt[:, :3, 3], axis=-1))
            )
            stats[f"r_{tag}"].append(
                np.asarray(
                    geodesic_distance(T[:, :3, :3], gt[:, :3, :3]) * 180 / np.pi
                )
            )
            stats[f"log6_{tag}"].append(np.asarray(log_SE3_norm(T, gt)))
            stats[f"add_{tag}"].append(
                np.asarray(
                    compute_ADD_L1_loss(gt, T, inst.points, inst.points_mask)
                )
            )
    summary = {k: float(np.concatenate(v).mean()) for k, v in stats.items()}
    summary.update({
        f"median_{k}": float(np.median(np.concatenate(v)))
        for k, v in stats.items()
    })
    summary["n_samples"] = args.n_batches * args.batch_size
    summary["n_iterations"] = args.n_iterations
    summary["data"] = str(args.split_dir) if args.split_dir else "synth"
    summary["init_mode"] = args.init_mode
    logger.info(json.dumps(summary, indent=1))
    (args.run_dir / "refiner_eval.json").write_text(json.dumps(summary))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    from happypose_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
