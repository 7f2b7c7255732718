"""Train a pose model (refiner or coarse classifier), data-parallel.

Parity targets: /root/reference/happypose/pose_estimators/megapose/training/
train_megapose.py:96-459 and cosypose/training/train_pose.py:252-520 —
distributed training loop, epoch metrics reduction, rank-0 JSON-lines log +
checkpoints, resume.

Data: `--data synth` trains on on-device synthetic scenes (no downloads
needed); `--data <bop_split_dir>` trains on a BOP split via PoseDataset.

Usage:
  python -m happypose_tpu.scripts.run_pose_training \
      --run-dir /tmp/run --model-type refiner --data synth \
      --epochs 2 --epoch-size 64 --batch-size 8
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from happypose_tpu.utils.logging import get_logger

logger = get_logger(__name__)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--model-type", choices=["refiner", "coarse"],
                   default="refiner")
    p.add_argument("--backbone", default="wide_resnet18")
    p.add_argument("--data", default="synth")
    p.add_argument("--models-dir", type=Path, default=None,
                   help="BOP models dir (required for --data <bop_dir>)")
    p.add_argument("--synth-set", default="debug",
                   choices=["debug", "textured", "mesh_only"],
                   help="synthetic mesh registry (textured = procedural "
                        "textures, the rotation-learning data fix)")
    p.add_argument("--mesh-files", type=Path, nargs="*", default=None,
                   help="extra mesh files added to the synth registry "
                        "(e.g. a BOP PLY; auto mm->m, procedural texture "
                        "when UVs exist)")
    p.add_argument("--max-faces", type=int, default=0,
                   help="decimate synth meshes above this face count "
                        "(keeps renders on the fast tile-major kernel)")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--epoch-size", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--n-warmup-steps", type=int, default=50)
    p.add_argument("--n-iterations", type=int, default=1)
    p.add_argument("--coarse-negatives", choices=["grid", "multiview"],
                   default="grid",
                   help="coarse-classifier negatives: random SO(3)-grid "
                        "rotations sharing the positive's translation (the "
                        "pipeline's actual scoring task; round-5 default) "
                        "or the reference's sphere-26 multiview protocol")
    p.add_argument("--coarse-hypotheses", type=int, default=8,
                   help="hypotheses per sample for --coarse-negatives grid")
    p.add_argument("--add-iteration-epoch-interval", type=int, default=0,
                   help="add one refiner iteration every K epochs (up to "
                        "--n-iterations-max; curriculum of the reference, "
                        "train_megapose.py:308-314)")
    p.add_argument("--n-iterations-max", type=int, default=3)
    p.add_argument("--render-size", type=int, nargs=2, default=(120, 160))
    p.add_argument("--image-size", type=int, nargs=2, default=(120, 160))
    p.add_argument("--eval-every", type=int, default=0,
                   help="epochs between in-training refiner evals (0=off)")
    p.add_argument("--save-every", type=int, default=10,
                   help="epochs between checkpoint writes (a 134MB state "
                        "costs seconds of wall per write through "
                        "device_get + 2x disk; the final epoch always "
                        "saves; 0 = final epoch only)")
    p.add_argument("--no-augment", action="store_true",
                   help="disable observed-image jitter augmentation in "
                        "split training (PoseDataset rgb_jitter)")
    p.add_argument("--stream", action="store_true",
                   help="stream training frames from WDS tar shards "
                        "(<data>/*.tar or <data>/wds/) through a chunked "
                        "device cache + host prefetch thread — removes "
                        "the whole-split HBM cap (ref: train_megapose "
                        "webdataset pipeline)")
    p.add_argument("--stream-chunk", type=int, default=512,
                   help="frames per streamed device chunk")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init-from", type=Path, default=None,
                   help="warm-start weights from another run dir's "
                        "checkpoint (the reference's run_id_pretrain, "
                        "train_megapose.py:245-249); optimizer state and "
                        "epoch counter start fresh")
    p.add_argument("--dp", action="store_true", help="data-parallel mesh")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="capture a jax profiler trace of the first epoch "
                        "to <run-dir>/trace (open with xprof/perfetto)")
    args = p.parse_args(argv)

    from happypose_tpu.models import PosePredictor, PosePredictorConfig
    from happypose_tpu.parallel import make_mesh
    from happypose_tpu.training import (
        TrainState, make_optimizer, make_train_step,
    )
    from happypose_tpu.training.forward_loss import (
        make_coarse_grid_loss_fn, make_coarse_loss_fn, make_refiner_loss_fn,
    )
    from happypose_tpu.training.trainer import split_batch_for_mesh
    from happypose_tpu.utils.checkpoint import (
        CHECKPOINT, load_checkpoint, save_checkpoint,
    )

    mesh = make_mesh() if args.dp else None

    # ---- data ----
    if args.data == "synth":
        from happypose_tpu.training.synth_data import (
            make_synth_batch, make_synth_mesh_db,
        )

        db = make_synth_mesh_db(
            args.synth_set, args.mesh_files, max_faces=args.max_faces
        )
        mesh_db = db
        K1 = jnp.asarray(
            [[300.0, 0, args.image_size[1] / 2],
             [0, 300.0, args.image_size[0] / 2], [0, 0, 1.0]]
        )

        def batches(epoch):
            for i in range(args.epoch_size // args.batch_size):
                yield make_synth_batch(
                    jax.random.PRNGKey(epoch * 10000 + i), assets, K1,
                    n_objects=len(db.labels), batch_size=args.batch_size,
                    resolution=tuple(args.image_size),
                )
    else:
        from happypose_tpu.datasets.bop import BOPObjectDataset

        obj_ds = BOPObjectDataset(args.models_dir)
        mesh_db = obj_ds.mesh_db
        data_dir = Path(args.data)
        wds_dir = (
            data_dir if list(data_dir.glob("*.tar"))
            else data_dir / "wds" if (data_dir / "wds").is_dir()
            else None
        )
        if args.stream and wds_dir is None:
            raise SystemExit(
                f"--stream: no WDS *.tar shards under {data_dir} "
                f"(or {data_dir / 'wds'})"
            )
        if wds_dir is not None and args.stream:
            # streaming WDS input: chunked device cache + host prefetch
            # thread — the reference's webdataset DataLoader path
            # (train_megapose.py:96-229), unbounded dataset size
            from happypose_tpu.datasets.streaming_pose_dataset import (
                StreamingPoseDataset,
            )

            pose_ds = StreamingPoseDataset(
                str(wds_dir), mesh_db, batch_size=args.batch_size,
                resolution=tuple(args.image_size),
                chunk_frames=args.stream_chunk,
                apply_rgb_augmentation=not args.no_augment,
            )
            logger.info(f"streaming WDS input from {wds_dir}")
        else:
            from happypose_tpu.datasets.bop import BOPSceneDataset
            from happypose_tpu.datasets.pose_dataset import PoseDataset

            scene_ds = BOPSceneDataset(args.data, cache_frames=True)
            pose_ds = PoseDataset(
                scene_ds, mesh_db, batch_size=args.batch_size,
                resolution=tuple(args.image_size),
                # uint8 240x320 frames are 230 KB each -> 4096 frames ~
                # 1 GB of device memory; the device cache removes
                # the 30 MB/batch host->device staging (TRAINING_NOTES r2)
                device_cache=len(scene_ds) <= 4400,
                apply_rgb_augmentation=not args.no_augment,
            )
        it = iter(pose_ds)

        def batches(epoch):
            for _ in range(args.epoch_size // args.batch_size):
                yield next(it)

    assets = mesh_db.render_assets()
    bm = mesh_db.batched(n_points=256)

    # ---- model ----
    cfg = PosePredictorConfig(
        backbone=args.backbone,
        render_size=tuple(args.render_size),
        compute_dtype="bfloat16" if args.bf16 else "float32",
        predict_pose_update=args.model_type == "refiner",
        predict_rendered_views_logits=args.model_type == "coarse",
        bn_axis_name="dp" if mesh is not None else None,
    )
    model = PosePredictor(cfg)

    def build_loss(n_iterations):
        if args.model_type == "refiner":
            return make_refiner_loss_fn(
                model, assets, bm, n_iterations=n_iterations
            )
        if args.coarse_negatives == "grid":
            return make_coarse_grid_loss_fn(
                model, assets, bm, n_hypotheses=args.coarse_hypotheses
            )
        return make_coarse_loss_fn(model, assets, bm)

    loss_fn = build_loss(args.n_iterations)

    example = next(iter(batches(0)))
    # jitted init: one compiled program instead of op-by-op dispatch
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), example.images, example.K, example.obj_ids,
        example.TCO_gt, assets, bm.select(example.obj_ids),
    )
    total_steps = args.epochs * (args.epoch_size // args.batch_size)
    tx = make_optimizer(
        lr=args.lr, n_warmup_steps=args.n_warmup_steps,
        total_steps=total_steps,
    )
    if args.init_from is not None:
        variables, pre_epoch = load_checkpoint(args.init_from, variables)
        logger.info(
            f"warm-started weights from {args.init_from} "
            f"(epoch {pre_epoch})"
        )
    state = TrainState.create(variables, tx)
    start_epoch = 0
    if args.resume and (args.run_dir / CHECKPOINT).exists():
        state, start_epoch = load_checkpoint(args.run_dir, state)
        logger.info(f"resumed from epoch {start_epoch}")

    step_fn = make_train_step(loss_fn, tx, mesh=mesh)
    cur_iters = args.n_iterations

    # in-training eval (reference train_pose.py builds eval bundles): refine
    # noised gt on a fixed held-out batch, report pose errors
    eval_fn = None
    if args.eval_every and args.model_type == "refiner":
        from happypose_tpu.lib3d.rotations import geodesic_distance
        from happypose_tpu.lib3d.transforms import add_pose_noise

        eval_batch = next(iter(batches(999983)))
        eval_rng = jax.random.PRNGKey(424242)

        @jax.jit
        def eval_fn(variables):
            TCO_init = add_pose_noise(eval_rng, eval_batch.TCO_gt)
            inst = bm.select(eval_batch.obj_ids)
            out = model.apply(
                variables, eval_batch.images, eval_batch.K,
                eval_batch.obj_ids, TCO_init, assets, inst, n_iterations=2,
            )
            T = out.TCO_output[-1]
            gt = eval_batch.TCO_gt
            return {
                "eval_trans_err": jnp.mean(
                    jnp.linalg.norm(T[:, :3, 3] - gt[:, :3, 3], axis=-1)
                ),
                "eval_rot_err_deg": jnp.mean(
                    geodesic_distance(T[:, :3, :3], gt[:, :3, :3])
                ) * 180.0 / jnp.pi,
            }

    args.run_dir.mkdir(parents=True, exist_ok=True)
    log_path = args.run_dir / "log.txt"
    for epoch in range(start_epoch, args.epochs):
        if args.add_iteration_epoch_interval and args.model_type == "refiner":
            want = min(
                args.n_iterations + epoch // args.add_iteration_epoch_interval,
                args.n_iterations_max,
            )
            if want != cur_iters:
                cur_iters = want
                logger.info(f"curriculum: n_iterations -> {cur_iters}")
                step_fn = make_train_step(build_loss(cur_iters), tx, mesh=mesh)
        t0 = time.time()
        epoch_metrics = []
        from happypose_tpu.utils.profiling import device_trace

        trace_dir = (
            args.run_dir / "trace"
            if (args.profile and epoch == start_epoch)
            else None
        )
        with device_trace(trace_dir):
            for i, batch in enumerate(batches(epoch)):
                rng = jax.random.PRNGKey(epoch * 100003 + i)
                if mesh is not None:
                    batch = split_batch_for_mesh(batch, mesh)
                state, metrics = step_fn(state, batch, rng)
                epoch_metrics.append(
                    {k: float(v) for k, v in metrics.items()}
                )
        avg = {
            k: float(np.mean([m[k] for m in epoch_metrics]))
            for k in epoch_metrics[0]
        }
        avg.update(epoch=epoch, time=time.time() - t0)
        if eval_fn is not None and (epoch + 1) % args.eval_every == 0:
            avg.update(
                {k: float(v) for k, v in eval_fn(state.variables).items()}
            )
        with open(log_path, "a") as f:
            f.write(json.dumps(avg) + "\n")
        logger.info(f"epoch {epoch}: loss={avg['loss']:.4f} "
                    f"({avg['time']:.1f}s)")
        if (args.save_every and (epoch + 1) % args.save_every == 0) \
                or epoch + 1 == args.epochs:
            save_checkpoint(args.run_dir, state, epoch + 1,
                            config=vars(args) | {"cfg": str(cfg)})
    return 0


if __name__ == "__main__":
    from happypose_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
