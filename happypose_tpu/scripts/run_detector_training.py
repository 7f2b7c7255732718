"""Train the detector on a BOP split (or recorded synthetic data).

Parity target: /root/reference/happypose/pose_estimators/cosypose/cosypose/
training/train_detector.py:119-386 (Mask R-CNN DDP loop); ours trains the
FCOS+mask detector with the same loop shape (epochs, JSON-lines log,
checkpoints, warmup schedule).

Usage:
  python -m happypose_tpu.scripts.run_detector_training \
      --run-dir /tmp/det --split-dir <bop>/test --models-dir <bop>/models \
      --epochs 2 --epoch-size 32 --batch-size 2
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from happypose_tpu.utils.logging import get_logger

logger = get_logger(__name__)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--split-dir", type=Path, required=True)
    p.add_argument("--models-dir", type=Path, default=None)
    p.add_argument("--image-size", type=int, nargs=2, default=(240, 320))
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--epoch-size", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--max-gt", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--fpn-channels", type=int, default=64)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--save-every", type=int, default=5,
                   help="epochs between checkpoint writes (a ResNet50-FPN "
                        "checkpoint is ~120 MB; per-epoch writes cost as "
                        "much wall-clock as the epoch itself); the final "
                        "epoch always saves")
    p.add_argument("--eval-interval", type=int, default=0,
                   help="every N epochs, log detection mAP on a few "
                        "training frames (0 = off); the analog of the "
                        "reference's in-training COCO eval "
                        "(train_detector.py:119-386)")
    p.add_argument("--eval-frames", type=int, default=8)
    p.add_argument("--no-augment", action="store_true",
                   help="disable the observed-image jitter augmentation "
                        "(brightness/contrast/saturation/blur, the "
                        "reference's Pillow pipeline on detector inputs, "
                        "train_detector.py via PoseDataset-style augs)")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import optax

    from happypose_tpu.datasets.bop import BOPObjectDataset, BOPSceneDataset
    from happypose_tpu.datasets.augmentations import crop_resize_to_aspect
    from happypose_tpu.models.detector import DetectorConfig, FCOSDetector
    from happypose_tpu.training.detector_loss import (
        DetectionTargets, detector_loss,
    )
    from happypose_tpu.utils.checkpoint import (
        CHECKPOINT, load_checkpoint, save_checkpoint,
    )

    # cache_frames: decoded-PNG RAM cache — batch building is host-bound
    # without it (TRAINING_NOTES r2)
    scene_ds = BOPSceneDataset(args.split_dir, cache_frames=True)
    if args.models_dir:
        obj_ds = BOPObjectDataset(args.models_dir)
        labels = obj_ds.labels
        label_to_id = obj_ds.mesh_db.label_to_id
    else:
        labels = sorted(
            {l for i in range(len(scene_ds))
             for l in (scene_ds[i].obj_labels or [])}
        )
        label_to_id = {l: i for i, l in enumerate(labels)}
    n_classes = len(labels)
    H, W = args.image_size
    Hm, Wm = H // 4, W // 4  # prototype-mask resolution

    # device frame cache (PoseDataset's trick): stage the whole split's
    # uint8 frames on the device once; per-batch host->device traffic
    # becomes a handful of ints instead of ~7 MB of f32 images
    frames_dev = None
    if len(scene_ds) <= 4400:
        shapes = {scene_ds[i].rgb.shape for i in range(min(len(scene_ds), 4))}
        if len(shapes) == 1:
            # sliced upload: no single ~1 GB host->device transfer
            n = len(scene_ds)
            parts = [
                jax.device_put(np.stack([
                    scene_ds[i].rgb for i in range(s, min(s + 128, n))
                ]))
                for s in range(0, n, 128)
            ]
            frames_dev = jnp.concatenate(parts, axis=0)
            frames_dev.block_until_ready()

    def make_batch(rng):
        imgs, Ks, boxes, lab, valid, fidx = [], [], [], [], [], []
        while len(Ks) < args.batch_size:
            fi = int(rng.randint(len(scene_ds)))
            obs = scene_ds[fi]
            if not obs.obj_labels:
                continue
            if frames_dev is None:
                imgs.append(
                    np.moveaxis(obs.rgb.astype(np.float32) / 255.0, -1, 0)
                )
            else:
                fidx.append(fi)
            Ks.append(obs.K)
            b = np.zeros((args.max_gt, 4), np.float32)
            c = np.zeros((args.max_gt,), np.int32)
            v = np.zeros((args.max_gt,), bool)
            for j, l in enumerate(obs.obj_labels[: args.max_gt]):
                b[j] = obs.bboxes[j]
                c[j] = label_to_id[l]
                v[j] = True
            boxes.append(b)
            lab.append(c)
            valid.append(v)
        if frames_dev is None:
            x = jnp.asarray(np.stack(imgs))
        else:
            sel = frames_dev[jnp.asarray(fidx, jnp.int32)]
            x = jnp.moveaxis(sel.astype(jnp.float32) / 255.0, -1, 1)
        K = jnp.asarray(np.stack(Ks))
        x, K2 = crop_resize_to_aspect(x, K, (H, W))
        # rescale boxes with the crop (uniform scale + offset from K change)
        sx = np.asarray(K2[:, 0, 0] / K[:, 0, 0])
        b = np.stack(boxes)
        # principal point shift gives the crop offset
        offx = np.asarray(K2[:, 0, 2] - K[:, 0, 2] * sx)
        offy = np.asarray(K2[:, 1, 2] - K[:, 1, 2] * sx)
        b[:, :, 0::2] = b[:, :, 0::2] * sx[:, None, None] + offx[:, None, None]
        b[:, :, 1::2] = b[:, :, 1::2] * sx[:, None, None] + offy[:, None, None]
        # coarse box-derived masks at prototype resolution
        m = np.zeros((args.batch_size, args.max_gt, Hm, Wm), bool)
        for i in range(args.batch_size):
            for j in range(args.max_gt):
                if valid[i][j]:
                    x1, y1, x2, y2 = (b[i, j] / 4).astype(int)
                    m[i, j, max(y1, 0) : y2, max(x1, 0) : x2] = True
        targets = DetectionTargets(
            boxes=jnp.asarray(b), labels=jnp.asarray(np.stack(lab)),
            masks=jnp.asarray(m), valid=jnp.asarray(np.stack(valid)),
        )
        return x, targets

    cfg = DetectorConfig(n_classes=n_classes, fpn_channels=args.fpn_channels)
    model = FCOSDetector(cfg)
    rng = np.random.RandomState(0)
    x0, t0 = make_batch(rng)
    variables = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.PRNGKey(0), x0)
    tx = optax.adam(args.lr)
    params = variables["params"]
    bstats = variables.get("batch_stats", {})
    opt_state = tx.init(params)
    state = {"params": params, "batch_stats": bstats, "opt_state": opt_state}
    start_epoch = 0
    if args.resume and (args.run_dir / CHECKPOINT).exists():
        state, start_epoch = load_checkpoint(args.run_dir, state)

    @jax.jit
    def step(state, x, targets):
        def lf(p):
            out, new_state = model.apply(
                {"params": p, "batch_stats": state["batch_stats"]}, x,
                train=True, mutable=["batch_stats"],
            )
            loss, parts = detector_loss(out, targets, n_classes)
            return loss, (parts, new_state["batch_stats"])

        (loss, (parts, bstats)), grads = jax.value_and_grad(
            lf, has_aux=True
        )(state["params"])
        updates, opt_state = tx.update(grads, state["opt_state"])
        params = optax.apply_updates(state["params"], updates)
        return (
            {"params": params, "batch_stats": bstats, "opt_state": opt_state},
            loss, parts,
        )

    eval_forward = jax.jit(lambda v, xx: model.apply(v, xx, train=False))

    def eval_map(state) -> float:
        """Detection mAP@0.5 on a deterministic handful of frames."""
        from happypose_tpu.evaluation.detection_meters import DetectionMeter
        from happypose_tpu.models.detector import detector_postprocess

        meter = DetectionMeter(iou_threshold=0.5)
        ev_rng = np.random.RandomState(12345)
        n_batches = max(1, args.eval_frames // args.batch_size)
        for _ in range(n_batches):
            x, targets = make_batch(ev_rng)
            out = eval_forward(
                {"params": state["params"],
                 "batch_stats": state["batch_stats"]}, x)
            post = detector_postprocess(
                out, score_threshold=0.3, iou_threshold=0.5,
                max_detections=args.max_gt * 2,
            )
            for b in range(x.shape[0]):
                keep = np.asarray(post["valid"][b])
                gt_keep = np.asarray(targets.valid[b])
                meter.add(
                    np.asarray(post["boxes"][b])[keep],
                    np.asarray(post["labels"][b])[keep],
                    np.asarray(post["scores"][b])[keep],
                    np.asarray(targets.boxes[b])[gt_keep],
                    np.asarray(targets.labels[b])[gt_keep],
                )
        return meter.summary()["mAP"]

    from happypose_tpu.datasets.augmentations import rgb_jitter

    aug_key = jax.random.PRNGKey(7)
    args.run_dir.mkdir(parents=True, exist_ok=True)
    for epoch in range(start_epoch, args.epochs):
        t0_ = time.time()
        losses = []
        for _ in range(args.epoch_size // args.batch_size):
            x, targets = make_batch(rng)
            if not args.no_augment:
                aug_key, k1 = jax.random.split(aug_key)
                x = rgb_jitter(k1, x)
            state, loss, parts = step(state, x, targets)
            losses.append(float(loss))
        rec = {
            "epoch": epoch, "loss": float(np.mean(losses)),
            "time": time.time() - t0_,
        }
        if args.eval_interval and (epoch + 1) % args.eval_interval == 0:
            rec["mAP@0.5"] = eval_map(state)
        with open(args.run_dir / "log.txt", "a") as f:
            f.write(json.dumps(rec) + "\n")
        msg = f"epoch {epoch}: loss={rec['loss']:.4f}"
        if "mAP@0.5" in rec:
            msg += f" mAP@0.5={rec['mAP@0.5']:.3f}"
        logger.info(msg)
        if (args.save_every and (epoch + 1) % args.save_every == 0) \
                or epoch + 1 == args.epochs:
            save_checkpoint(args.run_dir, state, epoch + 1,
                            config=vars(args))
    return 0


if __name__ == "__main__":
    from happypose_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
