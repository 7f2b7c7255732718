"""Smoke run of the pose pipeline on one GPU, end to end, at full width.

Run from the root of a checkout:

    python chip_smoke.py              # one GPU: phases 1-4
    python chip_smoke.py --four-gpus  # four GPUs: the two sharded checks only

Phases (one process, so one JAX process owns the card):

1. device     platform, device kind and count, the card's name and power
              limit (read by nvidia-smi), JAX version, compile cache.
2. renderer   the Triton rasterizer against the plain XLA reference
              `ops/rasterizer.render_batch` (matmul precision "highest") at
              B=16 and B=288, 240x320, on a ~1.5k-face and a ~16k-face
              scene; kernel and reference times.
3. inference  `load_named_model("megapose-RGB")` at its published width
              (ResNet34 coarse + refiner, 576-grid, top-5, 5 iterations) on
              recorded 480x640 frames with 4 objects: the FCOS detector,
              then `run_inference_pipeline_jit` on 4 fixed detections.
4. training   3 steps of the refiner train step (ResNet34, batch 16,
              240x320, bf16) on `make_synth_batch` data.

Weights are fresh-init from seeds. Every phase prints one line with its
shapes, compile seconds, steady seconds (host clock around
`block_until_ready`) and the device's `peak_bytes_in_use` so far; these are
smoke numbers, not benchmark cells. A failed check raises, so the script
exits non-zero. The last line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from functools import partial

import numpy as np

RENDER_HW = (240, 320)
RENDER_BATCHES = (16, 288)  # one refiner batch, one coarse chunk
FRAME_HW = (480, 640)
K_CROP = np.asarray([[600.0, 0, 160], [0, 600.0, 120], [0, 0, 1]], np.float32)


def _say(phase: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body}", flush=True)


def _peak_bytes() -> int:
    import jax

    return int(jax.devices()[0].memory_stats().get("peak_bytes_in_use", -1))


def _steady(fn, *args, n: int):
    """Mean host seconds per call over `n` calls after one warm call."""
    import jax

    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = jax.block_until_ready(fn(*args))
    return out, (time.perf_counter() - t0) / n


def _compile(fn, *args):
    """AOT-compile `fn` for `args`; returns (compiled, seconds)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


# ----------------------------------------------------------------------
# Phase 1: device
# ----------------------------------------------------------------------


def phase_device(cache_dir: str) -> None:
    import jax

    dev = jax.devices()[0]
    _say(
        "device", platform=dev.platform, kind=repr(dev.device_kind),
        count=len(jax.devices()), jax=jax.__version__, cache=cache_dir,
    )
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found platform {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)


# ----------------------------------------------------------------------
# Phase 2: renderer
# ----------------------------------------------------------------------


def scene_meshes():
    """The two render scenes: the ~1.5k-face debug set and a ~16k-face
    textured set (the face count of the reference's BOP test mesh)."""
    from happypose_tpu.meshes.io import (
        make_box_mesh, make_procedural_texture, make_uv_sphere,
        position_colored,
    )

    big = make_uv_sphere(radius=0.05, n_lat=90, n_lon=90, with_uv=True)
    big.texture = make_procedural_texture(256, seed=7)
    box = position_colored(make_box_mesh((0.06, 0.03, 0.04)))
    xy = box.vertices[:, :2]
    box.vertex_uv = (xy - xy.min(0)) / (xy.max(0) - xy.min(0))
    box.texture = make_procedural_texture(256, seed=8)
    return {
        "debug_1.5k": {
            "sphere": make_uv_sphere(radius=0.05, n_lat=24, n_lon=32),
            "box": make_box_mesh((0.04, 0.03, 0.05)),
        },
        "textured_16k": {"sphere16k": big, "box_tex": box},
    }


def _render_inputs(B: int, n_obj: int, seed: int):
    """Seeded crop-camera poses; every eighth object sits half outside the
    image so the masked tile edges are exercised."""
    import jax.numpy as jnp

    from happypose_tpu.datasets.scene_synth import random_rotations_np

    rs = np.random.RandomState(seed)
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    TCO[:, :3, :3] = random_rotations_np(rs, B)
    TCO[:, :2, 3] = rs.uniform(-0.03, 0.03, (B, 2))
    TCO[:, 2, 3] = rs.uniform(0.35, 0.6, B)
    TCO[::8, 0, 3] = 0.13
    ids = (np.arange(B) % n_obj).astype(np.int32)
    K = np.broadcast_to(K_CROP, (B, 3, 3))
    return jnp.asarray(ids), jnp.asarray(TCO), jnp.asarray(K)


def _agreement(ref, out):
    """Shares of agreeing pixels, with the tolerances of the CPU tests:
    mask everywhere; depth 1e-3, RGB 0.02 and normals 0.05 on pixels that
    both masks cover."""
    import jax.numpy as jnp

    both = ref.mask & out.mask
    n_both = jnp.maximum(jnp.sum(both), 1)

    def share(a, b, tol):
        bad = jnp.abs(a - b)
        if bad.ndim == 4:
            bad = jnp.max(bad, axis=-1)
        return jnp.sum(both & (bad < tol)) / n_both

    return {
        "mask": jnp.mean(ref.mask == out.mask),
        "depth": share(ref.depth, out.depth, 1e-3),
        "rgb": share(ref.rgb, out.rgb, 0.02),
        "normals": share(ref.normals, out.normals, 0.05),
    }


def check_agreement(agree) -> None:
    if not agree["mask"] > 0.99:
        raise AssertionError(f"mask agreement {agree['mask']}")
    for k in ("depth", "rgb", "normals"):
        if not agree[k] > 0.95:
            raise AssertionError(f"{k} agreement {agree[k]}")


def phase_renderer(scenes) -> None:
    import jax

    from happypose_tpu.meshes.database import MeshDataBase
    from happypose_tpu.ops.rasterizer import render_batch
    from happypose_tpu.ops.rasterizer_triton import render_batch_triton

    for name, meshes in scenes.items():
        db = MeshDataBase(meshes=meshes)
        assets = db.render_assets()
        n_faces = int(assets.faces.shape[1])
        for B in RENDER_BATCHES:
            args = (assets, *_render_inputs(B, len(db.labels), seed=B))
            kern, t_kc = _compile(
                partial(render_batch_triton, resolution=RENDER_HW), *args
            )
            out, t_k = _steady(kern, *args, n=5)
            with jax.default_matmul_precision("highest"):
                ref_fn, t_rc = _compile(
                    partial(render_batch, resolution=RENDER_HW), *args
                )
            ref, t_r = _steady(ref_fn, *args, n=3)
            agree = {
                k: float(v)
                for k, v in jax.jit(_agreement)(ref, out).items()
            }
            _say(
                "renderer", scene=name, faces=n_faces, B=B,
                hw=f"{RENDER_HW[0]}x{RENDER_HW[1]}",
                kernel_compile_s=f"{t_kc:.2f}", kernel_steady_s=f"{t_k:.6f}",
                reference_compile_s=f"{t_rc:.2f}",
                reference_steady_s=f"{t_r:.6f}",
                agree=json.dumps({k: round(v, 5) for k, v in agree.items()}),
                peak_bytes=_peak_bytes(),
            )
            check_agreement(agree)


# ----------------------------------------------------------------------
# Phase 3: inference (served path)
# ----------------------------------------------------------------------


def _record_frames(db, n: int, seed: int):
    """`n` recorded 480x640 frames that show all four objects."""
    from happypose_tpu.datasets.scene_record import BatchedSceneRecorder
    from happypose_tpu.datasets.scene_synth import SceneSynthConfig

    cfg = SceneSynthConfig(resolution=FRAME_HW, n_objects_interval=(4, 4))
    rec = BatchedSceneRecorder(db, cfg, seed=seed, batch_scenes=4)
    frames = []
    for _ in range(8):
        frames += [f for f in rec.record(4) if len(f.labels) == 4]
        if len(frames) >= n:
            return frames[:n]
    raise AssertionError(f"recorded {len(frames)} frames with 4 objects")


def phase_inference(scenes) -> None:
    import jax

    from happypose_tpu.inference.detector import Detector
    from happypose_tpu.inference.types import DetectionBatch, ObservationBatch
    from happypose_tpu.meshes.database import MeshDataBase
    from happypose_tpu.models.detector import DetectorConfig, FCOSDetector
    from happypose_tpu.utils.load_model import load_named_model

    meshes = {k: v for scene in scenes.values() for k, v in scene.items()}
    db = MeshDataBase(meshes=meshes)
    frames = _record_frames(db, 3, seed=0)

    t0 = time.perf_counter()
    estimator = load_named_model("megapose-RGB", db)
    dmodel = FCOSDetector(DetectorConfig(n_classes=len(db.labels)))
    obs0 = ObservationBatch.from_numpy(frames[0].rgb, frames[0].K)
    detector = Detector(
        dmodel, jax.jit(dmodel.init)(jax.random.PRNGKey(0), obs0.rgb)
    )
    t_build = time.perf_counter() - t0

    def answer(frame):
        obs = ObservationBatch.from_numpy(frame.rgb, frame.K)
        detector.get_detections(obs, detection_th=0.3)
        # a fresh-init detector finds nothing stable: the pose stages get
        # the frame's four ground-truth boxes as fixed detections
        det = DetectionBatch.from_numpy(
            boxes=frame.bboxes,
            obj_ids=np.asarray([db.label_to_id[l] for l in frame.labels]),
        )
        final = estimator.run_inference_pipeline_jit(
            obs, det, n_refiner_iterations=5, n_pose_hypotheses=5
        )["final"]
        jax.block_until_ready(final.poses)
        # one kept (top-1) pose per detection
        return np.asarray(final.poses)[np.asarray(final.valid)]

    t0 = time.perf_counter()
    answer(frames[0])
    t_first = time.perf_counter() - t0
    times = []
    for frame in frames:
        t0 = time.perf_counter()
        poses = answer(frame)
        times.append(time.perf_counter() - t0)
        if poses.shape != (4, 4, 4) or not np.isfinite(poses).all():
            raise AssertionError(f"poses {poses.shape}, finite="
                                 f"{np.isfinite(poses).all()}")
    cfg = estimator.cfg
    _say(
        "inference", model="megapose-RGB", frame=f"{FRAME_HW[0]}x{FRAME_HW[1]}",
        detections=4, grid=int(estimator.SO3_grid.shape[0]),
        top_k=cfg.n_pose_hypotheses, iterations=cfg.n_refiner_iterations,
        faces=int(estimator.assets.faces.shape[1]),
        build_s=f"{t_build:.2f}", compile_s=f"{t_first:.2f}",
        steady_s_per_frame=json.dumps([round(t, 4) for t in times]),
        peak_bytes=_peak_bytes(),
    )


# ----------------------------------------------------------------------
# Phase 4: training
# ----------------------------------------------------------------------


def _train_setup(scenes, batch: int, bn_axis_name=None, tx=None,
                 pose_noise: bool = True, compute_dtype: str = "bfloat16"):
    import jax

    from happypose_tpu.meshes.database import MeshDataBase
    from happypose_tpu.models import PosePredictor, PosePredictorConfig
    from happypose_tpu.training import TrainState, make_optimizer
    from happypose_tpu.training.forward_loss import make_refiner_loss_fn
    from happypose_tpu.training.synth_data import make_synth_batch

    db = MeshDataBase(meshes=scenes["debug_1.5k"])
    assets = db.render_assets()
    bm = db.batched(n_points=512)
    cfg = PosePredictorConfig(
        backbone="resnet34", render_size=RENDER_HW, compute_dtype=compute_dtype,
        bn_axis_name=bn_axis_name,
    )
    model = PosePredictor(cfg)
    noise = {} if pose_noise else {
        "euler_deg_std": (0.0, 0.0, 0.0), "trans_std": (0.0, 0.0, 0.0),
    }
    loss_fn = make_refiner_loss_fn(model, assets, bm, n_iterations=1, **noise)
    batch_data = make_synth_batch(
        jax.random.PRNGKey(0), assets, K_CROP, n_objects=len(db.labels),
        batch_size=batch, resolution=RENDER_HW,
    )
    variables = jax.jit(
        partial(model.init, n_iterations=1)
    )(
        jax.random.PRNGKey(1), batch_data.images, batch_data.K,
        batch_data.obj_ids, batch_data.TCO_gt, assets,
        bm.select(batch_data.obj_ids),
    )
    tx = tx or make_optimizer(lr=1e-3, n_warmup_steps=1)
    return loss_fn, tx, TrainState.create(variables, tx), batch_data


def phase_training(scenes) -> None:
    import jax

    from happypose_tpu.training import make_train_step

    loss_fn, tx, state, batch = _train_setup(scenes, batch=16)
    step = make_train_step(loss_fn, tx, donate=False)
    key = jax.random.PRNGKey(2)
    step_c, t_c = _compile(step, state, batch, key)
    losses, times = [], []
    for i in range(3):
        t0 = time.perf_counter()
        state, metrics = jax.block_until_ready(
            step_c(state, batch, jax.random.fold_in(key, i))
        )
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    _say(
        "training", model="refiner resnet34 bf16", batch=16,
        hw=f"{RENDER_HW[0]}x{RENDER_HW[1]}", compile_s=f"{t_c:.2f}",
        steady_s_per_step=json.dumps([round(t, 4) for t in times]),
        losses=json.dumps(losses), peak_bytes=_peak_bytes(),
    )
    if not all(np.isfinite(losses)) or metrics["skipped_nonfinite"] > 0:
        raise AssertionError(f"non-finite training loss {losses}")


# ----------------------------------------------------------------------
# --four-gpus: the sharded paths against their one-device counterparts
# ----------------------------------------------------------------------


def four_gpus(scenes, n_dev: int = 4) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from happypose_tpu.training import make_train_step
    from happypose_tpu.training.trainer import split_batch_for_mesh

    if len(jax.devices()) < n_dev:
        raise SystemExit(f"--four-gpus needs {n_dev} devices, "
                         f"found {len(jax.devices())}")
    devices = np.asarray(jax.devices()[:n_dev])

    # data-parallel train step (pmean grads, BN synced over "dp") against
    # the same global batch on one device, in f32 with "highest" matmul
    # precision so that the comparison sees the sharding and not bf16 or
    # TF32 rounding. Plain SGD, so an update is the gradient times the rate
    # (Adam's first step is lr * sign(g), which flips on gradients near
    # zero); no pose noise, because the step's key is replicated and each
    # shard would draw the first shard's noise.
    import optax

    batch_size = 16
    sgd = optax.sgd(1e-2)
    setup = partial(
        _train_setup, scenes, batch_size, tx=sgd, pose_noise=False,
        compute_dtype="float32",
    )
    loss_dp, _, state, batch = setup("dp")
    loss_1, _, _, _ = setup()
    key = jax.random.PRNGKey(2)
    mesh = Mesh(devices, ("dp",))
    with jax.default_matmul_precision("highest"):
        one = make_train_step(loss_1, sgd, donate=False)
        s1, m1 = jax.block_until_ready(one(state, batch, key))
        dp = make_train_step(loss_dp, sgd, mesh=mesh, axis="dp", donate=False)
        t0 = time.perf_counter()
        s4, m4 = jax.block_until_ready(
            dp(state, split_batch_for_mesh(batch, mesh), key)
        )
        t_dp = time.perf_counter() - t0
    def dist(a, b):  # L2 distance between two parameter trees
        return float(jnp.sqrt(sum(
            jnp.sum(jnp.square(x.astype(jnp.float32) - y))
            for x, y in zip(jax.tree.leaves(a.params), jax.tree.leaves(b.params))
        )))

    step_1 = dist(s1, state)
    rel_param = dist(s4, s1) / step_1
    rel_loss = abs(float(m4["loss"]) - float(m1["loss"])) / abs(float(m1["loss"]))
    _say(
        "four-gpus", check="dp train step vs 1 device", batch=batch_size,
        devices=n_dev, loss_1=float(m1["loss"]), loss_dp=float(m4["loss"]),
        rel_loss_diff=f"{rel_loss:.3e}", update_l2=f"{step_1:.4e}",
        rel_update_diff_l2=f"{rel_param:.3e}",
        compile_plus_step_s=f"{t_dp:.2f}",
    )
    # f32: the dp step only sums per-device partial statistics and
    # gradients in another order than one device does. The loss agrees to
    # ~1e-6; the update to ~1e-3, because BatchNorm scale/bias gradients are
    # sums of nearly cancelling terms that magnify that rounding.
    if not (rel_loss < 1e-4 and rel_param < 1e-2):
        raise AssertionError(
            f"dp step disagrees: loss {rel_loss}, update {rel_param}"
        )

    # hypothesis-sharded coarse scoring against serial chunked scoring
    from happypose_tpu.inference import PoseEstimator
    from happypose_tpu.inference.types import DetectionBatch, ObservationBatch
    from happypose_tpu.meshes.database import MeshDataBase
    from happypose_tpu.utils.load_model import load_named_model

    db = MeshDataBase(meshes=scenes["debug_1.5k"])
    est = load_named_model("megapose-RGB", db)
    rs = np.random.RandomState(0)
    obs = ObservationBatch(
        rgb=jnp.asarray(rs.rand(1, 3, *FRAME_HW).astype(np.float32)),
        K=jnp.asarray(K_CROP[None] * np.asarray([2, 2, 1])[:, None]),
    )
    det = DetectionBatch.from_numpy(
        boxes=np.asarray([[200, 150, 330, 280], [350, 200, 470, 330]],
                         np.float32),
        obj_ids=np.asarray([0, 1], np.int32),
    )
    serial = est.forward_coarse_jit(obs, det)
    sharded_est = PoseEstimator(
        refiner=(est.refiner_model, est.refiner_vars),
        coarse=(est.coarse_model, est.coarse_vars),
        assets=est.assets, meshes=est.meshes, cfg=est.cfg,
        device_mesh=Mesh(devices, ("hp",)),
    )
    t0 = time.perf_counter()
    sharded = sharded_est.forward_coarse(obs, det)
    logits_s = np.asarray(sharded.coarse_logits)
    t_sh = time.perf_counter() - t0
    logits_1 = np.asarray(serial.coarse_logits)
    d_logit = float(np.max(np.abs(logits_s - logits_1)))
    _say(
        "four-gpus", check="hypothesis-sharded coarse vs serial",
        hypotheses=int(logits_1.size), devices=n_dev,
        max_abs_logit_diff=f"{d_logit:.3e}",
        compile_plus_run_s=f"{t_sh:.2f}",
    )
    if not d_logit < 1e-2:
        raise AssertionError(f"sharded coarse logits differ by {d_logit}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four-gpus", action="store_true",
        help="run only the data-parallel train step and the "
             "hypothesis-sharded coarse scoring on four GPUs",
    )
    args = parser.parse_args(argv)

    from happypose_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    import jax

    phase_device(cache_dir)
    scenes = scene_meshes()
    if args.four_gpus:
        four_gpus(scenes)
    else:
        phase_renderer(scenes)
        phase_inference(scenes)
        phase_training(scenes)
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
