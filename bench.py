"""Benchmark: render-and-compare refiner pose-iterations per second.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"}.

Baseline anchor (BASELINE.md): the reference's GPU refiner moves every
iteration's crops through a multiprocess OpenGL pool; a V100-era refiner
sustains roughly 50 pose-iterations/s/GPU at bsz_objects=16 with 240x320
renders (BASELINE.json has no published number; this is the envelope implied
by its defaults and the 4h/dataset eval budget). vs_baseline is measured
against that 50 it/s anchor.

One pose-iteration = crop -> render (240x320) -> CNN (resnet34) -> SE(3)
update for one object hypothesis. The whole loop runs on the device; timing
repeats it in an on-device lax.scan, so one dispatch covers N_SCAN calls.
The renderer is the platform's (`ops/renderers.py`); the CNN runs in bf16.
"""

import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

REFERENCE_POSE_ITERS_PER_SEC = 50.0  # V100-era anchor, see docstring
B = 16  # bsz_objects (reference default, inference/types.py:98)
N_SCAN = 20


def _timed(fn, *args):
    """Compile, then time N_SCAN on-device repeats; returns seconds/call."""
    @jax.jit
    def many(a):
        def body(x, _):
            return x, fn(*a)

        _, outs = jax.lax.scan(body, 0, None, length=N_SCAN)
        return outs

    jax.block_until_ready(many(args))
    t0 = time.time()
    jax.block_until_ready(many(args))
    return (time.time() - t0) / N_SCAN


def breakdown():
    """Per-stage timing of the refiner iteration (dev tool, not the
    driver's JSON contract): render / crop / CNN / full iteration."""
    from happypose_tpu.meshes.database import MeshDataBase
    from happypose_tpu.meshes.io import make_box_mesh, make_uv_sphere
    from happypose_tpu.models import PosePredictor, PosePredictorConfig
    from happypose_tpu.ops.crop_resize import crop_images_matmul
    from happypose_tpu.ops.renderers import get_renderer

    db = MeshDataBase(
        meshes={
            "sphere": make_uv_sphere(radius=0.05, n_lat=24, n_lon=32),
            "box": make_box_mesh((0.04, 0.03, 0.05)),
        }
    )
    assets = db.render_assets()
    rs = np.random.RandomState(0)
    images = jnp.asarray(rs.rand(B, 3, 240, 320).astype(np.float32))
    K = jnp.broadcast_to(
        jnp.asarray([[600.0, 0, 160], [0, 600.0, 120], [0, 0, 1]]), (B, 3, 3)
    )
    obj_ids = jnp.asarray([0, 1] * (B // 2), jnp.int32)
    TCO0 = jnp.broadcast_to(jnp.eye(4), (B, 4, 4)).at[:, 2, 3].set(0.5)
    boxes = jnp.broadcast_to(
        jnp.asarray([80.0, 40.0, 240.0, 200.0]), (B, 4)
    )

    render_fn = get_renderer()
    t_render = _timed(
        lambda: render_fn(assets, obj_ids, TCO0, K).rgb
    )
    t_crop = _timed(
        lambda: crop_images_matmul(
            images, boxes, output_size=(240, 320), sampling_ratio=4,
            # the dtype the bf16 model path uses
            matmul_dtype=jnp.bfloat16,
        )
    )
    cfg = PosePredictorConfig(
        backbone="resnet34", render_size=(240, 320), compute_dtype="bfloat16",
    )
    model = PosePredictor(cfg)
    bm = db.batched(n_points=512)
    meshes = bm.select(obj_ids)
    variables = model.init(
        jax.random.PRNGKey(0), images, K, obj_ids, TCO0, assets, meshes,
        n_iterations=1,
    )
    x9 = jnp.asarray(rs.rand(B, 9, 240, 320).astype(np.float32))

    def cnn_only():
        return model.apply_net(variables, x9)["pose"]

    t_cnn = _timed(cnn_only)
    t_full = _timed(
        lambda: model.apply(
            variables, images, K, obj_ids, TCO0, assets, meshes,
            n_iterations=1,
        ).TCO_output
    )
    print(json.dumps({
        "render_ms": round(t_render * 1e3, 3),
        "crop_ms": round(t_crop * 1e3, 3),
        "cnn9ch_ms": round(t_cnn * 1e3, 3),
        "full_iter_ms": round(t_full * 1e3, 3),
        "batch": B,
    }))


def pipeline_bench(n_images: int = 8, so3_grid: int = 0):
    """End-to-end images/sec: detector -> 576-grid coarse -> top-5 ->
    5-iteration refine -> re-score -> top-1, per image, on the device.

    Directly comparable to the reference's eval envelope: one BOP dataset
    (~900-2000 keyframes) on 4x V100 in ~4 h (BASELINE.md, evaluation.slurm)
    = 28.8-64 GPU-seconds per image depending on keyframe count;
    vs_baseline divides the midpoint count (1450 keyframes -> 39.7 s/image)
    by seconds_per_image, and the emitted JSON states the range + the
    assumed count. Weights are fresh-init (identity updates) - wall-clock
    is architecture- and shape-bound, not value-bound."""
    from happypose_tpu.inference.detector import Detector
    from happypose_tpu.inference.types import (
        DetectionBatch, ObservationBatch,
    )
    from happypose_tpu.models.detector import DetectorConfig, FCOSDetector
    from happypose_tpu.utils.load_model import load_named_model

    db = _mesh_db("debug")
    estimator = load_named_model("megapose-RGB", db)
    if so3_grid:  # smoke-test override (CPU); the device number uses 576
        import dataclasses

        from happypose_tpu.lib3d.so3_grid import load_SO3_grid

        estimator.cfg = dataclasses.replace(
            estimator.cfg, SO3_grid_size=so3_grid,
            bsz_images=min(estimator.cfg.bsz_images, so3_grid),
        )
        estimator.SO3_grid = jnp.asarray(load_SO3_grid(so3_grid))

    rs = np.random.RandomState(0)
    rgb = jnp.asarray(rs.rand(1, 3, 240, 320).astype(np.float32))
    K = jnp.asarray([[[600.0, 0, 160], [0, 600.0, 120], [0, 0, 1]]])
    obs = ObservationBatch(rgb=rgb, K=K)

    dmodel = FCOSDetector(DetectorConfig(n_classes=len(db.labels)))
    dvars = jax.jit(dmodel.init)(jax.random.PRNGKey(0), rgb)
    detector = Detector(dmodel, dvars)

    # fixed synthetic detections: a fresh-init detector on noise returns
    # nothing stable; the pipeline stages get the reference's typical
    # per-image load (4 instances) regardless
    det = DetectionBatch.from_numpy(
        boxes=np.asarray(
            [[60, 40, 140, 120], [160, 50, 240, 130],
             [80, 120, 160, 200], [180, 130, 260, 210]], np.float32
        ),
        obj_ids=np.asarray([0, 1, 0, 1], np.int32),
    )

    def one_image():
        detector.get_detections(obs, detection_th=0.3)
        out = estimator.run_inference_pipeline_jit(
            obs, det, n_refiner_iterations=5, n_pose_hypotheses=5
        )
        jax.block_until_ready(out["final"].poses)

    one_image()  # compile
    t0 = time.time()
    for _ in range(n_images):
        one_image()
    dt = (time.time() - t0) / n_images
    print(json.dumps({
        "metric": "pipeline_seconds_per_image",
        "value": round(dt, 3),
        "unit": "s/image (detector + 4x576 coarse + top5 x 5-iter refine "
                "+ re-score, 240x320)",
        # baseline: 16 GPU-h / 1450 keyframes (midpoint of the reference's
        # 900-2000/dataset envelope) = 39.7 s/image; range 28.8-64.0
        "vs_baseline": round(39.7 / dt, 2),
        "baseline_s_per_image": 39.7,
        "baseline_s_per_image_range": [28.8, 64.0],
        "baseline_assumed_keyframes": 1450,
    }))


def _mesh_db(mesh_set: str):
    """Bench mesh sets.

    "debug": 24x32 sphere + box (~1.5k faces).
    "bop3k": the reference's shipped BOP mesh decimated to 3k faces (the
      post-decimation size real BOP objects arrive at).
    "bop_full": the same mesh undecimated (15.7k faces).
    """
    from happypose_tpu.meshes.database import MeshDataBase
    from happypose_tpu.meshes.io import (
        decimate_mesh, load_mesh, make_box_mesh, make_uv_sphere,
    )

    if mesh_set == "debug":
        return MeshDataBase(
            meshes={
                "sphere": make_uv_sphere(radius=0.05, n_lat=24, n_lon=32),
                "box": make_box_mesh((0.04, 0.03, 0.05)),
            }
        )
    ply = "/root/reference/tests/data/obj_000001.ply"
    m = load_mesh(ply)
    scales = {}
    if m.diameter > 1.0:
        scales = {"bop": 1e-3, "bop2": 1e-3}
    if mesh_set == "bop3k":
        m = decimate_mesh(m, 3000)
    elif mesh_set != "bop_full":
        raise SystemExit(f"unknown --mesh set {mesh_set}")
    return MeshDataBase(meshes={"bop": m, "bop2": m}, scales=scales)


def main(mesh_set: str = "debug", batch: int = B):
    global B
    B = batch
    from happypose_tpu.models import PosePredictor, PosePredictorConfig

    db = _mesh_db(mesh_set)
    assets = db.render_assets()
    bm = db.batched(n_points=512)

    cfg = PosePredictorConfig(
        backbone="resnet34", render_size=(240, 320), compute_dtype="bfloat16",
    )
    model = PosePredictor(cfg)

    rs = np.random.RandomState(0)
    images = jnp.asarray(rs.rand(B, 3, 240, 320).astype(np.float32))
    K = jnp.broadcast_to(
        jnp.asarray([[600.0, 0, 160], [0, 600.0, 120], [0, 0, 1]]), (B, 3, 3)
    )
    obj_ids = jnp.asarray([0, 1] * (B // 2), jnp.int32)
    TCO0 = jnp.broadcast_to(jnp.eye(4), (B, 4, 4)).at[:, 2, 3].set(0.5)
    meshes = bm.select(obj_ids)
    variables = model.init(
        jax.random.PRNGKey(0), images, K, obj_ids, TCO0, assets, meshes,
        n_iterations=1,
    )

    @jax.jit
    def many(TCO):
        def body(T, _):
            out = model.apply(
                variables, images, K, obj_ids, T, assets, meshes,
                n_iterations=1,
            )
            return out.TCO_output[-1], ()

        T_final, _ = jax.lax.scan(body, TCO, None, length=N_SCAN)
        return T_final

    # compile + warm
    jax.block_until_ready(many(TCO0))
    t0 = time.time()
    jax.block_until_ready(many(TCO0))
    dt = time.time() - t0
    pose_iters_per_sec = B * N_SCAN / dt

    metric = "refiner_pose_iterations_per_sec"
    if mesh_set != "debug":
        metric += f"_{mesh_set}"
    if batch != 16:
        metric += f"_b{batch}"
    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(pose_iters_per_sec, 2),
                "unit": "pose-iters/s (crop+render240x320+resnet34+update)",
                "vs_baseline": round(
                    pose_iters_per_sec / REFERENCE_POSE_ITERS_PER_SEC, 2
                ),
            }
        )
    )


if __name__ == "__main__":
    from happypose_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if "--breakdown" in sys.argv:
        breakdown()
    elif "--pipeline" in sys.argv:
        so3 = 0
        if "--so3" in sys.argv:
            so3 = int(sys.argv[sys.argv.index("--so3") + 1])
        pipeline_bench(so3_grid=so3)
    else:
        mesh_set = "debug"
        if "--mesh" in sys.argv:
            mesh_set = sys.argv[sys.argv.index("--mesh") + 1]
        batch = B
        if "--batch" in sys.argv:
            batch = int(sys.argv[sys.argv.index("--batch") + 1])
        main(mesh_set, batch)
