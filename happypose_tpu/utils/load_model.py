"""Named-model registry + one-call loading.

Parity target: /root/reference/happypose/toolbox/utils/load_model.py:8-89
(`NAMED_MODELS`, `load_named_model`) and `CosyPoseWrapper`
(cosypose/utils/cosypose_wrapper.py:80-190): a registry of model configs
keyed by name, resolving to (estimator, weights)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from happypose_tpu.inference.pose_estimator import PoseEstimator
from happypose_tpu.inference.types import InferenceConfig
from happypose_tpu.meshes.database import MeshDataBase
from happypose_tpu.models.pose_predictor import (
    PosePredictor,
    PosePredictorConfig,
)
from happypose_tpu.utils.checkpoint import load_checkpoint


@dataclass
class NamedModelSpec:
    """A named pipeline configuration (the 'megapose-1.0-RGB' analog)."""

    refiner_cfg: PosePredictorConfig
    coarse_cfg: Optional[PosePredictorConfig]
    inference_cfg: InferenceConfig
    requires_depth: bool = False


# Renderers are left to the platform (`ops/renderers.py`), chosen when a
# model renders, so building this table touches no device.
NAMED_MODELS: Dict[str, NamedModelSpec] = {
    # MegaPose-style novel-object pipeline (coarse classifier + refiner)
    "megapose-RGB": NamedModelSpec(
        refiner_cfg=PosePredictorConfig(
            backbone="resnet34", render_size=(240, 320),
            render_normals=True,
        ),
        coarse_cfg=PosePredictorConfig(
            backbone="resnet34", render_size=(240, 320),
            render_normals=True, predict_pose_update=False,
            predict_rendered_views_logits=True,
        ),
        inference_cfg=InferenceConfig(
            n_refiner_iterations=5, SO3_grid_size=576,
            n_pose_hypotheses=5,
        ),
    ),
    "megapose-RGB-multi-hypothesis": NamedModelSpec(
        refiner_cfg=PosePredictorConfig(
            backbone="resnet34", render_size=(240, 320),
        ),
        coarse_cfg=PosePredictorConfig(
            backbone="resnet34", render_size=(240, 320),
            predict_pose_update=False,
            predict_rendered_views_logits=True,
        ),
        inference_cfg=InferenceConfig(
            n_refiner_iterations=5, SO3_grid_size=576,
            n_pose_hypotheses=5,
        ),
    ),
    # CosyPose-style known-object pipeline (coarse pose + refiner)
    "cosypose-RGB": NamedModelSpec(
        refiner_cfg=PosePredictorConfig(
            backbone="wide_resnet34", render_size=(240, 320),
            render_normals=False,
        ),
        coarse_cfg=PosePredictorConfig(
            backbone="wide_resnet34", render_size=(240, 320),
            render_normals=False,
        ),
        inference_cfg=InferenceConfig(
            n_coarse_iterations=1, n_refiner_iterations=4,
        ),
),
}


def spec_from_checkpoints(
    checkpoint_dirs: Dict[str, Path],
    inference_cfg: Optional[InferenceConfig] = None,
) -> NamedModelSpec:
    """Build a spec from training run dirs' own saved configs — evaluate
    ANY `run_pose_training` output without a matching named spec (the
    reference reloads run configs the same way,
    cosypose/training/pose_models_cfg.py:62-75)."""
    import json

    def cfg_from(run_dir: Path, coarse: bool) -> PosePredictorConfig:
        c = json.loads((Path(run_dir) / "config.json").read_text())
        return PosePredictorConfig(
            backbone=c.get("backbone", "wide_resnet18"),
            render_size=tuple(c.get("render_size", (120, 160))),
            compute_dtype="bfloat16" if c.get("bf16") else "float32",
            predict_pose_update=not coarse,
            predict_rendered_views_logits=coarse,
        )

    return NamedModelSpec(
        refiner_cfg=cfg_from(checkpoint_dirs["refiner"], coarse=False),
        coarse_cfg=(
            cfg_from(checkpoint_dirs["coarse"], coarse=True)
            if "coarse" in checkpoint_dirs else None
        ),
        inference_cfg=inference_cfg or InferenceConfig(),
    )


def load_named_model(
    name: str,
    mesh_db: MeshDataBase,
    checkpoint_dirs: Optional[Dict[str, Path]] = None,
    n_points: int = 1000,
    rng_seed: int = 0,
) -> PoseEstimator:
    """Build a PoseEstimator for `name`; restores weights from
    `checkpoint_dirs` {"refiner": dir, "coarse": dir} when given, otherwise
    uses fresh (identity-update) initialization."""
    spec = NAMED_MODELS[name]
    assets = mesh_db.render_assets()
    meshes = mesh_db.batched(n_points=n_points)

    def build(cfg, seed):
        model = PosePredictor(cfg)
        B = 1
        images = jnp.zeros((B, 3, 240, 320))
        K = jnp.broadcast_to(
            jnp.asarray([[600.0, 0, 160], [0, 600.0, 120], [0, 0, 1]]),
            (B, 3, 3),
        )
        ids = jnp.zeros((B,), jnp.int32)
        TCO = jnp.broadcast_to(jnp.eye(4), (B, 4, 4)).at[:, 2, 3].set(0.5)
        variables = jax.jit(model.init)(
            jax.random.PRNGKey(seed), images, K, ids, TCO, assets,
            meshes.select(ids),
        )
        return model, variables

    refiner = build(spec.refiner_cfg, rng_seed)
    coarse = build(spec.coarse_cfg, rng_seed + 1) if spec.coarse_cfg else None

    if checkpoint_dirs:
        if "refiner" in checkpoint_dirs:
            v, _ = load_checkpoint(checkpoint_dirs["refiner"], refiner[1])
            refiner = (refiner[0], v)
        if coarse and "coarse" in checkpoint_dirs:
            v, _ = load_checkpoint(checkpoint_dirs["coarse"], coarse[1])
            coarse = (coarse[0], v)

    return PoseEstimator(
        refiner=refiner, coarse=coarse, assets=assets, meshes=meshes,
        cfg=spec.inference_cfg,
    )


def load_detector(run_dir: Path, n_classes: int):
    """Restore a trained FCOS detector from a training run directory.

    Parity target: `load_detector`
    (/root/reference/happypose/toolbox/inference/utils.py:61-83) — rebuild
    the model from the run's saved config and restore its weights. The run
    dir is one produced by `scripts/run_detector_training.py`
    (checkpoint.npz + config.json); detector class ids must match the
    mesh database used at training time (`--models-dir`)."""
    import json

    from happypose_tpu.inference.detector import Detector
    from happypose_tpu.models.detector import DetectorConfig, FCOSDetector

    run_dir = Path(run_dir)
    fpn_channels, image_size = 64, (240, 320)
    cfg_file = run_dir / "config.json"
    if cfg_file.exists():
        c = json.loads(cfg_file.read_text())
        fpn_channels = int(c.get("fpn_channels", fpn_channels))
        if c.get("image_size"):
            image_size = tuple(int(v) for v in c["image_size"])
    model = FCOSDetector(
        DetectorConfig(n_classes=n_classes, fpn_channels=fpn_channels)
    )
    # the variable tree's structure, without computing it
    target = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, *image_size))
    )
    variables, _ = load_checkpoint(run_dir, target)
    detector = Detector(model, variables)
    detector.image_size = image_size
    return detector
