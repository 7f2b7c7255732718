"""Models: CNN backbones and render-and-compare pose predictors."""

from happypose_tpu.models.backbones import (
    EfficientNetB0,
    EfficientNetB3,
    ResNet34,
    WideResNet18,
    WideResNet34,
)
from happypose_tpu.models.pose_predictor import (
    PosePredictor,
    PosePredictorConfig,
    PoseOutputs,
)

__all__ = [
    "WideResNet18",
    "EfficientNetB0",
    "EfficientNetB3",
    "WideResNet34",
    "ResNet34",
    "PosePredictor",
    "PosePredictorConfig",
    "PoseOutputs",
]
