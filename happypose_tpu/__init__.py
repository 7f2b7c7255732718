"""happypose_tpu — a 6D object-pose estimation framework in JAX.

A ground-up JAX/XLA re-design with the capabilities of
agimus-project/happypose (CosyPose + MegaPose), for NVIDIA GPUs:

- ``lib3d``:      SE(3)/rotation/camera/crop math as pure JAX ops.
- ``ops``:        rasterizer (XLA + Triton kernel), ROI-align, segment ops.
- ``meshes``:     mesh IO + padded, device-shardable mesh database.
- ``models``:     layer set, backbones, render-and-compare pose predictors.
- ``inference``:  CosyPose / MegaPose estimation pipelines (jitted).
- ``multiview``:  on-device RANSAC matching + Levenberg-Marquardt BA.
- ``training``:   disentangled pose losses, pjit data-parallel trainer.
- ``datasets``:   BOP scene/object datasets, augmentations.
- ``evaluation``: ADD(-S) meters, AUC, BOP export.
- ``parallel``:   mesh/sharding utilities (DP over batch, hypothesis-axis
                  sharding, object-asset sharding).

Unlike the reference (CUDA/torch + multiprocess OpenGL renderers), the whole
render->crop->CNN->SE(3)-update loop here lives on the device in a single jitted
computation; scaling is expressed with jax.sharding over a device Mesh.
"""

__version__ = "0.1.0"
