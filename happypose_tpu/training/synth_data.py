"""On-device synthetic training-scene generator.

The reference generates training data offline (pybullet recording /
BlenderProc PBR, SURVEY.md §2.7); for in-framework training smoke/bench and
fast iteration we also provide a fully on-device generator: random object,
random pose in the camera frustum, rendered with the on-device rasterizer over
a randomized background. Everything is jax.random-driven and jit-safe.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from happypose_tpu.lib3d.rotations import quat_to_rotmat
from happypose_tpu.lib3d.transforms import make_T
from happypose_tpu.meshes.database import RenderAssets
from happypose_tpu.ops.renderers import get_renderer
from happypose_tpu.training.forward_loss import PoseTrainingBatch


def make_synth_mesh_db(
    synth_set: str = "debug",
    mesh_files=None,
    texture_size: int = 256,
    max_faces: int = 0,
):
    """Shared synthetic-training mesh registry (training + checkpoint eval
    must agree on object ids, so both build through here).

    synth_set:
      "debug"    — position-colored sphere + box (round-1 toy set).
      "textured" — procedurally TEXTURED sphere + position-colored box;
                   the surface detail render-and-compare needs to learn
                   rotation (TRAINING_NOTES r1 plateau).
    mesh_files: optional extra mesh paths (e.g. a BOP PLY). Meshes with
      UVs but no texture image get a deterministic procedural texture;
      mm-scale meshes (diameter > 1) are auto-scaled to meters.
    max_faces: decimate loaded meshes above this face count (0 = keep
      full resolution); meshes under the tile-major kernel's resident
      budget train markedly faster.
    """
    import dataclasses as _dc

    from happypose_tpu.meshes.database import MeshDataBase
    from happypose_tpu.meshes.io import (
        decimate_mesh,
        load_mesh,
        make_box_mesh,
        make_procedural_texture,
        make_uv_sphere,
        position_colored,
    )

    meshes = {}
    scales = {}
    if synth_set == "debug":
        meshes["sphere"] = position_colored(make_uv_sphere(0.04, 16, 24))
        meshes["box"] = position_colored(make_box_mesh((0.035, 0.025, 0.045)))
    elif synth_set == "textured":
        sphere = make_uv_sphere(0.04, 16, 24, with_uv=True)
        sphere.texture = make_procedural_texture(texture_size, seed=1)
        meshes["sphere"] = sphere
        meshes["box"] = position_colored(
            make_box_mesh((0.035, 0.025, 0.045))
        )
    elif synth_set == "mesh_only":
        # only the --mesh-files objects (per-object models, the CosyPose
        # per-dataset training setting at its smallest)
        if not mesh_files:
            raise ValueError("synth_set=mesh_only needs --mesh-files")
    else:
        raise ValueError(f"unknown synth set: {synth_set}")

    for k, path in enumerate(mesh_files or []):
        m = load_mesh(path)
        label = f"mesh{k}"
        if m.diameter > 1.0:  # mm-scale BOP model
            scales[label] = 1e-3
        if max_faces and len(m.faces) > max_faces:
            m = decimate_mesh(m, max_faces)
        if m.vertex_uv is not None and m.texture is None:
            m = _dc.replace(m, texture=make_procedural_texture(
                texture_size, seed=100 + k
            ))
        meshes[label] = m
    return MeshDataBase(meshes=meshes, scales=scales)


def random_rotations(key: jax.Array, n: int) -> jax.Array:
    """Uniform random rotations via normalized 4D gaussians -> quats."""
    q = jax.random.normal(key, (n, 4))
    return quat_to_rotmat(q)


@partial(
    jax.jit,
    static_argnames=("batch_size", "resolution", "renderer", "n_objects"),
)
def make_synth_batch(
    rng: jax.Array,
    assets: RenderAssets,
    K1: jax.Array,  # [3, 3] shared intrinsics
    n_objects: int,
    batch_size: int,
    resolution: Tuple[int, int] = (120, 160),
    z_range: Tuple[float, float] = (0.35, 0.8),
    xy_extent: float = 0.08,
    renderer: Optional[str] = None,
    force_obj_ids: jax.Array = None,
) -> PoseTrainingBatch:
    """Random single-object scenes. Returns a PoseTrainingBatch.
    `force_obj_ids` pins the object of each scene (poses stay random)."""
    k_obj, k_rot, k_xy, k_z, k_bg, k_noise = jax.random.split(rng, 6)
    B = batch_size
    obj_ids = (
        force_obj_ids
        if force_obj_ids is not None
        else jax.random.randint(k_obj, (B,), 0, n_objects)
    )
    R = random_rotations(k_rot, B)
    xy = jax.random.uniform(k_xy, (B, 2), minval=-xy_extent, maxval=xy_extent)
    z = jax.random.uniform(k_z, (B, 1), minval=z_range[0], maxval=z_range[1])
    TCO_gt = make_T(R, jnp.concatenate([xy, z], axis=-1))
    K = jnp.broadcast_to(K1, (B, 3, 3))

    out = get_renderer(renderer)(
        assets, obj_ids, TCO_gt, K, resolution=resolution
    )

    H, W = resolution
    bg = jax.random.uniform(k_bg, (B, H, W, 3), minval=0.0, maxval=1.0)
    # low-frequency-ish background: blur by 2x2 average pooling up-down
    bg = jax.image.resize(
        jax.image.resize(bg, (B, H // 8, W // 8, 3), "linear"),
        (B, H, W, 3),
        "linear",
    )
    rgb = jnp.where(out.mask[..., None], out.rgb, bg)
    rgb = jnp.clip(
        rgb + 0.02 * jax.random.normal(k_noise, rgb.shape), 0.0, 1.0
    )
    images = jnp.moveaxis(rgb, -1, 1)  # [B, 3, H, W]
    return PoseTrainingBatch(images=images, K=K, obj_ids=obj_ids, TCO_gt=TCO_gt)
