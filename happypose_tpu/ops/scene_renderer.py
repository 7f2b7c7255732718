"""Multi-object scene rendering by z-composite of per-object renders.

The reference's scene renderer (panda3d_scene_renderer.py) rasterizes all
objects of a scene into one frame; our batched rasterizer renders one object
per image, so scenes composite by per-pixel nearest-depth merge — exact for
opaque objects, fully batched, and reuses the batched renderer unchanged.
Used by synthetic data recording and visualization.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from happypose_tpu.meshes.database import RenderAssets
from happypose_tpu.ops.rasterizer import RenderOutput
from happypose_tpu.ops.renderers import get_renderer


@partial(
    jax.jit,
    static_argnames=("n_scenes", "resolution", "renderer", "light_ambient",
                     "light_diffuse"),
)
def render_scenes(
    assets: RenderAssets,
    obj_ids: jax.Array,  # [N] all instances across scenes
    scene_ids: jax.Array,  # [N] which scene each instance belongs to
    TCO: jax.Array,  # [N, 4, 4]
    K: jax.Array,  # [N, 3, 3] (same K within a scene)
    valid: jax.Array,  # [N]
    n_scenes: int,
    resolution: Tuple[int, int] = (240, 320),
    renderer: Optional[str] = None,
    light_ambient: float = 0.6,
    light_diffuse: float = 0.6,
    lights: jax.Array = None,
) -> RenderOutput:
    """Composite per-instance renders into [n_scenes, ...] frames.
    `lights`: optional [N, 5] per-INSTANCE lighting rows (pass each
    scene's lighting repeated over its instances; see `shade_lambert`)."""
    out = get_renderer(renderer)(
        assets, obj_ids, TCO, K, resolution=resolution,
        light_ambient=light_ambient, light_diffuse=light_diffuse,
        lights=lights,
    )
    H, W = resolution
    inf = jnp.float32(jnp.inf)
    z = jnp.where(out.mask & valid[:, None, None], out.depth, inf)  # [N, H, W]

    # per-scene nearest instance per pixel via segment-min over scenes
    zmin = jnp.full((n_scenes, H, W), inf).at[scene_ids].min(z)
    is_front = (z == zmin[scene_ids]) & jnp.isfinite(z)  # [N, H, W]

    def seg(x, ndim_extra):
        m = is_front.astype(x.dtype)
        if ndim_extra:
            m = m[..., None]
        return jnp.zeros((n_scenes,) + x.shape[1:], x.dtype).at[scene_ids].add(
            x * m
        )

    rgb = seg(out.rgb, 1)
    normals = seg(out.normals, 1)
    depth = jnp.where(jnp.isfinite(zmin), zmin, 0.0)
    mask = jnp.isfinite(zmin)
    return RenderOutput(rgb=rgb, depth=depth, mask=mask, normals=normals)
