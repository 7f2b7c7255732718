"""On-device triangle rasterizer (pure-JAX reference implementation).

Replaces the reference's process-pool OpenGL renderers
(/root/reference/happypose/toolbox/renderer/panda3d_batch_renderer.py:194-286
and panda3d_scene_renderer.py:320-390) with an XLA computation that runs
inside the jitted pose-estimation step: no host round-trip, no process
boundary, fully batched.

Outputs per batch element: RGB (Lambertian + ambient on vertex colors),
camera-frame normals, metric depth, and a binary mask (depth > 0) — exactly
the channels the render-and-compare models consume.

Design (two passes, both static-shape):
  1. **Visibility pass** — scan over fixed-size face chunks; for each chunk
     compute edge-function coverage and affine-interpolated 1/z for every
     pixel, keep the per-pixel closest face id. This is the O(F·P) hot loop;
     `rasterizer_triton.py` provides the GPU-kernel version of exactly this
     pass (same face-id contract, interchangeable through `render_with`).
  2. **Shading pass** — per-pixel gather of the winning face's vertices,
     perspective-correct barycentric interpolation of color/normal, local
     shading. O(P), plain XLA.

Conventions: pixel (i, j) has continuous image coordinates (u, v) = (j, i)
at its center; a point X_cam projects to u = fx·x/z + cx, v = fy·y/z + cy.
Two-sided rasterization (no backface culling) — mesh winding is untrusted.

Precision: the geometry products (vertex and normal transforms, the light
dot product) ask for `Precision.HIGHEST`, so a GPU never runs them in TF32;
at a 600 px focal length TF32 would move silhouettes by a fraction of a
pixel.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from happypose_tpu.meshes.database import RenderAssets

_Z_NEAR = 1e-3
_HIGHEST = jax.lax.Precision.HIGHEST


class RenderOutput(NamedTuple):
    """Batched render results (channels-last)."""

    rgb: jax.Array  # [B, H, W, 3] float32 in [0, 1]
    depth: jax.Array  # [B, H, W] float32, 0 where no hit
    mask: jax.Array  # [B, H, W] bool
    normals: jax.Array  # [B, H, W, 3] float32, camera frame, 0 where no hit


class _FaceData(NamedTuple):
    """Per-face screen-space data for one image."""

    u: jax.Array  # [F, 3] screen u of the 3 vertices
    v: jax.Array  # [F, 3]
    inv_z: jax.Array  # [F, 3] 1/z_cam of the 3 vertices
    valid: jax.Array  # [F] face usable (in front of camera, non-degenerate)


def _face_screen_data(
    vertices: jax.Array,
    faces: jax.Array,
    faces_mask: jax.Array,
    TCO: jax.Array,
    K: jax.Array,
) -> Tuple[_FaceData, jax.Array]:
    """Project one object's vertices and gather per-face screen coords.

    Returns (_FaceData, verts_cam [V, 3]).
    """
    R, t = TCO[:3, :3], TCO[:3, 3]
    verts_cam = jnp.matmul(vertices, R.T, precision=_HIGHEST) + t  # [V, 3]
    z = verts_cam[:, 2]
    safe_z = jnp.maximum(z, _Z_NEAR)
    u = K[0, 0] * verts_cam[:, 0] / safe_z + K[0, 2]
    v = K[1, 1] * verts_cam[:, 1] / safe_z + K[1, 2]

    fu = u[faces]  # [F, 3]
    fv = v[faces]
    fz = z[faces]
    valid = faces_mask & jnp.all(fz > _Z_NEAR, axis=-1)
    return _FaceData(u=fu, v=fv, inv_z=1.0 / jnp.maximum(fz, _Z_NEAR), valid=valid), verts_cam


def _zbuffer_scan(
    fd: _FaceData, resolution: Tuple[int, int], chunk: int = 32
) -> Tuple[jax.Array, jax.Array]:
    """Pass 1: per-pixel closest-face search.

    Returns (face_id [H, W] int32 (-1 = background), inv_z_best [H, W]).
    """
    H, W = resolution
    F = fd.u.shape[0]
    n_chunks = (F + chunk - 1) // chunk
    Fp = n_chunks * chunk
    pad = Fp - F
    u = jnp.pad(fd.u, ((0, pad), (0, 0)))
    v = jnp.pad(fd.v, ((0, pad), (0, 0)))
    iz = jnp.pad(fd.inv_z, ((0, pad), (0, 0)))
    valid = jnp.pad(fd.valid, (0, pad))

    px_u = jnp.arange(W, dtype=jnp.float32)[None, :]  # [1, W]
    px_v = jnp.arange(H, dtype=jnp.float32)[:, None]  # [H, 1]

    def body(carry, ci):
        best_iz, best_id = carry
        sl = ci * chunk
        cu = jax.lax.dynamic_slice_in_dim(u, sl, chunk)  # [C, 3]
        cv = jax.lax.dynamic_slice_in_dim(v, sl, chunk)
        ciz = jax.lax.dynamic_slice_in_dim(iz, sl, chunk)
        cval = jax.lax.dynamic_slice_in_dim(valid, sl, chunk)

        # Edge functions in vertex-0-centered coordinates (f32-safe: absolute
        # pixel coords ~1e2 would cancel catastrophically on sliver triangles
        # like sphere poles). E_k(p) evaluated at p' = p - p0.
        u0, u1, u2 = cu[:, 0], cu[:, 1], cu[:, 2]
        v0, v1, v2 = cv[:, 0], cv[:, 1], cv[:, 2]
        e1u, e1v = u1 - u0, v1 - v0
        e2u, e2v = u2 - u0, v2 - v0
        area = e1u * e2v - e2u * e1v  # signed 2x triangle area

        def per_face(k, carry2):
            best_iz, best_id = carry2
            pu = px_u - u0[k]
            pv = px_v - v0[k]
            # w0 ~ edge(1,2), w1 ~ edge(2,0), w2 ~ edge(0,1); sum == area
            w1 = pu * e2v[k] - pv * e2u[k]
            w2 = pv * e1u[k] - pu * e1v[k]
            w0 = area[k] - w1 - w2
            s = jnp.sign(area[k])
            cov = (
                (w0 * s >= 0)
                & (w1 * s >= 0)
                & (w2 * s >= 0)
                & (jnp.abs(area[k]) > 1e-12)
                & cval[k]
            )
            inv_area = 1.0 / jnp.where(jnp.abs(area[k]) > 1e-12, area[k], 1.0)
            # 1/z is affine in screen space; clamp to the vertex range so
            # degenerate faces can never fabricate a closer depth
            pix_iz = (w0 * ciz[k, 0] + w1 * ciz[k, 1] + w2 * ciz[k, 2]) * inv_area
            pix_iz = jnp.clip(pix_iz, jnp.min(ciz[k]), jnp.max(ciz[k]))
            closer = cov & (pix_iz > best_iz)
            best_id = jnp.where(closer, sl + k, best_id)
            best_iz = jnp.where(closer, pix_iz, best_iz)
            return best_iz, best_id

        best_iz, best_id = jax.lax.fori_loop(0, chunk, per_face, (best_iz, best_id))
        return (best_iz, best_id), None

    init = (jnp.zeros((H, W), jnp.float32), jnp.full((H, W), -1, jnp.int32))
    (best_iz, best_id), _ = jax.lax.scan(body, init, jnp.arange(n_chunks))
    return best_id, best_iz


def shade_lambert(
    rgb: jax.Array,  # [B, H, W, 3] albedo
    normals: jax.Array,  # [B, H, W, 3] unit, camera-facing
    light_ambient: float,
    light_diffuse: float,
    lights: "jax.Array | None" = None,  # [B, 5]: dir_xyz + ambient + diffuse
) -> jax.Array:
    """Lambert shading, shared by every visibility pass (applied
    AFTER texture resolution so textured albedo shades identically to
    vertex colors).

    Default is the headlight model (light at the camera, direction
    (0, 0, -1) toward the scene). `lights` supplies PER-IMAGE lighting —
    unit direction from surface toward the light (camera frame) plus
    ambient/diffuse strengths — the analog of the reference's per-scene
    `light_datas` (panda3d_scene_renderer.py:294-318)."""
    if lights is None:
        lambert = jnp.maximum(-normals[..., 2], 0.0)
        shade = jnp.clip(light_ambient + light_diffuse * lambert, 0.0, 1.0)
        return jnp.clip(rgb * shade[..., None], 0.0, 1.0)
    d = lights[:, 0:3]
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-8)
    lambert = jnp.maximum(
        jnp.einsum("bhwc,bc->bhw", normals, d, precision=_HIGHEST), 0.0
    )
    amb = lights[:, 3][:, None, None]
    dif = lights[:, 4][:, None, None]
    shade = jnp.clip(amb + dif * lambert, 0.0, 1.0)
    return jnp.clip(rgb * shade[..., None], 0.0, 1.0)


def sample_textures_at(
    textures: jax.Array,  # [n_obj, T, T, 3]
    obj_ids: jax.Array,  # [B]
    uv: jax.Array,  # [B, H, W, 2] in [0, 1]
) -> jax.Array:
    """Bilinear texture lookup -> [B, H, W, 3].

    Flat-index gather over the whole texture atlas (no [B, T, T, 3]
    materialization — B can be a 576-hypothesis coarse batch). v=0 is the
    image BOTTOM (OBJ/GL convention); textures store row 0 at the top.
    """
    n_obj, T = textures.shape[0], textures.shape[1]
    flat = textures.reshape(n_obj * T * T, 3)

    def wrap(x):
        # GL_REPEAT (the panda3d default for tiled UVs); exact 1.0 stays
        return jnp.where(x == 1.0, 1.0, x - jnp.floor(x))

    u = wrap(uv[..., 0]) * (T - 1)
    v = (1.0 - wrap(uv[..., 1])) * (T - 1)
    x0f = jnp.floor(u)
    y0f = jnp.floor(v)
    fx = (u - x0f)[..., None]
    fy = (v - y0f)[..., None]
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, T - 1)
    y1 = jnp.minimum(y0 + 1, T - 1)
    base = (obj_ids.astype(jnp.int32) * T * T)[:, None, None]

    def g(y, x):
        return flat[base + y * T + x]

    return (
        g(y0, x0) * (1 - fx) * (1 - fy)
        + g(y0, x1) * fx * (1 - fy)
        + g(y1, x0) * (1 - fx) * fy
        + g(y1, x1) * fx * fy
    )


def resolve_albedo(
    rgb_attr: jax.Array,  # [B, H, W, 3] interpolated color channels
    textures: jax.Array,  # [n_obj, T, T, 3]
    obj_ids: jax.Array,  # [B]
    has_texture: jax.Array,  # [B] bool
) -> jax.Array:
    """Textured instances carry (u, v, 0) in their color channels; resolve
    them to sampled texture RGB. Untextured instances pass through."""
    if textures.shape[1] == 1:  # untextured database: skip the gathers
        return rgb_attr
    tex_rgb = sample_textures_at(textures, obj_ids, rgb_attr[..., 0:2])
    return jnp.where(has_texture[:, None, None, None], tex_rgb, rgb_attr)


def _shade(
    face_id: jax.Array,
    fd: _FaceData,
    faces: jax.Array,
    verts_cam: jax.Array,
    colors: jax.Array,
    normals_obj: jax.Array,
    TCO: jax.Array,
) -> RenderOutput:
    """Pass 2: per-pixel attribute interpolation (1 image).

    Returns UNSHADED albedo in `.rgb` (color channels may carry UVs for
    textured instances); texture resolution + Lambert shading happen at
    the batch level (`resolve_albedo` / `shade_lambert`)."""
    H, W = face_id.shape
    hit = face_id >= 0
    fid = jnp.maximum(face_id, 0)  # [H, W]

    tri = faces[fid]  # [H, W, 3] vertex ids
    fu = fd.u[fid]  # [H, W, 3]
    fv = fd.v[fid]
    fiz = fd.inv_z[fid]

    px_u = jnp.broadcast_to(jnp.arange(W, dtype=jnp.float32)[None, :], (H, W))
    px_v = jnp.broadcast_to(jnp.arange(H, dtype=jnp.float32)[:, None], (H, W))

    # vertex-0-centered edge functions (same f32-safe form as the z-buffer)
    u0, u1, u2 = fu[..., 0], fu[..., 1], fu[..., 2]
    v0, v1, v2 = fv[..., 0], fv[..., 1], fv[..., 2]
    e1u, e1v = u1 - u0, v1 - v0
    e2u, e2v = u2 - u0, v2 - v0
    area = e1u * e2v - e2u * e1v
    pu = px_u - u0
    pv = px_v - v0
    w1 = pu * e2v - pv * e2u
    w2 = pv * e1u - pu * e1v
    w0 = area - w1 - w2
    inv_area = 1.0 / jnp.where(jnp.abs(area) > 1e-12, area, 1.0)
    t0, t1, t2 = w0 * inv_area, w1 * inv_area, w2 * inv_area  # screen bary

    # perspective-correct weights
    iz_px = t0 * fiz[..., 0] + t1 * fiz[..., 1] + t2 * fiz[..., 2]
    z_px = 1.0 / jnp.maximum(iz_px, 1e-12)
    p0 = t0 * fiz[..., 0] * z_px
    p1 = t1 * fiz[..., 1] * z_px
    p2 = t2 * fiz[..., 2] * z_px

    def interp(attr_v):  # attr_v: [V, C] -> [H, W, C]
        a = attr_v[tri]  # [H, W, 3, C]
        return (
            a[..., 0, :] * p0[..., None]
            + a[..., 1, :] * p1[..., None]
            + a[..., 2, :] * p2[..., None]
        )

    color = interp(colors)
    # [V, 3] normals in camera frame
    n_cam_v = jnp.matmul(normals_obj, TCO[:3, :3].T, precision=_HIGHEST)
    n_px = interp(n_cam_v)
    n_px = n_px / jnp.maximum(jnp.linalg.norm(n_px, axis=-1, keepdims=True), 1e-8)
    # two-sided: flip normals facing away from the camera (view dir ~ -z)
    n_px = jnp.where(n_px[..., 2:3] > 0, -n_px, n_px)

    hit_f = hit[..., None]
    return RenderOutput(
        rgb=jnp.where(hit_f, color, 0.0),
        depth=jnp.where(hit, z_px, 0.0),
        mask=hit,
        normals=jnp.where(hit_f, n_px, 0.0),
    )


Visibility = Callable[[_FaceData, Tuple[int, int]], jax.Array]


def zbuffer_reference(fd: _FaceData, resolution: Tuple[int, int]) -> jax.Array:
    """Visibility pass of the plain path: [B, H, W] face ids (-1 = none)."""
    return jax.vmap(lambda f: _zbuffer_scan(f, resolution)[0])(fd)


def render_with(
    visibility: Visibility,
    assets: RenderAssets,
    obj_ids: jax.Array,
    TCO: jax.Array,
    K: jax.Array,
    resolution: Tuple[int, int],
    light_ambient: float,
    light_diffuse: float,
    lights: Optional[jax.Array],
) -> RenderOutput:
    """Project, run `visibility` (batched face screen data -> [B, H, W]
    face ids), then shade. Every renderer shares this body; only the
    visibility pass differs."""
    inst = assets.select(obj_ids)
    # textured instances carry (u, v, 0) in their color channels and are
    # resolved against the texture atlas after rasterization
    uv0 = jnp.concatenate(
        [inst.vertex_uv, jnp.zeros_like(inst.vertex_uv[..., :1])], axis=-1
    )
    attr_c = jnp.where(
        inst.has_texture[:, None, None], uv0, inst.vertex_colors
    )
    fd, verts_cam = jax.vmap(_face_screen_data)(
        inst.vertices, inst.faces, inst.faces_mask, TCO, K
    )
    face_id = visibility(fd, resolution)
    out = jax.vmap(_shade)(
        face_id, fd, inst.faces, verts_cam, attr_c, inst.vertex_normals, TCO
    )
    albedo = resolve_albedo(out.rgb, assets.textures, obj_ids, inst.has_texture)
    rgb = shade_lambert(
        albedo, out.normals, light_ambient, light_diffuse, lights
    )
    rgb = jnp.where(out.mask[..., None], rgb, 0.0)
    return RenderOutput(
        rgb=rgb, depth=out.depth, mask=out.mask, normals=out.normals
    )


@partial(
    jax.jit,
    static_argnames=("resolution", "light_ambient", "light_diffuse"),
)
def render_batch(
    assets: RenderAssets,
    obj_ids: jax.Array,
    TCO: jax.Array,
    K: jax.Array,
    resolution: Tuple[int, int] = (240, 320),
    light_ambient: float = 0.6,
    light_diffuse: float = 0.6,
    lights: Optional[jax.Array] = None,
) -> RenderOutput:
    """Render B object instances, one per output image.

    Args:
      assets: padded triangle database (RenderAssets).
      obj_ids: [B] int32 object indices into the database.
      TCO: [B, 4, 4] camera-from-object poses.
      K: [B, 3, 3] intrinsics of each (crop) camera.
      resolution: (H, W), static.
      lights: optional [B, 5] per-image lighting (see `shade_lambert`);
        overrides the static headlight scalars.
    Returns:
      RenderOutput with [B, ...] arrays.
    """
    return render_with(
        zbuffer_reference, assets, obj_ids, TCO, K, resolution,
        light_ambient, light_diffuse, lights,
    )
