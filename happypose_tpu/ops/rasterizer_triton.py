"""Visibility pass of the rasterizer as a Pallas kernel on the Triton route.

Same outputs as `rasterizer.render_batch`: this module replaces only its
visibility pass (per-pixel closest face id); projection and shading are the
shared XLA code of `rasterizer.render_with`.

Design, for a GPU (blocks run in parallel, registers are the scarce store):

- Grid (image, pixel tile). Each block owns one TILE_H x TILE_W tile and
  keeps the tile's best 1/z and face id in registers; nothing carries from
  one block to another.
- Per image, XLA packs every face into one 16-float record (vertex-0
  anchored edge coefficients, |area| and its inverse, the three vertex 1/z
  and their range), sorts the records along a Morton curve of their screen
  box centers and groups them into CHUNK-face chunks with one screen box
  each.
- The block walks the chunks; a chunk whose box misses the tile costs one
  scalar test. For a chunk that overlaps, each face's edge functions and
  1/z are evaluated by f32 FMA over the tile's pixels, with the same
  vertex-0-centered formulas as `rasterizer._zbuffer_scan`, so the two
  passes pick the same faces up to rounding.
- The face id goes straight into the [B, H, W] image layout, masked at the
  right and bottom edges.

`interpret=True` runs the kernel through the Pallas interpreter (CPU tests
only).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from happypose_tpu.meshes.database import RenderAssets
from happypose_tpu.ops.rasterizer import RenderOutput, _FaceData, render_with

TILE_H = 16
TILE_W = 32
CHUNK = 32  # faces per culling box
NUM_WARPS = 4
N_FIELDS = 16  # floats per packed face record (13 used, padded to 64 B)
_MORTON_BITS = 11  # screen-box centers quantised to 2048 px per axis


def _spread_bits(x: jax.Array) -> jax.Array:
    """Interleave zeros between the low 16 bits of `x` (Morton helper)."""
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    return (x | (x << 1)) & 0x55555555


def _pack_faces(fd: _FaceData, n_chunks: int):
    """One image's faces -> sorted records [Fp, N_FIELDS], chunk boxes
    [n_chunks, 4] (umin, vmin, umax, vmax) and the sort permutation [Fp]."""
    u0, u1, u2 = fd.u[:, 0], fd.u[:, 1], fd.u[:, 2]
    v0, v1, v2 = fd.v[:, 0], fd.v[:, 1], fd.v[:, 2]
    e1u, e1v = u1 - u0, v1 - v0
    e2u, e2v = u2 - u0, v2 - v0
    area = e1u * e2v - e2u * e1v
    ok = fd.valid & (jnp.abs(area) > 1e-12)
    s = jnp.sign(area)
    abs_area = jnp.where(ok, jnp.abs(area), 1.0)
    # invalid faces get 1/z = -1 everywhere: they never beat the empty
    # z-buffer (1/z = 0)
    iz = jnp.where(ok[:, None], fd.inv_z, -1.0)
    zero = jnp.zeros_like(u0)
    rec = jnp.stack(
        [
            u0, v0, s * e2v, s * e2u, s * e1u, s * e1v, abs_area,
            1.0 / abs_area, iz[:, 0], iz[:, 1], iz[:, 2],
            jnp.min(iz, axis=1), jnp.max(iz, axis=1), zero, zero, zero,
        ],
        axis=-1,
    )
    big = jnp.float32(3e38)
    umin = jnp.where(ok, jnp.min(fd.u, axis=1), big)
    vmin = jnp.where(ok, jnp.min(fd.v, axis=1), big)
    umax = jnp.where(ok, jnp.max(fd.u, axis=1), -big)
    vmax = jnp.where(ok, jnp.max(fd.v, axis=1), -big)

    hi = (1 << _MORTON_BITS) - 1
    cu = jnp.clip((umin + umax) * 0.5, 0, hi).astype(jnp.int32)
    cv = jnp.clip((vmin + vmax) * 0.5, 0, hi).astype(jnp.int32)
    key = (_spread_bits(cv) << 1) | _spread_bits(cu)
    key = jnp.where(ok, key, 1 << (2 * _MORTON_BITS))  # invalid faces last
    perm = jnp.argsort(key)

    box = jnp.stack([umin, vmin, umax, vmax], axis=-1)[perm]
    box = box.reshape(n_chunks, CHUNK, 4)
    chunk_box = jnp.concatenate(
        [jnp.min(box[..., :2], axis=1), jnp.max(box[..., 2:], axis=1)], -1
    )
    return rec[perm], chunk_box, perm


def _visibility_kernel(face_ref, box_ref, id_ref, *, height, width, n_tw,
                       n_chunks):
    b = pl.program_id(0)
    t = pl.program_id(1)
    r0 = (t // n_tw) * TILE_H
    c0 = (t % n_tw) * TILE_W
    rows = r0 + jnp.arange(TILE_H, dtype=jnp.int32)[:, None]
    cols = c0 + jnp.arange(TILE_W, dtype=jnp.int32)[None, :]
    pv = jnp.broadcast_to(rows.astype(jnp.float32), (TILE_H, TILE_W))
    pu = jnp.broadcast_to(cols.astype(jnp.float32), (TILE_H, TILE_W))
    tu0 = c0.astype(jnp.float32)
    tv0 = r0.astype(jnp.float32)

    def face(f, carry):
        best_iz, best_id = carry
        fu = pu - face_ref[b, f, 0]
        fv = pv - face_ref[b, f, 1]
        # w_k are the reference's edge functions times sign(area)
        w1 = fu * face_ref[b, f, 2] - fv * face_ref[b, f, 3]
        w2 = fv * face_ref[b, f, 4] - fu * face_ref[b, f, 5]
        w0 = face_ref[b, f, 6] - w1 - w2
        cov = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        iz = (
            w0 * face_ref[b, f, 8] + w1 * face_ref[b, f, 9]
            + w2 * face_ref[b, f, 10]
        ) * face_ref[b, f, 7]
        # 1/z is affine in screen space; clamp to the vertex range so
        # degenerate faces can never fabricate a closer depth
        iz = jnp.minimum(jnp.maximum(iz, face_ref[b, f, 11]), face_ref[b, f, 12])
        closer = cov & (iz > best_iz)
        return jnp.where(closer, iz, best_iz), jnp.where(closer, f, best_id)

    def chunk(c, carry):
        overlap = (
            (box_ref[b, c, 2] >= tu0)
            & (box_ref[b, c, 0] <= tu0 + (TILE_W - 1))
            & (box_ref[b, c, 3] >= tv0)
            & (box_ref[b, c, 1] <= tv0 + (TILE_H - 1))
        )
        return jax.lax.cond(
            overlap,
            lambda cr: jax.lax.fori_loop(
                0, CHUNK, lambda k, cr2: face(c * CHUNK + k, cr2), cr
            ),
            lambda cr: cr,
            carry,
        )

    init = (
        jnp.zeros((TILE_H, TILE_W), jnp.float32),
        jnp.full((TILE_H, TILE_W), -1, jnp.int32),
    )
    _, best_id = jax.lax.fori_loop(0, n_chunks, chunk, init)
    plgpu.store(
        id_ref.at[b, pl.ds(r0, TILE_H), pl.ds(c0, TILE_W)],
        best_id,
        mask=(rows < height) & (cols < width),
    )


def zbuffer_triton(
    fd: _FaceData, resolution: Tuple[int, int], interpret: bool = False
) -> jax.Array:
    """Visibility pass: batched face screen data -> [B, H, W] face ids
    (-1 = background), the contract of `rasterizer.zbuffer_reference`."""
    H, W = resolution
    B, F = fd.u.shape[:2]
    n_chunks = pl.cdiv(F, CHUNK)
    pad = n_chunks * CHUNK - F
    fd = _FaceData(
        u=jnp.pad(fd.u, ((0, 0), (0, pad), (0, 0))),
        v=jnp.pad(fd.v, ((0, 0), (0, pad), (0, 0))),
        inv_z=jnp.pad(fd.inv_z, ((0, 0), (0, pad), (0, 0)),
                      constant_values=1.0),
        valid=jnp.pad(fd.valid, ((0, 0), (0, pad))),
    )
    rec, chunk_box, perm = jax.vmap(partial(_pack_faces, n_chunks=n_chunks))(fd)
    n_th, n_tw = pl.cdiv(H, TILE_H), pl.cdiv(W, TILE_W)
    sorted_id = pl.pallas_call(
        partial(_visibility_kernel, height=H, width=W, n_tw=n_tw,
                n_chunks=n_chunks),
        out_shape=jax.ShapeDtypeStruct((B, H, W), jnp.int32),
        grid=(B, n_th * n_tw),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="raster_visibility",
    )(rec, chunk_box)
    flat = sorted_id.reshape(B, H * W)
    face_id = jnp.take_along_axis(perm, jnp.maximum(flat, 0), axis=1)
    return jnp.where(flat >= 0, face_id, -1).reshape(B, H, W)


@partial(
    jax.jit,
    static_argnames=("resolution", "light_ambient", "light_diffuse",
                     "interpret"),
)
def render_batch_triton(
    assets: RenderAssets,
    obj_ids: jax.Array,
    TCO: jax.Array,
    K: jax.Array,
    resolution: Tuple[int, int] = (240, 320),
    light_ambient: float = 0.6,
    light_diffuse: float = 0.6,
    lights: Optional[jax.Array] = None,
    interpret: bool = False,
) -> RenderOutput:
    """`rasterizer.render_batch` with the visibility pass as a GPU kernel."""
    return render_with(
        partial(zbuffer_triton, interpret=interpret), assets, obj_ids, TCO, K,
        resolution, light_ambient, light_diffuse, lights,
    )
