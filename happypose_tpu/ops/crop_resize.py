"""Crop+resize as separable matmuls (a dense form of roi_align).

`roi_align` in ops/roi_align.py is gather-based — semantically exact, with
scattered per-pixel gathers. Because ROI crops are axis-aligned scale+translate
resamplings, the same bilinear sampling (torchvision aligned=False semantics,
including the border zeroing/clamping rules and the sampling_ratio
anti-aliasing average) is expressible as one interpolation matrix per axis:

    out[b] = Ry[b] @ img[b] @ Rx[b]^T

with Ry [out_h, H] / Rx [out_w, W] having <= sampling_ratio+1 nonzeros per
row. Built densely and applied as two matrix products. Which of the two
forms is faster on the GPU is not measured yet (ROADMAP.md S5).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _axis_matrix(
    starts: jax.Array,  # [B] crop start (x1 or y1)
    sizes: jax.Array,  # [B] crop extent
    in_dim: int,
    out_dim: int,
    s: int,
    dtype,
) -> jax.Array:
    """[B, out_dim, in_dim] interpolation-and-average matrix for one axis."""
    B = starts.shape[0]
    bin_sz = sizes / out_dim  # [B]
    # sample positions: start + (o*s + i + 0.5) * bin/s for o in out, i in s
    samp = (
        jnp.arange(out_dim * s, dtype=dtype)[None, :] + 0.5
    ) * (bin_sz[:, None] / s) + starts[:, None]  # [B, out*s]
    valid = (samp > -1.0) & (samp < in_dim)
    y = jnp.clip(samp, 0.0, in_dim - 1)  # [B, out*s]
    idx = jnp.arange(in_dim, dtype=dtype)  # [in]
    # hat weights: exactly reproduces 2-tap bilinear after clamping
    w = jnp.maximum(0.0, 1.0 - jnp.abs(y[:, :, None] - idx[None, None, :]))
    w = jnp.where(valid[:, :, None], w, 0.0)  # [B, out*s, in]
    w = w.reshape(B, out_dim, s, in_dim).mean(axis=2)  # fold the s-average
    return w


@partial(
    jax.jit, static_argnames=("output_size", "sampling_ratio", "matmul_dtype")
)
def roi_align_matmul(
    images: jax.Array,
    boxes: jax.Array,
    output_size: tuple,
    sampling_ratio: int = 4,
    matmul_dtype=None,
) -> jax.Array:
    """Drop-in equivalent of ops.roi_align.roi_align (one ROI per image).

    Args:
      images: [B, C, H, W]; boxes: [B, 4] (x1, y1, x2, y2).
      matmul_dtype: optional lower-precision dtype for the matmul passes
        (f32 accumulation); the bf16 compute path feeds bf16 CNNs, where
        resampling at ~1/256 precision is lossless downstream.
    Returns:
      [B, C, out_h, out_w] in the input dtype.
    """
    B, C, H, W = images.shape
    out_h, out_w = output_size
    dtype = images.dtype
    Ry = _axis_matrix(
        boxes[:, 1], boxes[:, 3] - boxes[:, 1], H, out_h, sampling_ratio, dtype
    )  # [B, out_h, H]
    Rx = _axis_matrix(
        boxes[:, 0], boxes[:, 2] - boxes[:, 0], W, out_w, sampling_ratio, dtype
    )  # [B, out_w, W]
    if matmul_dtype is not None:
        Ry = Ry.astype(matmul_dtype)
        Rx = Rx.astype(matmul_dtype)
        images = images.astype(matmul_dtype)
    tmp = jnp.einsum(
        "bih,bchw->bciw", Ry, images, preferred_element_type=dtype
    )
    out = jnp.einsum(
        "bciw,bjw->bcij", tmp.astype(Ry.dtype), Rx,
        preferred_element_type=dtype,
    )
    return out.astype(dtype)


def crop_images_matmul(
    images: jax.Array,
    boxes: jax.Array,
    output_size: tuple,
    sampling_ratio: int = 4,
    matmul_dtype=None,
) -> jax.Array:
    """RGB(+depth) crop with depth invalidation (see roi_align.crop_images)."""
    crops = roi_align_matmul(
        images, boxes, output_size, sampling_ratio, matmul_dtype
    )
    if images.shape[1] == 4:
        # depth validity stays full precision (exact >= 0.99 threshold)
        depth_valid = (images[:, 3:4] > 0).astype(images.dtype)
        valid_crop = roi_align_matmul(
            depth_valid, boxes, output_size, sampling_ratio
        )
        mask = (valid_crop >= 0.99).astype(images.dtype)
        crops = crops.at[:, 3:4].multiply(mask)
    return crops
