"""Training augmentations (device-side, jax.random driven).

Parity target: /root/reference/happypose/toolbox/datasets/augmentations.py
(551 LoC): CropResizeToAspect, background replacement (p=0.3), Pillow-style
blur/sharpness/contrast/brightness/color jitter (p=0.8 composite), and the
3-level depth augmentations (blur, correlated gaussian noise, ellipse
dropout, missing pixels).

Design delta: the reference runs PIL per sample in DataLoader workers; here
every augmentation is a batched jit-compatible array op so the whole
training input pipeline can run on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def _blur_kernel(sigma: float, radius: int) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    return k / k.sum()


def gaussian_blur(images: jax.Array, sigma: float, radius: int = 3) -> jax.Array:
    """Separable gaussian blur; images [B, C, H, W]."""
    k = _blur_kernel(sigma, radius)
    B, C, H, W = images.shape
    x = images.reshape(B * C, 1, H, W)
    kx = k.reshape(1, 1, 1, -1)
    ky = k.reshape(1, 1, -1, 1)
    x = jax.lax.conv_general_dilated(
        x, kx, (1, 1), [(0, 0), (radius, radius)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    x = jax.lax.conv_general_dilated(
        x, ky, (1, 1), [(radius, radius), (0, 0)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    return x.reshape(B, C, H, W)


def rgb_jitter(
    key: jax.Array,
    images: jax.Array,  # [B, 3, H, W] in [0, 1]
    p_apply: float = 0.8,
    brightness: float = 0.3,
    contrast: float = 0.3,
    saturation: float = 0.3,
    sharpness: float = 0.5,
    blur_sigma_max: float = 1.2,
) -> jax.Array:
    """Pillow-equivalent enhancement jitters, each gated per image."""
    B = images.shape[0]
    keys = jax.random.split(key, 7)

    def gate(k):
        return (jax.random.uniform(k, (B, 1, 1, 1)) < p_apply).astype(
            images.dtype
        )

    # brightness: img * f
    f = 1.0 + jax.random.uniform(
        keys[0], (B, 1, 1, 1), minval=-brightness, maxval=brightness
    )
    images = images * (1 + gate(keys[1]) * (f - 1))
    # contrast: lerp to mean luminance
    lum = jnp.mean(images, axis=(1, 2, 3), keepdims=True)
    f = 1.0 + jax.random.uniform(
        keys[2], (B, 1, 1, 1), minval=-contrast, maxval=contrast
    )
    fc = 1 + gate(keys[2]) * (f - 1)
    images = lum + (images - lum) * fc
    # saturation (color): lerp to grayscale
    gray = jnp.mean(images, axis=1, keepdims=True)
    f = 1.0 + jax.random.uniform(
        keys[3], (B, 1, 1, 1), minval=-saturation, maxval=saturation
    )
    fs = 1 + gate(keys[3]) * (f - 1)
    images = gray + (images - gray) * fs
    # sharpness / blur: unsharp-mask style lerp with a blurred copy
    blurred = gaussian_blur(images, sigma=blur_sigma_max)
    f = jax.random.uniform(
        keys[4], (B, 1, 1, 1), minval=-sharpness, maxval=sharpness
    )
    images = images + gate(keys[5]) * f * (images - blurred)
    return jnp.clip(images, 0.0, 1.0)


def background_replace(
    key: jax.Array,
    images: jax.Array,  # [B, 3, H, W]
    fg_mask: jax.Array,  # [B, H, W] bool (object pixels)
    backgrounds: Optional[jax.Array] = None,  # [N, 3, H, W] pool
    p_apply: float = 0.3,
) -> jax.Array:
    """Replace background pixels with a random image (VOC paste analog;
    falls back to smooth random noise when no pool is given)."""
    B, _, H, W = images.shape
    k1, k2, k3 = jax.random.split(key, 3)
    if backgrounds is None:
        low = jax.random.uniform(k1, (B, 3, H // 8, W // 8))
        bg = jax.image.resize(low, (B, 3, H, W), "linear")
    else:
        idx = jax.random.randint(k1, (B,), 0, backgrounds.shape[0])
        bg = backgrounds[idx]
    apply = (jax.random.uniform(k2, (B, 1, 1, 1)) < p_apply)
    out = jnp.where(fg_mask[:, None], images, bg)
    return jnp.where(apply, out, images)


def depth_augment(
    key: jax.Array,
    depth: jax.Array,  # [B, 1, H, W] meters, 0 = missing
    blur_sigma: float = 1.0,
    noise_std: float = 0.003,
    corr_noise_std: float = 0.005,
    ellipse_dropout_rate: float = 3.0,
    p_missing: float = 0.05,
) -> jax.Array:
    """Depth sensor simulation: blur, correlated + white noise, elliptical
    dropout patches, random missing pixels (augmentations.py:300+)."""
    B, _, H, W = depth.shape
    keys = jax.random.split(key, 5)
    valid = depth > 0

    d = gaussian_blur(depth, blur_sigma)
    # correlated noise: low-res gaussian upsampled
    low = jax.random.normal(keys[0], (B, 1, H // 8, W // 8)) * corr_noise_std
    corr = jax.image.resize(low, (B, 1, H, W), "linear")
    white = jax.random.normal(keys[1], depth.shape) * noise_std
    d = d + corr + white

    # elliptical dropout: a few random ellipses zeroed per image
    n_ell = int(ellipse_dropout_rate)
    uu = jnp.arange(W, dtype=jnp.float32)[None, :]
    vv = jnp.arange(H, dtype=jnp.float32)[:, None]
    drop = jnp.zeros((B, H, W), bool)
    ck = jax.random.split(keys[2], n_ell)
    for i in range(n_ell):
        kc, ka, kb, kr = jax.random.split(ck[i], 4)
        cx = jax.random.uniform(kc, (B, 1, 1), minval=0, maxval=W)
        cy = jax.random.uniform(ka, (B, 1, 1), minval=0, maxval=H)
        ra = jax.random.uniform(kb, (B, 1, 1), minval=2, maxval=W * 0.08)
        rb = jax.random.uniform(kr, (B, 1, 1), minval=2, maxval=H * 0.08)
        drop = drop | (
            ((uu - cx) / ra) ** 2 + ((vv - cy) / rb) ** 2 < 1.0
        )
    missing = jax.random.uniform(keys[3], (B, 1, H, W)) < p_missing
    d = jnp.where(drop[:, None] | missing | ~valid, 0.0, d)
    return jnp.maximum(d, 0.0)


def crop_resize_to_aspect(
    images: jax.Array,  # [B, C, H, W]
    K: jax.Array,  # [B, 3, 3]
    target_hw: Tuple[int, int],
) -> Tuple[jax.Array, jax.Array]:
    """Center-crop to the target aspect ratio then resize; updates K.

    Parity: CropResizeToAspectTransform (augmentations.py)."""
    from happypose_tpu.lib3d.camera import get_K_crop_resize
    from happypose_tpu.ops.crop_resize import roi_align_matmul

    B, C, H, W = images.shape
    th, tw = target_hw
    target_ratio = tw / th
    ratio = W / H
    if ratio > target_ratio:
        crop_w, crop_h = H * target_ratio, H
    else:
        crop_w, crop_h = W, W / target_ratio
    x1 = (W - crop_w) / 2
    y1 = (H - crop_h) / 2
    boxes = jnp.tile(
        jnp.asarray([x1, y1, x1 + crop_w, y1 + crop_h], jnp.float32), (B, 1)
    )
    out = roi_align_matmul(images, boxes, target_hw, sampling_ratio=2)
    K_new = get_K_crop_resize(K, boxes, (H, W), target_hw)
    return out, K_new
