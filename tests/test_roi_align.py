"""roi_align vs a slow, independent numpy oracle implementing the
torchvision aligned=False semantics the reference crop path relies on."""

import numpy as np
import jax.numpy as jnp

from happypose_tpu.ops.roi_align import roi_align, crop_images


def roi_align_oracle(images, boxes, output_size, sampling_ratio):
    B, C, H, W = images.shape
    oh, ow = output_size
    s = sampling_ratio
    out = np.zeros((B, C, oh, ow), np.float64)

    def sample(img, y, x):
        if y <= -1 or y >= H or x <= -1 or x >= W:
            return np.zeros(C)
        y = min(max(y, 0.0), H - 1)
        x = min(max(x, 0.0), W - 1)
        y0, x0 = int(np.floor(y)), int(np.floor(x))
        y1, x1 = min(y0 + 1, H - 1), min(x0 + 1, W - 1)
        ly, lx = y - y0, x - x0
        return (
            img[:, y0, x0] * (1 - ly) * (1 - lx)
            + img[:, y0, x1] * (1 - ly) * lx
            + img[:, y1, x0] * ly * (1 - lx)
            + img[:, y1, x1] * ly * lx
        )

    for b in range(B):
        x1, y1, x2, y2 = boxes[b]
        bin_h = (y2 - y1) / oh
        bin_w = (x2 - x1) / ow
        for ph in range(oh):
            for pw in range(ow):
                acc = np.zeros(C)
                for iy in range(s):
                    for ix in range(s):
                        y = y1 + (ph + (iy + 0.5) / s) * bin_h
                        x = x1 + (pw + (ix + 0.5) / s) * bin_w
                        acc += sample(images[b], y, x)
                out[b, :, ph, pw] = acc / (s * s)
    return out


def test_roi_align_matches_oracle():
    rs = np.random.RandomState(0)
    images = rs.rand(2, 3, 24, 32).astype(np.float32)
    boxes = np.array([[4.5, 3.2, 20.0, 18.7], [-2.0, 5.0, 35.0, 30.0]], np.float32)
    out = np.asarray(roi_align(jnp.asarray(images), jnp.asarray(boxes), (8, 10), 4))
    ref = roi_align_oracle(images, boxes, (8, 10), 4)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_crop_images_depth_invalidation():
    rs = np.random.RandomState(1)
    images = rs.rand(1, 4, 16, 16).astype(np.float32) + 0.5
    images[0, 3, :, :8] = 0.0  # invalid depth half
    boxes = np.array([[4.0, 4.0, 12.0, 12.0]], np.float32)
    crops = np.asarray(crop_images(jnp.asarray(images), jnp.asarray(boxes), (8, 8)))
    # left half of the depth crop must be zeroed (mixed valid/invalid border too)
    assert np.all(crops[0, 3, :, :3] == 0.0)
    assert np.all(crops[0, 3, :, 5:] > 0.0)
    # rgb untouched by the depth mask
    assert np.all(crops[0, :3] > 0.0)


def test_matmul_crop_matches_gather():
    from happypose_tpu.ops.crop_resize import roi_align_matmul
    import jax.numpy as jnp

    rs = np.random.RandomState(2)
    images = rs.rand(3, 4, 24, 32).astype(np.float32)
    boxes = np.array(
        [[4.5, 3.2, 20.0, 18.7], [-2.0, 5.0, 35.0, 30.0], [0.0, 0.0, 32.0, 24.0]],
        np.float32,
    )
    a = np.asarray(roi_align(jnp.asarray(images), jnp.asarray(boxes), (8, 10), 4))
    b = np.asarray(
        roi_align_matmul(jnp.asarray(images), jnp.asarray(boxes), (8, 10), 4)
    )
    np.testing.assert_allclose(a, b, atol=2e-5)


def test_matmul_dtype_bf16_close_to_f32():
    """bf16 matmul crop path (the bf16-CNN feed) stays within bf16 tolerance
    of the exact f32 resampling."""
    import jax.numpy as jnp
    from happypose_tpu.ops.crop_resize import roi_align_matmul

    rs = np.random.RandomState(0)
    images = jnp.asarray(rs.rand(2, 3, 60, 80).astype(np.float32))
    boxes = jnp.asarray([[10.0, 5.0, 70.0, 55.0], [0.0, 0.0, 40.0, 30.0]])
    a = roi_align_matmul(images, boxes, (24, 32))
    b = roi_align_matmul(images, boxes, (24, 32), matmul_dtype=jnp.bfloat16)
    assert b.dtype == a.dtype
    assert float(jnp.abs(a - b).max()) < 0.02
