"""Object detector with instance masks (single-stage, static shapes).

Capability parity target: the reference's `DetectorMaskRCNN`
(/root/reference/happypose/pose_estimators/cosypose/cosypose/models/
mask_rcnn.py:6-27 — torchvision Mask R-CNN, resnet50-FPN) and its wrapper
`Detector.get_detections` (cosypose/integrated/detector.py:16-131).

Design delta (SURVEY.md §7): a two-stage detector's dynamic
proposal shapes are hostile to XLA; this is an anchor-free FCOS-style dense
detector (Tian et al., ICCV'19) with a YOLACT-style prototype mask branch
(Bolya et al., ICCV'19) on a ResNet50-FPN. Everything — training loss and
inference (top-k + NMS over a fixed budget) — is static-shape and jittable.
The pipeline-facing API matches the reference: boxes, labels, scores,
binary masks.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from happypose_tpu.models.layers import (
    Module, Scope, batch_norm, conv, init, max_pool,
)

Dtype = Any
relu = jax.nn.relu


def bottleneck(s: Scope, x, planes: int, stride: int, downsample: bool,
               dtype: Dtype, bn_axis_name: Optional[str], train: bool):
    norm = partial(
        batch_norm, train=train, momentum=0.9, dtype=dtype,
        axis_name=bn_axis_name if train else None,
    )
    residual = x
    out = relu(norm(s, conv(s, x, planes, 1, use_bias=False, dtype=dtype)))
    out = relu(norm(s, conv(s, out, planes, 3, strides=stride, padding=1,
                            use_bias=False, dtype=dtype)))
    out = norm(s, conv(s, out, planes * 4, 1, use_bias=False, dtype=dtype))
    if downsample:
        residual = norm(s, conv(s, x, planes * 4, 1, strides=stride,
                                use_bias=False, dtype=dtype))
    return relu(out + residual)


def resnet50_fpn(s: Scope, x, fpn_channels: int, dtype: Dtype,
                 bn_axis_name: Optional[str], train: bool):
    """ResNet50 backbone + FPN; returns (pyramid levels P3..P7, C2), NHWC."""
    norm = partial(
        batch_norm, train=train, momentum=0.9, dtype=dtype,
        axis_name=bn_axis_name if train else None,
    )
    x = conv(s, x, 64, 7, strides=2, padding=3, use_bias=False, dtype=dtype)
    x = relu(norm(s, x))
    x = max_pool(x, 3, 2, 1)

    feats = []
    for stage, (planes, blocks) in enumerate(
        zip((64, 128, 256, 512), (3, 4, 6, 3))
    ):
        stride = 1 if stage == 0 else 2
        for b in range(blocks):
            x = bottleneck(
                s.auto("Bottleneck"), x, planes, stride if b == 0 else 1,
                b == 0, dtype, bn_axis_name, train,
            )
        feats.append(x)
    c2, c3, c4, c5 = feats

    # FPN top-down
    fpn = partial(conv, s, features=fpn_channels, dtype=dtype)
    p5 = fpn(c5, kernel=1)
    p4 = fpn(c4, kernel=1)
    p3 = fpn(c3, kernel=1)
    p4 = p4 + jax.image.resize(p5, p4.shape, "nearest")
    p3 = p3 + jax.image.resize(p4, p3.shape, "nearest")
    p3 = fpn(p3, kernel=3, padding=1)
    p4 = fpn(p4, kernel=3, padding=1)
    p5 = fpn(p5, kernel=3, padding=1)
    p6 = fpn(p5, kernel=3, strides=2, padding=1)
    p7 = fpn(relu(p6), kernel=3, strides=2, padding=1)
    return [p3, p4, p5, p6, p7], c2


@dataclass(frozen=True)
class DetectorConfig:
    n_classes: int  # number of object labels (background-free)
    n_prototypes: int = 16
    fpn_channels: int = 256
    head_depth: int = 2
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    compute_dtype: str = "float32"
    bn_axis_name: Optional[str] = None


class DetectorOutputs(NamedTuple):
    cls_logits: jax.Array  # [B, L, n_classes] over all pyramid locations
    box_reg: jax.Array  # [B, L, 4] distances l, t, r, b (stride-scaled)
    centerness: jax.Array  # [B, L]
    mask_coeffs: jax.Array  # [B, L, n_proto]
    prototypes: jax.Array  # [B, Hp, Wp, n_proto] (P3/2 resolution)
    locations: jax.Array  # [L, 2] (u, v) pixel centers
    level_ids: jax.Array  # [L]


@dataclass(frozen=True)
class FCOSDetector(Module):
    cfg: DetectorConfig

    def forward(self, s: Scope, images, train: bool = False) -> DetectorOutputs:
        """images: [B, 3, H, W] in [0, 1]."""
        cfg = self.cfg
        dtype = (
            jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32
        )
        x = jnp.moveaxis(images, 1, -1).astype(dtype)
        pyramid, c2 = resnet50_fpn(
            s.auto("ResNet50FPN"), x, cfg.fpn_channels, dtype,
            cfg.bn_axis_name, train,
        )

        # heads shared across levels: the same names reuse the same weights
        head = partial(conv, s, kernel=3, padding=1, dtype=dtype)

        all_cls, all_box, all_ctr, all_coef = [], [], [], []
        all_loc, all_lvl = [], []
        for lvl, (p, stride) in enumerate(zip(pyramid, cfg.strides)):
            c = p
            for i in range(cfg.head_depth):
                c = relu(head(c, cfg.fpn_channels, name=f"cls_tower_{i}"))
            b = p
            for i in range(cfg.head_depth):
                b = relu(head(b, cfg.fpn_channels, name=f"box_tower_{i}"))
            cls = head(
                c, cfg.n_classes, name="cls_head",
                bias_init=init.constant(-4.6),  # focal prior ~0.01
            )
            box = jnp.exp(head(b, 4, name="box_head")) * stride  # positive
            ctr = head(b, 1, name="ctr_head")[..., 0]
            coef = jnp.tanh(head(c, cfg.n_prototypes, name="coef_head"))
            B, Hl, Wl = cls.shape[:3]
            all_cls.append(cls.reshape(B, Hl * Wl, -1).astype(jnp.float32))
            all_box.append(box.reshape(B, Hl * Wl, 4).astype(jnp.float32))
            all_ctr.append(ctr.reshape(B, Hl * Wl).astype(jnp.float32))
            all_coef.append(coef.reshape(B, Hl * Wl, -1).astype(jnp.float32))
            uu = (jnp.arange(Wl) + 0.5) * stride
            vv = (jnp.arange(Hl) + 0.5) * stride
            loc = jnp.stack(
                [jnp.tile(uu, Hl), jnp.repeat(vv, Wl)], axis=-1
            )
            all_loc.append(loc)
            all_lvl.append(jnp.full((Hl * Wl,), lvl, jnp.int32))

        # prototype masks from P3 (upsampled 2x)
        proto = pyramid[0]
        for _ in range(2):
            proto = relu(
                conv(s, proto, cfg.fpn_channels // 2, 3, padding=1,
                     dtype=dtype)
            )
        proto = jax.image.resize(
            proto, (proto.shape[0], proto.shape[1] * 2, proto.shape[2] * 2,
                    proto.shape[3]), "bilinear",
        )
        proto = conv(s, proto, cfg.n_prototypes, 1, dtype=dtype)
        proto = relu(proto).astype(jnp.float32)

        return DetectorOutputs(
            cls_logits=jnp.concatenate(all_cls, axis=1),
            box_reg=jnp.concatenate(all_box, axis=1),
            centerness=jnp.concatenate(all_ctr, axis=1),
            mask_coeffs=jnp.concatenate(all_coef, axis=1),
            prototypes=proto,
            locations=jnp.concatenate(all_loc, axis=0),
            level_ids=jnp.concatenate(all_lvl, axis=0),
        )


# ----------------------------------------------------------------------
# Inference: decode + NMS (static shapes)
# ----------------------------------------------------------------------


def decode_boxes(locations: jax.Array, box_reg: jax.Array) -> jax.Array:
    """FCOS distances (l, t, r, b) -> (x1, y1, x2, y2)."""
    u, v = locations[..., 0], locations[..., 1]
    l, t, r, b = box_reg[..., 0], box_reg[..., 1], box_reg[..., 2], box_reg[..., 3]
    return jnp.stack([u - l, v - t, u + r, v + b], axis=-1)


def _iou_matrix(boxes: jax.Array) -> jax.Array:
    """[N, N] IoU."""
    area = jnp.maximum(boxes[:, 2] - boxes[:, 0], 0) * jnp.maximum(
        boxes[:, 3] - boxes[:, 1], 0
    )
    x1 = jnp.maximum(boxes[:, None, 0], boxes[None, :, 0])
    y1 = jnp.maximum(boxes[:, None, 1], boxes[None, :, 1])
    x2 = jnp.minimum(boxes[:, None, 2], boxes[None, :, 2])
    y2 = jnp.minimum(boxes[:, None, 3], boxes[None, :, 3])
    inter = jnp.maximum(x2 - x1, 0) * jnp.maximum(y2 - y1, 0)
    return inter / jnp.maximum(area[:, None] + area[None, :] - inter, 1e-9)


def nms_fixed(
    boxes: jax.Array, scores: jax.Array, labels: jax.Array,
    iou_threshold: float = 0.5, max_out: int = 32,
) -> Tuple[jax.Array, jax.Array]:
    """Class-aware NMS over a fixed candidate budget.

    Returns (keep_idx [max_out], keep_valid [max_out])."""
    N = boxes.shape[0]
    iou = _iou_matrix(boxes)
    same_class = labels[:, None] == labels[None, :]
    suppress_pair = (iou > iou_threshold) & same_class

    order = jnp.argsort(-scores)

    def body(i, state):
        alive, keep, kv, nk = state
        cand = order[i]
        ok = alive[cand] & (nk < max_out)
        keep = keep.at[jnp.minimum(nk, max_out - 1)].set(
            jnp.where(ok, cand, keep[jnp.minimum(nk, max_out - 1)])
        )
        kv = kv.at[jnp.minimum(nk, max_out - 1)].set(
            jnp.where(ok, True, kv[jnp.minimum(nk, max_out - 1)])
        )
        nk = nk + ok.astype(jnp.int32)
        alive = alive & (~suppress_pair[cand] | ~ok)
        return alive, keep, kv, nk

    alive0 = jnp.ones((N,), bool)
    keep0 = jnp.zeros((max_out,), jnp.int32)
    kv0 = jnp.zeros((max_out,), bool)
    alive, keep, kv, nk = jax.lax.fori_loop(
        0, N, body, (alive0, keep0, kv0, jnp.int32(0))
    )
    return keep, kv


@partial(
    jax.jit,
    static_argnames=("score_threshold", "iou_threshold", "pre_nms_topk",
                     "max_detections", "mask_threshold"),
)
def detector_postprocess(
    out: DetectorOutputs,
    score_threshold: float = 0.3,
    iou_threshold: float = 0.5,
    pre_nms_topk: int = 256,
    max_detections: int = 32,
    mask_threshold: float = 0.5,
) -> Dict[str, jax.Array]:
    """Decode one batch of detector outputs into fixed-size detections.

    Returns dict of [B, max_detections, ...] arrays + valid mask and
    [B, max_detections, Hm, Wm] instance masks (prototype resolution)."""

    def per_image(cls_logits, box_reg, ctr, coeffs, protos, locations):
        probs = jax.nn.sigmoid(cls_logits) * jax.nn.sigmoid(ctr)[:, None]
        best_c = jnp.argmax(probs, axis=-1)
        best_p = jnp.max(probs, axis=-1)
        k = min(pre_nms_topk, best_p.shape[0])
        top_p, top_i = jax.lax.top_k(best_p, k)
        boxes = decode_boxes(locations[top_i], box_reg[top_i])
        labels = best_c[top_i]
        keep, kv = nms_fixed(
            boxes, top_p, labels, iou_threshold, max_detections
        )
        sel_boxes = boxes[keep]
        sel_scores = top_p[keep]
        sel_labels = labels[keep]
        sel_valid = kv & (sel_scores > score_threshold)
        sel_coeffs = coeffs[top_i][keep]  # [max_out, n_proto]
        masks = jax.nn.sigmoid(
            jnp.einsum("hwp,np->nhw", protos, sel_coeffs)
        )
        # crop masks to their boxes (YOLACT crop) at prototype scale
        Hm, Wm = masks.shape[1:]
        scale = 4.0  # prototypes are stride-4
        mu = (jnp.arange(Wm) + 0.5) * scale
        mv = (jnp.arange(Hm) + 0.5) * scale
        in_box = (
            (mu[None, None, :] >= sel_boxes[:, None, None, 0])
            & (mu[None, None, :] <= sel_boxes[:, None, None, 2])
            & (mv[None, :, None] >= sel_boxes[:, None, None, 1])
            & (mv[None, :, None] <= sel_boxes[:, None, None, 3])
        )
        masks = jnp.where(in_box, masks, 0.0) > mask_threshold
        return sel_boxes, sel_scores, sel_labels, sel_valid, masks

    boxes, scores, labels, valid, masks = jax.vmap(per_image)(
        out.cls_logits, out.box_reg, out.centerness, out.mask_coeffs,
        out.prototypes, jnp.broadcast_to(
            out.locations, (out.cls_logits.shape[0],) + out.locations.shape
        ),
    )
    return {
        "boxes": boxes, "scores": scores, "labels": labels, "valid": valid,
        "masks": masks,
    }
