"""Render-and-compare pose predictor.

Parity target: /root/reference/happypose/pose_estimators/megapose/models/
pose_rigid.py (`PosePredictor`, :96-788) and the simpler CosyPose variant
(cosypose/models/pose.py:116-199). Design deltas:

- The renderer is the on-device rasterizer, so the whole iteration
  (crop -> render -> CNN -> SE(3) update) is one jitted computation —
  no process boundary, no host math (`make_TCO_multiview` is closed-form).
- Labels are int32 object ids indexing padded mesh tensors; the per-instance
  point sets used for cropping come from `BatchedMeshes.select`.
- The pose head starts at the identity update (bias = identity ortho6d,
  vz = 1) so an untrained refiner is a no-op instead of a divergence.

The coarse hypothesis classifier is this same module with
`predict_rendered_views_logits=True, predict_pose_update=False`
(pose_rigid.py:676-788).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from happypose_tpu.lib3d.camera import (
    get_K_crop_resize,
    masked_boxes_from_uv,
    project_points_robust,
)
from happypose_tpu.lib3d.cropping import deepim_boxes
from happypose_tpu.lib3d.multiview_geom import make_TCO_multiview
from happypose_tpu.lib3d.pose_update import pose_update_with_reference_point
from happypose_tpu.lib3d.rotations import quat_to_rotmat, rotmat_from_ortho6d
from happypose_tpu.lib3d.transforms import normalize_T
from happypose_tpu.meshes.database import BatchedMeshes, RenderAssets
from happypose_tpu.ops.crop_resize import crop_images_matmul
from happypose_tpu.ops.renderers import get_renderer
from happypose_tpu.models.layers import Module, Scope, Context, dense, init
from happypose_tpu.models.backbones import (
    EfficientNetB3,
    FlowNetS,
    ResNet34,
    WideResNet18,
    WideResNet34,
)


@dataclass(frozen=True)
class PosePredictorConfig:
    """Static model configuration (hashable; safe as a jit static argument)."""

    backbone: str = "resnet34"  # resnet34 | wide_resnet18 | wide_resnet34
    #   | efficientnet_b3 | flownet
    render_size: Tuple[int, int] = (240, 320)
    multiview_type: str = "TCO"  # TCO | front_1view | front_3views | sphere_26views
    remove_TCO_rendering: bool = False
    views_inplane_rotations: bool = False
    render_normals: bool = True
    render_depth: bool = False
    input_depth: bool = False
    depth_normalization_type: str = "tCR_scale_clamp_center"
    predict_pose_update: bool = True
    predict_rendered_views_logits: bool = False
    # ortho6d (9 outputs, default) | quaternion (7 outputs, the reference
    # CosyPose models' older head: cosypose/models/pose.py:95-106)
    pose_head: str = "ortho6d"
    crop_lamb: float = 1.4
    compute_dtype: str = "float32"  # float32 | bfloat16
    # triton | reference; None: the platform's renderer (ops/renderers.py)
    renderer: Optional[str] = None
    bn_axis_name: Optional[str] = None

    @property
    def n_views(self) -> int:
        base = {"TCO": 0, "front_1view": 1, "front_3views": 3,
                "front_5views": 5, "sphere_26views": 26}[self.multiview_type]
        n = base + (0 if (self.remove_TCO_rendering and self.multiview_type != "TCO")
                    else 1)
        if self.multiview_type == "TCO":
            n = 1
        if self.views_inplane_rotations:
            n *= 4
        return n

    @property
    def n_render_channels(self) -> int:
        return 3 + (3 if self.render_normals else 0) + (1 if self.render_depth else 0)


class PoseOutputs(NamedTuple):
    """Per-iteration outputs, leading axis = iteration."""

    TCO_input: jax.Array  # [n_iter, B, 4, 4]
    TCO_output: jax.Array  # [n_iter, B, 4, 4]
    K_crop: jax.Array  # [n_iter, B, 3, 3]
    boxes_rend: jax.Array  # [n_iter, B, 4]
    boxes_crop: jax.Array  # [n_iter, B, 4]
    tCR: jax.Array  # [n_iter, B, 3]
    pose_raw: jax.Array  # [n_iter, B, 9]
    renderings_logits: jax.Array  # [n_iter, B, n_views]


def _identity_pose_bias(key, shape, dtype=jnp.float32):
    """Bias so the untrained head predicts the identity update."""
    del key
    assert shape == (9,)
    return jnp.asarray([1, 0, 0, 0, 1, 0, 0, 0, 1], dtype)


def _identity_quat_pose_bias(key, shape, dtype=jnp.float32):
    """Identity update for the quaternion head (xyzw + vxvyvz, vz=1)."""
    del key
    assert shape == (7,)
    return jnp.asarray([0, 0, 0, 1, 0, 0, 1], dtype)


_BACKBONES = {
    "resnet34": ResNet34,
    "wide_resnet18": WideResNet18,
    "wide_resnet34": WideResNet34,
    "efficientnet_b3": EfficientNetB3,
    "flownet": FlowNetS,
}


@dataclass(frozen=True)
class PosePredictor(Module):
    cfg: PosePredictorConfig

    @property
    def _dtype(self):
        return jnp.bfloat16 if self.cfg.compute_dtype == "bfloat16" else jnp.float32

    # ---------- geometry ----------

    def _crop_inputs(self, images, K, TCO, tCR, points, points_mask):
        """Crop around the reprojected model points; anchor at tCR.

        Returns (images_crop [B,C,h,w], K_crop, boxes_rend, boxes_crop)."""
        H, W = images.shape[-2:]
        uv = project_points_robust(points, K, TCO)
        boxes_rend = masked_boxes_from_uv(uv, points_mask)
        TCR = TCO.at[:, :3, 3].set(tCR)
        center = project_points_robust(
            jnp.zeros((TCO.shape[0], 1, 3), images.dtype), K, TCR
        )
        boxes_crop = deepim_boxes(
            center, boxes_rend, boxes_rend, lamb=self.cfg.crop_lamb,
            im_size=(H, W),
        )
        images_crop = crop_images_matmul(
            images, boxes_crop, output_size=self.cfg.render_size,
            sampling_ratio=4,
            matmul_dtype=(
                jnp.bfloat16
                if self.cfg.compute_dtype == "bfloat16" else None
            ),
        )
        K_crop = get_K_crop_resize(K, boxes_crop, (H, W), self.cfg.render_size)
        return images_crop, K_crop, boxes_rend, boxes_crop

    def _compute_KV_crop(self, im_hw, K, TCV_O, points, points_mask):
        """Crop intrinsics for each extra rendered view (no image crops)."""
        B, V = TCV_O.shape[:2]
        H, W = im_hw
        K_rep = jnp.repeat(K, V, axis=0)
        T_flat = TCV_O.reshape(B * V, 4, 4)
        pts_rep = jnp.repeat(points, V, axis=0)
        pm_rep = jnp.repeat(points_mask, V, axis=0)
        uv = project_points_robust(pts_rep, K_rep, T_flat)
        boxes_rend = masked_boxes_from_uv(uv, pm_rep)
        center = project_points_robust(
            jnp.zeros((B * V, 1, 3), K.dtype), K_rep, T_flat
        )
        boxes = deepim_boxes(
            center, boxes_rend, boxes_rend, lamb=self.cfg.crop_lamb,
            im_size=(H, W),
        )
        KV = get_K_crop_resize(K_rep, boxes, (H, W), self.cfg.render_size)
        return KV.reshape(B, V, 3, 3)

    def _render_views(self, assets, obj_ids, TCV_O, KV_crop):
        """Render all views; returns [B, V*C, h, w] channels-first."""
        cfg = self.cfg
        B, V = TCV_O.shape[:2]
        ids_rep = jnp.repeat(obj_ids, V, axis=0)
        out = get_renderer(cfg.renderer)(
            assets, ids_rep, TCV_O.reshape(B * V, 4, 4),
            KV_crop.reshape(B * V, 3, 3), resolution=cfg.render_size,
        )
        chans = [jnp.moveaxis(out.rgb, -1, 1)]  # [BV, 3, h, w]
        if cfg.render_normals:
            chans.append(jnp.moveaxis(out.normals, -1, 1))
        if cfg.render_depth:
            chans.append(out.depth[:, None])
        r = jnp.concatenate(chans, axis=1)  # [BV, C, h, w]
        C = r.shape[1]
        h, w = r.shape[-2:]
        return r.reshape(B, V * C, h, w)

    def _normalize_depth(self, depth, tCR):
        z = tCR[:, 2][(...,) + (None,) * (depth.ndim - 1)]
        t = self.cfg.depth_normalization_type
        if t == "tCR_scale":
            return depth / z
        if t == "tCR_scale_clamp_center":
            return jnp.clip(depth / z, 0.0, 2.0) - 1.0
        if t == "tCR_center_clamp":
            return jnp.clip(depth - z, -2.0, 2.0)
        if t == "none":
            return depth
        raise ValueError(f"unknown depth_normalization_type: {t}")

    def _normalize_images(self, images_crop, renders, tCR):
        cfg = self.cfg
        if cfg.input_depth:
            images_crop = images_crop.at[:, 3].set(
                self._normalize_depth(images_crop[:, 3], tCR)
            )
        if cfg.render_depth:
            C = cfg.n_render_channels
            d0 = 3 + (3 if cfg.render_normals else 0)
            for v in range(self.cfg.n_views):
                idx = v * C + d0
                renders = renders.at[:, idx].set(
                    self._normalize_depth(renders[:, idx], tCR)
                )
        return images_crop, renders

    # ---------- network ----------

    def apply_net(self, variables, x_chw, train: bool = False):
        """The CNN alone on a [B, C, h, w] input (observed + rendered
        channels), with the model's variables; no batch_stats update."""
        return self.net_forward(Scope(Context(variables, None, ())), x_chw, train)

    def net_forward(self, s: Scope, x_chw, train):
        """x_chw: [B, C, h, w] -> head outputs."""
        cfg = self.cfg
        x = jnp.moveaxis(x_chw, 1, -1).astype(self._dtype)  # NHWC convs
        backbone = _BACKBONES[cfg.backbone](
            dtype=self._dtype, bn_axis_name=cfg.bn_axis_name
        )
        feats = backbone.forward(s.child("backbone"), x, train=train)
        out = {}
        if cfg.predict_pose_update:
            quat = cfg.pose_head == "quaternion"
            out["pose"] = dense(
                s, feats, 7 if quat else 9, name="pose_fc",
                kernel_init=init.normal(1e-3),
                bias_init=(
                    _identity_quat_pose_bias if quat else _identity_pose_bias
                ),
            )
        if cfg.predict_rendered_views_logits:
            out["renderings_logits"] = dense(
                s, feats, cfg.n_views, name="views_logits_head"
            )
        return out

    def _iteration(self, s, images, K, obj_ids, TCO_input, assets, meshes,
                   train):
        cfg = self.cfg
        B = TCO_input.shape[0]
        TCO_input = jax.lax.stop_gradient(normalize_T(TCO_input))
        tCR = TCO_input[:, :3, 3]
        points = meshes.points
        points_mask = meshes.points_mask

        images_crop, K_crop, boxes_rend, boxes_crop = self._crop_inputs(
            images, K, TCO_input, tCR, points, points_mask
        )

        TCV_O = make_TCO_multiview(
            TCO_input,
            tCR,
            multiview_type=cfg.multiview_type,
            remove_TCO_rendering=cfg.remove_TCO_rendering,
            views_inplane_rotations=cfg.views_inplane_rotations,
        )
        KV_crop = self._compute_KV_crop(
            images.shape[-2:], K, TCV_O, points, points_mask
        )
        if not cfg.remove_TCO_rendering:
            KV_crop = KV_crop.at[:, 0].set(K_crop)

        renders = self._render_views(assets, obj_ids, TCV_O, KV_crop)
        # the renderer is non-differentiable (as in the reference); no
        # gradient ever flows through it (TCO_input is stop-gradient'd), and
        # the explicit stop_gradient keeps autodiff from materializing a
        # transpose of the render kernel
        renders = jax.lax.stop_gradient(renders)
        images_crop, renders = self._normalize_images(images_crop, renders, tCR)

        x = jnp.concatenate([images_crop, renders], axis=1)
        net_out = self.net_forward(s, x, train)

        if cfg.predict_pose_update:
            pose_raw = net_out["pose"]
            if cfg.pose_head == "quaternion":
                dR = quat_to_rotmat(pose_raw[:, 0:4])
                vxvyvz = pose_raw[:, 4:7]
            else:
                dR = rotmat_from_ortho6d(pose_raw[:, 0:6])
                vxvyvz = pose_raw[:, 6:9]
            TCO_output = pose_update_with_reference_point(
                TCO_input, K_crop, vxvyvz, dR, tCR
            )
        else:
            pose_raw = jnp.zeros((B, 9), TCO_input.dtype)
            TCO_output = TCO_input

        logits = net_out.get(
            "renderings_logits", jnp.zeros((B, cfg.n_views), TCO_input.dtype)
        )
        return PoseOutputs(
            TCO_input=TCO_input,
            TCO_output=TCO_output,
            K_crop=K_crop,
            boxes_rend=boxes_rend,
            boxes_crop=boxes_crop,
            tCR=tCR,
            pose_raw=pose_raw,
            renderings_logits=logits,
        )

    def forward(
        self,
        s: Scope,
        images: jax.Array,  # [B, 3(+1), H, W], float in [0, 1]
        K: jax.Array,  # [B, 3, 3]
        obj_ids: jax.Array,  # [B] int32
        TCO_input: jax.Array,  # [B, 4, 4]
        assets: RenderAssets,
        meshes: BatchedMeshes,  # pre-selected per instance (select(obj_ids))
        n_iterations: int = 1,
        train: bool = False,
    ) -> PoseOutputs:
        if not self.cfg.input_depth:
            images = images[:, :3]

        def body(scope, TCO):
            o = self._iteration(
                scope, images, K, obj_ids, TCO, assets, meshes, train
            )
            return o.TCO_output, o

        if n_iterations == 1 or s.initializing:
            # single compile of the body; at init the scan is skipped
            # (the variables every iteration uses are the same ones)
            outs = []
            TCO = TCO_input
            for _ in range(n_iterations):
                TCO, o = body(s, TCO)
                outs.append(o)
            return jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *outs)

        # lax.scan over iterations: ONE compiled render+CNN body regardless
        # of n_iterations (the reference unrolls in Python —
        # pose_rigid.py:546-674 — which is free under eager torch but
        # compiles n copies under jit; SURVEY.md §7). Params are closed
        # over; batch_stats ride the carry, so in training each iteration
        # sees the running statistics the previous one left.
        ctx = s.ctx
        params = ctx.variables["params"]

        def step(carry, _):
            TCO, stats = carry
            inner = Context(
                {"params": params, "batch_stats": stats}, None, ctx.mutable
            )
            TCO, o = body(Scope(inner, s.path), TCO)
            return (TCO, inner.variables["batch_stats"]), o

        (_, stats), outs = jax.lax.scan(
            step, (TCO_input, ctx.variables.get("batch_stats", {})), None,
            length=n_iterations,
        )
        if "batch_stats" in ctx.mutable:
            ctx.variables["batch_stats"] = stats
        return outs
