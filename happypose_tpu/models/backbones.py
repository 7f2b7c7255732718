"""CNN backbones (NHWC, bf16-friendly), on the layers of `models.layers`.

Parity targets: the reference's pose-model backbones —
WideResNet18/34 with pre-activation BasicBlockV2 and a 5x5/stride-2 stem
(/root/reference/happypose/pose_estimators/cosypose/cosypose/models/
wide_resnet.py:18-136) and a torchvision-style ResNet34 v1 with an
`n_inputs` argument (megapose/models/resnet.py:68-349). Architectures are
re-implemented in NHWC layout with a compute-dtype knob so convolutions
run in bfloat16 while params/BN stats stay float32.

BatchNorm supports cross-device sync through `axis_name` (the analog of
the reference's SyncBatchNorm option, train_megapose.py:270-277).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp

from happypose_tpu.models.layers import Module, Scope, batch_norm, conv, max_pool

Dtype = Any
relu = jax.nn.relu
swish = jax.nn.swish


def _norm(train: bool, dtype: Dtype, bn_axis_name: Optional[str]):
    return partial(
        batch_norm, train=train, momentum=0.9, dtype=dtype,
        axis_name=bn_axis_name if train else None,
    )


def basic_block_v2(s: Scope, x, planes: int, stride: int, downsample: bool,
                   dtype: Dtype, bn_axis_name: Optional[str], train: bool):
    """Pre-activation residual block (He et al. 2016, identity mappings)."""
    norm = _norm(train, dtype, bn_axis_name)
    out = relu(norm(s, x))
    if downsample:
        residual = conv(s, out, planes, 1, strides=stride, use_bias=False,
                        dtype=dtype)
    else:
        residual = x
    out = conv(s, out, planes, 3, strides=stride, padding=1, use_bias=False,
               dtype=dtype)
    out = relu(norm(s, out))
    out = conv(s, out, planes, 3, padding=1, use_bias=False, dtype=dtype)
    return out + residual


@dataclass(frozen=True)
class WideResNet(Module):
    """Stem (5x5/s2 conv + BN + ReLU + 3x3/s2 maxpool) + 4 v2 stages.

    Input: [B, H, W, C]; output: [B, n_features] (global average pool).
    """

    layers: Sequence[int]
    width: float = 1.0
    dtype: Dtype = jnp.float32
    bn_axis_name: Optional[str] = None

    @property
    def n_features(self) -> int:
        return int(512 * self.width)

    def forward(self, s: Scope, x, train: bool = False):
        config = [int(v * self.width) for v in (64, 128, 256, 512)]
        x = conv(s, x, config[0], 5, strides=2, padding=2, use_bias=False,
                 dtype=self.dtype)
        x = relu(_norm(train, self.dtype, self.bn_axis_name)(s, x))
        x = max_pool(x, 3, 2, 1)
        inplanes = config[0]
        for stage, (planes, blocks) in enumerate(zip(config, self.layers)):
            stride = 1 if stage == 0 else 2
            for b in range(blocks):
                st = stride if b == 0 else 1
                ds = b == 0 and (st != 1 or inplanes != planes)
                x = basic_block_v2(
                    s.auto("BasicBlockV2"), x, planes, st, ds, self.dtype,
                    self.bn_axis_name, train,
                )
                inplanes = planes
        x = jnp.mean(x, axis=(1, 2))  # global average pool -> [B, F]
        return x.astype(jnp.float32)


def WideResNet18(**kw) -> WideResNet:
    return WideResNet(layers=(2, 2, 2, 2), **kw)


def WideResNet34(**kw) -> WideResNet:
    return WideResNet(layers=(3, 4, 6, 3), **kw)


def basic_block_v1(s: Scope, x, planes: int, stride: int, downsample: bool,
                   dtype: Dtype, bn_axis_name: Optional[str], train: bool):
    """Post-activation residual block (torchvision ResNet v1)."""
    norm = _norm(train, dtype, bn_axis_name)
    residual = x
    out = conv(s, x, planes, 3, strides=stride, padding=1, use_bias=False,
               dtype=dtype)
    out = relu(norm(s, out))
    out = conv(s, out, planes, 3, padding=1, use_bias=False, dtype=dtype)
    out = norm(s, out)
    if downsample:
        residual = conv(s, x, planes, 1, strides=stride, use_bias=False,
                        dtype=dtype)
        residual = norm(s, residual)
    return relu(out + residual)


@dataclass(frozen=True)
class ResNet(Module):
    """torchvision-style ResNet v1 (7x7/s2 stem), `n_inputs` free.

    The reference's `vanilla_resnet34` is the MegaPose default backbone
    (megapose/training/pose_models_cfg.py:89-137).
    """

    layers: Sequence[int]
    dtype: Dtype = jnp.float32
    bn_axis_name: Optional[str] = None

    @property
    def n_features(self) -> int:
        return 512

    def forward(self, s: Scope, x, train: bool = False):
        x = conv(s, x, 64, 7, strides=2, padding=3, use_bias=False,
                 dtype=self.dtype)
        x = relu(_norm(train, self.dtype, self.bn_axis_name)(s, x))
        x = max_pool(x, 3, 2, 1)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(
            zip((64, 128, 256, 512), self.layers)
        ):
            stride = 1 if stage == 0 else 2
            for b in range(blocks):
                st = stride if b == 0 else 1
                ds = b == 0 and (st != 1 or inplanes != planes)
                x = basic_block_v1(
                    s.auto("BasicBlockV1"), x, planes, st, ds, self.dtype,
                    self.bn_axis_name, train,
                )
                inplanes = planes
        x = jnp.mean(x, axis=(1, 2))
        return x.astype(jnp.float32)


def ResNet34(**kw) -> ResNet:
    return ResNet(layers=(3, 4, 6, 3), **kw)


def mb_conv(s: Scope, x, out_ch: int, expand: int, kernel: int, stride: int,
            dtype: Dtype, bn_axis_name: Optional[str], train: bool,
            se_ratio: float = 0.25):
    """Mobile inverted bottleneck (EfficientNet building block)."""
    norm = _norm(train, dtype, bn_axis_name)
    in_ch = x.shape[-1]
    h = x
    mid = in_ch * expand
    if expand != 1:
        h = swish(norm(s, conv(s, h, mid, 1, use_bias=False, dtype=dtype)))
    h = swish(norm(s, conv(
        s, h, mid, kernel, strides=stride, padding=kernel // 2, groups=mid,
        use_bias=False, dtype=dtype,
    )))
    # squeeze-excite
    se_ch = max(1, int(in_ch * se_ratio))
    sq = jnp.mean(h, axis=(1, 2), keepdims=True)
    sq = swish(conv(s, sq, se_ch, 1, dtype=dtype))
    sq = jax.nn.sigmoid(conv(s, sq, mid, 1, dtype=dtype))
    h = h * sq
    h = norm(s, conv(s, h, out_ch, 1, use_bias=False, dtype=dtype))
    if stride == 1 and in_ch == out_ch:
        h = h + x
    return h


# (expand, out_ch, n_repeat, stride, kernel) per stage (B0 base)
_EFFICIENTNET_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


@dataclass(frozen=True)
class EfficientNet(Module):
    """EfficientNet (B0/B3 scalings) with free input-channel count.

    Parity target: the reference's EfficientNet-b3 pose backbone
    (cosypose/models/efficientnet.py, 331+433 LoC torch port). Stage layout
    follows Tan & Le (ICML'19); width/depth multipliers select the variant.
    """

    width_mult: float = 1.0
    depth_mult: float = 1.0
    dtype: Dtype = jnp.float32
    bn_axis_name: Optional[str] = None

    @property
    def n_features(self) -> int:
        return self._round_ch(1280)

    def _round_ch(self, ch: int) -> int:
        ch = ch * self.width_mult
        out = max(8, int(ch + 4) // 8 * 8)
        if out < 0.9 * ch:
            out += 8
        return out

    def forward(self, s: Scope, x, train: bool = False):
        norm = _norm(train, self.dtype, self.bn_axis_name)
        x = swish(norm(s, conv(
            s, x, self._round_ch(32), 3, strides=2, padding=1, use_bias=False,
            dtype=self.dtype,
        )))
        for (expand, out_ch, repeats, stride, kernel) in _EFFICIENTNET_STAGES:
            reps = int(math.ceil(repeats * self.depth_mult))
            for r in range(reps):
                x = mb_conv(
                    s.auto("MBConv"), x, self._round_ch(out_ch), expand,
                    kernel, stride if r == 0 else 1, self.dtype,
                    self.bn_axis_name, train,
                )
        x = swish(norm(s, conv(
            s, x, self.n_features, 1, use_bias=False, dtype=self.dtype
        )))
        x = jnp.mean(x, axis=(1, 2))
        return x.astype(jnp.float32)


def EfficientNetB0(**kw) -> EfficientNet:
    return EfficientNet(width_mult=1.0, depth_mult=1.0, **kw)


def EfficientNetB3(**kw) -> EfficientNet:
    return EfficientNet(width_mult=1.2, depth_mult=1.4, **kw)


@dataclass(frozen=True)
class FlowNetS(Module):
    """FlowNetS encoder (the reference's 'flownet' pose backbone).

    Parity target: cosypose/models/flownet.py:9-58 — the FlowNetS
    contracting path only (the decoder/flow heads are unused there),
    conv1 7x7/s2 64 -> conv2 5x5/s2 128 -> conv3 5x5/s2 256 -> conv3_1 ->
    conv4 /s2 512 -> conv4_1 -> conv5 /s2 512 -> conv5_1 -> conv6 /s2
    1024 -> conv6_1, LeakyReLU(0.1). The reference loads pretrained
    optical-flow weights from disk; here the encoder trains from scratch
    (no egress), optionally with (sync) BatchNorm like its batchNorm mode.
    """

    use_batchnorm: bool = False
    dtype: Dtype = jnp.float32
    bn_axis_name: Optional[str] = None

    @property
    def n_features(self) -> int:
        return 1024

    def forward(self, s: Scope, x, train: bool = False):
        norm = _norm(train, self.dtype, self.bn_axis_name)

        def block(x, ch, kernel, stride=1):
            x = conv(
                s, x, ch, kernel, strides=stride, padding=(kernel - 1) // 2,
                use_bias=not self.use_batchnorm, dtype=self.dtype,
            )
            if self.use_batchnorm:
                x = norm(s, x)
            return jax.nn.leaky_relu(x, negative_slope=0.1)

        x = block(x, 64, 7, 2)
        x = block(x, 128, 5, 2)
        x = block(block(x, 256, 5, 2), 256, 3)
        x = block(block(x, 512, 3, 2), 512, 3)
        x = block(block(x, 512, 3, 2), 512, 3)
        x = block(block(x, 1024, 3, 2), 1024, 3)
        x = jnp.mean(x, axis=(1, 2))
        return x.astype(jnp.float32)
