"""The one place that chooses a renderer for the platform.

Every renderer has the signature of `rasterizer.render_batch`. The choice
is made when a model renders (at trace time), never when a module is
imported, so importing the package does not touch a device.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax

from happypose_tpu.ops.rasterizer import render_batch
from happypose_tpu.ops.rasterizer_triton import render_batch_triton

RENDERERS = {"triton": render_batch_triton, "reference": render_batch}


def platform_renderer(platform: Optional[str] = None) -> str:
    """Renderer name for `platform` (default: JAX's default backend):
    the Triton kernel on a GPU, the plain XLA reference on the CPU."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "reference"
    raise ValueError(f"no renderer for platform {platform!r} (gpu or cpu)")


def get_renderer(name: Optional[str] = None) -> Callable:
    """Render function by name; None means `platform_renderer()`."""
    return RENDERERS[name or platform_renderer()]
