"""Test config: run everything on a virtual 8-device CPU mesh.

Mirrors SURVEY.md §4's note — the reference has no distributed CI; we test all
sharding deterministically on host CPU devices. The platform defaults to the
CPU; `JAX_PLATFORMS=cuda` runs the `gpu`-marked tests on a card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
