"""The in-repo layer set (`models/layers.py`) and the compile-cache switch."""

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from happypose_tpu.models.layers import (
    Context, Module, Scope, batch_norm, conv, dense, max_pool,
)


@dataclass(frozen=True)
class _Net(Module):
    axis_name: str = None

    def forward(self, s: Scope, x, train: bool = False):
        x = conv(s, x, 4, 3, padding=1)
        x = batch_norm(s, x, train, axis_name=self.axis_name)
        x = conv(s, jax.nn.relu(x), 4, 1, use_bias=False, name="shared")
        x = conv(s, x, 4, 1, use_bias=False, name="shared")  # same weights
        x = max_pool(x, 3, 2, 1)
        return dense(s, jnp.mean(x, axis=(1, 2)), 2)


def _x(n=4):
    return jax.random.normal(jax.random.PRNGKey(1), (n, 8, 8, 3))


def test_variable_tree_names_and_shapes():
    v = _Net().init(jax.random.PRNGKey(0), _x())
    p = v["params"]
    assert set(p) == {"Conv_0", "BatchNorm_0", "shared", "Dense_0"}
    assert p["Conv_0"]["kernel"].shape == (3, 3, 3, 4)
    assert p["Conv_0"]["bias"].shape == (4,)
    assert set(p["shared"]) == {"kernel"}
    assert p["Dense_0"]["kernel"].shape == (4, 2)
    np.testing.assert_array_equal(v["batch_stats"]["BatchNorm_0"]["mean"], 0.0)
    np.testing.assert_array_equal(v["batch_stats"]["BatchNorm_0"]["var"], 1.0)
    # a variable's initial value depends on its path and the key only
    v2 = _Net().init(jax.random.PRNGKey(0), _x(2))
    np.testing.assert_array_equal(p["Conv_0"]["kernel"], v2["params"]["Conv_0"]["kernel"])
    assert not np.allclose(p["Conv_0"]["kernel"][..., :3], p["shared"]["kernel"][0, 0, :3, :3])


def test_batch_norm_running_statistics():
    v = _Net().init(jax.random.PRNGKey(0), _x())
    x = _x()
    # without `mutable` the running statistics stay put
    out = _Net().apply(v, x, train=True)
    assert out.shape == (4, 2)
    out2, new = _Net().apply(v, x, train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(out, out2)
    feats = conv(Scope(Context(v, None, ())), x, 4, 3, padding=1)
    mean = np.asarray(feats).mean((0, 1, 2))
    var = np.asarray(feats).var((0, 1, 2))
    bs = new["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bs["mean"], 0.1 * mean, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(bs["var"], 0.9 + 0.1 * var, rtol=1e-4)
    # the input tree is not modified
    np.testing.assert_array_equal(v["batch_stats"]["BatchNorm_0"]["mean"], 0.0)
    # evaluation normalises with the running statistics
    ev = _Net().apply({"params": v["params"], "batch_stats": new["batch_stats"]}, x)
    assert not np.allclose(ev, _Net().apply(v, x))


def test_batch_norm_synchronised_over_axis_equals_global_batch():
    v = _Net().init(jax.random.PRNGKey(0), _x())
    x = _x(8)
    full, s_full = _Net().apply(v, x, train=True, mutable=["batch_stats"])
    split, s_split = jax.vmap(
        lambda xs: _Net(axis_name="d").apply(
            v, xs, train=True, mutable=["batch_stats"]
        ),
        axis_name="d",
    )(x.reshape(2, 4, 8, 8, 3))
    np.testing.assert_allclose(split.reshape(8, 2), full, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        s_split["batch_stats"]["BatchNorm_0"]["var"][0],
        s_full["batch_stats"]["BatchNorm_0"]["var"], rtol=1e-5,
    )


def test_max_pool_values_and_gradient():
    x = jnp.arange(16.0).reshape(1, 4, 4, 1)
    y = max_pool(x, 3, 2, 1)
    np.testing.assert_array_equal(y[0, :, :, 0], [[5.0, 7.0], [13.0, 15.0]])
    g = jax.grad(lambda a: jnp.sum(max_pool(a, 3, 2, 1)))(x)
    assert float(g.sum()) == 4.0


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_location(env_set, monkeypatch, tmp_path):
    from happypose_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = compile_cache.enable_compile_cache()
            assert path == str(compile_cache.CHECKOUT_CACHE)
            assert path.endswith(".jax_cache")
            assert (compile_cache.CHECKOUT_CACHE.parent / "pyproject.toml").exists()
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
