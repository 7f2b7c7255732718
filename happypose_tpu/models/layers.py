"""Functional layers over an explicit variable tree.

The models keep their variables in the tree `{"params": ..., "batch_stats":
...}` and expose `model.init(key, *args, **kw)` and
`model.apply(variables, *args, mutable=[...], **kw)`. A model is a frozen
(hashable) dataclass deriving from `Module` whose `forward(scope, ...)`
calls the layer functions below; each layer takes the parent `Scope` and
either an explicit `name` (calls with the same name share variables) or an
automatic `<Kind>_<n>` name, numbered per parent in call order.

Layers: `conv`, `dense`, `batch_norm` (with running statistics, optionally
synchronised over a mapped axis), `max_pool`. Activations and initializers
are `jax.nn`'s own.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
from jax import lax

Dtype = Any
Initializer = Callable[[jax.Array, Tuple[int, ...], Dtype], jax.Array]
init = jax.nn.initializers


class Context:
    """Variables of one `init` or `apply` call."""

    def __init__(self, variables: Dict[str, Any], rng: Optional[jax.Array],
                 mutable: Iterable[str]):
        self.variables = variables
        self.rng = rng
        self.mutable = frozenset(mutable)

    @property
    def initializing(self) -> bool:
        return self.rng is not None


def _fold_in_path(key: jax.Array, path: Tuple[Union[str, int], ...]):
    """Fold a variable's path into `key` through its SHA-1 hash, so each
    variable's initial value depends on its path only (not on the order
    variables are created in)."""
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    h = int.from_bytes(m.digest()[:4], byteorder="big")
    return jax.random.fold_in(key, jnp.uint32(h))


def _copy_tree(tree):
    """Copy the dict structure of a variable tree (leaves are shared)."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


class Scope:
    """One module's place in the variable tree."""

    def __init__(self, ctx: Context, path: Tuple[str, ...] = ()):
        self.ctx = ctx
        self.path = path
        self._counts: Dict[str, int] = {}
        self._n_params = 0

    @property
    def initializing(self) -> bool:
        return self.ctx.initializing

    def child(self, name: str) -> "Scope":
        return Scope(self.ctx, self.path + (name,))

    def auto(self, kind: str, name: Optional[str] = None) -> "Scope":
        """Child scope `name`, or `<kind>_<n>` numbered in call order."""
        if name is None:
            n = self._counts.get(kind, 0)
            self._counts[kind] = n + 1
            name = f"{kind}_{n}"
        return self.child(name)

    def _node(self, collection: str, create: bool) -> Dict[str, Any]:
        node = self.ctx.variables
        for key in (collection,) + self.path:
            node = node.setdefault(key, {}) if create else node[key]
        return node

    def param(self, name: str, initializer: Initializer,
              shape: Tuple[int, ...]) -> jax.Array:
        if self.initializing:
            node = self._node("params", create=True)
            if name not in node:
                self._n_params += 1
                key = _fold_in_path(self.ctx.rng, self.path + (self._n_params,))
                node[name] = initializer(key, shape, jnp.float32)
            return node[name]
        return self._node("params", create=False)[name]

    def state(self, collection: str, name: str,
              make: Callable[[], jax.Array]) -> jax.Array:
        if self.initializing:
            return self._node(collection, create=True).setdefault(name, make())
        return self._node(collection, create=False)[name]

    def set_state(self, collection: str, name: str, value: jax.Array) -> None:
        """Write a state variable; ignored unless `collection` is mutable."""
        if collection in self.ctx.mutable and not self.initializing:
            self._node(collection, create=False)[name] = value


class Module:
    """`init` / `apply` around a subclass's `forward(scope, *args, **kw)`."""

    def forward(self, scope: Scope, *args, **kwargs):
        raise NotImplementedError

    def init(self, key: jax.Array, *args, **kwargs) -> Dict[str, Any]:
        ctx = Context({}, key, mutable=())
        self.forward(Scope(ctx), *args, **kwargs)
        return ctx.variables

    def apply(self, variables: Dict[str, Any], *args,
              mutable: Union[bool, str, Sequence[str]] = False, **kwargs):
        """Run the model. With `mutable` collections, returns
        `(output, {collection: updated tree})`."""
        if isinstance(mutable, str):
            mutable = [mutable]
        mutable = list(mutable) if mutable else []
        tree = {
            c: _copy_tree(v) if c in mutable else v
            for c, v in variables.items()
        }
        ctx = Context(tree, None, mutable=mutable)
        out = self.forward(Scope(ctx), *args, **kwargs)
        if not mutable:
            return out
        return out, {c: ctx.variables.get(c, {}) for c in mutable}


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv(
    scope: Scope,
    x: jax.Array,
    features: int,
    kernel: Union[int, Tuple[int, int]],
    strides: Union[int, Tuple[int, int]] = 1,
    padding: Union[str, int] = "SAME",
    use_bias: bool = True,
    groups: int = 1,
    dtype: Dtype = jnp.float32,
    bias_init: Initializer = init.zeros,
    name: Optional[str] = None,
) -> jax.Array:
    """2-D convolution, NHWC input, HWIO kernel, computed in `dtype`."""
    s = scope.auto("Conv", name)
    kh, kw = _pair(kernel)
    w = s.param(
        "kernel", init.lecun_normal(), (kh, kw, x.shape[-1] // groups, features)
    )
    pad = padding if isinstance(padding, str) else [_pair(padding)] * 2
    y = lax.conv_general_dilated(
        x.astype(dtype), w.astype(dtype), _pair(strides), pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups,
    )
    if use_bias:
        y = y + s.param("bias", bias_init, (features,)).astype(dtype)
    return y


def dense(
    scope: Scope,
    x: jax.Array,
    features: int,
    kernel_init: Initializer = init.lecun_normal(),
    bias_init: Initializer = init.zeros,
    name: Optional[str] = None,
) -> jax.Array:
    """Affine map of the last axis."""
    s = scope.auto("Dense", name)
    w = s.param("kernel", kernel_init, (x.shape[-1], features))
    return jnp.dot(x, w) + s.param("bias", bias_init, (features,))


def batch_norm(
    scope: Scope,
    x: jax.Array,
    train: bool,
    momentum: float = 0.9,
    epsilon: float = 1e-5,
    axis_name: Optional[str] = None,
    dtype: Dtype = jnp.float32,
    name: Optional[str] = None,
) -> jax.Array:
    """BatchNorm over every axis but the last.

    Training normalises with the batch statistics (mean over `axis_name`
    too, when given: the synchronised form) and, where `batch_stats` is
    mutable, moves the running mean and variance by `1 - momentum`.
    Evaluation normalises with the running statistics. Statistics are f32.
    """
    s = scope.auto("BatchNorm", name)
    c = x.shape[-1]
    scale = s.param("scale", init.ones, (c,))
    bias = s.param("bias", init.zeros, (c,))
    ra_mean = s.state("batch_stats", "mean", lambda: jnp.zeros((c,), jnp.float32))
    ra_var = s.state("batch_stats", "var", lambda: jnp.ones((c,), jnp.float32))
    if train:
        axes = tuple(range(x.ndim - 1))
        xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
        mean = jnp.mean(xf, axis=axes)
        mean2 = jnp.mean(jnp.square(xf), axis=axes)
        if axis_name is not None:
            mean, mean2 = lax.pmean((mean, mean2), axis_name)
        var = jnp.maximum(0.0, mean2 - jnp.square(mean))
        s.set_state("batch_stats", "mean",
                    momentum * ra_mean + (1.0 - momentum) * mean)
        s.set_state("batch_stats", "var",
                    momentum * ra_var + (1.0 - momentum) * var)
    else:
        mean, var = ra_mean, ra_var
    y = (x - mean) * (lax.rsqrt(var + epsilon) * scale) + bias
    return y.astype(dtype)


def max_pool(x: jax.Array, window: int, stride: int, padding: int) -> jax.Array:
    """Max pooling over H and W of an NHWC array."""
    # a Python-scalar identity lets JAX recognise the max monoid (and
    # differentiate it)
    return lax.reduce_window(
        x, -jnp.inf, lax.max,
        (1, window, window, 1), (1, stride, stride, 1),
        [(0, 0), (padding, padding), (padding, padding), (0, 0)],
    )
