"""Data-parallel training step (shard_map over a device mesh).

Parity target: the reference's DDP training loops
(/root/reference/happypose/pose_estimators/megapose/training/
train_megapose.py:96-459, cosypose/training/train_pose.py:252-520):
one-process-per-GPU NCCL DDP with AMP. Here a single `shard_map` over
`Mesh(devices, ("dp",))` shards the batch from one process, gradients are
`pmean`ed across the devices, BatchNorm syncs through `axis_name` (the
SyncBatchNorm analog), and bf16 compute replaces AMP GradScaler (no loss
scaling needed — bf16 has f32's exponent range).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


class TrainState(NamedTuple):
    step: jax.Array
    params: Any
    batch_stats: Any
    opt_state: Any

    @classmethod
    def create(cls, variables, tx):
        params = variables["params"]
        return cls(
            step=jnp.zeros((), jnp.int32),
            params=params,
            batch_stats=variables.get("batch_stats", {}),
            opt_state=tx.init(params),
        )

    @property
    def variables(self):
        return {"params": self.params, "batch_stats": self.batch_stats}


def make_lr_schedule(
    base_lr: float,
    n_warmup_steps: int,
    total_steps: int,
    decay_steps: Tuple[int, ...] = (),
    decay_factor: float = 0.1,
) -> optax.Schedule:
    """Linear warmup + step decay (reference `make_lr_ratio_function`,
    megapose/training/utils.py:39-77)."""

    def schedule(step):
        warm = jnp.minimum(
            (step + 1) / max(n_warmup_steps, 1), 1.0
        )
        decay = jnp.ones(())
        for s in decay_steps:
            decay = decay * jnp.where(step >= s, decay_factor, 1.0)
        return base_lr * warm * decay

    return schedule


def make_optimizer(
    lr: float = 3e-4,
    n_warmup_steps: int = 500,
    total_steps: int = 100_000,
    decay_steps: Tuple[int, ...] = (),
    weight_decay: float = 0.0,
    clip_grad_norm: Optional[float] = 10.0,
) -> optax.GradientTransformation:
    """Adam (+ optional decoupled weight decay + grad clipping), warmed up."""
    sched = make_lr_schedule(lr, n_warmup_steps, total_steps, decay_steps)
    chain = []
    if clip_grad_norm is not None:
        chain.append(optax.clip_by_global_norm(clip_grad_norm))
    if weight_decay > 0:
        chain.append(optax.adamw(sched, weight_decay=weight_decay))
    else:
        chain.append(optax.adam(sched))
    return optax.chain(*chain)


LossFn = Callable[..., Tuple[jax.Array, Any]]
# signature: loss_fn(variables, batch, rng, train) -> (loss, (metrics, new_batch_stats))


def make_train_step(
    loss_fn: LossFn,
    tx: optax.GradientTransformation,
    mesh: Optional[Mesh] = None,
    axis: str = "dp",
    donate: bool = True,
):
    """Build the jitted train step.

    `loss_fn(variables, batch, rng, train=True)` must return
    `(scalar_loss, (metrics_dict, new_batch_stats))` and run BatchNorm with
    `axis_name=axis` when `mesh` is given (for sync-BN).

    With a mesh, the step is shard_mapped: `batch` sharded over `axis`,
    state replicated, gradients/metrics pmean'ed across the devices.
    """

    def _step(state: TrainState, batch, rng):
        def lf(params):
            return loss_fn(
                {"params": params, "batch_stats": state.batch_stats},
                batch,
                rng,
            )

        (loss, (metrics, new_stats)), grads = jax.value_and_grad(
            lf, has_aux=True
        )(state.params)
        if mesh is not None:
            grads = jax.lax.pmean(grads, axis)
            loss = jax.lax.pmean(loss, axis)
            metrics = jax.lax.pmean(metrics, axis)
            new_stats = jax.lax.pmean(new_stats, axis)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        # failure mitigation the reference lacks (SURVEY §5.3): a batch
        # with a non-finite loss/grad (degenerate render, bf16 overflow)
        # is skipped wholesale instead of poisoning the weights
        grad_norm = optax.global_norm(grads)
        ok = jnp.isfinite(loss) & jnp.isfinite(grad_norm)
        new_params, new_stats, new_opt = jax.tree_util.tree_map(
            lambda new, old: jnp.where(ok, new, old),
            (new_params, new_stats, new_opt),
            (state.params, state.batch_stats, state.opt_state),
        )
        metrics = dict(metrics)
        metrics["loss"] = jnp.where(ok, loss, 0.0)
        metrics["grad_norm"] = jnp.where(ok, grad_norm, 0.0)
        metrics["skipped_nonfinite"] = (~ok).astype(jnp.float32)
        new_state = state._replace(
            step=state.step + 1,
            params=new_params,
            batch_stats=new_stats,
            opt_state=new_opt,
        )
        return new_state, metrics

    if mesh is None:
        return jax.jit(_step, donate_argnums=(0,) if donate else ())

    smapped = shard_map(
        _step,
        mesh=mesh,
        in_specs=(P(), P(axis), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(smapped, donate_argnums=(0,) if donate else ())


def split_batch_for_mesh(batch, mesh: Mesh, axis: str = "dp"):
    """Device_put a host batch with the dp sharding (leading axis split)."""
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, P(axis))
    return jax.tree.map(
        lambda x: jax.device_put(x, sharding)
        if hasattr(x, "ndim") and x.ndim > 0
        else x,
        batch,
    )
