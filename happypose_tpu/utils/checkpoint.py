"""Checkpoint save/restore + run-directory conventions.

Parity targets: the reference's rank-0 `{"state_dict", "epoch"}` torch saves
with a `checkpoint_epoch=last` fallback copy and `resume_run_id` logic
(/root/reference/happypose/pose_estimators/megapose/training/utils.py:156-215,
train_megapose.py:251-266).

Format: one `.npz` archive whose entries are the state's leaves keyed by
their tree path, names joined by "/" (a dict key and a field of the same
name give the same key). Process 0 writes, others restore from the same
path; a `_last` copy is the fallback for a truncated file. Restoring reads
the keys of the target's structure only, so model variables can be taken
out of a saved training state."""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import jax
import numpy as np

from happypose_tpu.utils.logging import get_logger

logger = get_logger(__name__)

CHECKPOINT = "checkpoint.npz"
CHECKPOINT_LAST = "checkpoint_last.npz"


def _key(path) -> str:
    return "/".join(
        str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
        for k in path
    )


def save_checkpoint(
    run_dir: Union[str, Path],
    state: Any,
    epoch: int,
    config: Optional[Dict] = None,
    keep_last_copy: bool = True,
) -> Path:
    """Serialize a pytree train state; returns the checkpoint path."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    path = run_dir / CHECKPOINT
    if jax.process_index() != 0:
        return path
    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]
    buf = io.BytesIO()
    np.savez(buf, **{_key(k): np.asarray(v) for k, v in leaves})
    payload = buf.getvalue()
    path.write_bytes(payload)
    (run_dir / "epoch.json").write_text(json.dumps({"epoch": epoch}))
    if config is not None:
        (run_dir / "config.json").write_text(json.dumps(config, default=str))
    if keep_last_copy:
        (run_dir / CHECKPOINT_LAST).write_bytes(payload)
    return path


def load_checkpoint(
    run_dir: Union[str, Path], target: Any
) -> Tuple[Any, int]:
    """Restore into `target`'s structure; falls back to the `_last` copy on
    corruption (the reference's EOFError fallback)."""
    run_dir = Path(run_dir)
    paths, treedef = jax.tree_util.tree_flatten_with_path(target)
    for path in (run_dir / CHECKPOINT, run_dir / CHECKPOINT_LAST):
        if not path.exists():
            continue
        try:
            with np.load(path, allow_pickle=False) as data:
                values = [data[_key(k)] for k, _ in paths]
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            logger.warning(f"checkpoint {path} unreadable ({e}); trying next")
            continue
        epoch = 0
        ep = run_dir / "epoch.json"
        if ep.exists():
            epoch = json.loads(ep.read_text())["epoch"]
        return jax.tree_util.tree_unflatten(treedef, values), epoch
    raise FileNotFoundError(f"no readable checkpoint in {run_dir}")
