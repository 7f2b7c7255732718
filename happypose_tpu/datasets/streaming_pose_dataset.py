"""Streaming pose-training batches from WebDataset tar shards.

Parity target: /root/reference/happypose/pose_estimators/megapose/training/
train_megapose.py:96-229 (webdataset iterable pipeline + DataLoader worker
processes) and toolbox/datasets/web_scene_dataset.py:54-252. The reference
streams 2M PBR images from tar shards through torch DataLoader workers;
whole-dataset RAM/HBM caches cannot reach that scale.

Redesign: a host prefetch THREAD decodes shard samples into
fixed-size frame CHUNKS (uint8 numpy + per-object annotations); the training
iterator device_puts one chunk at a time ([chunk, H, W, 3] uint8 on device) and
builds batches by device-side gather exactly like PoseDataset's device
cache — so per-batch host->device traffic stays a handful of ints while the
NEXT chunk decodes concurrently on the host. Training throughput matches
the cached-split path as long as chunk decode time < chunk consume time.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from happypose_tpu.datasets.augmentations import (
    crop_resize_to_aspect,
    rgb_jitter,
)
from happypose_tpu.datasets.web_scene_dataset import IterableWebSceneDataset
from happypose_tpu.meshes.database import MeshDataBase
from happypose_tpu.training.forward_loss import PoseTrainingBatch


@dataclass
class _Chunk:
    """One decoded chunk: frames + flat (frame, object) sample table."""

    frames: np.ndarray  # [N, H, W, 3] uint8
    sample_frame: np.ndarray  # [S] int32 frame index of each sample
    sample_K: np.ndarray  # [S, 3, 3]
    sample_obj_id: np.ndarray  # [S] int32 mesh-db ids
    sample_TCO: np.ndarray  # [S, 4, 4]


@dataclass
class StreamingPoseDataset:
    """Infinite pose-training batches from a WDS shard directory.

    Decoding runs in a daemon thread `prefetch_chunks` chunks ahead; each
    chunk is staged to the device once and sampled for
    `samples_per_chunk_pass * n_samples / batch_size` batches before moving
    on (each sample seen ~`samples_per_chunk_pass` times per visit; shard
    order reshuffles every epoch through the stream)."""

    shards_dir: str
    mesh_db: MeshDataBase
    batch_size: int = 16
    resolution: tuple = (240, 320)
    chunk_frames: int = 512
    prefetch_chunks: int = 2
    samples_per_chunk_pass: float = 1.0
    min_visib_fract: float = 0.1
    min_area: float = 64.0
    keep_labels: Optional[Sequence[str]] = None
    apply_rgb_augmentation: bool = True
    seed: int = 0
    # per-__iter__ stop event (created fresh each iteration so the dataset
    # is reusable); stop() flips the most recent one
    _stop: threading.Event = field(
        default_factory=threading.Event, repr=False
    )

    def __post_init__(self):
        from pathlib import Path

        if not sorted(Path(self.shards_dir).glob("*.tar")):
            raise FileNotFoundError(
                f"no WDS *.tar shards in {self.shards_dir} — the underlying "
                "shard stream would spin forever yielding nothing"
            )

    def _valid_objects(self, obs) -> List[int]:
        if obs.obj_labels is None:
            return []
        out = []
        for i, label in enumerate(obs.obj_labels):
            if label not in self.mesh_db.label_to_id:
                continue
            if self.keep_labels and label not in self.keep_labels:
                continue
            if (obs.visib_fract is not None
                    and obs.visib_fract[i] < self.min_visib_fract):
                continue
            bb = obs.bboxes[i]
            if (bb[2] - bb[0]) * (bb[3] - bb[1]) < self.min_area:
                continue
            out.append(i)
        return out

    def _decode_loop(self, out_q: "queue.Queue", stop: threading.Event):
        try:
            stream = iter(IterableWebSceneDataset(
                self.shards_dir, buffer_size=max(32, self.chunk_frames // 4),
                seed=self.seed,
            ))
            while not stop.is_set():
                frames, sf, sK, so, sT = [], [], [], [], []
                while len(frames) < self.chunk_frames and not stop.is_set():
                    obs = next(stream)
                    cand = self._valid_objects(obs)
                    if not cand:
                        continue
                    fi = len(frames)
                    frames.append(obs.rgb)
                    for j in cand:
                        sf.append(fi)
                        sK.append(obs.K)
                        so.append(self.mesh_db.id_of(obs.obj_labels[j]))
                        sT.append(obs.TWO[j])
                if stop.is_set():
                    return
                chunk = _Chunk(
                    frames=np.stack(frames),
                    sample_frame=np.asarray(sf, np.int32),
                    sample_K=np.stack(sK).astype(np.float32),
                    sample_obj_id=np.asarray(so, np.int32),
                    sample_TCO=np.stack(sT).astype(np.float32),
                )
                while not stop.is_set():
                    try:
                        out_q.put(chunk, timeout=1.0)
                        break
                    except queue.Full:
                        continue
        except BaseException as exc:  # noqa: BLE001 — re-raised in __iter__
            # a corrupt tar member / mixed shapes / missing keys must not
            # hang the consumer on q.get() forever: ship the exception
            while not stop.is_set():
                try:
                    out_q.put(exc, timeout=1.0)
                    return
                except queue.Full:
                    continue

    def stop(self):
        self._stop.set()

    def __iter__(self) -> Iterator[PoseTrainingBatch]:
        rng = np.random.RandomState(self.seed + 1)
        key = jax.random.PRNGKey(self.seed)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_chunks)
        self._stop = stop = threading.Event()
        t = threading.Thread(
            target=self._decode_loop, args=(q, stop), daemon=True
        )
        t.start()
        try:
            while True:
                chunk = q.get()
                if isinstance(chunk, BaseException):
                    raise RuntimeError(
                        "streaming decode thread failed"
                    ) from chunk
                frames_dev = jnp.asarray(chunk.frames)  # -> device, uint8
                S = len(chunk.sample_frame)
                n_batches = max(
                    1,
                    int(self.samples_per_chunk_pass * S) // self.batch_size,
                )
                for _ in range(n_batches):
                    sel = rng.randint(S, size=self.batch_size)
                    imgs = frames_dev[
                        jnp.asarray(chunk.sample_frame[sel], jnp.int32)
                    ]
                    imgs = jnp.moveaxis(
                        imgs.astype(jnp.float32) / 255.0, -1, 1
                    )
                    K = jnp.asarray(chunk.sample_K[sel])
                    imgs, K = crop_resize_to_aspect(
                        imgs, K, self.resolution
                    )
                    key, k1 = jax.random.split(key)
                    if self.apply_rgb_augmentation:
                        imgs = rgb_jitter(k1, imgs)
                    yield PoseTrainingBatch(
                        images=imgs,
                        K=K,
                        obj_ids=jnp.asarray(chunk.sample_obj_id[sel]),
                        TCO_gt=jnp.asarray(chunk.sample_TCO[sel]),
                    )
        finally:
            stop.set()
