"""Pose estimation pipelines (CosyPose + MegaPose), fully jitted stages.

Parity targets:
- MegaPose novel-object pipeline: /root/reference/happypose/pose_estimators/
  megapose/inference/pose_estimator.py (`forward_coarse_model` :327,
  `forward_refiner` :104, `forward_scoring_model` :222,
  `run_inference_pipeline` :516).
- CosyPose known-object pipeline: cosypose/integrated/pose_estimator.py:137.

Design deltas: detections are padded fixed-size batches; the
hypothesis axis (detections x SO(3)-grid) is processed in static chunks with
`lax.map`, each chunk running crop -> on-device render -> CNN scoring inside
the same jit; group-wise top-k uses masked segment ops instead of pandas.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from happypose_tpu.inference.types import (
    DetectionBatch,
    InferenceConfig,
    ObservationBatch,
    PoseEstimateBatch,
    replace_valid,
)
from happypose_tpu.lib3d.pose_init import (
    TCO_init_from_boxes_autodepth_with_R,
    TCO_init_from_boxes_zup_autodepth,
)
from happypose_tpu.lib3d.so3_grid import load_SO3_grid
from happypose_tpu.meshes.database import BatchedMeshes, RenderAssets
from happypose_tpu.models.pose_predictor import PosePredictor
from happypose_tpu.ops.segment_ops import group_keys, topk_per_group


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


# Module-level jitted stage functions: the jit cache keys on the *model*
# (a frozen dataclass — equal configs hash equal), not on the
# PoseEstimator instance, so constructing a new estimator never recompiles
# (round-1 "jit-keyed-on-self" known limit, docs/scaling.md).
@functools.partial(jax.jit, static_argnames=("model",))
def _coarse_logits_fn(model, variables, images, K, obj_ids, TCO, assets,
                      meshes):
    out = model.apply(
        variables, images, K, obj_ids, TCO, assets, meshes, n_iterations=1
    )
    return out.renderings_logits[0, :, 0]  # [chunk]


@functools.partial(jax.jit, static_argnames=("model", "n_iterations"))
def _refine_fn(model, variables, images, K, obj_ids, TCO, assets, meshes,
               n_iterations):
    out = model.apply(
        variables, images, K, obj_ids, TCO, assets, meshes,
        n_iterations=n_iterations,
    )
    return out.TCO_output  # [n_iter, chunk, 4, 4]


class PoseEstimator:
    """Host-side orchestrator owning jitted stage functions.

    Args:
      refiner: (PosePredictor, variables) — pose-update model.
      coarse: (PosePredictor, variables) — either a CosyPose-style pose
        model (predict_pose_update) or a MegaPose hypothesis classifier
        (predict_rendered_views_logits); inferred from its config.
      assets / meshes: the padded mesh database tensors.
      cfg: InferenceConfig.
    """

    def __init__(
        self,
        refiner: Optional[Tuple[PosePredictor, dict]],
        coarse: Optional[Tuple[PosePredictor, dict]],
        assets: RenderAssets,
        meshes: BatchedMeshes,
        cfg: InferenceConfig = InferenceConfig(),
        device_mesh=None,
        mesh_axis: str = "hp",
    ):
        """`device_mesh`: optional jax.sharding.Mesh — shards the coarse
        hypothesis axis across devices (SURVEY.md §5.7's scale axis);
        hypotheses per shard replace the serial `bsz_images` chunking."""
        self.refiner_model, self.refiner_vars = refiner if refiner else (None, None)
        self.coarse_model, self.coarse_vars = coarse if coarse else (None, None)
        self.assets = assets
        self.meshes = meshes
        if device_mesh is None:
            # commit weights/assets to the device ONCE: checkpoint loads
            # hand back host numpy pytrees, and passing those to a jitted
            # call would copy them to the device again on EVERY frame
            (
                self.refiner_vars, self.coarse_vars, self.assets, self.meshes,
            ) = jax.device_put(
                (self.refiner_vars, self.coarse_vars, self.assets, self.meshes)
            )
        self.cfg = cfg
        self.device_mesh = device_mesh
        self.mesh_axis = mesh_axis
        self.SO3_grid = jnp.asarray(load_SO3_grid(cfg.SO3_grid_size))
        self._coarse_is_classifier = (
            self.coarse_model is not None
            and self.coarse_model.cfg.predict_rendered_views_logits
        )
        self._depth_refiners: Dict[tuple, object] = {}
        self._pipeline_jit_cache: Dict[tuple, object] = {}

    # ------------------------------------------------------------------
    # MegaPose coarse: score detections x SO(3)-grid hypotheses
    # ------------------------------------------------------------------

    def forward_coarse(
        self, obs: ObservationBatch, detections: DetectionBatch
    ) -> PoseEstimateBatch:
        """Replicate each detection over the SO(3) grid, init TCO with
        autodepth, score every hypothesis with the coarse classifier.

        Parity: pose_estimator.py:327-485.
        """
        assert self._coarse_is_classifier
        D = detections.n_rows
        # size from the loaded grid, not the config: the shipped "512"
        # .qua file actually holds 576 rotations (see lib3d/so3_grid.py)
        M = int(self.SO3_grid.shape[0])
        N = D * M

        det_idx = jnp.repeat(jnp.arange(D, dtype=jnp.int32), M)  # [N]
        hyp_ids = jnp.tile(jnp.arange(M, dtype=jnp.int32), D)
        boxes = detections.boxes[det_idx]
        obj_ids = detections.obj_ids[det_idx]
        im_ids = detections.batch_im_ids[det_idx]
        valid = detections.valid[det_idx]
        R = jnp.tile(self.SO3_grid, (D, 1, 1))  # [N, 3, 3]
        K = obs.K[im_ids]

        inst_meshes = self.meshes.select(obj_ids)
        TCO_init = TCO_init_from_boxes_autodepth_with_R(
            boxes, inst_meshes.points, K, R, inst_meshes.points_mask
        )

        logits = self._score_hypotheses(obs, K, obj_ids, im_ids, TCO_init)
        logits = jnp.where(valid, logits, -jnp.inf)

        return PoseEstimateBatch(
            poses=TCO_init,
            K=K,
            obj_ids=obj_ids,
            batch_im_ids=im_ids,
            instance_ids=detections.instance_ids[det_idx],
            hypothesis_ids=hyp_ids,
            scores=detections.scores[det_idx],
            coarse_logits=logits,
            pose_logits=jnp.zeros_like(logits),
            valid=valid,
        )

    def forward_coarse_jit(
        self, obs: ObservationBatch, detections: DetectionBatch
    ) -> PoseEstimateBatch:
        """`forward_coarse` as one compiled program per (image shape, D),
        for the reason given in `run_inference_pipeline_jit`."""
        key = ("coarse", obs.rgb.shape, detections.n_rows)
        fn = self._pipeline_jit_cache.get(key)
        if fn is None:

            def raw(cv, assets, meshes, grid, obs_t, det_t):
                saved = (
                    self.coarse_vars, self.assets, self.meshes, self.SO3_grid,
                )
                (
                    self.coarse_vars, self.assets, self.meshes, self.SO3_grid,
                ) = (cv, assets, meshes, grid)
                try:
                    return self.forward_coarse(obs_t, det_t)
                finally:
                    (
                        self.coarse_vars, self.assets, self.meshes,
                        self.SO3_grid,
                    ) = saved

            fn = jax.jit(raw)
            self._pipeline_jit_cache[key] = fn
        return fn(
            self.coarse_vars, self.assets, self.meshes, self.SO3_grid,
            obs, detections,
        )

    def _score_hypotheses(self, obs, K, obj_ids, im_ids, TCO) -> jax.Array:
        """Coarse-classifier scoring of [N] hypotheses: chunked serially by
        `bsz_images`, or device-parallel over the hypothesis axis when a
        device mesh is configured."""
        if self.device_mesh is not None:
            return self._score_hypotheses_sharded(obs, K, obj_ids, im_ids, TCO)
        cfg = self.cfg
        N = TCO.shape[0]
        chunk = min(cfg.bsz_images, N)
        Np = _ceil_to(N, chunk)

        def padn(x):
            widths = [(0, Np - N)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, widths)

        Kp, op, ip, Tp = padn(K), padn(obj_ids), padn(im_ids), padn(TCO)
        n_chunks = Np // chunk

        def body(args):
            Kc, oc, ic, Tc = args
            imgs = obs.images[ic]
            mc = self.meshes.select(oc)
            return _coarse_logits_fn(
                self.coarse_model, self.coarse_vars, imgs, Kc, oc, Tc,
                self.assets, mc,
            )

        logits = jax.lax.map(
            body,
            (
                Kp.reshape(n_chunks, chunk, 3, 3),
                op.reshape(n_chunks, chunk),
                ip.reshape(n_chunks, chunk),
                Tp.reshape(n_chunks, chunk, 4, 4),
            ),
        )
        return logits.reshape(Np)[:N]

    def _score_hypotheses_sharded(self, obs, K, obj_ids, im_ids, TCO):
        """Hypothesis axis sharded over the device mesh; each device scores
        its shard (weights/assets replicated), results concatenate."""
        from happypose_tpu.parallel.collectives import sharded_batch_apply
        from happypose_tpu.parallel.mesh import shard_leading

        mesh = self.device_mesh
        n_dev = int(
            mesh.devices.size if hasattr(mesh.devices, "size")
            else len(mesh.devices)
        )
        N = TCO.shape[0]
        Np = _ceil_to(N, n_dev)

        def padn(x):
            widths = [(0, Np - N)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, widths)

        def score(batch):
            Kc, oc, ic, Tc = batch
            imgs = obs.images[ic]
            mc = self.meshes.select(oc)
            out = self.coarse_model.apply(
                self.coarse_vars, imgs, Kc, oc, Tc, self.assets, mc,
                n_iterations=1,
            )
            return out.renderings_logits[0, :, 0]

        fn = sharded_batch_apply(score, mesh, axis=self.mesh_axis)
        batch = shard_leading(
            (padn(K), padn(obj_ids), padn(im_ids), padn(TCO)), mesh,
            self.mesh_axis,
        )
        return fn(batch)[:N]

    # ------------------------------------------------------------------
    # Refiner
    # ------------------------------------------------------------------

    def forward_refiner(
        self, obs: ObservationBatch, estimates: PoseEstimateBatch,
        n_iterations: Optional[int] = None,
    ) -> Tuple[PoseEstimateBatch, Dict[str, PoseEstimateBatch]]:
        """Iteratively refine all estimates (chunked by bsz_objects).

        Parity: pose_estimator.py:104-220. Returns (final, per-iteration).
        """
        cfg = self.cfg
        n_iterations = n_iterations or cfg.n_refiner_iterations
        N = estimates.n_rows
        chunk = min(cfg.bsz_objects, N)
        Np = _ceil_to(N, chunk)

        def padn(x):
            widths = [(0, Np - N)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, widths)

        K = padn(estimates.K)
        obj_ids = padn(estimates.obj_ids)
        im_ids = padn(estimates.batch_im_ids)
        TCO = padn(estimates.poses)
        n_chunks = Np // chunk

        def body(args):
            Kc, oc, ic, Tc = args
            imgs = obs.images[ic]
            mc = self.meshes.select(oc)
            return _refine_fn(
                self.refiner_model, self.refiner_vars, imgs, Kc, oc, Tc,
                self.assets, mc, n_iterations,
            )

        all_iters = jax.lax.map(
            body,
            (
                K.reshape(n_chunks, chunk, 3, 3),
                obj_ids.reshape(n_chunks, chunk),
                im_ids.reshape(n_chunks, chunk),
                TCO.reshape(n_chunks, chunk, 4, 4),
            ),
        )  # [n_chunks, n_iter, chunk, 4, 4]
        all_iters = jnp.moveaxis(all_iters, 1, 0).reshape(n_iterations, Np, 4, 4)
        all_iters = all_iters[:, :N]

        per_iter = {
            f"iteration={it + 1}": dataclasses.replace(
                estimates, poses=all_iters[it]
            )
            for it in range(n_iterations)
        }
        return per_iter[f"iteration={n_iterations}"], per_iter

    # ------------------------------------------------------------------
    # Scoring model (re-score refined poses with the coarse classifier)
    # ------------------------------------------------------------------

    def forward_scoring(
        self, obs: ObservationBatch, estimates: PoseEstimateBatch
    ) -> PoseEstimateBatch:
        """Parity: pose_estimator.py:222-325."""
        logits = self._score_hypotheses(
            obs, estimates.K, estimates.obj_ids, estimates.batch_im_ids,
            estimates.poses,
        )
        logits = jnp.where(estimates.valid, logits, -jnp.inf)
        return dataclasses.replace(estimates, pose_logits=logits)

    # ------------------------------------------------------------------
    # Selection
    # ------------------------------------------------------------------

    @staticmethod
    def filter_top_k(
        estimates: PoseEstimateBatch, by: str, k: int
    ) -> PoseEstimateBatch:
        """Group-wise top-k (groups = batch_im_id x obj_id x instance_id).

        Parity: tensor_collection.py:201-230 (`filter_top_pose_estimates`).
        """
        key = group_keys(
            estimates.batch_im_ids, estimates.obj_ids, estimates.instance_ids
        )
        score = getattr(estimates, by)
        keep = topk_per_group(key, score, estimates.valid, k)
        return replace_valid(estimates, keep)

    # ------------------------------------------------------------------
    # CosyPose-style init (no SO(3) grid)
    # ------------------------------------------------------------------

    def make_TCO_init(
        self, obs: ObservationBatch, detections: DetectionBatch
    ) -> PoseEstimateBatch:
        """Parity: cosypose/integrated/pose_estimator.py:125-134 (zup+autodepth)."""
        K = obs.K[detections.batch_im_ids]
        inst = self.meshes.select(detections.obj_ids)
        TCO = TCO_init_from_boxes_zup_autodepth(
            detections.boxes, inst.points, K, inst.points_mask
        )
        z = jnp.zeros_like(detections.scores)
        return PoseEstimateBatch(
            poses=TCO, K=K, obj_ids=detections.obj_ids,
            batch_im_ids=detections.batch_im_ids,
            instance_ids=detections.instance_ids,
            hypothesis_ids=jnp.zeros_like(detections.obj_ids),
            scores=detections.scores, coarse_logits=z, pose_logits=z,
            valid=detections.valid,
        )

    # ------------------------------------------------------------------
    # Full pipelines
    # ------------------------------------------------------------------

    def run_inference_pipeline(
        self,
        obs: ObservationBatch,
        detections: DetectionBatch,
        n_refiner_iterations: Optional[int] = None,
        n_pose_hypotheses: Optional[int] = None,
    ) -> Dict[str, PoseEstimateBatch]:
        """Full pipeline. MegaPose flavor when the coarse model is a
        classifier (grid scoring -> top-K -> refine -> re-score -> top-1);
        CosyPose flavor otherwise (init -> coarse iters -> refine).

        Parity: megapose pose_estimator.py:516-668,
        cosypose pose_estimator.py:137-470.
        """
        cfg = self.cfg
        n_hyp = n_pose_hypotheses or cfg.n_pose_hypotheses
        results: Dict[str, PoseEstimateBatch] = {}

        if self._coarse_is_classifier:
            coarse = self.forward_coarse(obs, detections)
            results["coarse"] = coarse
            kept = self.filter_top_k(coarse, by="coarse_logits", k=n_hyp)
            # compact to D*n_hyp rows for the refiner (static shape)
            D = detections.n_rows
            order = jnp.argsort(
                jnp.where(kept.valid, 0, 1) * jnp.float32(1e9)
                - kept.coarse_logits
            )
            take = order[: D * n_hyp]
            subset = kept.select(take)
            refined, per_iter = self.forward_refiner(
                obs, subset, n_refiner_iterations
            )
            results.update(per_iter)
            scored = self.forward_scoring(obs, refined)
            results["scored"] = scored
            final = self.filter_top_k(scored, by="pose_logits", k=1)
        else:
            init = self.make_TCO_init(obs, detections)
            results["init"] = init
            est = init
            if self.coarse_model is not None:
                est, _ = self._forward_coarse_pose_model(obs, est)
                results["coarse"] = est
            final, per_iter = self.forward_refiner(
                obs, est, n_refiner_iterations
            )
            results.update(per_iter)
            # CosyPose has no scoring model; score = detection score
            final = dataclasses.replace(final, pose_logits=final.scores)
        if cfg.run_depth_refiner and obs.depth is not None:
            final = self.run_depth_refiner(obs, final)
            results["depth_refined"] = final
        results["final"] = final
        return results

    def run_inference_pipeline_jit(
        self,
        obs: ObservationBatch,
        detections: DetectionBatch,
        n_refiner_iterations: Optional[int] = None,
        n_pose_hypotheses: Optional[int] = None,
    ) -> Dict[str, PoseEstimateBatch]:
        """`run_inference_pipeline` compiled into ONE XLA program.

        The eager pipeline dispatches hundreds of small ops per frame, each
        a host round trip. Here the whole frame — coarse grid scoring,
        top-K, refinement, re-scoring, selection — traces once per (image shape, detection
        count, iteration config) and each subsequent frame is a single
        dispatch. Weights/assets/meshes are passed as arguments (not
        captured) so they stage to HBM once instead of baking into the
        executable. Not used when a device mesh shards the hypothesis axis
        (that path jits inside `sharded_batch_apply`)."""
        key = (
            obs.rgb.shape,
            None if obs.depth is None else obs.depth.shape,
            detections.n_rows,
            n_refiner_iterations,
            n_pose_hypotheses,
        )
        fn = self._pipeline_jit_cache.get(key)
        if fn is None:

            def raw(rv, cv, assets, meshes, grid, obs_t, det_t):
                saved = (
                    self.refiner_vars, self.coarse_vars, self.assets,
                    self.meshes, self.SO3_grid,
                )
                (
                    self.refiner_vars, self.coarse_vars, self.assets,
                    self.meshes, self.SO3_grid,
                ) = (rv, cv, assets, meshes, grid)
                try:
                    return self.run_inference_pipeline(
                        obs_t, det_t, n_refiner_iterations, n_pose_hypotheses
                    )
                finally:
                    (
                        self.refiner_vars, self.coarse_vars, self.assets,
                        self.meshes, self.SO3_grid,
                    ) = saved

            fn = jax.jit(raw)
            self._pipeline_jit_cache[key] = fn
        return fn(
            self.refiner_vars, self.coarse_vars, self.assets, self.meshes,
            self.SO3_grid, obs, detections,
        )

    def run_depth_refiner(
        self, obs: ObservationBatch, estimates: PoseEstimateBatch
    ) -> PoseEstimateBatch:
        """Depth refinement against the observed depth (parity:
        megapose/inference/pose_estimator.py:497-513,633-642).
        `cfg.depth_refiner` selects 'icp' (default) or 'teaserpp' (robust
        GNC-TLS registration, the reference's TEASER++ option)."""
        from happypose_tpu.inference.icp_refiner import ICPRefiner
        from happypose_tpu.inference.teaser_refiner import TeaserRefiner
        from happypose_tpu.ops.renderers import get_renderer

        H, W = obs.rgb.shape[-2:]
        # refine at a reduced depth resolution for fixed cost
        scale = max(1, max(H, W) // 160)
        h, w = H // scale, W // scale
        depth = obs.depth[:, 0, ::scale, ::scale]
        K_scaled = obs.K.at[:, :2].divide(float(scale))
        render_fn = get_renderer(
            self.refiner_model.cfg.renderer if self.refiner_model else None
        )
        refiner_cls = (
            TeaserRefiner
            if self.cfg.depth_refiner == "teaserpp"
            else ICPRefiner
        )
        # cache the refiner (and its jit) across calls — round 1 rebuilt
        # both per call
        key = (refiner_cls, render_fn, (h, w))
        icp = self._depth_refiners.get(key)
        if icp is None:
            icp = refiner_cls(self.assets, render_fn, resolution=(h, w))
            self._depth_refiners[key] = icp
        poses = icp.refine(
            estimates.obj_ids,
            estimates.poses,
            K_scaled[estimates.batch_im_ids],
            depth[estimates.batch_im_ids],
        )
        # only valid rows move
        poses = jnp.where(
            estimates.valid[:, None, None], poses, estimates.poses
        )
        return dataclasses.replace(estimates, poses=poses)

    def _forward_coarse_pose_model(self, obs, estimates):
        """CosyPose coarse = a pose model run n_coarse_iterations."""
        saved = self.refiner_model, self.refiner_vars
        self.refiner_model, self.refiner_vars = self.coarse_model, self.coarse_vars
        try:
            out = self.forward_refiner(
                obs, estimates, n_iterations=self.cfg.n_coarse_iterations
            )
        finally:
            self.refiner_model, self.refiner_vars = saved
        return out
