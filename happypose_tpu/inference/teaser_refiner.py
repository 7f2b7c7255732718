"""Robust correspondence-based depth refinement (GNC-TLS, pure JAX).

Parity target: /root/reference/happypose/pose_estimators/megapose/inference/
teaserpp_refiner.py (`TeaserppRefiner`): render depth at the predicted pose,
take same-pixel 3D-3D correspondences between the rendered and observed
depth images (:202-215), downsample (farthest-point or random, :104-125),
solve a robust registration, and accept the update only when enough inliers
survive (:276-283). The reference shells out to the external TEASER++
library; its rotation solver there is GNC-TLS (:44-46).

Redesign: the whole refiner is a fixed-shape batched computation —
graduated non-convexity over a truncated-least-squares registration
(Yang et al., "Graduated Non-Convexity for Robust Spatial Perception"),
each GNC step a weighted Procrustes solve (3x3 SVD on device), `lax.scan`
over a fixed iteration count, `vmap` over instances. No per-instance host
loop, no external solver.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from happypose_tpu.inference.icp_refiner import backproject_depth
from happypose_tpu.lib3d.transforms import make_T


def weighted_procrustes(
    src: jax.Array,  # [N, 3]
    dst: jax.Array,  # [N, 3]
    w: jax.Array,  # [N] non-negative
) -> Tuple[jax.Array, jax.Array]:
    """Closed-form weighted rigid alignment src -> dst (Kabsch/SVD)."""
    wsum = jnp.maximum(w.sum(), 1e-9)
    p_bar = (w[:, None] * src).sum(0) / wsum
    q_bar = (w[:, None] * dst).sum(0) / wsum
    P = src - p_bar
    Q = dst - q_bar
    H = (w[:, None] * P).T @ Q  # [3, 3]
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
    D = jnp.diag(jnp.asarray([1.0, 1.0, 1.0], H.dtype)).at[2, 2].set(d)
    R = Vt.T @ D @ U.T
    t = q_bar - R @ p_bar
    return R, t


@partial(jax.jit, static_argnames=("n_iterations",))
def gnc_tls_registration(
    src: jax.Array,  # [N, 3]
    dst: jax.Array,  # [N, 3]
    valid: jax.Array,  # [N] bool
    noise_bound: float = 0.01,
    gnc_factor: float = 1.4,
    n_iterations: int = 50,
) -> Tuple[jax.Array, jax.Array]:
    """GNC-TLS rigid registration of correspondences src[i] <-> dst[i].

    Returns (T [4,4] aligning src->dst, n_inliers) where an inlier has
    post-alignment residual < noise_bound (the reference's acceptance
    count, teaserpp_refiner.py:169-171)."""
    c2 = jnp.asarray(noise_bound, src.dtype) ** 2
    vf = valid.astype(src.dtype)

    def residuals2(R, t):
        return jnp.sum((src @ R.T + t - dst) ** 2, axis=-1)

    # initial fit with all valid points; mu from max residual (GNC paper)
    R0, t0 = weighted_procrustes(src, dst, vf)
    r2 = jnp.where(valid, residuals2(R0, t0), 0.0)
    r2_max = jnp.maximum(r2.max(), c2 * (1.0 + 1e-3))
    mu0 = c2 / (2.0 * r2_max - c2)

    def body(carry, _):
        R, t, mu = carry
        r2 = residuals2(R, t)
        # TLS surrogate weights for current mu
        lo = mu / (mu + 1.0) * c2
        hi = (mu + 1.0) / mu * c2
        w_mid = jnp.sqrt(c2 * mu * (mu + 1.0) / jnp.maximum(r2, 1e-18)) - mu
        w = jnp.where(r2 <= lo, 1.0, jnp.where(r2 >= hi, 0.0, w_mid))
        w = jnp.clip(w, 0.0, 1.0) * vf
        R_new, t_new = weighted_procrustes(src, dst, w)
        return (R_new, t_new, mu * gnc_factor), None

    (R, t, _), _ = jax.lax.scan(
        body, (R0, t0, mu0), None, length=n_iterations
    )
    n_inliers = jnp.sum(valid & (residuals2(R, t) < c2))
    return make_T(R, t), n_inliers


def farthest_point_sample(
    pts: jax.Array,  # [N, 3]
    valid: jax.Array,  # [N]
    n: int,
    key: jax.Array,
) -> jax.Array:
    """Indices of n farthest-point samples among valid points.

    Replaces the reference's pytorch3d.ops.sample_farthest_points
    (teaserpp_refiner.py:115-119); O(n·N) lax.scan, fixed shapes."""
    big = jnp.asarray(jnp.inf, pts.dtype)
    invalid_pen = jnp.where(valid, 0.0, -big)
    start = jnp.argmax(
        jax.random.uniform(key, valid.shape) + valid.astype(pts.dtype)
    )

    def body(carry, _):
        mind, last = carry
        d = jnp.sum((pts - pts[last]) ** 2, axis=-1)
        mind = jnp.minimum(mind, d)
        nxt = jnp.argmax(mind + invalid_pen)
        return (mind, nxt), last

    (_, _), idx = jax.lax.scan(
        body, (jnp.full(pts.shape[0], big), start), None, length=n
    )
    return idx


class TeaserRefiner:
    """Drop-in alternative to `ICPRefiner` for `run_depth_refiner`
    (megapose/inference/pose_estimator.py:497-513, depth_refiner='teaserpp')."""

    def __init__(
        self,
        assets,
        renderer_fn,
        resolution=(120, 160),
        n_points: int = 512,
        n_min_points: int = 100,
        noise_bound: float = 0.01,
        min_num_inliers: int = 50,
        n_iterations: int = 50,
        n_outer_iterations: int = 1,
        use_farthest_point_sampling: bool = True,
    ):
        self.assets = assets
        self.renderer_fn = renderer_fn  # (assets, ids, TCO, K, resolution)
        self.resolution = resolution
        self.n_points = n_points
        self.n_min_points = n_min_points
        self.noise_bound = noise_bound
        self.min_num_inliers = min_num_inliers
        self.n_iterations = n_iterations
        # >1 re-renders at the refined pose and re-solves: fixes the
        # residual error same-pixel correspondences leave on curved
        # geometry (the reference solves only once)
        self.n_outer_iterations = n_outer_iterations
        self.use_fps = use_farthest_point_sampling

    def refine(
        self,
        obj_ids: jax.Array,  # [B]
        TCO: jax.Array,  # [B, 4, 4]
        K: jax.Array,  # [B, 3, 3] (intrinsics scaled to the depth map)
        depth_obs: jax.Array,  # [B, H, W] observed depth (meters)
        key: Optional[jax.Array] = None,
    ) -> jax.Array:
        """Returns refined TCO [B, 4, 4]."""
        key = key if key is not None else jax.random.PRNGKey(0)

        def per_instance(depth_r, depth_o, K_i, T_i, k):
            src_all, src_v = backproject_depth(depth_r, K_i)
            tgt_all, tgt_v = backproject_depth(depth_o, K_i)
            corr_v = src_v & tgt_v  # same-pixel correspondences
            if self.use_fps:
                idx = farthest_point_sample(src_all, corr_v, self.n_points, k)
            else:
                score = corr_v.astype(jnp.float32) + jax.random.uniform(
                    k, corr_v.shape, maxval=0.5
                )
                _, idx = jax.lax.top_k(score, self.n_points)
            src, dst, v = src_all[idx], tgt_all[idx], corr_v[idx]
            dT, n_inl = gnc_tls_registration(
                src, dst, v,
                noise_bound=self.noise_bound,
                n_iterations=self.n_iterations,
            )
            ok = (corr_v.sum() >= self.n_min_points) & (
                n_inl >= self.min_num_inliers
            )
            return jnp.where(ok, dT @ T_i, T_i)

        for outer in range(self.n_outer_iterations):
            render = self.renderer_fn(
                self.assets, obj_ids, TCO, K, resolution=self.resolution
            )
            keys = jax.random.split(
                jax.random.fold_in(key, outer), TCO.shape[0]
            )
            TCO = jax.vmap(per_instance)(
                render.depth, depth_obs, K, TCO, keys
            )
        return TCO
