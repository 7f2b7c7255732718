"""Multi-view candidate matching via RANSAC on relative camera poses.

Parity targets:
- pipeline: /root/reference/happypose/pose_estimators/cosypose/cosypose/
  multiview/ransac.py:150-223 (`multiview_candidate_matching`),
  `estimate_camera_poses` :23-50, `score_tmatches` :80-86,
  `scene_level_matching` :100-128.
- combinatorics (the C++ extension): cosypose/csrc/cosypose_cext.cpp —
  `make_ransac_infos` :38-107 (tentative matches per view pair + seed
  sampling) and `find_ransac_inliers` :109-218 (threshold -> greedy unique
  1-1 by sorted distance -> best hypothesis per view pair with the
  (more inliers, then lower dist sum) tie-break).

Design (SURVEY.md §2.3 note): the ragged host-side lists become dense
fixed-shape tensors — tentative matches are a masked [P, M] table per view
pair, seeds are jax.random index pairs, symmetric distances and inlier
counting are batched device ops; only the final strongly-connected-component
grouping runs on host scipy (tiny graph). The reference's `> 0` best-
hypothesis guard (cosypose_cext.cpp:209, which silently drops hypothesis 0)
is fixed to `>= 0` here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from happypose_tpu.lib3d.transforms import invert_transforms, transform_pts
from happypose_tpu.meshes.database import BatchedMeshes


@dataclass
class MultiviewCandidates:
    """Single-view pose candidates across the views of one scene (numpy)."""

    poses: np.ndarray  # [N, 4, 4] TCO in each candidate's own view
    view_ids: np.ndarray  # [N] int
    obj_ids: np.ndarray  # [N] int (mesh-db object ids)
    scores: np.ndarray  # [N]
    K: Optional[np.ndarray] = None  # [n_views, 3, 3] if needed downstream

    def __len__(self) -> int:
        return len(self.poses)


def _sym_dist_pairs(
    T1: jax.Array, T2: jax.Array, points: jax.Array, points_mask: jax.Array,
    symmetries: jax.Array, sym_mask: jax.Array,
) -> jax.Array:
    """min_s mean_p || T1 S p - T2 p ||; all [B, ...] batched. Returns [B]."""
    T1s = jnp.einsum("bij,bsjk->bsik", T1, symmetries)
    p1 = transform_pts(T1s, points)  # [B, S, P, 3]
    p2 = transform_pts(T2, points)  # [B, P, 3]
    d = jnp.linalg.norm(p1 - p2[:, None], axis=-1)
    m = points_mask[:, None, :].astype(d.dtype)
    dist = (d * m).sum(-1) / jnp.maximum(m.sum(-1), 1.0)
    dist = jnp.where(sym_mask, dist, jnp.inf)
    return jnp.min(dist, axis=-1)


def _best_symmetry(
    T1: jax.Array, T2: jax.Array, points: jax.Array, points_mask: jax.Array,
    symmetries: jax.Array, sym_mask: jax.Array,
) -> jax.Array:
    """argmin_s of the same distance; returns S* [B, 4, 4]."""
    T1s = jnp.einsum("bij,bsjk->bsik", T1, symmetries)
    p1 = transform_pts(T1s, points)
    p2 = transform_pts(T2, points)
    d = jnp.linalg.norm(p1 - p2[:, None], axis=-1)
    m = points_mask[:, None, :].astype(d.dtype)
    dist = (d * m).sum(-1) / jnp.maximum(m.sum(-1), 1.0)
    dist = jnp.where(sym_mask, dist, jnp.inf)
    best = jnp.argmin(dist, axis=-1)
    return jnp.take_along_axis(
        symmetries, best[:, None, None, None], axis=1
    )[:, 0]


def multiview_candidate_matching(
    candidates: MultiviewCandidates,
    meshes: BatchedMeshes,
    n_ransac_iter: int = 20,
    dist_threshold: float = 0.02,
    n_min_inliers: int = 3,
    max_tentative_per_pair: int = 64,
    seed: int = 0,
    known_TWC: Optional[np.ndarray] = None,  # [n_views, 4, 4]
) -> Dict:
    """Match candidates across views; estimate relative camera poses.

    Returns dict with:
      edges: [E, 2] candidate index pairs (inlier matches of best hypotheses)
      component_ids: [N] scene-object id per candidate (-1 = unmatched)
      view_pairs: [(v1, v2)] with TC1C2: [n_pairs, 4, 4]
    """
    N = len(candidates)
    view_ids = np.asarray(candidates.view_ids)
    obj_ids = np.asarray(candidates.obj_ids)
    views = np.unique(view_ids)
    rng = np.random.RandomState(seed)

    # ---- tentative matches per ordered view pair (host: tiny) ----
    pair_list = []  # (v1, v2, matches [M, 2])
    for v1 in views:
        for v2 in views:
            if v1 == v2:
                continue
            c1s = np.where(view_ids == v1)[0]
            c2s = np.where(view_ids == v2)[0]
            matches = [
                (a, b) for a in c1s for b in c2s if obj_ids[a] == obj_ids[b]
            ]
            if matches:
                pair_list.append((v1, v2, np.asarray(matches[:max_tentative_per_pair])))
    if not pair_list:
        return {
            "edges": np.zeros((0, 2), int),
            "component_ids": np.full(N, -1),
            "view_pairs": [],
            "TC1C2": np.zeros((0, 4, 4)),
        }

    poses_j = jnp.asarray(candidates.poses, jnp.float32)
    inst = meshes.select(jnp.asarray(obj_ids, jnp.int32))

    results_edges = []
    best_TC1C2 = []
    best_pairs = []
    for (v1, v2, matches) in pair_list:
        M = len(matches)
        a_idx = matches[:, 0]
        b_idx = matches[:, 1]
        if known_TWC is not None:
            vmap_ = {v: i for i, v in enumerate(views)}
            TC1C2_h = (
                np.linalg.inv(known_TWC[vmap_[v1]]) @ known_TWC[vmap_[v2]]
            )[None]
            R = 1
            TC1C2_h = jnp.asarray(TC1C2_h, jnp.float32)
        else:
            # ---- seeds: pairs of distinct tentative matches ----
            R = min(n_ransac_iter, M * max(M - 1, 1))
            if M < 2:
                seeds = np.zeros((R, 2), int)
            else:
                seeds = np.stack(
                    [rng.choice(M, 2, replace=False) for _ in range(R)]
                )
            m1, m2 = seeds[:, 0], seeds[:, 1]
            # hypothesis from match1 with symmetry chosen to best explain match2
            TC1Oa = poses_j[a_idx[m1]]
            TC2Ob = poses_j[b_idx[m1]]
            TC1Og = poses_j[a_idx[m2]]
            TC2Od = poses_j[b_idx[m2]]
            TObC2 = invert_transforms(TC2Ob)
            ids_ab = jnp.asarray(obj_ids[a_idx[m1]], jnp.int32)
            mesh_ab = meshes.select(ids_ab)
            ids_gd = jnp.asarray(obj_ids[a_idx[m2]], jnp.int32)
            mesh_gd = meshes.select(ids_gd)

            # evaluate all symmetries of the first match's object
            S = mesh_ab.symmetries  # [R, S, 4, 4]
            n_sym = S.shape[1]
            TC1C2_all = jnp.einsum(
                "rij,rsjk,rkl->rsil", TC1Oa, S, TObC2
            )  # [R, S, 4, 4]
            pred = jnp.einsum("rsij,rjk->rsik", TC1C2_all, TC2Od)
            # dist of TC1Og vs pred under gd symmetries: flatten (R*S)
            flat = pred.reshape(-1, 4, 4)
            rep = lambda x: jnp.repeat(x, n_sym, axis=0)
            d = _sym_dist_pairs(
                rep(TC1Og), flat, rep(mesh_gd.points), rep(mesh_gd.points_mask),
                rep(mesh_gd.symmetries), rep(mesh_gd.symmetries_mask),
            ).reshape(R, n_sym)
            d = jnp.where(mesh_ab.symmetries_mask, d, jnp.inf)
            s_star = jnp.argmin(d, axis=-1)
            TC1C2_h = jnp.take_along_axis(
                TC1C2_all, s_star[:, None, None, None], axis=1
            )[:, 0]

        # ---- score all tentative matches under all R hypotheses ----
        TC1Oa_all = poses_j[a_idx]  # [M, 4, 4]
        TC2Ob_all = poses_j[b_idx]
        TWOb = jnp.einsum("rij,mjk->rmik", TC1C2_h, TC2Ob_all)  # [R, M, 4, 4]
        flat2 = TWOb.reshape(-1, 4, 4)
        repM = lambda x: jnp.tile(x, (R,) + (1,) * (x.ndim - 1))
        ids_a = jnp.asarray(obj_ids[a_idx], jnp.int32)
        mesh_a = meshes.select(ids_a)
        dists = _sym_dist_pairs(
            repM(TC1Oa_all), flat2, repM(mesh_a.points),
            repM(mesh_a.points_mask), repM(mesh_a.symmetries),
            repM(mesh_a.symmetries_mask),
        ).reshape(R, M)
        dists = np.asarray(dists)

        # ---- greedy unique 1-1 per hypothesis (host, tiny) ----
        best = None  # (n_inliers, -dists_sum, hyp_id, edges)
        for r in range(R):
            order = np.argsort(dists[r])
            used1, used2 = set(), set()
            edges_r = []
            dsum = 0.0
            for i in order:
                if dists[r][i] > dist_threshold:
                    break
                c1, c2 = int(a_idx[i]), int(b_idx[i])
                if c1 in used1 or c2 in used2:
                    continue
                used1.add(c1)
                used2.add(c2)
                edges_r.append((c1, c2))
                dsum += float(dists[r][i])
            n_inl = len(edges_r)
            if n_inl >= n_min_inliers:
                key = (n_inl, -dsum)
                if best is None or key > (best[0], best[1]):
                    best = (n_inl, -dsum, r, edges_r)
        if best is not None:
            results_edges.extend(best[3])
            best_TC1C2.append(np.asarray(TC1C2_h[best[2]]))
            best_pairs.append((int(v1), int(v2)))

    # ---- strongly-connected-component grouping ----
    if results_edges:
        e = np.asarray(results_edges)
        graph = csr_matrix(
            (np.ones(len(e), int), (e[:, 0], e[:, 1])), shape=(N, N)
        )
        n_comp, comp = connected_components(
            graph, directed=True, connection="strong"
        )
        sizes = np.bincount(comp, minlength=n_comp)
        component_ids = np.where(sizes[comp] >= 2, comp, -1)
        # renumber surviving components densely
        uniq = np.unique(component_ids[component_ids >= 0])
        remap = {int(u): i for i, u in enumerate(uniq)}
        component_ids = np.asarray(
            [remap.get(int(c), -1) for c in component_ids]
        )
    else:
        component_ids = np.full(N, -1)

    return {
        "edges": np.asarray(results_edges).reshape(-1, 2),
        "component_ids": component_ids,
        "view_pairs": best_pairs,
        "TC1C2": np.stack(best_TC1C2) if best_TC1C2 else np.zeros((0, 4, 4)),
    }
