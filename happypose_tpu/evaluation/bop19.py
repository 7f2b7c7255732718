"""BOP19 official pose errors (VSD / MSSD / MSPD) computed on-device.

The reference shells out to the external ``bop_toolkit`` for its headline
BOP numbers (/root/reference/happypose/pose_estimators/megapose/evaluation/
bop.py:162-229 runs ``eval_bop19_pose.py`` in a subprocess, which in turn
rasterizes VSD depth maps with a C++/vispy renderer on the host). Here the
three BOP19 error functions are native JAX:

- **MSSD** — maximum symmetry-aware surface distance:
  ``min_sym max_pt || T_est·x - T_gt·S·x ||``.
- **MSPD** — maximum symmetry-aware projection distance (2D, pixels).
- **VSD** — visible surface discrepancy: depth maps of the object at the
  estimated and GT pose are rendered by the on-device rasterizer
  (`happypose_tpu.ops.renderers.get_renderer()`), visibility masks are
  estimated against the observed test depth (BOP19 ``visib_mode``), and the
  step-cost discrepancy is averaged over the visibility union for a range
  of misalignment tolerances τ.

Scoring follows the BOP19 protocol: per-(τ,)θ greedy score-ordered matching
of estimates to GT instances, recall over GT with ``visib_fract >= 0.1``,
``AR = (AR_VSD + AR_MSSD + AR_MSPD) / 3``.

All pairwise errors for one image batch are computed in a single device
pass; only the tiny greedy matching runs on host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from happypose_tpu.lib3d.transforms import transform_pts
from happypose_tpu.meshes.database import BatchedMeshes, RenderAssets
from happypose_tpu.ops.renderers import get_renderer

# BOP19 constants (bop_toolkit config used by the reference's eval bridge)
VSD_DELTA = 0.015  # visibility tolerance [m]
VSD_TAUS = tuple(np.arange(0.05, 0.51, 0.05))  # rel. to diameter
CORRECTNESS_THS = tuple(np.arange(0.05, 0.51, 0.05))  # θ for VSD + MSSD (×d)
MSPD_THS = tuple(np.arange(5.0, 51.0, 5.0))  # θ for MSPD (×r, r=w/640)
VISIB_GT_MIN = 0.1


def _pair_bucket(n: int) -> int:
    """Round a pair count up to a power-of-2 bucket (min 8).

    The pairwise error kernels below are jitted with the pair axis as the
    leading dim; without bucketing every image with a new (n_est x n_gt)
    combination triggers a fresh XLA compile, and a split's evaluation
    turns into a compile per frame."""
    b = 8
    while b < n:
        b *= 2
    return b


def _pad_pairs(x: np.ndarray, n_to: int) -> np.ndarray:
    """Pad the leading axis to ``n_to`` by repeating the last row (keeps
    values geometrically sane for the renderer; results are sliced off)."""
    pad = n_to - len(x)
    if pad <= 0:
        return x
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)


@jax.jit
def mssd_mspd_batch(
    TCO_pred: jax.Array,  # [N, 4, 4]
    TCO_gt: jax.Array,  # [N, 4, 4]
    K: jax.Array,  # [N, 3, 3]
    points: jax.Array,  # [N, P, 3]
    points_mask: jax.Array,  # [N, P]
    symmetries: jax.Array,  # [N, S, 4, 4]
    sym_mask: jax.Array,  # [N, S]
) -> Dict[str, jax.Array]:
    """MSSD [m] and MSPD [px] for N (estimate, GT) pairs in one pass."""
    TCO_gt_sym = jnp.einsum("nij,nsjk->nsik", TCO_gt, symmetries)
    gt_pts = transform_pts(TCO_gt_sym, points)  # [N, S, P, 3]
    pred_pts = transform_pts(TCO_pred, points)  # [N, P, 3]

    pm = points_mask[:, None, :]  # [N, 1, P]
    d3 = jnp.linalg.norm(gt_pts - pred_pts[:, None], axis=-1)  # [N, S, P]
    d3 = jnp.where(pm, d3, 0.0)
    mssd_per_sym = jnp.max(d3, axis=-1)  # [N, S]
    mssd = jnp.min(
        jnp.where(sym_mask, mssd_per_sym, jnp.inf), axis=-1
    )

    def pinhole(cam_pts):  # camera-frame [..., 3] -> pixels [..., 2]
        suv = jnp.einsum("nij,n...j->n...i", K, cam_pts)
        return suv[..., :2] / jnp.maximum(suv[..., 2:3], 1e-6)

    uv_gt = pinhole(gt_pts)  # [N, S, P, 2]
    uv_pred = pinhole(pred_pts)  # [N, P, 2]
    d2 = jnp.linalg.norm(uv_gt - uv_pred[:, None], axis=-1)
    d2 = jnp.where(pm, d2, 0.0)
    mspd_per_sym = jnp.max(d2, axis=-1)
    mspd = jnp.min(
        jnp.where(sym_mask, mspd_per_sym, jnp.inf), axis=-1
    )
    return {"mssd": mssd, "mspd": mspd}


def _dist_from_depth(depth: jax.Array, K: jax.Array) -> jax.Array:
    """Along-ray distance image from a z-depth image ([H, W], one K)."""
    H, W = depth.shape
    v, u = jnp.meshgrid(
        jnp.arange(H, dtype=depth.dtype),
        jnp.arange(W, dtype=depth.dtype),
        indexing="ij",
    )
    x = (u - K[0, 2]) / K[0, 0]
    y = (v - K[1, 2]) / K[1, 1]
    return depth * jnp.sqrt(x * x + y * y + 1.0)


@jax.jit
def _vsd_from_depths(
    depth_est: jax.Array,  # [N, H, W] rendered z-depth at estimated pose
    depth_gt: jax.Array,  # [N, H, W] rendered z-depth at GT pose
    depth_test: jax.Array,  # [N, H, W] observed scene z-depth (0 = invalid)
    K: jax.Array,  # [N, 3, 3]
    taus: jax.Array,  # [N, n_taus] absolute tolerances [m]
) -> jax.Array:
    """BOP19 VSD step-cost errors, [N, n_taus]."""
    dist = jax.vmap(_dist_from_depth)
    d_est, d_gt, d_test = dist(depth_est, K), dist(depth_gt, K), dist(depth_test, K)

    delta = jnp.asarray(VSD_DELTA, d_gt.dtype)
    # bop_toolkit visibility.py, visib_mode='bop19': a rendered pixel is
    # visible if it is in front of the measured surface (within delta) OR
    # the test depth is invalid there.
    visib_gt = (d_gt > 0) & ((d_gt - d_test <= delta) | (d_test == 0))
    visib_est = (d_est > 0) & ((d_est - d_test <= delta) | (d_test == 0))
    # estimate additionally counts pixels it shares with the visible GT mask
    visib_est = visib_est | (visib_gt & (d_est > 0))

    inter = visib_gt & visib_est
    union = visib_gt | visib_est
    union_count = union.sum(axis=(1, 2))  # [N]
    comp_count = union_count - inter.sum(axis=(1, 2))

    d_diff = jnp.abs(d_gt - d_est)[..., None]  # [N, H, W, 1]
    over = (d_diff > taus[:, None, None, :]) & inter[..., None]
    bad = over.sum(axis=(1, 2)) + comp_count[:, None]  # [N, n_taus]
    e = bad / jnp.maximum(union_count, 1)[:, None]
    return jnp.where(union_count[:, None] == 0, 1.0, e)


def vsd_batch(
    TCO_pred: np.ndarray,  # [N, 4, 4]
    TCO_gt: np.ndarray,  # [N, 4, 4]
    obj_ids: np.ndarray,  # [N]
    K: np.ndarray,  # [N, 3, 3]
    depth_test: np.ndarray,  # [N, H, W]
    assets: RenderAssets,
    diameters: np.ndarray,  # [N]
    resolution: Optional[Tuple[int, int]] = None,
    taus_rel: Tuple[float, ...] = VSD_TAUS,
) -> np.ndarray:
    """VSD errors [N, n_taus] (taus relative to object diameter).

    Renders both pose sets with the on-device rasterizer. If ``resolution``
    differs from the test-depth shape, K and the test depth are rescaled
    (used to keep eval renders cheap on large images).
    """
    N, H, W = depth_test.shape
    if resolution is None:
        resolution = (H, W)
    rh, rw = resolution
    if (rh, rw) != (H, W):
        sy, sx = rh / H, rw / W
        S = np.asarray([[sx, 0, 0], [0, sy, 0], [0, 0, 1]], np.float32)
        K = S[None] @ np.asarray(K, np.float32)
        # nearest-neighbor depth resample (keeps 0-invalid semantics)
        yi = np.clip((np.arange(rh) / sy).astype(int), 0, H - 1)
        xi = np.clip((np.arange(rw) / sx).astype(int), 0, W - 1)
        depth_test = depth_test[:, yi][:, :, xi]
    obj_ids = jnp.asarray(obj_ids, jnp.int32)
    Kj = jnp.asarray(K, jnp.float32)
    render = get_renderer()
    r_est = render(
        assets, obj_ids, jnp.asarray(TCO_pred, jnp.float32), Kj,
        resolution=(rh, rw),
    )
    r_gt = render(
        assets, obj_ids, jnp.asarray(TCO_gt, jnp.float32), Kj,
        resolution=(rh, rw),
    )
    taus = np.asarray(taus_rel, np.float32)[None] * np.asarray(
        diameters, np.float32
    )[:, None]
    e = _vsd_from_depths(
        r_est.depth, r_gt.depth, jnp.asarray(depth_test, jnp.float32), Kj,
        jnp.asarray(taus),
    )
    return np.asarray(jax.device_get(e))


def _match_recall(
    errors: np.ndarray,  # [n_est, n_gt] pairwise (inf = different object)
    est_scores: np.ndarray,  # [n_est]
    gt_valid: np.ndarray,  # [n_gt] bool (visib >= 0.1)
    ths: np.ndarray,  # [n_est, n_gt] per-pair correctness thresholds
) -> Tuple[int, int]:
    """BOP19 greedy matching for one image/object/threshold setting.

    Estimates in descending score order claim the unmatched GT with the
    lowest error among those with error < threshold; matches to invalid
    (low-visibility) GTs consume the estimate but score nothing.
    Returns (n_valid_matched, n_valid_gt)."""
    n_est, n_gt = errors.shape
    gt_used = np.zeros(n_gt, bool)
    matched_valid = 0
    for ei in np.argsort(-est_scores):
        ok = np.where(~gt_used & (errors[ei] < ths[ei]))[0]
        if len(ok) == 0:
            continue
        gi = ok[np.argmin(errors[ei, ok])]
        gt_used[gi] = True
        if gt_valid[gi]:
            matched_valid += 1
    return matched_valid, int(gt_valid.sum())


@dataclass
class Bop19Evaluator:
    """Accumulates BOP19 AR over images.

    ``add_image`` takes one image's predictions + GT annotations (already
    as arrays) and the observed depth map (None → VSD skipped and AR is
    the mean of MSSD/MSPD recalls, matching bop_toolkit's RGB-only
    fallback behavior of excluding VSD).
    """

    meshes: BatchedMeshes
    assets: Optional[RenderAssets] = None
    vsd_resolution: Optional[Tuple[int, int]] = None
    # accumulators: per error type, lists of (n_matched, n_valid) per setting
    _tallies: Dict[str, List[np.ndarray]] = field(default_factory=dict)

    def add_image(
        self,
        TCO_pred: np.ndarray,
        pred_obj_ids: np.ndarray,
        pred_scores: np.ndarray,
        TCO_gt: np.ndarray,
        gt_obj_ids: np.ndarray,
        K: np.ndarray,  # [3, 3]
        gt_visib_fract: Optional[np.ndarray] = None,
        depth_test: Optional[np.ndarray] = None,  # [H, W], meters
        im_width: int = 640,
    ) -> None:
        n_gt = len(TCO_gt)
        if n_gt == 0:
            return
        if gt_visib_fract is None:
            gt_visib_fract = np.ones(n_gt, np.float32)
        gt_valid = np.asarray(gt_visib_fract) >= VISIB_GT_MIN

        pred_obj_ids = np.asarray(pred_obj_ids, int)
        gt_obj_ids = np.asarray(gt_obj_ids, int)

        # BOP19 n_top = -1: per object, only the top-n scored estimates
        # participate, where n counts the object's GT instances visible
        # >= 10% (bop_toolkit builds targets' inst_count from visib_fract
        # >= visib_gt_min; without this extra estimates inflate recall)
        if len(TCO_pred):
            keep = np.zeros(len(TCO_pred), bool)
            order = np.argsort(-np.asarray(pred_scores))
            taken: Dict[int, int] = {}
            for ei in order:
                o = int(pred_obj_ids[ei])
                budget = int(((gt_obj_ids == o) & gt_valid).sum())
                if taken.get(o, 0) < budget:
                    taken[o] = taken.get(o, 0) + 1
                    keep[ei] = True
            TCO_pred = np.asarray(TCO_pred)[keep]
            pred_obj_ids = pred_obj_ids[keep]
            pred_scores = np.asarray(pred_scores)[keep]
        n_est = len(TCO_pred)
        diam = np.asarray(self.meshes.diameters)

        if n_est == 0:
            # one (0, n_valid) row per threshold setting, so per-image
            # weighting matches images that do have estimates
            n_settings = {
                "mssd": len(CORRECTNESS_THS),
                "mspd": len(MSPD_THS),
                "vsd": len(VSD_TAUS) * len(CORRECTNESS_THS),
            }
            zero = np.asarray([[0, int(gt_valid.sum())]], int)
            for name, ns in n_settings.items():
                if name == "vsd" and (
                    depth_test is None or self.assets is None
                ):
                    continue
                self._tallies.setdefault(name, []).append(
                    np.repeat(zero, ns, axis=0)
                )
            return

        # all same-object (est, gt) pairs
        pi, gi = np.meshgrid(np.arange(n_est), np.arange(n_gt), indexing="ij")
        pi, gi = pi.ravel(), gi.ravel()
        same = pred_obj_ids[pi] == gt_obj_ids[gi]
        pairs_p, pairs_g = pi[same], gi[same]

        err_ms = {
            "mssd": np.full((n_est, n_gt), np.inf),
            "mspd": np.full((n_est, n_gt), np.inf),
        }
        err_vsd = np.full((n_est, n_gt, len(VSD_TAUS)), np.inf)
        if len(pairs_p):
            # pad the pair axis to a power-of-2 bucket so the jitted error
            # kernels see a handful of shapes across a whole split instead
            # of one per (n_est, n_gt) combination
            n_pairs = len(pairs_p)
            Nb = _pair_bucket(n_pairs)
            ids_pad = _pad_pairs(gt_obj_ids[pairs_g], Nb)
            pred_pad = _pad_pairs(np.asarray(TCO_pred)[pairs_p], Nb)
            gt_pad = _pad_pairs(np.asarray(TCO_gt)[pairs_g], Nb)
            inst = self.meshes.select(jnp.asarray(ids_pad, jnp.int32))
            Kb = np.broadcast_to(K, (Nb, 3, 3))
            out = jax.device_get(
                mssd_mspd_batch(
                    jnp.asarray(pred_pad, jnp.float32),
                    jnp.asarray(gt_pad, jnp.float32),
                    jnp.asarray(Kb, jnp.float32),
                    inst.points,
                    inst.points_mask,
                    inst.symmetries,
                    inst.symmetries_mask,
                )
            )
            err_ms["mssd"][pairs_p, pairs_g] = out["mssd"][:n_pairs]
            err_ms["mspd"][pairs_p, pairs_g] = out["mspd"][:n_pairs]
            if depth_test is not None and self.assets is not None:
                e = vsd_batch(
                    pred_pad,
                    gt_pad,
                    ids_pad,
                    Kb,
                    np.broadcast_to(depth_test, (Nb,) + depth_test.shape),
                    self.assets,
                    diam[ids_pad],
                    resolution=self.vsd_resolution,
                )
                err_vsd[pairs_p, pairs_g] = e[:n_pairs]

        gt_diam = diam[gt_obj_ids][None, :]  # [1, n_gt]
        r = im_width / 640.0
        scores = np.asarray(pred_scores, np.float32)

        tallies_ms = {
            "mssd": np.asarray(
                [
                    _match_recall(
                        err_ms["mssd"], scores, gt_valid,
                        np.broadcast_to(th * gt_diam, (n_est, n_gt)),
                    )
                    for th in CORRECTNESS_THS
                ]
            ),
            "mspd": np.asarray(
                [
                    _match_recall(
                        err_ms["mspd"], scores, gt_valid,
                        np.full((n_est, n_gt), th * r),
                    )
                    for th in MSPD_THS
                ]
            ),
        }
        for name, t in tallies_ms.items():
            self._tallies.setdefault(name, []).append(t)

        if depth_test is not None and self.assets is not None:
            t = np.asarray(
                [
                    _match_recall(
                        err_vsd[:, :, ti], scores, gt_valid,
                        np.full((n_est, n_gt), th),
                    )
                    for ti in range(len(VSD_TAUS))
                    for th in CORRECTNESS_THS
                ]
            )
            self._tallies.setdefault("vsd", []).append(t)

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        ars = []
        for name in ("vsd", "mssd", "mspd"):
            if name not in self._tallies:
                continue
            t = np.concatenate(self._tallies[name], axis=0)
            n_matched, n_valid = t[:, 0].sum(), t[:, 1].sum()
            ar = float(n_matched / max(n_valid, 1))
            out[f"AR_{name.upper()}"] = ar
            ars.append(ar)
        out["bop19_AR"] = float(np.mean(ars)) if ars else float("nan")
        return out
