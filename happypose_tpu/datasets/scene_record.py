"""Batched on-device scene recording: render, composite, shade and
annotate B domain-randomized scenes in ONE jitted call.

Rendering frames one at a time (2 device round-trips + a Python
per-instance loop per frame) is too slow for the multi-thousand-frame
datasets the full-stack training chain needs. This module moves the whole
frame pipeline onto the device:

  render all B*N instances -> per-scene z-composite -> shadow-map pass
  (object-on-object + floor shadows from the DR light) -> Blinn-Phong
  specular -> background composite -> depth-of-field blur -> sensor noise
  -> per-instance visibility / bbox / border annotations

Parity target: the reference's synthetic data engines — pybullet
`BopRecordingScene` (cosypose/recording/bop_recording_scene.py:26-271:
DR lights/textures, border check, visib annotations) and the BlenderProc
PBR generator (megapose/scripts/generate_shapenet_pbr.py: shadows,
specular materials, camera effects at 2M-image scale). Re-designed
for the device: shadows are a second rasterizer pass from a light-frame
camera + a depth-compare in the composite (no ray tracing), materials
are per-scene Blinn-Phong parameters, and every annotation (visibility
fraction, bbox, border touch) is a masked segment-reduction computed in
the same jit as the render — host code only samples scene parameters
and writes PNG/JSON.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from happypose_tpu.datasets.scene_synth import (
    SceneSynthConfig,
    SceneSynthesizer,
    SynthScene,
)
from happypose_tpu.meshes.database import MeshDataBase, RenderAssets
from happypose_tpu.ops.renderers import get_renderer

FLOOR_LABEL = "zz_floor"  # sorts last -> object ids of the base db unchanged


class RecordBatch(NamedTuple):
    """Device outputs for B scenes of up to N instances each."""

    rgb: jax.Array  # [B, H, W, 3] uint8 final composite
    depth: jax.Array  # [B, H, W] float32 (0 where empty)
    visib_px: jax.Array  # [M] int32 visible pixels per instance
    solo_px: jax.Array  # [M] int32 unoccluded pixels per instance
    bbox: jax.Array  # [M, 4] float32 (x0, y0, x1, y1) of the visible mask
    any_vis: jax.Array  # [B] bool: >=1 annotated instance visible
    border_bad: jax.Array  # [B] bool: a visible instance touches the border


def _gaussian_blur5(img: jax.Array, sigma: jax.Array) -> jax.Array:
    """Separable 5-tap Gaussian with a per-image traced sigma [B].

    sigma ~ 0 degenerates to identity (w = one-hot at the center tap), so
    the same compiled kernel covers sharp and blurred frames."""
    t = jnp.arange(-2, 3, dtype=jnp.float32)
    s = jnp.maximum(sigma, 1e-3)[:, None]
    w = jnp.exp(-0.5 * (t[None] / s) ** 2)
    w = w / w.sum(-1, keepdims=True)  # [B, 5]

    def pass_(x, axis):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (2, 2)
        xp = jnp.pad(x, pad, mode="edge")
        acc = 0.0
        for k in range(5):
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(k, k + x.shape[axis])
            acc = acc + w[:, k, None, None, None] * xp[tuple(sl)]
        return acc

    return pass_(pass_(img, 1), 2)


@partial(
    jax.jit,
    static_argnames=("n_scenes", "resolution", "renderer", "shadow_size",
                     "enable_shadows"),
)
def record_scene_batch(
    assets: RenderAssets,
    obj_ids: jax.Array,  # [M] instance object ids (M = n_scenes * n_max)
    scene_of: jax.Array,  # [M] owning scene of each instance
    TCO: jax.Array,  # [M, 4, 4] camera-from-object
    K: jax.Array,  # [n_scenes, 3, 3]
    valid: jax.Array,  # [M] instance exists (rendered)
    annotate: jax.Array,  # [M] instance is annotated (floor: False)
    lights: jax.Array,  # [n_scenes, 5] dir_xyz (to light, cam frame)+amb+dif
    T_LC: jax.Array,  # [n_scenes, 4, 4] light-camera-from-camera
    K_L: jax.Array,  # [n_scenes, 3, 3] shadow-map intrinsics
    materials: jax.Array,  # [n_scenes, 4] spec_k, shininess, blur, noise
    bg_pool: jax.Array,  # [P, H, W, 3] uint8 background library (device-res)
    bg_idx: jax.Array,  # [n_scenes] int32
    bg_gain: jax.Array,  # [n_scenes, 3] per-channel background gain
    key: jax.Array,
    n_scenes: int,
    resolution: Tuple[int, int] = (240, 320),
    renderer: Optional[str] = None,
    shadow_size: int = 256,
    enable_shadows: bool = True,
) -> RecordBatch:
    H, W = resolution
    render = get_renderer(renderer)
    inf = jnp.float32(jnp.inf)

    out = render(
        assets, obj_ids, TCO, K[scene_of], resolution=resolution,
        lights=lights[scene_of],
    )

    # ---- per-scene z-composite (segment-min over instances) ----
    z = jnp.where(out.mask & valid[:, None, None], out.depth, inf)  # [M,H,W]
    zmin = jnp.full((n_scenes, H, W), inf).at[scene_of].min(z)
    is_front = (z == zmin[scene_of]) & jnp.isfinite(z)

    def seg(x):
        return jnp.zeros((n_scenes,) + x.shape[1:], x.dtype).at[scene_of].add(
            x * is_front[..., None].astype(x.dtype)
        )

    rgb = seg(out.rgb)
    normals = seg(out.normals)
    mask = jnp.isfinite(zmin)
    depth = jnp.where(mask, zmin, 0.0)

    # ---- per-instance annotations (same jit; no second render pass) ----
    visib = is_front & (valid & annotate)[:, None, None]  # [M, H, W]
    visib_px = visib.sum((1, 2)).astype(jnp.int32)
    solo_px = (out.mask & valid[:, None, None]).sum((1, 2)).astype(jnp.int32)
    jj = jnp.arange(W, dtype=jnp.float32)[None, None, :]
    ii = jnp.arange(H, dtype=jnp.float32)[None, :, None]
    x0 = jnp.where(visib, jj, inf).min((1, 2))
    x1 = jnp.where(visib, jj, -inf).max((1, 2))
    y0 = jnp.where(visib, ii, inf).min((1, 2))
    y1 = jnp.where(visib, ii, -inf).max((1, 2))
    bbox = jnp.stack([x0, y0, x1, y1], -1)
    touches = (visib_px > 0) & (
        (x0 == 0) | (y0 == 0) | (x1 == W - 1) | (y1 == H - 1)
    )
    any_touch = jnp.zeros((n_scenes,), bool).at[scene_of].max(touches)
    any_vis = jnp.zeros((n_scenes,), bool).at[scene_of].max(visib_px > 0)

    # ---- lighting extras on the composite ----
    d = lights[:, :3]
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-8)
    lambert = jnp.maximum(jnp.einsum("bhwc,bc->bhw", normals, d), 0.0)

    # camera-frame position of every composite pixel (backprojection)
    uu = jnp.arange(W, dtype=jnp.float32)[None, None, :]
    vv = jnp.arange(H, dtype=jnp.float32)[None, :, None]
    fx = K[:, 0, 0][:, None, None]
    fy = K[:, 1, 1][:, None, None]
    cx = K[:, 0, 2][:, None, None]
    cy = K[:, 1, 2][:, None, None]
    Xc = jnp.stack(
        [(uu - cx) / fx * depth, (vv - cy) / fy * depth, depth], -1
    )  # [B, H, W, 3]

    lit = jnp.ones((n_scenes, H, W), jnp.float32)
    if enable_shadows:
        S = shadow_size
        T_LO = jnp.einsum("mij,mjk->mik", T_LC[scene_of], TCO)
        shadow = render(
            assets, obj_ids, T_LO, K_L[scene_of], resolution=(S, S)
        )
        zs = jnp.where(
            shadow.mask & valid[:, None, None], shadow.depth, inf
        )
        zmap = jnp.full((n_scenes, S, S), inf).at[scene_of].min(zs)
        # project composite pixels into the light camera; sample points are
        # pushed along the surface normal (slope-scaled) against acne on
        # grazing-lit surfaces
        offset = (0.004 + 0.02 * (1.0 - lambert))[..., None] * normals
        Xl = (
            jnp.einsum("bij,bhwj->bhwi", T_LC[:, :3, :3], Xc + offset)
            + T_LC[:, None, None, :3, 3]
        )
        zl = Xl[..., 2]
        ul = K_L[:, 0, 0][:, None, None] * Xl[..., 0] / jnp.maximum(zl, 1e-3) \
            + K_L[:, 0, 2][:, None, None]
        vl = K_L[:, 1, 1][:, None, None] * Xl[..., 1] / jnp.maximum(zl, 1e-3) \
            + K_L[:, 1, 2][:, None, None]
        iu = jnp.clip(jnp.round(ul).astype(jnp.int32), 0, S - 1)
        iv = jnp.clip(jnp.round(vl).astype(jnp.int32), 0, S - 1)
        inside = (ul >= 0) & (ul <= S - 1) & (vl >= 0) & (vl <= S - 1) \
            & (zl > 0)
        zref = jnp.take_along_axis(
            zmap.reshape(n_scenes, -1),
            (iv * S + iu).reshape(n_scenes, -1),
            axis=1,
        ).reshape(n_scenes, H, W)
        # depth-compare with a scale-relative bias against shadow acne
        occluded = inside & jnp.isfinite(zref) & (zl > zref + 0.008)
        lit = jnp.where(occluded, 0.0, 1.0)

    amb = lights[:, 3][:, None, None]
    dif = lights[:, 4][:, None, None]
    shade_full = jnp.clip(amb + dif * lambert, 0.0, 1.0)
    shade_shadowed = jnp.clip(amb + dif * lambert * lit, 0.0, 1.0)
    rgb = rgb * (shade_shadowed / jnp.maximum(shade_full, 1e-3))[..., None]

    # Blinn-Phong specular highlight (white), killed inside shadows
    vdir = -Xc / jnp.maximum(
        jnp.linalg.norm(Xc, axis=-1, keepdims=True), 1e-6
    )
    h = d[:, None, None, :] + vdir
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-6)
    ndoth = jnp.maximum(jnp.einsum("bhwc,bhwc->bhw", normals, h), 0.0)
    spec_k = materials[:, 0][:, None, None]
    shininess = materials[:, 1][:, None, None]
    # gated by lambert > 0: no highlight on surfaces facing away from the
    # light (the Blinn-Phong lobe is otherwise nonzero on the back side)
    spec = spec_k * lit * ndoth ** shininess * (lambert > 0)
    rgb = rgb + spec[..., None] * mask[..., None]

    # ---- background composite + sensor model ----
    bg = bg_pool[bg_idx].astype(jnp.float32) / 255.0
    bg = jnp.clip(bg * bg_gain[:, None, None, :], 0.0, 1.0)
    rgb = jnp.where(mask[..., None], rgb, bg)
    rgb = _gaussian_blur5(rgb, materials[:, 2])
    rgb = rgb + materials[:, 3][:, None, None, None] * jax.random.normal(
        key, rgb.shape
    )
    rgb_u8 = jnp.clip(jnp.round(rgb * 255.0), 0, 255).astype(jnp.uint8)
    return RecordBatch(
        rgb=rgb_u8, depth=depth, visib_px=visib_px, solo_px=solo_px,
        bbox=bbox, any_vis=any_vis, border_bad=any_touch,
    )


def make_floor_mesh(
    half_size: float = 0.45, n_grid: int = 16, seed: int = 7,
    texture_size: int = 128,
):
    """Textured ground plane (z=0, +z normal) that receives shadows in
    falling scenes — the analog of the reference's `show_plane`
    (bop_recording_scene.py:84-90)."""
    from happypose_tpu.meshes.io import Mesh, make_random_texture

    lin = np.linspace(-half_size, half_size, n_grid + 1, dtype=np.float32)
    xx, yy = np.meshgrid(lin, lin, indexing="ij")
    verts = np.stack([xx, yy, np.zeros_like(xx)], -1).reshape(-1, 3)
    uv = np.stack(
        [(xx + half_size) / (2 * half_size),
         (yy + half_size) / (2 * half_size)], -1
    ).reshape(-1, 2).astype(np.float32)
    faces = []
    for i in range(n_grid):
        for j in range(n_grid):
            a = i * (n_grid + 1) + j
            b = a + 1
            c = a + (n_grid + 1)
            dd = c + 1
            faces += [[a, c, b], [b, c, dd]]
    rs = np.random.RandomState(seed)
    return Mesh(
        vertices=verts,
        faces=np.asarray(faces, np.int32),
        vertex_colors=np.full((len(verts), 3), 0.6, np.float32),
        vertex_uv=uv,
        texture=make_random_texture(rs, texture_size),
    )


def light_camera(
    light_dir: np.ndarray, TCO: np.ndarray, valid: np.ndarray,
    diameters: np.ndarray, shadow_size: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Place a pinhole 'light camera' along the (distant-directional) DR
    light so a rasterized depth pass approximates a directional shadow
    map. Returns (T_LC light-cam-from-camera, K_L)."""
    d = light_dir / max(np.linalg.norm(light_dir), 1e-8)
    t = TCO[valid, :3, 3]
    diam = diameters[valid] if valid.any() else np.asarray([0.1])
    center = t.mean(0) if len(t) else np.zeros(3)
    r = 0.15
    if len(t):
        r = max(
            r, float((np.linalg.norm(t - center, axis=-1) + diam / 2).max())
        )
    rho = 2.5 * r + 0.3
    pos = center + d * rho
    z = -d  # looks back at the scene center
    up = np.zeros(3)
    up[int(np.argmin(np.abs(z)))] = 1.0
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    T_CL = np.eye(4, dtype=np.float32)
    T_CL[:3, :3] = np.stack([x, y, z], -1)
    T_CL[:3, 3] = pos
    T_LC = np.linalg.inv(T_CL).astype(np.float32)
    f = 0.42 * shadow_size * rho / r
    K_L = np.asarray(
        [[f, 0, shadow_size / 2], [0, f, shadow_size / 2], [0, 0, 1]],
        np.float32,
    )
    return T_LC, K_L


@dataclass
class RecordedFrame:
    """Host-side result for one accepted frame."""

    rgb: np.ndarray  # [H, W, 3] uint8
    depth: np.ndarray  # [H, W] float32
    K: np.ndarray
    TWC: np.ndarray
    labels: List[str]
    TCO: np.ndarray  # [n, 4, 4]
    bboxes: np.ndarray  # [n, 4]
    visib_fract: np.ndarray  # [n]


class BatchedSceneRecorder:
    """Records DR frames in device-batches of `batch_scenes`.

    Usage:
        rec = BatchedSceneRecorder(mesh_db, cfg, seed=0)
        frames = rec.record(4096)   # list of RecordedFrame
    """

    def __init__(
        self,
        mesh_db: MeshDataBase,
        cfg: SceneSynthConfig = None,
        seed: int = 0,
        renderer: Optional[str] = None,
        batch_scenes: int = 16,
        floor: bool = True,
        shadows: bool = True,
        shadow_size: int = 256,
        n_backgrounds: int = 64,
        randomize_object_textures: bool = False,
        min_annot_px: int = 4,
    ):
        cfg = cfg or SceneSynthConfig()
        self.db = mesh_db
        self.cfg = cfg
        self.synth = SceneSynthesizer(mesh_db, cfg, seed=seed)
        self.rs = np.random.RandomState(seed + 1)
        self.batch_scenes = batch_scenes
        self.floor = floor
        self.shadows = shadows
        self.shadow_size = shadow_size
        self.min_annot_px = min_annot_px
        self.randomize_object_textures = randomize_object_textures
        self.renderer = renderer
        self.n_max = cfg.n_objects_interval[1] + (1 if floor else 0)

        render_meshes = dict(mesh_db.meshes)
        if floor:
            assert FLOOR_LABEL not in render_meshes
            assert all(l < FLOOR_LABEL for l in mesh_db.labels), (
                "floor label must sort last so base object ids are stable"
            )
            render_meshes[FLOOR_LABEL] = make_floor_mesh(seed=seed + 13)
        self.render_db = MeshDataBase(
            render_meshes, symmetries=mesh_db.symmetries,
            scales=mesh_db.scales,
        )
        self.floor_id = (
            self.render_db.label_to_id[FLOOR_LABEL] if floor else -1
        )
        self.assets = self.render_db.render_assets(texture_size=128)
        self._diam = np.asarray(
            [self.render_db.meshes[l].diameter
             * self.render_db.scales.get(l, 1.0)
             for l in self.render_db.labels], np.float32
        )

        # background library: device-resident once; per-scene index + gain
        from happypose_tpu.meshes.io import make_random_texture

        H, W = cfg.resolution
        pool = np.stack([
            self._square_to_frame(
                make_random_texture(self.rs, max(H, W)), H, W
            )
            for _ in range(n_backgrounds)
        ])
        self.bg_pool = jnp.asarray((pool * 255).astype(np.uint8))

    @staticmethod
    def _square_to_frame(tex: np.ndarray, H: int, W: int) -> np.ndarray:
        return tex[:H, :W]

    def _refresh_object_textures(self):
        """Per-batch object texture randomization (the reference's
        `textures_on_objects`): regenerate the texture atlas rows of real
        objects. Array swap only — no recompilation."""
        from happypose_tpu.meshes.io import make_random_texture

        tex = np.array(self.assets.textures)  # np.asarray of a jax array is read-only
        T = tex.shape[1]
        ht = np.asarray(self.assets.has_texture)
        for i, label in enumerate(self.render_db.labels):
            if label == FLOOR_LABEL or not ht[i]:
                continue
            tex[i] = make_random_texture(self.rs, T)
        import dataclasses

        self.assets = dataclasses.replace(
            self.assets, textures=jnp.asarray(tex)
        )

    def _sample_batch(self, scenes: Optional[List[SynthScene]] = None):
        B, N = self.batch_scenes, self.n_max
        if scenes is None:
            scenes = [self.synth.sample_scene() for _ in range(B)]
        assert len(scenes) == B
        M = B * N
        obj_ids = np.zeros(M, np.int32)
        scene_of = np.repeat(np.arange(B, dtype=np.int32), N)
        TCO = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
        TCO[:, 2, 3] = 10.0  # parked far behind everything
        valid = np.zeros(M, bool)
        annotate = np.zeros(M, bool)
        K = np.zeros((B, 3, 3), np.float32)
        lights = np.zeros((B, 5), np.float32)
        mats = np.zeros((B, 4), np.float32)
        T_LC = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        K_L = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
        for b, sc in enumerate(scenes):
            n = len(sc.obj_ids)
            sl = slice(b * N, b * N + n)
            obj_ids[sl] = sc.obj_ids
            tco = sc.TCO
            TCO[sl] = tco
            valid[sl] = True
            annotate[sl] = True
            if self.floor and sc.falling:
                k = b * N + self.n_max - 1
                obj_ids[k] = self.floor_id
                TCO[k] = np.linalg.inv(sc.TWC)  # floor frame == world frame
                valid[k] = True
            K[b] = sc.K
            lights[b] = sc.light
            mats[b] = sc.material
            # size the shadow map from annotated objects only (the floor
            # extends past the map; uncovered floor pixels just stay lit)
            vb = annotate[b * N: (b + 1) * N]
            T_LC[b], K_L[b] = light_camera(
                sc.light[:3],  # row stores unit dir TOWARD the light
                TCO[b * N: (b + 1) * N], vb,
                self._diam[obj_ids[b * N: (b + 1) * N]], self.shadow_size,
            )
        bg_idx = self.rs.randint(self.bg_pool.shape[0], size=B)
        bg_gain = self.rs.uniform(0.3, 1.0, (B, 3)).astype(np.float32)
        return scenes, dict(
            obj_ids=jnp.asarray(obj_ids), scene_of=jnp.asarray(scene_of),
            TCO=jnp.asarray(TCO), K=jnp.asarray(K),
            valid=jnp.asarray(valid), annotate=jnp.asarray(annotate),
            lights=jnp.asarray(lights), T_LC=jnp.asarray(T_LC),
            K_L=jnp.asarray(K_L), materials=jnp.asarray(mats),
            bg_idx=jnp.asarray(bg_idx.astype(np.int32)),
            bg_gain=jnp.asarray(bg_gain),
        )

    def _render_frames(
        self, scenes: Optional[List[SynthScene]] = None
    ) -> List[Optional[RecordedFrame]]:
        """Render one device batch; returns a frame per input scene/view
        (None where the border check or visibility rejected it)."""
        if self.randomize_object_textures:
            self._refresh_object_textures()
        scenes, dev = self._sample_batch(scenes)
        key = jax.random.PRNGKey(int(self.rs.randint(2**31)))
        out = record_scene_batch(
            self.assets, key=key, n_scenes=self.batch_scenes,
            resolution=self.cfg.resolution, renderer=self.renderer,
            shadow_size=self.shadow_size, enable_shadows=self.shadows,
            bg_pool=self.bg_pool, **dev,
        )
        out = jax.tree_util.tree_map(np.asarray, out)
        N = self.n_max
        frames: List[Optional[RecordedFrame]] = []
        for b, sc in enumerate(scenes):
            ok = out.any_vis[b] and not (
                self.cfg.border_check and out.border_bad[b]
            )
            if not ok:
                frames.append(None)
                continue
            labels, tcos, bbs, vf = [], [], [], []
            for j in range(len(sc.obj_ids)):
                m = b * N + j
                if out.visib_px[m] < self.min_annot_px:
                    continue
                labels.append(self.db.labels[int(sc.obj_ids[j])])
                tcos.append(sc.TCO[j])
                bbs.append(out.bbox[m])
                vf.append(out.visib_px[m] / max(int(out.solo_px[m]), 1))
            if not labels:
                frames.append(None)
                continue
            frames.append(RecordedFrame(
                rgb=out.rgb[b], depth=out.depth[b], K=sc.K, TWC=sc.TWC,
                labels=labels, TCO=np.stack(tcos),
                bboxes=np.asarray(bbs, np.float32),
                visib_fract=np.asarray(vf, np.float32),
            ))
        return frames

    def record(self, n_frames: int, max_batches: Optional[int] = None,
               progress_every: int = 0) -> List[RecordedFrame]:
        frames: List[RecordedFrame] = []
        n_batches = 0
        limit = max_batches or (n_frames // self.batch_scenes + 1) * 20
        while len(frames) < n_frames and n_batches < limit:
            got = [f for f in self._render_frames() if f is not None]
            frames.extend(got[: n_frames - len(frames)])
            n_batches += 1
            if progress_every and n_batches % progress_every == 0:
                from happypose_tpu.utils.logging import get_logger

                get_logger(__name__).info(
                    f"recorded {len(frames)}/{n_frames} frames "
                    f"({n_batches} batches)"
                )
        return frames

    def record_multiview(
        self, n_scenes: int, n_views: int, min_views: int = 2,
        max_rounds: Optional[int] = None,
    ) -> List[List[RecordedFrame]]:
        """Record multi-view scenes: one world layout, `n_views` cameras.

        The light is held fixed in the WORLD frame across views (each
        view row gets the direction rotated into its camera frame), so
        shading is multi-view consistent — the setting of the reference's
        multiview CosyPose eval (MultiViewWrapper groups n_views frames
        of one scene). Returns per-scene lists of >= min_views frames,
        ordered [view0, view1, ...]; TWC of each frame is its camera.
        """
        import dataclasses as _dc

        groups: List[List[RecordedFrame]] = []
        per_batch = max(1, self.batch_scenes // n_views)
        rounds = 0
        limit = max_rounds or (n_scenes // per_batch + 1) * 20
        while len(groups) < n_scenes and rounds < limit:
            rounds += 1
            entries: List[SynthScene] = []
            for _ in range(per_batch):
                sc = self.synth.sample_scene()
                d_world = sc.TWC[:3, :3] @ sc.light[:3]
                entries.append(sc)
                target = sc.TWO[:, :3, 3].mean(0)
                for _v in range(1, n_views):
                    TWC_v, K_v = self.synth.sample_camera(target)
                    light_v = np.concatenate(
                        [TWC_v[:3, :3].T @ d_world, sc.light[3:]]
                    ).astype(np.float32)
                    entries.append(_dc.replace(
                        sc, TWC=TWC_v.astype(np.float32), K=K_v,
                        light=light_v,
                    ))
            pad = self.batch_scenes - len(entries)
            entries_p = entries + [entries[-1]] * pad
            frames = self._render_frames(entries_p)[: len(entries)]
            for s in range(per_batch):
                views = [
                    f for f in frames[s * n_views: (s + 1) * n_views]
                    if f is not None
                ]
                if len(views) >= min_views and len(groups) < n_scenes:
                    groups.append(views)
        return groups
