"""Domain-randomized multi-object synthetic scene engine.

Parity target: the reference's pybullet recording scene
(/root/reference/happypose/pose_estimators/cosypose/cosypose/recording/
bop_recording_scene.py:26-271): random object subsets, resting poses via
physics, randomized textures/lights, spherical camera sampling with
border checks. Re-designed without an external physics/GL engine:

- **Resting poses** ("falling" mode, proba_falling): a projected-gravity
  solver — random orientation, object dropped onto the z=0 ground plane
  (translated down to vertex contact), then a position-based 2D
  separation pass resolves inter-object overlap (footprint circles,
  iterative push-apart). Cheap, deterministic, and produces the same
  class of physically-plausible supported poses the reference gets from
  pybullet's settle simulation.
- **Free poses**: uniform SE(3) in a box (the reference's non-falling
  branch).
- **Camera**: spherical sampling around the scene center (rho, theta,
  phi, roll), look-at extrinsics, focal-interval K — the reference's
  `sample_camera` (bop_recording_scene.py:153-178).
- **Domain randomization**: per-scene directional light (direction +
  ambient/diffuse strengths -> the renderer's `lights` rows), procedural
  background textures, optional procedural textures on objects, pixel
  noise.
- **Border check**: frames where any visible instance mask touches the
  image border are rejected and resampled (bop_recording_scene.py:185-205).
- **visib_fract**: occlusion-aware, from solo-vs-composite depth.

Everything host-side is numpy on tiny arrays; all rendering is the
on-device rasterizer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from happypose_tpu.lib3d.so3_grid import quats_to_rotmats


@dataclass
class SceneSynthConfig:
    n_objects_interval: Tuple[int, int] = (2, 4)
    proba_falling: float = 0.5
    # free-pose box (world frame, meters)
    objects_xyz_interval: Tuple[Tuple[float, float, float],
                                Tuple[float, float, float]] = (
        (-0.15, -0.15, 0.0), (0.15, 0.15, 0.15)
    )
    camera_distance_interval: Tuple[float, float] = (0.45, 0.9)
    theta_interval: Tuple[float, float] = (0.15, np.pi / 2 * 0.9)
    roll_deg: float = 10.0
    # focal length at a 320px-wide image; scaled by W/320 at sampling so
    # the field of view is resolution-invariant
    focal_interval: Tuple[float, float] = (480.0, 560.0)
    resolution: Tuple[int, int] = (240, 320)
    border_check: bool = True
    domain_randomization: bool = True
    ambient_interval: Tuple[float, float] = (0.3, 0.9)
    diffuse_interval: Tuple[float, float] = (0.3, 0.9)
    max_camera_tries: int = 8
    separation_iters: int = 24
    # material / sensor domain randomization (round-3 realism: specular
    # highlights, depth-of-field blur, sensor noise — the knobs the
    # reference gets for free from BlenderProc PBR materials and that
    # matter for sim-to-real rotation learning)
    specular_interval: Tuple[float, float] = (0.0, 0.45)
    shininess_interval: Tuple[float, float] = (8.0, 64.0)
    blur_sigma_interval: Tuple[float, float] = (0.0, 1.2)
    noise_std_interval: Tuple[float, float] = (0.003, 0.03)


@dataclass
class SynthScene:
    """One sampled scene: world poses + camera (host numpy)."""

    obj_ids: np.ndarray  # [N] int32 into the mesh database
    TWO: np.ndarray  # [N, 4, 4] world-from-object
    TWC: np.ndarray  # [4, 4] world-from-camera
    K: np.ndarray  # [3, 3]
    light: np.ndarray  # [5] camera-frame light row (dir_xyz, amb, diff)
    # (spec_strength, shininess, blur_sigma, noise_std) — material + sensor
    # randomization consumed by the batched recorder's shading/camera model
    material: np.ndarray = field(
        default_factory=lambda: np.asarray([0.0, 16.0, 0.0, 0.0], np.float32)
    )
    falling: bool = False

    @property
    def TCO(self) -> np.ndarray:
        TCW = np.linalg.inv(self.TWC)
        return (TCW[None] @ self.TWO).astype(np.float32)


def random_rotations_np(rs: np.random.RandomState, n: int) -> np.ndarray:
    q = rs.randn(n, 4).astype(np.float32)
    return quats_to_rotmats(q)


def resting_height(vertices: np.ndarray, R: np.ndarray) -> float:
    """z translation putting the rotated object in contact with z=0."""
    return float(-(vertices @ R.T)[:, 2].min())


def separate_footprints(
    xy: np.ndarray, radii: np.ndarray, iters: int = 24,
    bounds: float = 0.25,
) -> np.ndarray:
    """Position-based 2D circle separation (the collision-resolution half
    of the projected-gravity solver). Deterministic."""
    xy = xy.copy()
    n = len(xy)
    for _ in range(iters):
        moved = False
        for i in range(n):
            for j in range(i + 1, n):
                d = xy[j] - xy[i]
                dist = np.linalg.norm(d)
                min_d = radii[i] + radii[j]
                if dist < min_d:
                    push = (min_d - dist + 1e-4) * 0.5
                    dir_ = d / dist if dist > 1e-9 else np.asarray([1.0, 0.0])
                    xy[i] -= dir_ * push
                    xy[j] += dir_ * push
                    moved = True
        np.clip(xy, -bounds, bounds, out=xy)
        if not moved:
            break
    return xy


def look_at_TWC(
    target: np.ndarray, rho: float, theta: float, phi: float, roll: float
) -> np.ndarray:
    """World-from-camera pose on a sphere around `target`, OpenCV camera
    axes (+z forward, +x right, +y down). Parity: the reference's
    `set_extrinsic_spherical` (simulator Camera)."""
    cam_pos = target + rho * np.asarray(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
         np.cos(theta)]
    )
    z = target - cam_pos
    z = z / np.linalg.norm(z)
    world_up = np.asarray([0.0, 0.0, 1.0])
    x = np.cross(z, world_up)
    nx = np.linalg.norm(x)
    if nx < 1e-6:  # looking straight down
        x = np.asarray([1.0, 0.0, 0.0])
    else:
        x = x / nx
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=-1)  # columns = camera axes in world
    cr, sr = np.cos(roll), np.sin(roll)
    R_roll = np.asarray([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1.0]])
    R = R @ R_roll
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = cam_pos
    return T


class SceneSynthesizer:
    """Samples SynthScenes from a mesh database (host side)."""

    def __init__(self, mesh_db, cfg: SceneSynthConfig = SceneSynthConfig(),
                 seed: int = 0):
        self.db = mesh_db
        self.cfg = cfg
        self.rs = np.random.RandomState(seed)
        self._verts = {
            i: mesh_db.meshes[l].vertices * mesh_db.scales.get(l, 1.0)
            for i, l in enumerate(mesh_db.labels)
        }
        self._diam = np.asarray(
            [mesh_db.meshes[l].diameter * mesh_db.scales.get(l, 1.0)
             for l in mesh_db.labels]
        )

    def sample_camera(self, target: np.ndarray):
        """One spherical camera looking at `target` + sampled intrinsics.
        Multi-view recording calls this repeatedly on the SAME scene — the
        reference's `sample_camera` (bop_recording_scene.py:153-178)."""
        cfg, rs = self.cfg, self.rs
        rho = rs.uniform(*cfg.camera_distance_interval)
        theta = rs.uniform(*cfg.theta_interval)
        phi = rs.uniform(0, 2 * np.pi)
        roll = np.deg2rad(rs.uniform(-cfg.roll_deg, cfg.roll_deg))
        TWC = look_at_TWC(target, rho, theta, phi, roll)
        H, W = cfg.resolution
        f = rs.uniform(*cfg.focal_interval) * (W / 320.0)
        K = np.asarray(
            [[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32
        )
        return TWC, K

    def sample_scene(self) -> SynthScene:
        cfg, rs = self.cfg, self.rs
        n_min, n_max = cfg.n_objects_interval
        n = int(rs.randint(n_min, n_max + 1))
        n = min(n, len(self._verts))
        ids = rs.choice(len(self._verts), size=n, replace=False).astype(
            np.int32
        )
        R = random_rotations_np(rs, n)
        falling = rs.rand() < cfg.proba_falling

        TWO = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        TWO[:, :3, :3] = R
        if falling:
            # projected gravity: drop to plane contact + separate in xy
            radii = 0.5 * self._diam[ids] * 0.75
            xy = rs.uniform(-0.12, 0.12, (n, 2))
            xy = separate_footprints(xy, radii, cfg.separation_iters)
            for k in range(n):
                TWO[k, 0, 3], TWO[k, 1, 3] = xy[k]
                TWO[k, 2, 3] = resting_height(self._verts[int(ids[k])], R[k])
        else:
            lo, hi = np.asarray(cfg.objects_xyz_interval)
            TWO[:, :3, 3] = rs.uniform(lo, hi, (n, 3))

        # camera on a sphere around the objects' centroid
        target = TWO[:, :3, 3].mean(0)
        TWC, K = self.sample_camera(target)

        if cfg.domain_randomization:
            d = rs.randn(3)
            d[2] = -abs(d[2])  # light from the camera hemisphere
            d = d / np.linalg.norm(d)
            if falling:
                # keep the light above the WORLD horizon: a light under the
                # ground plane would put the whole resting scene in the
                # floor's shadow (ambient-only frames carry no shading
                # signal). Flip the world-z component upward if needed.
                d_w = TWC[:3, :3] @ d
                if d_w[2] < 0.15:
                    d_w[2] = abs(d_w[2]) + 0.15
                    d_w = d_w / np.linalg.norm(d_w)
                    d = TWC[:3, :3].T @ d_w
            light = np.asarray(
                [*d, rs.uniform(*cfg.ambient_interval),
                 rs.uniform(*cfg.diffuse_interval)], np.float32
            )
        else:
            light = np.asarray([0, 0, -1, 0.6, 0.6], np.float32)
        if cfg.domain_randomization:
            material = np.asarray(
                [rs.uniform(*cfg.specular_interval),
                 rs.uniform(*cfg.shininess_interval),
                 rs.uniform(*cfg.blur_sigma_interval),
                 rs.uniform(*cfg.noise_std_interval)], np.float32
            )
        else:
            material = np.asarray([0.0, 16.0, 0.0, 0.0], np.float32)
        return SynthScene(obj_ids=ids, TWO=TWO, TWC=TWC, K=K, light=light,
                          material=material, falling=falling)

    def background(self) -> np.ndarray:
        """Procedural randomized background [H, W, 3] (the reference
        pastes random ShapeNet textures; we synthesize one)."""
        from happypose_tpu.meshes.io import make_procedural_texture

        H, W = self.cfg.resolution
        tex = make_procedural_texture(
            max(H, W), seed=int(self.rs.randint(2**31))
        )
        # random crop to aspect + random channel-wise gain
        tex = tex[:H, :W]
        gain = self.rs.uniform(0.3, 1.0, (1, 1, 3)).astype(np.float32)
        return np.clip(tex * gain, 0.0, 1.0)
