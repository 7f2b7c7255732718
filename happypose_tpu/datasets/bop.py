"""BOP-format dataset loaders (host-side numpy/PIL; feeds device pipelines).

Parity targets:
- `BOPObjectDataset` (models dir + models_info.json symmetries):
  /root/reference/happypose/toolbox/datasets/bop_object_datasets.py
- `BOPDataset` scene loader (scene_gt/scene_camera/scene_gt_info json,
  rgb/depth/mask files, frame index):
  /root/reference/happypose/toolbox/datasets/bop_scene_dataset.py:47-371
- `SceneObservation` data model: toolbox/datasets/scene_dataset.py:193

BOP layout (per split):
  <root>/<split>/<scene_id>/rgb/<im_id>.png
  <root>/<split>/<scene_id>/depth/<im_id>.png         (uint16, depth_scale)
  <root>/<split>/<scene_id>/mask_visib/<im>_<i>.png
  <root>/<split>/<scene_id>/scene_gt.json, scene_camera.json,
                             scene_gt_info.json
  models dir: obj_000001.ply ... + models_info.json (mm units)
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

from happypose_tpu.lib3d.symmetries import (
    ContinuousSymmetry,
    DiscreteSymmetry,
    make_symmetries_poses,
)
from happypose_tpu.meshes.database import MeshDataBase
from happypose_tpu.meshes.io import load_mesh


def _load_image(path: Path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))


@dataclass
class SceneObservation:
    """One frame: image, camera, and ground-truth object annotations."""

    rgb: np.ndarray  # [H, W, 3] uint8
    K: np.ndarray  # [3, 3]
    depth: Optional[np.ndarray] = None  # [H, W] float32 meters
    TWC: Optional[np.ndarray] = None  # [4, 4] world-from-camera
    obj_labels: Optional[List[str]] = None
    TWO: Optional[np.ndarray] = None  # [n_obj, 4, 4] object poses in the
    #   CAMERA frame (BOP cam_R_m2c); world alignment lives in TWC. The
    #   name mirrors the reference's ObjectData.TWO field.
    TWO_init: Optional[np.ndarray] = None  # [n_obj, 4, 4] provided initial
    #   estimates (DeepIM-ModelNet refiner-only eval; reference ObjectData
    #   .TWO_init, toolbox/datasets/scene_dataset.py:72)
    bboxes: Optional[np.ndarray] = None  # [n_obj, 4] xyxy
    visib_fract: Optional[np.ndarray] = None  # [n_obj]
    scene_id: int = 0
    view_id: int = 0


class BOPObjectDataset:
    """Loads a BOP `models` directory into a MeshDataBase.

    Labels follow the BOP convention `obj_{id:06d}`; meshes are in mm and
    scaled to meters; symmetries come from models_info.json (discrete 4x4s
    with mm translations + continuous axes)."""

    def __init__(
        self,
        models_dir: Union[str, Path],
        label_format: str = "obj_{:06d}",
        n_symmetries_continuous: int = 8,
        max_faces: int = 0,
    ):
        """max_faces > 0 decimates high-resolution models at load time
        (vertex clustering; UVs/textures preserved) — full-resolution BOP
        models run 50-500k faces, far past the padded-tensor budget the
        on-device rasterizer wants. The reference sidesteps this with
        `_eval`/`_panda3d` downsampled model variants (datasets_cfg.py)."""
        models_dir = Path(models_dir)
        info_path = models_dir / "models_info.json"
        infos = json.loads(info_path.read_text()) if info_path.exists() else {}

        meshes = {}
        symmetries = {}
        self.diameters_mm: Dict[str, float] = {}
        for ply in sorted(models_dir.glob("obj_*.ply")):
            obj_id = int(ply.stem.split("_")[1])
            label = label_format.format(obj_id)
            mesh = load_mesh(ply).scaled(0.001)  # mm -> m
            if max_faces and len(mesh.faces) > max_faces:
                from happypose_tpu.meshes.io import decimate_mesh

                mesh = decimate_mesh(mesh, max_faces)
            meshes[label] = mesh
            info = infos.get(str(obj_id), {})
            disc = [
                DiscreteSymmetry(pose=np.asarray(m, np.float64).reshape(4, 4))
                for m in info.get("symmetries_discrete", [])
            ]
            cont = [
                ContinuousSymmetry(
                    offset=np.asarray(c["offset"], np.float64),
                    axis=np.asarray(c["axis"], np.float64),
                )
                for c in info.get("symmetries_continuous", [])
            ]
            symmetries[label] = make_symmetries_poses(
                disc, cont, n_symmetries_continuous=n_symmetries_continuous,
                units="mm",
            )
            if "diameter" in info:
                self.diameters_mm[label] = float(info["diameter"])

        self.mesh_db = MeshDataBase(meshes=meshes, symmetries=symmetries)
        self.labels = self.mesh_db.labels

    @property
    def is_symmetric(self) -> np.ndarray:
        """[n_obj] bool: has non-identity symmetries (use ADD-S)."""
        out = np.zeros(len(self.labels), bool)
        for i, label in enumerate(self.labels):
            S = self.mesh_db.symmetries.get(label)
            out[i] = S is not None and len(S) > 1
        return out


class BOPSceneDataset:
    """Frame-indexed BOP scene split."""

    def __init__(
        self,
        split_dir: Union[str, Path],
        load_depth: bool = False,
        label_format: str = "obj_{:06d}",
        cache_frames: bool = False,
    ):
        """cache_frames: memoize decoded frames in RAM — training epochs
        over small/medium splits are otherwise PNG-decode-bound (measured
        4x slower than on-device synth at 240 frames). The reference leans
        on torch DataLoader worker processes for the same problem."""
        self.split_dir = Path(split_dir)
        self.load_depth = load_depth
        self.label_format = label_format
        self.cache_frames = cache_frames
        self._frame_cache: Dict[int, SceneObservation] = {}
        self.frames: List[tuple] = []  # (scene_id, view_id)
        self._scene_data: Dict[int, dict] = {}
        for scene_dir in sorted(self.split_dir.iterdir()):
            if not scene_dir.is_dir():
                continue
            try:
                scene_id = int(scene_dir.name)
            except ValueError:
                continue
            cam = json.loads((scene_dir / "scene_camera.json").read_text())
            gt_path = scene_dir / "scene_gt.json"
            gt = json.loads(gt_path.read_text()) if gt_path.exists() else {}
            info_path = scene_dir / "scene_gt_info.json"
            gt_info = (
                json.loads(info_path.read_text()) if info_path.exists() else {}
            )
            self._scene_data[scene_id] = {
                "dir": scene_dir, "camera": cam, "gt": gt, "gt_info": gt_info,
            }
            for im_id in sorted(cam.keys(), key=int):
                self.frames.append((scene_id, int(im_id)))

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, idx: int) -> SceneObservation:
        if self.cache_frames:
            obs = self._frame_cache.get(idx)
            if obs is None:
                obs = self._load_frame(idx)
                self._frame_cache[idx] = obs
            return obs
        return self._load_frame(idx)

    def _load_frame(self, idx: int) -> SceneObservation:
        scene_id, view_id = self.frames[idx]
        sd = self._scene_data[scene_id]
        scene_dir = sd["dir"]
        cam = sd["camera"][str(view_id)]
        K = np.asarray(cam["cam_K"], np.float32).reshape(3, 3)

        rgb_path = scene_dir / "rgb" / f"{view_id:06d}.png"
        if not rgb_path.exists():
            rgb_path = scene_dir / "rgb" / f"{view_id:06d}.jpg"
        rgb = _load_image(rgb_path)
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, axis=-1)
        rgb = rgb[..., :3]

        depth = None
        if self.load_depth:
            depth_path = scene_dir / "depth" / f"{view_id:06d}.png"
            if depth_path.exists():
                depth = _load_image(depth_path).astype(np.float32)
                depth *= float(cam.get("depth_scale", 1.0)) / 1000.0  # -> m

        TWC = np.eye(4, dtype=np.float32)
        if "cam_R_w2c" in cam:
            TCW = np.eye(4, dtype=np.float32)
            TCW[:3, :3] = np.asarray(cam["cam_R_w2c"], np.float32).reshape(3, 3)
            TCW[:3, 3] = np.asarray(cam["cam_t_w2c"], np.float32) / 1000.0
            TWC = np.linalg.inv(TCW)

        labels, TCO_list, bboxes, visib = None, None, None, None
        gt = sd["gt"].get(str(view_id))
        if gt is not None:
            labels, TCO_list, bboxes, visib = [], [], [], []
            infos = sd["gt_info"].get(str(view_id), [{}] * len(gt))
            for obj, info in zip(gt, infos):
                labels.append(self.label_format.format(int(obj["obj_id"])))
                T = np.eye(4, dtype=np.float32)
                T[:3, :3] = np.asarray(obj["cam_R_m2c"], np.float32).reshape(3, 3)
                T[:3, 3] = np.asarray(obj["cam_t_m2c"], np.float32) / 1000.0
                TCO_list.append(T)
                bb = info.get("bbox_visib", [-1, -1, -1, -1])
                # BOP bbox is xywh; convert to xyxy
                bboxes.append(
                    [bb[0], bb[1], bb[0] + bb[2], bb[1] + bb[3]]
                )
                visib.append(float(info.get("visib_fract", 1.0)))
            TCO_list = np.stack(TCO_list)
            bboxes = np.asarray(bboxes, np.float32)
            visib = np.asarray(visib, np.float32)

        return SceneObservation(
            rgb=rgb, K=K, depth=depth, TWC=TWC, obj_labels=labels,
            TWO=TCO_list, bboxes=bboxes, visib_fract=visib,
            scene_id=scene_id, view_id=view_id,
        )


def write_bop_models(models_dir: Union[str, Path], mesh_db) -> None:
    """Write a MeshDataBase as a BOP `models` directory.

    PLYs in millimeters + models_info.json (diameter, symmetries_discrete
    with mm translations) — the inverse of `BOPObjectDataset`, so recorded
    synthetic datasets are self-contained BOP datasets."""
    from happypose_tpu.meshes.io import Mesh, save_ply

    models_dir = Path(models_dir)
    models_dir.mkdir(parents=True, exist_ok=True)
    info = {}
    for label in mesh_db.labels:
        obj_id = int(label.split("_")[-1])
        # textured meshes are written as BOP TextureFile PLYs (+ png next
        # to them) — baking to vertex colors (the pre-round-4 behavior)
        # is lossy at exactly the texture-detail frequencies rotation
        # learning needs, and broke observed-vs-rendered correspondence
        # whenever recording and training resolved textures differently
        mesh = mesh_db.meshes[label]
        scale = mesh_db.scales.get(label, 1.0) * 1000.0
        save_ply(
            models_dir / f"obj_{obj_id:06d}.ply",
            Mesh(
                vertices=mesh.vertices * scale,
                faces=mesh.faces,
                vertex_colors=mesh.vertex_colors,
                vertex_uv=mesh.vertex_uv,
                texture=mesh.texture,
            ),
        )
        entry = {"diameter": float(mesh.diameter * scale)}
        S = mesh_db.symmetries.get(label)
        if S is not None and len(S) > 0:
            discrete = []
            for T in np.asarray(S):
                if np.allclose(T, np.eye(4)):
                    continue
                T = np.asarray(T, np.float64).copy()
                T[:3, 3] *= 1000.0
                discrete.append(T.reshape(-1).tolist())
            if discrete:
                entry["symmetries_discrete"] = discrete
        info[str(obj_id)] = entry
    (models_dir / "models_info.json").write_text(json.dumps(info))


def write_bop_scene(
    out_dir: Union[str, Path],
    scene_id: int,
    frames: List[SceneObservation],
) -> None:
    """Write frames in BOP layout (fixture generation + dataset recording)."""
    from PIL import Image

    scene_dir = Path(out_dir) / f"{scene_id:06d}"
    (scene_dir / "rgb").mkdir(parents=True, exist_ok=True)
    cam, gt, gt_info = {}, {}, {}
    has_depth = any(f.depth is not None for f in frames)
    if has_depth:
        (scene_dir / "depth").mkdir(exist_ok=True)
    for f in frames:
        vid = str(f.view_id)
        Image.fromarray(f.rgb).save(scene_dir / "rgb" / f"{f.view_id:06d}.png")
        cam[vid] = {"cam_K": np.asarray(f.K).reshape(-1).tolist(),
                    "depth_scale": 1.0}
        if f.TWC is not None and not np.allclose(f.TWC, np.eye(4)):
            TCW = np.linalg.inv(f.TWC)
            cam[vid]["cam_R_w2c"] = TCW[:3, :3].reshape(-1).tolist()
            cam[vid]["cam_t_w2c"] = (TCW[:3, 3] * 1000.0).tolist()
        if f.depth is not None:
            d16 = np.clip(f.depth * 1000.0, 0, 65535).astype(np.uint16)
            Image.fromarray(d16).save(scene_dir / "depth" / f"{f.view_id:06d}.png")
        if f.obj_labels is not None:
            gt[vid] = []
            gt_info[vid] = []
            for j, label in enumerate(f.obj_labels):
                obj_id = int(label.split("_")[-1])
                T = f.TWO[j]
                gt[vid].append(
                    {
                        "obj_id": obj_id,
                        "cam_R_m2c": T[:3, :3].reshape(-1).tolist(),
                        "cam_t_m2c": (T[:3, 3] * 1000.0).tolist(),
                    }
                )
                bb = f.bboxes[j]
                gt_info[vid].append(
                    {
                        "bbox_visib": [
                            float(bb[0]), float(bb[1]),
                            float(bb[2] - bb[0]), float(bb[3] - bb[1]),
                        ],
                        "visib_fract": float(
                            f.visib_fract[j] if f.visib_fract is not None else 1.0
                        ),
                    }
                )
    (scene_dir / "scene_camera.json").write_text(json.dumps(cam))
    if gt:
        (scene_dir / "scene_gt.json").write_text(json.dumps(gt))
        (scene_dir / "scene_gt_info.json").write_text(json.dumps(gt_info))
