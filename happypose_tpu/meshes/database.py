"""Padded mesh database — fixed-shape tensors for jit/pjit.

Parity target: /root/reference/happypose/toolbox/lib3d/rigid_mesh_database.py
(`MeshDataBase` :52, `BatchedMeshes` :133, padding :172-200). Design delta
(SURVEY.md §7): labels become int32 ids everywhere; ragged meshes are padded
to fixed [n_obj, P, 3] / [n_obj, S, 4, 4] / [n_obj, F, 3] tensors with
validity masks, so per-label lookups are plain gathers that can live inside a
jitted computation and the whole database can be device_put / sharded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from happypose_tpu.meshes.io import Mesh


def _resize_texture(tex: np.ndarray, size: int) -> np.ndarray:
    """Resample a [TH, TW, 3] float texture to [size, size, 3] (bilinear)."""
    th, tw = tex.shape[:2]
    if (th, tw) == (size, size):
        return tex.astype(np.float32)
    try:
        from PIL import Image

        img = Image.fromarray(
            np.clip(tex * 255.0, 0, 255).astype(np.uint8)
        ).resize((size, size), Image.BILINEAR)
        return np.asarray(img, np.float32) / 255.0
    except Exception:
        # nearest-neighbor numpy fallback
        yi = (np.linspace(0, th - 1, size)).astype(np.int64)
        xi = (np.linspace(0, tw - 1, size)).astype(np.int64)
        return tex[yi][:, xi].astype(np.float32)


@jax.tree_util.register_pytree_node_class
@dataclass
class BatchedMeshes:
    """Fixed-shape per-object tensors, selectable by object id.

    Attributes:
      points: [n_obj, P, 3] sampled surface/vertex points (autodepth, losses).
      points_mask: [n_obj, P] bool — False on padding rows.
      symmetries: [n_obj, S, 4, 4]; identity-padded.
      symmetries_mask: [n_obj, S] bool.
      diameters: [n_obj].
    """

    points: jax.Array
    points_mask: jax.Array
    symmetries: jax.Array
    symmetries_mask: jax.Array
    diameters: jax.Array

    def tree_flatten(self):
        return (
            (self.points, self.points_mask, self.symmetries, self.symmetries_mask,
             self.diameters),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def n_sym_max(self) -> int:
        return self.symmetries.shape[1]

    def select(self, obj_ids: jax.Array) -> "BatchedMeshes":
        """Gather per-instance mesh data for a batch of object ids."""
        return BatchedMeshes(
            points=self.points[obj_ids],
            points_mask=self.points_mask[obj_ids],
            symmetries=self.symmetries[obj_ids],
            symmetries_mask=self.symmetries_mask[obj_ids],
            diameters=self.diameters[obj_ids],
        )


@jax.tree_util.register_pytree_node_class
@dataclass
class RenderAssets:
    """Padded triangle soup for the on-device rasterizer.

    Attributes:
      vertices: [n_obj, V, 3] float32, zero-padded.
      faces: [n_obj, F, 3] int32 vertex indices, 0-padded.
      faces_mask: [n_obj, F] bool.
      vertex_colors: [n_obj, V, 3] float32 RGB in [0, 1].
      vertex_normals: [n_obj, V, 3] float32.
      vertex_uv: [n_obj, V, 2] float32 in [0, 1] (0 where untextured).
      textures: [n_obj, T, T, 3] float32 RGB in [0, 1] (a common padded
        square size; 1x1 gray for untextured-only databases).
      has_texture: [n_obj] bool — per object, whether the renderer should
        sample `textures` via interpolated UVs instead of vertex colors.
    """

    vertices: jax.Array
    faces: jax.Array
    faces_mask: jax.Array
    vertex_colors: jax.Array
    vertex_normals: jax.Array
    vertex_uv: jax.Array
    textures: jax.Array
    has_texture: jax.Array

    def tree_flatten(self):
        return (
            (self.vertices, self.faces, self.faces_mask, self.vertex_colors,
             self.vertex_normals, self.vertex_uv, self.textures,
             self.has_texture),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def select(self, obj_ids: jax.Array) -> "RenderAssets":
        # NOTE: textures are NOT gathered per instance (that would
        # materialize [B, T, T, 3]); the renderer samples them lazily with
        # the instance's object id.
        return RenderAssets(
            vertices=self.vertices[obj_ids],
            faces=self.faces[obj_ids],
            faces_mask=self.faces_mask[obj_ids],
            vertex_colors=self.vertex_colors[obj_ids],
            vertex_normals=self.vertex_normals[obj_ids],
            vertex_uv=self.vertex_uv[obj_ids],
            textures=self.textures,
            has_texture=self.has_texture[obj_ids],
        )


class MeshDataBase:
    """Host-side registry of meshes + symmetries, keyed by string label,
    compiled into fixed-shape device tensors.

    Unlike the reference (random resampling pad, rigid_mesh_database.py:172),
    padding is deterministic: points are cycled (wrap-around repeat) so
    databases are bit-reproducible across processes — important for multi-host
    consistency without a broadcast.
    """

    def __init__(
        self,
        meshes: Dict[str, Mesh],
        symmetries: Optional[Dict[str, np.ndarray]] = None,
        scales: Optional[Dict[str, float]] = None,
    ):
        self.labels: List[str] = sorted(meshes.keys())
        self.label_to_id: Dict[str, int] = {l: i for i, l in enumerate(self.labels)}
        self.meshes = meshes
        self.symmetries = symmetries or {}
        self.scales = scales or {}

    def id_of(self, label: str) -> int:
        return self.label_to_id[label]

    def ids_of(self, labels: Sequence[str]) -> np.ndarray:
        return np.asarray([self.label_to_id[l] for l in labels], np.int32)

    def batched(
        self,
        n_points: int = 2000,
        n_sym: Optional[int] = None,
        aabb: bool = False,
        seed: int = 0,
    ) -> BatchedMeshes:
        """Build the padded point/symmetry database.

        Args:
          n_points: points per object (sampled from vertices, cycled if fewer).
          n_sym: symmetry slots; default = max over objects (>=1).
          aabb: use the 8 AABB corners instead of sampled points
                (reference's `aabb=True` mode used at inference).
        """
        n_obj = len(self.labels)
        if aabb:
            n_points = 8
        if n_sym is None:
            n_sym = max(
                [s.shape[0] for s in self.symmetries.values()] + [1]
            )

        points = np.zeros((n_obj, n_points, 3), np.float32)
        points_mask = np.zeros((n_obj, n_points), bool)
        syms = np.tile(np.eye(4, dtype=np.float32), (n_obj, n_sym, 1, 1))
        syms_mask = np.zeros((n_obj, n_sym), bool)
        syms_mask[:, 0] = True
        diameters = np.zeros((n_obj,), np.float32)

        del seed  # padding is deterministic (see class docstring)
        for i, label in enumerate(self.labels):
            mesh = self.meshes[label]
            scale = self.scales.get(label, 1.0)
            if aabb:
                pts = mesh.aabb * scale
            else:
                v = mesh.vertices * scale
                if len(v) >= n_points:
                    idx = np.linspace(0, len(v) - 1, n_points).astype(np.int64)
                    pts = v[idx]
                else:
                    reps = int(np.ceil(n_points / max(len(v), 1)))
                    pts = np.tile(v, (reps, 1))[:n_points]
            points[i, : len(pts)] = pts
            points_mask[i, : len(pts)] = True
            diameters[i] = mesh.diameter * scale

            S = self.symmetries.get(label)
            if S is not None and len(S) > 0:
                S = np.asarray(S, np.float32)[:n_sym]
                syms[i, : len(S)] = S
                syms_mask[i, : len(S)] = True

        return BatchedMeshes(
            points=jnp.asarray(points),
            points_mask=jnp.asarray(points_mask),
            symmetries=jnp.asarray(syms),
            symmetries_mask=jnp.asarray(syms_mask),
            diameters=jnp.asarray(diameters),
        )

    def render_assets(
        self,
        n_vertices: Optional[int] = None,
        n_faces: Optional[int] = None,
        texture_size: int = 256,
        bake_textures: bool = False,
    ) -> RenderAssets:
        """Build the padded triangle-soup tensors for the rasterizer.

        Padding faces are degenerate (all indices 0) AND masked, so a
        rasterizer that ignores the mask still can't produce coverage from
        them (zero-area triangles).

        Textured meshes (BOP/GSO `TextureFile` PLYs, OBJ+mtl) get their
        images resampled to a common `texture_size` square and sampled by
        the renderer via perspective-correct UVs (the reference renders
        them through panda3d, panda3d_scene_renderer.py:206-219).
        `bake_textures=True` instead folds textures into per-vertex colors
        at build time (cheaper, lossy — detail limited by vertex density).
        """
        n_obj = len(self.labels)
        if n_vertices is None:
            n_vertices = max(len(self.meshes[l].vertices) for l in self.labels)
        if n_faces is None:
            n_faces = max(len(self.meshes[l].faces) for l in self.labels)

        meshes = {
            l: (self.meshes[l].with_baked_texture() if bake_textures
                else self.meshes[l])
            for l in self.labels
        }
        any_texture = any(
            m.texture is not None and m.vertex_uv is not None
            for m in meshes.values()
        )
        T = texture_size if any_texture else 1

        V = np.zeros((n_obj, n_vertices, 3), np.float32)
        F = np.zeros((n_obj, n_faces, 3), np.int32)
        Fm = np.zeros((n_obj, n_faces), bool)
        C = np.full((n_obj, n_vertices, 3), 0.5, np.float32)
        N = np.zeros((n_obj, n_vertices, 3), np.float32)
        UV = np.zeros((n_obj, n_vertices, 2), np.float32)
        TEX = np.full((n_obj, T, T, 3), 0.5, np.float32)
        HT = np.zeros((n_obj,), bool)

        for i, label in enumerate(self.labels):
            mesh = meshes[label]
            scale = self.scales.get(label, 1.0)
            nv, nf = len(mesh.vertices), len(mesh.faces)
            assert nv <= n_vertices and nf <= n_faces, (
                f"mesh {label} exceeds padding budget ({nv}>{n_vertices} or "
                f"{nf}>{n_faces})"
            )
            V[i, :nv] = mesh.vertices * scale
            F[i, :nf] = mesh.faces
            Fm[i, :nf] = True
            if mesh.vertex_colors is not None:
                C[i, :nv] = mesh.vertex_colors
            N[i, :nv] = mesh.vertex_normals
            if mesh.texture is not None and mesh.vertex_uv is not None:
                # keep raw UVs: tiled (out-of-[0,1]) coordinates wrap at
                # sample time (GL_REPEAT), not clamp
                UV[i, :nv] = mesh.vertex_uv
                TEX[i] = _resize_texture(mesh.texture, T)
                HT[i] = True
                # baked colors double as the fallback for vertex-color-only
                # consumers (visualization, gltf export)
                C[i, :nv] = mesh.sample_texture_at_uv(mesh.vertex_uv)

        return RenderAssets(
            vertices=jnp.asarray(V),
            faces=jnp.asarray(F),
            faces_mask=jnp.asarray(Fm),
            vertex_colors=jnp.asarray(C),
            vertex_normals=jnp.asarray(N),
            vertex_uv=jnp.asarray(UV),
            textures=jnp.asarray(TEX),
            has_texture=jnp.asarray(HT),
        )
