"""Triton-route visibility kernel against the pure-JAX reference rasterizer.

On the CPU the kernel runs through the Pallas interpreter (`interpret=True`),
the same kernel body that the GPU compiles. Shapes are chosen so that the
face count is not a multiple of the chunk and the resolution is not a
multiple of the tile, so the padding and the masked edge stores run.
The `gpu` test runs the compiled kernel and skips where no GPU is found.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from happypose_tpu.meshes.database import MeshDataBase
from happypose_tpu.meshes.io import (
    make_box_mesh, make_procedural_texture, make_uv_sphere,
)
from happypose_tpu.ops import rasterizer_triton as rt
from happypose_tpu.ops.rasterizer import (
    _FaceData, _face_screen_data, render_batch, zbuffer_reference,
)
from happypose_tpu.ops.rasterizer_triton import render_batch_triton
from happypose_tpu.ops.renderers import get_renderer, platform_renderer

H, W = 60, 100  # neither is a multiple of the 16x32 tile


def _world(textured: bool):
    # 2 * 7 * 9 = 126 sphere faces: not a multiple of the 32-face chunk
    sphere = make_uv_sphere(radius=0.05, n_lat=7, n_lon=9, with_uv=textured)
    if textured:
        sphere.texture = make_procedural_texture(64, seed=3)
    db = MeshDataBase(
        meshes={"sphere": sphere, "box": make_box_mesh((0.04, 0.04, 0.04))}
    )
    assert db.render_assets().faces.shape[1] % rt.CHUNK != 0
    return db, db.render_assets(texture_size=64)


def _cameras(n: int, shift_u: float = 0.0):
    K = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    K[:, 0, 0] = K[:, 1, 1] = 150.0
    K[:, 0, 2] = W / 2 + shift_u
    K[:, 1, 2] = H / 2
    TCO = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    TCO[:, 2, 3] = 0.5
    TCO[1:, 0, 3] = 0.03
    return jnp.asarray(K), jnp.asarray(TCO)


def _check_against_reference(ref, out):
    ref_m = np.asarray(ref.mask)
    out_m = np.asarray(out.mask)
    # coverage may differ on exact-edge pixels; demand > 99% agreement
    agree = (ref_m == out_m).mean()
    assert agree > 0.99, f"mask agreement {agree}"
    both = ref_m & out_m
    # the kernel breaks exact depth ties between faces in its sorted order,
    # the reference in mesh order: demand 95% agreement on overlap pixels
    d_ok = np.abs(np.asarray(out.depth)[both] - np.asarray(ref.depth)[both]) < 1e-3
    assert d_ok.mean() > 0.95, f"depth agreement {d_ok.mean()}"
    rgb_ok = (
        np.abs(np.asarray(out.rgb)[both] - np.asarray(ref.rgb)[both]).max(-1) < 0.02
    )
    assert rgb_ok.mean() > 0.95, f"rgb agreement {rgb_ok.mean()}"
    n_ok = (
        np.abs(np.asarray(out.normals)[both] - np.asarray(ref.normals)[both]).max(-1)
        < 0.05
    )
    assert n_ok.mean() > 0.95, f"normals agreement {n_ok.mean()}"


@pytest.mark.parametrize("textured", [False, True], ids=["colored", "textured"])
def test_triton_kernel_matches_reference(textured):
    db, assets = _world(textured)
    K, TCO = _cameras(2)
    ids = jnp.asarray([db.id_of("sphere"), db.id_of("box")], jnp.int32)
    ref = render_batch(assets, ids, TCO, K, resolution=(H, W))
    out = render_batch_triton(
        assets, ids, TCO, K, resolution=(H, W), interpret=True
    )
    assert np.asarray(out.mask).sum() > 300
    _check_against_reference(ref, out)


def test_triton_kernel_object_in_corner():
    """An object near one corner: most tiles cull every chunk, and the
    covered tile straddles the image edge."""
    db, assets = _world(False)
    K, TCO = _cameras(1, shift_u=-W / 2)  # optical axis at the left edge
    K = K.at[:, 1, 2].set(0.0)  # ... and at the top edge
    ids = jnp.asarray([db.id_of("sphere")], jnp.int32)
    ref = render_batch(assets, ids, TCO, K, resolution=(H, W))
    out = render_batch_triton(
        assets, ids, TCO, K, resolution=(H, W), interpret=True
    )
    mask = np.asarray(out.mask[0])
    assert mask[0, 0] and mask.sum() > 50
    assert not mask[H // 2:, :].any() and not mask[:, W // 2:].any()
    np.testing.assert_array_equal(mask, np.asarray(ref.mask[0]))
    _check_against_reference(ref, out)


def test_triton_kernel_analytic_depth_probe():
    db, assets = _world(False)
    K, TCO = _cameras(2)
    ids = jnp.asarray([db.id_of("sphere")] * 2, jnp.int32)
    out = render_batch_triton(
        assets, ids, TCO, K, resolution=(H, W), interpret=True
    )
    depth = np.asarray(out.depth[0])
    mask = np.asarray(out.mask[0])
    assert mask[H // 2, W // 2]
    # sphere of radius 0.05 at z=0.5: the near pole is at 0.45
    np.testing.assert_allclose(depth[H // 2, W // 2], 0.45, atol=3e-3)
    assert not mask[0, 0] and depth[0, 0] == 0.0


def test_zbuffer_triton_face_ids_match_reference():
    """The kernel's face-id contract: original (unsorted) face indices,
    -1 on background, the reference's winner on nearly every pixel."""
    db, assets = _world(False)
    K, TCO = _cameras(2)
    ids = jnp.asarray([db.id_of("sphere"), db.id_of("box")], jnp.int32)
    inst = assets.select(ids)
    fd, _ = jax.vmap(_face_screen_data)(
        inst.vertices, inst.faces, inst.faces_mask, TCO, K
    )
    ref = np.asarray(zbuffer_reference(fd, (H, W)))
    out = np.asarray(rt.zbuffer_triton(fd, (H, W), interpret=True))
    assert out.shape == (2, H, W) and out.dtype == np.int32
    np.testing.assert_array_equal(out < 0, ref < 0)
    assert (out == ref).mean() > 0.99
    assert out.max() < fd.u.shape[1]


def test_pack_faces_sorted_chunks_bound_their_faces():
    rs = np.random.RandomState(0)
    F = 3 * rt.CHUNK
    u = rs.uniform(0, 200, (F, 3)).astype(np.float32)
    v = rs.uniform(0, 100, (F, 3)).astype(np.float32)
    valid = rs.rand(F) > 0.2
    fd = _FaceData(
        u=jnp.asarray(u), v=jnp.asarray(v),
        inv_z=jnp.full((F, 3), 2.0, jnp.float32), valid=jnp.asarray(valid),
    )
    rec, boxes, perm = rt._pack_faces(fd, n_chunks=3)
    perm = np.asarray(perm)
    assert sorted(perm) == list(range(F))
    assert rec.shape == (F, rt.N_FIELDS)
    # invalid faces sort last and never win (1/z = -1)
    n_valid = int(valid.sum())
    assert valid[perm[:n_valid]].all() and not valid[perm[n_valid:]].any()
    np.testing.assert_array_equal(np.asarray(rec)[n_valid:, 8:13], -1.0)
    # each chunk's box contains the screen box of each valid face in it
    boxes = np.asarray(boxes)
    for j, f in enumerate(perm[:n_valid]):
        c = j // rt.CHUNK
        assert boxes[c, 0] <= u[f].min() and boxes[c, 2] >= u[f].max()
        assert boxes[c, 1] <= v[f].min() and boxes[c, 3] >= v[f].max()


@pytest.mark.parametrize(
    "platform, expected",
    [("cpu", render_batch), ("gpu", render_batch_triton), ("metal", None)],
)
def test_platform_renderer_choice(platform, expected):
    if expected is None:
        with pytest.raises(ValueError, match="no renderer"):
            platform_renderer(platform)
        return
    assert get_renderer(platform_renderer(platform)) is expected


def test_get_renderer_default_is_the_platform_choice():
    assert get_renderer() is get_renderer(platform_renderer())
    assert get_renderer("reference") is render_batch


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; run with JAX_PLATFORMS=cuda")


@pytest.mark.gpu
def test_compiled_kernel_matches_reference_on_gpu(gpu):
    db, assets = _world(True)
    K, TCO = _cameras(2)
    ids = jnp.asarray([db.id_of("sphere"), db.id_of("box")], jnp.int32)
    with jax.default_matmul_precision("highest"):
        ref = render_batch(assets, ids, TCO, K, resolution=(H, W))
    out = render_batch_triton(assets, ids, TCO, K, resolution=(H, W))
    _check_against_reference(ref, out)
