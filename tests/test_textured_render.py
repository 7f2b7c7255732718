"""Texture-mapped rendering: UV parsing, bilinear sampling, and parity
probes against the reference's shipped fixture.

Covers VERDICT r1 missing #3 (texture support) and next-round task #4
(golden-render parity with the probes of
/root/reference/tests/test_batch_renderer_panda3d.py:105-171).
"""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest

from happypose_tpu.meshes.database import MeshDataBase
from happypose_tpu.meshes.io import Mesh, load_mesh, load_obj
from happypose_tpu.ops.rasterizer import render_batch
from happypose_tpu.ops.rasterizer_triton import render_batch_triton

REF_PLY = Path("/root/reference/tests/data/obj_000001.ply")


def make_textured_quad(half: float = 0.05, n: int = 8) -> Mesh:
    """A z=0 square [-half, half]^2 with uv == normalized position and a
    ramp texture (r = u, g = v, b = 0.25): rendered color is an analytic
    function of the hit point."""
    xs = np.linspace(-half, half, n, dtype=np.float32)
    vv, uu = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([uu.ravel(), vv.ravel(), np.zeros(n * n, np.float32)], -1)
    uv = np.stack(
        [(uu.ravel() / (2 * half) + 0.5), (vv.ravel() / (2 * half) + 0.5)], -1
    ).astype(np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    T = 64
    ty, tx = np.meshgrid(
        np.linspace(0, 1, T, dtype=np.float32),
        np.linspace(0, 1, T, dtype=np.float32),
        indexing="ij",
    )
    # row 0 = top of image = v=1 (the sampler flips v)
    tex = np.stack([tx, 1.0 - ty, np.full_like(tx, 0.25)], -1)
    return Mesh(
        vertices=verts, faces=np.asarray(faces, np.int32),
        vertex_uv=uv, texture=tex,
    )


def _quad_setup():
    db = MeshDataBase(meshes={"quad": make_textured_quad()})
    assets = db.render_assets(texture_size=64)
    H, W = 64, 128
    K = np.tile(np.eye(3, dtype=np.float32), (1, 1, 1))
    K[:, 0, 0] = K[:, 1, 1] = 300.0
    K[:, 0, 2], K[:, 1, 2] = W / 2, H / 2
    TCO = np.tile(np.eye(4, dtype=np.float32), (1, 1, 1))
    TCO[:, 2, 3] = 0.5
    return assets, jnp.asarray(TCO), jnp.asarray(K), (H, W)


@pytest.mark.parametrize("renderer", ["xla", "triton"])
def test_uv_texture_sampling_analytic(renderer):
    """Rendered color must equal the analytic texture function of the hit
    point (ambient-only light -> rgb == sampled albedo)."""
    assets, TCO, K, (H, W) = _quad_setup()
    ids = jnp.zeros((1,), jnp.int32)
    kw = dict(resolution=(H, W), light_ambient=1.0, light_diffuse=0.0)
    if renderer == "xla":
        out = render_batch(assets, ids, TCO, K, **kw)
    else:
        out = render_batch_triton(assets, ids, TCO, K, interpret=True, **kw)
    rgb = np.asarray(out.rgb[0])
    mask = np.asarray(out.mask[0])
    assert mask.sum() > 200
    # expected: u = x/(2*half)+0.5 with x = (px_u - cx) * z / fx
    ii, jj = np.nonzero(mask)
    # stay off the quad border where bilinear support is clipped
    keep = (np.abs(jj - W / 2) < 25) & (np.abs(ii - H / 2) < 25)
    ii, jj = ii[keep], jj[keep]
    x = (jj - W / 2) * 0.5 / 300.0
    y = (ii - H / 2) * 0.5 / 300.0
    exp_u = np.clip(x / 0.1 + 0.5, 0, 1)
    exp_v = np.clip(y / 0.1 + 0.5, 0, 1)
    assert np.abs(rgb[ii, jj, 0] - exp_u).mean() < 0.03
    assert np.abs(rgb[ii, jj, 1] - exp_v).mean() < 0.03
    np.testing.assert_allclose(rgb[ii, jj, 2], 0.25, atol=0.03)


def test_baked_texture_approximates_uv_path():
    """bake_textures=True must approximate the UV path on a dense mesh."""
    db = MeshDataBase(meshes={"quad": make_textured_quad(n=24)})
    a_uv = db.render_assets(texture_size=64)
    a_baked = db.render_assets(texture_size=64, bake_textures=True)
    assert bool(a_uv.has_texture[0]) and not bool(a_baked.has_texture[0])
    H, W = 64, 128
    K = jnp.asarray(
        [[[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1]]], jnp.float32
    )
    TCO = jnp.eye(4)[None].at[:, 2, 3].set(0.5)
    ids = jnp.zeros((1,), jnp.int32)
    kw = dict(resolution=(H, W), light_ambient=1.0, light_diffuse=0.0)
    r_uv = render_batch(a_uv, ids, TCO, K, **kw)
    r_bk = render_batch(a_baked, ids, TCO, K, **kw)
    both = np.asarray(r_uv.mask[0]) & np.asarray(r_bk.mask[0])
    diff = np.abs(np.asarray(r_uv.rgb[0]) - np.asarray(r_bk.rgb[0]))[both]
    assert diff.mean() < 0.05


def test_obj_loader_vt_mtl(tmp_path):
    """OBJ vt/f v/vt + mtllib map_Kd round-trip, with vertex splitting."""
    from PIL import Image

    tex = np.zeros((8, 8, 3), np.uint8)
    tex[:, :4] = (255, 0, 0)  # left half red
    tex[:, 4:] = (0, 0, 255)  # right half blue
    Image.fromarray(tex).save(tmp_path / "t.png")
    (tmp_path / "m.mtl").write_text(
        "newmtl mat\nmap_Kd t.png\n"
    )
    (tmp_path / "q.obj").write_text(
        "mtllib m.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "usemtl mat\n"
        "f 1/1 2/2 3/3 4/4\n"
    )
    m = load_obj(tmp_path / "q.obj")
    assert m.faces.shape == (2, 3)  # fan-triangulated quad
    assert m.vertex_uv is not None and m.texture is not None
    assert m.texture.shape == (8, 8, 3)
    # uv (0.1, 0.5) = left half -> red; (0.9, 0.5) -> blue
    c = m.sample_texture_at_uv(np.asarray([[0.1, 0.5], [0.9, 0.5]], np.float32))
    assert c[0, 0] > 0.9 and c[0, 2] < 0.1
    assert c[1, 2] > 0.9 and c[1, 0] < 0.1


@pytest.mark.skipif(not REF_PLY.is_file(), reason="reference fixture absent")
class TestReferenceFixtureParity:
    """The probe assertions of the reference's renderer golden test
    (test_batch_renderer_panda3d.py:105-171), run against our renderers on
    the same shipped mesh: obj_000001.ply (mm units), pose
    TWO = (quat xyzw (0.5, 0.5, -0.5, 0.5), t (0, 0, 0.3)), camera at
    identity, K = [300, 300, 320, 240] at 640x480 — scaled 1/4 here
    (160x120, K/4) so interpret-mode CPU runtime stays sane; the center
    ray and probe geometry are preserved exactly."""

    def _setup(self):
        mesh = load_mesh(REF_PLY)
        assert mesh.vertex_uv is not None  # texture_u/v parsed
        db = MeshDataBase(meshes={"obj": mesh}, scales={"obj": 0.001})
        assets = db.render_assets()
        # quaternion xyzw (0.5, 0.5, -0.5, 0.5) -> rotation matrix
        from happypose_tpu.lib3d.rotations import quat_to_rotmat

        q = jnp.asarray([[0.5, 0.5, -0.5, 0.5]], jnp.float32)
        R = quat_to_rotmat(q)[0]
        TCO = jnp.eye(4).at[:3, :3].set(R).at[2, 3].set(0.3)
        H, W = 120, 160
        K = jnp.asarray(
            [[75.0, 0, 80.0], [0, 75.0, 60.0], [0, 0, 1.0]], jnp.float32
        )
        # two identical cameras: outputs must match exactly (ref :116-120)
        TCO = jnp.tile(TCO[None], (2, 1, 1))
        K = jnp.tile(K[None], (2, 1, 1))
        return assets, TCO, K, (H, W)

    def test_probes_xla(self):
        self._run(render_batch)

    @pytest.mark.slow  # interpret mode; the kernel stays pinned in the
    # default lane by tests/test_rasterizer_triton.py
    def test_probes_triton(self):
        self._run(
            lambda *a, **k: render_batch_triton(*a, interpret=True, **k)
        )

    def _run(self, render_fn):
        assets, TCO, K, (H, W) = self._setup()
        ids = jnp.zeros((2,), jnp.int32)
        out = render_fn(
            assets, ids, TCO, K, resolution=(H, W),
            light_ambient=1.0, light_diffuse=0.0,  # ref: 3x ambient lights
        )
        rgb = np.asarray(out.rgb)
        depth = np.asarray(out.depth)
        normals = np.asarray(out.normals)
        mask = np.asarray(out.mask)
        # identical cameras -> identical renders (ref :116-120)
        np.testing.assert_array_equal(rgb[0], rgb[1])
        np.testing.assert_array_equal(depth[0], depth[1])
        cy, cx = H // 2, W // 2
        # background probes (ref :166-171)
        np.testing.assert_array_equal(rgb[0, 0, 0], (0, 0, 0))
        assert depth[0, 0, 0] == 0
        np.testing.assert_array_equal(normals[0, 0, 0], (0, 0, 0))
        assert not mask[0, 0, 0]
        # object probes at the image center
        assert mask[0, cy, cx]
        assert (rgb[0, cy, cx] > 0).all()
        assert 0.15 < depth[0, cy, cx] < 0.3  # in front of the anchor z
        assert np.abs(normals[0, cy, cx]).sum() > 0


def test_uv_wrapping_gl_repeat():
    """Tiled UVs (outside [0,1]) wrap like GL_REPEAT instead of clamping
    (code-review finding r5)."""
    m = make_textured_quad()
    a = m.sample_texture_at_uv(np.asarray([[0.25, 0.5], [1.25, 0.5],
                                           [-0.75, 0.5]], np.float32))
    np.testing.assert_allclose(a[1], a[0], atol=1e-5)
    np.testing.assert_allclose(a[2], a[0], atol=1e-5)

    from happypose_tpu.ops.rasterizer import sample_textures_at

    tex = jnp.asarray(m.texture)[None]
    uv = jnp.asarray([[[[0.25, 0.5], [1.25, 0.5], [-0.75, 0.5]]]])
    s = np.asarray(sample_textures_at(tex, jnp.zeros(1, jnp.int32), uv))[0, 0]
    np.testing.assert_allclose(s[1], s[0], atol=1e-5)
    np.testing.assert_allclose(s[2], s[0], atol=1e-5)
