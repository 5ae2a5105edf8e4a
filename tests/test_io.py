"""IO subsystems: OBJ/MTL loader, JSON scenes, PNG/ACES, checkpoint."""

import os

import numpy as np
import pytest

from pathtrace_tpu.io import checkpoint, image
from pathtrace_tpu.models import json_io, obj, procedural


OBJ_TEXT = """
mtllib test.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
usemtl red
f 1//1 2//1 3//1 4//1
"""

MTL_TEXT = """
newmtl red
Kd 0.8 0.1 0.1
Ke 0 0 0
Ks 0.04 0.04 0.04
d 1.0
Ns 10
"""


@pytest.fixture
def obj_file(tmp_path):
    (tmp_path / "test.mtl").write_text(MTL_TEXT)
    p = tmp_path / "test.obj"
    p.write_text(OBJ_TEXT)
    return str(p)


def test_obj_loader(obj_file):
    mesh = obj.load_obj(obj_file)
    assert mesh.faces.shape == (2, 3)  # quad fan-triangulated
    assert "red" in mesh.materials
    pos, normals, uvs, mat = obj.obj_to_arrays(mesh, scale=2.0)
    assert pos.shape == (2, 3, 3)
    assert pos.max() == 2.0  # scale applied
    np.testing.assert_allclose(np.asarray(mat.albedo)[0], [0.8, 0.1, 0.1])
    # Ns=10 -> roughness = sqrt(2/12)
    np.testing.assert_allclose(np.asarray(mat.roughness)[0],
                               np.sqrt(2.0 / 12.0), rtol=1e-5)


def test_obj_smooth_normals(tmp_path):
    # no vn -> smooth normals generated
    p = tmp_path / "t.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    mesh = obj.load_obj(str(p))
    np.testing.assert_allclose(mesh.normals[0, 0], [0, 0, 1], atol=1e-6)


def test_obj_scene_end_to_end(obj_file):
    scene = obj.load_obj_scene(obj_file, build_bvh=False)
    assert scene.num_tris == 2


def test_json_scene(tmp_path):
    import json
    doc = {
        "camera": {"pos": [0, 20, 60], "width": 8, "height": 8},
        "objects": [
            {"type": "cornell_walls"},
            {"type": "box", "center": [0, 5, 0], "half_extents": [3, 5, 3],
             "material": {"albedo": [0.7, 0.7, 0.7]}},
            {"type": "sphere", "center": [5, 5, 5], "radius": 2,
             "material": {"metallic": 1.0, "roughness": 0.2}},
        ],
    }
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(doc))
    scene, camera = json_io.load_scene(str(p), build_accel=False)
    assert scene.num_tris == 14 + 12  # walls+light quads + box
    assert scene.num_spheres == 1
    assert scene.num_lights == 2
    assert camera.width == 8

    # renders without error
    from pathtrace_tpu import render
    from pathtrace_tpu.utils import rng
    img = np.asarray(render(scene, camera, 2, rng.make_key(0)))
    assert np.isfinite(img).all()


def test_aces_and_png(tmp_path):
    img = np.random.default_rng(0).random((8, 8, 3)).astype(np.float32) * 4
    out = np.asarray(image.aces_film(img))
    assert out.min() >= 0 and out.max() <= 1
    # monotonic-ish: brighter in -> brighter out
    assert out[img[..., 0].argmax() // 8, img[..., 0].argmax() % 8, 0] > 0.5
    path = str(tmp_path / "t.png")
    image.write_png(path, img)
    assert os.path.getsize(path) > 100


def _decode_png(data: bytes) -> np.ndarray:
    """Minimal decoder for the writer's own output (8-bit RGB, filter 0)."""
    import struct
    import zlib
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body), tag
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, ctype) == (8, 2) and b"IEND" in chunks
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_png_writer_roundtrip(tmp_path):
    """write_png's bytes decode to exactly the tonemapped uint8 image."""
    img = np.random.default_rng(2).random((5, 7, 3)).astype(np.float32) * 3
    path = tmp_path / "t.png"
    image.write_png(str(path), img)
    got = _decode_png(path.read_bytes())
    want = image.to_uint8(np.asarray(image.aces_film(img)))
    np.testing.assert_array_equal(got, want)
    raw = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    np.testing.assert_array_equal(_decode_png(image.encode_png(raw)), raw)


def test_checkpoint_roundtrip(tmp_path):
    from pathtrace_tpu.models.scene import Material

    accum = np.random.default_rng(1).random((4, 4, 3)).astype(np.float32)
    mat = Material.make(3, albedo=(0.5, 0.4, 0.3))
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, accum, passes_done=2, seed=7,
                          spp_per_pass=16, tri_mat=mat)
    state = checkpoint.load_state(path)
    np.testing.assert_array_equal(state["accum_image"], accum)
    assert state["passes_done"] == 2
    assert state["seed"] == 7
    assert state["spp_per_pass"] == 16
    np.testing.assert_allclose(np.asarray(state["tri_mat"].albedo),
                               np.asarray(mat.albedo))


def test_presets_build_with_production_accel():
    """Every preset builds; large scenes get the KD pair-block structures
    (the production mesh path), small ones MT coefficients."""
    from pathtrace_tpu.models.presets import PRESETS, build_preset_scene

    small = build_preset_scene(PRESETS["diffuse256"], to_device=False)
    assert small.mt is not None
    mesh = build_preset_scene(PRESETS["mesh512"], to_device=False)
    assert mesh.clusters.dup_map is not None
