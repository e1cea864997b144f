"""The viewer exports (utils/viewer.py, utils/webviewer.py) against the
JAX package's: byte-identical files from the same arrays (cfg_args and
cameras.json, Inria PLYs with and without features_rest, the interactive
HTML, its subsample above max_points included), a PLY read back, and
``evaluation(save_viewer=True)`` on the CPU writing the tree the JAX
package's writes: with zero-initialised heads (the refined scene is the
input exactly, as the JAX build's default) byte for byte in its viewer
folder; with random heads, which move the scene, the input's files byte
for byte and the refined PLY's fields and viewer.html's clouds within the
forward's 1e-5."""
import base64
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from splatformer_tpu.utils import viewer as jax_viewer  # noqa: E402
from splatformer_tpu.utils import webviewer as jax_webviewer  # noqa: E402
from splatformer_tpu_torch.utils import viewer, webviewer  # noqa: E402
from test_torch_diagnostics import jax_scene, pair, port_scene  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (tests/test_torch_checkpoint_metrics.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def read(path):
    with open(path, "rb") as f:
        return f.read()


def tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = read(p)
    return out


def test_prepare_viewer_bytes(tmp_path):
    from splatformer_tpu.data.synthetic import orbit_cameras
    cams = orbit_cameras(3, 40, 48)
    arg = {"camera_to_worlds": np.asarray(cams.c2w),
           "fx": float(cams.fx[0]), "fy": float(cams.fy[0]),
           "width": cams.width, "height": cams.height}
    jax_viewer.prepare_viewer(arg, str(tmp_path / "j"), sh_degree=1)
    viewer.prepare_viewer(arg, str(tmp_path / "t"), sh_degree=1)
    assert tree(tmp_path / "t") == tree(tmp_path / "j")
    assert len(json.loads(read(tmp_path / "t" / "cameras.json"))) == 3


@pytest.mark.parametrize("rest", [3, 0, None])
def test_export_ply_bytes(tmp_path, rest):
    """features_rest of 3 SH coefficients, of none, and absent; then
    read_ply gives the fields back."""
    rng = np.random.default_rng(rest or 5)
    n = 37
    gs = {"means": rng.normal(size=(n, 3)), "scales": rng.normal(size=(n, 3)),
          "quats": rng.normal(size=(n, 4)),
          "opacities": rng.normal(size=(n, 1)),
          "features_dc": rng.normal(size=(n, 3))}
    gs = {k: v.astype(np.float32) for k, v in gs.items()}
    if rest is not None:
        gs["features_rest"] = rng.normal(size=(n, rest, 3)).astype(np.float32)
    jax_viewer.export_ply_for_viewer(gs, str(tmp_path / "j" / "a.ply"))
    viewer.export_ply_for_viewer(gs, str(tmp_path / "t" / "a.ply"))
    assert read(tmp_path / "t" / "a.ply") == read(tmp_path / "j" / "a.ply")
    fields = viewer.read_ply(str(tmp_path / "t" / "a.ply"))
    assert fields.keys() == jax_viewer.read_ply(
        str(tmp_path / "j" / "a.ply")).keys()
    np.testing.assert_array_equal(fields["y"], gs["means"][:, 1])
    np.testing.assert_array_equal(fields["rot_3"], gs["quats"][:, 3])
    assert ("f_rest_0" in fields) == bool(rest)


@pytest.mark.parametrize("n_points,max_points", [(500, 200_000),
                                                 (5_000, 1_000),
                                                 (250_001, 200_000)])
def test_interactive_viewer_bytes(tmp_path, n_points, max_points):
    rng = np.random.default_rng(n_points)
    pts = rng.uniform(-1, 1, (n_points, 3)).astype(np.float32)
    clouds = {"a": (pts, (rng.uniform(0, 1, (n_points, 3)) * 255
                          ).astype(np.uint8)),
              "b": (pts * 2, rng.uniform(-0.2, 1.2, (n_points, 3)))}
    kw = dict(title="t", max_points=max_points, visible=("b",))
    jax_webviewer.export_interactive_viewer(str(tmp_path / "j.html"), clouds,
                                            **kw)
    path = webviewer.export_interactive_viewer(str(tmp_path / "t.html"),
                                               clouds, **kw)
    assert read(path) == read(tmp_path / "j.html")
    js = read(path).decode().split("<script>")[1].split("</script>")[0]
    data = json.loads(re.search(r"const DATA = (\[.*?\]);", js,
                                re.S).group(1))
    got = np.frombuffer(base64.b64decode(data[0]["pos"]), np.float32)
    assert got.size == 3 * min(n_points, max_points)
    assert [d["on"] for d in data] == [False, True]


def viewer_clouds(path):
    """viewer.html's clouds: {name: (positions, uint8 colours)}."""
    js = read(path).decode().split("<script>")[1].split("</script>")[0]
    data = json.loads(re.search(r"const DATA = (\[.*?\]);", js,
                                re.S).group(1))
    return {d["name"]: (
        np.frombuffer(base64.b64decode(d["pos"]), np.float32).reshape(-1, 3),
        np.frombuffer(base64.b64decode(d["col"]), np.uint8).reshape(-1, 3))
        for d in data}


@pytest.mark.parametrize("zeroinit", [True, False])
def test_evaluation_save_viewer_matches_jax(tmp_path, zeroinit):
    from splatformer_tpu.data.synthetic import orbit_cameras as jax_orbit
    from splatformer_tpu.ops.types import RasterizeConfig as JaxConfig
    from splatformer_tpu.parallel.mesh import make_mesh
    from splatformer_tpu.training.loop import evaluation as jax_evaluation
    from splatformer_tpu.training.train_step import SceneBatch as JaxBatch
    from splatformer_tpu_torch.data.synthetic import orbit_cameras
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    from splatformer_tpu_torch.training.loop import evaluation
    from splatformer_tpu_torch.training.train_step import SceneBatch

    raster = dict(max_intersects=2 ** 12, tiles_per_gauss=16)
    jmodel, variables, tmodel = pair(None, zeroinit=zeroinit)
    scene = jax_scene(3)
    images = np.random.default_rng(4).uniform(size=(2, 32, 32, 3)).astype(
        np.float32)
    jbatch = JaxBatch(scene=scene, cameras=jax_orbit(2, 32, 32),
                      images=jnp.asarray(images), background=jnp.zeros(3))
    jax_evaluation(jmodel, variables["params"],
                   variables.get("batch_stats", {}), [("s0", jbatch)],
                   make_mesh(n_devices=1), JaxConfig(**raster),
                   str(tmp_path / "j"), save_viewer=True)
    tbatch = SceneBatch(scene=port_scene(scene),
                        cameras=orbit_cameras(2, 32, 32, device="cpu"),
                        images=torch.from_numpy(images),
                        background=torch.zeros(3))
    evaluation(tmodel, [("s0", tbatch)], RasterizeConfig(**raster),
               str(tmp_path / "t"), save_viewer=True)
    got, want = tree(tmp_path / "t"), tree(tmp_path / "j")
    assert sorted(got) == sorted(want)
    viewer_files = [p for p in want if p.startswith("viewer/")]
    assert len(viewer_files) == 5
    refined_files = ("viewer/s0/point_cloud/iteration_1/point_cloud.ply",
                     "viewer/s0/viewer.html")
    for p in viewer_files:
        if zeroinit or p not in refined_files:
            assert got[p] == want[p], p
    ply, jply = (viewer.read_ply(str(tmp_path / d / refined_files[0]))
                 for d in ("t", "j"))
    x = np.asarray(scene.means)[:, 0]
    if zeroinit:
        np.testing.assert_array_equal(ply["x"], x)
        return
    # the refinement moved the scene, and both packages moved it alike
    assert np.abs(jply["x"] - x).max() > 1e-3
    assert list(ply) == list(jply)
    for k in jply:
        np.testing.assert_allclose(ply[k], jply[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    clouds, jclouds = (viewer_clouds(tmp_path / d / refined_files[1])
                       for d in ("t", "j"))
    assert list(clouds) == list(jclouds) == ["input 3DGS", "refined"]
    for name, (pos, col) in clouds.items():
        np.testing.assert_allclose(pos, jclouds[name][0], rtol=0, atol=1e-5)
        assert np.abs(col.astype(int) - jclouds[name][1]).max() <= 1
