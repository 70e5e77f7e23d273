"""The AE's data path on the CPU against surfd_tpu: the curriculum's state
and samplers, `batched` and `ae_batch_iterator` (with and without
rotations) drawing bit for bit what JAX's draw from the same
`default_rng`, and the ValueError where JAX's iterator would loop for ever;
UDF preprocessing (`prepare_udf_sample` and its parts, `normalize_mesh`,
`preprocess_mesh_file`); OBJ reading; the manifests; the configs and
overrides; the phase timer."""

import dataclasses

import numpy as np
import pytest

from surfd_tpu.data import curriculum as jcur
from surfd_tpu.data import datasets as jdata
from surfd_tpu.data import manifests as jman
from surfd_tpu.data import preprocess as jpre
from surfd_tpu.geometry import marching as jmarching
from surfd_tpu.geometry import mesh_io as jmesh_io
from surfd_tpu.utils import config as jconfig
from surfd_tpu_torch.data import curriculum as tcur
from surfd_tpu_torch.data import datasets as tdata
from surfd_tpu_torch.data import manifests as tman
from surfd_tpu_torch.data import preprocess as tpre
from surfd_tpu_torch.geometry import Mesh, marching_tetrahedra, read_obj, write_obj
from surfd_tpu_torch.utils import config as tconfig

SMALL = dict(num_points_pcd=1000, counts=(500, 400, 50), num_uniform=50)


def _sphere_mesh(r=32, radius=0.6):
    xs = np.linspace(-1, 1, r)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
    return marching_tetrahedra(np.linalg.norm(g, axis=-1) - radius, iso=0.0)


def _jmesh(m):
    return jmarching.Mesh(m.vertices, m.faces)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """train/ with six sphere items of radii 0.3-0.8 (small counts)."""
    root = tmp_path_factory.mktemp("ae_data")
    (root / "train").mkdir()
    cfg = tpre.PreprocessConfig(**SMALL)
    for i in range(6):
        np.savez(root / "train" / f"item_{i}.npz",
                 **tpre.prepare_udf_sample(_sphere_mesh(24, 0.3 + 0.1 * i), cfg))
    return str(root)


# --- curriculum --------------------------------------------------------------

def test_curriculum_state_matches_jax(tmp_path):
    """Sorted unique indices, complement, add_easiest, and the
    training_idxes.txt format, read back by both."""
    t, j = tcur.CurriculumState(10, [7, 3, 3, 5]), jcur.CurriculumState(10, [7, 3, 3, 5])
    assert t.training_idxes == j.training_idxes == [3, 5, 7]
    assert t.complement == j.complement
    losses = [0.5, 0.1, 0.9, 0.3, 0.2, 0.05, 0.7]
    t.add_easiest(t.complement, losses, 3)
    j.add_easiest(j.complement, losses, 3)
    assert t.training_idxes == j.training_idxes
    t.save(str(tmp_path / "t.txt"))
    assert (tmp_path / "t.txt").read_text() == "".join(f"{i}\n" for i in t.training_idxes)
    assert jcur.CurriculumState.load(str(tmp_path / "t.txt"), 10).training_idxes == t.training_idxes
    assert tcur.CurriculumState.load(str(tmp_path / "t.txt"), 10).training_idxes == t.training_idxes
    assert list(tcur.SequenceSamplerComplement(t)) == list(jcur.SequenceSamplerComplement(j))
    assert len(tcur.SequenceSamplerComplement(t)) == len(t.complement)


def test_samplers_draw_equal_to_jax():
    """Three shuffles of the curriculum and the loss-weighted draws, on the
    same default_rng, are equal."""
    t = tcur.SequenceSamplerTrain(tcur.CurriculumState(50, range(0, 50, 3)),
                                  np.random.default_rng(4))
    j = jcur.SequenceSamplerTrain(jcur.CurriculumState(50, range(0, 50, 3)),
                                  np.random.default_rng(4))
    for _ in range(3):
        assert list(t) == list(j)
    assert len(t) == len(j) == 17
    tw, jw = (m.WeightedDynamicSampler(20, np.random.default_rng(2)) for m in (tcur, jcur))
    for w in (tw, jw):
        w.update_weights([1, 5, 7], [3.0, 0.5, 9.0])
    np.testing.assert_array_equal(tw.sample(30), jw.sample(30))


@pytest.mark.parametrize("drop_last", [False, True])
def test_batched_matches_jax(drop_last):
    assert list(tcur.batched(iter(range(11)), 4, drop_last)) == list(
        jcur.batched(iter(range(11)), 4, drop_last))


@pytest.mark.parametrize("rotations", [False, True])
def test_ae_batch_iterator_matches_jax(corpus, rotations):
    """Four batches of 2 over a five-item curriculum (two passes, a short
    tail dropped), each array and the indices bit-equal to JAX's; the
    rotated batches keep the labels and turn the gradients with the queries."""
    tds, jds = tdata.UdfDataset(corpus), jdata.UdfDataset(corpus)
    tr, jr = np.random.default_rng(11), np.random.default_rng(11)
    ts = tcur.SequenceSamplerTrain(tcur.CurriculumState(6, [0, 1, 2, 4, 5]), tr)
    js = jcur.SequenceSamplerTrain(jcur.CurriculumState(6, [0, 1, 2, 4, 5]), jr)
    ti = tdata.ae_batch_iterator(tds, lambda: list(ts), 2, 64, 128, tr,
                                 augment_rotations=rotations)
    ji = jdata.ae_batch_iterator(jds, lambda: list(js), 2, 64, 128, jr,
                                 augment_rotations=rotations)
    for _ in range(4):
        tb, jb = next(ti), next(ji)
        assert set(tb) == set(jb) == {"pcd", "coords", "udf", "gradients", "indices"}
        for k in tb:
            assert tb[k].dtype == jb[k].dtype and np.array_equal(tb[k], jb[k]), k
        assert tb["pcd"].shape == (2, 64, 3) and tb["coords"].shape == (2, 128, 3)
    if rotations:
        np.testing.assert_allclose(np.linalg.norm(tb["gradients"], axis=-1), 1.0, atol=1e-5)


def test_ae_batch_iterator_raises_on_a_curriculum_below_the_batch(corpus):
    """One item and a batch of 2: JAX's iterator would loop without yielding;
    the port's raises, through the prefetch thread too."""
    from surfd_tpu_torch.data import prefetch_iterator

    ds = tdata.UdfDataset(corpus)
    it = tdata.ae_batch_iterator(ds, lambda: [3], 2, 64, 128, np.random.default_rng(0))
    with pytest.raises(ValueError, match="fewer than the batch"):
        next(it)
    it = prefetch_iterator(tdata.ae_batch_iterator(ds, lambda: [3], 2, 64, 128,
                                                   np.random.default_rng(0)))
    with pytest.raises(ValueError, match="fewer than the batch"):
        next(it)


def test_rotation_and_point_sampling_match_jax():
    r = tdata.random_rotation_matrix(np.random.default_rng(3))
    np.testing.assert_array_equal(r, jdata.random_rotation_matrix(np.random.default_rng(3)))
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)
    assert abs(np.linalg.det(r) - 1) < 1e-5
    pts = np.random.default_rng(0).normal(size=(2, 50, 3))
    inds = np.array([4, 9, 9, 0])
    np.testing.assert_array_equal(tdata.random_point_sampling(pts, 4, None, inds), pts[:, inds])
    for n in (10, 80):  # without, then with replacement
        np.testing.assert_array_equal(
            tdata.random_point_sampling(pts, n, np.random.default_rng(1)),
            jdata.random_point_sampling(pts, n, np.random.default_rng(1)))


# --- preprocessing -------------------------------------------------------------

def test_prepare_udf_sample_matches_jax():
    """The sphere of tests/test_data_and_utils.py at its counts: every array
    bit-equal to JAX's (the same draws, the same C++ BVH)."""
    mesh = _sphere_mesh()
    got = tpre.prepare_udf_sample(mesh, tpre.PreprocessConfig(**SMALL))
    want = jpre.prepare_udf_sample(_jmesh(mesh), jpre.PreprocessConfig(**SMALL))
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["labels"].max() <= 0.1 + 1e-6 and got["coords"].shape == (1000, 3)


def test_preprocess_parts_match_jax():
    mesh = _sphere_mesh(24)
    pcd = tpre.sample_points_on_mesh(mesh, 300, np.random.default_rng(0))
    np.testing.assert_array_equal(
        pcd, jpre.sample_points_on_mesh(_jmesh(mesh), 300, np.random.default_rng(0)))
    q = tpre.sample_points_around_pcd(pcd, counts=(50, 40, 10), num_uniform=20)
    np.testing.assert_array_equal(
        q, jpre.sample_points_around_pcd(pcd, counts=(50, 40, 10), num_uniform=20))
    for a, b in zip(tpre.compute_udf_from_mesh(mesh, q, 0.05),
                    jpre.compute_udf_from_mesh(_jmesh(mesh), q, 0.05)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["center", "box_center", "unit"])
def test_normalize_mesh_matches_jax(mode):
    mesh = _sphere_mesh(16)
    moved = Mesh(mesh.vertices * np.float32(1.7) + np.float32([0.3, -0.2, 0.1]), mesh.faces)
    got = tpre.normalize_mesh(moved, mode)
    want = jpre.normalize_mesh(_jmesh(moved), mode)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    assert got.faces is moved.faces
    if mode == "unit":
        assert np.isclose(np.abs(got.vertices).max(), 1.0)
    with pytest.raises(ValueError):
        tpre.normalize_mesh(moved, "bogus")


def test_preprocess_mesh_file_matches_jax(tmp_path):
    write_obj(str(tmp_path / "s.obj"), _sphere_mesh(16, 0.5))
    cfg = SMALL
    got = tpre.preprocess_mesh_file(str(tmp_path / "s.obj"), str(tmp_path / "t.npz"),
                                    tpre.PreprocessConfig(**cfg))
    want = jpre.preprocess_mesh_file(str(tmp_path / "s.obj"), str(tmp_path / "j.npz"),
                                     jpre.PreprocessConfig(**cfg))
    with np.load(tmp_path / "t.npz") as z:
        for k, v in want.items():
            assert np.array_equal(got[k], v) and np.array_equal(z[k], v), k


def test_read_obj_matches_jax_and_round_trips(tmp_path):
    """A written mesh reads back exactly (%.8g keeps every f32); polygons,
    `v/vt/vn` faces and negative indices read as JAX reads them."""
    mesh = _sphere_mesh(12)
    write_obj(str(tmp_path / "m.obj"), mesh)
    back = read_obj(str(tmp_path / "m.obj"))
    np.testing.assert_array_equal(back.vertices, mesh.vertices)
    np.testing.assert_array_equal(back.faces, mesh.faces)
    (tmp_path / "p.obj").write_text(
        "# quad and a triangle\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvn 0 0 1\n"
        "f 1/1/1 2/2/1 3/3/1 4/4/1\nf -1 -2 -4\n")
    got, want = read_obj(str(tmp_path / "p.obj")), jmesh_io.read_obj(str(tmp_path / "p.obj"))
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.faces.tolist() == [[0, 1, 2], [0, 2, 3], [3, 2, 0]]


# --- manifests ---------------------------------------------------------------

def test_build_manifest_matches_jax(tmp_path):
    """generic, deepfashion3d, shapenet (by name and by synset id) and pix3d
    manifests of one temporary tree, equal to JAX's; category_for_id."""
    root, lists = tmp_path / "meshes", tmp_path / "lists"
    for rel in ("a.obj", "sub/b.obj", "03001627/x1/model.obj", "03001627/x2/model.obj",
                "test/chair/c1/model.obj", "test/chair/c2/model.obj", "test/bed/d1/model.obj",
                "test/bed/empty/readme.txt"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text("")
    lists.mkdir()
    (lists / "deepfashion3d_test.txt").write_text("1-1\n2-3\n\n")
    (lists / "03001627_test.lst").write_text("x2\nx1\n")
    cases = [("generic", {}), ("deepfashion3d", {"filelists_dir": str(lists)}),
             ("shapenet", {"category": "chair", "filelists_dir": str(lists)}),
             ("shapenet", {"category": "03001627", "filelists_dir": str(lists)}),
             ("pix3d", {})]
    for dataset, kw in cases:
        got = tman.build_manifest(dataset, str(root), "test", **kw)
        assert got == jman.build_manifest(dataset, str(root), "test", **kw), dataset
        assert got
    assert tman.build_manifest("pix3d", str(root), "train") == []
    with pytest.raises(ValueError):
        tman.build_manifest("shapenet", str(root), "test")
    assert tman.SHAPENET_CAT2ID == jman.SHAPENET_CAT2ID
    id2cat = {"dress": 2, "skirt": 5}
    for fid in ("dress-001", "skirt-7", "coat-1", "dress"):
        assert tman.category_for_id(fid, id2cat) == jman.category_for_id(fid, id2cat)


# --- configs and timers --------------------------------------------------------

def test_configs_round_trip_and_override_as_jax(tmp_path):
    """The same dataclasses with the same defaults; overrides parse as JAX's;
    each side loads the other's JSON."""
    t, j = tconfig.SurfDConfig(), jconfig.SurfDConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    ovs = ["ae.hidden_dim=64", "train.lr=3e-4", "generate.watertight=yes",
           "model.channel_mult=1,2", "diffusion.timestep_respacing=ddim50"]
    tconfig.apply_overrides(t, ovs)
    jconfig.apply_overrides(j, ovs)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.ae.hidden_dim == 64 and t.generate.watertight is True
    tconfig.save_config(t, str(tmp_path / "t.json"))
    jconfig.save_config(j, str(tmp_path / "j.json"))
    assert tconfig.load_config(str(tmp_path / "j.json")) == t
    back = jconfig.load_config(str(tmp_path / "t.json"))
    assert dataclasses.asdict(back) == dataclasses.asdict(t)
