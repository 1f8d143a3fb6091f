"""The port's data pipeline against the JAX package's, on the CPU: dataset
indexers (paths, starts, endpoint conditions) on BAIR, landscape, DTDB and
iPER trees; the registry's dispatch and its in-place config mutation; loader
batches bitwise equal (shuffled or not, ragged tail, with and without a
framestore); a framestore built by either package read bitwise by the other,
through the native library and the numpy path; the eval augmentation at
1e-5 (fp32 resize arithmetic in two frameworks) upsampling and downsampling;
the train branch's raise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import image2video_synthesis_using_cinns_tpu.data.datasets as JD
import image2video_synthesis_using_cinns_tpu_torch.data.datasets as TD
from image2video_synthesis_using_cinns_tpu import config as jcfg
from image2video_synthesis_using_cinns_tpu.data import registry as jreg
from image2video_synthesis_using_cinns_tpu.data.augment import build_augment as jaugment
from image2video_synthesis_using_cinns_tpu.data.framestore import FrameStore as JStore
from image2video_synthesis_using_cinns_tpu.data.framestore import dataset_fingerprint as jfingerprint
from image2video_synthesis_using_cinns_tpu.data.loader import Loader as JLoader
from image2video_synthesis_using_cinns_tpu.testing import PRESETS, make_bair_data_dir, stage1_config
from image2video_synthesis_using_cinns_tpu_torch import config as tcfg
from image2video_synthesis_using_cinns_tpu_torch.data import framestore as tfs
from image2video_synthesis_using_cinns_tpu_torch.data import registry as treg
from image2video_synthesis_using_cinns_tpu_torch.data.augment import build_augment as taugment
from image2video_synthesis_using_cinns_tpu_torch.data.loader import Loader as TLoader


@pytest.fixture(scope="module")
def bair_dir(tmp_path_factory):
    return make_bair_data_dir(str(tmp_path_factory.mktemp("bair")) + "/", n_videos=5, img=32)


def _opt(path, seq=9):
    opt = stage1_config(PRESETS["tiny"])
    opt.Data["data_path"] = path
    opt.Data["sequence_length"] = seq
    return opt


def _samples(ds, n_seeds=3):
    out = []
    for seed in range(n_seeds):
        for i in range(len(ds)):
            s = ds.sample(i, np.random.default_rng((seed, i)))
            out.append({k: (v.tolist() if isinstance(v, np.ndarray) else v)
                        for k, v in s.items()})
    return out


def _same_index(jds, tds):
    assert len(jds) == len(tds)
    assert list(map(str, jds.videos)) == list(map(str, tds.videos))
    assert list(jds.num_frames) == list(tds.num_frames)
    assert [jds.video_of(i) for i in range(len(jds))] == [tds.video_of(i) for i in range(len(tds))]
    assert _samples(jds) == _samples(tds)


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("endpoint", [False, True])
def test_bair_indexers_match_jax(bair_dir, mode, endpoint):
    jcls = JD.BairEndpointDataset if endpoint else JD.BairDataset
    tcls = TD.BairEndpointDataset if endpoint else TD.BairDataset
    jds, tds = jcls(_opt(bair_dir), mode), tcls(_opt(bair_dir), mode)
    _same_index(jds, tds)
    if endpoint:
        np.testing.assert_array_equal(jds.positions, tds.positions)
        assert tds.sample(2, np.random.default_rng(0))["cond"].dtype == np.float32


def _split_dirs(monkeypatch, tmp_path, files: dict):
    """Point both packages' split directory at a temporary one holding ``files``."""
    for rel, text in files.items():
        p = tmp_path / "splits" / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    monkeypatch.setattr(JD, "_SPLIT_DIR", str(tmp_path / "splits"))
    monkeypatch.setattr(TD, "_SPLIT_DIR", str(tmp_path / "splits"))


def _frames(d, names, value):
    d.mkdir(parents=True, exist_ok=True)
    for k, name in enumerate(names):
        Image.new("RGB", (16, 16), (value, k, 0)).save(d / name)


def test_landscape_dtdb_iper_indexers_match_jax(tmp_path, monkeypatch):
    _split_dirs(monkeypatch, tmp_path, {
        "landscape/train.txt": "vid_a vid_b", "landscape/test.txt": "vid_c",
        "iPER/train.txt": "001/1/1 001/1/2 002/1/3", "iPER/val.txt": "001/1/2",
        "iPER/test.txt": "001/1/1 002/1/3",
    })
    land = tmp_path / "land"
    for prefix, vids in (("sky_train", ("vid_a", "vid_b")), ("sky_test", ("vid_c",))):
        for v, vid in enumerate(vids):
            _frames(land / prefix / vid, [f"frame{k}.jpg" for k in range(12 + v)], v)
    dtdb = tmp_path / "dtdb"
    for mode in ("train", "eval"):
        for v in range(2):
            _frames(dtdb / "fire" / mode / f"v{v}", [f"frame{k}.png" for k in range(8 + v)], v)
    iper = tmp_path / "iper"
    for v, vid in enumerate(("001_1_1", "001_1_2", "002_1_3")):
        _frames(iper / vid, [f"frame_{k}.png" for k in range(10 + 3 * v)], v)

    def cfg(mod, **data):
        return mod.Config({"Data": dict(data, iter_train=2, iter_test=3, iter_val=1)})

    for mode in ("train", "test"):
        _same_index(JD.LandscapeDataset(cfg(jcfg, data_path=str(land) + "/", sequence_length=5), mode),
                    TD.LandscapeDataset(cfg(tcfg, data_path=str(land) + "/", sequence_length=5), mode))
        dt = dict(data_path=str(dtdb) + "/", texture="fire", image_format="png", sequence_length=4)
        _same_index(JD.DTDBDataset(cfg(jcfg, **dt), mode), TD.DTDBDataset(cfg(tcfg, **dt), mode))
    ip = dict(data_path=str(iper) + "/", sequence_length=4)
    for mode in ("train", "val"):
        _same_index(JD.IperDataset(cfg(jcfg, **ip), mode), TD.IperDataset(cfg(tcfg, **ip), mode))
    jev = JD.IperEvaluation(seq_length=4, img_size=16, path=str(iper) + "/")
    tev = TD.IperEvaluation(seq_length=4, img_size=16, path=str(iper) + "/")
    assert len(tev) == 1000 and tev.num_videos == jev.num_videos == 2
    _same_index(jev, tev)


def test_port_keeps_its_own_split_lists():
    assert os.path.dirname(TD._SPLIT_DIR) == os.path.dirname(TD.__file__)
    for rel in ("iPER/train.txt", "iPER/val.txt", "iPER/test.txt", "landscape/train.txt",
                "landscape/eval.txt", "landscape/test.txt"):
        with open(os.path.join(TD._SPLIT_DIR, rel)) as a, open(os.path.join(JD._SPLIT_DIR, rel)) as b:
            assert a.read() == b.read(), rel


def test_registry_dispatch_and_config_mutation(bair_dir):
    for name in ("BAIR", "bair", "iper", "iPER", "landscape", "Landscape", "DTDB", "dtdb"):
        for control in (False, True):
            assert jreg.get_loader(name, control).__name__ == treg.get_loader(name, control).__name__
    for reg in (jreg, treg):
        with pytest.raises(NotImplementedError):
            reg.get_loader("kinetics")
    jopt, topt = _opt(bair_dir), _opt(bair_dir)
    jds = jreg.get_eval_loader("bair", 10, bair_dir, jopt, control=True)
    tds = treg.get_eval_loader("bair", 10, bair_dir, topt, control=True)
    assert topt.Data["sequence_length"] == 10 and topt.Data["data_path"] == bair_dir
    assert topt.Data == jopt.Data  # the same in-place mutation
    assert type(tds).__name__ == "BairEndpointDataset" and tds.deterministic_start
    _same_index(jds, tds)


def _batches(loader, epoch=0):
    return [{k: v.copy() for k, v in b.items()} for b in loader.epoch_iter(epoch)]


@pytest.mark.parametrize("shuffle,drop_last,bs", [(True, True, 2), (False, False, 2),
                                                   (True, False, 3)])
def test_loader_batches_bitwise_equal(bair_dir, shuffle, drop_last, bs):
    """5 clips: batches of 2 or 3 leave a ragged tail, kept when drop_last is off."""
    jds = JD.BairEndpointDataset(_opt(bair_dir), "train")
    tds = TD.BairEndpointDataset(_opt(bair_dir), "train")
    kw = dict(shuffle=shuffle, drop_last=drop_last, workers=3, seed=11)
    for epoch in (0, 2):
        want = _batches(JLoader(jds, bs, **kw), epoch)
        got = _batches(TLoader(tds, bs, **kw), epoch)
        assert len(got) == len(want) == len(TLoader(tds, bs, **kw))
        assert [b["seq_raw"].shape[0] for b in got][-1] == (5 % bs if not drop_last else bs)
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"seq_raw", "cond"}
            assert g["seq_raw"].dtype == np.uint8
            np.testing.assert_array_equal(g["seq_raw"], w["seq_raw"])
            np.testing.assert_array_equal(g["cond"], w["cond"])


def test_loader_raises_a_decode_error(tmp_path):
    root = make_bair_data_dir(str(tmp_path / "d") + "/", n_videos=3, img=16, modes=("test",))
    os.remove(os.path.join(root, "test", "traj_0", "1", "3.png"))
    loader = TLoader(TD.BairDataset(_opt(root), "test"), 2, shuffle=False, workers=2)
    with pytest.raises(FileNotFoundError):
        _batches(loader)


@pytest.mark.parametrize("made_by", ["jax", "port"])
def test_framestore_reads_bitwise_across_packages(bair_dir, tmp_path, made_by):
    """A store built by one package: the same bytes and sidecar as the other's
    build, and windows read bitwise equal by both packages, native and numpy."""
    jds = JD.BairDataset(_opt(bair_dir), "train")
    tds = TD.BairDataset(_opt(bair_dir), "train")
    jpath, tpath = str(tmp_path / "j.fst"), str(tmp_path / "t.fst")
    JStore.build(jds, jpath)
    tfs.FrameStore.build(tds, tpath)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    with open(jpath + ".json") as a, open(tpath + ".json") as b:
        assert a.read() == b.read()
    assert tfs.dataset_fingerprint(tds) == jfingerprint(jds)

    path = jpath if made_by == "jax" else tpath
    vids, starts = [4, 0, 2], [3, 0, 21]
    want = JStore(path, use_native=False).read_batch(vids, starts, 9)
    readers = [tfs.FrameStore(path, use_native=False), JStore(path)]
    if tfs.native_library() is not None:
        readers.append(tfs.FrameStore(path))
        assert readers[-1].backend == "native"
    for r in readers:
        np.testing.assert_array_equal(r.read_batch(vids, starts, 9), want)
        with pytest.raises(IndexError):
            r.read_batch([0], [25], 9)
    assert readers[0].backend == "numpy"
    for r in readers:
        r.close()


def test_loader_through_framestore_equals_decoding(bair_dir, tmp_path):
    tds = TD.BairDataset(_opt(bair_dir), "train")
    store = tfs.open_or_build(tds, str(tmp_path / "s.fst"), "train")
    assert tfs.open_or_build(tds, "off") is None
    plain = _batches(TLoader(tds, 2, drop_last=False, workers=2, seed=3))
    fast = _batches(TLoader(tds, 2, drop_last=False, workers=2, seed=3, framestore=store))
    want = _batches(JLoader(JD.BairDataset(_opt(bair_dir), "train"), 2, drop_last=False,
                            workers=2, seed=3))
    for a, b, w in zip(plain, fast, want):
        np.testing.assert_array_equal(a["seq_raw"], w["seq_raw"])
        np.testing.assert_array_equal(b["seq_raw"], w["seq_raw"])


@pytest.mark.parametrize("src,img_size", [(32, 64), (40, 24), (128, 64), (64, 64)])
def test_eval_augment_matches_jax(src, img_size):
    """uint8 -> [0, 1] -> resize -> [-1, 1]: upsampling, antialiased
    downsampling (a 128 px dataset at 64 px) and the size already right."""
    raw = np.random.default_rng(src).integers(0, 256, (2, 3, src, src, 3), dtype=np.uint8)
    want = np.asarray(jaugment(img_size, None, False, False)(jnp.asarray(raw),
                                                             jax.random.PRNGKey(0)))
    got = taugment(img_size, None, False, False)(torch.from_numpy(raw))
    assert got.shape == want.shape == (2, 3, img_size, img_size, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(taugment(img_size, None, False, False)(raw).numpy(), want,
                               rtol=1e-5, atol=1e-5)  # numpy input too


def test_augment_train_branch_raises():
    """The train branch takes its per-clip draws (drawn from an explicit
    generator): called without them it raises instead of using a global
    stream."""
    raw = np.zeros((2, 3, 8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="explicit generator"):
        taugment(8, {"prob_hflip": 0.5}, False, True)(raw)
