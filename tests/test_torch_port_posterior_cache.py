"""The port's posterior cache (``train/posterior_cache.py``) and the loader's
cache input mode against the JAX package's, on the CPU at the tiny preset
(10 synthetic BAIR clips of 30 frames, windows of 9: 22 starts a clip).

* ``WindowIndex``: offsets, representatives, the entry map and every
  window id equal the JAX table's, on the plain split and on the split
  repeated 3x (the oversampling datasets); an id past the table raises.
* The loader's ``frames_per_item`` and ``with_meta`` modes: batches bitwise
  equal to the JAX ``Loader``'s, decoded and through a ``FrameStore``.
* ``build_cache`` against the JAX ``build_cache`` with the same encoder
  weights (numpy-drawn, carried over by the weight bridge): whole, and each
  of two shards (the rows it does not own exactly zero); the two shards sum
  to the whole cache; the repeated split, read through a FrameStore, gives
  the plain split's cache bitwise, each unique video read once.
  rtol and atol 1e-4, the encoder test's tolerance (a resnet18 of 3-D convs
  and group norms, sums in another order on each side); the port's shards
  and direct forwards against its own whole cache rtol 1e-4, atol 2e-5, the
  JAX package's bound for a change of encoder batch (the CPU's convolutions
  sum in another order at another batch: 1.9e-5 seen).
* ``resample_posterior`` against JAX for the JAX draw's eps: fp32 to 1e-6,
  bf16 to one bf16 rounding step (2**-7 relative).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image2video_synthesis_using_cinns_tpu.data.datasets as JD
import image2video_synthesis_using_cinns_tpu.train.posterior_cache as JPC
import image2video_synthesis_using_cinns_tpu_torch.data.datasets as TD
import image2video_synthesis_using_cinns_tpu_torch.train.posterior_cache as TPC
from image2video_synthesis_using_cinns_tpu import config as jcfg
from image2video_synthesis_using_cinns_tpu.data.augment import build_augment as jaugment
from image2video_synthesis_using_cinns_tpu.data.framestore import FrameStore as JStore
from image2video_synthesis_using_cinns_tpu.data.loader import Loader as JLoader
from image2video_synthesis_using_cinns_tpu.models.stage1.resnet3d import Encoder as JEncoder
from image2video_synthesis_using_cinns_tpu.testing import PRESETS, make_bair_data_dir, stage1_config
from image2video_synthesis_using_cinns_tpu_torch.data.augment import build_augment as taugment
from image2video_synthesis_using_cinns_tpu_torch.data.framestore import FrameStore as TStore
from image2video_synthesis_using_cinns_tpu_torch.data.loader import Loader as TLoader
from image2video_synthesis_using_cinns_tpu_torch.models.stage1.resnet3d import Encoder
from image2video_synthesis_using_cinns_tpu_torch.utils.convert import to_state_dict
from test_torch_port_encoder import _numpy_init
from test_torch_port_stage1_step import two_threads  # noqa: F401
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401

P = PRESETS["tiny"]
T = 9
N_CLIPS = 10
CACHE_TOL = dict(rtol=1e-4, atol=1e-4)
BATCH_TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return make_bair_data_dir(str(tmp_path_factory.mktemp("cache_data")) + "/",
                              n_videos=N_CLIPS, img=P["img_size"], modes=("train",))


def _opt(data_dir):
    return jcfg.Config({"Data": {"data_path": data_dir, "sequence_length": T,
                                 "dataset": "BAIR"}})


def _repeated(ds, times=3):
    rep = copy.copy(ds)
    rep.videos = list(ds.videos) * times
    rep.num_frames = list(ds.num_frames) * times
    return rep


@pytest.fixture(scope="module")
def datasets(data_dir):
    jds, tds = JD.BairDataset(_opt(data_dir), "train"), TD.BairDataset(_opt(data_dir), "train")
    return jds, tds


@pytest.mark.parametrize("times", [1, 3])
def test_window_index_matches_jax(datasets, times):
    jds, tds = datasets
    if times > 1:
        jds, tds = _repeated(jds, times), _repeated(tds, times)
    want, got = JPC.WindowIndex(jds, T), TPC.WindowIndex(tds, T)
    for name in ("rep_entries", "entry_to_uniq", "offsets"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.n_windows == want.n_windows == N_CLIPS * (30 - T + 1)
    assert got.duplication == want.duplication == float(times)
    idx = np.repeat(np.arange(len(tds)), 30 - T + 1)
    starts = np.tile(np.arange(30 - T + 1), len(tds))
    ids = got.ids(tds, idx, starts)
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, want.ids(jds, idx, starts))
    # every repeat lands on the plain split's rows
    np.testing.assert_array_equal(ids.reshape(times, -1), np.tile(ids[: ids.size // times],
                                                                   (times, 1)))


def test_window_ids_out_of_range_raise(datasets):
    _, tds = datasets
    wi = TPC.WindowIndex(tds, T)
    with pytest.raises(IndexError, match="out of range"):
        wi.ids(tds, [len(tds) - 1], [30 - T + 1])
    with pytest.raises(IndexError, match="out of range"):
        wi.ids(tds, [0], [-1])


def _batches(loader, epoch):
    return [{k: v.copy() for k, v in b.items()} for b in loader.epoch_iter(epoch)]


@pytest.mark.parametrize("frames_per_item,with_meta,store", [
    (1, True, False), (1, True, True), (None, True, False), (3, False, True)])
def test_loader_cache_modes_match_jax(datasets, tmp_path, frames_per_item, with_meta, store):
    """Batches of 4 over 10 clips (a ragged tail), epochs 0 and 2; the first
    frame of each item is the full-window load's."""
    jds, tds = datasets
    kw = dict(drop_last=False, workers=2, seed=7, frames_per_item=frames_per_item,
              with_meta=with_meta)
    jkw, tkw = dict(kw), dict(kw)
    if store:
        jkw["framestore"] = JStore.build(jds, str(tmp_path / "j.fst"))
        tkw["framestore"] = TStore.build(tds, str(tmp_path / "t.fst"))
    for epoch in (0, 2):
        want = _batches(JLoader(jds, 4, **jkw), epoch)
        got = _batches(TLoader(tds, 4, **tkw), epoch)
        full = _batches(TLoader(tds, 4, drop_last=False, workers=2, seed=7), epoch)
        assert len(got) == len(want) == len(full) == 3
        for g, w, f in zip(got, want, full):
            keys = {"seq_raw"} | ({"index", "start"} if with_meta else set())
            assert set(g) == set(w) == keys
            assert g["seq_raw"].shape[1] == (frames_per_item or T)
            for k in keys:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            np.testing.assert_array_equal(g["seq_raw"][:, 0], f["seq_raw"][:, 0])
            if with_meta:
                assert g["index"].dtype == np.int64
                assert ((g["start"] >= 0) & (g["start"] <= 30 - T)).all()


@pytest.fixture(scope="module")
def encoders():
    """The tiny stage-1 encoder in both packages, with numpy-drawn weights."""
    jenc = JEncoder.from_config(stage1_config(P).Encoder)
    img = P["img_size"]
    variables = _numpy_init(jenc, jnp.zeros((1, T - 1, img, img, 3)), jax.random.PRNGKey(0),
                            seed=5)
    tenc = Encoder.from_config(stage1_config(P).Encoder)
    tenc.load_state_dict(to_state_dict(variables))
    return jenc, variables, tenc.eval()


@pytest.fixture(scope="module")
def jax_caches(encoders, datasets):
    """The JAX caches: whole (3 videos a dispatch: a ragged tail chunk) and
    two shards."""
    jenc, variables, _ = encoders
    jds, _ = datasets
    aug = jaugment(P["img_size"], {}, False, False)
    reader = JPC.make_clip_reader(jds)
    whole = np.asarray(JPC.build_cache(jenc, variables, jds, T, aug, reader,
                                       videos_per_dispatch=3))
    shards = [np.asarray(JPC.build_cache(jenc, variables, jds, T, aug, reader,
                                         videos_per_dispatch=3, shard=(i, 2)))
              for i in range(2)]
    return whole, shards


def _port_cache(encoder, ds, store=None, **kw):
    aug = taugment(P["img_size"], {}, False, False)
    return TPC.build_cache(encoder, ds, T, aug, TPC.make_clip_reader(ds, store, workers=2),
                           videos_per_dispatch=kw.pop("videos_per_dispatch", 4), **kw)


def test_build_cache_matches_jax(encoders, datasets, jax_caches, tmp_path):
    _, _, tenc = encoders
    _, tds = datasets
    want, want_shards = jax_caches
    got = _port_cache(tenc, tds)
    assert got.dtype == torch.float32 and tuple(got.shape) == (N_CLIPS * (30 - T + 1), 2,
                                                               P["z_dim"])
    np.testing.assert_allclose(got.numpy(), want, **CACHE_TOL)
    shards = [_port_cache(tenc, tds, shard=(i, 2)).numpy() for i in range(2)]
    wi = TPC.WindowIndex(tds, T)
    for i, (g, w) in enumerate(zip(shards, want_shards)):
        owned = np.zeros(wi.n_windows, bool)
        for u in range(i, N_CLIPS, 2):
            owned[wi.offsets[u]:wi.offsets[u + 1]] = True
        assert (g[~owned] == 0).all() and (w[~owned] == 0).all()
        assert (np.abs(g[owned]).sum(axis=(1, 2)) > 0).all()
        np.testing.assert_allclose(g, w, **CACHE_TOL)
    np.testing.assert_allclose(shards[0] + shards[1], got.numpy(), **BATCH_TOL)
    with pytest.raises(ValueError, match="owns no videos"):
        _port_cache(tenc, tds, shard=(N_CLIPS + 1, N_CLIPS + 2))
    # the repeated split, read through a FrameStore's video_map: the same cache
    rep = _repeated(tds)
    store = TStore.build(rep, str(tmp_path / "rep.fst"))
    reads = []
    reader = TPC.make_clip_reader(rep, store)

    def counting(vids, n):
        reads.extend(vids)
        return reader(vids, n)

    aug = taugment(P["img_size"], {}, False, False)
    again = TPC.build_cache(tenc, rep, T, aug, counting, videos_per_dispatch=4)
    np.testing.assert_array_equal(again.numpy(), got.numpy())  # the same batches
    assert sorted(reads) == list(range(N_CLIPS))


def test_build_cache_rows_are_the_encoders_moments(encoders, datasets):
    """Each row against a direct forward of the port's encoder on its
    window (all 22 windows of a clip in one batch)."""
    _, _, tenc = encoders
    _, tds = datasets
    cache = _port_cache(tenc, tds, videos_per_dispatch=3)
    wi = TPC.WindowIndex(tds, T)
    aug = taugment(P["img_size"], {}, False, False)
    for v in (0, N_CLIPS - 1):
        clip = aug(TPC.make_clip_reader(tds)([v], 30))[0]
        wins = torch.stack([clip[s + 1:s + T] for s in range(30 - T + 1)]).permute(0, 4, 1, 2, 3)
        with torch.no_grad():
            mu, logvar = tenc.moments(wins)
        rows = cache[wi.offsets[v]:wi.offsets[v + 1]]
        np.testing.assert_allclose(rows[:, 0].numpy(), mu.numpy(), **BATCH_TOL)
        np.testing.assert_allclose(rows[:, 1].numpy(), logvar.numpy(), **BATCH_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resample_posterior_matches_jax(dtype):
    rng = np.random.default_rng(2)
    mu = rng.standard_normal((6, 16)).astype(np.float32)
    logvar = rng.uniform(-3, 1, (6, 16)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    mp = jnp.bfloat16 if dtype == "bfloat16" else None
    want = np.asarray(JPC.resample_posterior(jnp.asarray(mu), jnp.asarray(logvar), key, mp))
    eps = torch.from_numpy(np.array(jax.random.normal(key, mu.shape)))
    got = TPC.resample_posterior(torch.from_numpy(mu), torch.from_numpy(logvar), eps,
                                 torch.bfloat16 if mp else None)
    assert got.dtype == torch.float32
    tol = 2.0 ** -7 if mp else 1e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    if mp:  # exactly what the port's bf16 encoder computes from the same moments and eps
        enc = (eps.bfloat16() * torch.exp(0.5 * torch.from_numpy(logvar).bfloat16())
               + torch.from_numpy(mu).bfloat16()).float()
        torch.testing.assert_close(got, enc, rtol=0, atol=0)
