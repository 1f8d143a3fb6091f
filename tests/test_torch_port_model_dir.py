"""``make_model_dir``: the JAX package's ``testing.make_model_dir`` for the
port's test modules, built once per xdist run.

Its four jitted inits take about 50 s of XLA compiles in a process whose
compile cache is cold (about 12 s when it is warm), and a dozen port test
modules need a model directory. Under xdist the first process that asks
builds it, under a file lock, in the run's temp root (beside the workers'
``popen-gw*`` directories, which pytest rotates with it); each caller gets a
copy whose chained paths (``config_stage2.yaml``) name its own directories,
as ``make_model_dir(root)`` writes them. Outside xdist it calls
``make_model_dir``. Its tests use a stand-in builder, so they compile nothing.

    from test_torch_port_model_dir import make_model_dir

The port's own ``testing.make_model_dir`` is held to that fixture here: the
same files, configs and checkpoint layout, and both packages' ``Model``s
serve what it writes alike.
"""

import fcntl
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest

from test_torch_port_stage1_step import two_threads  # noqa: F401
from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401


def make_model_dir(root, preset: str = "tiny", seed: int = 0, control: bool = False) -> str:
    """``testing.make_model_dir(root, preset, seed, control)``: the chained
    stage-1, AE and stage-2 directories under ``root``; returns the stage-2
    one's path."""
    from image2video_synthesis_using_cinns_tpu import testing

    root = str(root)
    worker = next((d for d in Path(root).resolve().parents if d.name.startswith("popen-gw")),
                  None)
    if worker is None:
        return testing.make_model_dir(root, preset=preset, seed=seed, control=control)
    shared = worker.parent / "shared_model_dirs"
    shared.mkdir(exist_ok=True)
    built = shared / f"{preset}_seed{seed}_control{int(control)}"
    with open(f"{built}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released if the holder dies
        if not (built / ".done").exists():
            shutil.rmtree(built, ignore_errors=True)
            testing.make_model_dir(str(built), preset=preset, seed=seed, control=control)
            (built / ".done").touch()
    shutil.copytree(built, root, dirs_exist_ok=True, ignore=shutil.ignore_patterns(".done"))
    for config in Path(root).rglob("*.yaml"):
        text = config.read_text()
        if str(built) in text:
            config.write_text(text.replace(str(built), root))
    return str(Path(root) / "stage2")


def _stand_in(calls: list):
    """A builder that writes ``make_model_dir``'s layout in miniature: a
    checkpoint per stage and a stage-2 config naming the other two."""
    def build(root, preset="tiny", seed=0, control=False):
        calls.append((root, preset, seed, control))
        for d in ("stage1", "AE", "stage2"):
            os.makedirs(os.path.join(root, d), exist_ok=True)
            with open(os.path.join(root, d, "weights.msgpack"), "wb") as f:
                f.write(bytes([seed % 256, int(control)]) * 8)
        with open(os.path.join(root, "stage2", "config_stage2.yaml"), "w") as f:
            f.write(f"First_stage_model: {{model_path: {root}/}}\n"
                    f"Conditioning_Model: {{model_path: {root}/}}\n")
        return os.path.join(root, "stage2")
    return build


def test_xdist_workers_share_one_build_per_arguments(tmp_path, monkeypatch):
    """Two workers' callers: one build for each set of arguments; each copy
    holds the built files, with the chained paths naming its own directory,
    as the builder writes them there."""
    from image2video_synthesis_using_cinns_tpu import testing

    calls = []
    monkeypatch.setattr(testing, "make_model_dir", _stand_in(calls))
    roots = [tmp_path / "popen-gw0" / "a" / "ckpt", tmp_path / "popen-gw1" / "b" / "ckpt",
             tmp_path / "popen-gw1" / "c" / "ckpt"]
    args = [dict(seed=0), dict(seed=0), dict(seed=1234, control=True)]
    got = [make_model_dir(r, **a) for r, a in zip(roots, args)]
    assert got == [str(r / "stage2") for r in roots]
    assert [c[2:] for c in calls] == [(0, False), (1234, True)]
    assert all(Path(c[0]).parent == tmp_path / "shared_model_dirs" for c in calls)
    _stand_in([])(str(tmp_path / "direct"), seed=1234, control=True)
    for name in ("stage1/weights.msgpack", "AE/weights.msgpack", "stage2/weights.msgpack",
                 "stage2/config_stage2.yaml"):
        want = (tmp_path / "direct" / name).read_bytes().replace(
            str(tmp_path / "direct").encode(), str(roots[2]).encode())
        assert (roots[2] / name).read_bytes() == want, name
    assert not (roots[0] / ".done").exists()


def test_outside_xdist_it_builds_in_place(monkeypatch):
    """A root with no ``popen-gw*`` directory above it (pytest's own temp
    directories have one under xdist, so the root is made elsewhere)."""
    from image2video_synthesis_using_cinns_tpu import testing

    calls = []
    monkeypatch.setattr(testing, "make_model_dir", _stand_in(calls))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "ckpt"
        assert make_model_dir(root, seed=3) == str(root / "stage2")
        assert calls == [(str(root), "tiny", 3, False)]
        assert sorted(os.listdir(tmp)) == ["ckpt"]


# -- the port's own make_model_dir against the JAX fixture -----------------------------------------

def _tree(payload) -> dict:
    """{path: (shape, dtype)} of a checkpoint's leaves, and its other keys."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out["/".join(path + (k,))] = (np.shape(v), np.asarray(v).dtype)

    walk(payload["state_dict"], ())
    return out, {k: v for k, v in payload.items() if k != "state_dict"}


def _files(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("control", [False, True], ids=["plain", "control"])
def test_port_make_model_dir_matches_jax(control, tmp_path):
    """The port's ``testing.make_model_dir`` writes the JAX fixture's
    directory: the same files, equal configs (the chained paths naming each
    its own root), and every checkpoint's tree paths, shapes and dtypes."""
    from image2video_synthesis_using_cinns_tpu_torch import config as tcfg
    from image2video_synthesis_using_cinns_tpu_torch import testing as ttesting
    from image2video_synthesis_using_cinns_tpu_torch.utils import checkpoint

    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    make_model_dir(jax_root, "tiny", seed=0, control=control)
    got = ttesting.make_model_dir(str(port_root), "tiny", seed=0, control=control, device="cpu")
    assert got == str(port_root / "stage2")
    assert _files(port_root) == _files(jax_root) == [
        "AE/Encoder_stage2.msgpack", "AE/config_stage2_AE.yaml", "stage1/best_PFVD_ENC.msgpack",
        "stage1/best_PFVD_GEN.msgpack", "stage1/config_stage1.yaml", "stage2/cINN.msgpack",
        "stage2/config_stage2.yaml"]
    for name in _files(port_root):
        if name.endswith(".yaml"):
            want = tcfg.loads((jax_root / name).read_text().replace(str(jax_root), str(port_root)))
            assert tcfg.load(port_root / name).to_dict() == want.to_dict(), name
        else:
            assert (_tree(checkpoint.load(str(port_root / name)))
                    == _tree(checkpoint.load(str(jax_root / name)))), name


def test_both_models_serve_the_port_written_dir(tmp_path):
    """The JAX ``Model`` (plain flow) and the port's (plain flow) on the
    directory the port writes: the same video for one x0 and residual, to
    1e-4 (the bound of ``test_torch_port_model.py``)."""
    from image2video_synthesis_using_cinns_tpu.models.facade import Model as JaxModel
    from image2video_synthesis_using_cinns_tpu_torch import testing as ttesting
    from image2video_synthesis_using_cinns_tpu_torch.models.facade import Model

    d = ttesting.make_model_dir(str(tmp_path), "tiny", seed=5, device="cpu") + "/"
    rng = np.random.default_rng(13)
    x0 = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    residual = rng.standard_normal((2, 16)).astype(np.float32)
    want = np.asarray(JaxModel(d, vid_length=8, use_pallas=False).forward(x0, residual=residual))
    got = Model(d, vid_length=8, use_kernel=False, device="cpu").forward(
        x0, residual=residual).numpy()
    assert got.shape == want.shape == (2, 8, 3, 32, 32)
    assert np.isfinite(got).all() and np.abs(got).max() <= 1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
