"""The port's train augmentation against the JAX package's, on the CPU.

The JAX draws are recomputed here from the same keys as
``data/augment.py:94,157`` (one key per clip from ``split(key, B)``, eight
subkeys per clip) and handed to the port's ``apply_augment``; the result is
held against ``build_augment(..., train=True)`` to 1e-5. Two parameter sets:
BAIR's (brightness, contrast and saturation 0.1, no hue, no crop) and a
landscape-like one (random crop after a resize to ``img + 16``, all four
colour ops with hue on). The frames are uniform noise with some gray pixels,
so the HSV round trip meets negative hue differences (the floor-mod) and
zero saturation. Then the port's own draws: their ranges, that each order
is a permutation of the enabled ops, and that they repeat per seed.
"""

import jax
import numpy as np
import pytest
import torch

from image2video_synthesis_using_cinns_tpu import config as jcfg
from image2video_synthesis_using_cinns_tpu.data.augment import build_augment as jbuild
from image2video_synthesis_using_cinns_tpu.data.registry import augment_params as jparams
from image2video_synthesis_using_cinns_tpu_torch import config as tcfg
from image2video_synthesis_using_cinns_tpu_torch.data import augment as taug
from image2video_synthesis_using_cinns_tpu_torch.data.registry import augment_params as tparams

BAIR = {"brightness": 0.1, "contrast": 0.1, "saturation": 0.1, "hue": 0, "prob_hflip": 0.5}
LANDSCAPE = {"brightness": 0.2, "contrast": 0.3, "saturation": 0.2, "hue": 0.4, "prob_hflip": 0.5}


def jax_draws(key, n: int, params: dict) -> dict:
    """The per-clip draws of the JAX ``_augment_clip``, from the same keys."""
    ops = taug.enabled_ops(params)
    flip, crop, factors, order = [], [], [], []
    for k in jax.random.split(key, n):
        k_flip, k_y, k_x, *k_ops, k_order = jax.random.split(k, 8)
        flip.append(bool(jax.random.bernoulli(k_flip, params.get("prob_hflip", 0.5))))
        crop.append([int(jax.random.randint(k_y, (), 0, 17)), int(jax.random.randint(k_x, (), 0, 17))])
        f = []
        for name, kk in zip(taug.COLOUR_OPS, k_ops):
            v = params.get(name, 0.0)
            if v:
                lo, hi = (-v, v) if name == "hue" else (max(0.0, 1 - v), 1 + v)
                f.append(float(jax.random.uniform(kk, (), minval=lo, maxval=hi)))
        factors.append(f)
        order.append(np.asarray(jax.random.permutation(k_order, len(ops))) if len(ops) > 1
                     else np.arange(len(ops)))
    return {"flip": torch.tensor(flip), "crop": torch.tensor(crop),
            "factors": torch.tensor(factors, dtype=torch.float32),
            "order": torch.from_numpy(np.stack(order).astype(np.int64))}


def _frames(n, src, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n, 3, src, src, 3), dtype=np.uint8)
    raw[:, :, :4, :4] = rng.integers(0, 256, (n, 3, 4, 4, 1), dtype=np.uint8)  # gray pixels
    return raw


@pytest.mark.parametrize("params,random_crop,src,img", [
    (BAIR, False, 32, 32),
    (LANDSCAPE, True, 32, 24),
    (dict(LANDSCAPE, hue=0.5, brightness=0), False, 20, 16),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_train_augment_apply_matches_jax(params, random_crop, src, img, seed):
    raw = _frames(6, src, seed)
    key = jax.random.PRNGKey(seed + 10)
    want = np.asarray(jbuild(img, params, random_crop, True)(raw, key))
    draws = jax_draws(key, raw.shape[0], params)
    if len(taug.enabled_ops(params)) > 1:  # the test must see several orders
        assert len({tuple(o) for o in draws["order"].tolist()}) > 1
    got = taug.apply_augment(torch.from_numpy(raw), img, params, random_crop, draws)
    assert got.shape == want.shape == (6, 3, img, img, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    built = taug.build_augment(img, params, random_crop, True)
    np.testing.assert_array_equal(built(raw, draws=draws).numpy(), got.numpy())


def test_hue_floor_mod_of_negative_differences():
    """A red-max pixel with blue above green has a negative hue difference;
    torch.remainder keeps its hue in [0, 1), as the JAX package's %."""
    x = torch.tensor([[0.9, 0.1, 0.5], [0.2, 0.2, 0.2], [0.1, 0.8, 0.3]])
    hsv = taug._rgb_to_hsv(x)
    assert bool(((hsv[:, 0] >= 0) & (hsv[:, 0] < 1)).all())
    assert float(hsv[0, 0]) == pytest.approx((0.1 - 0.5) / 0.8 / 6 + 1, abs=1e-6)
    np.testing.assert_allclose(taug._hsv_to_rgb(hsv).numpy(), x.numpy(), atol=1e-6)


@pytest.mark.parametrize("params,random_crop", [(BAIR, False), (LANDSCAPE, True)])
def test_own_draws_ranges_orders_and_repeat(params, random_crop):
    n = 64
    draws = taug.draw_augment(n, params, random_crop, torch.Generator().manual_seed(3))
    ops = taug.enabled_ops(params)
    assert ops == ((("brightness", "contrast", "saturation")) if params is BAIR
                   else ("brightness", "contrast", "saturation", "hue"))
    assert draws["flip"].dtype == torch.bool and 0 < int(draws["flip"].sum()) < n
    assert draws["crop"].shape == (n, 2) and int(draws["crop"].min()) >= 0
    assert int(draws["crop"].max()) <= 16
    assert draws["factors"].shape == (n, len(ops)) and draws["factors"].dtype == torch.float32
    for j, name in enumerate(ops):
        v = params[name]
        lo, hi = (-v, v) if name == "hue" else (max(0.0, 1 - v), 1 + v)
        col = draws["factors"][:, j]
        assert float(col.min()) >= lo and float(col.max()) <= hi
    for row in draws["order"].tolist():
        assert sorted(row) == list(range(len(ops)))
    assert len({tuple(r) for r in draws["order"].tolist()}) > 1
    again = taug.draw_augment(n, params, random_crop, torch.Generator().manual_seed(3))
    other = taug.draw_augment(n, params, random_crop, torch.Generator().manual_seed(4))
    for k in draws:
        assert torch.equal(draws[k], again[k])
    assert not torch.equal(draws["factors"], other["factors"])


@pytest.mark.parametrize("dataset,mode,aug", [("BAIR", "train", True), ("BAIR", "train", False),
                                              ("BAIR", "eval", True), ("landscape", "train", True),
                                              ("DTDB", "test", True)])
def test_augment_params_matches_jax(dataset, mode, aug):
    data = {"dataset": dataset, "aug": aug, "Augmentation": dict(LANDSCAPE)}
    want = jparams(jcfg.Config({"Data": data}), mode)
    got = tparams(tcfg.Config({"Data": data}), mode)
    assert got == want
    assert got[2] == (mode == "train" and aug)
