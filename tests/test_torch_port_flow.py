"""The torch port's conditional flow and its fused-chain kernel wrappers
against the JAX package, on the CPU.

Weights are made by the JAX package and carried to the port through the
weight bridge; inputs are made with numpy from a seed. On a CPU tensor the
kernel wrappers run their plain PyTorch version, which rounds where the
CUDA kernel and the Pallas kernel round.

Tolerances: the plain fp32 paths agree to 1e-5 (only the order of sums
differs); the bf16-weight chain is held to the Pallas test's 2e-2
(tests/test_pallas_flow.py).
"""

import re
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image2video_synthesis_using_cinns_tpu.models.stage2.flow import (
    control_mask,
    flow_forward,
    flow_reverse,
    init_flow_blocks,
    init_shuffle_buffers,
)
from image2video_synthesis_using_cinns_tpu.ops.pallas.flow_kernel import (
    flow_forward_fused,
    flow_reverse_fused,
)
from image2video_synthesis_using_cinns_tpu_torch.models.stage2 import flow as tflow
from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import build
from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk
from image2video_synthesis_using_cinns_tpu_torch.utils.convert import to_state_dict

C, E, H, NF, B = 16, 12, 32, 5, 8  # the shapes of tests/test_pallas_flow.py


def _setup(control: bool):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    blocks = init_flow_blocks(k1, C, E, H, 2, NF)
    buffers = init_shuffle_buffers(k2, C, NF)
    blocks["actnorm"] = {
        "loc": 0.2 * jax.random.normal(k3, (NF, C)),
        "scale": 1.0 + 0.2 * jax.random.uniform(k3, (NF, C)),
    }
    mask = control_mask(NF, control)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, C)).astype(np.float32)
    emb = rng.standard_normal((B, E)).astype(np.float32)

    port = tflow.ConditionalFlow(C, E, H, 2, NF, control=control, use_kernel=True)
    variables = jax.tree.map(np.asarray, {"params": {"blocks": blocks}, "buffers": {"shuffle": buffers}})
    port.load_state_dict(to_state_dict(variables))
    return blocks, buffers, mask, x, emb, port


def _packed(port, dtype):
    return fk.PackedFlow(port.blocks_dict(), port.shuffle.fwd, port.shuffle.inv, port.mask, dtype)


@pytest.mark.parametrize("control", [False, True])
def test_plain_flow_matches_jax(control):
    blocks, buffers, mask, x, emb, port = _setup(control)
    ref_y, ref_ld = flow_forward(blocks, buffers, jnp.asarray(x), jnp.asarray(emb), mask)
    ref_x = flow_reverse(blocks, buffers, jnp.asarray(x), jnp.asarray(emb), mask)
    with torch.no_grad():
        y, ld = tflow.flow_forward(port.blocks_dict(), port.shuffle_dict(), torch.from_numpy(x),
                                   torch.from_numpy(emb), port.mask)
        xr = tflow.flow_reverse(port.blocks_dict(), port.shuffle_dict(), torch.from_numpy(x),
                                torch.from_numpy(emb), port.mask)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ref_ld), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xr.numpy(), np.asarray(ref_x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("control", [False, True])
def test_fp32_chain_matches_plain_jax_flow(control):
    """The fp32-weight mode of the fused chain is the plain flow, to rounding."""
    blocks, buffers, mask, x, emb, port = _setup(control)
    p = _packed(port, torch.float32)
    ref_y, ref_ld = flow_forward(blocks, buffers, jnp.asarray(x), jnp.asarray(emb), mask)
    ref_x = flow_reverse(blocks, buffers, jnp.asarray(x), jnp.asarray(emb), mask)
    y, ld = fk.flow_forward_fused(p, torch.from_numpy(x), torch.from_numpy(emb))
    xr = fk.flow_reverse_fused(p, torch.from_numpy(x), torch.from_numpy(emb))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ref_ld), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xr.numpy(), np.asarray(ref_x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("control", [False, True])
def test_bf16_chain_matches_pallas(control):
    """bf16-weight chain against the Pallas kernel (interpret mode on the CPU)."""
    blocks, buffers, mask, x, emb, port = _setup(control)
    port.pack_kernel_weights()  # the module's default: bf16 weights
    p = port.packed
    assert p.bf16 and p.w1.dtype == torch.bfloat16
    ref_y, ref_ld = flow_forward_fused(blocks, buffers, jnp.asarray(x), jnp.asarray(emb), mask)
    ref_x = flow_reverse_fused(blocks, buffers, jnp.asarray(x), jnp.asarray(emb), mask)
    y, ld = fk.flow_forward_fused(p, torch.from_numpy(x), torch.from_numpy(emb))
    xr = fk.flow_reverse_fused(p, torch.from_numpy(x), torch.from_numpy(emb))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ref_ld), rtol=2e-2, atol=2e-1)
    np.testing.assert_allclose(xr.numpy(), np.asarray(ref_x), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_roundtrip(dtype):
    """forward -> reverse through the fused chain gives x back: both
    directions round the same coupling inputs the same way."""
    _, _, _, x, emb, port = _setup(False)
    p = _packed(port, dtype)
    y, _ = fk.flow_forward_fused(p, torch.from_numpy(x), torch.from_numpy(emb))
    xr = fk.flow_reverse_fused(p, y, torch.from_numpy(emb))
    np.testing.assert_allclose(xr.numpy(), x, rtol=1e-4, atol=1e-4)


def test_module_splits_batches_above_kernel_limit():
    """ConditionalFlow feeds the kernel at most MAX_BATCH rows a call."""
    _, _, _, _, _, port = _setup(True)
    port.pack_kernel_weights()
    rng = np.random.default_rng(2)
    n = fk.MAX_BATCH + 3
    x = torch.from_numpy(rng.standard_normal((n, C)).astype(np.float32))
    emb = torch.from_numpy(rng.standard_normal((n, E)).astype(np.float32))
    with torch.no_grad():
        whole = fk.flow_reverse_fused_ref(port.packed, x, emb)
        split = port.reverse(x, emb)
        y, ld = port(x, emb)
        y_ref, ld_ref = fk.flow_forward_fused_ref(port.packed, x, emb)
    torch.testing.assert_close(split, whole, rtol=0, atol=0)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(ld, ld_ref, rtol=0, atol=0)


def test_wrapper_dispatch():
    """CPU tensors take the plain version and count no launch; other devices raise."""
    _, _, _, x, emb, port = _setup(False)
    port.pack_kernel_weights()
    before = dict(fk.launches), dict(fk.device_launches)
    fk.flow_reverse_fused(port.packed, torch.from_numpy(x), torch.from_numpy(emb))
    assert (fk.launches, fk.device_launches) == before
    with pytest.raises(ValueError):
        fk.flow_reverse_fused(port.packed, torch.empty((B, C), device="meta"),
                              torch.empty((B, E), device="meta"))
    assert fk.workspace_bytes(C, H) == (fk._round128(fk.BARRIER_WORDS * 4)
                                        + 2 * fk._round128(2 * fk.MAX_BATCH * C // 2 * 8)
                                        + 2 * fk._round128(2 * fk.MAX_BATCH * H * 4))


def test_workspace_is_kept_per_stream(monkeypatch):
    """A stream's workspace is zeroed when made, reused with the call number
    counting up, made anew when too small, and zeroed before numbers repeat."""
    dev = torch.device("cpu")
    monkeypatch.setattr(fk, "_workspaces", {})
    monkeypatch.setattr(fk, "SEQ_LIMIT", 4)
    work, seq = fk._workspace(dev, 1, 256)
    assert work.dtype == torch.uint8 and work.numel() == 256 and not work.any() and seq == 1
    work.fill_(7)
    assert fk._workspace(dev, 1, 256) == (work, 2)
    assert fk._workspace(dev, 2, 256)[1] == 1  # another stream, its own
    assert fk._workspace(dev, 1, 128) == (work, 3)
    again, seq = fk._workspace(dev, 1, 128)  # the 4th call would repeat a flag
    assert again is work and seq == 1 and not work.any()
    bigger, seq = fk._workspace(dev, 1, 512)
    assert bigger.numel() == 512 and seq == 1


def test_workspace_numbers_are_unique_across_threads(monkeypatch):
    """Calls on one stream from many threads never draw the same call number,
    which the kernel's flags rely on."""
    monkeypatch.setattr(fk, "_workspaces", {})
    dev, drawn, interval = torch.device("cpu"), [], sys.getswitchinterval()

    def draw():
        for _ in range(200):
            drawn.append(fk._workspace(dev, 7, 64)[1])

    threads = [threading.Thread(target=draw) for _ in range(16)]
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(drawn) == list(range(1, 16 * 200 + 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_tiles_hold_the_coupling_weights(dtype):
    """Tile t of a layer is one contiguous (d_in, TILE_N) slab: the s net's
    columns first, then the t net's, zero past the output width."""
    _, _, _, _, _, port = _setup(True)
    p = _packed(port, dtype)
    coupling = port.blocks_dict()["coupling"]
    for li, w in enumerate(p.weights()):
        d_out = p.d_out[li]
        d_pad = -(-d_out // fk.TILE_N) * fk.TILE_N
        assert w.is_contiguous() and w.shape[2:] == (2 * d_pad // fk.TILE_N, w.shape[3], fk.TILE_N)
        for pass_ in (0, 1):
            for k, net in enumerate((f"s{pass_}", f"t{pass_}")):
                want = torch.zeros(NF, w.shape[3], d_pad, dtype=dtype)
                want[..., :d_out] = coupling[net][li][0].detach().transpose(1, 2).to(dtype)
                for t in range(d_pad // fk.TILE_N):
                    got = w[:, pass_, k * d_pad // fk.TILE_N + t]
                    torch.testing.assert_close(
                        got, want[..., t * fk.TILE_N:(t + 1) * fk.TILE_N], rtol=0, atol=0)
                torch.testing.assert_close(p.dense(li, NF - 1, pass_, k), want[NF - 1, :, :d_out],
                                           rtol=0, atol=0)


def test_wrapper_matches_cuda_source():
    """MAX_BATCH, TILE_N, BARRIER_WORDS, SEQ_LIMIT and the ctypes argument list
    agree with csrc/flow_chain.cu."""
    src = (build.CSRC / "flow_chain.cu").read_text()
    assert int(re.search(r"constexpr int kMaxB = (\d+);", src).group(1)) == fk.MAX_BATCH
    assert int(re.search(r"constexpr int kTileN = (\d+);", src).group(1)) == fk.TILE_N
    line = int(re.search(r"constexpr int kLineWords = (\d+);", src).group(1))
    lines = int(re.search(r"constexpr int kBarrierWords = (\d+) \* kLineWords;", src).group(1))
    assert lines * line == fk.BARRIER_WORDS
    shift = int(re.search(r"constexpr int kFlagShift = (\d+);", src).group(1))
    assert fk.SEQ_LIMIT == 1 << (32 - shift)
    params = re.search(r"int flow_chain\(([^)]*)\)", src).group(1).split(",")
    lib = types.SimpleNamespace(flow_chain=types.SimpleNamespace(),
                                flow_chain_error_string=types.SimpleNamespace())
    assert len(fk._type_library(lib).flow_chain.argtypes) == len(params) == 28


def test_build_path_follows_source_and_flags(monkeypatch):
    """The library's name digests the source and nvcc's flags, so either edit rebuilds."""
    path = build.library_path("flow_chain")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libflow_chain-")
    assert build.library_path("flow_chain") == path
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-lineinfo"])
    assert build.library_path("flow_chain") != path
