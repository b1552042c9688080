"""The port's checkpoint reader (``hyperscalees_t2i_tpu_torch.weights.io``)
against the JAX package's ``weights/io.py``: torch pickles (plain and
wrapped), f32 and f16 safetensors files, a shard directory, the bf16
divergence (the reference keeps bf16 on its safetensors route, the port
upcasts as torch does), the port's writer, ``strip_prefix``, ``.gguf`` and
a missing path. Every comparison is bitwise."""

import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.weights import io as jio
from hyperscalees_t2i_tpu_torch.weights import io as pio

torch.set_num_threads(1)
safetensors_np = pytest.importorskip("safetensors.numpy")
safetensors_torch = pytest.importorskip("safetensors.torch")


def _sd(rng, dtype=np.float32):
    return {
        "blocks.0.attn.weight": rng.standard_normal((6, 4)).astype(dtype),
        "blocks.0.attn.bias": rng.standard_normal(6).astype(dtype),
        "head.weight": rng.standard_normal((3, 2, 2, 2)).astype(dtype),
        "steps": np.arange(5, dtype=np.int64),
        "codes": rng.integers(-128, 127, (2, 3)).astype(np.int8),
        "ids": np.arange(4, dtype=np.int32),
    }


def _assert_same(port, ref, cast_ref=None):
    assert sorted(port) == sorted(ref)
    for k in ref:
        want = ref[k] if cast_ref is None or ref[k].dtype.kind != "f" else ref[k].astype(cast_ref)
        assert port[k].dtype == want.dtype and port[k].shape == want.shape, k
        assert np.array_equal(port[k], want), k


@pytest.mark.parametrize("wrapper", [None, "state_dict", "model", "module"])
def test_torch_pickles_match_jax(tmp_path, wrapper):
    sd = _sd(np.random.default_rng(0))
    obj = {k: torch.from_numpy(v) for k, v in sd.items()}
    obj["blocks.0.half"] = torch.randn(3, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    if wrapper is not None:
        obj = {wrapper: obj, "epoch": 3}
    path = tmp_path / "ckpt.pth"
    torch.save(obj, path)
    port, ref = pio.load_state_dict(path), jio.load_state_dict(path)
    _assert_same(port, ref)
    assert port["blocks.0.half"].dtype == np.float32  # bf16 upcast on the torch route, as the reference


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_safetensors_match_jax(tmp_path, dtype):
    sd = _sd(np.random.default_rng(1), dtype)
    path = tmp_path / "ckpt.safetensors"
    safetensors_np.save_file(sd, str(path))
    port, ref = pio.load_state_dict(path), jio.load_state_dict(path)
    # the reference keeps f16 on this route; the port upcasts it to f32 (the
    # same values), which every converter's f32 cast does anyway
    _assert_same(port, ref, cast_ref=np.float32)


def test_shard_directory_matches_jax(tmp_path):
    sd = _sd(np.random.default_rng(2))
    names = sorted(sd)
    safetensors_np.save_file({k: sd[k] for k in names[:3]}, str(tmp_path / "model-00001-of-00002.safetensors"))
    safetensors_np.save_file({k: sd[k] for k in names[3:]}, str(tmp_path / "model-00002-of-00002.safetensors"))
    (tmp_path / "model.safetensors.index.json").write_text("{}")
    _assert_same(pio.load_state_dict(tmp_path), jio.load_state_dict(tmp_path))
    # a directory of torch files only
    tdir = tmp_path / "torch"
    tdir.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tdir / "pytorch_model.bin")
    _assert_same(pio.load_state_dict(tdir), jio.load_state_dict(tdir))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint files"):
        pio.load_state_dict(empty)


def test_bf16_safetensors_port_upcasts_where_the_reference_keeps_bf16(tmp_path):
    """bf16 (and f16) tensors of a safetensors file: the reference's numpy
    route returns them as they are stored, bf16 as ``ml_dtypes`` arrays
    (importing jax registers that dtype with numpy; without it the route
    raises ``TypeError``, shown in a fresh process), the port returns the
    f32 values torch upcasts them to. Every converter casts to f32, so the
    converted trees are the same (ROADMAP queue C)."""
    import subprocess
    import sys

    g = torch.Generator().manual_seed(3)
    tensors = {"w": torch.randn(5, 7, generator=g).to(torch.bfloat16), "b": torch.randn(7, generator=g),
               "h": torch.randn(3, generator=g).to(torch.float16)}
    path = tmp_path / "bf16.safetensors"
    safetensors_torch.save_file(tensors, str(path))
    ref = jio.load_state_dict(path)
    assert (ref["w"].dtype.name, ref["h"].dtype.name, ref["b"].dtype.name) == ("bfloat16", "float16", "float32")
    port = pio.load_state_dict(path)
    want = safetensors_torch.load_file(str(path))
    for k, t in want.items():
        assert port[k].dtype == np.float32
        assert np.array_equal(port[k], t.float().numpy()) and np.array_equal(port[k], ref[k].astype(np.float32)), k
    bare = subprocess.run([sys.executable, "-c", "import sys; from safetensors import safe_open; "
                           f"safe_open({str(path)!r}, framework='np').get_tensor('w'); "
                           "print('ml_dtypes' in sys.modules)"], capture_output=True, text=True, timeout=120)
    assert bare.returncode != 0 and "TypeError" in bare.stderr and "bfloat16" in bare.stderr


def test_save_safetensors_is_read_by_the_safetensors_package(tmp_path):
    """The port's writer (``chip_smoke.py`` makes its card checkpoints with
    it): bf16 from f32 values rounds as torch rounds, a streamed tensor is
    made when written, and the package reads every dtype back."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((9, 5)).astype(np.float32)
    made = []
    tensors = {
        "f32": x,
        "bf16": ("BF16", (9, 5), lambda: made.append(1) or x),
        "torch_bf16": torch.from_numpy(x).to(torch.bfloat16),
        "i64": np.arange(3, dtype=np.int64),
        "i8": np.array([-3, 4], np.int8),
        "f16": x.astype(np.float16),
    }
    path = tmp_path / "w.safetensors"
    size = pio.save_safetensors(path, tensors, metadata={"format": "pt"})
    assert size == path.stat().st_size and made == [1]
    got = safetensors_torch.load_file(str(path))
    want_bf16 = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(got["bf16"], want_bf16) and torch.equal(got["torch_bf16"], want_bf16)
    assert torch.equal(got["f32"], torch.from_numpy(x)) and torch.equal(got["i64"], torch.arange(3))
    assert torch.equal(got["i8"], torch.tensor([-3, 4], dtype=torch.int8))
    assert torch.equal(got["f16"], torch.from_numpy(x.astype(np.float16)))
    back = pio.load_state_dict(path)
    assert np.array_equal(back["bf16"], want_bf16.float().numpy()) and back["i8"].dtype == np.int8
    # round to nearest even at a tie, NaN stays NaN
    tie = np.array([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, np.nan, -0.0], np.float32)
    bits = pio.f32_to_bf16_bits(tie)
    ref = torch.from_numpy(tie).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(bits[[0, 1, 3]], ref[[0, 1, 3]]) and np.isnan(pio.bf16_bits_to_f32(bits)[2])


def test_truncated_safetensors_is_refused(tmp_path):
    path = tmp_path / "t.safetensors"
    pio.save_safetensors(path, {"w": np.ones((4, 4), np.float32)})
    path.write_bytes(path.read_bytes()[:-8])
    with pytest.raises(ValueError, match="does not hold"):
        pio.load_state_dict(path)


def test_strip_prefix_matches_jax():
    sd = {"module.a": np.zeros(1), "module.b.c": np.ones(2)}
    for prefix in ("module", "module."):
        got, want = pio.strip_prefix(sd, prefix), jio.strip_prefix(sd, prefix)
        assert list(got) == list(want) == ["a", "b.c"]
    mixed = dict(sd, other=np.zeros(1))
    assert pio.strip_prefix(mixed, "module") is mixed and jio.strip_prefix(mixed, "module") is mixed


def test_gguf_raises_naming_item_9(tmp_path):
    path = tmp_path / "z.gguf"
    path.write_bytes(b"GGUF")
    with pytest.raises(NotImplementedError, match="item 9"):
        pio.load_state_dict(path)


def test_missing_path_raises_at_once(monkeypatch):
    calls = []
    real = pio._load_torch
    monkeypatch.setattr(pio, "_load_torch", lambda p: calls.append(p) or real(p))
    monkeypatch.setenv("HYPERSCALEES_RETRY_BASE_S", "30")  # a retry would sleep 30 s
    for name in ("missing.pth", "missing.safetensors", "missing_dir"):
        with pytest.raises(FileNotFoundError):
            pio.load_state_dict(name)
    assert calls == []
