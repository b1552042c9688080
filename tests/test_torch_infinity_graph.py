"""The Infinity generate call as a capturable program, on the CPU, tiny, f32.

- ``generate`` with a caller-owned KV workspace (filled with NaN before
  the call: the call zeroes it) equals ``generate`` without one, bitwise,
  images and f̂; the backend keeps one workspace per row count and reuses
  it.
- The 2D RoPE tables are the model's buffers, bitwise ``rope2d_pyramid``'s.
- ``generate`` and the backend's ``generate_p`` copy nothing from the host:
  ``torch.from_numpy`` raises while they run.
- The ES step through the program cache with the capture stubbed by a
  recording function (graphs "on" the CPU): the capture reuses the warm-up's
  workspace, the entry reports the workspace's bytes apart from its pool,
  and a replay equals the eager step bitwise; chained replays
  (``steps_per_dispatch`` 4) end at the unchained run's θ bitwise.
  ``utils.graphs.capture`` keeps the cycle collector off while it records
  (CUDA calls stubbed).
- ``run_training`` of the tiny Infinity backend with ``pop_fuse`` on the
  int8 base (``quantize_tree(min_size=512)`` in both packages, each from
  its own ``seed_params`` draw), from a seed with nothing injected,
  against the JAX loop: every shared ``metrics.jsonl`` value and the
  epoch-2 slot's θ within 3e-4 (measured: θ ≤ 6.2e-7, row values ≤ 7.6e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.backends.infinity_backend import InfinityBackend as JBackend
from hyperscalees_t2i_tpu.backends.infinity_backend import InfinityBackendConfig as JConfig
from hyperscalees_t2i_tpu.ops import quant as jquant
from hyperscalees_t2i_tpu.train.config import TrainConfig as JTrainConfig
from hyperscalees_t2i_tpu.train.trainer import run_training as jrun_training
from hyperscalees_t2i_tpu_torch.backends.infinity_backend import InfinityBackend
from hyperscalees_t2i_tpu_torch.lora import stack_adapters
from hyperscalees_t2i_tpu_torch.models import infinity as tinf
from hyperscalees_t2i_tpu_torch.ops.quant import quantize_tree
from hyperscalees_t2i_tpu_torch.rungs import infinity_rung_model
from hyperscalees_t2i_tpu_torch.train import trainer
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.utils import graphs, threefry
from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows

from test_torch_infinity import tiny_cfg
from test_torch_trainer import _assert_rows_match, brightness, jax_brightness

torch.set_num_threads(1)
TOL = dict(rtol=3e-4, atol=3e-4)
PROMPTS = ["a red square", "a blue circle", "a green cat", "a woman reading"]
RELEASED = dict(attn_l2_norm=True, use_rope2d=True, cross_attn_l2_norm=True)


def _backend(int8: bool = True, **flags):
    bcfg = infinity_rung_model("tiny")["bcfg"]
    bcfg = dataclasses.replace(bcfg, model=dataclasses.replace(bcfg.model, **flags), cfg_list=(3.0, 2.0),
                               tau_list=(0.7,))
    params = tinf.init_infinity(bcfg.model, threefry.prng_key(4, "cpu"))
    backend = InfinityBackend(bcfg, "cpu", params=quantize_tree(params, 512) if int8 else params, prompts=PROMPTS)
    backend.setup()
    return backend


def _inputs(backend, n=2, b=2):
    thetas = [backend.init_theta(threefry.fold_in(threefry.prng_key(5, "cpu"), i)) for i in range(n)]
    thetas = [{k: {f: t + 0.1 for f, t in d.items()} for k, d in th.items()} for th in thetas]
    ids = torch.arange(n * b).reshape(n, b) % backend.num_items
    noise = backend.sample_gen_noise(threefry.prng_key(6, "cpu"), range(n * b)).reshape(n, b, *backend.noise_shape)
    return stack_adapters(thetas), ids, noise


@pytest.mark.parametrize("flags", ["plain", "released"])
def test_generate_with_a_workspace_equals_without_bitwise(flags):
    backend = _backend(**(RELEASED if flags == "released" else {}))
    lora, ids, noise = _inputs(backend)
    m, cfg = backend.model, backend.model.cfg
    emb, mask = backend.text_emb[ids], backend.text_mask[ids]
    shape = (cfg.depth, 2 * ids.numel(), cfg.seq_len, cfg.n_heads, cfg.head_dim)
    ws = (torch.full(shape, float("nan")), torch.full(shape, float("nan")))
    with torch.inference_mode():
        for decode in (False, True):
            fresh = tinf.generate(m, emb, mask, noise, lora=lora, lora_scale=backend.lora_scale, decode=decode)
            reused = tinf.generate(m, emb, mask, noise, lora=lora, lora_scale=backend.lora_scale, decode=decode,
                                   workspace=ws)
            assert torch.equal(fresh, reused) and bool(torch.isfinite(fresh).all())
            ws[0].fill_(float("nan"))
        with pytest.raises(ValueError, match="KV workspace"):
            tinf.generate(m, emb, mask, noise, lora=lora, workspace=(ws[0][:, :2], ws[1][:, :2]))


def test_backend_owns_one_workspace_per_row_count():
    backend = _backend()
    assert backend.cuda_graphs and backend.workspace_bytes == 0
    lora, ids, noise = _inputs(backend)
    with torch.inference_mode():
        first = backend.generate_p(lora, ids, None, noise=noise)
        ws = backend.kv_workspace(8)
        again = backend.generate_p(lora, ids, None, noise=noise)
    assert torch.equal(first, again) and backend.kv_workspace(8) is ws
    cfg = backend.model.cfg
    per_row = 2 * cfg.depth * cfg.seq_len * cfg.n_heads * cfg.head_dim * 4
    assert backend.workspace_bytes == 8 * per_row
    backend.generate(None, [0], threefry.prng_key(3, "cpu"))  # outside inference mode, another row count
    assert backend.workspace_bytes == (8 + 2) * per_row


def test_rope_buffers_are_rope2d_pyramid():
    backend = _backend(**RELEASED)
    cos, sin = tinf.rope2d_pyramid(backend.model.cfg)
    assert torch.equal(backend.model.rope_cos, cos) and torch.equal(backend.model.rope_sin, sin)
    assert dict(backend.model.named_buffers())["rope_cos"] is backend.model.rope[0]
    assert _backend().model.rope is None


@pytest.mark.parametrize("flags", ["plain", "released"])
def test_generate_copies_nothing_from_the_host(monkeypatch, flags):
    backend = _backend(**(RELEASED if flags == "released" else {}))
    lora, ids, noise = _inputs(backend)

    def refuse(*a, **kw):
        raise AssertionError("generate copied an array from the host")

    monkeypatch.setattr(torch, "from_numpy", refuse)
    with torch.inference_mode():
        out = backend.generate_p(lora, ids, None, noise=noise)
        tinf.generate(backend.model, backend.text_emb[ids], backend.text_mask[ids], noise, lora=lora, decode=False)
    assert bool(torch.isfinite(out).all())


@pytest.fixture
def stubbed(monkeypatch):
    """Graphs "on" the CPU, the capture a function that runs the program
    once (recording its static inputs) and replays it by running it again
    into the captured outputs."""
    seen = []

    def capture(fn, static_args, stream):
        outputs = fn(*static_args)

        def replay():
            for out, new in zip(graphs._flatten(outputs)[0], graphs._flatten(fn(*static_args))[0]):
                out.copy_(new)

        seen.append(static_args)
        return graphs.Captured(replay, outputs, 0.0, 0.0, 0)

    monkeypatch.setattr(graphs, "graphs_on", lambda device: True)
    monkeypatch.setattr(graphs, "capture", capture)
    return seen


def test_graphed_step_reuses_the_workspace_and_reports_it(stubbed):
    backend = _backend()
    tc = TrainConfig(pop_size=4, sigma=0.05, egg_rank=2, member_batch=2, pop_fuse=True)
    cache = trainer.program_cache(backend, torch.device("cpu"))
    eager = trainer.make_es_step(backend, brightness, tc, 2, 1, "cpu", graphs=graphs.GraphCache("cpu", graph=False))
    step = trainer.make_es_step(backend, brightness, tc, 2, 1, "cpu", graphs=cache)
    theta = backend.init_theta(threefry.prng_key(1, "cpu"))
    step(theta, [0, 1], threefry.prng_key(2, "cpu"))  # warm-up and capture
    ws = backend.kv_workspace(2 * 2 * 2)
    assert len(stubbed) == 1 and backend.workspace_bytes > 0
    st = cache.stats()["(2, 1)"]
    assert st["workspace_bytes"] == backend.workspace_bytes and st["pool_bytes"] == 0
    for e in range(2):
        key = threefry.prng_key(10 + e, "cpu")
        g = [t.clone() for t in step(theta, [2, 3], key)[1].values()]
        x = list(eager(theta, [2, 3], key)[1].values())
        assert all(torch.equal(a, b) for a, b in zip(g, x))
    assert cache.stats()["(2, 1)"]["replays"] == 2 and backend.kv_workspace(8) is ws


def test_chained_graphed_run_training_equals_unchained_bitwise(stubbed, tmp_path):
    """``run_training`` of the tiny Infinity backend (int8 base, ``pop_fuse``)
    through the program cache with graphs "on" the CPU: chained replays
    (``steps_per_dispatch=4``: chains [1, 4]) end at the θ of the unchained
    run, bitwise, with one capture each and the draws made inside the
    step."""
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_leaves

    kw = dict(num_epochs=5, pop_size=4, sigma=0.05, egg_rank=2, prompts_per_gen=2, member_batch=2, save_every=0,
              quality=False, seed=5, pop_fuse=True, resume=False)
    runs = {}
    for k in (4, 1):
        history = []
        state = trainer.run_training(_backend(), brightness,
                                     TrainConfig(run_dir=str(tmp_path / f"k{k}"), steps_per_dispatch=k, **kw),
                                     on_epoch_end=lambda e, st: history.append(st), device="cpu")
        runs[k] = (torch.cat([t.reshape(-1) for t in tree_leaves(state.theta)]), history)
    assert [h["epochs_chained"] for h in runs[4][1]] == [1, 4] and len(stubbed) == 2
    assert torch.equal(runs[4][0], runs[1][0]) and bool(torch.isfinite(runs[4][0]).all())


def test_capture_keeps_the_cycle_collector_off(monkeypatch):
    """A capture runs the cycle collector first and keeps it off while the
    function records (a dead cycle holding an earlier graph, collected
    mid-capture, would destroy that graph inside the capture), then turns
    it back on: checked with the CUDA calls replaced by recording stubs."""
    import contextlib
    import gc
    import types

    seen = []

    class FakeGraph:
        def __init__(self, keep_graph=False):
            pass

        def instantiate(self):
            seen.append(("instantiate", gc.isenabled()))

        def replay(self):
            pass

        def pool(self):
            return (0, 0)

    @contextlib.contextmanager
    def fake_graph(g, stream=None):
        seen.append(("begin", gc.isenabled()))
        yield
        seen.append(("end", gc.isenabled()))

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(graphs, "pool_bytes", lambda pool: 0)
    assert gc.isenabled()
    captured = graphs.capture(lambda x: seen.append(("fn", gc.isenabled())) or x + 1, (torch.ones(2),),
                              types.SimpleNamespace(device=torch.device("cpu")))
    assert seen == [("begin", False), ("fn", False), ("end", False), ("instantiate", True)]
    assert gc.isenabled() and torch.equal(captured.outputs, torch.full((2,), 2.0))
    with pytest.raises(RuntimeError, match="boom"):
        graphs.capture(lambda: (_ for _ in ()).throw(RuntimeError("boom")), (),
                       types.SimpleNamespace(device=torch.device("cpu")))
    assert gc.isenabled()  # turned back on after a capture that raised


def test_run_training_int8_pop_fuse_from_a_seed_matches_jax(tmp_path):
    path = tmp_path / "prompts.txt"
    path.write_text("\n".join(PROMPTS) + "\n")
    kw = dict(num_epochs=2, pop_size=4, sigma=0.05, egg_rank=2, prompts_per_gen=2, member_batch=2, save_every=1,
              quality=True, seed=3, run_name="q8", pop_fuse=True)
    jb = JBackend(JConfig(model=tiny_cfg(), prompts_txt_path=str(path)))
    jb.setup()
    jb.params = jquant.quantize_tree(jb.params, min_size=512)
    jrun_training(jb, jax_brightness, JTrainConfig(run_dir=str(tmp_path / "jax"), base_quant="int8", **kw))
    cfg = dataclasses.replace(infinity_rung_model("tiny")["bcfg"], prompts_txt_path=str(path))
    params = quantize_tree(tinf.init_infinity(cfg.model, threefry.prng_key(cfg.seed_params, "cpu")), 512)
    backend = InfinityBackend(cfg, "cpu", params=params)
    trainer.run_training(backend, brightness, TrainConfig(run_dir=str(tmp_path / "port"), base_quant="int8", **kw),
                         device="cpu")
    assert any(hasattr(m, "q8") for m in backend.model.blocks.modules())
    jdir, pdir = tmp_path / "jax" / "q8", tmp_path / "port" / "q8"
    _assert_rows_match(read_jsonl_rows(jdir / "metrics.jsonl"), read_jsonl_rows(pdir / "metrics.jsonl"))
    slot = "ckpt/step_00000002/theta.npz"
    with np.load(jdir / slot) as jz, np.load(pdir / slot) as pz:
        assert set(jz.files) == set(pz.files)
        for k in jz.files:
            np.testing.assert_allclose(pz[k], jz[k], err_msg=k, **TOL)
