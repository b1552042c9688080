"""The program ledger's counts (``obs/program_cost.py``) and the card's peak
tables (``utils/mfu.py``) on the CPU.

- For each of K1-K4 at two shapes: the wrapper's own FLOP count equals the
  dispatch mode's count of its plain version (exactly: the mode sums
  ``torch.utils.flop_counter``'s formulas over the plain version's aten
  ops), and under the mode the wrapper is counted once, as its own FLOPs and
  bytes, with nothing inside it counted again.
- ``GraphCache(count_cost=True)`` counts a program's first run only; a tiny
  int8 ``pop_fuse`` plan's ``programs.jsonl`` record carries the counted
  FLOPs and bytes with K1's and K3's share.
- The ``mfu`` helpers give None on the CPU, as the reference's do, and the
  H100 tables resolve the cards' names.
"""

import json

import pytest
import torch

from hyperscalees_t2i_tpu.utils import mfu as jmfu
from hyperscalees_t2i_tpu_torch.backends.sana_backend import build_serve_backend
from hyperscalees_t2i_tpu_torch.es.sampling import epoch_key
from hyperscalees_t2i_tpu_torch.lora import FactoredDelta
from hyperscalees_t2i_tpu_torch.obs import program_cost
from hyperscalees_t2i_tpu_torch.obs.program_cost import CostCounter
from hyperscalees_t2i_tpu_torch.ops.attention import decode_attention, decode_attention_cost, naive_masked_attention
from hyperscalees_t2i_tpu_torch.ops.fused_lora import (member_lora_delta, member_lora_delta_cost,
                                                       member_lora_delta_reference)
from hyperscalees_t2i_tpu_torch.ops.fused_qlora import fused_qlora_cost, fused_qlora_matmul, fused_qlora_reference
from hyperscalees_t2i_tpu_torch.ops.quant_mm import int8_matmul, int8_matmul_cost, int8_matmul_reference
from hyperscalees_t2i_tpu_torch.rungs import sana_rung_model
from hyperscalees_t2i_tpu_torch.train import trainer
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.utils import mfu, threefry
from hyperscalees_t2i_tpu_torch.utils.graphs import GraphCache

torch.set_num_threads(1)


def _g(seed):
    return torch.Generator().manual_seed(seed)


def _factors(g, din, dout, r_l, r_e, lanes, ndt):
    shape = (lambda *s: (lanes, *s)) if lanes else (lambda *s: s)
    a = FactoredDelta(torch.randn(din, r_l, generator=g), torch.randn(shape(din, r_e), generator=g).to(ndt),
                      torch.randn(shape(r_l, r_e), generator=g).to(ndt), torch.randn(shape(), generator=g))
    b = FactoredDelta(torch.randn(r_l, dout, generator=g), torch.randn(shape(r_l, r_e), generator=g).to(ndt),
                      torch.randn(shape(dout, r_e), generator=g).to(ndt), torch.randn(shape(), generator=g))
    return a, b


def _q8(g, din, dout):
    return torch.randint(-127, 128, (din, dout), dtype=torch.int8, generator=g), torch.rand(1, dout, generator=g)


def _cases():
    g = _g(0)
    q8, sc = _q8(g, 16, 24)
    q8b, scb = _q8(g, 40, 8)
    a, b = _factors(g, 16, 24, 4, 2, 3, torch.float32)
    a1, b1 = _factors(g, 40, 8, 2, 4, 0, torch.bfloat16)
    q, k, v = torch.randn(2, 3, 4, 8, generator=g), torch.randn(2, 10, 4, 8, generator=g), \
        torch.randn(2, 10, 4, 8, generator=g)
    mask = torch.rand(2, 10, generator=g) > 0.3
    x3 = torch.randn(3, 5, 16, generator=g)
    x1 = torch.randn(7, 40, generator=g).to(torch.bfloat16)
    return [
        ("k1", int8_matmul, int8_matmul_cost, int8_matmul_reference, (x3, q8, sc)),
        ("k1", int8_matmul, int8_matmul_cost, int8_matmul_reference, (x1, q8b, scb)),
        ("k2", member_lora_delta, member_lora_delta_cost, member_lora_delta_reference, (x3, a, b, 0.5)),
        ("k2", member_lora_delta, member_lora_delta_cost, member_lora_delta_reference, (x1, a1, b1, 2.0)),
        ("k3", fused_qlora_matmul, fused_qlora_cost, fused_qlora_reference, (x3, q8, sc, a, b, 0.5)),
        ("k3", fused_qlora_matmul, fused_qlora_cost, fused_qlora_reference, (x1, q8b, scb, a1, b1, 2.0)),
        ("k4", decode_attention, decode_attention_cost,
         lambda q, k, v, kv_len, mask: naive_masked_attention(q, k, v, kv_len, mask, 0.35), (q, k, v, 7, mask)),
        ("k4", decode_attention, decode_attention_cost,
         lambda q, k, v: naive_masked_attention(q, k, v, k.shape[1], None, 0.35), (q, k, v)),
    ]


CASES = _cases()


@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"{c[0]}-{i % 2}" for i, c in enumerate(CASES)])
def test_wrapper_flops_equal_the_modes_count_of_the_plain_version(case):
    _, wrapper, cost, plain, args = CASES[case]
    flops, nbytes = cost(*args)
    with torch.inference_mode(), CostCounter() as counted_plain:
        plain(*args)
    assert flops > 0 and flops == counted_plain.flops
    assert counted_plain.kernels == {}
    with torch.inference_mode(), CostCounter() as counted:
        out = wrapper(*args)
    # the wrapper counts itself once; nothing inside it reaches the mode
    assert counted.ops == 0 and (counted.flops, counted.bytes_accessed) == (flops, nbytes)
    assert counted.kernels == {wrapper.__name__: {"calls": 1, "flops": flops, "bytes": nbytes}}
    # bytes: each input read once, the output written once
    assert nbytes >= out.numel() * out.element_size() + args[0].numel() * args[0].element_size()
    # outside a counter the wrapper runs as it is
    torch.testing.assert_close(wrapper(*args), out, rtol=0, atol=0)


def test_counter_counts_ops_and_skips_views():
    x, w = torch.randn(6, 8), torch.randn(8, 3)
    with CostCounter() as c:
        y = (x @ w).t().contiguous()  # mm, a view, a copy
        torch.empty(100)
    assert c.flops == 2 * 6 * 8 * 3
    assert c.bytes_accessed == (6 * 8 + 8 * 3 + 6 * 3) * 4 + 2 * y.numel() * 4
    assert program_cost.active_counter() is None


def test_graph_cache_counts_the_first_run_only():
    cache = GraphCache("cpu", count_cost=True)
    x = torch.randn(4, 16)
    q8, sc = _q8(_g(1), 16, 8)
    fn = lambda x: int8_matmul(x, q8, sc) @ torch.ones(8, 2)  # noqa: E731
    cache("k", fn, x)
    first = dict(cache.entries["k"].cost)
    cache("k", fn, x)
    assert cache.entries["k"].cost == first
    assert first["flops"] == 2 * 4 * 16 * 8 + 2 * 4 * 8 * 2
    assert first["kernels"]["int8_matmul"]["calls"] == 1
    assert GraphCache("cpu")._warmup(cache.entries["k"], fn, (x,)) is not None


@pytest.mark.parametrize("member_batch, reward_tile", [(1, 1), (2, 0), (3, 1)])
def test_repeated_units_count_what_every_op_counts(monkeypatch, member_batch, reward_tile):
    """The ledger's count with each member tile counted twice and repeated
    after equals the count of every op, exactly (the tiny int8 plan with
    ``pop_fuse``: K1 and K3 inside the repeated units; at member_batch 3 the
    last chunk is smaller, a second unit shape)."""
    monkeypatch.setenv("HSES_BASE_QUANT_MIN_SIZE", "0")
    backend = build_serve_backend(sana_rung_model("tiny")["bcfg"], "int8", device="cpu",
                                  prompts=["a red cube", "a blue sphere", "a green cone"])
    tc = TrainConfig(pop_size=4, sigma=0.01, egg_rank=2, prompts_per_gen=2, batches_per_gen=2,
                     member_batch=member_batch, reward_tile=reward_tile, pop_fuse=True, base_quant="int8", seed=5)
    info = backend.step_info(0, 2, 2)
    counts = []
    for repeat_units in (True, False):
        step = trainer.make_es_step(backend, lambda images, ids: {"combined": images.mean(dim=(1, 2, 3))}, tc,
                                    2, 2, "cpu")
        with torch.inference_mode(), CostCounter(repeat_units=repeat_units) as counter:
            step(backend.init_theta(threefry.prng_key(1, "cpu")), info.flat_ids, epoch_key(5, 0, "cpu"))
        counts.append(counter.summary())
    assert counts[0] == counts[1]
    assert counts[0]["kernels"]["fused_qlora_matmul"]["calls"] > 0


def test_tiny_int8_plan_record(tmp_path, monkeypatch):
    monkeypatch.setenv("HSES_BASE_QUANT_MIN_SIZE", "0")  # every tiny kernel int8: K1 and K3 run
    backend = build_serve_backend(sana_rung_model("tiny")["bcfg"], "int8", device="cpu",
                                  prompts=["a red cube", "a blue sphere", "a green cone"])
    tc = TrainConfig(num_epochs=2, pop_size=4, sigma=0.01, egg_rank=2, prompts_per_gen=2, member_batch=2,
                     pop_fuse=True, base_quant="int8", save_every=0, seed=5, run_dir=str(tmp_path), run_name="q8")
    trainer.run_training(backend, lambda images, ids: {"combined": images.mean(dim=(1, 2, 3))}, tc, device="cpu")
    (rec,) = [json.loads(line) for line in (tmp_path / "q8" / "programs.jsonl").read_text().splitlines()]
    assert (rec["site"], rec["label"], rec["chain"], rec["n_devices"]) == ("train", "es_step_m2r1", 1, 1)
    assert rec["platform"] == rec["device_kind"] == "cpu"
    assert rec["geometry"]["m"] == 2 and rec["geometry"]["pop_fuse"] is True
    assert rec["geometry"]["member_batch"] == 2 and rec["geometry"]["reward_tile"] == 0  # noted by pop_eval
    kernels = rec["kernels"]
    assert set(kernels) == {"int8_matmul", "fused_qlora_matmul"}
    assert all(k["calls"] > 0 and k["flops"] > 0 for k in kernels.values())
    assert rec["flops"] > sum(k["flops"] for k in kernels.values()) > 0
    assert rec["bytes_accessed"] > sum(k["bytes"] for k in kernels.values()) > 0
    assert rec["intensity"] == pytest.approx(rec["flops"] / rec["bytes_accessed"])
    assert rec["warmup_s"] > 0 and rec["pool_bytes"] == 0


def test_mfu_helpers():
    assert mfu.device_peak_flops() is None and mfu.device_hbm_bandwidth() is None  # no card here
    assert mfu.mfu(1e12, 0.1) is None and jmfu.mfu(1e12, 0.1) is None
    assert mfu.device_kind() == "cpu" and mfu.peak_flops_for_kind("cpu") is None
    h100 = "NVIDIA H100 80GB HBM3"
    assert (mfu.peak_flops_for_kind(h100), mfu.hbm_bw_for_kind(h100), mfu.hbm_bytes_for_kind(h100)) == \
        (989e12, 3.35e12, 80e9)
    assert (mfu.peak_flops_for_kind("NVIDIA H100 PCIe"), mfu.hbm_bw_for_kind("NVIDIA H100 PCIe")) == (756e12, 2.0e12)
    assert mfu.peak_flops_for_kind("TPU v5 lite") is None  # no TPU figure in the port's tables
