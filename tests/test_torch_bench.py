"""The port's rung runner (``hyperscalees_t2i_tpu_torch/tools/bench.py``)
against the root ``bench.py``, on the CPU at tiny sizes.

- The tiny rung from the JAX runner's keys: the warm-up step's per-member
  scores and the timed step's ``opt_score_mean`` within 3e-4 of the JAX
  rung's; the port's record has every key of the JAX record but those with
  no counterpart (:data:`NO_COUNTERPART`).
- ``flaggen``'s latent-only generate within 1e-4 of the JAX backend with
  ``decode_images=False``; the latent-only build shares the flagship path's
  keys.
- The ported helpers (``physical_floor_check``, the analytic floor's count,
  ``scaling_summary``, ``artifact_stamp``) and the shared rung tables.
- The parent with stub children: rung lines stream, a stalled rung is
  killed and the rest respawned, an MFU above 1 is refused, a silent child
  is rc 1 with no rung record, and without a card the runner exits nonzero.
- ``--serve``, ``--fleet`` and ``--scaling`` (1 and 2 gloo processes) at
  tiny: per-request and per-job parity, equal digests.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from hyperscalees_t2i_tpu import rungs as jrungs
from hyperscalees_t2i_tpu.backends.base import make_frozen as jmake_frozen
from hyperscalees_t2i_tpu.backends.sana_backend import SanaBackend as JSanaBackend
from hyperscalees_t2i_tpu_torch import rungs
from hyperscalees_t2i_tpu_torch.backends import sana_backend
from hyperscalees_t2i_tpu_torch.backends.sana_backend import SanaBackend
from hyperscalees_t2i_tpu_torch.obs.program_cost import set_ledger
from hyperscalees_t2i_tpu_torch.tools import bench
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.weights.from_jax import adapter_from_jax, tree_from_numpy

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TOL = 3e-4
# JAX record keys the port's record replaces: the Pallas provenance by
# kernel_launches, the jax version by torch_version
NO_COUNTERPART = {"pallas_env", "pallas_probes", "fused_qlora", "jax_version"}


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _f32_compute(rung_model, dtype):
    """``sana_rung_model`` with the DiT and the DC-AE computing in f32: at
    bf16, XLA and torch round the activations differently, and promptnorm
    divides the members' reward spread, which is at that rounding's scale."""
    def wrapped(scale, **kw):
        spec = dict(rung_model(scale, **kw))
        b = spec["bcfg"]
        spec["bcfg"] = dataclasses.replace(b, model=dataclasses.replace(b.model, compute_dtype=dtype),
                                           vae=dataclasses.replace(b.vae, compute_dtype=dtype))
        return spec

    return wrapped


@pytest.fixture(scope="module")
def tiny_records(tmp_path_factory):
    """The JAX tiny rung and the port's, one timed step each, no chain, the
    weights bf16 as the rung casts them and the generator computing in f32
    (:func:`_f32_compute`); the JAX warm-up scores read where its runner
    hashes them."""
    tmp = tmp_path_factory.mktemp("bench")
    mp = pytest.MonkeyPatch()
    mp.setattr(jbench, "sana_rung_model", _f32_compute(jbench.sana_rung_model, jnp.float32))
    mp.setattr(sana_backend, "sana_rung_model", _f32_compute(sana_backend.sana_rung_model, torch.float32))
    for k, v in {"BENCH_STEPS": "1", "BENCH_CHAIN": "0", "BENCH_PROGRAMS_JSONL": str(tmp / "programs.jsonl")}.items():
        mp.setenv(k, v)
    mp.delenv("BENCH_PROFILE_DIR", raising=False)
    seen = []
    real = hashlib.sha256

    def spy(data=b"", *a, **kw):
        seen.append(bytes(data))
        return real(data, *a, **kw)

    try:
        mp.setattr(hashlib, "sha256", spy)
        jrec = jbench.run_rung("tiny")
        mp.setattr(hashlib, "sha256", real)
        mp.setenv("BENCH_PROFILE_DIR", str(tmp / "profile"))
        bench._install_bench_ledger()
        trec = bench.run_rung("tiny", device="cpu")
    finally:
        mp.undo()
        set_ledger(None)
    # the digest's input: the 4 members' f32 scores
    jscores = np.frombuffer([b for b in seen if len(b) == 16][-1], np.float32)
    return jrec, trec, jscores, tmp


def test_tiny_rung_scores_match_jax(tiny_records):
    jrec, trec, jscores, _ = tiny_records
    err = np.abs(np.asarray(trec["opt_scores"], np.float32) - jscores).max()
    assert jscores.shape == (4,) and err <= TOL, (trec["opt_scores"], jscores)
    assert abs(trec["opt_score_mean"] - jrec["opt_score_mean"]) <= TOL
    mean_err = abs(trec["opt_score_mean"] - jrec["opt_score_mean"])
    print(f"max |Δ| warm-up scores {err:.3g}, opt_score_mean {mean_err:.3g}")
    assert trec["chain"] == jrec["chain"] == 0 and trec["steps_timed"] == jrec["steps_timed"] == 1
    for k in ("rung", "geometry", "pop", "prompts", "member_batch", "reward_tile", "noise_dtype", "tower_dtype",
              "pop_fuse", "base_quant", "remat"):
        assert trec[k] == jrec[k], k


def test_tiny_record_has_the_jax_keys(tiny_records):
    jrec, trec, _, tmp = tiny_records
    assert set(jrec) - NO_COUNTERPART <= set(trec), sorted(set(jrec) - NO_COUNTERPART - set(trec))
    assert trec["schema_version"] == jrec["schema_version"] == 4
    assert trec["platform"] == "cpu" and trec["mfu"] is None and trec["physical_floor_s"] is None
    assert trec["step_tflops"] > 0 and trec["bytes_accessed"] > 0
    assert trec["kernel_launches"] == {k: 0 for k in bench.KERNELS}  # the CPU runs the plain versions
    # the record's program landed in the ledger, and the profile window's
    # ranges are the ones obs/calib.py joins to it
    from hyperscalees_t2i_tpu_torch.obs import calib, profile_trace

    progs = [json.loads(l) for l in (tmp / "programs.jsonl").read_text().splitlines()]
    assert [(p["site"], p["label"]) for p in progs if p.get("rung") == "tiny"][-1] == ("bench", "tiny")
    (trace,) = profile_trace.find_trace_files(tmp / "profile" / "tiny")
    names = {e["name"] for e in profile_trace.range_events(profile_trace.load_trace(trace), ("bench/",))}
    assert names == {"bench/tiny"}
    payload = calib.calibrate_run(tmp, host_measured={"bench/tiny": trec["step_time_s"]})
    assert [r["key"] for r in payload["rows"]] == ["bench/tiny"]


def test_flaggen_latent_generate_matches_jax():
    """At f32 compute (:func:`_f32_compute`)."""
    jcfg = _f32_compute(jrungs.sana_rung_model, jnp.float32)("tiny")["bcfg"]
    jcfg = dataclasses.replace(jcfg, decode_images=False)
    tcfg = dataclasses.replace(_f32_compute(rungs.sana_rung_model, torch.float32)("tiny")["bcfg"],
                               decode_images=False)
    jb = JSanaBackend(jcfg)
    jb.setup()
    assert jb.vae_params is None
    theta = jax.tree_util.tree_map(lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(31), x.shape),
                                   jb.init_theta(jax.random.PRNGKey(30)))
    j = np.asarray(jb.generate_p(jb.frozen, theta, jnp.array([0, 0], jnp.int32), jax.random.PRNGKey(5)))
    tb = SanaBackend(tcfg, "cpu", params=tree_from_numpy(_np(jb.params), "cpu"), prompts=jb.prompts)
    tb.setup()
    assert tb.vae is None
    tb.prompt_embeds = torch.from_numpy(np.array(jb.prompt_embeds))
    stacked = {k: {f: t[None] for f, t in d.items()} for k, d in adapter_from_jax(_np(theta), "cpu").items()}
    with torch.inference_mode():
        out = tb.generate_p(stacked, [[0, 0]], threefry.prng_key(5, "cpu")[None])[0]
    assert out.shape == j.shape == (2, 8, 8, 4)
    err = float(np.abs(out.numpy() - j).max())
    assert err <= 1e-4, err
    print(f"latent-only generate max |Δ| {err:.3g}")
    np.testing.assert_allclose(sana_backend.latent_mean_reward(out, None)["combined"].numpy(),
                               j.astype(np.float32).mean(axis=(1, 2, 3)), rtol=1e-5, atol=1e-6)


def test_flaggen_build_shares_the_flagship_keys(monkeypatch):
    """``build_train_backend("flagship_gen")`` draws the DiT and prompt
    embeddings from the keys the full build uses, builds no decoder and no
    towers, and rewards the latents' mean (at tiny widths here)."""
    tiny = rungs.sana_rung_model("tiny")
    latent = dict(tiny, bcfg=dataclasses.replace(tiny["bcfg"], decode_images=False), latent_only=True)
    full_backend, suite = sana_backend.build_train_backend("tiny", "cpu")
    monkeypatch.setattr(sana_backend, "sana_rung_model", lambda scale, **kw: latent)
    backend, reward = sana_backend.build_train_backend("flagship_gen", "cpu", base_quant="off")
    assert reward is sana_backend.latent_mean_reward and backend.vae is None and suite is not reward
    for (n, a), (_, b) in zip(full_backend.model.state_dict().items(), backend.model.state_dict().items()):
        assert torch.equal(a, b), n
    assert torch.equal(full_backend.prompt_embeds, backend.prompt_embeds)
    spec = rungs.sana_rung_model("flagship_gen")
    assert spec["latent_only"] and not spec["bcfg"].decode_images
    assert spec["bcfg"].model == rungs.sana_rung_model("flagship")["bcfg"].model


@pytest.mark.parametrize("impl", [bench, jbench], ids=["port", "jax"])
def test_physical_floor_check(impl):
    assert impl.physical_floor_check(0.01, 1e12, 989e12, 1) is None
    err = impl.physical_floor_check(0.0001, 1e12, 989e12, 1)
    assert err is not None and "IMPOSSIBLE" in err
    assert impl.physical_floor_check(0.0001, 1e12, 989e12, 16) is None
    assert impl.physical_floor_check(1e-9, 1e12, None, 1) is None
    assert impl.physical_floor_check(1e-9, 0.0, 989e12, 1) is None
    assert impl.physical_floor_check(1e-9, None, 989e12, 1) is None
    assert bench.physical_floor_check(0.0001, 1e12, 989e12, 1) == jbench.physical_floor_check(0.0001, 1e12, 989e12, 1)


def test_analytic_floor_counts_the_jax_trees(monkeypatch):
    """The same count as the JAX runner's over the tiny rung's trees, built
    with f32 leaves: the JAX count skips bf16 leaves (``np.issubdtype`` of
    ml_dtypes' bfloat16 is not floating; ROADMAP queue C), the port's counts
    every float leaf."""
    monkeypatch.setattr(jbench, "_cast_tree", lambda tree, dtype: tree)
    monkeypatch.setattr(sana_backend, "cast_floating", lambda tree, dtype: tree)
    jbackend, jreward = jbench.build("tiny")
    jtheta = jbackend.init_theta(jax.random.PRNGKey(1))
    want = jbench.analytic_floor_flops(jmake_frozen(jbackend, jreward), jtheta, 16)
    backend, reward = bench.build_rung("tiny", torch.device("cpu"))
    theta = backend.init_theta(threefry.prng_key(1, "cpu"))
    got = bench.analytic_floor_flops(bench.frozen_tensors(backend, reward) + bench._tree_tensors(theta), 16)
    assert got == want


def test_scaling_summary_matches_jax():
    rows = {
        "1": {"rung": "tiny", "imgs_per_sec": 100.0, "step_time_s": 0.16, "mesh_shape": None,
              "collective_bytes": None, "collective_ops": None, "opt_scores_digest": "aa" * 8, "t_comms_s": None},
        "2": {"rung": "tiny", "imgs_per_sec": 180.0, "step_time_s": 0.089, "mesh_shape": {"pop": 2, "data": 1},
              "collective_bytes": 67520.0, "collective_ops": 37, "opt_scores_digest": "aa" * 8, "t_comms_s": 0.0089},
        "4": {"rung": "tiny", "error": "launch rc=1, no record"},
    }
    assert bench.scaling_summary(rows) == jbench.scaling_summary(rows)
    by_n = {s["devices"]: s for s in bench.scaling_summary(rows)}
    assert by_n[2]["efficiency"] == 0.9 and by_n[2]["collective_time_share_est"] == 0.1
    assert by_n[4]["error"] and by_n[4]["efficiency"] is None


def test_artifact_stamp_fields():
    stamp = bench.artifact_stamp()
    assert stamp["schema_version"] == jbench.BENCH_SCHEMA_VERSION == 4
    assert stamp["torch_version"] and stamp["torch_version"].split("+")[0] == torch.__version__.split("+")[0]
    assert set(stamp) == {"schema_version", "torch_version", "git_sha", "device_name", "power_limit"}
    assert set(jbench.artifact_stamp()) - {"jax_version"} <= set(stamp)


def test_rung_tables_equal_jax():
    for r, plan in jrungs.RUNG_PLAN.items():
        assert rungs.RUNG_PLAN[r] == plan, r
        jopt = {k: v for k, v in jrungs.RUNG_OPT[r].items() if k not in ("remat", "quality")}
        if r == "flaggen":  # the port's runs at the flagship's tile (queue C)
            jopt["reward_tile"] = jrungs.RUNG_OPT["flagship"]["reward_tile"]
        assert jopt == rungs.RUNG_OPT[r], r
    assert rungs.SERVE_PLAN == jrungs.SERVE_PLAN and rungs.CAPACITY_PLAN == jrungs.CAPACITY_PLAN
    assert rungs.RUNG_CHAIN_FIT_GATED == jrungs.RUNG_CHAIN_FIT_GATED
    assert rungs.SCALING_DEVICE_COUNTS == jrungs.SCALING_DEVICE_COUNTS
    assert rungs.BENCH_PROMPT_SET == jrungs.BENCH_PROMPT_SET and rungs.RUNG_ORDER == jrungs.RUNG_ORDER
    assert set(rungs.RUNG_PLAN) == set(rungs.RUNG_EST_S) and set(rungs.RUNG_CHAIN) <= set(rungs.RUNG_PLAN)
    assert rungs.RUNG_PLAN["flaggen"][1:] == rungs.RUNG_PLAN["flagship"][1:]
    from hyperscalees_t2i_tpu.ops.pallas_probe import PALLAS_ENV_FLAGS

    assert rungs.PALLAS_ENV_FLAGS == PALLAS_ENV_FLAGS
    for d in ({}, {"remat": "blocks", "reward_tile": 2, "noise_dtype": "bfloat16", "tower_dtype": "bfloat16",
                   "pop_fuse": True, "base_quant": "int8"},
              {"base_quant": "int8", "fused_qlora": False, "pallas_env": {"HSES_FUSED_QLORA_PALLAS": "1",
                                                                          "HSES_USE_PALLAS": "0", "HSES_X": "1"},
               "pallas_probes": {"qlora": False, "flash": True}}):
        assert rungs.knobs_str(d) == jrungs.knobs_str(d) and rungs.kernel_marks(d) == jrungs.kernel_marks(d)
    assert bench.plan_kernels("flagship") == ["int8_matmul", "fused_qlora"]
    assert bench.plan_kernels("flaggen") == ["int8_matmul", "fused_qlora"]
    assert bench.plan_kernels("ar_d16") == bench.plan_kernels("ar") == ["decode_attention"]
    assert bench.plan_kernels("tiny") == [] and bench.plan_kernels("inf_2b") == ["decode_attention"]


# ---------------------------------------------------------------------------
# the parent, with stub children
# ---------------------------------------------------------------------------

def _stub(monkeypatch, body: str):
    """Make the ladder's child ``python -c body`` with the rung list in
    ``sys.argv[1]``."""
    monkeypatch.setattr(bench, "_child_argv", lambda rungs: [sys.executable, "-c", body, ",".join(rungs)])


STUB_HEAD = "import json, sys, time\nrungs = sys.argv[1].split(',')\n"


def _rec(rung, **kw):
    return dict({"rung": rung, "geometry": rung, "imgs_per_sec": 10.0, "pop": 4, "member_batch": 1, "mfu": 0.1,
                 "platform": "gpu"}, **kw)


def _run_parent(monkeypatch, capsys, rungs_env, **env):
    monkeypatch.setenv("BENCH_RUNGS", rungs_env)
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    rc = bench.main()
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


def test_parent_streams_rung_lines(monkeypatch, capsys):
    _stub(monkeypatch, STUB_HEAD + (
        "print(json.dumps({'hb': 'tiny', 'phase': 'build'}), file=sys.stderr, flush=True)\n"
        "for r in rungs:\n"
        f"    rec = {_rec('R')!r}\n"
        "    rec.update(rung=r, geometry=r)\n"
        "    print(json.dumps(rec), flush=True)\n"))
    rc, d = _run_parent(monkeypatch, capsys, "tiny,flagship", BENCH_BUDGET_S=120)
    assert rc == 0 and set(d["rungs"]) == {"tiny", "flagship"}
    assert all("imgs_per_sec" in r for r in d["rungs"].values())
    assert d["value"] == 10.0 and d["geometry"] == "flagship" and d["vs_baseline"] == round(10.0 / 3.0, 4)
    assert d["mfu_gate_armed"] and d["platform_fallback"] is None


def test_parent_kills_a_stalled_rung_and_respawns_the_rest(monkeypatch, capsys, tmp_path):
    calls = tmp_path / "calls.txt"
    _stub(monkeypatch, STUB_HEAD + (
        f"open({str(calls)!r}, 'a').write(sys.argv[1] + '\\n')\n"
        "for r in rungs:\n"
        "    if r == 'small':\n"
        "        print(json.dumps({'hb': r, 'phase': 'build'}), file=sys.stderr, flush=True)\n"
        "        time.sleep(600)\n"
        f"    rec = {_rec('R')!r}\n"
        "    rec.update(rung=r, geometry=r)\n"
        "    print(json.dumps(rec), flush=True)\n"))
    monkeypatch.setattr(bench, "rung_stall_cap", lambda left_s, n_pending: 3.0)
    rc, d = _run_parent(monkeypatch, capsys, "tiny,small,mid", BENCH_BUDGET_S=120)
    assert rc == 0
    assert d["rungs"]["small"]["error"].startswith("stalled")
    assert "imgs_per_sec" in d["rungs"]["tiny"] and "imgs_per_sec" in d["rungs"]["mid"]
    assert calls.read_text().split() == ["tiny,small,mid", "mid"]


def test_parent_refuses_mfu_above_one(monkeypatch, capsys):
    _stub(monkeypatch, STUB_HEAD + f"print(json.dumps({_rec('tiny', mfu=1.5)!r}), flush=True)\n")
    rc, d = _run_parent(monkeypatch, capsys, "tiny", BENCH_BUDGET_S=120)
    assert rc == 1 and d["value"] is None and "IMPOSSIBLE MFU" in d["error"]


def test_silent_child_is_an_error_with_no_cpu_rung(monkeypatch, capsys):
    _stub(monkeypatch, STUB_HEAD + "time.sleep(600)\n")
    monkeypatch.setattr(bench, "INIT_SILENCE_S", 2.0)
    rc, d = _run_parent(monkeypatch, capsys, "tiny", BENCH_BUDGET_S=120)
    assert rc == 1 and d["value"] is None and "printed nothing" in d["error"]
    assert d["platform_fallback"] is None
    assert not any("imgs_per_sec" in r for r in d["rungs"].values())
    # a child that exits without a line is the same error
    _stub(monkeypatch, STUB_HEAD + "sys.exit(3)\n")
    rc, d = _run_parent(monkeypatch, capsys, "tiny", BENCH_BUDGET_S=120)
    assert rc == 1 and "without a line" in d["error"]


def test_without_a_card_the_runner_exits_nonzero():
    """No ``--device cpu`` and no CUDA device: the ladder's child reports
    the error on every rung and the parent exits 1; a direct ``--rung``
    raises. The parent itself imports no torch."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_TINY="1", BENCH_BUDGET_S="200", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", bench.MODULE], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=200)
    assert out.returncode == 1, out.stderr[-2000:]
    d = json.loads(out.stdout.strip().splitlines()[-1])
    assert d["value"] is None and "no CUDA device" in d["rungs"]["tiny"]["error"]
    out = subprocess.run([sys.executable, "-m", bench.MODULE, "--rung", "tiny"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=200)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    out = subprocess.run([sys.executable, "-c", "import sys; import hyperscalees_t2i_tpu_torch.tools.bench as b; "
                          "print('torch' in sys.modules)"], cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert out.stdout.strip() == "False", out.stderr


def test_compile_cache_is_refused():
    with pytest.raises(SystemExit, match="cannot be serialized"):
        bench.cli(["--compile_cache", "x", "--rung", "tiny"])


# ---------------------------------------------------------------------------
# --serve, --fleet and --scaling at tiny on the CPU
# ---------------------------------------------------------------------------

def test_serve_bench_tiny_parity():
    rec = bench.run_serve_bench("tiny", adapters=4, batches=1, device="cpu")
    assert rec["mode"] == "serve" and rec["adapters"] == 4
    assert rec["parity_bitwise"] and rec["parity_max_abs_diff"] == 0.0 and rec["hot_swap_effective"]
    assert rec["batched_imgs_per_sec"] > 0 and rec["sequential_imgs_per_sec"] > 0
    assert rec["platform"] == "cpu" and rec["schema_version"] == 4


def test_fleet_bench_tiny_parity():
    rec = bench.run_fleet_bench("tiny", [1, 2], batches=1, base_quant="off", device="cpu")
    assert rec["mode"] == "fleet" and [r["width"] for r in rec["widths"]] == [1, 2]
    assert rec["parity_bitwise"]
    w2 = rec["widths"][1]
    assert w2["reward_rows_sha256"] == w2["solo_rows_sha256"] and len(set(w2["solo_rows_sha256"])) == 2
    assert w2["bytes_per_job"] > 0


def test_scaling_one_and_two_processes_agree(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_SCALING_DIR", str(tmp_path))
    monkeypatch.setenv("BENCH_STEPS", "1")
    monkeypatch.setenv("BENCH_CHAIN", "0")
    monkeypatch.setenv("BENCH_PROGRAMS_JSONL", str(tmp_path / "programs.jsonl"))
    out = tmp_path / "SCALING.json"
    rc = bench.scaling_main(["--scaling", "--rungs", "tiny", "--devices", "1,2", "--out", str(out)], device="cpu")
    assert rc == 0, capsys.readouterr().err[-3000:]
    doc = json.loads(out.read_text())
    assert doc["platform_forced"] == "cpu" and doc["device_counts"] == [1, 2]
    by_n = {s["devices"]: s for s in doc["summary"]}
    assert by_n[1]["opt_scores_digest"] == by_n[2]["opt_scores_digest"]
    assert by_n[2]["mesh_shape"] == {"pop": 2, "data": 1} and by_n[1]["efficiency"] == 1.0
    assert doc["rows"]["2"]["n_devices"] == 2
    assert bench.scaling_main(["--scaling", "--rungs", "nonesuch"]) == 2
    assert bench.scaling_main(["--scaling", "--devices", "2,4"]) == 2
