"""The data axis over processes: the population's pop × data plans of
``parallel.mesh`` run by gloo launches of 2 and 4 CPU processes, against
the JAX package's mesh-sharded evaluation on the CPU's forced devices.

- The eval programs of ``train.trainer.make_host_sharded_programs(...,
  mesh=)`` over the plans 1×2 and 2×1 (2 processes) and 1×4 and 2×2 (4
  processes), on ``tests/test_torch_trainer.py``'s tiny Sana backend (the
  JAX backend's weights and prompt embeddings carried across), with an odd
  batch (3 prompts: padded to 4 by the data axis, the padding cut away):
  every rank's gathered ``[pop, B]`` rows are the same, bitwise the port's
  one-process rows (within 1e-6 at 1×4, where each process generates one
  image and the CPU's BLAS takes its one-row path for the time embedder's
  product), and within 3e-4 of the JAX ``make_host_sharded_programs``
  evaluation over a ``make_mesh`` of the same shape (θ₀, the ES noise and the
  latents each package's own draws of the JAX stream).
- ``make_population_evaluator`` refuses a generator marked
  ``ignores_item_index`` with the JAX text once the data axis is above 1.

The launches share one set of processes per size (module-scoped), each
with a time limit.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.backends.base import make_frozen as jmake_frozen
from hyperscalees_t2i_tpu.es.sampling import epoch_key as jepoch_key
from hyperscalees_t2i_tpu.parallel.mesh import make_mesh as jmake_mesh
from hyperscalees_t2i_tpu.train.config import TrainConfig as JTrainConfig
from hyperscalees_t2i_tpu.train.trainer import make_host_sharded_programs as jmake_host_sharded_programs
from hyperscalees_t2i_tpu_torch.parallel.pop_eval import make_population_evaluator
from hyperscalees_t2i_tpu_torch.train import trainer
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig

from _torch_gloo import run_workers
from test_torch_trainer import PARITY, TOL, _jax_backend, _np, brightness, jax_brightness, port_backend

torch.set_num_threads(1)
# three prompts: an odd batch that every data axis above 1 pads
CFG = {**PARITY, "prompts_per_gen": 3, "quality": False}
PLANS = {2: [(1, 2), (2, 1)], 4: [(1, 4), (2, 2)]}

WORKER = r"""
import pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from hyperscalees_t2i_tpu_torch.backends.sana_backend import SanaBackend, SanaBackendConfig
from hyperscalees_t2i_tpu_torch.models import dcae, sana
from hyperscalees_t2i_tpu_torch.parallel.collectives import process_rank
from hyperscalees_t2i_tpu_torch.parallel.mesh import initialize_multihost, make_axis_groups, make_mesh
from hyperscalees_t2i_tpu_torch.es.sampling import epoch_key
from hyperscalees_t2i_tpu_torch.train import trainer
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.weights.from_jax import tree_from_numpy

src, out = sys.argv[1], sys.argv[2]
d = pickle.load(open(src, "rb"))
initialize_multihost()
model = sana.SanaConfig(in_channels=4, out_channels=4, patch_size=1, d_model=24, n_layers=2, n_heads=4,
                        cross_n_heads=4, caption_dim=12, ff_ratio=2.0, compute_dtype=torch.float32)
vae = dcae.DCAEConfig(latent_channels=4, channels=(8, 8), blocks_per_stage=(1, 1), attn_stages=(),
                      compute_dtype=torch.float32)
cfg = SanaBackendConfig(model=model, vae=vae, width_latent=4, height_latent=4, lora_r=2, lora_alpha=4.0)
b = SanaBackend(cfg, "cpu", params=tree_from_numpy(d["params"], "cpu"),
                vae_params=tree_from_numpy(d["vae_params"], "cpu"), prompts=d["prompts"])
b.prompt_embeds = torch.from_numpy(d["embeds"])
b.prompt_mask = torch.ones(len(d["prompts"]), b.prompt_embeds.shape[1], dtype=torch.bool)
b.setup()
tc = TrainConfig(**d["tc"])
reward = lambda images, ids: {"combined": images.mean(dim=(1, 2, 3)).to(torch.float32)}
theta = trainer._init_theta(b, tc, torch.device("cpu"))
key = epoch_key(tc.seed, 0, "cpu")
res = {}
for a, n_data in d["plans"]:
    mesh = make_mesh({"pop": a, "data": n_data})
    make_axis_groups([mesh])
    ev, _ = trainer.make_host_sharded_programs(b, reward, tc, d["m"], d["r"], (0, tc.pop_size), "cpu", mesh=mesh)
    res[(a, n_data)] = {k: v.numpy() for k, v in ev(theta, d["ids"], key).items()}
pickle.dump(res, open(f"{out}.{process_rank()}", "wb"))
print("OK", process_rank())
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pop_data")
    jb = _jax_backend(tmp)
    jb.setup()
    tc = TrainConfig(run_dir=str(tmp), **CFG)
    info = jb.step_info(0, tc.prompts_per_gen, tc.batches_per_gen)
    m, r = len(info.unique_ids), info.repeats
    ids = list(info.flat_ids)
    assert m * r == 3
    src = tmp / "backend.pkl"
    d = {"params": _np(jb.params), "vae_params": _np(jb.vae_params), "prompts": list(jb.prompts),
         "embeds": np.array(jb.prompt_embeds), "tc": {"run_dir": str(tmp), **CFG}, "m": m, "r": r, "ids": ids}
    rows = {}
    for n, plans in PLANS.items():
        src.write_bytes(pickle.dumps({**d, "plans": plans}))
        run_workers(n, WORKER, [str(src), str(tmp / f"rows{n}")], timeout_s=240)
        per_rank = [pickle.loads((tmp / f"rows{n}.{i}").read_bytes()) for i in range(n)]
        for plan in plans:
            for k in per_rank[0][plan]:  # every rank holds the same gathered rows
                assert all(np.array_equal(per_rank[0][plan][k], pr[plan][k]) for pr in per_rank[1:])
            rows[plan] = per_rank[0][plan]
    # the port's one-process rows
    pb = port_backend(jb)
    pb.setup()
    theta = trainer._init_theta(pb, tc, torch.device("cpu"))
    from hyperscalees_t2i_tpu_torch.es.sampling import epoch_key

    ev, _ = trainer.make_host_sharded_programs(pb, brightness, tc, m, r, (0, tc.pop_size), "cpu")
    one = {k: v.numpy() for k, v in ev(theta, ids, epoch_key(tc.seed, 0, "cpu")).items()}
    # the JAX mesh-sharded evaluation on the same plans
    jtc = JTrainConfig(run_dir=str(tmp), **CFG)
    frozen = jmake_frozen(jb, jax_brightness)
    jtheta = jb.init_theta(jax.random.fold_in(jax.random.PRNGKey(jtc.seed), 17))
    jids = jnp.asarray(np.asarray(ids, np.int32))
    jrows = {}
    for plans in PLANS.values():
        for a, b in plans:
            mesh = jmake_mesh({"pop": a, "data": b}, devices=jax.devices()[:a * b])
            jev, _ = jmake_host_sharded_programs(jb, jax_brightness, jtc, m, r, mesh, (0, jtc.pop_size))
            jrows[(a, b)] = _np(jev(frozen, jtheta, jids, jepoch_key(jtc.seed, 0)))
    return rows, one, jrows


@pytest.mark.parametrize("plan", [p for ps in PLANS.values() for p in ps], ids=lambda p: f"{p[0]}x{p[1]}")
def test_data_axis_rows_are_one_process_rows_and_jax_rows(setup, plan):
    rows, one, jrows = setup
    assert set(rows[plan]) == set(one) == set(jrows[plan])
    for k in one:
        assert rows[plan][k].shape == one[k].shape == (CFG["pop_size"], 3)
        gap = float(np.abs(rows[plan][k] - one[k]).max())
        print(f"plan {plan} {k}: max |data-axis - one process| {gap:.3g}")
        if plan == (1, 4):
            # one image a process: the CPU's BLAS takes its one-row path for
            # the time embedder's [1, 256] @ [256, d] product, whose sums
            # differ from the batched product's in the last bit
            assert gap <= 1e-6, k
        else:
            assert np.array_equal(rows[plan][k], one[k]), k
        err = float(np.abs(rows[plan][k] - jrows[plan][k]).max())
        print(f"plan {plan} {k}: max |port - JAX| {err:.3g}")
        np.testing.assert_allclose(rows[plan][k], jrows[plan][k], err_msg=k, **TOL)


def test_ignores_item_index_generators_are_refused_on_the_data_axis():
    from hyperscalees_t2i_tpu_torch.parallel.mesh import make_mesh

    def gen(*a, **kw):
        raise AssertionError("never called")

    gen.ignores_item_index = True
    es_cfg = TrainConfig().es_config()
    mesh = make_mesh({"pop": 1, "data": 2}, ranks=[0, 1])
    with pytest.raises(ValueError, match="data-axis sharding needs a generator that folds item_index"):
        make_population_evaluator(gen, None, 4, es_cfg, 1, mesh=mesh)
    # a pop-only plan takes it
    make_population_evaluator(gen, None, 4, es_cfg, 1, mesh=make_mesh({"pop": 2, "data": 1}, ranks=[0, 1]))
