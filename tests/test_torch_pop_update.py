"""The pop-sharded update (``parallel.pop_update``) and its pieces in
``es.noiser`` against the JAX package on the CPU.

- ``member_maps`` equal to the JAX tables; ``es_partial_delta`` and
  ``apply_es_delta`` against the JAX functions on the same noise (the JAX
  draws handed across, 2D, stacked 3D and dense leaves, f32 and bf16
  stores) within 1e-4; partials of a cover of the base samples summed and
  applied against the JAX ``es_update``; one shard over the whole range
  bitwise the port's ``es_update``.
- ``pop_shard_update_plan``'s decisions and errors against the JAX plan
  on a pop-N mesh, for a table of (mode, pop, antithetic, N).
- ``make_sharded_es_update`` at N = 2 and 4 gloo processes
  (``_torch_gloo.run_workers``) against the JAX ``make_sharded_es_update``
  on a pop-N mesh within 1e-4, every rank's θ′ bitwise equal; a base that
  does not tile the processes raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.es import noiser as jnoiser
from hyperscalees_t2i_tpu.parallel import mesh as jmesh
from hyperscalees_t2i_tpu.parallel import pop_update as jpop_update
from hyperscalees_t2i_tpu_torch.es import noiser
from hyperscalees_t2i_tpu_torch.parallel import pop_update
from hyperscalees_t2i_tpu_torch.utils.pytree import tree_leaves
from hyperscalees_t2i_tpu_torch.weights.from_jax import tree_from_numpy

from _torch_gloo import run_workers

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _theta(seed=0):
    """A 2D, a stacked 3D and a dense (1D) leaf."""
    r = np.random.default_rng(seed)
    f = lambda *s: jnp.asarray(r.normal(size=s) * 0.1, jnp.float32)  # noqa: E731
    return {"blocks/to_q": {"a": f(2, 6, 3), "b": f(2, 3, 5)}, "proj": {"a": f(6, 3), "b": f(3, 4)},
            "norm": {"scale": f(5)}}


def _case(pop, antithetic, noise_dtype, seed=3):
    kw = dict(sigma=0.05, lr_scale=1.5, rank=2, antithetic=antithetic, noise_dtype=noise_dtype)
    jcfg, cfg = jnoiser.EggRollConfig(**kw), noiser.EggRollConfig(**kw)
    theta = _theta()
    noise = jnoiser.sample_noise(jax.random.PRNGKey(seed), theta, pop, jcfg)
    fitness = np.random.default_rng(seed).standard_normal(pop).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, theta=theta, noise=noise, fitness=fitness, pop=pop,
                ttheta=tree_from_numpy(_np(theta), "cpu"), tnoise=tree_from_numpy(_np(noise), "cpu"))


def _close(t, j, **tol):
    tl, jl = tree_leaves(t), jax.tree_util.tree_leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), **(tol or TOL))


@pytest.mark.parametrize("pop, antithetic", [(1, True), (5, True), (8, True), (6, False)])
def test_member_maps_match_jax(pop, antithetic):
    js, jb = jnoiser.member_maps(pop, antithetic)
    ts, tb = noiser.member_maps(pop, antithetic, "cpu")
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert ts.dtype == torch.float32 and tb.dtype == torch.int64
    assert noiser.member_maps(pop, antithetic, "cpu")[0] is ts  # made once


@pytest.mark.parametrize("noise_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pop, antithetic, lo, n", [(8, True, 1, 2), (8, True, 0, 4), (6, False, 2, 3)])
def test_partial_delta_and_apply_match_jax(noise_dtype, pop, antithetic, lo, n):
    c = _case(pop, antithetic, noise_dtype)
    jcoeffs = jnoiser.fitness_coeffs(jnp.asarray(c["fitness"]), pop, c["jcfg"])
    tcoeffs = noiser.fitness_coeffs(torch.from_numpy(c["fitness"]), pop, c["cfg"])
    np.testing.assert_allclose(tcoeffs.numpy(), np.asarray(jcoeffs), **TOL)
    j = jnoiser.es_partial_delta(c["theta"], c["noise"], jcoeffs, lo, n, pop, c["jcfg"])
    t = noiser.es_partial_delta(c["ttheta"], c["tnoise"], tcoeffs, lo, n, pop, c["cfg"])
    assert all(x.dtype == torch.float32 for x in tree_leaves(t))
    _close(t, j)
    _close(noiser.apply_es_delta(c["ttheta"], t, c["tnoise"], pop, c["cfg"]),
           jnoiser.apply_es_delta(c["theta"], j, c["noise"], pop, c["jcfg"]))


@pytest.mark.parametrize("noise_dtype", ["float32", "bfloat16"])
def test_partials_of_a_cover_sum_to_the_update(noise_dtype):
    """Partials over a cover of the base samples, summed and applied: the
    JAX ``es_update`` within 1e-4; one shard over the whole range: the
    port's ``es_update`` bitwise."""
    c = _case(8, True, noise_dtype)
    cfg, pop = c["cfg"], c["pop"]
    coeffs = noiser.fitness_coeffs(torch.from_numpy(c["fitness"]), pop, cfg)
    parts = [noiser.es_partial_delta(c["ttheta"], c["tnoise"], coeffs, lo, 2, pop, cfg) for lo in (0, 2)]
    total = [a + b for a, b in zip(*(tree_leaves(p) for p in parts))]
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_replace_leaves

    got = noiser.apply_es_delta(c["ttheta"], tree_replace_leaves(c["ttheta"], total), c["tnoise"], pop, cfg)
    _close(got, jnoiser.es_update(c["theta"], c["noise"], jnp.asarray(c["fitness"]), pop, c["jcfg"]))
    whole = noiser.es_partial_delta(c["ttheta"], c["tnoise"], coeffs, 0, 4, pop, cfg)
    one = noiser.apply_es_delta(c["ttheta"], whole, c["tnoise"], pop, cfg)
    ref = noiser.es_update(c["ttheta"], c["tnoise"], torch.from_numpy(c["fitness"]), pop, cfg)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(one), tree_leaves(ref)))


_PLAN_TABLE = [(mode, pop, anti, n) for mode in ("auto", "on", "off") for pop, anti in ((8, True), (6, True),
                                                                                        (12, False), (7, True))
               for n in (1, 2, 4)] + [("always", 8, True, 2)]


@pytest.mark.parametrize("mode, pop, antithetic, n", _PLAN_TABLE)
def test_plan_matches_jax(mode, pop, antithetic, n):
    jm = jmesh.make_mesh({jmesh.POP_AXIS: n}, devices=jax.devices()[:n])

    def outcome(fn, *a):
        try:
            return fn(*a)
        except ValueError as e:
            return ("raises", str(e))

    ours = outcome(pop_update.pop_shard_update_plan, mode, pop, antithetic, n)
    theirs = outcome(jpop_update.pop_shard_update_plan, mode, pop, antithetic, jm)
    if ours[0] == "raises" and n == 1 and mode == "on":
        # the JAX text names its mesh, the port's its process group
        assert theirs[0] == "raises" and ours[1].startswith("pop_shard_update=on needs")
        assert theirs[1].startswith("pop_shard_update=on needs")
    else:
        assert ours == theirs
    # the default pop axis is the process group: one process here
    if n == 1:
        assert outcome(pop_update.pop_shard_update_plan, mode, pop, antithetic) == ours


_WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
from hyperscalees_t2i_tpu_torch.es.noiser import EggRollConfig
from hyperscalees_t2i_tpu_torch.parallel.collectives import process_count, process_rank
from hyperscalees_t2i_tpu_torch.parallel.mesh import initialize_multihost
from hyperscalees_t2i_tpu_torch.parallel.pop_update import make_sharded_es_update

assert initialize_multihost()
rank, n = process_rank(), process_count()
case = torch.load(sys.argv[1], weights_only=False)
outs = {}
for name, c in case.items():
    update = make_sharded_es_update(c["pop"], EggRollConfig(**c["cfg"]))
    assert update.n_pop == n and update.slice[0] == rank * update.slice[1]
    outs[name] = update(c["theta"], c["noise"], c["fitness"])
try:
    make_sharded_es_update(9, EggRollConfig(antithetic=True))  # base 5
    raise SystemExit("a base of 5 was split over the processes")
except ValueError as e:
    assert "does not tile the pop axis" in str(e), e
torch.save(outs, sys.argv[2] + f"/rank{rank}.pt")
print(f"rank{rank} ok", flush=True)
"""


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_update_matches_jax_and_is_identical_on_every_rank(tmp_path, n):
    cases = {f"{pop}-{anti}-{ndt}": _case(pop, anti, ndt, seed=n)
             for pop, anti, ndt in ((8, True, "float32"), (8, True, "bfloat16"), (8 * n // 2, False, "float32"))}
    torch.save({name: dict(pop=c["pop"], cfg=dict(sigma=0.05, lr_scale=1.5, rank=2, antithetic=c["cfg"].antithetic,
                                                   noise_dtype=c["cfg"].noise_dtype),
                           theta=c["ttheta"], noise=c["tnoise"], fitness=torch.from_numpy(c["fitness"]))
                for name, c in cases.items()}, tmp_path / "case.pt")
    outs = run_workers(n, _WORKER, [str(tmp_path / "case.pt"), str(tmp_path)], timeout_s=100)
    assert all(f"rank{r} ok" in outs[r] for r in range(n))
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(n)]
    jm = jmesh.make_mesh({jmesh.POP_AXIS: n}, devices=jax.devices()[:n])
    for name, c in cases.items():
        ref = jax.jit(jpop_update.make_sharded_es_update(jm, c["pop"], c["jcfg"]))(
            c["theta"], c["noise"], jnp.asarray(c["fitness"]))
        _close(got[0][name], ref)
        for r in range(1, n):
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got[r][name]), tree_leaves(got[0][name]))), \
                (name, r)
