"""Ring attention of the port (``ops/ring_attention.py``, the sequence
sharded over a gloo group) and Z-Image's attention through it, against the
JAX package on the CPU (``tests/test_ring.py``'s cases).

- At sp 2 and 4 (gloo launches of 2 and 4 CPU processes): the port's
  ``ring_attention`` within 1e-4 of the JAX ``ring_attention`` over a mesh
  of the same size on the forced CPU devices and of the naive masked
  attention, with ragged masks, without a mask, and with ``KV_CHUNK``
  patched to 4 so the chunks pad (L 28); every rank returns the same whole
  sequence.
- ``zimage.ZImageTransformer`` with ``sp_group`` at sp 4 within 1e-4 of the
  port's plain forward and of the JAX ``forward(sp_mesh=)``, and
  ``generate_latents`` with CFG through the ring within 1e-4 of the plain
  sampler.
- A length the group does not divide raises with the JAX text.

The errors measured are printed.
"""

import importlib
import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.models import zimage as jzimage
from hyperscalees_t2i_tpu.ops.attention import _naive_masked_attention
from hyperscalees_t2i_tpu.ops.ring_attention import ring_attention as jring_attention
from hyperscalees_t2i_tpu.parallel import make_mesh as jmake_mesh
from hyperscalees_t2i_tpu_torch.models import zimage
from hyperscalees_t2i_tpu_torch.ops import ring_attention as ra

from _torch_gloo import run_workers

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(L, seed, B=2, H=2, dh=8):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, L, H, dh).astype(np.float32) for _ in range(3)]


def _ragged(L):
    return np.stack([np.arange(L) < L - 1, np.arange(L) < L - (L // 4)])


# name: (L, mask, KV_CHUNK)
CASES = {"ragged": (16, True, None), "no_mask": (16, False, None), "chunk_pad": (28, True, 4)}

WORKER = r"""
import pickle, sys
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
from hyperscalees_t2i_tpu_torch.models import zimage
from hyperscalees_t2i_tpu_torch.ops import ring_attention as ra
from hyperscalees_t2i_tpu_torch.parallel.collectives import process_rank
from hyperscalees_t2i_tpu_torch.parallel.mesh import initialize_multihost
from hyperscalees_t2i_tpu_torch.weights.from_jax import tree_from_numpy

src, out = sys.argv[1:3]
d = pickle.load(open(src, "rb"))
initialize_multihost()
T = torch.from_numpy
res = {}
for name, (q, k, v, mask, chunk) in d["cases"].items():
    ra.KV_CHUNK = chunk or 512
    res[name] = ra.ring_attention(T(q), T(k), T(v), kv_mask=None if mask is None else T(mask)).numpy()
ra.KV_CHUNK = 512
if "zimage" in d:
    s = d["zimage"]
    model = zimage.ZImageTransformer(s["cfg"], tree_from_numpy(s["params"], "cpu"))
    world = dist.group.WORLD
    with torch.inference_mode():
        args = [T(a) for a in s["inputs"]]
        res["forward_plain"] = model(*args).numpy()
        res["forward_sp"] = model(*args, sp_group=world).numpy()
        emb, mask, noise = (T(a) for a in s["gen"])
        kw = dict(num_steps=2, guidance_scale=1.5)
        res["gen_plain"] = zimage.generate_latents(model, emb, mask, noise, **kw).numpy()
        res["gen_sp"] = zimage.generate_latents(model, emb, mask, noise, sp_group=world, **kw).numpy()
res["stats"] = {k: v[0] for k, v in ra.RING_STATS.items()}
pickle.dump(res, open(f"{out}.{process_rank()}", "wb"))
"""


def _zimage_case():
    kw = dict(in_channels=4, patch_size=2, d_model=24, n_layers=2, n_heads=2, caption_dim=12, ff_ratio=2.0)
    jcfg = jzimage.ZImageConfig(**kw, compute_dtype=jnp.float32)
    params = jzimage.init_zimage(jax.random.PRNGKey(0), jcfg)
    rs = np.random.RandomState(1)
    B, h, w, Lt = 2, 8, 8, 8  # S = 8 + 16 = 24
    inputs = (rs.randn(B, h, w, 4).astype(np.float32), np.array([0.3, 0.8], np.float32),
              rs.randn(B, Lt, 12).astype(np.float32), np.stack([np.arange(Lt) < 5, np.arange(Lt) < Lt]))
    gen = (inputs[2], inputs[3], rs.randn(B, h, w, 4).astype(np.float32))
    jplain = np.asarray(jzimage.forward(params, jcfg, *(jnp.asarray(a) for a in inputs)))
    jsp = np.asarray(jzimage.forward(params, jcfg, *(jnp.asarray(a) for a in inputs), sp_mesh=jmake_mesh({"sp": 4})))
    port = dict(cfg=zimage.ZImageConfig(**kw, compute_dtype=torch.float32),
                params=jax.tree_util.tree_map(np.asarray, params), inputs=inputs, gen=gen)
    return port, jplain, jsp


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    out, refs = {}, {}
    zport, jplain, jsp = _zimage_case()
    refs["zimage"] = (jplain, jsp)
    for n in (2, 4):
        cases = {}
        for name, (L, masked, chunk) in CASES.items():
            q, k, v = _qkv(L, seed=L + n)
            mask = _ragged(L) if masked else None
            cases[name] = (q, k, v, mask, chunk)
            jmask = jnp.asarray(mask if masked else np.ones((2, L), bool))
            naive = np.asarray(_naive_masked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=None,
                                                       kv_mask=jmask, sm_scale=1.0 / math.sqrt(q.shape[-1])))
            # the package re-exports the function under the module's name
            jmod = importlib.import_module("hyperscalees_t2i_tpu.ops.ring_attention")
            old, jmod.KV_CHUNK = jmod.KV_CHUNK, chunk or jmod.KV_CHUNK
            try:
                jring = np.asarray(jmod.ring_attention(*(jnp.asarray(a) for a in (q, k, v)), jmake_mesh({"sp": n}),
                                                       "sp", kv_mask=jmask if masked else None))
            finally:
                jmod.KV_CHUNK = old
            refs[(n, name)] = (naive, jring)
        src = tmp / f"in{n}.pkl"
        src.write_bytes(pickle.dumps({"cases": cases, **({"zimage": zport} if n == 4 else {})}))
        run_workers(n, WORKER, [str(src), str(tmp / f"out{n}")], timeout_s=180)
        out[n] = [pickle.loads((tmp / f"out{n}.{i}").read_bytes()) for i in range(n)]
    return out, refs


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_and_naive(launches, n, name):
    out, refs = launches
    got = out[n][0][name]
    assert all(np.array_equal(got, r[name]) for r in out[n][1:])  # every rank the whole sequence
    naive, jring = refs[(n, name)]
    e_naive, e_jax = float(np.abs(got - naive).max()), float(np.abs(got - jring).max())
    print(f"sp {n} {name}: max |ring - naive| {e_naive:.3g}, max |ring - JAX ring| {e_jax:.3g}")
    np.testing.assert_allclose(got, naive, **TOL)
    np.testing.assert_allclose(got, jring, **TOL)
    assert out[n][0]["stats"]["ppermute"] > 0


def test_zimage_forward_and_sampler_with_an_sp_group(launches):
    out, refs = launches
    r = out[4][0]
    jplain, jsp = refs["zimage"]
    for label, ref in (("port plain", r["forward_plain"]), ("JAX sp", jsp)):
        print(f"zimage sp 4 forward against {label}: max abs {float(np.abs(r['forward_sp'] - ref).max()):.3g}")
    np.testing.assert_allclose(r["forward_sp"], r["forward_plain"], **TOL)
    np.testing.assert_allclose(r["forward_sp"], jsp, **TOL)
    np.testing.assert_allclose(r["forward_plain"], jplain, **TOL)
    print(f"zimage sp 4 sampler: max |ring - plain| {float(np.abs(r['gen_sp'] - r['gen_plain']).max()):.3g}")
    np.testing.assert_allclose(r["gen_sp"], r["gen_plain"], **TOL)


def test_an_indivisible_length_raises_with_the_jax_text(monkeypatch):
    monkeypatch.setattr(ra, "axis_size", lambda group=None: 4)
    x = torch.zeros(1, 10, 2, 8)
    with pytest.raises(ValueError, match="sequence length 10 not divisible by sp=4"):
        ra.ring_attention(x, x, x)
    with pytest.raises(ValueError, match="not divisible"):
        jring_attention(jnp.zeros((1, 10, 2, 8)), jnp.zeros((1, 10, 2, 8)), jnp.zeros((1, 10, 2, 8)),
                        jmake_mesh({"sp": 4}), "sp")
