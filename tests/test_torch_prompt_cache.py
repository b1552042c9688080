"""The Sana encoded-prompt cache in the port against the JAX package.

- ``.npz`` and ``.pt`` caches written by the JAX ``save_sana_cache`` load
  to the same prompts, embeddings and mask through both packages, with the
  same ``content_sha256``; a second load of the same bytes is a warm hit
  (the same payload object, ``prompt_cache_warm_hits`` ticked).
- The port's writer makes files the JAX loader reads to the same arrays.
- A Sana backend given ``encoded_prompt_path`` (both modes) takes its
  catalog from the cache, as the JAX backend does.
"""

import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.backends.sana_backend import SanaBackend as JSanaBackend
from hyperscalees_t2i_tpu.backends.sana_backend import SanaBackendConfig as JSanaBackendConfig
from hyperscalees_t2i_tpu.models import dcae as jdcae
from hyperscalees_t2i_tpu.models import sana as jsana
from hyperscalees_t2i_tpu.utils import prompt_cache as jpc
from hyperscalees_t2i_tpu_torch.backends.sana_backend import SanaBackend, SanaBackendConfig
from hyperscalees_t2i_tpu_torch.models import dcae, sana
from hyperscalees_t2i_tpu_torch.obs.metrics import MetricsRegistry, set_registry
from hyperscalees_t2i_tpu_torch.utils import prompt_cache as pc

torch.set_num_threads(1)
PROMPTS = ["a cat", "a dog on a skateboard", "a man in the rain"]


def _payload(seed=3, L=5, D=12):
    rng = np.random.RandomState(seed)
    emb = rng.randn(len(PROMPTS), L, D).astype(np.float32)
    mask = np.ones((len(PROMPTS), L), bool)
    mask[1, 3:] = False
    return emb, mask


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_sana_cache_written_by_jax_loads_identically(tmp_path, suffix):
    reg = set_registry(MetricsRegistry())
    path = str(tmp_path / "sub" / f"sana_cache{suffix}")
    emb, mask = _payload()
    jpc.save_sana_cache(path, PROMPTS, emb, mask)
    data = pc.load_cache(path, "sana_pipeline")
    jdata = jpc.load_cache(path, "sana_one_step")
    assert [str(p) for p in data["prompts"]] == [str(p) for p in jdata["prompts"]] == PROMPTS
    np.testing.assert_array_equal(data["prompt_embeds"], jdata["prompt_embeds"])
    np.testing.assert_array_equal(data["prompt_attention_mask"], jdata["prompt_attention_mask"])
    np.testing.assert_array_equal(data["prompt_embeds"], emb)
    np.testing.assert_array_equal(np.asarray(data["prompt_attention_mask"], bool), mask)
    assert data["content_sha256"] == jdata["content_sha256"] == pc.file_sha256(path) == jpc.file_sha256(path)
    assert data["cache_backend"] == jdata["cache_backend"] == "sana"
    # the same bytes again: the warm memo's payload, one hit counted
    assert reg.value("prompt_cache_warm_hits") == 0
    assert pc.load_cache(path, "sana_one_step") is data
    assert reg.value("prompt_cache_warm_hits") == 1


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_port_writer_is_read_by_jax(tmp_path, suffix):
    path = str(tmp_path / f"port{suffix}")
    emb, mask = _payload(seed=4)
    pc.save_sana_cache(path, PROMPTS, emb, mask)
    again = jpc.load_sana_cache(path)
    assert [str(p) for p in again["prompts"]] == PROMPTS
    np.testing.assert_array_equal(again["prompt_embeds"], emb)
    np.testing.assert_array_equal(np.asarray(again["prompt_attention_mask"], bool), mask)
    np.testing.assert_array_equal(pc.load_sana_cache(path)["prompt_embeds"], emb)


@pytest.mark.parametrize("mode", ["one_step", "pipeline"])
def test_backend_takes_its_catalog_from_the_cache(tmp_path, mode):
    kw = dict(in_channels=4, out_channels=4, d_model=16, n_layers=1, n_heads=2, cross_n_heads=2, caption_dim=12,
              ff_ratio=2.0)
    vkw = dict(latent_channels=4, channels=(8, 8), blocks_per_stage=(1, 1), attn_stages=())
    path = str(tmp_path / "cache.npz")
    emb, mask = _payload()
    jpc.save_sana_cache(path, PROMPTS, emb, mask)
    jb = JSanaBackend(JSanaBackendConfig(backend_mode=mode, model=jsana.SanaConfig(**kw),
                                         vae=jdcae.DCAEConfig(**vkw), encoded_prompt_path=path))
    jb.setup()
    tb = SanaBackend(SanaBackendConfig(backend_mode=mode, model=sana.SanaConfig(**kw), vae=dcae.DCAEConfig(**vkw),
                                       encoded_prompt_path=path), "cpu")
    tb.setup()
    assert tb.prompts == [str(p) for p in jb.prompts] == PROMPTS and tb.num_items == 3
    np.testing.assert_array_equal(tb.prompt_embeds.numpy(), np.asarray(jb.prompt_embeds))
    np.testing.assert_array_equal(tb.prompt_mask.numpy(), np.asarray(jb.prompt_mask))
    assert tb.prompt_cache_sha == jb.prompt_cache_sha
    assert tb.name == jb.name == f"sana_{mode}"
