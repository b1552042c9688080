"""The port's Hugging Face CLIP converter and the Hugging Face branch of
``tokenize_with_hf`` against the JAX package's.

- A tiny random ``transformers.CLIPModel`` (built from a ``CLIPConfig`` in
  the test: nothing is downloaded), both activations: its state dict
  through both ``convert_hf_clip_state_dict`` gives bitwise-equal trees;
  the port's image and text features on the converted tree are within 1e-4
  of the JAX package's (measured ≤ 7.2e-7 and ≤ 1.2e-6) and of the HF
  model's (measured ≤ 5.1e-7 and ≤ 9.6e-7).
- ``train.cli.load_clip_tower`` converts a saved model directory as the JAX
  CLI does, and gives ``None`` for a model that is not there.
- A CLIP tokenizer directory the test writes (``vocab.json``,
  ``merges.txt``): both packages' ``tokenize_with_hf`` give equal ids,
  EOT positions and masks, and without it both give the hash fallback.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.models import clip as jclip
from hyperscalees_t2i_tpu.rewards.suite import tokenize_with_hf as jtokenize
from hyperscalees_t2i_tpu_torch.models import clip
from hyperscalees_t2i_tpu_torch.rewards.suite import tokenize_with_hf
from hyperscalees_t2i_tpu_torch.weights.from_jax import clip_from_jax

from test_torch_weights_var import assert_trees_bitwise

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)
PRIM_TOL = 1e-4


def tiny_hf(act, seed=0):
    hf_cfg = transformers.CLIPConfig(
        text_config={"hidden_size": 24, "intermediate_size": 48, "num_hidden_layers": 2, "num_attention_heads": 4,
                     "vocab_size": 100, "max_position_embeddings": 16, "hidden_act": act, "eos_token_id": 99},
        vision_config={"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
                       "image_size": 32, "patch_size": 8, "hidden_act": act},
        projection_dim=20)
    torch.manual_seed(seed)
    return transformers.CLIPModel(hf_cfg).eval()


def configs(act):
    kw = dict(image_size=32, patch_size=8, vocab_size=100, max_positions=16, projection_dim=20, hidden_act=act)
    return (clip.CLIPConfig(vision=clip.CLIPTowerConfig(32, 2, 4, 64), text=clip.CLIPTowerConfig(24, 2, 4, 48),
                            compute_dtype=torch.float32, **kw),
            jclip.CLIPConfig(vision=jclip.CLIPTowerConfig(32, 2, 4, 64), text=jclip.CLIPTowerConfig(24, 2, 4, 48),
                             **kw))


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_convert_bitwise_and_features(act):
    hf = tiny_hf(act)
    cfg, jcfg = configs(act)
    tree = clip.convert_hf_clip_state_dict(hf.state_dict(), cfg)
    ref = jclip.convert_hf_clip_state_dict(hf.state_dict(), jcfg)
    assert assert_trees_bitwise(tree, ref) == 46
    # numpy inputs convert the same way
    assert_trees_bitwise(clip.convert_hf_clip_state_dict({k: v.numpy() for k, v in hf.state_dict().items()}, cfg),
                         ref)
    model = clip_from_jax(tree, cfg, "cpu")
    pixels = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    ids = np.array([[1, 5, 7, 99, 0, 0, 0, 0], [1, 8, 42, 17, 99, 0, 0, 0]], np.int64)
    mask = ids != 0
    with torch.no_grad():
        img = clip.image_features(model, torch.from_numpy(pixels.transpose(0, 2, 3, 1))).numpy()
        txt = clip.text_features(model, torch.from_numpy(ids.astype(np.int32)),
                                 attention_mask=torch.from_numpy(mask)).numpy()
        hf_img = hf.get_image_features(pixel_values=torch.from_numpy(pixels)).numpy()
        hf_txt = hf.get_text_features(input_ids=torch.from_numpy(ids),
                                      attention_mask=torch.from_numpy(mask.astype(np.int64))).numpy()
    j_img = np.asarray(jclip.image_features(ref, jcfg, jnp.asarray(pixels.transpose(0, 2, 3, 1))))
    j_txt = np.asarray(jclip.text_features(ref, jcfg, jnp.asarray(ids.astype(np.int32)),
                                           attention_mask=jnp.asarray(mask)))
    for got, want in ((img, j_img), (txt, j_txt), (img, hf_img), (txt, hf_txt)):
        assert float(np.abs(got - want).max()) <= PRIM_TOL


def test_load_clip_tower_reads_a_saved_model(tmp_path):
    from hyperscalees_t2i_tpu_torch.train import cli

    hf = tiny_hf("quick_gelu", seed=1)
    hf.save_pretrained(tmp_path / "clip")
    cfg, jcfg = configs("quick_gelu")
    tree = cli.load_clip_tower(str(tmp_path / "clip"), cfg, torch.device("cpu"))
    assert_trees_bitwise(tree, jclip.convert_hf_clip_state_dict(hf.state_dict(), jcfg))
    assert cli.load_clip_tower(str(tmp_path / "missing"), cfg, torch.device("cpu")) is None


def write_clip_tokenizer(root):
    """A CLIP BPE tokenizer directory: single letters, a few merges, the
    start and end tokens (the end token the largest id, as in CLIP's
    vocabulary)."""
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    tokens = ["!"] + letters + [x + "</w>" for x in letters]
    merges = [("c", "a"), ("ca", "t</w>"), ("r", "e"), ("re", "d</w>"), ("a", "n</w>")]
    tokens += ["".join(m) for m in merges] + ["<|startoftext|>", "<|endoftext|>"]
    root.mkdir()
    (root / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(tokens)}))
    (root / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    (root / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "CLIPTokenizer", "model_max_length": 77, "bos_token": "<|startoftext|>",
        "eos_token": "<|endoftext|>", "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>"}))
    return len(tokens)


def test_tokenize_with_hf_branch_matches_jax(tmp_path):
    n = write_clip_tokenizer(tmp_path / "tok")
    prompts = ["a red cat", "an owl", "cat " * 90]  # the last one is cut at 77 tokens
    ids, eot, mask = tokenize_with_hf(prompts, str(tmp_path / "tok"))
    jids, jeot, jmask = (np.asarray(a) for a in jtokenize(prompts, str(tmp_path / "tok")))
    assert ids.dtype == torch.int32 and eot.dtype == torch.int32 and mask.dtype == torch.bool
    assert tuple(ids.shape) == (3, 77) and np.array_equal(ids.numpy(), jids)
    assert np.array_equal(eot.numpy(), jeot) and np.array_equal(mask.numpy(), jmask)
    assert int(ids[0, 0]) == n - 2 and int(ids[0].max()) == n - 1  # BOS, and EOT the largest id
    assert not mask[0].all() and mask[2].all()  # padded, and cut to 77
    # no tokenizer there: both fall back to the same hash tokenizer
    fb, jfb = tokenize_with_hf(prompts, str(tmp_path / "none")), jtokenize(prompts, str(tmp_path / "none"))
    for a, b in zip(fb, jfb):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert int(fb[0][0, 1 + len(prompts[0].split())]) == 49407
