"""The port's prompt encoder (``tools/encode_prompts.py``) against the JAX
package's on the CPU.

- The hash fallback: the same cache keys, prompts and masks (bitwise), the
  embeddings within 1e-6 (the noise stream's normal bound; measured
  2.4e-7).
- Caches the port writes load in the JAX loaders and the reverse, for the
  ``sana``, ``zimage`` and ``infinity`` formats (bitwise: one file, two
  readers).
- The Hugging Face branch on tiny encoder directories the test writes (a
  BERT-style model with its ``vocab.txt``, and a T5 encoder-decoder whose
  ``tokenizer_config.json`` names that tokenizer): the port at
  ``device="cpu"`` is bitwise the JAX ``encode_hf`` (both run the same
  library on the same weights).
- The fallback needs its flag; ``--enable_positive_prompt`` gives the JAX
  package's prompts; no card and no ``--device cpu`` raises.
"""

import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.tools import encode_prompts as jep
from hyperscalees_t2i_tpu.utils import prompt_cache as jpc
from hyperscalees_t2i_tpu_torch.tools import encode_prompts as ep
from hyperscalees_t2i_tpu_torch.utils import prompt_cache as pc

torch.set_num_threads(1)
NORMAL_TOL = 1e-6
PROMPTS = ["a red square", "a portrait of a woman", "two dogs on a beach at dusk", "x"]
TSV = ("Prompt\tCategory\tChallenge\na red square\tAbstract\tSimple\n\tEmpty\tSimple\n"
       "a boy on a bike\tPeople\tSimple\n")
HASH = ["--encoder", "definitely/not-a-cached-model", "--fallback", "hash"]
LOADERS = {"sana": ("load_sana_cache", "prompt_embeds", "prompt_attention_mask"),
           "zimage": ("load_zimage_cache", "prompt_embeds", "prompt_mask"),
           "infinity": ("load_infinity_cache", "text_emb", "text_mask")}


@pytest.fixture
def prompts_txt(tmp_path):
    path = tmp_path / "p.txt"
    path.write_text("# comment\n" + "\n".join(PROMPTS) + "\n")
    return path


def test_hash_fallback_matches_jax(tmp_path, prompts_txt):
    argv = ["--prompts", str(prompts_txt), "--format", "sana", *HASH, "--dim", "32"]
    ep.main([*argv, "--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    jep.main([*argv, "--out", str(tmp_path / "jax.npz")])
    ours, theirs = (np.load(tmp_path / f"{tag}.npz", allow_pickle=True) for tag in ("port", "jax"))
    assert sorted(ours.files) == sorted(theirs.files)
    assert list(ours["prompts"]) == list(theirs["prompts"]) == PROMPTS
    np.testing.assert_array_equal(ours["prompt_attention_mask"], theirs["prompt_attention_mask"])
    assert ours["prompt_embeds"].shape == theirs["prompt_embeds"].shape == (4, 64, 32)
    err = float(np.abs(ours["prompt_embeds"] - theirs["prompt_embeds"]).max())
    assert err <= NORMAL_TOL, err
    # the function alone, and deterministic
    a = ep.encode_hash_fallback(PROMPTS, 12, 8, device="cpu")
    b = jep.encode_hash_fallback(PROMPTS, 12, 8)
    np.testing.assert_array_equal(a[1], b[1])
    assert np.abs(a[0] - b[0]).max() <= NORMAL_TOL
    np.testing.assert_array_equal(a[0], ep.encode_hash_fallback(PROMPTS, 12, 8, device="cpu")[0])


@pytest.mark.parametrize("fmt", ["sana", "zimage", "infinity"])
def test_caches_load_in_both_packages(tmp_path, prompts_txt, fmt):
    loader, emb, mask = LOADERS[fmt]
    argv = ["--prompts", str(prompts_txt), "--format", fmt, *HASH, "--dim", "12"]
    ep.main([*argv, "--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    jep.main([*argv, "--out", str(tmp_path / "jax.npz")])
    for path in (tmp_path / "port.npz", tmp_path / "jax.npz"):
        ours, theirs = getattr(pc, loader)(str(path)), getattr(jpc, loader)(str(path))
        assert list(ours["prompts"]) == list(theirs["prompts"]) == PROMPTS
        np.testing.assert_array_equal(np.asarray(ours[emb]), np.asarray(theirs[emb]))
        np.testing.assert_array_equal(np.asarray(ours[mask]), np.asarray(theirs[mask]))


def test_tsv_prompts_as_jax(tmp_path):
    tsv = tmp_path / "parti.tsv"
    tsv.write_text(TSV)
    assert pc.load_partiprompts_tsv(str(tsv)) == jpc.load_partiprompts_tsv(str(tsv)) == ["a red square",
                                                                                         "a boy on a bike"]
    argv = ["--tsv", str(tsv), "--format", "infinity", *HASH, "--dim", "8", "--enable_positive_prompt"]
    ep.main([*argv, "--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    jep.main([*argv, "--out", str(tmp_path / "jax.npz")])
    ours, theirs = pc.load_infinity_cache(str(tmp_path / "port.npz")), jpc.load_infinity_cache(
        str(tmp_path / "jax.npz"))
    assert ours["prompts"] == theirs["prompts"]
    assert ours["prompts"] == ["a red square", "a boy on a bike" + pc.POSITIVE_PROMPT_SUFFIX]


def _bert_dir(root):
    from transformers import BertConfig, BertModel, BertTokenizer

    words = sorted({w for p in PROMPTS for w in p.split()})
    vocab = root / "vocab.txt"
    root.mkdir()
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *words]) + "\n")
    n = len(words) + 5
    torch.manual_seed(0)
    BertModel(BertConfig(vocab_size=n, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                         intermediate_size=32, max_position_embeddings=32)).save_pretrained(root)
    BertTokenizer(str(vocab)).save_pretrained(root)
    return root, n


def _t5_dir(root, bert):
    """A T5 encoder-decoder whose tokenizer is the BERT directory's."""
    from transformers import BertTokenizer, T5Config, T5Model

    src, n = bert
    torch.manual_seed(1)
    T5Model(T5Config(vocab_size=n, d_model=16, d_kv=8, d_ff=32, num_layers=1, num_heads=2,
                     decoder_start_token_id=0, pad_token_id=0)).save_pretrained(root)
    BertTokenizer(str(src / "vocab.txt")).save_pretrained(root)
    return root


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("enc")
    bert = _bert_dir(tmp / "bert")
    return {"bert": bert[0], "t5": _t5_dir(tmp / "t5", bert)}


@pytest.mark.parametrize("kind", ["bert", "t5"])
def test_hf_encoder_bitwise_jax(encoders, kind):
    path = str(encoders[kind])
    ours = ep.encode_hf(PROMPTS, path, max_length=12, batch_size=3, device="cpu")
    theirs = jep.encode_hf(PROMPTS, path, max_length=12, batch_size=3)
    assert ours[0].shape == theirs[0].shape == (4, 12, 16) and ours[0].dtype == np.float32
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert ours[1][:, 0].all() and not ours[1].all()


def test_hf_encoder_through_main_writes_the_jax_cache(tmp_path, prompts_txt, encoders):
    argv = ["--prompts", str(prompts_txt), "--format", "zimage", "--encoder", str(encoders["bert"]),
            "--max_length", "10"]
    ep.main([*argv, "--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    jep.main([*argv, "--out", str(tmp_path / "jax.npz")])
    ours, theirs = (np.load(tmp_path / f"{tag}.npz", allow_pickle=True) for tag in ("port", "jax"))
    assert sorted(ours.files) == sorted(theirs.files)
    for k in ours.files:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_an_unavailable_encoder_needs_the_fallback_flag(tmp_path, prompts_txt):
    base = ["--prompts", str(prompts_txt), "--format", "sana", "--out", str(tmp_path / "c.npz"), "--device", "cpu",
            "--encoder", "definitely/not-a-cached-model"]
    with pytest.raises(SystemExit, match="unavailable"):
        ep.main(base)
    with pytest.raises(SystemExit, match="needs --dim"):
        ep.main([*base, "--fallback", "hash"])
    with pytest.raises(SystemExit, match="exactly one of"):
        ep.main(["--format", "sana", "--out", str(tmp_path / "c.npz"), "--device", "cpu"])
    assert not (tmp_path / "c.npz").exists()


def test_encoding_needs_a_card_or_the_cpu(tmp_path, prompts_txt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ep.main(["--prompts", str(prompts_txt), "--format", "sana", "--out", str(tmp_path / "c.npz"), *HASH,
                 "--dim", "8"])
