"""The port's ImageNet labels (``utils/imagenet_labels.py``) and the VAR
backend's class names against the JAX package's on the CPU.

- A 1000-line file gives both packages the same list; a missing file raises
  ``FileNotFoundError`` without ``download_if_missing`` and the reference's
  ``RuntimeError`` text with it (the port never downloads; the JAX side's
  fetch is made to fail by a monkeypatched ``urlretrieve``, so neither
  package reaches the network); a wrong line count raises in both.
- ``load_class_names`` in the JAX branch order: an explicit file with
  enough names, else at 1000 classes the file at ``DEFAULT_LABELS_PATH``
  (monkeypatched to a ``tmp_path`` file in both packages), else
  ``class_{i}`` with the reference's warning. The VAR backend's prompts are
  equal strings in both packages (exact: no tolerance applies to text).
"""

import pytest
import torch

from hyperscalees_t2i_tpu.backends import var_backend as jvar_backend
from hyperscalees_t2i_tpu.models import var as jvar
from hyperscalees_t2i_tpu.utils import imagenet_labels as jil
from hyperscalees_t2i_tpu_torch.backends import var_backend
from hyperscalees_t2i_tpu_torch.models import var
from hyperscalees_t2i_tpu_torch.utils import imagenet_labels as il

torch.set_num_threads(1)


def _labels(path, n=1000, prefix="name"):
    path.write_text("\n".join(f"{prefix}{i}" for i in range(n)) + "\n")
    return path


@pytest.fixture
def offline(monkeypatch):
    def boom(*a, **k):
        raise OSError("no egress")

    monkeypatch.setattr("urllib.request.urlretrieve", boom)


def test_labels_from_a_file_match_jax(tmp_path):
    path = _labels(tmp_path / "labels.txt")
    ours = il.get_imagenet_labels(labels_path=path, use_cache=False)
    assert ours == jil.get_imagenet_labels(labels_path=path, use_cache=False)
    assert len(ours) == 1000 and ours[3] == "name3"
    assert il.imagenet_class_name(5, labels_path=path, use_cache=False) == "name5"
    assert il.imagenet_class_name(1000, labels_path=path, use_cache=False) == "class_1000"
    # the in-process cache returns the same list for the same resolved path
    assert il.get_imagenet_labels(labels_path=path) is il.get_imagenet_labels(labels_path=str(path))


def test_missing_file_raises_as_the_reference_offline(tmp_path, offline):
    missing = tmp_path / "nope.txt"
    for mod in (il, jil):
        with pytest.raises(FileNotFoundError, match="not found"):
            mod.get_imagenet_labels(labels_path=missing, download_if_missing=False, use_cache=False)
    with pytest.raises(RuntimeError) as ours:
        il.get_imagenet_labels(labels_path=missing, use_cache=False)
    with pytest.raises(RuntimeError) as theirs:
        jil.get_imagenet_labels(labels_path=missing, use_cache=False)
    for e in (ours, theirs):
        text = str(e.value)
        assert text.startswith(f"could not download ImageNet labels from {il.IMAGENET_LABELS_URL}")
        assert "--labels_path" in text and str(missing.resolve()) in text
    assert not missing.exists()


@pytest.mark.parametrize("n", [999, 1001])
def test_wrong_line_count_raises_in_both(tmp_path, n):
    path = _labels(tmp_path / "labels.txt", n)
    for mod in (il, jil):
        with pytest.raises(RuntimeError, match=f"expected 1000 ImageNet labels, got {n}"):
            mod.get_imagenet_labels(labels_path=path, use_cache=False)


def _prompts(tmp_path, monkeypatch, default, labels_path=None, num_classes=1000):
    monkeypatch.setattr(il, "DEFAULT_LABELS_PATH", default)
    monkeypatch.setattr(jil, "DEFAULT_LABELS_PATH", default)
    ours = var_backend.VarBackend(var_backend.VarBackendConfig(
        model=var.VARConfig(num_classes=num_classes), labels_path=labels_path), "cpu").prompts
    theirs = jvar_backend.VarBackend(jvar_backend.VarBackendConfig(
        model=jvar.VARConfig(num_classes=num_classes), labels_path=labels_path)).prompts
    return ours, theirs


def test_var_1000_classes_read_the_default_labels_file_as_jax(tmp_path, monkeypatch):
    default = _labels(tmp_path / "imagenet_classes.txt", prefix="tench")
    ours, theirs = _prompts(tmp_path, monkeypatch, default)
    assert ours == theirs
    assert ours[0] == "a photo of tench0" and len(ours) == 1000


def test_explicit_labels_file_wins_over_the_default(tmp_path, monkeypatch):
    default = _labels(tmp_path / "imagenet_classes.txt", prefix="default")
    explicit = _labels(tmp_path / "mine.txt", prefix="mine")
    ours, theirs = _prompts(tmp_path, monkeypatch, default, labels_path=str(explicit))
    assert ours == theirs and ours[7] == "a photo of mine7"
    # a file shorter than the class count falls through to the default list
    short = _labels(tmp_path / "short.txt", 10, prefix="short")
    ours, theirs = _prompts(tmp_path, monkeypatch, default, labels_path=str(short))
    assert ours == theirs and ours[7] == "a photo of default7"


def test_missing_default_falls_back_to_placeholders_with_a_warning(tmp_path, monkeypatch, offline, capsys):
    ours, theirs = _prompts(tmp_path, monkeypatch, tmp_path / "absent" / "imagenet_classes.txt")
    assert ours == theirs and ours[:2] == ["a photo of class_0", "a photo of class_1"]
    out = capsys.readouterr().out
    assert out.count("[var] WARNING: could not download ImageNet labels") == 2
    assert out.count("using class_<i> placeholder names") == 2


def test_toy_class_counts_skip_the_labels_file(tmp_path, monkeypatch, capsys):
    ours, theirs = _prompts(tmp_path, monkeypatch, _labels(tmp_path / "imagenet_classes.txt"), num_classes=10)
    assert ours == theirs == [f"a photo of class_{i}" for i in range(10)]
    assert "WARNING" not in capsys.readouterr().out
