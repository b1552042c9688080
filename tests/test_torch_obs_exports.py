"""The small public helpers (ROADMAP item 13), on the CPU.

- ``utils.tree_size`` and ``utils.tree_norms`` (re-exported lazily, as the
  JAX ``utils/__init__.py`` does) against the JAX helpers on the same
  trees: the size equal, the norm and mean |x| within 1e-6 (relative).
- ``hyperscalees_t2i_tpu_torch.obs`` in a fresh process: importing it
  loads no torch; its ``__all__`` is the JAX package's 63 names less the 8
  with no counterpart (the ``.xplane.pb`` readers and the XLA compile
  records), and each resolves; the 8 are absent. ``utils`` alone loads no
  torch either.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.utils import pytree as jpytree
from hyperscalees_t2i_tpu_torch import utils

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
NONE = {"build_xspace", "device_planes", "find_xplane_files", "load_xspace", "parse_xspace",
        "compile_cache_entries", "program_record", "record_compile"}


def _tree(seed, dtype):
    rng = np.random.default_rng(seed)
    return {"blocks": [{"a": rng.standard_normal((3, 5)).astype(dtype), "b": rng.standard_normal((5,)).astype(dtype)}
                       for _ in range(2)],
            "head": {"w": (rng.standard_normal((7, 2)) * 10).astype(dtype)}, "empty": {}}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, fn) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("seed,dtype", [(0, np.float32), (1, np.float32), (2, np.float16)])
def test_tree_size_and_norms_match_jax(seed, dtype):
    tree = _tree(seed, dtype)
    port = _to(tree, torch.from_numpy)
    ref = _to(tree, jnp.asarray)
    assert utils.tree_size(port) == jpytree.tree_size(ref) == 2 * (15 + 5) + 14
    got, want = utils.tree_norms(port), jpytree.tree_norms(ref)
    assert set(got) == set(want) == {"norm", "mean_abs"}
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=0)


def test_tree_norms_of_an_empty_tree():
    got, want = utils.tree_norms({}), jpytree.tree_norms({})
    assert utils.tree_size({}) == jpytree.tree_size({}) == 0
    assert float(got["norm"]) == float(want["norm"]) == 0.0
    assert float(got["mean_abs"]) == float(want["mean_abs"]) == 0.0


_CHECK = r"""
import sys
import hyperscalees_t2i_tpu_torch.obs as obs
import hyperscalees_t2i_tpu_torch.utils
print("TORCH_AFTER_IMPORT", "torch" in sys.modules)
print("ALL", " ".join(obs.__all__))
missing = [n for n in obs.__all__ if getattr(obs, n, None) is None]
print("MISSING", " ".join(missing) or "-")
present = [n for n in sys.argv[1:] if hasattr(obs, n)]
print("PRESENT", " ".join(present) or "-")
"""


def test_obs_exports_the_ported_names_without_importing_torch():
    src = (ROOT / "hyperscalees_t2i_tpu" / "obs" / "__init__.py").read_text()
    jax_names = set(re.findall(r'"(\w+)"', re.search(r"__all__ = \[(.*?)\]", src, re.S).group(1)))
    assert len(jax_names) == 63 and NONE <= jax_names
    out = subprocess.run([sys.executable, "-c", _CHECK, *sorted(NONE)], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert lines["TORCH_AFTER_IMPORT"] == "False"
    names = set(lines["ALL"].split())
    assert names == jax_names - NONE and len(names) == 55
    assert lines["MISSING"] == "-" and lines["PRESENT"] == "-"
