"""Rules of the PyTorch port that hold on any machine.

- Importing every module of ``hyperscalees_t2i_tpu_torch`` loads neither
  ``jax`` nor any module of the JAX package (checked in a fresh process),
  and no source line of the port or of ``chip_smoke.py`` imports them.
- Entry points default to the CUDA card and raise without one; the CPU is
  used only when named.
- A tensor that is not on the CPU never reaches the plain version of the
  kernel.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hyperscalees_t2i_tpu_torch.device import resolve_device
from hyperscalees_t2i_tpu_torch.ops import _build
from hyperscalees_t2i_tpu_torch.ops.quant_mm import int8_matmul

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "hyperscalees_t2i_tpu_torch"

_CHECK = r"""
import importlib, pkgutil, sys
import hyperscalees_t2i_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "hyperscalees_t2i_tpu"
             or n.startswith("hyperscalees_t2i_tpu."))
print("LOADED", len([n for n in sys.modules if n.startswith("hyperscalees_t2i_tpu_torch")]))
print("BAD", bad)
print("MISSING", sorted(set(sys.argv[1:]) - set(sys.modules)))
"""
# modules the walk must reach (the slices' models, backends and caches among them)
_REQUIRED = ["hyperscalees_t2i_tpu_torch." + m for m in (
    "models.var", "models.msvq", "models.bsq", "models.infinity", "backends.var_backend",
    "backends.infinity_backend", "utils.prompt_cache", "utils.threefry", "train.cli",
    "serve.admission", "serve.overload", "serve.engine", "obs.slo", "obs.exporter", "utils.stats",
    "resilience.telemetry", "tools.loadgen", "tools.dispatch_tax")]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _CHECK, *_REQUIRED], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "MISSING []" in out.stdout, out.stdout
    assert int(re.search(r"LOADED (\d+)", out.stdout).group(1)) >= 20


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"])
def test_no_source_line_imports_jax(path):
    pat = re.compile(r"^\s*(import|from)\s+(jax|hyperscalees_t2i_tpu)(\.|\s|$)")
    lines = (ROOT / path).read_text().splitlines()
    assert [l for l in lines if pat.match(l)] == []


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")

    from hyperscalees_t2i_tpu_torch.backends.sana_backend import SanaBackend
    from hyperscalees_t2i_tpu_torch.rungs import sana_rung_model
    from hyperscalees_t2i_tpu_torch.serve import ServeConfig

    with pytest.raises(RuntimeError):
        SanaBackend(sana_rung_model("tiny")["bcfg"])
    with pytest.raises(RuntimeError):
        resolve_device(ServeConfig().device)


def test_int8_matmul_refuses_non_cpu_tensors_without_a_launch():
    """A tensor off the CPU takes the kernel or raises — never the plain
    version (a meta tensor stands in for one here)."""
    x = torch.empty(4, 8, device="meta")
    q8 = torch.empty(8, 2, dtype=torch.int8, device="meta")
    scale = torch.empty(1, 2, device="meta")
    before = int8_matmul.launches
    with pytest.raises(ValueError):
        int8_matmul(x, q8, scale)
    assert int8_matmul.launches == before


def test_kernel_build_is_keyed_by_source_and_lands_in_an_ignored_dir():
    lib = _build.library_path("int8_matmul")
    assert lib.parent == ROOT / "build" / "torch_kernels"
    assert re.fullmatch(r"libint8_matmul-[0-9a-f]{12}\.so", lib.name)
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
