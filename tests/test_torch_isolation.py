"""The port stands alone: it imports torch and numpy, never JAX, flax or the
JAX package, nor ``safetensors``, ``tokenizers``, ``transformers``,
``regex`` or ``matplotlib``, which a CUDA host running it need not have; and
it runs on the CPU only when asked to."""

import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "fairness_llm_tpu_torch"
OUTSIDE = ("jax", "jaxlib", "flax", "fairness_llm_tpu", "safetensors", "tokenizers",
           "transformers", "regex", "matplotlib")
_NAMES = "|".join(OUTSIDE)
FORBIDDEN = re.compile(
    rf"^\s*(?:import|from)\s+(?:{_NAMES})\b"
    rf"|(?:import_module|__import__)\(\s*['\"](?:{_NAMES})\b",
    re.MULTILINE,
)


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fairness_llm_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {OUTSIDE!r})\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('fairness_llm_tpu_torch.')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 40


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.name} imports {hits}"


def test_engine_without_a_device_needs_a_card():
    from fairness_llm_tpu_torch.device import resolve_device
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(get_model_config("tiny-test"))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path does not apply")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
