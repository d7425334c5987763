"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless asked for the CPU."""
import os
import pathlib
import re
import subprocess
import sys

import jax  # noqa: F401  (the tests import both packages; the port must not)
import pytest
import torch

import repro  # noqa: F401

# One intra-op thread per process: the suite runs several test workers, and
# the port's test shapes are too small to gain from more.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?:[\s.,]|$)", re.M)


def _port_modules():
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def test_fresh_import_loads_no_jax_and_no_repro():
    mods = _port_modules()
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(mods) >= 20


@pytest.mark.parametrize(
    "path",
    [p for p in sorted(PORT.rglob("*.py"))] + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_source_imports_no_jax_or_repro(path):
    src = path.read_text()
    assert not _IMPORT.findall(src), f"{path} imports {_IMPORT.findall(src)}"


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    from repro_torch.configs import get_arch, reduced_variant
    from repro_torch.launch.serve import build_engine
    from repro_torch.models.transformer import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_variant(get_arch("deepseek-r1"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, {"data": 1, "model": 4})
    # the CPU is used only when asked for
    model = build_model(cfg, {"data": 1, "model": 4}, device="cpu")
    assert model.device.type == "cpu"


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """Run alone, in a directory holding only the script, with no card
    visible: it must fail and print no result."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(script)], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
