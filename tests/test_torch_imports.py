"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless asked for the CPU."""
import importlib
import importlib.abc
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


class _Refuse(importlib.abc.MetaPathFinder):
    """Refuses (and records) every import of the named top-level packages."""

    def __init__(self, names: tuple):
        self.names, self.asked = names, []

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            self.asked.append(name)
            raise ImportError(f"{name} may not be imported by the port")
        return None


def test_fresh_import_loads_no_jax_and_no_repro():
    """Every port module imported afresh, in this process, with jax, jaxlib
    and repro taken out of ``sys.modules`` and refused by the import system:
    none of them is asked for, not even by an import that would swallow the
    ``ImportError``. The process's modules are put back afterwards (a fresh
    interpreter paid ~2 s to import torch again)."""
    mods = _port_modules()
    refuse = _Refuse(("jax", "jaxlib", "repro"))
    owned = refuse.names + ("repro_torch",)
    saved = {k: m for k, m in sys.modules.items() if k.split(".")[0] in owned}
    for k in saved:
        del sys.modules[k]
    sys.meta_path.insert(0, refuse)
    try:
        for m in mods:
            importlib.import_module(m)
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in refuse.names)
    finally:
        sys.meta_path.remove(refuse)
        for k in [k for k in sys.modules if k.split(".")[0] in owned]:
            del sys.modules[k]
        sys.modules.update(saved)
    assert not refuse.asked and not loaded, (refuse.asked, loaded)
    assert len(mods) >= 20
    # the recurrent blocks and every architecture's config are among them
    assert {"repro_torch.models.recurrent", "repro_torch.models.xlstm",
            "repro_torch.configs.recurrentgemma_2b", "repro_torch.configs.xlstm_350m",
            "repro_torch.configs.grok_1_314b", "repro_torch.configs.musicgen_medium",
            "repro_torch.configs.llama4_maverick_400b_a17b"} <= set(mods)


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


def test_chip_smoke_profile_kinds_by_namespace():
    """The profile's kinds classify the port's kernels by their CUDA
    namespaces: PyTorch's own ``reduce_kernel`` is other device work, not a
    split kernel."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    kinds = {
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >(float)": "other",
        "void split_hopper::hopper_kernel<1, 2, 1, 0>(CUtensorMap_st, CUtensorMap_st)": "split",
        "split_hopper::finish_reduce_kernel(float const*, __nv_bfloat16*)": "split",
        "void split_tile::grouped_kernel<float>(float const*)": "split",
        "void fa::fa_wgmma_kernel<3>(CUtensorMap_st)": "attention",
        "Memcpy DtoD (Device -> Device)": "landing",
        "memcpy128": "landing",
    }
    for name, kind in kinds.items():
        assert smoke.kernel_kind(name).startswith(kind), name
