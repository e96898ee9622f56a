"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the reference package
``repro``, and entry points never carry on quietly without a card."""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                yield arg.values[0].value.rstrip(".")
            elif isinstance(arg, ast.Constant):
                yield arg.value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_or_reference(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_sees_every_port_module():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "lm.py", "ops.py", "_build.py", "chip_smoke.py", "aot.py",
            "function.py", "collectives.py"} <= names


def test_no_device_without_card_raises(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import common, lm
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.serve import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("smollm-360m")
    params = lm.init(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(cfg, common.map_tree(lambda t: t.numpy(), params))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
