"""The port's import rule and its config copy.

``repro_torch`` imports torch, numpy and the standard library: never
``jax`` and nothing of ``repro``, not even its jax-free modules. It keeps
its own copy of the config dataclasses, which must equal the JAX
package's field by field.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
print(len(names), "modules;", "leaked:", leaked)
assert not leaked, leaked
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "leaked: []" in out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)"
    r"|from\s+repro(\.|\s))", re.M)


def test_port_sources_never_name_jax_or_repro_imports():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    bad = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not bad, bad


@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_equals_jax(reduced):
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    for name in ("moe-gpt3-s", "moe-gpt3-xl", "moe-bert-l",
                 "deepseek-v2-lite-16b", "llama3-8b", "h2o-danube-1.8b",
                 "gemma3-12b", "qwen1.5-110b"):
        a, b = jax_config(name), get_config(name)
        if reduced:
            a, b = a.reduced(), b.reduced()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.layer_roles() == b.layer_roles()
        assert a.num_periods == b.num_periods


def test_param_count_matches_jax():
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    for name in ("moe-gpt3-s", "moe-bert-l", "deepseek-v2-lite-16b",
                 "h2o-danube-1.8b", "gemma3-12b"):
        assert get_config(name).param_count() == \
            jax_config(name).param_count()
        assert get_config(name).active_param_count() == \
            jax_config(name).active_param_count()


def test_chip_scripts_never_name_jax_or_repro_imports():
    """``chip_smoke.py`` and the phase runners it imports from ``tools/``
    run on the card, where JAX is not installed."""
    root = SRC.parent
    files = [root / "chip_smoke.py"] + sorted(root.glob("tools/*_phase.py"))
    assert root / "tools" / "gqa_phase.py" in files
    bad = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not bad, bad


def test_entry_points_refuse_to_fall_back_to_cpu():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import Engine, EngineOptions
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    cfg = get_config("moe-gpt3-s").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg)
    with pytest.raises(ValueError, match="process group"):
        Engine(cfg, options=EngineOptions(device="cpu", devices=2))
