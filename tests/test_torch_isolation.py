"""The port stands alone: it imports neither JAX nor the JAX package,
and it never runs on the CPU unless asked to."""
import os
import pkgutil
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import repro_torch

_REPO = Path(__file__).resolve().parents[1]
_PORT = _REPO / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro |from repro\.)",
                        re.MULTILINE)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_with_jax_and_repro_blocked():
    modules = _port_modules()
    for name in ("repro_torch.models.transformer", "repro_torch.models.rwkv",
                 "repro_torch.models.moe", "repro_torch.configs.olmoe_1b_7b",
                 "repro_torch.configs.mixtral_8x7b",
                 "repro_torch.kernels.rwkv_wkv", "repro_torch.configs.rwkv6_1b6",
                 "repro_torch.data.pipeline", "repro_torch.optim.adamw",
                 "repro_torch.optim.schedules", "repro_torch.checkpoint.checkpointer",
                 "repro_torch.runtime.fault", "repro_torch.runtime.train_loop",
                 "repro_torch.launch.train", "repro_torch.models.ssm",
                 "repro_torch.configs.jamba_15_large",
                 "repro_torch.configs.llama32_vision_90b",
                 "repro_torch.configs.seamless_m4t_v2", "repro_torch.launch",
                 "repro_torch.launch.mesh", "repro_torch.launch.sharding",
                 "repro_torch.launch.steps", "repro_torch.models.shards",
                 "repro_torch.launch.dryrun", "repro_torch.launch.op_analysis",
                 "repro_torch.kernels.cost", "repro_torch.runtime.pipeline"):
        assert name in modules
    code = textwrap.dedent(f"""
        import importlib, sys

        class Blocker:
            def find_spec(self, name, path=None, target=None):
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Blocker())
        for name in {modules!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("ok", len({modules!r}))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(_REPO / "src")})
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_no_source_names_jax_or_the_jax_package():
    files = sorted(_PORT.rglob("*.py")) + [_REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        m = _FORBIDDEN.search(f.read_text())
        assert m is None, f"{f.relative_to(_REPO)}: {m.group(0).strip()}"


def test_default_device_is_cuda_and_fails_loudly_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LM
    with pytest.raises(RuntimeError, match="cuda"):
        LM(get_smoke_config("llama3_8b"), param_dtype=torch.float32)


def test_build_list_names_every_kernel_entry_point():
    """``_build.ENTRY_POINTS`` (what chip_smoke.py builds and checks) names
    every source under csrc/ and every entry point the wrappers launch,
    the WKV backward's included, and each is defined in its source."""
    import importlib
    from repro_torch.kernels import _build
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}
    for name in _build.SOURCES:
        wrapper = importlib.import_module(f"repro_torch.kernels.{name}")
        assert set(wrapper._ENTRY.values()) == set(_build.ENTRY_POINTS[name]), name
        src = (_build.CSRC / f"{name}.cu").read_text()
        for entry in _build.ENTRY_POINTS[name]:
            assert f'extern "C" int {entry}(' in src, entry
    assert "repro_wkv_bwd" in _build.ENTRY_POINTS["rwkv_wkv"]
