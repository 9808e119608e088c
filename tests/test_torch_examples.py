"""The port's examples run on the CPU with JAX blocked.

Each of ``examples/train_lm_torch.py`` (smallest preset),
``pipeline_training_torch.py`` (4 gloo stage processes),
``quickstart_torch.py`` and ``elastic_serving_torch.py`` runs with
``--device cpu`` in a subprocess with its own time limit.  A ``sitecustomize`` on the subprocess's path blocks
``jax`` and ``jaxlib`` in it and in every process it spawns, so an example
that reached JAX would fail with an ImportError.  For the examples that
schedule (``pipeline_training_torch.py``, ``quickstart_torch.py``,
``elastic_serving_torch.py``) it blocks the JAX package ``repro`` as well:
they plan through the port's own scheduler (``repro_torch.core``).

The three host-only examples (``heterogeneous_scheduling_torch.py``,
``multi_tenant_service_torch.py``, ``sustained_throughput_torch.py``) take
no device: each runs with ``jax``, ``jaxlib`` and ``repro`` blocked, and
its stdout is the JAX example's, run here on the same machine, line for
line.  Two things are set aside: the milliseconds of the lines that print
wall-clock planning time (``_WALL_MS``; the path and the number of calls
stay), and the package name a line may print (``repro_torch.`` for
``repro.``).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from _torch_parity import JAX_BLOCKER as _BLOCKER

_REPO = Path(__file__).resolve().parents[1]
_TIMEOUT_S = 300
_HOST_ONLY = ("heterogeneous_scheduling_torch.py", "multi_tenant_service_torch.py",
              "sustained_throughput_torch.py")


def _run(tmp_path, script, *args, blocked=("jax", "jaxlib")):
    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "sitecustomize.py").write_text(_BLOCKER)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(blocker), str(_REPO / "src")]),
           "OMP_NUM_THREADS": "2", "REPRO_TEST_BLOCKED": ",".join(blocked)}
    res = subprocess.run([sys.executable, str(_REPO / "examples" / script), *args],
                         capture_output=True, text=True, timeout=_TIMEOUT_S, env=env,
                         cwd=str(tmp_path))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


#: the wall-clock part of a line such as "  cold    planning:     14.7 ms avg
#: over 26" (multi_tenant_service)
_WALL_MS = re.compile(r"planning: +[0-9.]+ ms avg")


def _reference_stdout(tmp_path, script):
    """The JAX example's stdout, run in a subprocess of this machine."""
    env = {**os.environ, "PYTHONPATH": str(_REPO / "src"), "OMP_NUM_THREADS": "2",
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, str(_REPO / "examples" / script)],
                         capture_output=True, text=True, timeout=_TIMEOUT_S, env=env,
                         cwd=str(tmp_path))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


def _comparable(out: str) -> list[str]:
    return [_WALL_MS.sub("planning: <ms> ms avg", line.replace("repro_torch.", "repro."))
            for line in out.splitlines()]


@pytest.mark.parametrize("script", ["heterogeneous_scheduling", "multi_tenant_service",
                                    "sustained_throughput"])
def test_host_example_prints_what_the_jax_example_prints(tmp_path, script):
    out = _run(tmp_path, f"{script}_torch.py", blocked=("jax", "jaxlib", "repro"))
    ref = _reference_stdout(tmp_path, f"{script}.py")
    assert len(out.splitlines()) > 10
    assert _comparable(out) == _comparable(ref)
    walls = [line for line in out.splitlines() if _WALL_MS.search(line)]
    assert len(walls) == (3 if script == "multi_tenant_service" else 0)


def test_blocker_blocks_jax(tmp_path):
    """The sitecustomize the examples run under really blocks JAX, and the
    JAX package where asked to."""
    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "sitecustomize.py").write_text(_BLOCKER)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(blocker), str(_REPO / "src")])}
    env.pop("REPRO_TEST_BLOCKED", None)
    res = subprocess.run([sys.executable, "-c", "import jax"], capture_output=True, text=True,
                         timeout=60, env=env)
    assert res.returncode != 0 and "blocked: jax" in res.stderr
    res = subprocess.run([sys.executable, "-c", "import repro.core"], capture_output=True,
                         text=True, timeout=60, env={**env, "REPRO_TEST_BLOCKED": "jax,repro"})
    assert res.returncode != 0 and "blocked: repro" in res.stderr


def test_train_lm_torch_tiny(tmp_path):
    out = _run(tmp_path, "train_lm_torch.py", "--preset", "tiny", "--device", "cpu",
               "--ckpt-dir", str(tmp_path / "ckpt"))
    first, last = map(float, re.search(r"loss: ([\d.]+) -> ([\d.]+)", out).groups())
    assert last < first and "0 restarts" in out


def test_train_lm_torch_restarts_after_a_fault(tmp_path):
    out = _run(tmp_path, "train_lm_torch.py", "--preset", "tiny", "--device", "cpu",
               "--steps", "12", "--inject-fault-at", "7", "--ckpt-dir", str(tmp_path / "ckpt"))
    assert "1 restarts" in out


def test_pipeline_training_torch(tmp_path):
    out = _run(tmp_path, "pipeline_training_torch.py", "--device", "cpu",
               blocked=("jax", "jaxlib", "repro"))
    assert "split 8 layers into [2, 2, 2, 2]" in out
    first, last = map(float, re.search(
        r"pipeline training \(4 stage\(s\), 4 microbatches, cpu\): loss ([\d.]+) -> ([\d.]+)",
        out).groups())
    assert last < first


def test_quickstart_torch(tmp_path):
    out = _run(tmp_path, "quickstart_torch.py", "--device", "cpu",
               blocked=("jax", "jaxlib", "repro"))
    assert "on 64 H100 cards" in out and "valid: True" in out
    first, last = map(float, re.search(r"8 steps: loss ([\d.]+) -> ([\d.]+)", out).groups())
    assert out.rstrip().endswith("done.") and last < first


def test_elastic_serving_torch(tmp_path):
    """The replan's printed step times are JAX's ``rescale_plan`` on the
    same 64 processors (3.72 ms before, 1.87 ms after, 3.73 ms stitched),
    and the reduced mixtral's decode starts where its prefill ends."""
    from _torch_parity import platform_as
    from repro.configs import get_config, shape_by_name
    from repro.core.autoshard import plan
    from repro.runtime import rescale_plan
    from repro_torch.core import h100_fleet_si

    out = _run(tmp_path, "elastic_serving_torch.py", "--device", "cpu",
               blocked=("jax", "jaxlib", "repro"))
    jfleet = platform_as(h100_fleet_si({"h100": 56, "h100-degraded": 8}), "jax")
    cfg, shape, kprime = get_config("mixtral_8x7b"), shape_by_name("decode_32k"), [8, 16, 32, 56]
    t_fail = 0.5 * plan(cfg, shape, jfleet, kprime=kprime).est_step_s
    ref = rescale_plan(cfg, shape, jfleet, failed=set(range(8)), at=t_fail,
                       policy="pinned-warm-start", kprime=kprime)
    for line in (f"est step before: {ref.est_step_before_s * 1e3:.2f} ms",
                 f"est step after:  {ref.est_step_after_s * 1e3:.2f} ms",
                 f"stitched finish: {ref.timeline.makespan * 1e3:.2f} ms",
                 "est step before: 3.72 ms", "est step after:  1.87 ms",
                 "stitched finish: 3.73 ms", "new plan valid:  True",
                 f"migration: {ref.timeline.migrations[0].moved_tasks} moved, "
                 f"{ref.timeline.migrations[0].displaced_tasks} displaced",
                 "first token agrees with the prefill: True"):
        assert line in out, line
    assert "▼" in out and "generated: [[" in out


@pytest.mark.parametrize("script", ["train_lm_torch.py", "pipeline_training_torch.py",
                                    "quickstart_torch.py", "elastic_serving_torch.py",
                                    "heterogeneous_scheduling_torch.py",
                                    "multi_tenant_service_torch.py",
                                    "sustained_throughput_torch.py"])
def test_example_imports_nothing_of_jax_and_defaults_to_the_card(script):
    """No example imports JAX or the JAX package; those that use a device
    default to the card, and the host-only ones take none."""
    src = (_REPO / "examples" / script).read_text()
    assert not re.search(r"^\s*(import jax|from jax|import repro\.|from repro |from repro\.)",
                         src, re.MULTILINE)
    if script in _HOST_ONLY:
        assert "--device" not in src and "import torch" not in src
    else:
        assert 'default="cuda"' in src
