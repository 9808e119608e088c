"""The port's k' sweep joins its process pool before ``schedule()`` returns.

A pool left to wind down after its sweep keeps its manager thread alive;
the next sweep's ``fork`` can copy that thread's lock held into a worker,
which then blocks for good at its exit, and the parent blocks joining it at
its own.  (a) After ``schedule(..., workers=2)`` returns, normally, after a
``time_budget_s`` truncation, or with a callback's exception, no worker
process and no manager thread of that sweep is alive.  (b) A process whose
torch intra-op threads have run makes 40 parallel sweeps back to back, then
serves 8 submissions with a parallel scheduler, and exits within a time
limit (its whole process group is killed if not, so a hang fails the test
and leaves nothing behind).
"""
import multiprocessing
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.core import default_cluster, generate_workflow, schedule

from _torch_parity import manager_threads

SRC = Path(__file__).resolve().parents[1] / "src"
#: the k' values of case (a)
KPRIME = list(range(1, 17))
SOAK_TIMEOUT_S = 120


class CallbackFault(Exception):
    pass


def _raise_on_first(point):
    raise CallbackFault(point.k_prime)


@pytest.mark.parametrize("end", ["returned", "truncated", "callback_raised"])
def test_pool_joined_when_schedule_returns(end):
    plat = default_cluster()
    wf = generate_workflow("montage", 300, seed=3, platform=plat)
    threads_before = set(manager_threads())
    children_before = {p.pid for p in multiprocessing.active_children()}
    if end == "returned":
        rep = schedule(wf, plat, kprime=KPRIME, workers=2)
        assert rep.feasible and not rep.truncated and len(rep.sweep) == len(KPRIME)
    elif end == "truncated":
        # over budget from the second point on: each point not yet started
        # when its turn comes is cancelled (in practice each has started,
        # since the pool dispatches ahead of the in-order collection)
        rep = schedule(wf, plat, kprime=KPRIME, workers=2, time_budget_s=0.0)
        assert rep.feasible and 1 <= len(rep.sweep) <= len(KPRIME)
        assert rep.truncated == (len(rep.sweep) < len(KPRIME))
    else:
        with pytest.raises(CallbackFault):
            schedule(wf, plat, kprime=KPRIME, workers=2, on_sweep_result=_raise_on_first)
    children = [p.pid for p in multiprocessing.active_children()
                if p.pid not in children_before]
    threads = [t.name for t in manager_threads() if t not in threads_before]
    assert children == [] and threads == []


SOAK = textwrap.dedent("""
    import torch

    from repro_torch.core import SchedulerConfig, default_cluster, generate_workflow, schedule
    from repro_torch.service import ServiceConfig, Submission, run_service

    torch.set_num_threads(4)
    x = torch.randn(512, 512)
    assert torch.isfinite(x @ x).all()          # the intra-op pool has run
    plat = default_cluster()
    wf = generate_workflow("blast", 120, seed=5, platform=plat)
    first = None
    for _ in range(40):
        rep = schedule(wf, plat, kprime=[2, 4, 6], workers=2)
        first = rep.makespan if first is None else first
        assert rep.makespan == first
    config = ServiceConfig(scheduler=SchedulerConfig(kprime=[2, 4, 6], workers=2,
                                                     simulate=True))
    subs = [Submission(generate_workflow(f, 80, seed=i, platform=plat), name=f"{f}{i}",
                       arrival_t=50.0 * i)
            for i, f in enumerate(["montage", "blast", "genome", "epigenomics"] * 2)]
    out = run_service(subs, plat, config=config)
    assert len(out.jobs) == 8
    print("soak done", first, [j.status for j in out.jobs], flush=True)
""")


def test_parallel_sweeps_then_service_exit():
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(SRC), *filter(None, [os.environ.get("PYTHONPATH")])])}
    proc = subprocess.Popen([sys.executable, "-c", SOAK], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=SOAK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)     # the process and its forked workers
        out, err = proc.communicate()
        pytest.fail(f"the soak did not exit within {SOAK_TIMEOUT_S} s:\n{out[-2000:]}\n{err[-2000:]}")
    assert proc.returncode == 0 and "soak done" in out, err[-4000:]
