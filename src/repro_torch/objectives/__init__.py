"""repro_torch.objectives — reliability- and energy-aware schedule pricing.

The paper optimizes one axis: makespan under memory constraints.  This
subsystem prices a mapped schedule on two more (grounding: Tekawade & Banerjee, *Makespan and Energy-Aware Scheduling
under Reliability Constraint*, and Benoit, Rehn-Sonigo & Robert,
*Multi-criteria scheduling of pipeline workflows* — see PAPERS.md):

* **Reliability** — with per-processor exponential failure rates
  (:attr:`Platform.failure_rates <repro_torch.core.platform.Platform>`), a
  block computing for ``d`` seconds on processor ``j`` survives with
  probability ``exp(-λ_j · d)``.  Failures are independent, so the
  whole schedule's success probability is
  ``exp(-Σ_v λ_proc(v) · exposure_v)`` and
  :func:`schedule_reliability` reports it together with the
  *reliability-weighted makespan* ``makespan / success_prob`` — the
  expected completion cost when a failed run must be repeated.
* **Energy** — with per-processor :class:`ProcPower
  <repro_torch.core.platform.ProcPower>` models (``static + dynamic·s^α``),
  :func:`schedule_energy` integrates per-block dynamic energy
  (``dynamic · w · (f·s)^(α-1)`` at DVFS scale ``f``) plus per-proc
  static energy (``static × horizon``), and :func:`energy_plan`
  *minimizes* it under a reliability floor by choosing a per-block
  speed scale from a DVFS ladder: slowing a block saves dynamic energy
  (α > 1) but lengthens its failure exposure, so the greedy raises the
  speeds with the best exposure-reduction-per-joule until the floor is
  met — or reports the floor unreachable (``None``; the scheduler's
  ``energy`` stage turns that into a structured
  ``Infeasibility(stage="objective")``).

Both axes plug into the scheduler as pipeline stages (algorithms
``"reliability"`` / ``"energy"``, registered via ``register_pipeline``
and swept over k' in parallel like any other pipeline); the stages are
**bit-inert** when the platform carries no failure/power model, so the
makespan pipeline's output is unchanged on model-free platforms.
:func:`plan_reliability` / :func:`plan_energy` select the sweep attempt
that wins on the *objective* (not makespan) from the per-point metric
observations, exactly as the throughput analysis's ``plan_throughput``
does for rate.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.core.platform import Platform, ProcPower

__all__ = [
    "EnergyReport",
    "EnergyResult",
    "ReliabilityReport",
    "ReliabilityResult",
    "block_exposures",
    "energy_from_sim",
    "energy_plan",
    "plan_energy",
    "plan_reliability",
    "schedule_energy",
    "schedule_reliability",
]


# ---------------------------------------------------------------------- #
# reliability
# ---------------------------------------------------------------------- #
@dataclass
class ReliabilityReport:
    """Success probability of one mapped schedule.

    ``exposure[v]`` is block ``v``'s compute duration (its at-risk
    window on its processor), ``hazard`` the summed ``λ · exposure``
    over all blocks, ``success_prob = exp(-hazard)`` ∈ (0, 1], and
    ``weighted_makespan = makespan / success_prob`` — the expected
    completion cost when a failed schedule is re-run from scratch.
    ``proc_hazard`` splits the hazard by processor *name* (names are
    stable across failures; indices are not).
    """

    success_prob: float
    hazard: float
    makespan: float
    weighted_makespan: float
    exposure: dict[int, float] = field(default_factory=dict)
    proc_hazard: dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "success_prob": self.success_prob,
            "hazard": self.hazard,
            "makespan": self.makespan,
            "weighted_makespan": self.weighted_makespan,
            "exposure": [[v, x] for v, x in sorted(self.exposure.items())],
            "proc_hazard": dict(sorted(self.proc_hazard.items())),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ReliabilityReport":
        return cls(
            success_prob=d["success_prob"],
            hazard=d["hazard"],
            makespan=d["makespan"],
            weighted_makespan=d["weighted_makespan"],
            exposure={v: x for v, x in d.get("exposure", [])},
            proc_hazard=dict(d.get("proc_hazard", {})),
        )


def block_exposures(mapping, platform: Platform,
                    speed_scale: dict[int, float] | None = None,
                    ) -> dict[int, float]:
    """Per-block compute durations ``w_v / (f_v · s_proc(v))``.

    ``speed_scale`` optionally maps a block id to its DVFS scale factor
    (default 1.0 = nominal speed).  This is the exposure-time input of
    both the reliability and the energy accounting.
    """
    q = mapping.quotient
    out: dict[int, float] = {}
    for v in sorted(q.members):
        f = speed_scale.get(v, 1.0) if speed_scale else 1.0
        out[v] = q.weight[v] / (f * platform.procs[q.proc[v]].speed)
    return out


def schedule_reliability(mapping, platform: Platform | None = None,
                         *, speed_scale: dict[int, float] | None = None,
                         makespan: float | None = None,
                         ) -> ReliabilityReport:
    """Price a mapping's success probability from per-block exposure
    time × its processor's failure rate (independent exponential
    failures).  Without a failure model every λ is 0 and the report is
    the trivial ``success_prob=1.0``.
    """
    res = getattr(mapping, "best", mapping)
    platform = platform if platform is not None else res.platform
    q = res.quotient
    exposure = block_exposures(res, platform, speed_scale)
    hazard = 0.0
    proc_hazard: dict[str, float] = {}
    for v, dur in exposure.items():
        j = q.proc[v]
        lam = platform.failure_rate(j)
        if lam <= 0:
            continue
        h = lam * dur
        hazard += h
        name = platform.procs[j].name
        proc_hazard[name] = proc_hazard.get(name, 0.0) + h
    prob = math.exp(-hazard)
    ms = float(makespan if makespan is not None else res.makespan)
    # exp(-hazard) underflows to exactly 0.0 around hazard ~ 745; the
    # weighted makespan is then "never finishes", not a ZeroDivisionError
    weighted = ms / prob if prob > 0.0 else math.inf
    return ReliabilityReport(
        success_prob=prob, hazard=hazard, makespan=ms,
        weighted_makespan=weighted, exposure=exposure,
        proc_hazard=proc_hazard,
    )


# ---------------------------------------------------------------------- #
# energy
# ---------------------------------------------------------------------- #
@dataclass
class EnergyReport:
    """Energy of one mapped schedule, decomposed so that

    ``total == sum(per_block_dynamic.values())
             + sum(per_proc_static.values())``

    holds *by construction* (the property the accounting tests pin).
    ``per_block_dynamic[v]`` integrates the dynamic power of block
    ``v``'s compute interval at its chosen DVFS scale
    (``dynamic · w_v · (f_v·s_j)^(α-1)``); ``per_proc_static`` is keyed
    by processor *name* and integrates static power over ``horizon`` —
    the nominal makespan stretched by the worst slowdown
    ``max(1/f_v)`` when DVFS scaling is in force.  ``reliability`` is
    the success probability *under the chosen speeds* (slower blocks
    are exposed longer); ``reliability_floor`` echoes the constraint
    :func:`energy_plan` enforced (``None`` for unconstrained pricing).
    """

    total: float
    dynamic: float
    static: float
    horizon: float
    per_block_dynamic: dict[int, float] = field(default_factory=dict)
    per_proc_static: dict[str, float] = field(default_factory=dict)
    speed_of_block: dict[int, float] = field(default_factory=dict)
    reliability: float = 1.0
    reliability_floor: float | None = None

    def to_dict(self) -> dict:
        return {
            "total": self.total,
            "dynamic": self.dynamic,
            "static": self.static,
            "horizon": self.horizon,
            "per_block_dynamic": [[v, e] for v, e in
                                  sorted(self.per_block_dynamic.items())],
            "per_proc_static": dict(sorted(self.per_proc_static.items())),
            "speed_of_block": [[v, f] for v, f in
                               sorted(self.speed_of_block.items())],
            "reliability": self.reliability,
            "reliability_floor": self.reliability_floor,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "EnergyReport":
        return cls(
            total=d["total"], dynamic=d["dynamic"], static=d["static"],
            horizon=d["horizon"],
            per_block_dynamic={v: e for v, e
                               in d.get("per_block_dynamic", [])},
            per_proc_static=dict(d.get("per_proc_static", {})),
            speed_of_block={v: f for v, f in d.get("speed_of_block", [])},
            reliability=d.get("reliability", 1.0),
            reliability_floor=d.get("reliability_floor"),
        )


def _dynamic_energy(weight: float, speed: float, f: float,
                    pw: ProcPower) -> float:
    """Dynamic energy of one block: power ``dynamic·(f·s)^α`` times
    duration ``w/(f·s)`` — the closed form ``dynamic·w·(f·s)^(α-1)``."""
    return pw.dynamic * weight * (f * speed) ** (pw.alpha - 1.0)


def schedule_energy(mapping, platform: Platform | None = None,
                    *, speed_of_block: dict[int, float] | None = None,
                    reliability_floor: float | None = None,
                    ) -> EnergyReport:
    """Integrate a mapping's energy under the platform's power model.

    Per-block dynamic integrals at the given DVFS scales (default
    nominal) plus per-processor static integrals over the schedule
    horizon; processors without a :class:`ProcPower` entry contribute
    nothing.  The decomposition invariant of :class:`EnergyReport`
    holds exactly.
    """
    res = getattr(mapping, "best", mapping)
    platform = platform if platform is not None else res.platform
    q = res.quotient
    scales = dict(speed_of_block or {})
    per_block: dict[int, float] = {}
    for v in sorted(q.members):
        j = q.proc[v]
        pw = platform.proc_power(j)
        f = scales.get(v, 1.0)
        per_block[v] = (_dynamic_energy(q.weight[v],
                                        platform.procs[j].speed, f, pw)
                        if pw is not None else 0.0)
    stretch = max((1.0 / f for f in scales.values()), default=1.0)
    horizon = float(res.makespan) * max(stretch, 1.0)
    per_proc: dict[str, float] = {}
    for j, pw in sorted(platform.power.items()):
        per_proc[platform.procs[j].name] = pw.static * horizon
    dynamic = sum(per_block.values())
    static = sum(per_proc.values())
    rel = schedule_reliability(res, platform, speed_scale=scales)
    return EnergyReport(
        total=dynamic + static, dynamic=dynamic, static=static,
        horizon=horizon, per_block_dynamic=per_block,
        per_proc_static=per_proc,
        speed_of_block={v: scales.get(v, 1.0) for v in per_block},
        reliability=rel.success_prob,
        reliability_floor=reliability_floor,
    )


def energy_plan(mapping, platform: Platform | None = None,
                *, reliability_floor: float | None = None,
                speed_levels=(1.0,),
                ) -> EnergyReport | None:
    """Minimize energy under a reliability floor via per-block DVFS.

    ``speed_levels`` is the ladder of scale factors (each in (0, 1];
    1.0 — nominal speed — is always available).  Every block starts at
    the *lowest* level (minimum dynamic energy, since α > 1 makes
    dynamic energy increase with speed); while the schedule's success
    probability is below ``reliability_floor``, the greedy raises the
    block/level step with the best hazard reduction per joule.  Returns
    ``None`` when even all-nominal speeds miss the floor — the caller
    (the ``energy`` scheduler stage) reports that as a structured
    ``Infeasibility(stage="objective")``, never an exception.
    """
    res = getattr(mapping, "best", mapping)
    platform = platform if platform is not None else res.platform
    q = res.quotient
    levels = sorted({float(f) for f in speed_levels} | {1.0})
    for f in levels:
        if not 0 < f <= 1.0:
            raise ValueError(
                f"DVFS speed levels must be in (0, 1], got {f!r}")

    vids = sorted(q.members)
    lam = {v: platform.failure_rate(q.proc[v]) for v in vids}
    spd = {v: platform.procs[q.proc[v]].speed for v in vids}
    pw = {v: platform.proc_power(q.proc[v]) for v in vids}

    def hazard_at(v: int, f: float) -> float:
        return lam[v] * q.weight[v] / (f * spd[v])

    def dyn_at(v: int, f: float) -> float:
        p = pw[v]
        return (_dynamic_energy(q.weight[v], spd[v], f, p)
                if p is not None else 0.0)

    lvl = {v: 0 for v in vids}
    top = len(levels) - 1

    def success() -> float:
        return math.exp(-sum(hazard_at(v, levels[lvl[v]]) for v in vids))

    if reliability_floor is not None:
        # feasibility first: the floor must be reachable at nominal
        if math.exp(-sum(hazard_at(v, 1.0) for v in vids)) \
                < reliability_floor:
            return None
        while success() < reliability_floor:
            best = None  # (score, -dh, v): max hazard drop per joule
            for v in vids:
                i = lvl[v]
                if i >= top:
                    continue
                f0, f1 = levels[i], levels[i + 1]
                dh = hazard_at(v, f0) - hazard_at(v, f1)
                de = dyn_at(v, f1) - dyn_at(v, f0)
                score = dh / de if de > 0 else math.inf
                key = (score, dh, -v)
                if best is None or key > best[0]:
                    best = (key, v)
            if best is None:   # pragma: no cover — nominal check above
                return None
            lvl[best[1]] += 1

    scales = {v: levels[lvl[v]] for v in vids}
    return schedule_energy(res, platform, speed_of_block=scales,
                           reliability_floor=reliability_floor)


def energy_from_sim(sim, platform: Platform) -> dict:
    """Energy/exposure accounting from the engine's per-proc busy
    integrals (:attr:`SimReport.procs
    <repro_torch.sim.report.SimReport>`\\ 's ``busy_s``) — the simulation-side
    counterpart of :func:`schedule_energy` at nominal speeds.

    Returns a plain dict: per-proc-name ``dynamic`` (busy integral ×
    ``dynamic·s^α``), ``static`` (horizon × static), ``exposure``
    (λ-weighted busy integrals), plus ``total`` / ``success_prob``.
    This is what :func:`repro_torch.sim.simulate` attaches as
    ``SimReport.energy`` when the platform carries a model.
    """
    dynamic: dict[str, float] = {}
    static: dict[str, float] = {}
    exposure: dict[str, float] = {}
    hazard = 0.0
    busy = {p.proc: p.busy_s for p in sim.procs}
    horizon = sim.horizon
    for j in range(platform.k):
        name = platform.procs[j].name
        b = busy.get(j, 0.0)
        pw = platform.proc_power(j)
        if pw is not None:
            dynamic[name] = (pw.dynamic
                             * platform.procs[j].speed ** pw.alpha * b)
            static[name] = pw.static * horizon
        lam = platform.failure_rate(j)
        if lam > 0:
            exposure[name] = b
            hazard += lam * b
    return {
        "dynamic": dynamic,
        "static": static,
        "exposure": exposure,
        "total": sum(dynamic.values()) + sum(static.values()),
        "hazard": hazard,
        "success_prob": math.exp(-hazard),
    }


# ---------------------------------------------------------------------- #
# objective-winning sweep selection (mirrors plan_throughput)
# ---------------------------------------------------------------------- #
@dataclass
class ReliabilityResult:
    """What :func:`plan_reliability` returns — never ``None``.

    ``report`` is the full k'-sweep ``ScheduleReport``; ``best`` /
    ``reliability`` the weighted-makespan-minimizing mapping and its
    :class:`ReliabilityReport` (``None`` when no attempt was feasible).
    """

    report: object
    best: object | None
    reliability: ReliabilityReport | None
    k_prime: int | None

    @property
    def feasible(self) -> bool:
        return self.best is not None


@dataclass
class EnergyResult:
    """What :func:`plan_energy` returns — never ``None``."""

    report: object
    best: object | None
    energy: EnergyReport | None
    k_prime: int | None

    @property
    def feasible(self) -> bool:
        return self.best is not None


def _point_observation(point, name: str) -> float | None:
    """The attempt's single objective observation from its metrics
    block (the stage observes exactly once per attempt, so the
    histogram's ``sum`` is the value — same contract as
    ``plan_throughput``)."""
    h = point.metrics.get("histograms", {}).get(name)
    if not h or not h.get("count"):
        return None
    return float(h["sum"])


def _plan_objective(wf, platform, algorithm: str, metric: str,
                    objective_options: dict | None, config, overrides):
    """Run ``algorithm``'s pipeline over the k' sweep and re-materialize
    the attempt minimizing ``metric`` (ties: smaller makespan, then
    earlier sweep position)."""
    from repro_torch.core.scheduler import Scheduler, SchedulerConfig

    cfg = config if config is not None else SchedulerConfig()
    run_overrides = {"algorithm": algorithm, **overrides}
    if objective_options is not None:
        merged = dict(cfg.objective_options or {})
        merged.update(objective_options)
        run_overrides["objective_options"] = merged
    report = Scheduler(cfg, **run_overrides).schedule(wf, platform)
    if report.best is None:
        return report, None, None

    best_kp = None
    best_val = math.inf
    best_ms = math.inf
    for p in report.sweep:
        if not p.feasible:
            continue
        val = _point_observation(p, metric)
        if val is None:
            continue
        if val < best_val or (val == best_val and p.makespan < best_ms):
            best_kp, best_val, best_ms = p.k_prime, val, p.makespan
    best = report.best
    if best_kp is not None and best_kp != best.extras.get("k_prime"):
        # the objective winner lost the makespan reduction: re-run the
        # single winning k' (stages are deterministic)
        rerun = Scheduler(cfg, **{**run_overrides, "kprime": [best_kp],
                                  "workers": 1}).schedule(wf, platform)
        if rerun.best is not None:
            best = rerun.best
    return report, best, best.extras.get("k_prime")


def plan_reliability(wf, platform: Platform, *, config=None,
                     **overrides) -> ReliabilityResult:
    """Plan ``wf`` minimizing the reliability-weighted makespan.

    Runs the registered ``reliability`` pipeline across the k' sweep
    (``config`` / ``overrides`` are ``SchedulerConfig`` material), then
    picks the attempt with the smallest ``makespan / success_prob``
    from the per-point ``objective_rel_weighted_ms`` observations — a
    finer partition may lose on raw makespan yet win weighted, when it
    keeps exposure off failure-prone processors.  Without a failure
    model the stage is inert and the makespan winner stands.
    """
    report, best, kp = _plan_objective(
        wf, platform, "reliability", "objective_rel_weighted_ms",
        None, config, overrides)
    rel = best.extras.get("reliability") if best is not None else None
    return ReliabilityResult(report=report, best=best, reliability=rel,
                             k_prime=kp)


def plan_energy(wf, platform: Platform, *,
                reliability_floor: float | None = None,
                speed_levels=(1.0,), config=None,
                **overrides) -> EnergyResult:
    """Plan ``wf`` minimizing energy under a reliability floor.

    Runs the registered ``energy`` pipeline (per-block DVFS greedy, see
    :func:`energy_plan`) across the k' sweep and picks the attempt with
    the smallest total energy from the per-point
    ``objective_energy_total`` observations.  Attempts that cannot
    reach the floor are structurally infeasible; when *no* attempt can,
    the returned report carries an ``Infeasibility`` with
    ``stage="objective"``.
    """
    opts = {"reliability_floor": reliability_floor,
            "speed_levels": tuple(speed_levels)}
    report, best, kp = _plan_objective(
        wf, platform, "energy", "objective_energy_total",
        opts, config, overrides)
    en = best.extras.get("energy") if best is not None else None
    return EnergyResult(report=report, best=best, energy=en, k_prime=kp)
