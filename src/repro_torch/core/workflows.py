"""Workflow instance generators (paper §5.1.1).

The paper evaluates on (a) real nf-core workflows and (b) WfCommons/
WFGen-simulated workflows of seven model families.  Neither the nf-core
dumps nor WFGen are available offline, so this module generates
topologically faithful synthetic instances of the same seven families
(structure summarized from the WfCommons model descriptions) plus small
"real-like" nf-core-shaped instances.

Weights follow the paper's simulated setup: edge weights ~ U(1, 10),
work ~ U(1, 1000), memory ~ U(1, 192); deterministic per seed.  As in
the paper, memory weights are scaled so the most demanding single task
still fits on some processor of the target platform.
"""
from __future__ import annotations

import json

import numpy as np

from .dag import Workflow
from .platform import Platform

__all__ = [
    "FAMILIES",
    "SCHEMA_VERSION",
    "generate_workflow",
    "random_weights",
    "residual_workflow",
    "scale_memory_to_platform",
    "real_like_workflows",
    "random_layered_dag",
    "to_json",
    "from_json",
    "WorkflowValidationError",
]

FAMILIES = (
    "genome",       # 1000Genome: phased parallel analysis per population
    "blast",        # split → wide blast fan → merge
    "bwa",          # two-level fan-out/fan-in
    "epigenomics",  # several long parallel pipelines, late merge
    "montage",      # diamond: project fan → fit → background fan → add
    "seismology",   # wide independent pairs → join
    "soykb",        # chain prologue → fork-join epilogue
)


# ---------------------------------------------------------------------- #
# topology builders.  Each returns a Workflow with unit weights; weights
# are drawn afterwards by ``random_weights``.
# ---------------------------------------------------------------------- #
def _chain(wf: Workflow, length: int) -> list[int]:
    ids = [wf.add_task() for _ in range(length)]
    for a, b in zip(ids, ids[1:]):
        wf.add_edge(a, b)
    return ids


def _blast(n: int) -> Workflow:
    wf = Workflow(name="blast")
    split = wf.add_task(label="split_fasta")
    width = max(1, n - 3)
    mids = []
    for i in range(width):
        t = wf.add_task(label=f"blastall_{i}")
        wf.add_edge(split, t)
        mids.append(t)
    cat = wf.add_task(label="cat_blast")
    out = wf.add_task(label="cat_all")
    for t in mids:
        wf.add_edge(t, cat)
    wf.add_edge(cat, out)
    return wf


def _bwa(n: int) -> Workflow:
    wf = Workflow(name="bwa")
    idx = wf.add_task(label="bwa_index")
    width = max(1, (n - 4) // 2)
    joins = []
    for i in range(width):
        a = wf.add_task(label=f"bwa_aln_{i}")
        b = wf.add_task(label=f"bwa_sampe_{i}")
        wf.add_edge(idx, a)
        wf.add_edge(a, b)
        joins.append(b)
    cat = wf.add_task(label="cat_sam")
    out = wf.add_task(label="merge")
    for t in joins:
        wf.add_edge(t, cat)
    wf.add_edge(cat, out)
    return wf


def _seismology(n: int) -> Workflow:
    wf = Workflow(name="seismology")
    width = max(1, (n - 1) // 2)
    join = None
    pairs = []
    for i in range(width):
        a = wf.add_task(label=f"sG1_{i}")
        b = wf.add_task(label=f"wrapper_{i}")
        wf.add_edge(a, b)
        pairs.append(b)
    join = wf.add_task(label="sG2")
    for t in pairs:
        wf.add_edge(t, join)
    return wf


def _epigenomics(n: int) -> Workflow:
    wf = Workflow(name="epigenomics")
    lanes = max(2, int(np.sqrt(max(n, 4)) / 2))
    stage_len = max(1, (n - 3) // (lanes * 4))
    src = wf.add_task(label="fastqsplit")
    ends = []
    for l in range(lanes):
        prev = src
        for s, op in enumerate(("filter", "map", "sort", "dedup")):
            for j in range(stage_len):
                t = wf.add_task(label=f"{op}_{l}_{j}")
                wf.add_edge(prev, t)
                prev = t
        ends.append(prev)
    merge = wf.add_task(label="mapmerge")
    out = wf.add_task(label="maqindex")
    for t in ends:
        wf.add_edge(t, merge)
    wf.add_edge(merge, out)
    return wf


def _montage(n: int) -> Workflow:
    wf = Workflow(name="montage")
    width = max(2, (n - 4) // 3)
    projects = [wf.add_task(label=f"mProject_{i}") for i in range(width)]
    # overlapping diff tasks between neighbouring projections
    diffs = []
    for i in range(width - 1):
        d = wf.add_task(label=f"mDiffFit_{i}")
        wf.add_edge(projects[i], d)
        wf.add_edge(projects[i + 1], d)
        diffs.append(d)
    fit = wf.add_task(label="mConcatFit")
    for d in diffs:
        wf.add_edge(d, fit)
    bgmodel = wf.add_task(label="mBgModel")
    wf.add_edge(fit, bgmodel)
    bgs = []
    for i, p in enumerate(projects):
        b = wf.add_task(label=f"mBackground_{i}")
        wf.add_edge(p, b)
        wf.add_edge(bgmodel, b)
        bgs.append(b)
    add = wf.add_task(label="mAdd")
    for b in bgs:
        wf.add_edge(b, add)
    shrink = wf.add_task(label="mShrink")
    wf.add_edge(add, shrink)
    return wf


def _genome(n: int) -> Workflow:
    wf = Workflow(name="genome")
    phases = max(2, n // 600)
    per_phase = max(2, (n - 2) // (phases * 2))
    prev_join = wf.add_task(label="individuals_in")
    for ph in range(phases):
        mids = []
        for i in range(per_phase):
            a = wf.add_task(label=f"individuals_{ph}_{i}")
            b = wf.add_task(label=f"sifting_{ph}_{i}")
            wf.add_edge(prev_join, a)
            wf.add_edge(a, b)
            mids.append(b)
        join = wf.add_task(label=f"mutation_overlap_{ph}")
        for t in mids:
            wf.add_edge(t, join)
        prev_join = join
    return wf


def _soykb(n: int) -> Workflow:
    wf = Workflow(name="soykb")
    chain_len = max(1, n // 3)
    ids = _chain(wf, chain_len)
    width = max(1, n - chain_len - 2)
    fans = []
    for i in range(width):
        t = wf.add_task(label=f"haplotype_{i}")
        wf.add_edge(ids[-1], t)
        fans.append(t)
    join = wf.add_task(label="merge_gcvf")
    out = wf.add_task(label="indel_realign")
    for t in fans:
        wf.add_edge(t, join)
    wf.add_edge(join, out)
    return wf


_BUILDERS = {
    "genome": _genome,
    "blast": _blast,
    "bwa": _bwa,
    "epigenomics": _epigenomics,
    "montage": _montage,
    "seismology": _seismology,
    "soykb": _soykb,
}


# ---------------------------------------------------------------------- #
# weights
# ---------------------------------------------------------------------- #
def random_weights(
    wf: Workflow,
    seed: int,
    *,
    work_range: tuple[float, float] = (1.0, 1000.0),
    mem_range: tuple[float, float] = (1.0, 192.0),
    edge_range: tuple[float, float] = (1.0, 10.0),
    work_multiplier: float = 1.0,
    mem_dist: str = "lognormal",
) -> Workflow:
    """Draw paper-§5.1.1 weights in place (returns ``wf``).

    Work and edge weights are uniform as in the paper.  For memory we
    default to a *heavy-tailed* (lognormal) draw normalized so the
    biggest task hits ``mem_range[1]`` (= the biggest processor after
    the paper's normalization).  Rationale (documented deviation, see
    DESIGN.md §3 item 7): a literal U(1, 192) draw gives an average
    task memory of 96 — under the MemDag memory model the default
    36-processor cluster (total memory 1 968) can then hold only a few
    hundred tasks in *any* valid mapping, contradicting the paper's own
    experiments which schedule 30 000-task instances on it.  The
    paper's generator mimics historical nf-core traces, which are
    heavy-tailed (most tasks tiny, few huge); ``mem_dist="uniform"``
    restores the literal text.
    """
    rng = np.random.default_rng(seed)
    n = wf.n
    work = rng.uniform(*work_range, size=n) * work_multiplier
    if mem_dist == "uniform":
        mem = rng.uniform(*mem_range, size=n)
    elif mem_dist == "lognormal":
        v = rng.lognormal(mean=0.0, sigma=1.6, size=n)
        mem = np.maximum(v / v.max() * mem_range[1], mem_range[0])
    else:
        raise ValueError(f"unknown mem_dist {mem_dist!r}")
    for u in range(n):
        wf.work[u] = float(work[u])
        wf.mem[u] = float(mem[u])
    for u in range(n):
        for v in list(wf.succ[u]):
            c = float(rng.uniform(*edge_range))
            wf.succ[u][v] = c
            wf.pred[v][u] = c
    wf._flat_cache = None  # weights changed in place: drop the CSR view
    return wf


def scale_memory_to_platform(wf: Workflow, platform: Platform) -> Workflow:
    """Paper: grow processor memories proportionally until the most
    demanding task fits somewhere.  We instead scale task memory *down*
    by the equivalent factor, which keeps platform definitions fixed."""
    worst = max(wf.task_requirement(u) for u in range(wf.n))
    cap = platform.max_memory()
    if worst <= cap:
        return wf
    # small relative margin so float round-off in downstream sums can
    # never push the worst task above the largest memory again
    f = cap * (1.0 - 1e-9) / worst
    for u in range(wf.n):
        wf.mem[u] *= f
        for v in list(wf.succ[u]):
            wf.succ[u][v] *= f
            wf.pred[v][u] *= f
    wf._flat_cache = None  # weights changed in place: drop the CSR view
    return wf


def generate_workflow(
    family: str,
    n_tasks: int,
    seed: int = 0,
    *,
    platform: Platform | None = None,
    work_multiplier: float = 1.0,
) -> Workflow:
    """Generate a weighted workflow of ``family`` with ≈ ``n_tasks`` tasks."""
    if family not in _BUILDERS:
        raise KeyError(f"unknown family {family!r}; choose from {FAMILIES}")
    wf = _BUILDERS[family](n_tasks)
    random_weights(wf, seed, work_multiplier=work_multiplier)
    if platform is not None:
        scale_memory_to_platform(wf, platform)
    return wf


# ---------------------------------------------------------------------- #
# "real-like" instances: nf-core workflows are small (11–58 tasks) with
# long chains, sparse fans, and a heavy-tailed weight distribution where
# half the tasks carry weight 1 (missing historical data).
# ---------------------------------------------------------------------- #
def real_like_workflows(seed: int = 0) -> list[Workflow]:
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate((11, 17, 24, 37, 58)):
        wf = Workflow(name=f"nfcore_like_{n}")
        ids = [wf.add_task() for _ in range(n)]
        for v in range(1, n):
            # mostly chain-like: attach to a recent predecessor
            u = int(rng.integers(max(0, v - 4), v))
            wf.add_edge(ids[u], ids[v])
            if rng.random() < 0.25 and v >= 2:
                w = int(rng.integers(0, v - 1))
                if w != u:
                    wf.add_edge(ids[w], ids[v])
        for u in range(n):
            has_data = rng.random() < 0.5
            wf.work[u] = float(rng.uniform(10, 500)) if has_data else 1.0
            wf.mem[u] = float(rng.uniform(1, 100)) if has_data else 1.0
        for u in range(n):
            for v in list(wf.succ[u]):
                c = float(rng.uniform(1, 8))
                wf.succ[u][v] = c
                wf.pred[v][u] = c
        wf._flat_cache = None  # weights rewritten in place (see _flat_view)
        out.append(wf)
    return out


def random_layered_dag(
    n: int,
    seed: int = 0,
    *,
    width: int = 8,
    edge_prob: float = 0.35,
) -> Workflow:
    """Random layered DAG — used by property tests, not by benchmarks."""
    rng = np.random.default_rng(seed)
    wf = Workflow(name=f"random_{n}")
    layers: list[list[int]] = []
    made = 0
    while made < n:
        lw = int(rng.integers(1, width + 1))
        lw = min(lw, n - made)
        layers.append([wf.add_task() for _ in range(lw)])
        made += lw
    for li in range(1, len(layers)):
        for v in layers[li]:
            parents = layers[li - 1]
            got = False
            for u in parents:
                if rng.random() < edge_prob:
                    wf.add_edge(u, v, float(rng.uniform(1, 10)))
                    got = True
            if not got:
                u = parents[int(rng.integers(0, len(parents)))]
                wf.add_edge(u, v, float(rng.uniform(1, 10)))
    for u in range(wf.n):
        wf.work[u] = float(rng.uniform(1, 1000))
        wf.mem[u] = float(rng.uniform(1, 192))
    return wf


# ---------------------------------------------------------------------- #
# residual extraction: mid-trace replanning (repro_torch.scenario)
# ---------------------------------------------------------------------- #
def residual_workflow(
    wf: Workflow, completed: set[int]
) -> tuple[Workflow, list[int]]:
    """The workflow left to execute after ``completed`` tasks finished.

    Returns ``(residual, mapping)`` where ``mapping[i]`` is the
    original id of residual task ``i``.  ``completed`` must be closed
    under predecessors (a task cannot finish before its inputs exist) —
    exactly the invariant a simulated execution prefix satisfies.

    Frontier handling: tasks whose predecessors all completed become
    *sources* of the residual DAG.  Each file a completed producer
    feeds across the boundary is already materialized, so its transfer
    is not re-priced; its volume is folded into the consumer's task
    memory instead, which keeps the residual task requirement ``r_u``
    (inputs + outputs + task memory) identical to the original.  Moving
    such a consumer to another processor would in reality re-transfer
    the file — :mod:`repro_torch.scenario` reports those moves in its
    migration log, and pricing them is the checkpoint-cost-aware
    follow-on (ROADMAP).
    """
    bad = [u for u in completed
           if any(p not in completed for p in wf.pred[u])]
    if bad:
        raise ValueError(
            f"completed set not closed under predecessors (e.g. task "
            f"{bad[0]} completed before some of its inputs)"
        )
    remaining = [u for u in range(wf.n) if u not in completed]
    sub, mapping = wf.subgraph(remaining)
    sub.name = f"{wf.name}-residual"
    for i, u in enumerate(mapping):
        ext = sum(c for p, c in wf.pred[u].items() if p in completed)
        if ext:
            sub.mem[i] += ext
    return sub, mapping


# ---------------------------------------------------------------------- #
# serialization: a WfCommons-flavored JSON schema.
#
# WfCommons instances describe tasks (name/id/parents/children) in
# ``workflow.specification`` and measured runtimes in
# ``workflow.execution``; files carry the data volumes.  We mirror that
# split with unit-agnostic weight keys ("work", "memory", "persistent",
# file "size") and make files explicit ``source -> target`` records so
# the round trip is exact.  Real WfCommons dumps map onto this shape by
# renaming keys (runtimeInSeconds -> work, sizeInBytes -> size), which
# is what keeps the door open for dropping real instances in later.
# ---------------------------------------------------------------------- #
SCHEMA_VERSION = "repro-wfcommons-1.0"


def to_json(wf: Workflow, *, indent: int | None = None) -> str:
    """Serialize ``wf`` to the WfCommons-flavored JSON schema."""
    tasks = []
    execution = []
    files = []
    for u in range(wf.n):
        tasks.append({
            "id": f"t{u}",
            "name": wf.labels[u],
            "parents": [f"t{p}" for p in sorted(wf.pred[u])],
            "children": [f"t{c}" for c in sorted(wf.succ[u])],
        })
        execution.append({
            "id": f"t{u}",
            "work": wf.work[u],
            "memory": wf.mem[u],
            "persistent": wf.persistent[u],
        })
        for v in sorted(wf.succ[u]):
            files.append({
                "id": f"t{u}->t{v}",
                "size": wf.succ[u][v],
                "source": f"t{u}",
                "target": f"t{v}",
            })
    doc = {
        "name": wf.name,
        "schemaVersion": SCHEMA_VERSION,
        "workflow": {
            "specification": {"tasks": tasks, "files": files},
            "execution": {"tasks": execution},
        },
    }
    return json.dumps(doc, indent=indent)


class WorkflowValidationError(ValueError):
    """Structured :func:`from_json` rejection: what is wrong, where.

    ``code`` is a stable machine-readable kind (``"bad-json"``,
    ``"bad-schema"``, ``"duplicate-task-id"``, ``"dangling-edge"``,
    ``"self-loop"``, ``"cycle"``, ``"bad-weight"``), ``where`` names
    the offending record (task/file id) when there is one.  The service
    admission path turns this into a ``Rejection`` — malformed
    submissions must never crash the event loop.
    """

    def __init__(self, code: str, detail: str,
                 where: str | None = None) -> None:
        self.code = code
        self.detail = detail
        self.where = where
        at = f" at {where!r}" if where is not None else ""
        super().__init__(f"[{code}]{at}: {detail}")


def _checked_weight(value: object, key: str,
                    where: str) -> float:
    try:
        x = float(value)  # type: ignore[arg-type]
    except (TypeError, ValueError):
        raise WorkflowValidationError(
            "bad-weight", f"{key} is not a number: {value!r}", where
        ) from None
    if not (x >= 0.0) or x == float("inf"):  # NaN fails the >=
        raise WorkflowValidationError(
            "bad-weight", f"{key} must be finite and >= 0, got {x!r}",
            where)
    return x


def from_json(text: str) -> Workflow:
    """Rebuild a :class:`Workflow` from :func:`to_json` output.

    Tasks are numbered by their position in ``specification.tasks``
    (ids may be arbitrary strings); files are authoritative for edges
    and their weights, ``parents``/``children`` being derived views.
    Execution entries are optional per task (weights default to the
    ``add_task`` defaults, as in WfCommons instances lacking history).

    Malformed input raises :class:`WorkflowValidationError` — a
    structured rejection (duplicate task ids, dangling or self-loop
    file endpoints, cycles, negative/non-finite weights, schema
    violations), never a raw ``KeyError``/``TypeError`` from the guts.
    """
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as exc:
        raise WorkflowValidationError("bad-json", str(exc)) from None
    try:
        spec = doc["workflow"]["specification"]
        task_list = spec["tasks"]
    except (KeyError, TypeError) as exc:
        raise WorkflowValidationError(
            "bad-schema",
            f"missing workflow.specification.tasks ({exc!r})"
        ) from None
    if not isinstance(task_list, list):
        raise WorkflowValidationError(
            "bad-schema", "specification.tasks is not a list")
    if not task_list:
        raise WorkflowValidationError(
            "empty", "workflow has no tasks")
    wf = Workflow(name=str(doc.get("name", "workflow")))
    index: dict[str, int] = {}
    for t in task_list:
        if not isinstance(t, dict) or "id" not in t:
            raise WorkflowValidationError(
                "bad-schema", f"task record without an id: {t!r}")
        tid = t["id"]
        if tid in index:
            raise WorkflowValidationError(
                "duplicate-task-id",
                "task id appears more than once", str(tid))
        index[tid] = wf.add_task(label=t.get("name"))
    for f in spec.get("files", []):
        if not isinstance(f, dict):
            raise WorkflowValidationError(
                "bad-schema", f"file record is not an object: {f!r}")
        fid = str(f.get("id", f"{f.get('source')}->{f.get('target')}"))
        for end in ("source", "target"):
            if f.get(end) not in index:
                raise WorkflowValidationError(
                    "dangling-edge",
                    f"file {end} {f.get(end)!r} names no task", fid)
        if f["source"] == f["target"]:
            raise WorkflowValidationError(
                "self-loop", "file source equals target", fid)
        size = _checked_weight(f.get("size", 1.0), "size", fid)
        wf.add_edge(index[f["source"]], index[f["target"]], size)
    for e in doc["workflow"].get("execution", {}).get("tasks", []):
        if not isinstance(e, dict) or e.get("id") not in index:
            raise WorkflowValidationError(
                "dangling-edge",
                f"execution entry names no task: "
                f"{e.get('id') if isinstance(e, dict) else e!r}")
        u = index[e["id"]]
        eid = str(e["id"])
        wf.work[u] = _checked_weight(e.get("work", wf.work[u]),
                                     "work", eid)
        wf.mem[u] = _checked_weight(e.get("memory", wf.mem[u]),
                                    "memory", eid)
        wf.persistent[u] = _checked_weight(
            e.get("persistent", wf.persistent[u]), "persistent", eid)
    # Kahn's sweep: the mapping stack assumes a DAG everywhere, so a
    # cyclic submission must be rejected here, not hang downstream.
    indeg = [len(wf.pred[u]) for u in range(wf.n)]
    ready = [u for u, d in enumerate(indeg) if d == 0]
    seen = 0
    while ready:
        u = ready.pop()
        seen += 1
        for v in wf.succ[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                ready.append(v)
    if seen != wf.n:
        raise WorkflowValidationError(
            "cycle", f"{wf.n - seen} task(s) lie on a dependency cycle")
    return wf
