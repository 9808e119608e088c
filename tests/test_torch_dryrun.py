"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.op_analysis``,
``kernels.cost``) on the CPU.

* Counterparts of JAX's analyzer tests (``tests/test_dryrun_machinery.py``):
  a loop of products counts each iteration, nested loops multiply, a slice
  read inside a loop counts the slice's bytes.
* The cell cache and the traceback's paths, as JAX's.
* Parity with JAX's unsharded math (JAX's own builders fail on jax 0.9.0):
  the FLOPs of ``LM.loss`` forward and backward against ``analyze_hlo`` of
  ``jax.jit(jax.value_and_grad(loss))``'s compiled HLO, within 2 %, and the
  train step's argument bytes against XLA's ``argument_size_in_bytes`` of
  the unsharded jitted step (params, AdamW state, batch), exactly.
* The committed JAX cells: each llama3_8b 16 x 16 cell's ``argument_gib``.
* The kernels' meta branches: the plain versions' shapes and dtypes, the
  work of ``kernels/cost.py``, no launch counted.
* A hand count of one region's collectives on a fake 2 x 2 mesh.
* Both ``--production`` flags on a small registered shape, and
  ``--full-size``'s refusal of weights larger than the device.
"""
import importlib
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import SHAPES, ShapeConfig, get_config, get_smoke_config
from repro_torch.convert import param_tree, to_numpy_tree, tree_leaves
from repro_torch.kernels import cost
from repro_torch.launch import dryrun, serve, steps, train
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.op_analysis import analyze
from repro_torch.models import LM
from repro_torch.models.shards import on_shards

fa = importlib.import_module("repro_torch.kernels.flash_attention")
wkv = importlib.import_module("repro_torch.kernels.rwkv_wkv")

_REPO = Path(__file__).resolve().parents[1]
B, S, CHUNK = 2, 32, 16
SHAPES.setdefault("dry_unit_train", ShapeConfig("dry_unit_train", S, B, "train"))
SHAPES.setdefault("dry_unit_prod_train", ShapeConfig("dry_unit_prod_train", 16, 32, "train"))
SHAPES.setdefault("dry_unit_prod_decode", ShapeConfig("dry_unit_prod_decode", 64, 32, "decode"))


@pytest.fixture
def group_of_one():
    assert not dist.is_initialized()
    mesh = make_local_mesh(1, 1, device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.fixture
def fake_world():
    def start(world):
        assert not dist.is_initialized()
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------- #
# the analyzer
# ---------------------------------------------------------------------- #
class TestOpAnalysis:
    def test_loop_flops_counted_every_iteration(self):
        def f(x, w):
            for _ in range(10):
                x = x @ w
            return x

        x = torch.zeros(64, 64)
        _, st = analyze(f, x, x)
        assert st.flops == 10 * 2 * 64**3
        assert st.flops_by_rate == {"f32": 10 * 2 * 64**3}

    def test_nested_loops_multiply(self):
        def g(x, w):
            for _ in range(3):
                for _ in range(5):
                    x = x @ w
            return x

        x = torch.zeros(32, 32)
        assert analyze(g, x, x)[1].flops == 15 * 2 * 32**3

    def test_slice_not_counted_as_full_operand(self):
        def f(big):
            acc = torch.zeros(8, 256)
            for i in range(64):
                acc = acc + big[i * 8:(i + 1) * 8]
            return acc

        big = torch.zeros(1024, 256)
        st = analyze(f, big)[1]
        # 64 iterations touching ~8x256 floats each, not 1024x256 (JAX's bar)
        assert st.bytes_accessed < 64 * (8 * 256 * 4) * 12
        # each add reads two 8 x 256 slices and writes one
        assert st.bytes_accessed == 64 * 3 * 8 * 256 * 4 + 8 * 256 * 4

    def test_gather_counts_the_rows_it_reads(self):
        table = torch.zeros(1000, 64)
        idx = torch.arange(10)
        st = analyze(lambda t, i: t[i], table, idx)[1]
        assert st.bytes_accessed == 2 * 10 * 64 * 4

    def test_peak_counts_arguments_and_frees(self):
        x = torch.zeros(1024, 256)                 # 1 MiB

        def f(x):
            y = x * 2                              # + 1 MiB
            del x
            z = y + 1                              # + 1 MiB, the peak
            del y
            return z.sum()

        st = analyze(f, x)[1]
        assert st.argument_bytes == 2**20
        assert st.peak_bytes == 3 * 2**20


# ---------------------------------------------------------------------- #
# the cell cache
# ---------------------------------------------------------------------- #
class TestCellCaching:
    @pytest.mark.parametrize("text,ok", [('{"status": "ok", "arch": "a"}', True),
                                         ('{"status": "error", "error": "boom"}', False),
                                         ("{truncated", False)],
                             ids=["ok", "error", "unreadable"])
    def test_cached_ok(self, tmp_path, text, ok):
        p = tmp_path / "cell.json"
        p.write_text(text)
        assert dryrun._cached_ok(p) is ok
        assert not dryrun._cached_ok(tmp_path / "missing.json")

    def test_traceback_paths_relativized(self):
        tb = f'  File "{dryrun._REPO_ROOT}/src/repro_torch/launch/dryrun.py", line 1, in main\n'
        clean = dryrun._sanitize_traceback(tb)
        assert dryrun._REPO_ROOT not in clean
        assert 'File "src/repro_torch/launch/dryrun.py"' in clean

    def test_cells_are_jax_cells(self, monkeypatch):
        # JAX's dry run sets XLA_FLAGS when imported: JAX is started first,
        # and the variable is restored after the test
        jax.devices()
        monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
        from repro.launch import dryrun as jax_dryrun
        shapes = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
        ours = [c for c in dryrun.cells() if c[1] in shapes]
        assert ours == [c for c in jax_dryrun.cells() if c[1] in shapes]
        assert dryrun.cell_path("a", "b", True).parent.name == "dryrun_torch"


# ---------------------------------------------------------------------- #
# parity with JAX's unsharded math
# ---------------------------------------------------------------------- #
def _batch(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _products_jax_does_not_count(cfg) -> float:
    """The products the port runs that XLA's compiled HLO does not show as
    dots, by name:

    * the checkpointed loss chunk's logits: the port's checkpoint recomputes
      ``x @ table`` in the backward, while XLA:CPU computes that product
      once (2 B S d V);
    * each checkpointed KV chunk's ``p @ v``: the port's checkpoint reruns
      the whole chunk, while JAX's backward recomputes only what the VJP
      reads (2 B Hq S hd a layer, summed over the chunks);
    * less the label pick: JAX's forward contracts the logits with a
      one-hot (a dot of 2 B S V), the port gathers the label's column."""
    head = 2 * B * S * cfg.d_model * cfg.vocab_size
    pv = 2 * B * cfg.n_heads * S * cfg.hd * S * cfg.n_layers
    return head + pv - 2 * B * S * cfg.vocab_size


@pytest.mark.parametrize("arch", ["llama3_8b", "olmoe_1b_7b"])
def test_loss_flops_match_analyze_hlo(arch):
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.models import LM as JaxLM
    cfg = get_smoke_config(arch)
    model = LM(cfg, param_dtype=torch.float32, attn_chunk=CHUNK, remat="none", device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    data = _batch(cfg)
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    leaves = tree_leaves(param_tree(model))
    _, st = analyze(lambda: torch.autograd.grad(model.loss(batch), leaves))
    jm = JaxLM(cfg, param_dtype=jnp.float32, attn_chunk=CHUNK, max_seq=S + 8)
    params = jax.tree.map(jnp.asarray, to_numpy_tree(model))
    compiled = jax.jit(jax.value_and_grad(jm.loss)).lower(
        params, {k: jnp.asarray(v) for k, v in data.items()}).compile()
    want = analyze_hlo(compiled.as_text()).flops + _products_jax_does_not_count(cfg)
    assert st.flops == pytest.approx(want, rel=0.02)


def test_train_step_argument_bytes_match_xla(group_of_one):
    """The dry run's argument bytes of the train step (bf16 params, f32
    AdamW state, int32 batch) equal XLA's for JAX's unsharded jitted step."""
    from repro.models import LM as JaxLM
    from repro.optim import AdamWConfig, adamw_init, adamw_update
    cfg = get_smoke_config("llama3_8b")
    cell = dryrun.run_cell("llama3_8b", "dry_unit_train", multi_pod=False,
                           overrides={"cfg": cfg}, mesh=group_of_one, verbose=False)
    assert cell["status"] == "ok" and cell["mesh"] == "1x1"
    jm = JaxLM(cfg, param_dtype=jnp.bfloat16, attn_chunk=512, max_seq=S + 8, remat="full")
    params = jm.init(0)

    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jm.loss)(params, batch)
        return adamw_update(AdamWConfig(), params, grads, opt_state, 1.0)

    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    mem = jax.jit(step).lower(params, adamw_init(params), batch).compile().memory_analysis()
    assert cell["argument_bytes"] == mem.argument_size_in_bytes


@pytest.fixture(scope="module")
def llama_cells():
    """The three llama3_8b cells on the 16 x 16 production mesh."""
    out = {}
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert not dist.is_initialized()
        out[shape] = dryrun.run_cell("llama3_8b", shape, multi_pod=False, verbose=False)
        assert not dist.is_initialized()        # the fake group is torn down
    return out


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_argument_gib_matches_the_committed_jax_cell(llama_cells, shape):
    jax_cell = json.loads((_REPO / "experiments" / "dryrun" /
                           f"llama3_8b__{shape}__16x16.json").read_text())
    cell = llama_cells[shape]
    assert cell["status"] == "ok" and cell["n_chips"] == 256 and cell["mesh"] == "16x16"
    assert cell["policy"] == jax_cell["policy"]
    assert cell["argument_gib"] == jax_cell["argument_gib"]
    assert cell["model_flops_total"] == jax_cell["model_flops_total"]


def test_cells_count_the_kernels_per_rank(llama_cells):
    """Kernel launches per rank: 32 attention layers, twice forward under
    remat "full" with one backward each, none in decode; and the FFN
    computed over the rank's rows with every weight gathered keeps the
    useful fraction far below JAX's 0.731 (ROADMAP queue 1 item 3)."""
    train_cell = llama_cells["train_4k"]
    assert train_cell["kernel_launches"] == {"flash_attention_bhsd[wgmma]": 64,
                                             "flash_attention_bwd[backward_wgmma]": 32}
    assert llama_cells["prefill_32k"]["kernel_launches"] == {"flash_attention_bhsd[wgmma]": 32}
    assert llama_cells["decode_32k"]["kernel_launches"] == {}
    assert 0.0 < train_cell["useful_flop_frac"] < 0.2
    for cell in llama_cells.values():
        assert cell["per_device_bytes"] >= cell["argument_gib"] * 2**30 * 0.999
        assert cell["dominant"] in ("compute", "memory", "collective")


# ---------------------------------------------------------------------- #
# the kernels' meta branches
# ---------------------------------------------------------------------- #
def _recorded(fn):
    seen = []

    def sink(*a):
        seen.append(a)
    cost.add_sink(sink)
    try:
        out = fn()
    finally:
        cost.remove_sink(sink)
    return out, seen


@pytest.mark.parametrize("dtype,hd,variant", [(torch.bfloat16, 128, "wgmma"),
                                              (torch.float32, 64, "cuda_core")])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_meta_branch(dtype, hd, variant, causal):
    bh, bh_kv, s = 8, 2, 48
    cpu = [torch.randn(n, s, hd, dtype=dtype) for n in (bh, bh_kv, bh_kv)]
    meta = [t.to("meta").requires_grad_() for t in cpu]
    fa.reset_launch_counts()
    plain = fa.flash_attention_bhsd(*cpu, causal=causal)
    o, seen = _recorded(lambda: fa.flash_attention_bhsd(*meta, causal=causal))
    assert (o.shape, o.dtype, o.device.type) == (plain.shape, plain.dtype, "meta")
    rate = "bf16" if variant == "wgmma" else "f32"
    assert seen == [(f"flash_attention_bhsd[{variant}]", cost.attention_flops(bh, s, hd, causal),
                     cost.attention_bytes(bh, bh_kv, s, hd, cpu[0].element_size()), rate)]
    grads, seen = _recorded(lambda: torch.autograd.grad(o, meta, torch.empty_like(o)))
    assert [(g.shape, g.dtype) for g in grads] == [(t.shape, t.dtype) for t in cpu]
    bwd = fa.backward_variant(dtype, hd)
    assert seen == [(f"flash_attention_bwd[{bwd}]", cost.bwd_flops(bh, s, hd, causal),
                     cost.bwd_bytes(bh, bh_kv, s, hd, cpu[0].element_size()), rate)]
    assert fa.flash_attention_bhsd.launches == 0          # nothing launched


@pytest.mark.parametrize("dtype,hd,s,variant", [(torch.bfloat16, 64, 40, "chunked"),
                                                (torch.float32, 16, 5, "sequential")])
def test_wkv_meta_branch(dtype, hd, s, variant):
    b, h = 2, 3
    cpu = [torch.randn(b, h, s, hd, dtype=dtype) for _ in range(3)]
    cpu += [torch.rand(b, h, s, hd) * 0.5 + 0.4, torch.randn(h, hd) * 0.1,
            torch.zeros(b, h, hd, hd)]
    meta = [t.to("meta").requires_grad_(i < 5) for i, t in enumerate(cpu)]
    wkv.reset_launch_counts()
    plain = wkv.wkv_bhsd(*cpu)
    (out, sT), seen = _recorded(lambda: wkv.wkv_bhsd(*meta))
    assert [(t.shape, t.dtype) for t in (out, sT)] == [(t.shape, t.dtype) for t in plain]
    assert seen == [(f"wkv_bhsd[{variant}]", cost.wkv_flops(b, h, s, hd),
                     cost.wkv_bytes(b, h, s, hd, cpu[0].element_size(), 4), "f32")]
    grads, seen = _recorded(lambda: torch.autograd.grad(out, meta[:5], torch.empty_like(out)))
    assert [(g.shape, g.dtype) for g in grads] == [(t.shape, t.dtype) for t in cpu[:5]]
    bwd = wkv.backward_variant(dtype, torch.float32, hd, s)
    assert seen == [(f"wkv_bhsd_bwd[{bwd}]", cost.wkv_bwd_flops(b, h, s, hd),
                     cost.wkv_bwd_bytes(b, h, s, hd, cpu[0].element_size(), 4), "f32")]
    assert wkv.wkv_bhsd.launches == 0 and wkv.wkv_bhsd.dout_copies == 0


def test_cpu_tensors_record_nothing():
    q = torch.randn(2, 16, 16)
    _, seen = _recorded(lambda: fa.flash_attention_bhsd(q, q, q))
    assert seen == []


# ---------------------------------------------------------------------- #
# collectives
# ---------------------------------------------------------------------- #
def test_region_collectives_match_a_hand_count(fake_world):
    """On a fake 2 x 2 mesh: x [8, 16] split on both dims, w [16, 12] split
    over "data" on its rows.  The region wants w's rows over "model":
    one all-gather over "data" of w's local [8, 12] (384 bytes), then a
    local chunk.  x @ w over the split contraction leaves partial sums on
    "model"; making them whole is one all-reduce of the local [4, 12]
    (192 bytes, 2x on the wire).  FLOPs: the local product, 2 x 4 x 8 x 12."""
    fake_world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    x = DTensor.from_local(torch.empty(4, 8, device="meta"), mesh, [Shard(0), Shard(1)],
                           run_check=False)
    w = DTensor.from_local(torch.empty(8, 12, device="meta"), mesh, [Shard(0), Replicate()],
                           run_check=False)

    def step(x, w):
        y = on_shards(torch.matmul, [(x, [Shard(0), Shard(1)]), (w, [Replicate(), Shard(0)])],
                      [Shard(0), Partial()])
        return y.redistribute(mesh, [Shard(0), Replicate()])

    y, st = analyze(step, x, w)
    assert y.to_local().shape == (4, 12)
    c = st.collectives
    assert c.count_by_type == {"all-gather": 1, "all-reduce": 1}
    assert c.bytes_by_type == {"all-gather": 384.0, "all-reduce": 192.0}
    assert c.wire_bytes == 384 + 2 * 192
    assert st.flops == 2 * 4 * 8 * 12


# ---------------------------------------------------------------------- #
# the launchers' flags
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("launcher,shape", [(train, "dry_unit_prod_train"),
                                            (serve, "dry_unit_prod_decode")],
                         ids=["train", "serve"])
def test_production_flag_writes_an_ok_cell(launcher, shape, tmp_path, monkeypatch):
    monkeypatch.setattr(steps, "get_config", get_smoke_config)
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    assert launcher.main(["--arch", "llama3_8b", "--production", "--shape", shape]) == 0
    assert not dist.is_initialized()
    cell = json.loads(dryrun.cell_path("llama3_8b", shape, False).read_text())
    assert cell["status"] == "ok" and cell["mesh"] == "16x16" and cell["shape"] == shape


def test_full_size_keeps_the_refusal(monkeypatch):
    monkeypatch.setattr(serve, "_device_memory_bytes", lambda device: 80 * 10**9)
    monkeypatch.setattr(serve, "LM", None)          # never reached
    need = get_config("jamba_15_large").total_params() * 2
    with pytest.raises(ValueError, match=f"{need} bytes"):
        serve.main(["--arch", "jamba_15_large", "--full-size", "--device", "cpu"])


def test_run_cell_refuses_another_world(fake_world):
    fake_world(4)
    with pytest.raises(ValueError, match="256 ranks; this one has 4"):
        dryrun.run_cell("llama3_8b", "train_4k", multi_pod=False, verbose=False)
    assert dist.is_initialized()                    # the caller's group stays
