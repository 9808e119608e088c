"""The plain reference against the port at smoke sizes on the CPU, in
float32 on both sides: the last-position logits of both configurations,
a training cell's checked steps (loss, gradients, AdamW), and AdamW and
its schedule on their own.  The test imports both packages; the
reference imports nothing of the port."""
import pytest
import torch

from chipbench import harness, program
from chipbench.drivers import prefill_closed, train_steps
from chipbench.reference import AdamW, Reference, lowp_round
from chipbench.reference.adamw import lr_scale

SMOKE = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 96,
         "vocab_size": 256, "n_experts": 8, "experts_per_token": 2}
SEED = 2**31 + 11


def _ctx(workload, **traffic):
    ctx = harness.make_ctx(workload, SEED, 0.2, False, device="cpu", config_overrides=SMOKE,
                           traffic_overrides=traffic)
    ctx.config = {**ctx.config, "param_dtype": "float32"}
    return ctx


@pytest.mark.parametrize("workload", ["olmoe_1b_7b.prefill_4x4k", "mixtral_8x7b.prefill_8x2k"])
def test_last_logits_match_the_port(workload):
    from repro_torch.launch import serve
    ctx = _ctx(workload, prompt_len=96)
    lm = program.build_lm(ctx.config, SEED, 96, "cpu")
    tokens = prefill_closed.prompts(ctx, 0)
    got = serve.prefill(lm, tokens).float()
    ref = Reference(ctx.model, SEED, capacity_factor=1.25, device="cpu",
                    weight_dtype=torch.float32)
    want = ref.last_logits(tokens)
    assert torch.allclose(got, want, atol=2e-5 * float(want.abs().max()), rtol=0)


def test_a_training_cell_matches_the_port():
    ctx = _ctx("olmoe_1b_7b.train_1x4k", seq_len=64)
    rec = train_steps.run(ctx)
    n = rec["numbers"]
    assert n["loss_gap"] < 1e-6 and n["grad_gap"] < 1e-4 and n["change_gap"] < 1e-3, n
    prog, ref = rec["readings"]["program"], rec["readings"]["reference"]
    assert sorted(prog["grad1"]) == sorted(ref["grad1"])
    assert all(v > 0 for v in ref["change"].values())


def test_adamw_matches_the_ports():
    optim = pytest.importorskip("repro_torch.optim")
    from repro_torch.optim import schedules
    gen = torch.Generator().manual_seed(3)
    shapes = {"a": (8, 4, 5), "b": (7,), "c": (16, 3)}
    init = {n: torch.randn(s, generator=gen) for n, s in shapes.items()}
    grads = [{n: torch.randn(s, generator=gen) * 3 for n, s in shapes.items()} for _ in range(3)]
    mine = {n: t.clone() for n, t in init.items()}
    opt = AdamW(total=10_000)
    state = opt.init(mine)
    theirs = {n: t.clone() for n, t in init.items()}
    their_state = optim.adamw_init(theirs)
    cfg = optim.AdamWConfig()
    for g in grads:
        for n, p in mine.items():
            p.grad = g[n].clone()
        opt.step(mine, state)
        scale = schedules.warmup_cosine(their_state["step"], warmup=10, total=10_000)
        optim.adamw_update(cfg, theirs, {n: t.clone() for n, t in g.items()}, their_state, scale)
    for n in shapes:
        assert torch.allclose(mine[n], their_state["master"][n], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 500, 9999])
def test_lr_scale_matches_the_ports(step):
    from repro_torch.optim.schedules import warmup_cosine
    assert lr_scale(step, 10, 10_000) == pytest.approx(
        float(warmup_cosine(torch.tensor(step), warmup=10, total=10_000)), rel=1e-6)


def test_fp8_rounding_is_coarse_and_passes_gradients():
    x = torch.linspace(-3, 3, 1001, requires_grad=True)
    q = lowp_round(x, "fp8")
    err = (q - x).abs().max() / x.abs().max()
    assert 2**-6 < err < 2**-3
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    assert lowp_round(x, None) is x
