"""The control: the reference in the precision below the configuration's
(fp8 e4m3 operands for bf16), put in the program's place, must come out
as not correct.  At smoke size on the CPU here; at each cell's own size
on the card under the ``cuda`` marker:

    PYTHONPATH=src python -m pytest -m cuda chipbench/test_chipbench_control.py
"""
import pytest
import torch

from chipbench import harness
from chipbench.drivers import prefill_closed, train_steps

SMOKE = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 96,
         "vocab_size": 256, "n_experts": 8, "experts_per_token": 2}
PREFILL = ["olmoe_1b_7b.prefill_4x4k", "mixtral_8x7b.prefill_1x32k", "mixtral_8x7b.prefill_8x2k"]
TRAIN = "olmoe_1b_7b.train_1x4k"


def _prefill_control(ctx, n_requests):
    idx = prefill_closed.sample(ctx, n_requests)
    ref = prefill_closed.reference_logits(ctx, idx)
    got = prefill_closed.reference_logits(ctx, idx, lowp="fp8")
    return prefill_closed.served_numbers(got, ref, [i % ctx.traffic["clients"] for i in idx])


def _train_control(ctx):
    ref = train_steps.reference_readings(ctx)
    return train_steps.train_numbers(train_steps.reference_readings(ctx, lowp="fp8"), ref)


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
@pytest.mark.parametrize("workload", PREFILL)
def test_the_prefill_control_fails_at_smoke_size(workload, seed):
    ctx = harness.make_ctx(workload, seed, 1.0, False, device="cpu", config_overrides=SMOKE,
                           traffic_overrides={"prompt_len": 48, "sample_requests": 4})
    ok, checks = harness.judge(_prefill_control(ctx, 16), ctx.limits)
    assert not ok, checks


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_the_training_control_fails_at_smoke_size(seed):
    ctx = harness.make_ctx(TRAIN, seed, 1.0, False, device="cpu", config_overrides=SMOKE,
                           traffic_overrides={"seq_len": 64})
    ok, checks = harness.judge(_train_control(ctx), ctx.limits)
    assert not ok, checks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's own size")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
@pytest.mark.parametrize("workload", PREFILL + [TRAIN])
def test_the_control_fails_at_the_cells_size(card, workload, seed):
    ctx = harness.make_ctx(workload, seed, 1.0, False, device=card)
    if workload == TRAIN:
        numbers = _train_control(ctx)
    else:
        numbers = _prefill_control(ctx, 16 * ctx.traffic["sample_requests"])
    ok, checks = harness.judge(numbers, ctx.limits)
    assert not ok, checks
