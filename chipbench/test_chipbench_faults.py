"""A run driven end to end on the CPU, past the harness's look for a
card, with the timed path broken underneath (``chipbench/faults.py``):
``correct`` comes out false for each fault a cell can have, and true
without one.  The cells run at smoke sizes in float32 against their own
limits.

Every prefill cell can have an answer or a token altered where it is
produced; a batched one also half of its batch left out, the rest given
the mean of the computed half's answers, and one slot's answer wrong.
The training cell can have a step that returns its state unchanged,
half of its batch left out with the mean taken over the rest, and a
token altered where it is produced.  No cell spans cards, so none can
leave out an exchange between them."""
import pytest

from chipbench import faults, harness

SMOKE = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 96,
         "vocab_size": 256, "n_experts": 8, "experts_per_token": 2}
PREFILL = ["olmoe_1b_7b.prefill_4x4k", "mixtral_8x7b.prefill_1x32k", "mixtral_8x7b.prefill_8x2k"]
BATCHED = ["olmoe_1b_7b.prefill_4x4k", "mixtral_8x7b.prefill_8x2k"]
SEED = 2**31 + 101


def _run(workload, hooks=None, **traffic):
    ctx = harness.make_ctx(workload, SEED, 0.2, False, device="cpu", config_overrides=SMOKE,
                           traffic_overrides=traffic)
    ctx.config = {**ctx.config, "param_dtype": "float32"}
    ctx.hooks = hooks or {}
    return harness.run_cell(ctx)


PREFILL_TRAFFIC = {"prompt_len": 48, "sample_requests": 16}


@pytest.mark.parametrize("workload", PREFILL)
def test_a_sound_prefill_run_is_correct(workload):
    out = _run(workload, **PREFILL_TRAFFIC)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(faults.PREFILL))
@pytest.mark.parametrize("workload", PREFILL)
def test_a_faulty_prefill_run_is_not_correct(workload, fault):
    out = _run(workload, {"prefill": faults.PREFILL[fault]}, **PREFILL_TRAFFIC)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(faults.BATCHED))
@pytest.mark.parametrize("workload", BATCHED)
def test_a_fault_confined_to_some_slots_is_not_correct(workload, fault):
    out = _run(workload, {"prefill": faults.BATCHED[fault]}, **PREFILL_TRAFFIC)
    assert not out["correct"], out["checks"]


def test_a_sound_training_run_is_correct():
    out = _run("olmoe_1b_7b.train_1x4k", seq_len=64)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "labels_altered"])
def test_a_faulty_training_run_is_not_correct(fault):
    out = _run("olmoe_1b_7b.train_1x4k", {"step": faults.TRAIN[fault]}, seq_len=64)
    assert not out["correct"], out["checks"]
