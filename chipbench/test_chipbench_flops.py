"""The yardstick: model FLOPs at each cell's shape against hand counts,
and the frozen kernel formulas against the program's own at those
shapes."""
import json

import pytest

from chipbench import flops, harness

CONFIGS = harness.HERE / "configs"


def _model(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["model"]


def _hand(d, hq, hkv, hd, f, e, k, layers, vocab, s, unembed_rows):
    """Per token: q, k, v, o; attention's two products over the causal
    pairs, averaged over the S queries; router; k experts' SwiGLU."""
    per_layer = (2 * d * hq * hd + 2 * 2 * d * hkv * hd + 2 * hq * hd * d
                 + 4 * hd * hq * (s + 1) / 2 + 2 * d * e + k * 6 * d * f)
    return layers * per_layer + 2 * d * vocab * unembed_rows


@pytest.mark.parametrize("config, seq, kind, gflop", [
    ("olmoe_1b_7b", 4096, "prefill", 2.42),
    ("olmoe_1b_7b_pp2", 4096, "train", 4.25),
    ("mixtral_8x7b", 32768, "prefill", 8.46),
    ("mixtral_8x7b", 2048, "prefill", 6.44),
])
def test_model_flops_per_token(config, seq, kind, gflop):
    m = _model(config)
    hd = m["d_model"] // m["n_heads"]
    rows = 1.0 / seq if kind == "prefill" else 1.0
    fwd = _hand(m["d_model"], m["n_heads"], m["n_kv_heads"], hd, m["d_ff"], m["n_experts"],
                m["experts_per_token"], m["n_layers"], m["vocab_size"], seq, rows)
    want = fwd if kind == "prefill" else 3 * fwd
    got = flops.model_flops_per_token(m, seq, kind)
    assert got == pytest.approx(want, rel=1e-12)
    assert got / 1e9 == pytest.approx(gflop, abs=0.006)


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        flops.model_flops_per_token(_model("olmoe_1b_7b"), 4096, "decode")


@pytest.mark.parametrize("bh, bh_kv, s, window", [
    (64, 64, 4096, 0), (32, 8, 32768, 0), (256, 64, 2048, 0), (16, 16, 4096, 0),
    (32, 8, 8192, 4096)])
def test_frozen_formulas_equal_the_programs(bh, bh_kv, s, window):
    cost = pytest.importorskip("repro_torch.kernels.cost")
    for causal in (True, False):
        assert flops.attention_pairs(s, causal, window) == cost.attention_pairs(s, causal, window)
        assert (flops.attention_flops(bh, s, 128, causal, window)
                == cost.attention_flops(bh, s, 128, causal, window))
        assert flops.bwd_flops(bh, s, 128, causal, window) == cost.bwd_flops(bh, s, 128, causal, window)
    assert flops.attention_bytes(bh, bh_kv, s, 128, 2) == cost.attention_bytes(bh, bh_kv, s, 128, 2)
    assert flops.bwd_bytes(bh, bh_kv, s, 128, 2) == cost.bwd_bytes(bh, bh_kv, s, 128, 2)
    assert flops.PEAK_FLOPS == cost.PEAK_FLOPS and flops.PEAK_BYTES == cost.PEAK_BYTES


def test_attention_pairs_by_hand():
    assert flops.attention_pairs(4, True) == 10
    assert flops.attention_pairs(4, False) == 16
    assert flops.attention_pairs(4, True, 2) == 7        # 1 + 2 + 2 + 2


def test_bound_takes_the_longer_term():
    assert flops.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert flops.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert flops.bound_s(67e12, 0.0, "f32") == pytest.approx(1.0)
