"""The Hopper kernels against their plain versions, on the card.

These tests need an NVIDIA card and ``nvcc`` (a CUDA kernel has no CPU
form) and skip without one.  The file imports no JAX, so it also runs on
a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances (atol, rtol): f32 2e-5 for summation order, as
``tests/test_kernels.py``; bf16 1e-5 and 2**-7, because kernel and plain
version both compute in f32 and round once to bf16, so they differ by
at most one bf16 ulp of the output.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention_bhsd, flash_attention_bhsd_plain

_SHAPES = [
    (1, 32, 2, 2, 16),      # MHA
    (2, 64, 4, 2, 32),      # GQA 2:1
    (1, 128, 8, 1, 64),     # MQA
    (2, 48, 4, 4, 128),     # S not a multiple of the tile
    (1, 1000, 4, 2, 128),   # ragged S over several tiles
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    # the plain version runs f32 matmuls: keep them in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,hd", _SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(card, b, s, h, hkv, hd, dtype, causal):
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    gen = torch.Generator(device=card).manual_seed(b * s + h)
    q, k, v = (torch.randn((b * n, s, hd), generator=gen, device=card).to(tdt)
               for n in (h, hkv, hkv))
    before = flash_attention_bhsd.launches
    out = flash_attention_bhsd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bhsd.launches == before + 1
    assert out.dtype == tdt and out.shape == q.shape
    ref = flash_attention_bhsd_plain(q, k, v, causal=causal)
    atol, rtol = (2e-5, 2e-5) if dtype == "f32" else (1e-5, 2.0 ** -7)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros(4, 8, 128, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bhsd(q[..., :96].contiguous(), q[:2, :, :96].contiguous(),
                             q[:2, :, :96].contiguous())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_bhsd(q.half(), q[:2].half(), q[:2].half())
    with pytest.raises(ValueError, match="contiguous"):
        kt = torch.zeros(2, 128, 8, device=card).transpose(1, 2)
        flash_attention_bhsd(q, kt, kt)
