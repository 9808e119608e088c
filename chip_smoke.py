#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card and check it.

Run from the repo root with no arguments: ``python3 chip_smoke.py``.  It
needs one CUDA card and ``nvcc``; without a card it exits 1 and prints no
result.  Phases, each printing JSON lines and each ending the run with
a non-zero exit if it fails:

0. env         card name and power limit (nvidia-smi), torch/CUDA/nvcc versions
1. build       every kernel library from ``src/repro_torch/kernels/csrc``, one
               ``nvcc`` per source, all started together; ptxas registers,
               spills and shared memory of each; ``cuobjdump -sass`` must
               show HGMMA (wgmma) and UTMALDG (TMA loads) in every
               instantiation of the tensor-core flash forward and of both
               kernels of the tensor-core flash backward, and HMMA
               (mma.sync) and LDGSTS (cp.async) in every instantiation of
               the chunked WKV kernel
2. kernel      ``flash_attention_bhsd`` vs its plain version on the card, f32
               and bf16, causal both ways, at the test shapes, a ragged S=1000
               and every shape the later phases give it, each row naming the
               kernel that served it (tensor-core or CUDA-core); at S >= 256
               also a planted fault (one V tile zeroed) that the limit must
               reject; times at the one-layer prefill shape, with achieved
               TFLOP/s, share of the bound and the ratio to SDPA
3. wkv         ``wkv_bhsd`` vs its plain version, out and state, f32 and bf16
               r/k/v with f32 w, two laws of w, nonzero s0, at the test
               shapes and a ragged S=1000 (contiguous [B,H,S,hd]) and at
               every prefill and decode shape the RWKV phases give it
               (serve.main's 2 x 256 included) in the layout
               ``ops.rwkv_wkv`` gives it: [B,S,H,hd] tensors read through
               transposed views.  Each row names the kernel that served
               it (chunked or sequential) and, for bf16 at hd 64, holds
               the other kernel to the same limits; at S >= 256 a planted
               fault (one step's k v^T update dropped); one 4096 call
               against two 2048 calls with the state carried; times at
               the one-layer prefill shape (both kernels, in model layout
               and on contiguous copies), at the decode steps
               (S = 1), and at S = 1, 16, 32 and 64, where the wrapper's
               choice of kernel changes
4. prefill     full llama3_8b (32 layers, bf16, seeded random weights):
               ``prefill`` on 2 x 4096 tokens, 32 tensor-core kernel launches
               per call
5. consistency full width, 4 layers, f32 (TF32 off): prefill logits through
               the CUDA-core kernel vs decode logits through plain
               ``decode_attention``
6. serve       ``ServeLoop(slots=4, max_len=256)`` answering 8 requests on
               full llama3_8b; a torch.profiler window over one prefill
               call and one decode step; then ``serve.main(["--production",
               ...])`` end to end — llama's main path, whose flash launches
               are counted
7. rwkv        full rwkv6_1b6 (24 layers, bf16, seeded random weights):
               ``prefill`` on 2 x 4096 tokens, 24 chunked WKV launches per
               call; full width, 4 layers, f32: prefill logits vs decode
               logits, both through the sequential kernel; a profiler window
               over one prefill call and one decode step;
               ``serve.main(["--arch", "rwkv6_1b6", "--production", ...])``
               — RWKV's main path, whose WKV launches are counted by kernel
8. backward    both flash backward kernels (through ``flash_attention_bhsd``'s
               autograd Function) vs autograd of the plain version: dQ, dK
               and dV, f32 and bf16, causal both ways, at the test shapes,
               a ragged S=1000, the training shape and every shape the
               training phases give it; each row names the forward and
               the backward kernel that served it; at S >= 256 a planted
               fault (one dO tile zeroed in the plain run) that the limit
               must reject; every tensor-core backward call run twice,
               which must give identical bits; times at the training
               shape: the tensor-core and the CUDA-core backward on the
               same bf16 inputs, the CUDA-core one in f32, autograd of the
               plain version and SDPA's backward (the yardstick only),
               the five-product bound and the bound of the products the
               tensor-core kernel runs (``WGMMA_BWD_PRODUCTS``)
9. gradients   full width, 4 layers, f32 (TF32 off): ``LM.loss`` and every
               gradient leaf through the kernels vs the same with
               ``gqa_attention`` routed to the chunked torch scan
10. train      ``llama3_8b`` at full width, 8 layers, bf16 params, f32
               AdamW state, B=1 x S=4096: ``Trainer.step_fn`` on one
               repeated ``SyntheticTokens`` batch; train tokens/s, the
               forward/backward/AdamW split (CUDA events), peak memory and
               kernel launches per step (8 tensor-core backward launches,
               no CUDA-core one), a profiler window over one step (with
               the flash kernels' own device time),
               one ``remat="full"`` step, then the falling loss from fresh
               weights — the training main path, whose backward launches
               are counted
11. trainer    the smoke ``llama3_8b`` ``Trainer.run`` with async
               checkpoints, then a ``FailureInjector`` fault under
               ``run_with_restarts``: it resumes from the last checkpoint,
               and its losses equal the unfaulted run's bit for bit
12. kernels    the card's nvidia-smi line again, one JSON line listing every
               ported kernel, and the final ``{"ok": true, "device": ...}``.

Prefill calls and profile windows are timed after a full garbage
collection, and each reports the collector's seconds inside it; the
``done`` line sums the collector's pauses over the run.
"""
from __future__ import annotations

import gc
import importlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.configs import ShapeConfig, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import tree_leaves  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import attention as attention_mod  # noqa: E402
from repro_torch.models import transformer as transformer_mod  # noqa: E402
from repro_torch.models.rwkv import wkv_chunked  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.runtime import (FailureInjector, Request, ServeLoop, Trainer,  # noqa: E402
                                 TrainerConfig, run_with_restarts)

# the modules; the package's ``flash_attention`` and ``rwkv_wkv`` are the
# layout wrappers
fa = importlib.import_module("repro_torch.kernels.flash_attention")
wkv = importlib.import_module("repro_torch.kernels.rwkv_wkv")
KERNEL_SOURCES = ("flash_attention", "rwkv_wkv")
SEED = 0
# H100 SXM data sheet, dense: bf16 tensor cores, f32 on the CUDA cores, HBM3
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
# the llama3_8b prefill layer: B=1, S=4096, Hq=32, Hkv=8, hd=128, causal
MAIN_SHAPE = (1, 4096, 32, 8, 128)
PREFILL = (2, 4096)                 # prompt batch x length of phase 3
MAIN_PATH = (2, 256)                # batch x prompt length of serve.main below
KERNEL_SHAPES = [
    (1, 32, 2, 2, 16),      # MHA
    (2, 64, 4, 2, 32),      # GQA 2:1
    (1, 128, 8, 1, 64),     # MQA
    (2, 48, 4, 4, 128),     # S not a multiple of the tile
    (1, 1000, 32, 8, 128),  # ragged S at llama3_8b heads
    (2, 1000, 16, 4, 64),   # ragged S, GQA 4:1, the tensor-core kernel's hd 64
    MAIN_SHAPE,
    (*PREFILL, 32, 8, 128),     # what phase 3's prefill gives the kernel
    (*MAIN_PATH, 32, 8, 128),   # what serve.main's prefill gives it
]
# training: llama3_8b at full width with its depth cut to 8 of 32 layers
# (2.80 B parameters: params, grads, m, v and master take 44.8 GB), one
# sequence of 4096 tokens a step
TRAIN_LAYERS = 8
TRAIN_SHAPE = (1, 4096)             # batch x length of phase 10
TRAIN_STEPS = 6                     # timed steps on one repeated batch
# Peak lr of the falling-loss check.  The trainer's default (3e-4 after
# warmup-cosine's 10 steps) is the smoke configs' schedule: at full width
# Adam's first, sign-like steps of 3e-5 and 6e-5 move every output of a
# 4096-wide matrix by about lr * 4096, and the loss rose (12.27 to 13.16
# to 13.45; PERF.md §6).  At 1e-5 (steps of 1e-6, 2e-6, ...) the first
# order term leads.
TRAIN_LR = 1e-5
FALLING_STEPS = 5
GRAD_CHECK = (1, 256)               # batch x length of phase 9 (4 layers, f32)
GRAD_TOL = 1e-3                     # of each leaf's largest |gradient|
TRAINER_SHAPE = (16, 4)             # seq x batch of phase 11 (the CPU tests' TINY)
# the backward kernel's shapes: the forward's test shapes and ragged S,
# the training shape, and what phases 9 and 11 give it
BWD_SHAPES = KERNEL_SHAPES[:-2] + [
    (GRAD_CHECK[0], GRAD_CHECK[1], 32, 8, 128), (TRAINER_SHAPE[1], TRAINER_SHAPE[0], 4, 2, 16)]
# (atol, rtol) of kernel vs plain.  f32: tests/test_kernels.py's 2e-5 for
# summation order.  bf16: both sides compute in f32 from the same bf16
# inputs and round once to bf16, so they differ by at most one bf16 ulp,
# which is at most 2**-7 of |plain|; the atol covers the f32 summation
# noise near zero.  A limit that does not scale with the output would let
# a dropped tile through at S=4096, where |output| is about 0.03.
TOL = {"f32": (2e-5, 2e-5), "bf16": (1e-5, 2.0 ** -7)}
# bf16 products per pair of q row and key that the tensor-core backward
# runs (csrc/flash_attention.cu): S and dP twice in the dQ kernel and dS.K
# as hi and lo; S^T and dP^T in the dK/dV kernel (twice at hd 128, where
# both warpgroups of a block compute them), P^T.dO and dS^T.q as hi and lo
WGMMA_BWD_PRODUCTS = {64: 12, 128: 14}

# WKV shapes (b, s, h, hd): the JAX kernel tests' and a ragged S at the
# rwkv6_1b6 heads, contiguous; then what the RWKV phases give the kernel,
# in model layout
WKV_MAIN = (2, 4096, 32, 64)        # one rwkv6_1b6 prefill layer of phase 7
RWKV_MAIN_PATH = (2, 256, 16)       # batch, prompt length, new tokens
RWKV_CONSISTENCY = (2, 80)          # batch, length of the 4-layer f32 check
WKV_MODEL_SHAPES = [WKV_MAIN,
                    (*RWKV_MAIN_PATH[:2], 32, 64),  # serve.main's prefill
                    (*RWKV_CONSISTENCY, 32, 64),    # the 4-layer f32 prefill
                    (2, 1, 32, 64), (4, 1, 32, 64)]  # decode steps of batch 2 and 4
WKV_SHAPES = [(1, 16, 1, 8), (2, 32, 2, 16), (1, 64, 4, 64), (2, 24, 2, 32),
              (1, 1000, 32, 64), *WKV_MODEL_SHAPES]
# (atol, rtol) of kernel vs plain.  out: the sequential kernel sums the
# hd = 64 products r_i (S_ij + u_i k_i v_j) in a chain of FMAs, the plain
# version in a batched matmul, in another order.  Once the state is in
# steady state the partial sums reach about 25, so the two f32 results
# differ by about 2**-24 * sqrt(2 * sum of squared partial sums) ~ 1e-5
# (one standard deviation), whatever |out| is: the atol of 2e-4 is 20 of
# them, and rtol 1e-5 is tests/test_kernels.py's f32 bar.  bf16 out: both
# sides round an f32 value once to bf16, so they differ by at most one
# bf16 ulp (at most 2**-7 of |plain|) plus f32 noise; the chunked kernel
# (bf16 only) sums the same terms in 16-step chunks from bf16 parts of
# its f32 operands, whose f32 error stays far below that ulp.  The state
# is f32 in every case.  The sequential kernel updates each entry by one
# multiply and one FMA a step, the plain version likewise, so they differ
# by f32 rounding of a short chain: 1e-5.  The chunked kernel's update is
# a sum over a chunk's 16 steps of products with k*E split into three
# bf16 parts, which keeps f32 precision
# (tests/test_torch_wkv_numerics.py: 0.02-0.03 of this limit); the limit
# stays 1e-5.
WKV_TOL = {"f32": (2e-4, 1e-5), "bf16": (2e-4, 2.0 ** -7)}
WKV_STATE_TOL = (1e-5, 1e-5)
WKV_DECODE = (4, 1, 32, 64)         # one decode step of batch 4


# Python's collector pauses in this process, (generation, seconds) each: a
# full collection of a large heap stalls the host for up to a second or
# more, and one that lands in a timed call shows as a slow call
GC_PAUSES: list = []
_gc_start = [0.0]


def _gc_timer(phase: str, info: dict) -> None:
    if phase == "start":
        _gc_start[0] = time.perf_counter()
    else:
        GC_PAUSES.append((info["generation"], time.perf_counter() - _gc_start[0]))


def timed_call(fn):
    """(result, wall seconds, seconds of Python garbage collection inside)
    of one call, after a full collection so that the work of earlier
    phases is not collected inside the timed call."""
    gc.collect()
    torch.cuda.synchronize()
    n = len(GC_PAUSES)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, sum(p for _, p in GC_PAUSES[n:])


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attention_flops(bh, s, hd, causal) -> int:
    """The algorithm's operations: two products over the unmasked score pairs."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * hd * pairs * bh


def attention_bound_ms(bh, bh_kv, s, hd, causal, dtype, elem_bytes) -> tuple[float, str]:
    """Least time for the work: the unmasked score pairs' two products over
    the peak rate, or q/k/v read once and o written once over HBM."""
    t_ops = attention_flops(bh, s, hd, causal) / PEAK_FLOPS[dtype]
    t_bytes = (2 * bh + 2 * bh_kv) * s * hd * elem_bytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    # f32 phases compare against f32 references: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("env", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc.splitlines()[-1], python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         allow_tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32})
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        logs = list(pool.map(_build.build, KERNEL_SOURCES))   # raises if nvcc failed
    secs = time.perf_counter() - t0
    for name, log in zip(KERNEL_SOURCES, logs):
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "entry function" in ln or "registers" in ln or "spill" in ln
                 or "smem" in ln or "warning" in ln]
        emit("build", kernel=name, built=bool(log), ptxas=ptxas)
    emit("build", seconds=secs, kernels=list(KERNEL_SOURCES))
    lib = _build.load_library("flash_attention")
    emit("build", kernel="flash_attention", wgmma_dynamic_smem_bytes={
        hd: lib.repro_flash_attention_wgmma_smem_bytes(hd) for hd in fa.WGMMA_HEAD_DIMS},
         backward_wgmma_dynamic_smem_bytes={
             hd: {"dq": lib.repro_flash_attention_bwd_wgmma_smem_bytes(hd, 0),
                  "dkdv": lib.repro_flash_attention_bwd_wgmma_smem_bytes(hd, 1)}
             for hd in fa.WGMMA_HEAD_DIMS})
    # the tensor-core forward and both kernels of the tensor-core backward;
    # LDL/STL count local-memory loads and stores (spills)
    for kernel in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                   "flash_bwd_dkdv_wgmma_kernel"):
        sass = sass_instructions("flash_attention", kernel, ("HGMMA", "UTMALDG", "LDL", "STL"))
        emit("build", kernel="flash_attention", sass=sass)
        check(len(sass) == len(fa.WGMMA_HEAD_DIMS) and
              all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 for c in sass.values()),
              f"{kernel} lacks HGMMA or UTMALDG in its SASS: {sass}")
    lib = _build.load_library("rwkv_wkv")
    emit("build", kernel="rwkv_wkv", chunked_dynamic_smem_bytes={
        f"{'bf16' if bw else 'f32'}_w": lib.repro_wkv_chunked_smem_bytes(bw) for bw in (0, 1)})
    sass = sass_instructions("rwkv_wkv", "wkv_fwd_chunked_kernel",
                             ("HMMA", "LDSM", "LDGSTS", "HGMMA", "UTMALDG", "LDL", "STL"))
    emit("build", kernel="rwkv_wkv", sass=sass)
    check(len(sass) == 2 and
          all(c["HMMA"] > 0 and c["LDGSTS"] > 0 for c in sass.values()),
          f"the chunked WKV kernel lacks HMMA or LDGSTS in its SASS: {sass}")


def sass_instructions(source: str, kernel: str, opcodes) -> dict:
    """Count of each opcode in the SASS of every function of the built
    ``source`` library whose name contains ``kernel``."""
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    dump = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(source))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    counts, name = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            if kernel in name:
                counts[name] = dict.fromkeys(opcodes, 0)
        elif name in counts:
            for op in opcodes:
                counts[name][op] += f" {op}" in line
    return counts


def planted_fault(q, k, v, causal):
    """The plain version with one late V tile zeroed: what a kernel that
    drops one 64-key tile from its accumulator would return."""
    s = q.shape[1]
    t0 = (s - 1) // 64 * 64 - 64
    v = v.clone()
    v[:, t0:t0 + 64] = 0
    return fa.flash_attention_bhsd_plain(q, k, v, causal=causal)


def limit_ratio(out, ref, atol, rtol) -> float:
    """Largest |out - ref| / (atol + rtol |ref|): at most 1 within the limit."""
    return float(((out - ref).abs() / (atol + rtol * ref.abs())).max())


def cuda_core_bf16_ms(q, k, v, reps: int) -> float:
    """The CUDA-core kernel's time on bf16 inputs that the wrapper sends to
    the tensor-core kernel: the earlier design, timed in the same run.
    Called through its C entry point, so no launch count moves."""
    o = torch.empty_like(q)
    fn = fa._kernel("cuda_core")
    stream = torch.cuda.current_stream().cuda_stream
    bh, s, hd = q.shape
    launch = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),  # noqa: E731
                        None, bh, k.shape[0], s, hd, 1, 1, hd ** -0.5, stream)
    check(launch() == 0, "the CUDA-core kernel refused a bf16 launch")
    return time_ms(launch, reps)


def phase_kernel() -> tuple[dict, list]:
    """Kernel vs plain at every shape and dtype; times at the main shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    timed, rows = {}, []
    for b, s, h, hkv, hd in KERNEL_SHAPES:
        for name, dt in dtypes.items():
            q, k, v = (torch.randn((b * n, s, hd), generator=gen, device="cuda").to(dt)
                       for n in (h, hkv, hkv))
            for causal in (True, False):
                before = dict(fa.flash_attention_bhsd.variant_launches)
                out = fa.flash_attention_bhsd(q, k, v, causal=causal)
                served = [n for n, c in fa.flash_attention_bhsd.variant_launches.items()
                          if c != before[n]]
                ref = fa.flash_attention_bhsd_plain(q, k, v, causal=causal)
                torch.cuda.synchronize()
                atol, rtol = TOL[name]
                err = float((out.float() - ref.float()).abs().max())
                ok = bool(torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol))
                row = dict(shape=[b, s, h, hkv, hd], dtype=name, causal=causal,
                           variant=served[0] if len(served) == 1 else served,
                           max_abs_err=err, atol=atol, rtol=rtol, ok=ok,
                           limit_ratio=limit_ratio(out.float(), ref.float(), atol, rtol))
                check(row["variant"] == fa.kernel_variant(dt, hd),
                      f"launch counts show {served} serving {row}")
                if s >= 256:
                    bad = planted_fault(q, k, v, causal).float()
                    row["fault_max_abs_err"] = float((bad - ref.float()).abs().max())
                    row["fault_limit_ratio"] = limit_ratio(bad, ref.float(), atol, rtol)
                    row["fault_rejected"] = not bool(torch.allclose(
                        bad, ref.float(), atol=atol, rtol=rtol))
                    del bad
                if (b, s, h, hkv, hd) == MAIN_SHAPE and causal:
                    reps = 10
                    row["kernel_ms"] = time_ms(
                        lambda: fa.flash_attention_bhsd(q, k, v, causal=True), reps)
                    row["plain_ms"] = time_ms(
                        lambda: fa.flash_attention_bhsd_plain(q, k, v, causal=True), reps)
                    # yardstick only: the port never calls SDPA
                    q4, k4, v4 = (t.view(b, -1, s, hd) for t in (q, k, v))
                    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                        q4, k4, v4, is_causal=True, enable_gqa=True)
                    row["library_ms"] = time_ms(sdpa, reps)
                    row["library_max_abs_err"] = float(
                        (sdpa().reshape(out.shape).float() - ref.float()).abs().max())
                    row["bound_ms"], row["bound_by"] = attention_bound_ms(
                        b * h, b * hkv, s, hd, True, name, q.element_size())
                    row["achieved_tflops"] = (attention_flops(b * h, s, hd, True)
                                              / row["kernel_ms"] / 1e9)
                    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
                    row["kernel_over_library"] = row["kernel_ms"] / row["library_ms"]
                    if name == "bf16":
                        row["cuda_core_kernel_ms"] = cuda_core_bf16_ms(q, k, v, reps)
                    timed[name] = row
                emit("kernel", **row)
                rows.append(row)
                check(ok, f"flash_attention_bhsd disagrees with its plain version: {row}")
                check(row.get("fault_rejected", True),
                      f"the limit lets a zeroed V tile through: {row}")
            del q, k, v, out, ref
    return timed, rows


def wkv_inputs(b, s, h, hd, dtype, w_law, gen, model_layout=False):
    """r/k/v/w [B,H,S,hd], u [H,hd], s0 [B,H,hd,hd] f32 on the card.

    ``dtype`` "f32": all f32; "bf16": bf16 r/k/v/u with f32 w and s0, the
    model's mix.  w is drawn per element, by the JAX kernel tests' law
    ("uniform": U(0.2, 0.95)) or the model's ("model":
    exp(-min(exp(N(0,1)), 8))).  ``model_layout``: r/k/v/w are views of
    contiguous [B,S,H,hd] tensors, as ``ops.rwkv_wkv`` passes them."""
    shape = (b, s, h, hd) if model_layout else (b, h, s, hd)
    io = torch.float32 if dtype == "f32" else torch.bfloat16
    r, k, v = (torch.randn(shape, generator=gen, device="cuda").to(io) for _ in range(3))
    if w_law == "uniform":
        w = 0.2 + 0.75 * torch.rand(shape, generator=gen, device="cuda")
    else:
        w = torch.exp(-torch.randn(shape, generator=gen, device="cuda").exp().clamp(max=8.0))
    if model_layout:
        r, k, v, w = (x.transpose(1, 2) for x in (r, k, v, w))
    u = torch.randn((h, hd), generator=gen, device="cuda").to(io)
    s0 = torch.randn((b, h, hd, hd), generator=gen, device="cuda")
    return r, k, v, w, u, s0


def planted_wkv_fault(r, k, v, w, u, s0):
    """The plain version with the k_t v_t^T update of one late step t0
    dropped: what a kernel that loses one rank-1 update would return.
    out_t0 itself is right; every later output misses that term."""
    s = r.shape[2]
    t0 = 3 * s // 4
    part = lambda a, b, st: wkv.wkv_bhsd_plain(  # noqa: E731
        *(x[:, :, a:b] for x in (r, k, v, w)), u, st)
    o1, st = part(0, t0, s0)
    o2, _ = part(t0, t0 + 1, st)
    st = st * w[:, :, t0, :, None].float()
    o3, _ = part(t0 + 1, s, st)
    return torch.cat([o1, o2, o3], dim=2)


def wkv_bytes_ms(b, h, s, hd, io_bytes, w_bytes) -> float:
    """r/k/v/w/u/s0 read once and out/sT written once over HBM (ms)."""
    return (b * h * s * hd * (4 * io_bytes + w_bytes) + h * hd * io_bytes
            + 2 * b * h * hd * hd * 4) / PEAK_BYTES * 1e3


def wkv_bound_ms(b, h, s, hd, io_bytes, w_bytes) -> tuple[float, str]:
    """Least time for the work: 5 hd^2 f32 operations per (b, h, t) on the
    CUDA cores (r.S is hd^2 FMAs; the update one multiply and one FMA per
    element), or the bytes of :func:`wkv_bytes_ms`."""
    t_ops = 5 * hd * hd * b * h * s / PEAK_FLOPS["f32"] * 1e3
    t_bytes = wkv_bytes_ms(b, h, s, hd, io_bytes, w_bytes)
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def wkv_tensor_flops(b, h, s, hd) -> int:
    """The chunked kernel's tensor-core operations: per 16-step chunk and
    16 value columns, S^T (r*P)^T in three bf16 products (16 x 16 x hd),
    V^T A^T in two (16 x 16 x 16) and V^T (k*E) in three (16 x hd x 16).
    Work of the chunked form, beyond the recurrence's 5 hd^2 per step."""
    per_chunk = 2 * (3 * 16 * 16 * hd + 2 * 16 * 16 * 16 + 3 * 16 * hd * 16)
    return per_chunk * (hd // 16) * b * h * -(-s // 16)


def device_ms(fn, reps: int, kernel: str) -> float:
    """Device time per call of the kernels whose name contains ``kernel``,
    from ``torch.profiler``: for launches too short for CUDA events around
    a host-bound loop."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):      # the profiler has been seen to drop launches; retry
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key:
                us = getattr(e, "self_device_time_total", None)
                total += e.self_cuda_time_total if us is None else us
                count += e.count
        if count == reps:
            return total / 1e3 / reps
        seen.append(count)
        emit("profiler_retry", kernel=kernel, seen=count, want=reps)
    raise RuntimeError(f"profiler saw {seen} launches of {kernel} in three tries, want {reps}")


_WKV_KERNEL = {"chunked": "wkv_fwd_chunked_kernel", "sequential": "wkv_fwd_kernel"}


def wkv_served(args):
    """(out, sT, variant) of one wrapper call, the variant read from the
    launch counts."""
    before = dict(wkv.wkv_bhsd.variant_launches)
    out, sT = wkv.wkv_bhsd(*args)
    served = [n for n, c in wkv.wkv_bhsd.variant_launches.items() if c != before[n]]
    return out, sT, served[0] if len(served) == 1 else served


def phase_wkv() -> tuple[dict, list]:
    """WKV kernels vs plain at every shape, dtype and law of w; state
    carried across two calls; times at the one-layer prefill shape, the
    decode steps and the lengths where the wrapper's choice changes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    timed, rows = {}, []
    for b, s, h, hd in WKV_SHAPES:
        model_layout = (b, s, h, hd) in WKV_MODEL_SHAPES
        for dtype in ("f32", "bf16"):
            for w_law in ("uniform", "model"):
                args = wkv_inputs(b, s, h, hd, dtype, w_law, gen, model_layout)
                out, sT, variant = wkv_served(args)
                ref, sT_ref = wkv.wkv_bhsd_plain(*args)
                torch.cuda.synchronize()
                out, ref = out.float(), ref.float()
                atol, rtol = WKV_TOL[dtype]
                satol, srtol = WKV_STATE_TOL
                row = dict(shape=[b, s, h, hd], dtype=dtype, w_law=w_law, variant=variant,
                           layout="model [B,S,H,hd]" if model_layout else "[B,H,S,hd]",
                           max_abs_err=float((out - ref).abs().max()),
                           state_max_abs_err=float((sT - sT_ref).abs().max()),
                           atol=atol, rtol=rtol,
                           limit_ratio=limit_ratio(out, ref, atol, rtol),
                           state_limit_ratio=limit_ratio(sT, sT_ref, satol, srtol))
                check(variant == wkv.kernel_variant(args[0].dtype, args[3].dtype, hd, s),
                      f"launch counts show {variant} serving {row}")
                if dtype == "bf16" and hd == wkv.CHUNKED_HEAD_DIM:
                    # the kernel the wrapper did not pick, on the same inputs
                    other = "sequential" if variant == "chunked" else "chunked"
                    o2, s2 = wkv.launch(other, *args[:4], args[4].float(), args[5])
                    torch.cuda.synchronize()
                    o2 = o2.float()
                    row.update(other_variant=other,
                               other_max_abs_err=float((o2 - ref).abs().max()),
                               other_state_max_abs_err=float((s2 - sT_ref).abs().max()),
                               other_limit_ratio=limit_ratio(o2, ref, atol, rtol),
                               other_state_limit_ratio=limit_ratio(s2, sT_ref, satol, srtol))
                    del o2, s2
                row["ok"] = all(row.get(key, 0) <= 1 for key in (
                    "limit_ratio", "state_limit_ratio", "other_limit_ratio",
                    "other_state_limit_ratio"))
                if s >= 256:
                    bad = planted_wkv_fault(*args).float()
                    row["fault_max_abs_err"] = float((bad - ref).abs().max())
                    row["fault_limit_ratio"] = limit_ratio(bad, ref, atol, rtol)
                    row["fault_rejected"] = row["fault_limit_ratio"] > 1
                    del bad
                if (b, s, h, hd) == WKV_MAIN and w_law == "model":
                    half = s // 2
                    sl = lambda a, c: [x[:, :, a:c] for x in args[:4]]  # noqa: E731
                    o1, s_mid = wkv.wkv_bhsd(*sl(0, half), args[4], args[5])
                    o2, s_end = wkv.wkv_bhsd(*sl(half, s), args[4], s_mid)
                    two = torch.cat([o1, o2], dim=2).float()
                    row["two_calls_max_abs_err"] = float((two - out).abs().max())
                    row["two_calls_state_max_abs_err"] = float((s_end - sT).abs().max())
                    row["two_calls_bit_equal"] = bool(torch.equal(two, out)
                                                      and torch.equal(s_end, sT))
                    row["two_calls_ok"] = (limit_ratio(two, out, atol, rtol) <= 1 and
                                           limit_ratio(s_end, sT, satol, srtol) <= 1)
                    del o1, o2, two
                    if dtype == "bf16":
                        row.update(wkv_times(args))
                    timed[dtype] = row
                if s == 1 and dtype == "bf16" and w_law == "model":
                    row.update(wkv_decode_times(args))
                    timed[("decode", b)] = row
                emit("wkv", **row)
                rows.append(row)
                check(row["ok"], f"a WKV kernel disagrees with its plain version: {row}")
                check(row.get("fault_rejected", True),
                      f"the limit lets a dropped k v^T update through: {row}")
                check(row.get("two_calls_ok", True),
                      f"two calls with the state carried differ from one: {row}")
                del args, out, ref, sT, sT_ref
    wkv_choice_times(gen)
    return timed, rows


def wkv_times(args) -> dict:
    """Both kernels on ``args`` (model layout, as the main path gives
    them) and on contiguous copies, the plain version and the port's
    torch-only chunked form; bound from this shape's work."""
    r, k, v, w, u, s0 = args
    b, h, s, hd = r.shape
    uf = u.float()
    dense = [x.contiguous() for x in (r, k, v, w)]
    row = dict(kernel_ms=time_ms(lambda: wkv.wkv_bhsd(*args), 20),
               # the earlier design on the same inputs, through its C entry
               sequential_kernel_ms=time_ms(
                   lambda: wkv.launch("sequential", r, k, v, w, uf, s0), 5),
               contiguous_kernel_ms=time_ms(
                   lambda: wkv.launch("chunked", *dense, uf, s0), 20),
               sequential_contiguous_kernel_ms=time_ms(
                   lambda: wkv.launch("sequential", *dense, uf, s0), 5),
               plain_ms=time_ms(lambda: wkv.wkv_bhsd_plain(*args), 2))
    del dense
    # for later PRs: the port's torch-only chunked form (the JAX model's
    # prefill formulation) at the same shape, in its model layout.  Not a
    # library call and not used on the card: no PyTorch call computes WKV.
    tr = [x.transpose(1, 2).contiguous() for x in (r, k, v, w)]
    row["torch_chunked_ms"] = time_ms(lambda: wkv_chunked(*tr, u, s0, chunk=16), 3)
    row["library_ms"] = None
    row["bound_ms"], row["bound_by"] = wkv_bound_ms(
        b, h, s, hd, r.element_size(), w.element_size())
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    # the bytes alone: the floor of a kernel that runs the operations on
    # the tensor cores, as the chunked one does
    row["bytes_bound_ms"] = wkv_bytes_ms(b, h, s, hd, r.element_size(), w.element_size())
    row["bytes_bound_share"] = row["bytes_bound_ms"] / row["kernel_ms"]
    row["tensor_gflop"] = wkv_tensor_flops(b, h, s, hd) / 1e9
    row["tensor_tflops"] = wkv_tensor_flops(b, h, s, hd) / row["kernel_ms"] / 1e9
    row["sequential_over_chunked"] = row["sequential_kernel_ms"] / row["kernel_ms"]
    return row


def wkv_decode_times(args) -> dict:
    """The S = 1 decode step: the wrapper's kernel (device time from the
    profiler), the plain version and the bound."""
    r, k, v, w, u, s0 = args
    b, h, s, hd = r.shape
    variant = wkv.kernel_variant(r.dtype, w.dtype, hd, s)
    row = dict(kernel_ms=device_ms(lambda: wkv.wkv_bhsd(*args), 50, _WKV_KERNEL[variant]),
               plain_ms=time_ms(lambda: wkv.wkv_bhsd_plain(*args), 20), library_ms=None)
    row["bound_ms"], row["bound_by"] = wkv_bound_ms(
        b, h, s, hd, r.element_size(), w.element_size())
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    return row


def wkv_choice_times(gen) -> None:
    """Both kernels at S = 1, 16, 32 and 64 (batch 4, the model's heads, bf16):
    where the chunked kernel starts to pay, which sets CHUNKED_MIN_SEQ."""
    for s in (1, 16, 32, 64):
        b, h, hd = WKV_DECODE[0], WKV_DECODE[2], WKV_DECODE[3]
        r, k, v, w, u, s0 = wkv_inputs(b, s, h, hd, "bf16", "model", gen)
        uf = u.float()
        times = {name: device_ms(lambda n=name: wkv.launch(n, r, k, v, w, uf, s0), 50,
                                 _WKV_KERNEL[name])
                 for name in wkv.VARIANTS}
        emit("wkv_choice", shape=[b, s, h, hd], kernel_ms=times,
             wrapper_picks=wkv.kernel_variant(r.dtype, w.dtype, hd, s),
             chunked_min_seq=wkv.CHUNKED_MIN_SEQ)


def phase_prefill(model) -> dict:
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, s = PREFILL
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    launches, secs, gc_secs = [], [], []
    for _ in range(2):          # the first call also warms cuBLAS up
        fa.reset_launch_counts()
        logits, sec, gc_sec = timed_call(lambda: serve.prefill(model, tokens))
        secs.append(sec)
        gc_secs.append(gc_sec)
        launches.append(dict(fa.flash_attention_bhsd.variant_launches))
        check(tuple(logits.shape) == (b, cfg.vocab_size), f"logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
        check(launches[-1] == flash_counts(wgmma=cfg.n_layers),
              f"kernel launches in one prefill {launches[-1]}, want {cfg.n_layers} "
              f"of the tensor-core kernel")
    peak = torch.cuda.max_memory_allocated()
    # the kernel alone at this call's attention shape, to split the time
    q = torch.randn((b * cfg.n_heads, s, cfg.hd), generator=gen, device="cuda").bfloat16()
    kv = torch.randn((b * cfg.n_kv_heads, s, cfg.hd), generator=gen, device="cuda").bfloat16()
    attn_ms = time_ms(lambda: fa.flash_attention_bhsd(q, kv, kv, causal=True), 5)
    row = dict(arch=cfg.name, layers=cfg.n_layers, batch=b, seq=s, dtype="bf16",
               launches_per_call=launches, seconds=secs, gc_seconds_in_calls=gc_secs,
               tokens_per_s=b * s / secs[-1], peak_memory_gb=peak / 1e9,
               attention_kernel_ms_per_layer=attn_ms,
               attention_share=attn_ms * cfg.n_layers / 1e3 / secs[-1])
    emit("prefill", **row)
    return row


def phase_consistency(cfg_full) -> int:
    """Prefill logits vs decode logits, full width, 4 layers, f32; returns
    the CUDA-core kernel's launches in the prefill, the one path that runs
    it."""
    cfg = replace(cfg_full, n_layers=4)
    b, s = 2, 80                    # S not a multiple of the kernel's 64-row tile
    model = LM(cfg, param_dtype=torch.float32, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    fa.reset_launch_counts()
    last = serve.prefill(model, tokens)
    launches = dict(fa.flash_attention_bhsd.variant_launches)
    check(launches == flash_counts(cuda_core=cfg.n_layers),
          f"f32 prefill kernel launches {launches}, want {cfg.n_layers} of the CUDA-core kernel")
    with torch.no_grad():
        full = model(tokens)
        cache = model.init_cache(b, s, dtype=torch.float32)
        worst = 0.0
        for t in range(s):
            logits, cache = model.decode_step(cache, tokens[:, t:t + 1], t)
            worst = max(worst, float((logits[:, 0] - full[:, t]).abs().max()))
    err_last = float((logits[:, 0] - last).abs().max())
    emit("consistency", layers=cfg.n_layers, d_model=cfg.d_model, batch=b, seq=s,
         dtype="f32", max_abs_err_last=err_last, max_abs_err_all_positions=worst,
         tol=2e-3, kernel_launches=launches)
    check(err_last < 2e-3 and worst < 2e-3,
          f"prefill vs decode logits differ: last {err_last}, all {worst}")
    del model, cache, full
    return launches["cuda_core"]


def phase_serve(model) -> dict:
    cfg = model.cfg
    rng = np.random.default_rng(SEED)
    requests = [Request(i, rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
                        max_new_tokens=32)
                for i, n in enumerate(rng.integers(32, 129, size=8))]
    loop = ServeLoop(model, slots=4, max_len=256)
    for r in requests:
        loop.submit(r)
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = loop.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(len(done) == len(requests), f"{len(done)} of {len(requests)} requests finished")
    check(all(len(r.out) == 32 for r in done), "a request ended short of 32 tokens")
    prompt_tokens = sum(len(r.prompt) for r in requests)
    row = dict(requests=len(done), slots=4, max_len=256, prompt_tokens=prompt_tokens,
               new_tokens=32 * len(done), seconds=secs,
               decode_tokens_per_s=32 * len(done) / secs,
               processed_tokens_per_s=(prompt_tokens + 32 * len(done)) / secs,
               kernel_launches=dict(fa.flash_attention_bhsd.variant_launches))
    emit("serve", **row)
    return row


def profile_window(fn, reps: int, top: int = 6, named: str = "") -> dict:
    """Wall time per call unprofiled, then device time per call and the
    top kernels from ``torch.profiler`` over the same calls (and every
    kernel whose name contains ``named``).  The device-busy share compares
    the two: the profiler's own host cost does not enter the wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    _, secs, gc_secs = timed_call(lambda: [fn() for _ in range(reps)])
    wall_ms = secs * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_name = {}
    for e in prof.key_averages():
        # device-side entries only: a CPU op's own entry repeats the
        # time of the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        per_name[e.key] = per_name.get(e.key, 0.0) + us / 1e3 / reps
    device_ms = sum(per_name.values())
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    row = dict(reps=reps, wall_ms=wall_ms, gc_ms_in_wall=gc_secs * 1e3, device_ms=device_ms,
               device_busy_share=device_ms / wall_ms,
               top_device_ms=[[name[:80], ms] for name, ms in ranked])
    if named:
        row["named_device_ms"] = {name[:80]: ms for name, ms in per_name.items() if named in name}
    return row


def phase_profile(model) -> None:
    """Where the time goes in one prefill call and one 4-slot decode step."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, PREFILL, generator=gen, device="cuda")
    emit("profile", step="prefill", batch=PREFILL[0], seq=PREFILL[1],
         **profile_window(lambda: serve.prefill(model, tokens), 1))
    cache = model.init_cache(4, 256, dtype=torch.float32)
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen, device="cuda")
    pos = torch.tensor([200, 150, 100, 50], device="cuda")
    with torch.no_grad():
        step = lambda: model.decode_step(cache, tok, pos)  # noqa: E731
        emit("profile", step="decode", slots=4, cache_len=256,
             **profile_window(step, 10))


def flash_row(main_row: dict, checks: list, variant: str, launches: int, path: str) -> dict:
    """The kernels-line entry of one flash kernel: errors over the phase-2
    rows it served, times at the main shape in the dtype it serves there."""
    mine = [r for r in checks if r["variant"] == variant]
    return {
        "name": f"flash_attention_bhsd[{variant}]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "launches": launches,
        "launches_counted_on": path,
        "serves": ("bf16 at hd 64 and 128" if variant == "wgmma"
                   else "f32 at hd 16-128, bf16 at hd 16 and 32"),
        "max_abs_err": max(r["max_abs_err"] for r in mine),
        "max_abs_err_by_dtype": {d: max(r["max_abs_err"] for r in mine if r["dtype"] == d)
                                 for d in TOL if any(r["dtype"] == d for r in mine)},
        "tol": {d: {"atol": a, "rtol": r} for d, (a, r) in TOL.items()},
        "limit_ratio": max(r["limit_ratio"] for r in mine),
        "fault_limit_ratio_min": min(r["fault_limit_ratio"] for r in mine
                                     if "fault_limit_ratio" in r),
        "checked_shapes": sorted({tuple(r["shape"]) for r in mine}),
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "achieved_tflops": main_row["achieved_tflops"],
        "bound_share": main_row["bound_share"],
        "kernel_over_library": main_row["kernel_over_library"],
        "shape": main_row["shape"],
        "dtype": main_row["dtype"],
    }


def wkv_row(timed_row: dict, checks: list, variant: str, launches: int, path: str,
            **extra) -> dict:
    """The kernels-line entry of one WKV kernel: errors over every phase-3
    row it computed (served by the wrapper or launched beside the other
    kernel), times at the shape the main path gives it."""
    errs = [(r["dtype"], r["max_abs_err"], r["state_max_abs_err"], r["limit_ratio"],
             r["state_limit_ratio"]) for r in checks if r["variant"] == variant]
    errs += [(r["dtype"], r["other_max_abs_err"], r["other_state_max_abs_err"],
              r["other_limit_ratio"], r["other_state_limit_ratio"])
             for r in checks if r.get("other_variant") == variant]
    mine = [r for r in checks if r["variant"] == variant]
    row = {
        "name": f"wkv_bhsd[{variant}]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv_wkv.cu",
        "replaces": "src/repro/kernels/rwkv_wkv.py:61",
        "launches": launches,
        "launches_counted_on": path,
        "serves": (f"bf16 r/k/v at hd 64, S >= {wkv.CHUNKED_MIN_SEQ}" if variant == "chunked"
                   else f"the rest: f32 r/k/v, hd 8-32, bf16 at S < {wkv.CHUNKED_MIN_SEQ}"),
        "max_abs_err": max(e[1] for e in errs),
        "max_abs_err_by_dtype": {d: max(e[1] for e in errs if e[0] == d)
                                 for d in WKV_TOL if any(e[0] == d for e in errs)},
        "state_max_abs_err": max(e[2] for e in errs),
        "tol": {d: {"atol": a, "rtol": r} for d, (a, r) in WKV_TOL.items()},
        "state_tol": {"atol": WKV_STATE_TOL[0], "rtol": WKV_STATE_TOL[1]},
        "limit_ratio": max(e[3] for e in errs),
        "state_limit_ratio": max(e[4] for e in errs),
        "fault_limit_ratio_min": min((r["fault_limit_ratio"] for r in mine
                                      if "fault_limit_ratio" in r), default=None),
        "two_calls_bit_equal": all(r["two_calls_bit_equal"] for r in mine
                                   if "two_calls_bit_equal" in r),
        "checked_shapes": sorted({tuple(r["shape"]) for r in mine}),
        "checked_layouts": sorted({r["layout"] for r in checks if variant in (
            r["variant"], r.get("other_variant"))}),
        "ms": timed_row["kernel_ms"],
        "plain_ms": timed_row["plain_ms"],
        "bound_ms": timed_row["bound_ms"],
        "bound_by": timed_row["bound_by"],
        "library_ms": None,          # no PyTorch call computes WKV
        "bound_share": timed_row["bound_share"],
        "shape": timed_row["shape"],
        "dtype": "bf16 r/k/v/out, f32 w",
    }
    if variant == "chunked":
        row.update({key: timed_row[key] for key in (
            "bytes_bound_ms", "bytes_bound_share", "tensor_gflop", "tensor_tflops",
            "sequential_kernel_ms", "sequential_over_chunked", "contiguous_kernel_ms",
            "sequential_contiguous_kernel_ms", "torch_chunked_ms")})
    if "at_prefill_ms" in extra:
        row["ms_at_prefill_shape"] = extra["at_prefill_ms"]
    if "decode_batch4" in extra:
        d = extra["decode_batch4"]
        row["decode_batch4"] = {key: d[key] for key in ("shape", "kernel_ms", "plain_ms",
                                                        "bound_ms", "bound_by")}
    return row


def reset_launches() -> None:
    fa.reset_launch_counts()
    wkv.reset_launch_counts()


def flash_counts(**launches) -> dict:
    """A full ``variant_launches`` dict of the flash kernels: the given
    counts, 0 for every other variant."""
    return {**dict.fromkeys(fa.VARIANTS, 0), **launches}


def phase_main_path() -> int:
    """``serve.main --production``: prefill then greedy decode on the card."""
    argv = ["--arch", "llama3_8b", "--production", "--batch", str(MAIN_PATH[0]),
            "--prompt-len", str(MAIN_PATH[1]), "--tokens", "16"]
    reset_launches()
    t0 = time.perf_counter()
    rc = serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(fa.flash_attention_bhsd.variant_launches)
    emit("serve_main", argv=argv, rc=rc, seconds=time.perf_counter() - t0,
         kernel_launches=launches, wkv_launches=wkv.wkv_bhsd.launches)
    check(rc == 0, f"serve.main exited {rc}")
    want = get_config("llama3_8b").n_layers    # one launch per layer, one prefill
    check(launches == flash_counts(wgmma=want),
          f"kernel launches on the main path {launches}, want {want} of the tensor-core kernel")
    check(wkv.wkv_bhsd.launches == 0, "the llama path launched the WKV kernel")
    return launches["wgmma"]


def phase_rwkv_prefill(model, wkv_ms: float) -> dict:
    """Full rwkv6_1b6 prefill: one chunked WKV launch per layer; ``wkv_ms``
    is phase 3's kernel time at this call's one-layer shape."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    b, s = PREFILL
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    launches, secs, gc_secs = [], [], []
    for _ in range(2):          # the first call also warms cuBLAS up
        wkv.reset_launch_counts()
        logits, sec, gc_sec = timed_call(lambda: serve.prefill(model, tokens))
        secs.append(sec)
        gc_secs.append(gc_sec)
        launches.append(dict(wkv.wkv_bhsd.variant_launches))
        check(tuple(logits.shape) == (b, cfg.vocab_size), f"logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "rwkv prefill logits are not finite")
        check(launches[-1] == {"chunked": cfg.n_layers, "sequential": 0},
              f"WKV launches in one prefill {launches[-1]}, want {cfg.n_layers} chunked")
    row = dict(arch=cfg.name, layers=cfg.n_layers, batch=b, seq=s, dtype="bf16",
               launches_per_call=launches, seconds=secs, gc_seconds_in_calls=gc_secs,
               tokens_per_s=b * s / secs[-1],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               wkv_kernel_ms_per_layer=wkv_ms,
               wkv_share=wkv_ms * cfg.n_layers / 1e3 / secs[-1])
    emit("rwkv_prefill", **row)
    return row


def phase_rwkv_consistency(cfg_full) -> None:
    """Prefill logits through the kernel vs decode logits through its
    S = 1 steps, at every position: full width, 4 layers, f32."""
    cfg = replace(cfg_full, n_layers=4)
    b, s = RWKV_CONSISTENCY
    model = LM(cfg, param_dtype=torch.float32, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    wkv.reset_launch_counts()
    last = serve.prefill(model, tokens)
    prefill_launches = dict(wkv.wkv_bhsd.variant_launches)
    check(prefill_launches == {"chunked": 0, "sequential": cfg.n_layers},
          f"f32 rwkv prefill WKV launches {prefill_launches}, want {cfg.n_layers} sequential")
    with torch.no_grad():
        full = model(tokens)
        wkv.reset_launch_counts()
        cache = model.init_cache(b, s, dtype=torch.float32)
        worst = 0.0
        for t in range(s):
            logits, cache = model.decode_step(cache, tokens[:, t:t + 1], t)
            worst = max(worst, float((logits[:, 0] - full[:, t]).abs().max()))
    decode_launches = wkv.wkv_bhsd.variant_launches["sequential"]
    err_last = float((logits[:, 0] - last).abs().max())
    emit("rwkv_consistency", layers=cfg.n_layers, d_model=cfg.d_model, batch=b, seq=s,
         dtype="f32", max_abs_err_last=err_last, max_abs_err_all_positions=worst,
         prefill_launches=prefill_launches, decode_launches=decode_launches, tol=2e-3)
    check(decode_launches == wkv.wkv_bhsd.launches == cfg.n_layers * s,
          "rwkv decode missed the sequential kernel")
    check(err_last < 2e-3 and worst < 2e-3,
          f"rwkv prefill vs decode logits differ: last {err_last}, all {worst}")
    del model, cache, full


def phase_rwkv_profile(model) -> None:
    """Where the time goes in one rwkv6_1b6 prefill call and one decode
    step of batch 4."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    tokens = torch.randint(0, cfg.vocab_size, PREFILL, generator=gen, device="cuda")
    emit("rwkv_profile", step="prefill", batch=PREFILL[0], seq=PREFILL[1],
         **profile_window(lambda: serve.prefill(model, tokens), 1, top=12))
    cache = model.init_cache(4, 1, dtype=torch.float32)
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen, device="cuda")
    with torch.no_grad():
        step = lambda: model.decode_step(cache, tok, 0)  # noqa: E731
        emit("rwkv_profile", step="decode", batch=4, **profile_window(step, 10))


def phase_rwkv_main_path() -> dict:
    """``serve.main --arch rwkv6_1b6 --production``: one chunked WKV
    launch per layer for the prefill, and one sequential launch per layer
    for each of the prompt's teacher-forced decode steps and each new
    token."""
    batch, plen, new = RWKV_MAIN_PATH
    argv = ["--arch", "rwkv6_1b6", "--production", "--batch", str(batch),
            "--prompt-len", str(plen), "--tokens", str(new)]
    reset_launches()
    t0 = time.perf_counter()
    rc = serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(wkv.wkv_bhsd.variant_launches)
    emit("rwkv_serve_main", argv=argv, rc=rc, seconds=time.perf_counter() - t0,
         kernel_launches=launches, flash_launches=fa.flash_attention_bhsd.launches)
    check(rc == 0, f"serve.main exited {rc}")
    n_layers = get_config("rwkv6_1b6").n_layers
    want = {"chunked": n_layers, "sequential": n_layers * (plen + new)}
    check(launches == want and wkv.wkv_bhsd.launches == sum(want.values()),
          f"WKV launches on the RWKV main path {launches}, want {want}")
    check(fa.flash_attention_bhsd.launches == 0, "the RWKV path launched flash attention")
    return launches


def bwd_flops(bh, s, hd, causal) -> int:
    """The backward's operations: five products (scores, dP, dV, dK, dQ)
    over the unmasked score pairs, 2.5x the forward's two."""
    return attention_flops(bh, s, hd, causal) * 5 // 2


def bwd_bound_ms(bh, bh_kv, s, hd, causal, dtype, elem_bytes) -> tuple[float, str]:
    """Least time for the backward's work: its operations over the peak
    rate of the input type, or q/k/v/dO and the f32 lse read once and
    dq/dk/dv written once over HBM."""
    t_ops = bwd_flops(bh, s, hd, causal) / PEAK_FLOPS[dtype]
    t_bytes = ((3 * bh + 4 * bh_kv) * s * hd * elem_bytes + 4 * bh * s) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def attention_grads(fn, q, k, v, do, causal):
    """(out, (dq, dk, dv)) of ``fn`` by autograd on fresh leaves."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves, causal=causal)
    return out, torch.autograd.grad(out, leaves, do)


def planted_bwd_fault(q, k, v, do, causal):
    """Autograd of the plain version with one late 64-row dO tile zeroed:
    what a kernel that drops one q tile from its sums would return."""
    s = q.shape[1]
    t0 = (s - 1) // 64 * 64 - 64
    do = do.clone()
    do[:, t0:t0 + 64] = 0
    return attention_grads(fa.flash_attention_bhsd_plain, q, k, v, do, causal)[1]


def phase_backward() -> tuple[dict, list]:
    """Both backward kernels vs autograd of the plain version at every
    shape and dtype; the tensor-core one run twice for identical bits;
    times at the training shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    timed, rows = {}, []
    for b, s, h, hkv, hd in BWD_SHAPES:
        for name, dt in dtypes.items():
            q, k, v, do = (torch.randn((b * n, s, hd), generator=gen, device="cuda").to(dt)
                           for n in (h, hkv, hkv, h))
            for causal in (True, False):
                before = dict(fa.flash_attention_bhsd.variant_launches)
                _, grads = attention_grads(fa.flash_attention_bhsd, q, k, v, do, causal)
                served = sorted(n for n, c in fa.flash_attention_bhsd.variant_launches.items()
                                if c != before[n])
                _, ref = attention_grads(fa.flash_attention_bhsd_plain, q, k, v, do, causal)
                torch.cuda.synchronize()
                atol, rtol = TOL[name]
                ratios = {g: limit_ratio(out.float(), r.float(), atol, rtol)
                          for g, out, r in zip(("dq", "dk", "dv"), grads, ref)}
                row = dict(shape=[b, s, h, hkv, hd], dtype=name, causal=causal,
                           forward_kernel=fa.kernel_variant(dt, hd),
                           backward_kernel=fa.backward_variant(dt, hd), launched=served,
                           max_abs_err=max(float((g.float() - r.float()).abs().max())
                                           for g, r in zip(grads, ref)),
                           limit_ratio_by_grad=ratios, limit_ratio=max(ratios.values()),
                           atol=atol, rtol=rtol)
                row["ok"] = row["limit_ratio"] <= 1
                check(served == sorted([row["backward_kernel"], row["forward_kernel"]]),
                      f"launch counts show {served} serving {row}")
                if row["backward_kernel"] == "backward_wgmma":
                    again = attention_grads(fa.flash_attention_bhsd, q, k, v, do, causal)[1]
                    row["two_calls_bit_equal"] = all(torch.equal(a, g)
                                                     for a, g in zip(again, grads))
                    del again
                if s >= 256:
                    bad = planted_bwd_fault(q, k, v, do, causal)
                    row["fault_limit_ratio"] = max(limit_ratio(x.float(), r.float(), atol, rtol)
                                                   for x, r in zip(bad, ref))
                    row["fault_rejected"] = row["fault_limit_ratio"] > 1
                    del bad
                if (b, s, h, hkv, hd) == MAIN_SHAPE and causal:
                    row.update(backward_times(q, k, v, do, name))
                    timed[name] = row
                emit("backward", **row)
                rows.append(row)
                check(row["ok"], f"the backward kernel disagrees with autograd of the plain "
                                 f"version: {row}")
                check(row.get("fault_rejected", True),
                      f"the limit lets a zeroed dO tile through: {row}")
                check(row.get("two_calls_bit_equal", True),
                      f"two identical tensor-core backward calls differ: {row}")
                del grads, ref
            del q, k, v, do
    return timed, rows


def cuda_core_bwd_bf16_ms(q, k, v, lse, do, reps: int) -> float:
    """The CUDA-core backward's time on bf16 inputs that the wrapper sends
    to the tensor-core one: the earlier design, timed in the same run.
    Called through its C entry point, so no launch count moves."""
    bh, s, hd = q.shape
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = fa._kernel("backward")
    stream = torch.cuda.current_stream().cuda_stream
    launch = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),  # noqa: E731
                        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), bh, k.shape[0], s, hd, 1, 1, hd ** -0.5, stream)
    check(launch() == 0, "the CUDA-core backward refused a bf16 launch")
    return time_ms(launch, reps)


def backward_times(q, k, v, do, name) -> dict:
    """The backward kernel that serves these inputs alone (and, in bf16,
    the CUDA-core one on the same inputs), backward only of autograd of
    the plain version and of SDPA (the yardstick: the port never calls
    it); the bound from this shape's work."""
    bh, s, hd = q.shape
    reps = 5
    _, lse = fa._forward(q, k, v, True, with_lse=True)
    row = dict(kernel_ms=time_ms(
        lambda: fa.flash_attention_bwd(q, k, v, lse, do, causal=True), 10))
    if name == "bf16":
        row["cuda_core_kernel_ms"] = cuda_core_bwd_bf16_ms(q, k, v, lse, do, reps)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_bhsd_plain(*leaves, causal=True)
    row["plain_ms"] = time_ms(
        lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 2)
    del out
    b = 1
    q4, k4, v4 = (t.view(b, -1, s, hd) for t in leaves)
    out = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                           enable_gqa=True)
    do4 = do.view(b, -1, s, hd)
    row["library_ms"] = time_ms(
        lambda: torch.autograd.grad(out, leaves, do4, retain_graph=True), reps)
    del out
    flops = bwd_flops(bh, s, hd, True)
    row["bound_ms"], row["bound_by"] = bwd_bound_ms(bh, k.shape[0], s, hd, True, name,
                                                    q.element_size())
    if name == "bf16":
        # the products the tensor-core kernel runs, against the algorithm's 5
        row["executed_products"] = WGMMA_BWD_PRODUCTS[hd]
        row["executed_bound_ms"] = flops * WGMMA_BWD_PRODUCTS[hd] / 5 / PEAK_FLOPS["bf16"] * 1e3
        row["executed_bound_share"] = row["executed_bound_ms"] / row["kernel_ms"]
        row["cuda_core_over_kernel"] = row["cuda_core_kernel_ms"] / row["kernel_ms"]
    row["f32_cuda_core_bound_ms"] = flops / PEAK_FLOPS["f32"] * 1e3
    row["kernel_tflops"] = flops / row["kernel_ms"] / 1e9
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    row["kernel_over_library"] = row["kernel_ms"] / row["library_ms"]
    return row


def scan_route(q, k, v, *, causal=True, chunk=512, sliding_window=0):
    """``gqa_attention`` by the chunked torch scan, on any device: the CPU
    route of the model, differentiated by autograd."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    og = attention_mod._chunked_gqa(q.reshape(b, s, hkv, hq // hkv, hd), k, v, causal=causal,
                                    chunk=min(chunk, s), sliding_window=sliding_window)
    return og.reshape(b, s, hq, hd)


def model_grads(model, batch) -> tuple[float, dict]:
    for p in model.parameters():
        p.grad = None
    loss = model.loss(batch)
    loss.backward()
    grads = {name: p.grad.detach().clone() for name, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return float(loss.detach()), grads


def phase_gradients(cfg_full) -> int:
    """``LM.loss`` and every gradient leaf through the kernels (CUDA-core
    forward, backward kernel) vs the same with attention routed to the
    chunked torch scan: full width, 4 layers, f32, TF32 off.  Returns the
    backward kernel's launches in the kernel route."""
    cfg = replace(cfg_full, n_layers=4)
    model = LM(cfg, param_dtype=torch.float32, seed=SEED, device="cuda")
    for p in model.parameters():
        p.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    b, s = GRAD_CHECK
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    fa.reset_launch_counts()
    loss_k, grads_k = model_grads(model, batch)
    launches = dict(fa.flash_attention_bhsd.variant_launches)
    original = transformer_mod.attn.gqa_attention
    transformer_mod.attn.gqa_attention = scan_route
    try:
        fa.reset_launch_counts()
        loss_s, grads_s = model_grads(model, batch)
        scan_launches = fa.flash_attention_bhsd.launches
    finally:
        transformer_mod.attn.gqa_attention = original
    errs = {name: float((g - grads_s[name]).abs().max() / grads_s[name].abs().max().clamp(
        min=1e-30)) for name, g in grads_k.items()}
    worst = max(errs, key=errs.get)
    row = dict(layers=cfg.n_layers, d_model=cfg.d_model, batch=b, seq=s, dtype="f32",
               loss_kernels=loss_k, loss_scan=loss_s, loss_abs_err=abs(loss_k - loss_s),
               leaves=len(errs), worst_leaf=worst, worst_rel_err=errs[worst],
               median_rel_err=statistics.median(errs.values()), limit=GRAD_TOL,
               kernel_launches=launches, scan_route_flash_launches=scan_launches)
    emit("gradients", **row)
    check(launches == flash_counts(cuda_core=cfg.n_layers, backward=cfg.n_layers),
          f"kernel-route launches {launches}")
    check(scan_launches == 0, "the scan route launched a flash kernel")
    check(all(e <= GRAD_TOL for e in errs.values()) and abs(loss_k - loss_s) < 1e-4,
          f"gradients through the kernels differ from the scan route: {row}")
    del model, grads_k, grads_s
    return launches["backward"]


def phase_train(cfg_full) -> dict:
    """Full-width llama3_8b, 8 layers, bf16 params: ``Trainer.step_fn`` on
    one repeated batch, timed at the trainer's default AdamW; one
    ``remat="full"`` step; then fresh weights at peak lr ``TRAIN_LR``,
    where the loss must fall.  The training main path: the launch counts
    are reset just before the timed steps and read just after."""
    cfg = replace(cfg_full, n_layers=TRAIN_LAYERS)
    seq, batch_size = TRAIN_SHAPE[1], TRAIN_SHAPE[0]
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(cfg, ShapeConfig("train_4k_b1", seq, batch_size, "train"),
                          TrainerConfig(steps=TRAIN_STEPS, ckpt_dir=ckpt_dir),
                          param_dtype=torch.bfloat16, device="cuda")
        params = trainer.params()
        opt_state = adamw_init(params)
        n_params = sum(p.numel() for p in tree_leaves(params))
        batch = trainer.batch(trainer.data.batch_at(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, secs, splits = [], [], []
        for _ in range(TRAIN_STEPS):
            events = {}

            def mark(name, events=events):
                events[name] = torch.cuda.Event(enable_timing=True)
                events[name].record()
            gc.collect()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, metrics = trainer.step_fn(params, opt_state, batch, mark=mark)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            splits.append({name: events[name].elapsed_time(events[nxt]) for name, nxt in
                           (("forward", "backward"), ("backward", "adamw"), ("adamw", "end"))})
        launches = dict(fa.flash_attention_bhsd.variant_launches)
        peak = torch.cuda.max_memory_allocated()
        profile = profile_window(lambda: trainer.step_fn(params, opt_state, batch), 1, top=10,
                                 named="flash")
        # one step with every layer recomputed in the backward pass
        trainer.model.remat = "full"
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        _, remat_secs, _ = timed_call(lambda: trainer.step_fn(params, opt_state, batch))
        remat_launches = dict(fa.flash_attention_bhsd.variant_launches)
        remat_peak = torch.cuda.max_memory_allocated()
        # the falling-loss check: fresh weights and state, peak lr TRAIN_LR
        del params, opt_state, metrics
        gc.collect()
        trainer.model.remat = "none"
        trainer.model.init_params(trainer.tcfg.seed)
        trainer.tcfg.opt = AdamWConfig(lr=TRAIN_LR)
        params = trainer.params()
        opt_state = adamw_init(params)
        falling = [float(trainer.step_fn(params, opt_state, batch)[2]["loss"])
                   for _ in range(FALLING_STEPS)]
        del trainer, params, opt_state, batch
    timed = secs[2:]                     # after cuBLAS and the allocator warmed up
    step_s = statistics.median(timed)
    split = {name: statistics.median(sp[name] for sp in splits[2:]) for name in splits[0]}
    row = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, params=n_params,
               batch=batch_size, seq=seq, dtype="bf16 params, f32 AdamW state",
               losses=losses, falling_lr=TRAIN_LR, losses_falling=falling,
               step_seconds=secs, median_step_s=step_s,
               train_tokens_per_s=batch_size * seq / step_s, split_ms=split,
               split_ms_by_step=splits, peak_memory_gb=peak / 1e9,
               launches=launches, launches_per_step={n: c / TRAIN_STEPS
                                                     for n, c in launches.items()},
               remat_full=dict(step_s=remat_secs, launches=remat_launches,
                               peak_memory_gb=remat_peak / 1e9),
               profile=profile)
    emit("train", **row)
    want = flash_counts(wgmma=cfg.n_layers * TRAIN_STEPS,
                        backward_wgmma=cfg.n_layers * TRAIN_STEPS)
    check(launches == want, f"training launches {launches}, want {want}")
    check(remat_launches == flash_counts(wgmma=2 * cfg.n_layers, backward_wgmma=cfg.n_layers),
          f"remat='full' step launches {remat_launches}")
    check(all(np.isfinite(losses + falling)), f"training losses are not finite: {row}")
    # warmup-cosine's first scale is 0: steps 0 and 1 see the same weights
    check(falling[0] == falling[1] and falling[-1] < falling[2] < falling[1],
          f"the loss does not fall on a repeated batch at lr {TRAIN_LR}: {falling}")
    return row


def phase_trainer() -> dict:
    """The smoke llama3_8b Trainer on the card with async checkpoints, and
    a fault under run_with_restarts that must resume from the last
    checkpoint and give the unfaulted run's losses bit for bit."""
    cfg = get_smoke_config("llama3_8b")
    seq, batch = TRAINER_SHAPE
    shape = ShapeConfig("tiny_train", seq, batch, "train")
    steps, fault_at = 8, 5

    def trainer(ckpt_dir, injector=None):
        return Trainer(cfg, shape, TrainerConfig(steps=steps, ckpt_every=2, ckpt_dir=ckpt_dir,
                                                 async_ckpt=True),
                       attn_chunk=8, injector=injector, device="cuda")
    with tempfile.TemporaryDirectory() as root:
        reset_launches()
        ref = trainer(f"{root}/ref").run()
        launches = dict(fa.flash_attention_bhsd.variant_launches)
        injector = FailureInjector(fail_at_steps=(fault_at,))
        hist, restarts = run_with_restarts(
            lambda: trainer(f"{root}/fault", injector), lambda t: t.run())
        kept = sorted(p.name for p in Path(f"{root}/fault").iterdir())
    resumed = hist["restarted_at"]
    row = dict(arch=cfg.name, steps=steps, fault_at=fault_at, restarts=restarts,
               restarted_at=resumed, losses=ref["loss"], losses_after_restart=hist["loss"],
               bit_equal=hist["loss"] == ref["loss"][resumed:], checkpoints_kept=kept,
               launches_unfaulted_run=launches)
    emit("trainer", **row)
    check(restarts == 1 and resumed == 4 and hist["step"] == list(range(4, steps)),
          f"the faulted run did not resume from the step-3 checkpoint: {row}")
    check(row["bit_equal"], f"losses after the restart differ from the unfaulted run: {row}")
    check(all(np.isfinite(ref["loss"])), "trainer losses are not finite")
    check(launches == flash_counts(cuda_core=steps * cfg.n_layers, backward=steps * cfg.n_layers),
          f"trainer launches {launches}")
    return row


def backward_row(main_row: dict, checks: list, variant: str, launches: int, path: str) -> dict:
    """The kernels-line entry of one backward kernel: errors over the
    phase-8 rows it served, times at the training shape in the dtype it
    serves there."""
    mine = [r for r in checks if r["backward_kernel"] == variant]
    row = {
        "name": f"flash_attention_bwd[{variant}]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "replaces_note": ("the gradient of that kernel's function; the TPU kernel is forward "
                          "only and JAX differentiates its jnp model path"),
        "launches": launches,
        "launches_counted_on": path,
        "serves": ("bf16 at hd 64 and 128 under grad" if variant == "backward_wgmma"
                   else "f32 at hd 16-128, bf16 at hd 16 and 32, under grad"),
        "max_abs_err": max(r["max_abs_err"] for r in mine),
        "max_abs_err_by_dtype": {d: max(r["max_abs_err"] for r in mine if r["dtype"] == d)
                                 for d in TOL if any(r["dtype"] == d for r in mine)},
        "tol": {d: {"atol": a, "rtol": r} for d, (a, r) in TOL.items()},
        "limit_ratio": max(r["limit_ratio"] for r in mine),
        "fault_limit_ratio_min": min(r["fault_limit_ratio"] for r in mine
                                     if "fault_limit_ratio" in r),
        "checked_shapes": sorted({tuple(r["shape"]) for r in mine}),
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "f32_cuda_core_bound_ms": main_row["f32_cuda_core_bound_ms"],
        "achieved_tflops": main_row["kernel_tflops"],
        "bound_share": main_row["bound_share"],
        "kernel_over_library": main_row["kernel_over_library"],
        "shape": main_row["shape"],
        "dtype": main_row["dtype"],
    }
    if variant == "backward_wgmma":
        row.update({key: main_row[key] for key in (
            "executed_products", "executed_bound_ms", "executed_bound_share",
            "cuda_core_kernel_ms",
            "cuda_core_over_kernel")})
        row["two_calls_bit_equal"] = all(r["two_calls_bit_equal"] for r in mine)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; it needs an NVIDIA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    gc.callbacks.append(_gc_timer)
    smi = phase_env()
    print(smi, flush=True)
    phase_build()
    timed, checks = phase_kernel()
    wkv_timed, wkv_checks = phase_wkv()
    bwd_timed, bwd_checks = phase_backward()

    cfg = get_config("llama3_8b")
    model = LM(cfg, seed=SEED, device="cuda")        # bf16, full depth
    phase_prefill(model)
    cuda_core_launches = phase_consistency(cfg)
    phase_serve(model)
    phase_profile(model)
    del model
    torch.cuda.empty_cache()
    launches = phase_main_path()

    rwkv_cfg = get_config("rwkv6_1b6")
    model = LM(rwkv_cfg, seed=SEED, device="cuda")   # bf16, full depth
    phase_rwkv_prefill(model, wkv_timed["bf16"]["kernel_ms"])
    phase_rwkv_profile(model)
    del model
    torch.cuda.empty_cache()
    phase_rwkv_consistency(rwkv_cfg)
    torch.cuda.empty_cache()
    wkv_launches = phase_rwkv_main_path()

    grad_launches = phase_gradients(cfg)
    torch.cuda.empty_cache()
    train = phase_train(cfg)
    torch.cuda.empty_cache()
    phase_trainer()

    kernels = [flash_row(timed["bf16"], checks, "wgmma", launches,
                         "every llama3_8b prefill (serve.main --production)"),
               flash_row(timed["f32"], checks, "cuda_core", cuda_core_launches,
                         "the 4-layer f32 prefill of phase 5")]
    main_decode = (RWKV_MAIN_PATH[0], 1, *WKV_MAIN[2:])
    kernels += [wkv_row(wkv_timed["bf16"], wkv_checks, "chunked", wkv_launches["chunked"],
                        "every rwkv6_1b6 bf16 prefill (serve.main --production)"),
                wkv_row(wkv_timed[("decode", main_decode[0])], wkv_checks, "sequential",
                        wkv_launches["sequential"],
                        "every rwkv6_1b6 decode step (serve.main --production)",
                        at_prefill_ms=wkv_timed["bf16"]["sequential_kernel_ms"],
                        decode_batch4=wkv_timed[("decode", WKV_DECODE[0])])]
    kernels += [backward_row(bwd_timed["bf16"], bwd_checks, "backward_wgmma",
                             train["launches"]["backward_wgmma"],
                             f"every full-width llama3_8b train step ({TRAIN_LAYERS} "
                             f"layers, {TRAIN_STEPS} steps of Trainer.step_fn)"),
                backward_row(bwd_timed["f32"], bwd_checks, "backward", grad_launches,
                             "the 4-layer f32 loss gradient of phase 9")]
    emit("done", seconds=time.perf_counter() - t_start, gc_collections=len(GC_PAUSES),
         gc_full_collections=sum(g == 2 for g, _ in GC_PAUSES),
         gc_seconds=sum(p for _, p in GC_PAUSES),
         gc_max_pause_s=max((p for _, p in GC_PAUSES), default=0.0))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
