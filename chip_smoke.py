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
               instantiation of the tensor-core flash kernel
2. kernel      ``flash_attention_bhsd`` vs its plain version on the card, f32
               and bf16, causal both ways, at the test shapes, a ragged S=1000
               and every shape the later phases give it, each row naming the
               kernel that served it (tensor-core or CUDA-core); at S >= 256
               also a planted fault (one V tile zeroed) that the limit must
               reject; times at the one-layer prefill shape, with achieved
               TFLOP/s, share of the bound and the ratio to SDPA
3. wkv         ``wkv_bhsd`` vs its plain version, out and state, f32 and bf16
               r/k/v with f32 w, two laws of w, nonzero s0, at the test
               shapes, a ragged S=1000 and every prefill and decode shape
               the RWKV phases give it (serve.main's 2 x 256 included); at
               S >= 256 a planted fault (one step's k v^T update dropped);
               one 4096 call against two 2048 calls with the state carried;
               times at the one-layer prefill shape
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
               ``prefill`` on 2 x 4096 tokens, 24 WKV launches per call; full
               width, 4 layers, f32: prefill logits vs decode logits, both
               through the kernel; a profiler window over one prefill call
               and one decode step; ``serve.main(["--arch", "rwkv6_1b6",
               "--production", ...])`` — RWKV's main path, whose WKV
               launches are counted
8. kernels     the card's nvidia-smi line again, one JSON line listing every
               ported kernel, and the final ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.rwkv import wkv_chunked  # noqa: E402
from repro_torch.runtime import Request, ServeLoop  # noqa: E402

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
# (atol, rtol) of kernel vs plain.  f32: tests/test_kernels.py's 2e-5 for
# summation order.  bf16: both sides compute in f32 from the same bf16
# inputs and round once to bf16, so they differ by at most one bf16 ulp,
# which is at most 2**-7 of |plain|; the atol covers the f32 summation
# noise near zero.  A limit that does not scale with the output would let
# a dropped tile through at S=4096, where |output| is about 0.03.
TOL = {"f32": (2e-5, 2e-5), "bf16": (1e-5, 2.0 ** -7)}

# WKV shapes (b, s, h, hd): the JAX kernel tests', a ragged S at the
# rwkv6_1b6 heads, and what the RWKV phases give the kernel
WKV_MAIN = (2, 4096, 32, 64)        # one rwkv6_1b6 prefill layer of phase 7
RWKV_MAIN_PATH = (2, 256, 16)       # batch, prompt length, new tokens
RWKV_CONSISTENCY = (2, 80)          # batch, length of the 4-layer f32 check
WKV_SHAPES = [(1, 16, 1, 8), (2, 32, 2, 16), (1, 64, 4, 64), (2, 24, 2, 32),
              (1, 1000, 32, 64),
              WKV_MAIN,
              (*RWKV_MAIN_PATH[:2], 32, 64),  # serve.main's prefill
              (*RWKV_CONSISTENCY, 32, 64),    # the 4-layer f32 prefill
              (2, 1, 32, 64), (4, 1, 32, 64)]  # decode steps of batch 2 and 4
# (atol, rtol) of kernel vs plain.  out: the kernel sums the hd = 64
# products r_i (S_ij + u_i k_i v_j) in a chain of FMAs, the plain version
# in a batched matmul, in another order.  Once the state is in steady
# state the partial sums reach about 25, so the two f32 results differ
# by about 2**-24 * sqrt(2 * sum of squared partial sums) ~ 1e-5 (one
# standard deviation), whatever |out| is: the atol of 2e-4 is 20 of them,
# and rtol 1e-5 is tests/test_kernels.py's f32 bar.  bf16 out: both sides
# round that f32 value once to bf16, so they differ by at most one bf16
# ulp (at most 2**-7 of |plain|) plus the same f32 noise.  The state is
# f32 in both cases; its update has no sum, so it keeps 1e-5.
WKV_TOL = {"f32": (2e-4, 1e-5), "bf16": (2e-4, 2.0 ** -7)}
WKV_STATE_TOL = (1e-5, 1e-5)


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
        hd: lib.repro_flash_attention_wgmma_smem_bytes(hd) for hd in fa.WGMMA_HEAD_DIMS})
    sass = sass_instructions("flash_attention", "flash_fwd_wgmma_kernel", ("HGMMA", "UTMALDG"))
    emit("build", kernel="flash_attention", sass=sass)
    check(len(sass) == len(fa.WGMMA_HEAD_DIMS) and
          all(n > 0 for counts in sass.values() for n in counts.values()),
          f"the tensor-core flash kernel lacks HGMMA or UTMALDG in its SASS: {sass}")


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
                        bh, k.shape[0], s, hd, 1, 1, hd ** -0.5, stream)
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


def wkv_inputs(b, s, h, hd, dtype, w_law, gen):
    """r/k/v/w [B,H,S,hd], u [H,hd], s0 [B,H,hd,hd] f32 on the card.

    ``dtype`` "f32": all f32; "bf16": bf16 r/k/v/u with f32 w and s0, the
    model's mix.  w is drawn per element, by the JAX kernel tests' law
    ("uniform": U(0.2, 0.95)) or the model's ("model":
    exp(-min(exp(N(0,1)), 8)))."""
    shape = (b, h, s, hd)
    io = torch.float32 if dtype == "f32" else torch.bfloat16
    r, k, v = (torch.randn(shape, generator=gen, device="cuda").to(io) for _ in range(3))
    if w_law == "uniform":
        w = 0.2 + 0.75 * torch.rand(shape, generator=gen, device="cuda")
    else:
        w = torch.exp(-torch.randn(shape, generator=gen, device="cuda").exp().clamp(max=8.0))
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


def wkv_bound_ms(b, h, s, hd, io_bytes, w_bytes) -> tuple[float, str]:
    """Least time for the work: 5 hd^2 f32 operations per (b, h, t) on the
    CUDA cores (r.S is hd^2 FMAs; the update one multiply and one FMA per
    element), or r/k/v/w/u/s0 read once and out/sT written once over HBM."""
    t_ops = 5 * hd * hd * b * h * s / PEAK_FLOPS["f32"]
    t_bytes = (b * h * s * hd * (4 * io_bytes + w_bytes) + h * hd * io_bytes
               + 2 * b * h * hd * hd * 4) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase_wkv() -> tuple[dict, list]:
    """WKV kernel vs plain at every shape, dtype and law of w; state
    carried across two calls; times at the one-layer prefill shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    timed, rows = {}, []
    for b, s, h, hd in WKV_SHAPES:
        for dtype in ("f32", "bf16"):
            for w_law in ("uniform", "model"):
                args = wkv_inputs(b, s, h, hd, dtype, w_law, gen)
                out, sT = wkv.wkv_bhsd(*args)
                ref, sT_ref = wkv.wkv_bhsd_plain(*args)
                torch.cuda.synchronize()
                out, ref = out.float(), ref.float()
                atol, rtol = WKV_TOL[dtype]
                satol, srtol = WKV_STATE_TOL
                row = dict(shape=[b, s, h, hd], dtype=dtype, w_law=w_law,
                           max_abs_err=float((out - ref).abs().max()),
                           state_max_abs_err=float((sT - sT_ref).abs().max()),
                           atol=atol, rtol=rtol,
                           limit_ratio=limit_ratio(out, ref, atol, rtol),
                           state_limit_ratio=limit_ratio(sT, sT_ref, satol, srtol))
                row["ok"] = row["limit_ratio"] <= 1 and row["state_limit_ratio"] <= 1
                if s >= 256:
                    bad = planted_wkv_fault(*args).float()
                    row["fault_max_abs_err"] = float((bad - ref).abs().max())
                    row["fault_limit_ratio"] = limit_ratio(bad, ref, atol, rtol)
                    row["fault_rejected"] = row["fault_limit_ratio"] > 1
                    del bad
                if (b, s, h, hd) == WKV_MAIN and w_law == "model":
                    half = s // 2
                    sl = lambda a, c: [x[:, :, a:c].contiguous()  # noqa: E731
                                       for x in args[:4]]
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
                emit("wkv", **row)
                rows.append(row)
                check(row["ok"], f"wkv_bhsd disagrees with its plain version: {row}")
                check(row.get("fault_rejected", True),
                      f"the limit lets a dropped k v^T update through: {row}")
                check(row.get("two_calls_ok", True),
                      f"two calls with the state carried differ from one: {row}")
                del args, out, ref, sT, sT_ref
    return timed, rows


def wkv_times(args) -> dict:
    """Kernel, plain version and the port's torch-only chunked form at
    the shape of ``args``; bound from this shape's work."""
    r, k, v, w, u, s0 = args
    b, h, s, hd = r.shape
    row = dict(kernel_ms=time_ms(lambda: wkv.wkv_bhsd(*args), 20),
               plain_ms=time_ms(lambda: wkv.wkv_bhsd_plain(*args), 2))
    # for later PRs: the port's torch-only chunked form (the JAX model's
    # prefill formulation) at the same shape, in its model layout.  Not a
    # library call and not used on the card: no PyTorch call computes WKV.
    tr = [x.transpose(1, 2).contiguous() for x in (r, k, v, w)]
    row["torch_chunked_ms"] = time_ms(lambda: wkv_chunked(*tr, u, s0, chunk=16), 3)
    row["library_ms"] = None
    row["bound_ms"], row["bound_by"] = wkv_bound_ms(
        b, h, s, hd, r.element_size(), w.element_size())
    return row


def phase_prefill(model) -> dict:
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, s = PREFILL
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    launches, secs = [], []
    for _ in range(2):          # the first call also warms cuBLAS up
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = serve.prefill(model, tokens)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches.append(dict(fa.flash_attention_bhsd.variant_launches))
        check(tuple(logits.shape) == (b, cfg.vocab_size), f"logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
        check(launches[-1] == {"wgmma": cfg.n_layers, "cuda_core": 0},
              f"kernel launches in one prefill {launches[-1]}, want {cfg.n_layers} "
              f"of the tensor-core kernel")
    peak = torch.cuda.max_memory_allocated()
    # the kernel alone at this call's attention shape, to split the time
    q = torch.randn((b * cfg.n_heads, s, cfg.hd), generator=gen, device="cuda").bfloat16()
    kv = torch.randn((b * cfg.n_kv_heads, s, cfg.hd), generator=gen, device="cuda").bfloat16()
    attn_ms = time_ms(lambda: fa.flash_attention_bhsd(q, kv, kv, causal=True), 5)
    row = dict(arch=cfg.name, layers=cfg.n_layers, batch=b, seq=s, dtype="bf16",
               launches_per_call=launches, seconds=secs,
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
    check(launches == {"wgmma": 0, "cuda_core": cfg.n_layers},
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


def profile_window(fn, reps: int) -> dict:
    """Wall time per call unprofiled, then device time per call and the
    top kernels from ``torch.profiler`` over the same calls.  The
    device-busy share compares the two: the profiler's own host cost
    does not enter the wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
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
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(reps=reps, wall_ms=wall_ms, device_ms=device_ms,
                device_busy_share=device_ms / wall_ms,
                top_device_ms=[[name[:80], ms] for name, ms in top])


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


def reset_launches() -> None:
    fa.reset_launch_counts()
    wkv.wkv_bhsd.launches = 0


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
    check(launches == {"wgmma": want, "cuda_core": 0},
          f"kernel launches on the main path {launches}, want {want} of the tensor-core kernel")
    check(wkv.wkv_bhsd.launches == 0, "the llama path launched the WKV kernel")
    return launches["wgmma"]


def phase_rwkv_prefill(model, wkv_ms: float) -> dict:
    """Full rwkv6_1b6 prefill: one WKV launch per layer; ``wkv_ms`` is
    phase 3's kernel time at this call's one-layer shape."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    b, s = PREFILL
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    launches, secs = [], []
    for _ in range(2):          # the first call also warms cuBLAS up
        wkv.wkv_bhsd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = serve.prefill(model, tokens)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches.append(wkv.wkv_bhsd.launches)
        check(tuple(logits.shape) == (b, cfg.vocab_size), f"logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "rwkv prefill logits are not finite")
        check(launches[-1] == cfg.n_layers,
              f"{launches[-1]} WKV launches in one prefill, want {cfg.n_layers}")
    row = dict(arch=cfg.name, layers=cfg.n_layers, batch=b, seq=s, dtype="bf16",
               launches_per_call=launches, seconds=secs,
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
    wkv.wkv_bhsd.launches = 0
    last = serve.prefill(model, tokens)
    check(wkv.wkv_bhsd.launches == cfg.n_layers, "rwkv prefill missed the kernel")
    with torch.no_grad():
        full = model(tokens)
        wkv.wkv_bhsd.launches = 0
        cache = model.init_cache(b, s, dtype=torch.float32)
        worst = 0.0
        for t in range(s):
            logits, cache = model.decode_step(cache, tokens[:, t:t + 1], t)
            worst = max(worst, float((logits[:, 0] - full[:, t]).abs().max()))
    decode_launches = wkv.wkv_bhsd.launches
    err_last = float((logits[:, 0] - last).abs().max())
    emit("rwkv_consistency", layers=cfg.n_layers, d_model=cfg.d_model, batch=b, seq=s,
         dtype="f32", max_abs_err_last=err_last, max_abs_err_all_positions=worst,
         decode_launches=decode_launches, tol=2e-3)
    check(decode_launches == cfg.n_layers * s, "rwkv decode missed the kernel")
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
         **profile_window(lambda: serve.prefill(model, tokens), 1))
    cache = model.init_cache(4, 1, dtype=torch.float32)
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen, device="cuda")
    with torch.no_grad():
        step = lambda: model.decode_step(cache, tok, 0)  # noqa: E731
        emit("rwkv_profile", step="decode", batch=4, **profile_window(step, 10))


def phase_rwkv_main_path() -> int:
    """``serve.main --arch rwkv6_1b6 --production``: one WKV launch per
    layer for the prefill, and one per layer for each of the prompt's
    teacher-forced decode steps and each new token."""
    batch, plen, new = RWKV_MAIN_PATH
    argv = ["--arch", "rwkv6_1b6", "--production", "--batch", str(batch),
            "--prompt-len", str(plen), "--tokens", str(new)]
    reset_launches()
    t0 = time.perf_counter()
    rc = serve.main(argv)
    torch.cuda.synchronize()
    launches = wkv.wkv_bhsd.launches
    emit("rwkv_serve_main", argv=argv, rc=rc, seconds=time.perf_counter() - t0,
         kernel_launches=launches, flash_launches=fa.flash_attention_bhsd.launches)
    check(rc == 0, f"serve.main exited {rc}")
    n_layers = get_config("rwkv6_1b6").n_layers
    want = n_layers + n_layers * (plen + new)
    check(launches == want, f"{launches} WKV launches on the RWKV main path, want {want}")
    check(fa.flash_attention_bhsd.launches == 0, "the RWKV path launched flash attention")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; it needs an NVIDIA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = phase_env()
    print(smi, flush=True)
    phase_build()
    timed, checks = phase_kernel()
    wkv_timed, wkv_checks = phase_wkv()

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

    kernels = [flash_row(timed["bf16"], checks, "wgmma", launches,
                         "every llama3_8b prefill (serve.main --production)"),
               flash_row(timed["f32"], checks, "cuda_core", cuda_core_launches,
                         "the 4-layer f32 prefill of phase 5")]
    kernels.append({
        "name": "wkv_bhsd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv_wkv.cu",
        "replaces": "src/repro/kernels/rwkv_wkv.py:61",
        "launches": wkv_launches,
        # worst over every shape, dtype and law of w of phase 3
        "max_abs_err": max(r["max_abs_err"] for r in wkv_checks),
        "max_abs_err_by_dtype": {d: max(r["max_abs_err"] for r in wkv_checks
                                        if r["dtype"] == d) for d in WKV_TOL},
        "state_max_abs_err": max(r["state_max_abs_err"] for r in wkv_checks),
        "tol": {d: {"atol": a, "rtol": r} for d, (a, r) in WKV_TOL.items()},
        "state_tol": {"atol": WKV_STATE_TOL[0], "rtol": WKV_STATE_TOL[1]},
        "limit_ratio": max(r["limit_ratio"] for r in wkv_checks),
        "state_limit_ratio": max(r["state_limit_ratio"] for r in wkv_checks),
        "fault_limit_ratio_min": min(r["fault_limit_ratio"] for r in wkv_checks
                                     if "fault_limit_ratio" in r),
        "two_calls_bit_equal": all(r["two_calls_bit_equal"] for r in wkv_checks
                                   if "two_calls_bit_equal" in r),
        "checked_shapes": [list(sh) for sh in WKV_SHAPES],
        "ms": wkv_timed["bf16"]["kernel_ms"],
        "plain_ms": wkv_timed["bf16"]["plain_ms"],
        "bound_ms": wkv_timed["bf16"]["bound_ms"],
        "bound_by": wkv_timed["bf16"]["bound_by"],
        "library_ms": None,          # no PyTorch call computes WKV
        "torch_chunked_ms": wkv_timed["bf16"]["torch_chunked_ms"],
        "shape": list(WKV_MAIN),
        "dtype": "bf16 r/k/v/out, f32 w",
    })
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
