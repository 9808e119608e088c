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
               the chunked WKV kernel and of the chunk-parallel WKV
               backward's chain kernel; no local memory (LDL/STL, ptxas
               spills) in either WKV backward; every library must export
               the entry points ``_build.ENTRY_POINTS`` names (the WKV
               backwards' ``repro_wkv_bwd`` and ``repro_wkv_bwd_chunked``
               among them)
2. kernel      ``flash_attention_bhsd`` vs its plain version on the card, f32
               and bf16, causal both ways, at the test shapes, a ragged S=1000
               and every shape the later phases give it (olmoe_1b_7b's MHA
               16/16, mixtral_8x7b's GQA 32/8, jamba_15_large's and
               llama32_vision_90b's GQA 64/8 at hd 128, seamless_m4t_v2's MHA
               16/16 at hd 64 among them), each row naming the kernel that
               served it (tensor-core or CUDA-core); at S >= 256 also a
               planted fault (one V tile zeroed) that the limit must reject;
               times at the one-layer prefill shapes of llama3_8b (32/8),
               olmoe_1b_7b (16/16), jamba_15_large (64/8) and seamless_m4t_v2
               (16/16 at hd 64, non-causal as its encoder and causal), with
               achieved TFLOP/s, share of the bound and the ratio to SDPA;
               then (run after phase 8b) the sliding window
               (``WINDOW_CASES``): both forward kernels with a window vs the
               plain version, f32 and bf16, at mixtral_8x7b's GQA 32/8 hd 128
               at S = 8192 with its window of
               4096, a ragged S = 1000 with W = 300 and W = 1, W = 64 at hd 64
               and a window with ``causal=False``; each with a planted fault
               (one V row inside the window zeroed) that the limit must
               reject, each launch counted under its "+window" mask, and
               windows of S and 2S bit-equal to none; at mixtral's shape a
               profiler window times the windowed kernel against the same
               call with no window (CUDA events, and the kernel's device
               time from a profiler window), and SDPA with a boolean mask of
               the window (the library time), with both bounds from
               ``cost.py``; the kernel alone at 1 x 32768 (the 32k
               prefill's call)
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
               call and one decode step; full llama3_8b decode over 64
               steps through the int8 KV cache and the bf16 one (kv_int8:
               within 5 % of the bf16 logits, the cache int8, bytes and
               step times of both); then ``serve.main(["--full-size",
               ...])`` end to end — llama's main path, whose flash launches
               are counted
7. rwkv        full rwkv6_1b6 (24 layers, bf16, seeded random weights):
               ``prefill`` on 2 x 4096 tokens, 24 chunked WKV launches per
               call; full width, 4 layers, f32: prefill logits vs decode
               logits, both through the sequential kernel; a profiler window
               over one prefill call and one decode step;
               ``serve.main(["--arch", "rwkv6_1b6", "--full-size", ...])``
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
               shapes (llama3_8b's, and olmoe_1b_7b's MHA in bf16): the
               tensor-core and the CUDA-core backward on the same bf16
               inputs, the CUDA-core one in f32, autograd of the plain
               version and SDPA's backward (the yardstick only; also at
               seamless_m4t_v2's 16/16 at hd 64, causal; the kernel and
               SDPA each the median of 20 windows of 10 back-to-back calls
               between CUDA events, with the spread, and each one's device
               time a call from a profiler window of 20 calls), the
               five-product bound and the bound of the products the
               tensor-core kernel runs (``WGMMA_BWD_PRODUCTS``); then both
               backward kernels under the window cases of phase 2, against
               autograd of the plain version with the window, with a planted
               fault (the last query's dO row zeroed; at W = 1 no gradient
               reads V), reruns bit-equal, windows of S and 2S
               bit-equal to none, and times at mixtral's shape beside the
               unwindowed call and SDPA's backward with the mask
8b. wkv_backward  both WKV backward kernels vs autograd of the plain
               version: dr, dk, dv, dw, du and ds0, f32 and bf16 r/k/v with
               f32 w, two laws of w, nonzero s0 and dsT, at the test
               shapes, S around one chunk, a ragged S=1000, the training
               shape and what phases 9b and 11 give it (model layout).
               Each row names the forward and the backward kernel the
               wrapper (``wkv_bhsd``'s autograd Function) launched; where
               that is the chunk-parallel ``backward_chunked``, the
               ``backward`` kernel runs on the same inputs too, held to the
               same limit; at S >= 256 a planted fault (one dout step
               dropped in the plain run); every kernel call run twice for
               identical bits; times at the training shape: both backwards
               on the same inputs in turns (old, new, new, old), the
               chunk-parallel one's two kernels (chains, chunks) from the
               profiler, the forward kernel of the same call, the backward
               of autograd of the plain version, and the bound
8c. adamw     both AdamW kernels (``kernels/adamw.py``) at the leaf shapes
               of olmoe_1b_7b at 8 layers (the benchmark's
               ``olmoe_1b_7b_pp2``: 13 bf16 leaves, 3.56 B parameters,
               three stacked expert leaves of 1.07 B): the norm pass over
               every grad leaf within rtol 1e-5 of ``global_norm`` and
               the same bits on a second call; the update of each leaf
               (f32 moments and master, clip engaged) bit-equal on param,
               grad, m, v and master to the eager ATen update given the
               same scale; times of both beside the eager path's and the
               bound of their HBM bytes.  Each training phase below runs
               between a reset and a read of the kernels' launch counts
9. gradients   full width, 4 layers, f32 (TF32 off): ``LM.loss`` and every
               gradient leaf through the kernels vs the same with
               ``gqa_attention`` routed to the chunked torch scan
9b. rwkv_gradients  the same for rwkv6_1b6 (4 layers, f32): through the
               sequential WKV kernel and the backward kernel vs the WKV
               routed to the model's chunked torch form
10. train      ``llama3_8b`` at full width, 8 layers, bf16 params, f32
               AdamW state, B=1 x S=4096: ``Trainer.step_fn`` on one
               repeated ``SyntheticTokens`` batch; train tokens/s, the
               forward/backward/AdamW split (CUDA events), peak memory and
               kernel launches per step (8 tensor-core backward launches,
               no CUDA-core one), a profiler window over one step (with
               the flash kernels' own device time),
               two ``remat="full"`` steps, then the falling loss from fresh
               weights — the training main path, whose backward launches
               are counted
10b. rwkv_train  rwkv6_1b6 at full width and full depth (24 layers, 1.84 B
               parameters), the same step, timing, profile (with the WKV
               kernels' own device time), ``remat="full"`` steps and
               falling-loss check as phase 10: 24 chunked forward and 24
               ``backward_chunked`` WKV launches a step (none of
               ``backward``), no flash launch
11. trainer    the smoke ``llama3_8b`` ``Trainer.run`` with async
               checkpoints, then a ``FailureInjector`` fault under
               ``run_with_restarts``: it resumes from the last checkpoint,
               and its losses equal the unfaulted run's bit for bit; then
               ``launch.train.main(["--arch", "rwkv6_1b6", ...])`` on the
               card (smoke config, f32: the sequential WKV kernel and the
               ``backward`` kernel: the path whose launches the kernels
               line counts for it)
12. olmoe      full olmoe_1b_7b (16 layers, d 2048, 16/16 heads of 128, 64
               experts top-8 of d_ff 1024, bf16, seeded random weights):
               ``prefill`` on 2 x 4096 tokens, 16 tensor-core flash launches
               per call; the tokens its MoE layers drop at capacity factor
               1.25 (the program's ``moe.*`` counters); a profiler window over one prefill call (busy share,
               top kernels, device time under the MoE's ops: the expert
               products' ``aten::bmm``) and one 4-slot decode step;
               ``ServeLoop(slots=4)`` answering 8 requests; then
               ``serve.main(["--arch", "olmoe_1b_7b", "--full-size", ...])``
               — olmoe's serving path, whose flash launches are counted
13. olmoe_train olmoe_1b_7b at full width, 6 of 16 layers (2.72 B parameters),
               the step of phase 10: 6 ``wgmma`` and 6 ``backward_wgmma``
               launches a step; two steps each under ``remat="full"`` and
               ``"dots"`` (twice the forwards), each with its split,
               tokens/s, step peak and forward+backward peak; the "dots"
               peaks between "full"'s and "none"'s; the ops the "dots"
               policy saved; falling loss from fresh weights
14. olmoe_f32  olmoe_1b_7b at full width, 4 layers, f32 (TF32 off): prefill vs
               decode logits at capacity factor 16 (no token dropped) as
               phase 5; ``LM.loss`` and every gradient leaf through the
               kernels vs the chunked attention scan as phase 9
15. mixtral    mixtral_8x7b at full width, 4 of 32 layers, bf16: ``prefill``
               on 1 x 4096 tokens, where the 4096 window masks nothing and
               so takes the tensor-core kernel (4 GQA 32/8 launches); the
               prefill's k/v written into a decode cache, then 16 greedy
               decode steps past the window, which ``decode_attention``
               masks; finite logits; then ``prefill`` on 1 x 32768 tokens at
               the same 4 layers, twice: 4 ``wgmma/causal+window`` launches a
               call, finite logits, tokens/s, a profiler window (the top
               kernels, the flash kernel's device time); f32 at 2 layers over
               1 x 8192 (capacity factor 16): prefill logits through the CUDA-core
               windowed kernel vs ``gqa_attention`` routed to the chunked
               scan, within phase 5's 2e-3; one bf16 ``Trainer.step_fn`` step
               at 1 layer on 1 x 8192 through the windowed tensor-core forward
               and ``backward_wgmma``: finite loss, 1 + 1 windowed launches
16. jamba      jamba_15_large at full width, 4 of 72 layers at
               attn_layer_period 4 (mamba, mamba+MoE, mamba, attn+MoE; 23.07 B
               parameters), bf16: ``prefill`` on 2 x 4096 tokens, 1
               tensor-core flash launch per call (its one attention layer) and
               3 ``mamba_seq`` calls (the selective scan, plain torch); the
               tokens its 2 MoE layers drop; a profiler window with the device
               time under the scan's device span (``repro_torch.mamba.scan``);
               a teacher-forced ``greedy_decode`` through ``mamba_step``;
               ``serve.main --full-size`` of the whole config must refuse its
               799 GB before allocating; then f32 at 2 layers (period 2: mamba,
               attn+MoE; 11.9 B parameters): prefill vs decode logits at
               capacity factor 16, as phase 5
17. vision     llama32_vision_90b at full width, 10 of 100 layers (2
               cross-attention layers), bf16, over 6404 frontend tokens:
               ``prefill`` on 2 x 4096 tokens, 10 flash launches per call and
               none from cross-attention (the chunked scan); teacher-forced
               ``greedy_decode`` with memory; int8 vs bf16 KV decode over 64
               steps with memory (within 5 %); the whole config's refusal;
               then f32 at 5 layers (1 cross layer): prefill vs decode with
               memory, as phase 5
18. seamless   seamless_m4t_v2 whole (24 encoder + 24 decoder layers, 1.93 B
               parameters), bf16, over 2 x 4096 frames: ``encode_memory``
               (24 non-causal launches), ``prefill`` (24 non-causal and 24
               causal launches per call), teacher-forced ``greedy_decode``
               (one encoding), then ``serve.main(["--arch",
               "seamless_m4t_v2", "--full-size", ...])`` — its main path,
               whose launches (by mask) are counted
19. seamless_train  seamless_m4t_v2 whole, the step of phase 10 at B=1 x
               S=4096 over 4096 frames: 24 non-causal and 24 causal
               ``wgmma`` and as many ``backward_wgmma`` launches a step, twice
               the forwards under ``remat="full"``, falling loss from fresh
               weights; then f32 at 4 encoder and 4 decoder layers: ``LM.loss``
               and every gradient leaf through the kernels vs the chunked
               attention scan, as phase 9
20. steps_prefill  ``build_prefill_step("llama3_8b", ...)`` at full depth
               on a mesh of one (``make_local_mesh``): the DTensor step on
               the plain model's own storage vs ``serve.prefill`` on 2 x
               4096 tokens, within phase 2's bf16 bar; 32 tensor-core flash
               launches a call; its time beside the plain call's
21. steps_decode ``build_serve_step`` over caches of 4096 for 8 rows (4.3
               GB, seeded values): logits and new cache entries vs
               ``LM.decode_step`` at position 4095; no flash launch
22. steps_train ``build_train_step("llama3_8b", ...)`` at 8 layers, B=1 x
               S=4096, remat "full": 5 steps (16 forward and 8 backward
               tensor-core launches a step), finite losses; the losses, m
               and the f32 master of the first two steps vs the same steps
               on plain tensors from the same seed (``STEPS_*`` bars); then
               ``grad_accum=2`` at B=2 against the plain bf16-accumulator
               route; the step time beside the Trainer's (phase 10)
23. steps_rwkv_train ``build_train_step("rwkv6_1b6", ...)`` at full depth:
               48 chunked WKV forwards (24 recomputed) and 24
               ``backward_chunked`` a step, finite losses
24. jamba_train jamba_15_large at full width, 1 layer (a Mamba mixer and a
               dense FFN, 2.115 B parameters) through ``Trainer.step_fn`` as
               phase 10: the Mamba path's backward on the card, falling
               loss, split and peaks; f32 gradients vs the scan route
25. vision_train llama32_vision_90b at full width, 1 layer at
               cross_attn_period 1 (self- and cross-attention, 3.108 B
               parameters; the 2-layer cut ran out of memory in AdamW) over
               6404 frontend tokens, as phase 24: one flash forward and one
               backward a step (the cross-attention launches none)
26. dryrun_steps  the dry run (``launch/dryrun.run_cell``) of the step cells
               of phases 20-22 on a meta mesh of one: its predicted peak
               over each step's measured peak (``torch.cuda.max_memory_allocated``
               reset just before the step, less what was allocated then
               beyond the step's inputs) within [0.75, 1.33], its predicted
               flash and WKV launches equal to the measured ones (prefill
               32; train 16 + 8; decode none); its FLOPs over the measured
               step time (achieved TFLOP/s) and the measured roofline
               fraction beside the predicted one
27. production_dryrun  ``launch.train --arch llama3_8b --production`` and
               ``launch.serve --arch llama3_8b --production`` (the 16 x 16
               dry runs over a fake group of 256 ranks), and ``launch.dryrun
               --arch mixtral_8x7b --shape prefill_32k`` (its windowed
               attention through the kernel's meta branch), each in a
               process of its own, at once: each exits 0 with an "ok" cell;
               its per-rank GiB, dominant term, useful FLOP fraction, wall
               time
28. pipeline   ``runtime/pipeline.pipeline_apply`` with one stage on the
               NCCL mesh of one: llama3_8b's 8 blocks, bf16, on 4 x 4096
               hidden states in 4 microbatches, within phase 2's bf16 bar
               of the same blocks on the whole batch; 32 flash launches
28a. train_lm_example  ``examples/train_lm_torch.py --preset tiny`` on the
               card, a process of its own with its own time limit: exit 0
               and a falling loss
29. scheduler  the paper's scheduler (``repro_torch.core``, host code in
               numpy) on the card's host: each of the seven ``FAMILIES`` at
               n = 1000, seed 1, on ``default_cluster()`` through
               ``schedule()`` with both algorithms; every mapping valid
               (``validate_mapping`` returns no violation) and a rerun
               bit-equal (makespan, blocks, processors); the makespans,
               their ratio, the wall seconds.  Each schedule whose k'
               sweep has more than one point (every ``dag_het_part``; a
               ``dag_het_mem`` sweep has one, so no pool) again with
               ``workers=4`` (``SCHED_WORKERS``): bit-equal to the serial
               mapping, no child process and no pool manager thread alive
               after it, its wall seconds beside the serial ones.  Then
               ``autoshard.plan`` of
               llama3_8b and olmoe_1b_7b at phase 4's 2 x 4096 prefill on
               ``h100_fleet_si({"h100": 1})``: one valid stage each, its GB
               beside the peak phases 4 and 12 measured, its estimated step
               seconds beside the measured prefill seconds, both ratios
               (no limit: the analytic model's error on this card);
               mixtral_8x7b at that shape infeasible on one card (``plan``
               gives None, ``Scheduler.schedule`` an ``Infeasibility`` with
               its stage and reason) and in 2 valid stages on two
30. sim        the simulator, the scenario runner and ``rescale_plan``
               (``repro_torch.sim`` / ``scenario`` / ``runtime.elastic``,
               host code) on the card's host.  (a) Each of phase 29's 14
               schedules replayed: contention-free, bit-equal to its
               analytic makespan with ``exact_anchor``; fair-share at or
               above it (the ratio); a lognormal jitter envelope (0.2, 16
               replicas, seed 0) over the makespan, a second call's
               makespans equal; ``validate_mapping(memory_trace=True)``
               clean and the trace feasible; each call's wall seconds.
               (b) At phase 4's 2 x 4096 prefill through ``rescale_plan``:
               mixtral_8x7b on 3 cards (2 stages healthy; losing {0} at 0
               feasible in 2; losing {1, 2} a structured infeasibility with
               the old plan kept; losing {0} mid-step with
               ``pinned-warm-start`` feasible with one migration and a
               valid residual plan, the stitched makespan beside the
               healthy step); llama3_8b on 2 cards losing {0}: one valid
               stage, its GB and estimated seconds beside phase 4's
               measured ones (no limit); phase 29's 2-stage mixtral plan
               replayed under both comm models.  (c)
               ``examples/elastic_serving_torch.py`` on the card, a process
               of its own with its own time limit: exit 0, the migration
               and the stitched Gantt, the flash launches of its prefill
31. throughput the throughput planner and the service loop
               (``repro_torch.throughput`` / ``service``, host code) on the
               card's host.  (a) Each of phase 29's seven n = 1000
               workflows through ``plan_throughput`` (rate, replicas, k',
               wall seconds); the identity anchor on its plan (one
               instance at 0 replays to ``simulate``'s makespan and
               horizon, to the bit); 64 Poisson instances at 0.8 x the rate
               (seed 0, 64 000 tasks in one engine pass) with the summed
               memory trace, its violations those the reference counts on
               the same plan (``PIPELINED_VIOLATIONS``) and a rerun equal;
               genome's ``saturation_sweep`` at 0.5, 0.8, 0.95 and 1.1 x its
               rate with 64 instances: the reference's rows to the bit
               (``GENOME_SATURATION``), achieved over offered falling rung
               to rung.  (b) At phase 4's 2 x 4096 prefill on
               ``h100_fleet_si({"h100": 4})``: ``plan_throughput`` of
               ``build_model_graph`` of llama3_8b (4 replicas) and
               mixtral_8x7b (2 replicas of a 2-stage plan), each with the
               identity anchor; ``run_sustained`` of llama3_8b at 0.8 x its
               rate with 64 instances twice through one ``PlanCache``:
               ``cold`` then ``seeded``, every instance's arrival, dispatch
               and finish equal; the plan rate over 4 / phase 4's measured
               prefill seconds (no limit: the spec-rate model's error).
               (c) ``run_service`` of the seven workflows submitted twice
               each (a weight-2 tenant, a ``max_running=1`` one) and two
               malformed payloads, the two last processors failing while a
               job runs and a spare arriving later (``SERVICE_EVENTS``):
               each of the 16 submissions in exactly one terminal status, a
               plan-cache hit, a warm replan at the failure, the trace's
               bytes equal on a rerun and with tracing on; planning wall
               seconds by path; the same run with ``workers=2``
               (``SERVICE_WORKERS``): its trace equal to the serial run's,
               the whole report too (wall clock set aside as the parity
               tests' ``untimed_service_json`` does) but for the sweep's
               work counters (``SWEEP_WORK_COUNTERS``) and the histograms'
               min, max and sum, and no child process or pool manager
               thread alive after it.  (d) The examples
               ``heterogeneous_scheduling_torch.py``,
               ``multi_tenant_service_torch.py`` and
               ``sustained_throughput_torch.py``, each a process of its own
               with its own time limit: exit 0
32. kernels    the card's nvidia-smi line again, one JSON line listing every
               ported kernel (the flash forward also at olmoe_1b_7b's,
               jamba_15_large's, llama32_vision_90b's and seamless_m4t_v2's
               shapes and the tensor-core backward at olmoe_1b_7b's and
               seamless_m4t_v2's, with their launches on those paths; the
               launches of phases 20-25 and 28 under
               ``launches_on_step_paths``, and the dry runs' predicted ones;
               the windowed forward kernels and the windowed tensor-core
               backward as entries ``...@mixtral_8x7b+window``, with their
               launches on mixtral's windowed paths; both AdamW kernels
               with their launches in each training phase), and the final
               ``{"ok": true, "device": ...}``.

Prefill calls and profile windows are timed after a full garbage
collection, and each reports the collector's seconds inside it; the
``done`` line sums the collector's pauses over the run.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures.process import _ExecutorManagerThread
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.configs import SHAPES, ShapeConfig, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import flatten_tree, param_tree, tree_leaves, tree_map  # noqa: E402
from repro_torch.core import (FAMILIES, Processor, Scheduler, SchedulerConfig,  # noqa: E402
                              default_cluster, generate_workflow, h100_fleet_si, schedule,
                              validate_mapping)
from repro_torch.core.autoshard import default_microbatches, plan  # noqa: E402
from repro_torch.core.modelgraph import build_model_graph  # noqa: E402
from repro_torch.kernels import _build, cost  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch import (build_prefill_step, build_serve_step,  # noqa: E402
                                build_train_step, make_local_mesh)
from repro_torch.launch import dryrun, op_analysis  # noqa: E402
from repro_torch.launch.steps import gathered, place_like, place_state  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import attention as attention_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import rwkv as rwkv_mod  # noqa: E402
from repro_torch.models import transformer as transformer_mod  # noqa: E402
from repro_torch.models.rwkv import wkv_chunked  # noqa: E402
from repro_torch.kernels import adamw as fused_adamw  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,  # noqa: E402
                               adamw_update_eager, global_norm, warmup_cosine)
from repro_torch.optim.adamw import _bias_and_lr, _clip_scale, _update_eager  # noqa: E402
from repro_torch.runtime import (FailureInjector, Request, ServeLoop, Trainer,  # noqa: E402
                                 TrainerConfig, pipeline_apply, rescale_plan,
                                 run_with_restarts, stack_stage_params)
from repro_torch.obs import METRICS, ObsConfig  # noqa: E402
from repro_torch.scenario import ProcArrival, ProcFailure  # noqa: E402
from repro_torch.service import (PlanCache, QuotaConfig, ServiceConfig,  # noqa: E402
                                 Submission, TenantQuota, run_service, run_sustained)
from repro_torch.sim import simulate  # noqa: E402
from repro_torch.throughput import (plan_throughput, saturation_sweep,  # noqa: E402
                                    simulate_pipelined)

# the modules; the package's ``flash_attention`` and ``rwkv_wkv`` are the
# layout wrappers
fa = importlib.import_module("repro_torch.kernels.flash_attention")
wkv = importlib.import_module("repro_torch.kernels.rwkv_wkv")
KERNEL_SOURCES = _build.SOURCES
SEED = 0
# H100 SXM data sheet, dense: bf16 tensor cores, f32 on the CUDA cores, HBM3
# (the package's one copy, which the dry run reads too)
PEAK_FLOPS, PEAK_BYTES = cost.PEAK_FLOPS, cost.PEAK_BYTES
# the llama3_8b prefill layer: B=1, S=4096, Hq=32, Hkv=8, hd=128, causal
MAIN_SHAPE = (1, 4096, 32, 8, 128)
# the olmoe_1b_7b layer at the same length: MHA, 16 heads of 128
OLMOE_SHAPE = (1, 4096, 16, 16, 128)
# the jamba_15_large and llama32_vision_90b layer: GQA 64/8 of 128 (group 8)
GQA8_SHAPE = (1, 4096, 64, 8, 128)
# the seamless_m4t_v2 layer: MHA, 16 heads of 64; non-causal in the
# encoder, causal in the decoder
SEAMLESS_SHAPE = (1, 4096, 16, 16, 64)
# the shapes whose kernel times the kernels line reports, by the arch whose
# layer they are, the dtypes and the masks (llama3_8b: both dtypes; the
# others bf16, their dtype; seamless_m4t_v2's encoder is non-causal)
TIMED_SHAPES = {MAIN_SHAPE: ("llama3_8b", ("f32", "bf16"), (True,)),
                OLMOE_SHAPE: ("olmoe_1b_7b", ("bf16",), (True,)),
                GQA8_SHAPE: ("jamba_15_large", ("bf16",), (True,)),
                SEAMLESS_SHAPE: ("seamless_m4t_v2", ("bf16",), (False, True))}
PREFILL = (2, 4096)                 # prompt batch x length of phase 3
SCHED_N, SCHED_SEED = 1000, 1       # phase 29: tasks of each family's workflow, its seed
SCHED_WORKERS = 4                   # phase 29: the pool of each schedule's parallel rerun
MAIN_PATH = (2, 256)                # batch x prompt length of serve.main below
CONSISTENCY = (2, 80)               # batch x length of the 4-layer f32 prefill vs decode
KERNEL_SHAPES = [
    (1, 32, 2, 2, 16),      # MHA
    (2, 64, 4, 2, 32),      # GQA 2:1
    (1, 128, 8, 1, 64),     # MQA
    (2, 48, 4, 4, 128),     # S not a multiple of the tile
    (1, 1000, 32, 8, 128),  # ragged S at llama3_8b heads
    (2, 1000, 16, 4, 64),   # ragged S, GQA 4:1, the tensor-core kernel's hd 64
    MAIN_SHAPE,                 # also what phase 15's mixtral_8x7b prefill gives it
    OLMOE_SHAPE,
    (*PREFILL, 32, 8, 128),     # what phase 3's prefill gives the kernel
    (*MAIN_PATH, 32, 8, 128),   # what serve.main's prefill gives it
    (*PREFILL, 16, 16, 128),    # olmoe_1b_7b's prefill (phase 12)
    (*MAIN_PATH, 16, 16, 128),  # olmoe_1b_7b's serve.main prefill
    (*CONSISTENCY, 16, 16, 128),  # olmoe_1b_7b's 4-layer f32 prefill (phase 14)
    GQA8_SHAPE,
    SEAMLESS_SHAPE,
    (*PREFILL, 64, 8, 128),     # jamba_15_large's and llama32_vision_90b's prefill
    (*PREFILL, 16, 16, 64),     # seamless_m4t_v2's encoder and decoder prefill
    (*CONSISTENCY, 64, 8, 128),  # their f32 prefills (phases 16, 17)
    (*MAIN_PATH, 16, 16, 64),   # seamless_m4t_v2's serve.main prefill
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
# the training shapes, and what phases 9, 11 and 14 give it
BWD_SHAPES = KERNEL_SHAPES[:8] + [
    (GRAD_CHECK[0], GRAD_CHECK[1], 32, 8, 128), (TRAINER_SHAPE[1], TRAINER_SHAPE[0], 4, 2, 16),
    (GRAD_CHECK[0], GRAD_CHECK[1], 16, 16, 128),
    SEAMLESS_SHAPE, (GRAD_CHECK[0], GRAD_CHECK[1], 16, 16, 64)]    # phases 19, 19b
# The sliding window (phases 2, 8 and 15): mixtral_8x7b's window of 4096 over
# its GQA 32/8 layer at hd 128, at twice the window (the f32 check's and the
# training step's length) and at the 32k prefill's length, where the plain
# version runs WINDOW_BLOCK query rows at a time (its 32 x 32768^2 f32 scores
# in one call would not fit the card)
MIXTRAL_WINDOW = 4096
WINDOW_SHAPE = (1, 8192, 32, 8, 128)
WINDOW_LONG = (1, 32768, 32, 8, 128)
WINDOW_BLOCK = 2048
# (b, s, h, hkv, hd, window, masks) of the windowed calls held against the
# plain version in both dtypes: mixtral's layer; a ragged S with a window off
# every tile size and with one key; a window of one 64-key tile at hd 64; a
# window without the causal mask (every later key kept)
WINDOW_CASES = [(*WINDOW_SHAPE, MIXTRAL_WINDOW, (True,)),
                (1, 1000, 32, 8, 128, 300, (True,)),
                (1, 1000, 32, 8, 128, 1, (True,)),
                (2, 1000, 16, 4, 64, 64, (True,)),
                (1, 2048, 32, 8, 128, 512, (False,))]
# mixtral_8x7b's windowed cells: the prefill at 32k (4 layers), the f32
# check at 2 layers over WINDOW_SHAPE's length, one training step at 1 layer
MIXTRAL_LONG_PREFILL = (1, 32768)
MIXTRAL_F32_LAYERS = 2
MIXTRAL_TRAIN_LAYERS = 1
# examples/train_lm_torch.py --preset tiny on the card (phase 28a)
TRAIN_LM_EXAMPLE_TIMEOUT_S = 300
# phase 30: the jitter envelope of each replay (lognormal sigma, replicas,
# seed), and examples/elastic_serving_torch.py's time limit
SIM_JITTER = (0.2, 16, 0)
ELASTIC_EXAMPLE_TIMEOUT_S = 300
# phase 31: instances of each pipelined replay, the offered rate over the
# plan's rate, its arrival seed, and genome's saturation ladder
THROUGHPUT_INSTANCES = 64
THROUGHPUT_LOAD = 0.8
THROUGHPUT_SEED = 0
SATURATION_RUNGS = (0.5, 0.8, 0.95, 1.1)
# what the reference (repro.throughput) gives on a CPU host for phase 29's
# workflows: genome's saturation rows (offered, achieved, p50, p99,
# saturated), and the memory violations of each family's 64-instance replay
# (seismology's overlapping instances exceed a processor's 192 by 0.146; the
# other six families have none)
GENOME_SATURATION = [
    (0.0002843954908548803, 0.0002726725653771168, 7885.133844139942, 9973.299114593854, False),
    (0.0004550327853678085, 0.0004223617001483205, 8761.01116772887, 13120.41763820288, True),
    (0.0005403514326242726, 0.0004866863863501968, 8892.058475633188, 14359.717434011933, True),
    (0.0006256700798807367, 0.0005473071762974333, 10038.151556117467, 15222.887266815285, True)]
PIPELINED_VIOLATIONS = {"seismology": 9}
# the port's models replicated on four cards (phase 31 b)
THROUGHPUT_FLEET = {"h100": 4}
THROUGHPUT_REPLICAS = {"llama3_8b": 4, "mixtral_8x7b": 2}
# phase 31 (c): the service's k' sweep, the spacing of the families'
# arrivals, and its events' times: on a CPU host, genome (job 0) runs over
# [0, 18848.16], so the failure of the two last processors at 3000 strikes
# it, and the spare arrives at 20000 with jobs queued
SERVICE_KPRIME = [2, 4, 6]
SERVICE_WORKERS = 2                 # the pool of phase 31 (c)'s parallel run
SERVICE_SPACING = 100.0
SERVICE_FAILURE_T, SERVICE_ARRIVAL_T = 3000.0, 20000.0
HOST_EXAMPLES = {"heterogeneous_scheduling_torch.py": "bit-identical to analytic: True",
                 "multi_tenant_service_torch.py": "=== stitched timeline ===",
                 "sustained_throughput_torch.py": "bit-equal: True"}
HOST_EXAMPLE_TIMEOUT_S = 300
# olmoe_1b_7b: full depth for serving; 6 of 16 layers for training (2.72 B
# parameters: 43.6 GB of params, grads and AdamW state)
OLMOE_TRAIN_LAYERS = 6
OLMOE_SERVE = dict(n_requests=8, prompt=(16, 65), new_tokens=16)    # ServeLoop of phase 12
# mixtral_8x7b: 4 of 32 layers (6.07 B parameters, 12.1 GB in bf16);
# prefill B x S, then decode steps past the 4096 window
MIXTRAL_LAYERS = 4
MIXTRAL_PREFILL = (1, 4096)
MIXTRAL_DECODE = 16
# jamba_15_large (399.6 B parameters whole): full width, 4 of 72 layers at
# attn_layer_period 4 (mamba, mamba+MoE, mamba, attn+MoE; at its own period
# of 8, 4 layers hold no attention layer), 23.07 B parameters, 46.1 GB in
# bf16; the f32 check at 2 layers and period 2 (mamba, attn+MoE), 11.9 B
# parameters, 47.7 GB
JAMBA_CUT = dict(n_layers=4, attn_layer_period=4)
JAMBA_F32_CUT = dict(n_layers=2, attn_layer_period=2)
# llama32_vision_90b (90.7 B whole): full width, 10 of 100 layers (2 cross
# layers), 10.96 B parameters, 21.9 GB in bf16; the f32 check at 5 (1 cross)
VISION_CUT = dict(n_layers=10)
VISION_F32_CUT = dict(n_layers=5)
NEW_DECODE = (2, 16, 4)     # batch, teacher-forced prompt, new tokens of greedy_decode
# seamless_m4t_v2 (1.93 B) is served and trained whole; the f32 gradient
# check at 4 encoder and 4 decoder layers over GRAD_CHECK's length of frames
SEAMLESS_F32_CUT = dict(n_layers=4, n_encoder_layers=4)
# its cross-attention is the chunked scan on the card: the LM's default KV
# chunk of 512, not the Trainer's 64 (64 chunks a layer of small launches)
SEAMLESS_TRAIN_ATTN_CHUNK = 512
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

# The WKV backward's shapes (b, s, h, hd, model layout): the JAX kernel
# tests' and a ragged S at the rwkv6_1b6 heads, contiguous; then the
# training shape and what phases 9b and 11 give it, in model layout
WKV_TRAIN = (TRAIN_SHAPE[0], TRAIN_SHAPE[1], 32, 64)    # one rwkv6_1b6 layer of phase 10b
RWKV_TRAIN_MAIN = ("--arch", "rwkv6_1b6")               # launch.train.main in phase 11
WKV_BWD_SHAPES = [(1, 16, 1, 8, False), (2, 32, 2, 16, False), (1, 64, 4, 64, False),
                  (2, 24, 2, 32, False), (1, 15, 4, 64, False), (2, 17, 4, 64, False),
                  (1, 1000, 32, 64, False), (*WKV_TRAIN, True),
                  (*GRAD_CHECK, 32, 64, True),          # phase 9b (f32, 4 layers)
                  (4, 32, 2, 32, True)]                 # launch.train.main's smoke config
# Limit of the WKV backward against autograd of the plain version: every
# gradient within REL of its largest |value|, plus one bf16 ulp (rtol
# 2**-7) where the gradient is bf16.  REL is 25x the f32 spread of autograd
# of the plain version from an f64 oracle, as tests/test_torch_wkv_bwd.py
# measures it (at most 2.5e-7 for dr, dk, dv, dw and ds0, and 2e-6 for du,
# which sums B*S steps), at the test shapes, S = 1024 under the model's
# law of w and S = 4096 with every w near e^-8.  A limit relative to each tensor's largest value, not to each
# element: dw near w = e^-8 and entries that cancel have no element-scale
# f32 accuracy in either version.
WKV_BWD_REL = {"du": 5e-5, "other": 6.25e-6}
WKV_GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")
# full llama3_8b decode through the int8 and the bf16 cache: batch x steps
KV_INT8 = (2, 64)

# The step builders' cells on the card (phases 20-23), each on a mesh of
# one, registered as the JAX tests register theirs: llama3_8b's prefill at
# PREFILL at full depth; its train step at 8 layers on one sequence of
# 4096, and with grad_accum 2 on two; its decode step over caches of 4096
# for 8 rows (4.3 GB); rwkv6_1b6's train step at full depth
STEPS_PREFILL = ShapeConfig("card_prefill", PREFILL[1], PREFILL[0], "prefill")
STEPS_TRAIN = ShapeConfig("card_train", TRAIN_SHAPE[1], TRAIN_SHAPE[0], "train")
STEPS_TRAIN_ACCUM = ShapeConfig("card_train_accum", TRAIN_SHAPE[1], 2, "train")
STEPS_DECODE = ShapeConfig("card_decode", 4096, 8, "decode")
for _shape in (STEPS_PREFILL, STEPS_TRAIN, STEPS_TRAIN_ACCUM, STEPS_DECODE):
    SHAPES.setdefault(_shape.name, _shape)
STEPS_TRAIN_STEPS = 5
# Bars of a bundle's step against the same step on plain tensors.  On a
# mesh of one the DTensor route runs the same kernels on the same storage,
# so anything past rounding order is a fault: the loss to 1e-4 of its
# value; AdamW's m to one bf16 ulp (2**-7) of each leaf's largest |m|,
# the ulp of the bf16 gradient it is made of; the f32 master after the
# second step (the first whose warmup scale is not 0) to twice that
# step's update, lr 3e-4 x warmup 0.01 (a gradient entry that is noise
# takes Adam's sign-like step either way)
STEPS_LOSS_REL = 1e-4
STEPS_M_REL = 2.0 ** -7
STEPS_MASTER_ATOL = 2 * 3e-4 * 0.01
# jamba_15_large trained at full width with 1 layer: layer 0, a Mamba
# mixer with a dense FFN (2.115 B parameters, 33.8 GB of params, grads and
# AdamW state).  llama32_vision_90b with 1 layer at cross_attn_period 1:
# self- and cross-attention in one layer (3.108 B, 49.7 GB).  The 2-layer
# cut at period 2 (3.964 B, 63.4 GB of state) ran out of the card's 79.2
# GiB in AdamW's f32 temporaries of the 1.05 B-entry embedding (peak 80.5
# GB; PERF.md §4)
JAMBA_TRAIN_CUT = dict(n_layers=1)
VISION_TRAIN_CUT = dict(n_layers=1, cross_attn_period=1)
# The dry run held against the step cells of phases 20-22 (phase 26): its
# predicted peak over the step's measured peak must lie in this range
DRYRUN_PEAK_RATIO = (0.75, 1.33)
# both --production dry runs (phase 27) run at once, each within this time
PRODUCTION_DRYRUN_TIMEOUT_S = 600
# the one-stage GPipe run (phase 28): llama3_8b's TRAIN_LAYERS blocks on
# batch x length hidden states in as many microbatches as rows
PIPELINE_BATCH = (4, 4096)
PIPELINE_MICROBATCHES = 4


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


@contextlib.contextmanager
def step_memory(inputs, row: dict):
    """The card's memory around one step, into ``row``: its raw peak
    (``torch.cuda.max_memory_allocated``, reset just before the step),
    what was allocated before it, the bytes of the step's inputs (their
    distinct storages) and ``step_peak_bytes``, the peak with only the
    inputs alive before the step: what the dry run predicts."""
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    yield
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    nbytes = op_analysis.argument_bytes(inputs)
    row.update(peak_bytes=peak, allocated_before_bytes=before, input_bytes=nbytes,
               step_peak_bytes=peak - before + nbytes)


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


def windows_ms(fn, reps: int = 10, windows: int = 20) -> dict:
    """``time_ms(fn, reps)`` taken ``windows`` times (each window its own
    warm-up, then ``reps`` calls back to back between two CUDA events):
    the median window and the spread (min, quartiles, max)."""
    times = [time_ms(fn, reps) for _ in range(windows)]
    q1, _, q3 = statistics.quantiles(times, n=4)
    return dict(median=statistics.median(times), min=min(times), q1=q1, q3=q3,
                max=max(times), reps=reps, windows=windows)


# the bound column's formulas (kernels/cost.py)
attention_flops, attention_bound_ms = cost.attention_flops, cost.attention_bound_ms
bwd_flops, bwd_bound_ms = cost.bwd_flops, cost.bwd_bound_ms
wkv_bound_ms, wkv_bwd_bound = cost.wkv_bound_ms, cost.wkv_bwd_bound


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
    for name, entries in _build.ENTRY_POINTS.items():
        lib = _build.load_library(name)
        missing = [e for e in entries if not hasattr(lib, e)]
        check(not missing, f"lib{name} lacks the entry points {missing}")
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
        # one instantiation per head dim, with and without a sliding window
        check(len(sass) == 2 * len(fa.WGMMA_HEAD_DIMS) and
              all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 for c in sass.values()),
              f"{kernel} lacks HGMMA or UTMALDG in its SASS: {sass}")
    lib = _build.load_library("rwkv_wkv")
    emit("build", kernel="rwkv_wkv", chunked_dynamic_smem_bytes={
        f"{'bf16' if bw else 'f32'}_w": lib.repro_wkv_chunked_smem_bytes(bw) for bw in (0, 1)},
         backward_dynamic_smem_bytes={hd: lib.repro_wkv_bwd_smem_bytes(hd)
                                      for hd in wkv.KERNEL_HEAD_DIMS},
         backward_chunked_dynamic_smem_bytes={
             f"{'bf16' if bw else 'f32'}_w": {"chains": lib.repro_wkv_bwd_chunked_smem_bytes(bw, 0),
                                             "chunks": lib.repro_wkv_bwd_chunked_smem_bytes(bw, 1)}
             for bw in (0, 1)})
    sass = sass_instructions("rwkv_wkv", "wkv_fwd_chunked_kernel",
                             ("HMMA", "LDSM", "LDGSTS", "HGMMA", "UTMALDG", "LDL", "STL"))
    emit("build", kernel="rwkv_wkv", sass=sass)
    check(len(sass) == 2 and
          all(c["HMMA"] > 0 and c["LDGSTS"] > 0 for c in sass.values()),
          f"the chunked WKV kernel lacks HMMA or LDGSTS in its SASS: {sass}")
    # the backward's state rows and columns must stay in registers
    sass = sass_instructions("rwkv_wkv", "wkv_bwd_kernel", ("LDL", "STL"))
    emit("build", kernel="rwkv_wkv", backward_sass=sass)
    check(len(sass) == 16 and all(c["LDL"] == c["STL"] == 0 for c in sass.values()),
          f"the WKV backward kernel uses local memory: {sass}")
    # the chunk-parallel backward: its chains on the tensor cores, cp.async
    # loads in both kernels, nothing in local memory
    for kernel, ops in (("wkv_bwd_chain_kernel", ("HMMA", "LDSM", "LDGSTS", "LDL", "STL")),
                        ("wkv_bwd_chunk_kernel", ("LDGSTS", "SHFL", "LDL", "STL"))):
        sass = sass_instructions("rwkv_wkv", kernel, ops)
        emit("build", kernel="rwkv_wkv", backward_chunked_sass=sass)
        check(len(sass) == 2 and all(c["LDL"] == c["STL"] == 0 and c["LDGSTS"] > 0 and
                                     c.get("HMMA", 1) > 0 for c in sass.values()),
              f"{kernel} lacks HMMA or LDGSTS, or uses local memory: {sass}")
    spills = ptxas_spills(logs[KERNEL_SOURCES.index("rwkv_wkv")], "wkv_bwd_")
    emit("build", kernel="rwkv_wkv", backward_ptxas=spills)
    check(all(e["spill_bytes"] == 0 for e in spills.values()),
          f"ptxas spills in a WKV backward kernel: {spills}")


def ptxas_spills(log: str, kernel: str) -> dict:
    """Registers and spill bytes ptxas reported for each function of a
    build log whose name contains ``kernel`` (empty if nothing was built)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
            if name:
                out[name] = {}
        elif name and "spill stores" in line:
            out[name]["spill_bytes"] = sum(
                int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))
        elif name and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


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


def cuda_core_bf16_ms(q, k, v, causal: bool, reps: int, window: int = 0) -> float:
    """The CUDA-core kernel's time on bf16 inputs that the wrapper sends to
    the tensor-core kernel: the earlier design, timed in the same run.
    Called through its C entry point, so no launch count moves."""
    o = torch.empty_like(q)
    fn = fa._kernel("cuda_core")
    stream = torch.cuda.current_stream().cuda_stream
    bh, s, hd = q.shape
    launch = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),  # noqa: E731
                        None, bh, k.shape[0], s, hd, 1, int(causal), window, hd ** -0.5,
                        stream)
    check(launch() == 0, "the CUDA-core kernel refused a bf16 launch")
    return time_ms(launch, reps)


def phase_kernel() -> tuple[dict, list]:
    """Kernel vs plain at every shape and dtype; times at ``TIMED_SHAPES``,
    keyed (arch, dtype, causal)."""
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
                arch, timed_dtypes, timed_masks = TIMED_SHAPES.get((b, s, h, hkv, hd),
                                                                   (None, (), ()))
                if name in timed_dtypes and causal in timed_masks:
                    reps = 10
                    row["kernel_ms"] = time_ms(
                        lambda: fa.flash_attention_bhsd(q, k, v, causal=causal), reps)
                    row["plain_ms"] = time_ms(
                        lambda: fa.flash_attention_bhsd_plain(q, k, v, causal=causal), reps)
                    # yardstick only: the port never calls SDPA
                    q4, k4, v4 = (t.view(b, -1, s, hd) for t in (q, k, v))
                    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                        q4, k4, v4, is_causal=causal, enable_gqa=True)
                    row["library_ms"] = time_ms(sdpa, reps)
                    row["library_max_abs_err"] = float(
                        (sdpa().reshape(out.shape).float() - ref.float()).abs().max())
                    row["bound_ms"], row["bound_by"] = attention_bound_ms(
                        b * h, b * hkv, s, hd, causal, name, q.element_size())
                    row["achieved_tflops"] = (attention_flops(b * h, s, hd, causal)
                                              / row["kernel_ms"] / 1e9)
                    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
                    row["kernel_over_library"] = row["kernel_ms"] / row["library_ms"]
                    if name == "bf16":
                        row["cuda_core_kernel_ms"] = cuda_core_bf16_ms(q, k, v, causal, reps)
                    timed[(arch, name, causal)] = row
                emit("kernel", **row)
                rows.append(row)
                check(ok, f"flash_attention_bhsd disagrees with its plain version: {row}")
                check(row.get("fault_rejected", True),
                      f"the limit lets a zeroed V tile through: {row}")
            del q, k, v, out, ref
    return timed, rows


def window_fault_v(v, s: int, window: int):
    """V with one row inside the window zeroed: the key at the lower edge
    of the last query's window, which a kernel that masked or skipped one
    key too many at that edge would drop."""
    v = v.clone()
    v[:, max(s - window, 0)] = 0
    return v


def plain_window_blocked(q, k, v, window: int, block: int = WINDOW_BLOCK):
    """The plain version of a causal windowed call, ``block`` query rows at
    a time: rows [q0, q1) read only keys [q0 - W + 1, q1), and the mask
    depends on q - k alone, so ``flash_attention_bhsd_plain`` over that span
    gives those rows the mask of the whole call."""
    s = q.shape[1]
    rows = []
    for q0 in range(0, s, block):
        q1, a = min(q0 + block, s), max(0, q0 - window + 1)
        rows.append(fa.flash_attention_bhsd_plain(
            q[:, a:q1], k[:, a:q1], v[:, a:q1], causal=True, sliding_window=window)[:, q0 - a:])
    return torch.cat(rows, dim=1)


def window_kernel_times(q, k, v, causal: bool, window: int, reps: int) -> dict:
    """The windowed forward kernel against the same call without a window:
    CUDA events over ``reps`` calls, as phase 2 times every kernel, and a
    profiler window of each (the kernel's own device time; None where the
    profiler recorded fewer than half the launches, which it has been seen
    to do in a long process)."""
    hd = q.shape[-1]
    kernel = ("flash_fwd_wgmma_kernel" if fa.kernel_variant(q.dtype, hd) == "wgmma"
              else "flash_fwd_kernel")
    calls = {"": lambda: fa.flash_attention_bhsd(q, k, v, causal=causal, sliding_window=window),
             "_no_window": lambda: fa.flash_attention_bhsd(q, k, v, causal=causal)}
    row = {}
    for tag, fn in calls.items():
        row[f"kernel{tag}_ms"] = time_ms(fn, reps)
        total, count = profiled_ms(fn, reps, (kernel,))[kernel]
        row[f"profiler_kernel{tag}_ms"] = total / count if reps // 2 <= count <= reps else None
        row[f"profiler_kernel{tag}_seen"] = count
    return row


def window_times(q, k, v, causal: bool, window: int, name: str) -> dict:
    """The windowed kernel against the same call without a window
    (:func:`window_kernel_times`), the plain version and SDPA with a boolean
    mask of the same window (the library call, the yardstick only: the
    port never calls SDPA); the bounds of both calls from ``cost.py``."""
    bh, s, hd = q.shape
    row = window_kernel_times(q, k, v, causal, window, 10)
    row["plain_ms"] = time_ms(lambda: fa.flash_attention_bhsd_plain(
        q, k, v, causal=causal, sliding_window=window), 2)
    pos = torch.arange(s, device="cuda")
    keep = pos[None, :] > pos[:, None] - window
    if causal:
        keep &= pos[None, :] <= pos[:, None]
    q4, k4, v4 = (t.view(1, -1, s, hd) for t in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=keep, enable_gqa=True)
    row["library_ms"] = time_ms(sdpa, 5)
    ref = fa.flash_attention_bhsd_plain(q, k, v, causal=causal, sliding_window=window)
    row["library_max_abs_err"] = float((sdpa().reshape(q.shape).float() - ref.float()).abs().max())
    del ref
    row["bound_ms"], row["bound_by"] = attention_bound_ms(
        bh, k.shape[0], s, hd, causal, name, q.element_size(), window)
    row["bound_no_window_ms"], _ = attention_bound_ms(bh, k.shape[0], s, hd, causal, name,
                                                      q.element_size())
    row["kept_pairs_per_head"] = cost.attention_pairs(s, causal, window)
    row["achieved_tflops"] = attention_flops(bh, s, hd, causal, window) / row["kernel_ms"] / 1e9
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    row["no_window_over_window"] = row["kernel_no_window_ms"] / row["kernel_ms"]
    row["kernel_over_library"] = row["kernel_ms"] / row["library_ms"]
    if name == "bf16":
        row["cuda_core_kernel_ms"] = cuda_core_bf16_ms(q, k, v, causal, 3, window)
    return row


def phase_kernel_window() -> tuple[dict, list]:
    """Phase 2's windowed calls: both forward kernels with a sliding window
    (``WINDOW_CASES``, f32 and bf16) vs the plain version with the same
    window, at phase 2's limits; a planted fault (one V row inside the
    window zeroed) that the limit must reject; a window of S and 2S bit-equal
    to none.  The 32k prefill's call (``WINDOW_LONG``, bf16) likewise, against
    :func:`plain_window_blocked`.  Times at ``WINDOW_SHAPE`` (both dtypes) and
    ``WINDOW_LONG``, keyed by dtype and "long"."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    timed, rows = {}, []
    for b, s, h, hkv, hd, window, masks in WINDOW_CASES:
        for name, dt in dtypes.items():
            q, k, v = (torch.randn((b * n, s, hd), generator=gen, device="cuda").to(dt)
                       for n in (h, hkv, hkv))
            for causal in masks:
                fa.reset_launch_counts()
                out = fa.flash_attention_bhsd(q, k, v, causal=causal, sliding_window=window)
                by_mask = dict(fa.flash_attention_bhsd.mask_launches)
                ref = fa.flash_attention_bhsd_plain(q, k, v, causal=causal, sliding_window=window)
                torch.cuda.synchronize()
                atol, rtol = TOL[name]
                variant = fa.kernel_variant(dt, hd)
                mask = fa.mask_name(causal, window, s)
                row = dict(shape=[b, s, h, hkv, hd], window=window, dtype=name, causal=causal,
                           variant=variant, mask_launches=by_mask,
                           max_abs_err=float((out.float() - ref.float()).abs().max()),
                           atol=atol, rtol=rtol,
                           limit_ratio=limit_ratio(out.float(), ref.float(), atol, rtol))
                row["ok"] = row["limit_ratio"] <= 1
                bad = fa.flash_attention_bhsd_plain(q, k, window_fault_v(v, s, window),
                                                    causal=causal, sliding_window=window)
                row["fault_limit_ratio"] = limit_ratio(bad.float(), ref.float(), atol, rtol)
                row["fault_rejected"] = row["fault_limit_ratio"] > 1
                del bad, ref
                none = fa.flash_attention_bhsd(q, k, v, causal=causal)
                row["window_ge_s_bit_equal"] = all(torch.equal(none, fa.flash_attention_bhsd(
                    q, k, v, causal=causal, sliding_window=w)) for w in (s, 2 * s))
                del none
                if (b, s, h, hkv, hd) == WINDOW_SHAPE:
                    row.update(window_times(q, k, v, causal, window, name))
                    timed[name] = row
                emit("kernel_window", **row)
                rows.append(row)
                check(mask.endswith("+window") and by_mask == {f"{variant}/{mask}": 1},
                      f"a windowed call counted {by_mask}, want one {variant}/{mask}")
                check(row["ok"], f"the windowed kernel disagrees with its plain version: {row}")
                check(row["fault_rejected"], f"the limit lets a zeroed V row through: {row}")
                check(row["window_ge_s_bit_equal"],
                      f"a window of S or 2S does not give the bits of none: {row}")
            del q, k, v, out
    # the 32k prefill's call against the plain version run a block of query
    # rows at a time, at phase 2's bf16 limits, with the planted fault
    b, s, h, hkv, hd = WINDOW_LONG
    q, k, v = (torch.randn((b * n, s, hd), generator=gen, device="cuda").bfloat16()
               for n in (h, hkv, hkv))
    atol, rtol = TOL["bf16"]
    fa.reset_launch_counts()
    out = fa.flash_attention_bhsd(q, k, v, sliding_window=MIXTRAL_WINDOW)
    by_mask = dict(fa.flash_attention_bhsd.mask_launches)
    ref = plain_window_blocked(q, k, v, MIXTRAL_WINDOW).float()
    row = dict(shape=list(WINDOW_LONG), window=MIXTRAL_WINDOW, dtype="bf16", causal=True,
               variant="wgmma", mask_launches=by_mask, plain_block_rows=WINDOW_BLOCK,
               finite=bool(torch.isfinite(out).all()),
               max_abs_err=float((out.float() - ref).abs().max()), atol=atol, rtol=rtol,
               limit_ratio=limit_ratio(out.float(), ref, atol, rtol))
    row["ok"] = row["limit_ratio"] <= 1
    bad = plain_window_blocked(q, k, window_fault_v(v, s, MIXTRAL_WINDOW), MIXTRAL_WINDOW)
    row["fault_limit_ratio"] = limit_ratio(bad.float(), ref, atol, rtol)
    row["fault_rejected"] = row["fault_limit_ratio"] > 1
    del bad, ref, out
    row["plain_ms"] = time_ms(lambda: plain_window_blocked(q, k, v, MIXTRAL_WINDOW), 1)
    row.update(window_kernel_times(q, k, v, True, MIXTRAL_WINDOW, 3))
    row["bound_ms"], row["bound_by"] = attention_bound_ms(b * h, b * hkv, s, hd, True, "bf16", 2,
                                                          MIXTRAL_WINDOW)
    row["bound_no_window_ms"], _ = attention_bound_ms(b * h, b * hkv, s, hd, True, "bf16", 2)
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    row["no_window_over_window"] = row["kernel_no_window_ms"] / row["kernel_ms"]
    emit("kernel_window", **row)
    check(by_mask == {"wgmma/causal+window": 1},
          f"the 32k windowed call counted {by_mask}, want one wgmma/causal+window")
    check(row["finite"], f"the windowed kernel at 32k gave non-finite output: {row}")
    check(row["ok"], f"the windowed kernel at 32k disagrees with its plain version: {row}")
    check(row["fault_rejected"], f"the limit at 32k lets a zeroed V row through: {row}")
    timed["long"] = row
    del q, k, v
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
    return cost.wkv_bytes(b, h, s, hd, io_bytes, w_bytes) / PEAK_BYTES * 1e3


def wkv_tensor_flops(b, h, s, hd) -> int:
    """The chunked kernel's tensor-core operations: per 16-step chunk and
    16 value columns, S^T (r*P)^T in three bf16 products (16 x 16 x hd),
    V^T A^T in two (16 x 16 x 16) and V^T (k*E) in three (16 x hd x 16).
    Work of the chunked form, beyond the recurrence's 5 hd^2 per step."""
    per_chunk = 2 * (3 * 16 * 16 * hd + 2 * 16 * 16 * 16 + 3 * 16 * hd * 16)
    return per_chunk * (hd // 16) * b * h * -(-s // 16)


def is_device_work(e) -> bool:
    """Whether an entry of ``key_averages()`` is a kernel, copy or set on
    the card: a device-side entry that is not a named range's device
    span (a user annotation, such as the program's ``repro_torch.*``
    device spans), which covers kernels counted in their own entries."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("repro_torch."))


def profiled_kernels(fn, reps: int) -> dict:
    """``{kernel name: (device ms, launches recorded)}`` of every kernel
    over ``reps`` calls of ``fn`` in one ``torch.profiler`` window after
    one call outside it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if is_device_work(e):
            us = getattr(e, "self_device_time_total", None)
            total, count = out.get(e.key, (0.0, 0))
            out[e.key] = (total + (e.self_cuda_time_total if us is None else us) / 1e3,
                          count + e.count)
    return out


def profiled_ms(fn, reps: int, kernels) -> dict:
    """``{name: (device ms, launches recorded)}`` of the kernels whose name
    contains each of ``kernels``, over ``reps`` calls of ``fn`` in one
    ``torch.profiler`` window after one call outside it."""
    seen = profiled_kernels(fn, reps)
    return {name: (sum(t for key, (t, _) in seen.items() if name in key),
                   sum(c for key, (_, c) in seen.items() if name in key))
            for name in kernels}


def call_device_ms(fn, reps: int = 20) -> dict:
    """Device time of one call of ``fn``, every kernel it launches, from
    one profiler window of ``reps`` calls: each kernel's time per launch
    recorded, times its launches a call (those recorded over ``reps``,
    rounded; the profiler drops a few launches of a window).  A window in
    which a kernel's launches are not within a quarter of a whole number
    a call (most of them dropped) is taken again, three times at most;
    after that ``per_call`` is None (a reading, not a check)."""
    for _ in range(3):
        seen = profiled_kernels(fn, reps)
        counts = {k: c for k, (_, c) in seen.items()}
        per_call = {k: round(c / reps) for k, c in counts.items()}
        if seen and all(per_call[k] >= 1 and abs(c / reps - per_call[k]) <= 0.25
                        for k, c in counts.items()):
            return dict(per_call=sum(t / c * per_call[k] for k, (t, c) in seen.items()),
                        launches_a_call=sum(per_call.values()),
                        launches_seen=sum(counts.values()), reps=reps)
        emit("profiler_retry", kernel="every", seen=counts, want=reps)
    return dict(per_call=None, launches_seen=counts, reps=reps)


def device_ms(fn, reps: int, kernel: str) -> float:
    """Device time per launch of the kernels whose name contains ``kernel``,
    from ``torch.profiler``: for launches too short for CUDA events around
    a host-bound loop.  Per launch the profiler recorded: it has been seen
    to drop one launch of a window, and now and then most or all of them,
    so a window that recorded fewer than half is taken again, three times
    at most."""
    seen = []
    for _ in range(3):
        total, count = profiled_ms(fn, reps, (kernel,))[kernel]
        if reps // 2 <= count <= reps:
            return total / count
        seen.append(count)
        emit("profiler_retry", kernel=kernel, seen=count, want=reps)
    raise RuntimeError(f"profiler saw {seen} launches of {kernel} in three tries, want {reps}")


def kernel_split_ms(fn, reps: int, kernels) -> dict:
    """Device time per launch of each kernel named in ``kernels`` (a name
    part) over ``reps`` calls of ``fn`` that launch each once, from one
    profiler window, divided by the launches the profiler recorded: it has
    been seen to drop the first launch of a window.  Keys
    ``<name>_ms`` and ``<name>_seen``."""
    out = {}
    for name, (total, count) in profiled_ms(fn, reps, kernels).items():
        check(reps // 2 <= count <= reps, f"the profiler saw {count} launches of {name}, "
                                          f"want {reps}")
        out[f"{name}_ms"], out[f"{name}_seen"] = total / count, count
    return out


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
                 for name in _WKV_KERNEL}
        emit("wkv_choice", shape=[b, s, h, hd], kernel_ms=times,
             wrapper_picks=wkv.kernel_variant(r.dtype, w.dtype, hd, s),
             chunked_min_seq=wkv.CHUNKED_MIN_SEQ)


def wkv_bwd_ratio(name: str, got, ref) -> float:
    """Largest |got - ref| / (REL max|ref| + rtol |ref|): at most 1 within
    the limit (:data:`WKV_BWD_REL`)."""
    rel = WKV_BWD_REL["du" if name == "du" else "other"]
    rtol = 2.0 ** -7 if ref.dtype == torch.bfloat16 else 0.0
    got, ref = got.float(), ref.float()
    scale = rel * float(ref.abs().max().clamp(min=1e-30))
    return float(((got - ref).abs() / (scale + rtol * ref.abs())).max())


def wkv_grads(fn, args, dout, dsT) -> dict:
    """The six gradients of ``fn`` (``wkv_bhsd`` or its plain version) by
    autograd on fresh leaves of ``args``' layout, for dout and dsT."""
    leaves = [t.detach().clone().requires_grad_() for t in args]
    out, sT = fn(*leaves)
    heads, grads_in = [out], [dout]
    if dsT is not None:
        heads.append(sT)
        grads_in.append(dsT)
    return dict(zip(WKV_GRADS, torch.autograd.grad(heads, leaves, grads_in)))


def phase_wkv_backward() -> tuple[dict, list]:
    """Both WKV backward kernels vs autograd of the plain version at every
    shape, dtype and law of w, with nonzero s0 and dsT: the one the wrapper
    picks through ``wkv_bhsd``'s autograd Function, and, where that is
    ``backward_chunked``, the ``backward`` kernel on the same inputs; each
    kernel call run twice for identical bits; a planted fault at S >= 256;
    times at the training shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    timed, rows = {}, []
    for b, s, h, hd, model_layout in WKV_BWD_SHAPES:
        for dtype in ("f32", "bf16"):
            for w_law in ("uniform", "model"):
                args = wkv_inputs(b, s, h, hd, dtype, w_law, gen, model_layout)
                dout = torch.randn((b, s, h, hd) if model_layout else (b, h, s, hd),
                                   generator=gen, device="cuda").to(args[0].dtype)
                if model_layout:
                    dout = dout.transpose(1, 2)
                dsT = torch.randn(args[5].shape, generator=gen, device="cuda")
                before = dict(wkv.wkv_bhsd.variant_launches)
                got = wkv_grads(wkv.wkv_bhsd, args, dout, dsT)
                served = sorted(n for n, c in wkv.wkv_bhsd.variant_launches.items()
                                if c != before[n])
                ref = wkv_grads(wkv.wkv_bhsd_plain, args, dout, dsT)
                torch.cuda.synchronize()
                fwd = wkv.kernel_variant(args[0].dtype, args[3].dtype, hd, s)
                bwd = wkv.backward_variant(args[0].dtype, args[3].dtype, hd, s)
                row = dict(shape=[b, s, h, hd], dtype=dtype, w_law=w_law,
                           layout="model [B,S,H,hd]" if model_layout else "[B,H,S,hd]",
                           forward_kernel=fwd, backward_kernel=bwd, launched=served,
                           **wkv_bwd_errors(got, ref))
                check(served == sorted([bwd, fwd]),
                      f"launch counts show {served} serving {row}")
                again = wkv_grads(wkv.wkv_bhsd, args, dout, dsT)
                row["two_calls_bit_equal"] = all(torch.equal(again[g], got[g])
                                                 for g in WKV_GRADS)
                del again
                if bwd == "backward_chunked":      # the other kernel, same inputs
                    def old_call():
                        return dict(zip(WKV_GRADS, wkv.launch_backward(
                            "backward", *args, dout, dsT)))
                    old = old_call()
                    row["other_kernel"] = "backward"
                    row.update({f"other_{key}": val
                                for key, val in wkv_bwd_errors(old, ref).items()})
                    row["other_two_calls_bit_equal"] = all(
                        torch.equal(x, old[g]) for g, x in old_call().items())
                    del old
                if s >= 256:
                    bad_dout = dout.clone()
                    bad_dout[:, :, 3 * s // 4] = 0
                    bad = wkv_grads(wkv.wkv_bhsd_plain, args, bad_dout, dsT)
                    row["fault_limit_ratio"] = max(wkv_bwd_ratio(g, bad[g], ref[g])
                                                   for g in WKV_GRADS)
                    row["fault_rejected"] = row["fault_limit_ratio"] > 1
                    del bad, bad_dout
                if (b, s, h, hd) == WKV_TRAIN and dtype == "bf16" and w_law == "model":
                    row.update(wkv_bwd_times(args, dout))
                    timed[dtype] = row
                emit("wkv_backward", **row)
                rows.append(row)
                check(row["ok"] and row.get("other_ok", True),
                      f"a WKV backward disagrees with autograd of the plain version: {row}")
                check(row.get("fault_rejected", True),
                      f"the limit lets a dropped dout step through: {row}")
                check(row["two_calls_bit_equal"] and row.get("other_two_calls_bit_equal", True),
                      f"two identical WKV backward calls differ: {row}")
                del args, got, ref, dout, dsT
    return timed, rows


def wkv_bwd_errors(got: dict, ref: dict) -> dict:
    """Each gradient's largest error and limit ratio (:func:`wkv_bwd_ratio`)."""
    ratios = {g: wkv_bwd_ratio(g, got[g], ref[g]) for g in WKV_GRADS}
    errs = {g: float((got[g].float() - ref[g].float()).abs().max()) for g in WKV_GRADS}
    return dict(max_abs_err_by_grad=errs, max_abs_err=max(errs.values()),
                limit_ratio_by_grad=ratios, limit_ratio=max(ratios.values()),
                ok=max(ratios.values()) <= 1)


def wkv_bwd_times(args, dout) -> dict:
    """Both backward kernels alone (no dsT, as the model calls them) on the
    same inputs, in turns (old, new, new, old; each the mean of its
    launches), the chunk-parallel one's two kernels from the profiler, the
    forward kernel that serves the same call, the backward of autograd of
    the plain version (a yardstick: it repeats the kernel's function), and
    the bound from this shape's work."""
    r, k, v, w, u, s0 = args
    b, h, s, hd = r.shape
    uf = u.float()
    new = lambda: wkv.wkv_bhsd_bwd(r, k, v, w, u, s0, dout)             # noqa: E731
    old = lambda: wkv.launch_backward("backward", r, k, v, w, u, s0, dout)  # noqa: E731
    turns = [("backward", time_ms(old, 5)), ("backward_chunked", time_ms(new, 20)),
             ("backward_chunked", time_ms(new, 20)), ("backward", time_ms(old, 5))]
    by_kernel = {n: [t for m, t in turns if m == n] for n in ("backward", "backward_chunked")}
    row = dict(kernel=wkv.backward_variant(r.dtype, w.dtype, hd, s),
               kernel_ms=statistics.mean(by_kernel["backward_chunked"]),
               other_kernel_ms=statistics.mean(by_kernel["backward"]), turns_ms=turns,
               **kernel_split_ms(new, 10, ("wkv_bwd_chain_kernel", "wkv_bwd_chunk_kernel")),
               forward_kernel_ms=time_ms(
                   lambda: wkv.launch(wkv.kernel_variant(r.dtype, w.dtype, hd, s),
                                      r, k, v, w, uf, s0), 10))
    row["old_over_new"] = row["other_kernel_ms"] / row["kernel_ms"]
    leaves = [t.detach().clone().requires_grad_() for t in args]
    out, _ = wkv.wkv_bhsd_plain(*leaves)
    row["plain_ms"] = time_ms(lambda: torch.autograd.grad(out, leaves, dout,
                                                          retain_graph=True), 1)
    del out, leaves
    row["library_ms"] = None                 # no PyTorch call computes it
    row["bound_ms"], row["bound_by"], ops, nbytes = wkv_bwd_bound(
        b, h, s, hd, r.element_size(), w.element_size())
    row.update(gflop=ops / 1e9, mbytes=nbytes / 1e6,
               bytes_bound_ms=nbytes / PEAK_BYTES * 1e3,
               achieved_tflops=ops / row["kernel_ms"] / 1e9,
               bound_share=row["bound_ms"] / row["kernel_ms"],
               other_bound_share=row["bound_ms"] / row["other_kernel_ms"],
               # what the chunk-parallel kernel moves beyond the function's
               # bytes: the state and gradient before and after every chunk,
               # written once and read once
               checkpoint_mbytes=2 * b * h * -(-s // wkv.BWD_CHUNK) * hd * hd * 4 / 1e6)
    return row


def wkv_bwd_row(timed_row: dict, checks: list, variant: str, launches: int, path: str) -> dict:
    """The kernels-line entry of one WKV backward kernel: errors over every
    phase-8b row it computed (launched by the wrapper or beside the other
    kernel), times at the training shape (bf16, where the wrapper picks
    ``backward_chunked``; ``backward`` runs the same inputs)."""
    errs = [(r["dtype"], r["max_abs_err"], r["limit_ratio"], r["two_calls_bit_equal"])
            for r in checks if r["backward_kernel"] == variant]
    errs += [(r["dtype"], r["other_max_abs_err"], r["other_limit_ratio"],
              r["other_two_calls_bit_equal"]) for r in checks
             if r.get("other_kernel") == variant]
    mine = [r for r in checks if variant in (r["backward_kernel"], r.get("other_kernel"))]
    chunked = variant == "backward_chunked"
    row = {
        "name": f"wkv_bhsd_bwd[{variant}]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv_wkv.cu",
        "replaces": "src/repro/kernels/rwkv_wkv.py:61",
        "replaces_note": ("the gradient of that kernel's function; the TPU kernel is forward "
                          "only and JAX differentiates its jnp model path "
                          "(src/repro/models/rwkv.py:76 wkv_chunked)"),
        "launches": launches,
        "launches_counted_on": path,
        "serves": ("every WKV call under grad whose forward is the chunked kernel: bf16 r/k/v "
                   f"at hd 64, S >= {wkv.CHUNKED_MIN_SEQ}" if chunked else
                   "the other WKV calls under grad: f32 r/k/v, hd 8-32, bf16 at S < "
                   f"{wkv.CHUNKED_MIN_SEQ}"),
        "max_abs_err": max(e[1] for e in errs),
        "max_abs_err_by_dtype": {d: max(e[1] for e in errs if e[0] == d)
                                 for d in ("f32", "bf16") if any(e[0] == d for e in errs)},
        "tol": {"rel_of_max": WKV_BWD_REL, "rtol_bf16": 2.0 ** -7},
        "limit_ratio": max(e[2] for e in errs),
        "fault_limit_ratio_min": min(r["fault_limit_ratio"] for r in mine
                                     if "fault_limit_ratio" in r),
        "two_calls_bit_equal": all(e[3] for e in errs),
        "checked_shapes": sorted({tuple(r["shape"]) for r in mine}),
        "ms": timed_row["kernel_ms" if chunked else "other_kernel_ms"],
        "plain_ms": timed_row["plain_ms"],
        "bound_ms": timed_row["bound_ms"],
        "bound_by": timed_row["bound_by"],
        "library_ms": None,
        "bytes_bound_ms": timed_row["bytes_bound_ms"],
        "bound_share": timed_row["bound_share" if chunked else "other_bound_share"],
        "old_over_new": timed_row["old_over_new"],
        "turns_ms": timed_row["turns_ms"],
        "forward_kernel_ms": timed_row["forward_kernel_ms"],
        "shape": timed_row["shape"],
        "dtype": "bf16 r/k/v/dout and dr/dk/dv, f32 w and dw",
    }
    if chunked:
        row.update(chain_kernel_ms=timed_row["wkv_bwd_chain_kernel_ms"],
                   chunk_kernel_ms=timed_row["wkv_bwd_chunk_kernel_ms"],
                   checkpoint_mbytes=timed_row["checkpoint_mbytes"])
    return row


def phase_kv_int8(model, frontend=None) -> dict:
    """Decode token by token over ``KV_INT8`` steps (reading the memory of
    ``frontend`` where the arch has one), with the int8 cache and with the
    bf16 cache from the same tokens: the int8 logits within 5 % of the bf16
    ones (``tests/test_archs_smoke.py``'s bar), the cache int8.
    ``kv_dtype`` is read by ``init_cache`` alone, so both runs use the one
    model's weights."""
    cfg = model.cfg
    b, n = KV_INT8
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    tokens = torch.randint(0, cfg.vocab_size, (b, n), generator=gen, device="cuda")
    with torch.no_grad():
        memory = model.encode_memory(frontend)
    runs = {}
    reset_launches()
    try:
        for kv_dtype in ("bf16", "int8"):
            model.kv_dtype = kv_dtype
            cache = model.init_cache(b, n)
            logits, secs = [], []
            with torch.no_grad():
                for t in range(n):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    lg, cache = model.decode_step(cache, tokens[:, t:t + 1], t, memory=memory)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                    logits.append(lg[:, 0])
            runs[kv_dtype] = dict(logits=torch.stack(logits, dim=1), cache=cache, secs=secs)
    finally:
        model.kv_dtype = "bf16"
    ref, q = runs["bf16"]["logits"], runs["int8"]["logits"]
    worst = float((q - ref).abs().max())
    scale = float(ref.abs().max())
    cache = runs["int8"]["cache"]
    nbytes = {kv: sum(t.numel() * t.element_size() for c in runs[kv]["cache"]
                      for t in c.values()) for kv in runs}
    row = dict(arch=cfg.name, layers=cfg.n_layers, batch=b, steps=n, param_dtype="bf16",
               worst_logit_gap=worst, max_abs_bf16_logit=scale, rel_gap=worst / scale,
               limit=0.05, logits_finite=bool(torch.isfinite(q).all()),
               cache_dtypes={name: str(t.dtype) for name, t in cache[0].items()},
               cache_bytes=nbytes, cache_bytes_ratio=nbytes["bf16"] / nbytes["int8"],
               decode_step_ms_median={kv: statistics.median(r["secs"][2:]) * 1e3
                                      for kv, r in runs.items()},
               flash_launches=fa.flash_attention_bhsd.launches)
    emit("kv_int8", **row)
    check(row["logits_finite"] and worst / scale < 0.05,
          f"int8 KV decode is off the bf16 cache's logits by more than 5 %: {row}")
    check(cache[0]["k"].dtype == cache[0]["v"].dtype == torch.int8, "the cache is not int8")
    del runs, cache, memory
    return row


def chunked_route(r, k, v, w, u, s0=None):
    """``ops.rwkv_wkv`` by the model's chunked torch form, on any device:
    the CPU route of the model, differentiated by autograd."""
    return wkv_chunked(r, k, v, w, u, s0, chunk=16)


def phase_rwkv_gradients(cfg_full) -> int:
    """``LM.loss`` and every gradient leaf of rwkv6_1b6 through the kernels
    (sequential forward, backward kernel) vs the same with the WKV routed
    to the chunked torch form: full width, 4 layers, f32, TF32 off.
    Returns the backward kernel's launches in the kernel route."""
    cfg = replace(cfg_full, n_layers=4)
    model = LM(cfg, param_dtype=torch.float32, seed=SEED, device="cuda")
    for p in model.parameters():
        p.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    b, s = GRAD_CHECK
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    reset_launches()
    loss_k, grads_k = model_grads(model, batch)
    launches = dict(wkv.wkv_bhsd.variant_launches)
    original = rwkv_mod.ops
    rwkv_mod.ops = types.SimpleNamespace(rwkv_wkv=chunked_route)
    try:
        reset_launches()
        loss_s, grads_s = model_grads(model, batch)
        scan_launches = wkv.wkv_bhsd.launches
    finally:
        rwkv_mod.ops = original
    errs = {name: float((g - grads_s[name]).abs().max() / grads_s[name].abs().max().clamp(
        min=1e-30)) for name, g in grads_k.items()}
    worst = max(errs, key=errs.get)
    row = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, batch=b, seq=s,
               dtype="f32", loss_kernels=loss_k, loss_chunked=loss_s,
               loss_abs_err=abs(loss_k - loss_s), leaves=len(errs), worst_leaf=worst,
               worst_rel_err=errs[worst], median_rel_err=statistics.median(errs.values()),
               limit=GRAD_TOL, kernel_launches=launches,
               chunked_route_wkv_launches=scan_launches)
    emit("rwkv_gradients", **row)
    check(launches == wkv_counts(sequential=cfg.n_layers, backward=cfg.n_layers),
          f"kernel-route WKV launches {launches}")
    check(scan_launches == 0, "the chunked route launched a WKV kernel")
    check(all(e <= GRAD_TOL for e in errs.values()) and abs(loss_k - loss_s) < 1e-4,
          f"RWKV gradients through the kernels differ from the chunked route: {row}")
    del model, grads_k, grads_s
    return launches["backward"]


def phase_prefill(model, frontend=None, masks=None) -> dict:
    """``prefill`` on ``PREFILL`` tokens (with ``frontend`` embeddings where
    the arch has them), twice; each call must launch the tensor-core kernel
    once per self-attention layer (decoder and encoder), by mask as
    ``masks`` says (default: every launch causal).  The kernel alone at the
    call's shape, for each mask, splits the time."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, s = PREFILL
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    masks = masks or {"wgmma/causal": attention_layers(model)}
    torch.cuda.reset_peak_memory_stats()
    launches, by_mask, secs, gc_secs = [], [], [], []
    for _ in range(2):          # the first call also warms cuBLAS up
        fa.reset_launch_counts()
        logits, sec, gc_sec = timed_call(lambda: serve.prefill(model, tokens, frontend))
        secs.append(sec)
        gc_secs.append(gc_sec)
        launches.append(dict(fa.flash_attention_bhsd.variant_launches))
        by_mask.append(dict(fa.flash_attention_bhsd.mask_launches))
        check(tuple(logits.shape) == (b, cfg.vocab_size), f"logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
        check(launches[-1] == flash_counts(wgmma=sum(masks.values())) and by_mask[-1] == masks,
              f"kernel launches in one prefill {launches[-1]} {by_mask[-1]}, want {masks}")
    peak = torch.cuda.max_memory_allocated()
    q = torch.randn((b * cfg.n_heads, s, cfg.hd), generator=gen, device="cuda").bfloat16()
    kv = torch.randn((b * cfg.n_kv_heads, s, cfg.hd), generator=gen, device="cuda").bfloat16()
    attn_ms = {mask: time_ms(lambda: fa.flash_attention_bhsd(
        q, kv, kv, causal=mask.endswith("causal")), 5) for mask in masks}
    attention_s = sum(attn_ms[mask] * n for mask, n in masks.items()) / 1e3
    row = dict(arch=cfg.name, layers=cfg.n_layers, encoder_layers=cfg.n_encoder_layers,
               batch=b, seq=s, frontend_tokens=0 if frontend is None else frontend.shape[1],
               dtype="bf16", launches_per_call=launches, mask_launches_per_call=by_mask,
               seconds=secs, gc_seconds_in_calls=gc_secs, tokens_per_s=b * s / secs[-1],
               peak_memory_gb=peak / 1e9, attention_kernel_ms_per_layer=attn_ms,
               attention_share=attention_s / secs[-1])
    emit("prefill", **row)
    return row


def attention_layers(model) -> int:
    """Self-attention layers of ``model``'s decoder and encoder: the flash
    launches of one forward."""
    decoder = model.n_rep * sum(spec.kind == "attn" for spec in model.specs)
    return decoder + model.cfg.n_encoder_layers


def phase_consistency(cfg_full, capacity_factor: float = 1.25, **cut) -> int:
    """Prefill logits vs decode logits, full width, f32, 4 layers unless
    ``cut`` says otherwise; archs with a frontend get seeded embeddings
    (decode reads ``encode_memory``'s memory).  Returns the CUDA-core
    kernel's launches in the prefill, the one path that runs it.  A MoE
    config runs at ``capacity_factor`` 16, where the prefill drops no token
    (decode's groups of one token drop none either)."""
    cfg = replace(cfg_full, **{"n_layers": 4, **cut})
    b, s = CONSISTENCY              # S not a multiple of the kernel's 64-row tile
    model = LM(cfg, param_dtype=torch.float32, capacity_factor=capacity_factor,
               seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    frontend = (torch.randn((b, cfg.frontend_tokens, cfg.frontend_dim), generator=gen,
                            device="cuda") if cfg.frontend_tokens else None)
    fa.reset_launch_counts()
    last = serve.prefill(model, tokens, frontend)
    launches = dict(fa.flash_attention_bhsd.variant_launches)
    n_attn = attention_layers(model)
    check(launches == flash_counts(cuda_core=n_attn),
          f"f32 prefill kernel launches {launches}, want {n_attn} of the CUDA-core kernel")
    with torch.no_grad():
        full = model(tokens, frontend)
        memory = model.encode_memory(frontend)
        cache = model.init_cache(b, s, dtype=torch.float32)
        worst = 0.0
        for t in range(s):
            logits, cache = model.decode_step(cache, tokens[:, t:t + 1], t, memory=memory)
            worst = max(worst, float((logits[:, 0] - full[:, t]).abs().max()))
    err_last = float((logits[:, 0] - last).abs().max())
    emit("consistency", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, batch=b,
         seq=s, kinds=[spec.kind for spec in model.specs], dtype="f32",
         frontend_tokens=cfg.frontend_tokens if frontend is not None else 0,
         capacity_factor=capacity_factor, max_abs_err_last=err_last,
         max_abs_err_all_positions=worst, tol=2e-3, kernel_launches=launches)
    check(err_last < 2e-3 and worst < 2e-3,
          f"prefill vs decode logits differ: last {err_last}, all {worst}")
    del model, cache, full, memory
    return launches["cuda_core"]


def phase_serve(model, n_requests: int = 8, prompt=(32, 129), new_tokens: int = 32) -> dict:
    """``ServeLoop(slots=4)`` answering ``n_requests`` requests with prompts
    of ``prompt`` (low, high) tokens, ``new_tokens`` each."""
    cfg = model.cfg
    rng = np.random.default_rng(SEED)
    requests = [Request(i, rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
                        max_new_tokens=new_tokens)
                for i, n in enumerate(rng.integers(*prompt, size=n_requests))]
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
    check(all(len(r.out) == new_tokens for r in done),
          f"a request ended short of {new_tokens} tokens")
    prompt_tokens = sum(len(r.prompt) for r in requests)
    generated = new_tokens * len(done)
    row = dict(arch=cfg.name, requests=len(done), slots=4, max_len=256,
               prompt_tokens=prompt_tokens, new_tokens=generated, seconds=secs,
               decode_tokens_per_s=generated / secs,
               processed_tokens_per_s=(prompt_tokens + generated) / secs,
               kernel_launches=dict(fa.flash_attention_bhsd.variant_launches))
    emit("serve", **row)
    return row


def profile_window(fn, reps: int, top: int = 6, named: str = "", ops=()) -> dict:
    """Wall time per call unprofiled, then device time per call and the
    top kernels from ``torch.profiler`` over the same calls (and every
    kernel whose name contains ``named``, and the device time of the
    kernels launched under each operator in ``ops``, such as
    ``"aten::bmm"``).  The device-busy share compares the two: the
    profiler's own host cost does not enter the wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    _, secs, gc_secs = timed_call(lambda: [fn() for _ in range(reps)])
    wall_ms = secs * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_name, per_op = {}, dict.fromkeys(ops, 0.0)
    for e in prof.key_averages():
        if e.key in per_op:
            # the host entry of an operator or a named range: the device
            # time of the kernels launched under it; a named range's
            # device-side span (a user annotation) is no kernel
            if e.device_type == torch.autograd.DeviceType.CPU:
                us = getattr(e, "device_time_total", None)
                per_op[e.key] += (e.cuda_time_total if us is None else us) / 1e3 / reps
            continue
        # device work only: a CPU op's own entry repeats the time of the
        # kernels it launched, and so does a named range's device span
        if not is_device_work(e):
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
    if ops:
        row["op_device_ms"] = per_op
        row["op_device_share"] = {op: ms / device_ms for op, ms in per_op.items()}
    return row


def phase_profile(model, top: int = 6, ops=()) -> dict:
    """Where the time goes in one prefill call and one 4-slot decode step
    (with the device time under each operator of ``ops``); returns the
    prefill's window."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, PREFILL, generator=gen, device="cuda")
    prefill = profile_window(lambda: serve.prefill(model, tokens), 1, top=top, ops=ops)
    emit("profile", arch=cfg.name, step="prefill", batch=PREFILL[0], seq=PREFILL[1], **prefill)
    cache = model.init_cache(4, 256, dtype=torch.float32)
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen, device="cuda")
    pos = torch.tensor([200, 150, 100, 50], device="cuda")
    with torch.no_grad():
        step = lambda: model.decode_step(cache, tok, pos)  # noqa: E731
        emit("profile", arch=cfg.name, step="decode", slots=4, cache_len=256,
             **profile_window(step, 10, top=top, ops=ops))
    return prefill


def flash_row(main_row: dict, checks: list, variant: str, launches: int, path: str,
              at: str = "") -> dict:
    """The kernels-line entry of one flash kernel: errors over the phase-2
    rows it served, times at the main shape in the dtype it serves there;
    ``at`` names the arch of another layer shape (a second entry)."""
    mine = [r for r in checks if r["variant"] == variant]
    return {
        "name": f"flash_attention_bhsd[{variant}]" + (f"@{at}" if at else ""),
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


def wkv_counts(**launches) -> dict:
    """A full ``variant_launches`` dict of the WKV kernels: the given
    counts, 0 for every other kernel."""
    return {**dict.fromkeys(wkv.VARIANTS, 0), **launches}


def flash_counts(**launches) -> dict:
    """A full ``variant_launches`` dict of the flash kernels: the given
    counts, 0 for every other variant."""
    return {**dict.fromkeys(fa.VARIANTS, 0), **launches}


def phase_main_path(arch: str = "llama3_8b", masks=None) -> int:
    """``serve.main --full-size``: prefill then greedy decode on the card;
    one tensor-core flash launch per layer (the prefill's), or by mask as
    ``masks`` says."""
    argv = ["--arch", arch, "--full-size", "--batch", str(MAIN_PATH[0]),
            "--prompt-len", str(MAIN_PATH[1]), "--tokens", "16"]
    reset_launches()
    t0 = time.perf_counter()
    rc = serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(fa.flash_attention_bhsd.variant_launches)
    by_mask = dict(fa.flash_attention_bhsd.mask_launches)
    emit("serve_main", argv=argv, rc=rc, seconds=time.perf_counter() - t0,
         kernel_launches=launches, mask_launches=by_mask, wkv_launches=wkv.wkv_bhsd.launches)
    check(rc == 0, f"serve.main exited {rc}")
    # one launch per layer, one prefill
    masks = masks or {"wgmma/causal": get_config(arch).n_layers}
    check(launches == flash_counts(wgmma=sum(masks.values())) and by_mask == masks,
          f"kernel launches on the main path {launches} {by_mask}, want {masks}")
    check(wkv.wkv_bhsd.launches == 0, f"the {arch} path launched the WKV kernel")
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
        check(launches[-1] == wkv_counts(chunked=cfg.n_layers),
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
    check(prefill_launches == wkv_counts(sequential=cfg.n_layers),
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
    """``serve.main --arch rwkv6_1b6 --full-size``: one chunked WKV
    launch per layer for the prefill, and one sequential launch per layer
    for each of the prompt's teacher-forced decode steps and each new
    token."""
    batch, plen, new = RWKV_MAIN_PATH
    argv = ["--arch", "rwkv6_1b6", "--full-size", "--batch", str(batch),
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
    want = wkv_counts(chunked=n_layers, sequential=n_layers * (plen + new))
    check(launches == want and wkv.wkv_bhsd.launches == sum(want.values()),
          f"WKV launches on the RWKV main path {launches}, want {want}")
    check(fa.flash_attention_bhsd.launches == 0, "the RWKV path launched flash attention")
    return launches


def attention_grads(fn, q, k, v, do, causal, window: int = 0):
    """(out, (dq, dk, dv)) of ``fn`` by autograd on fresh leaves."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves, causal=causal, sliding_window=window)
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
    times at the training shapes (``TIMED_SHAPES``), keyed (arch, dtype)."""
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
                arch, timed_dtypes, _ = TIMED_SHAPES.get((b, s, h, hkv, hd), (None, (), ()))
                if name in timed_dtypes and causal:
                    row.update(backward_times(q, k, v, do, name))
                    timed[(arch, name)] = row
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
                        dv.data_ptr(), bh, k.shape[0], s, hd, 1, 1, 0, hd ** -0.5, stream)
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
    kernel_bwd = lambda: fa.flash_attention_bwd(q, k, v, lse, do, causal=True)  # noqa: E731
    row = dict(kernel_windows_ms=windows_ms(kernel_bwd))
    row["kernel_ms"] = row["kernel_windows_ms"]["median"]
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
    # SDPA's backward timed as the kernel is: the median of 20 windows of
    # 10 back-to-back calls, with the spread; then each one's device time
    sdpa_bwd = lambda: torch.autograd.grad(out, leaves, do4, retain_graph=True)  # noqa: E731
    row["library_windows_ms"] = windows_ms(sdpa_bwd)
    row["library_ms"] = row["library_windows_ms"]["median"]
    row["library_device_ms"] = call_device_ms(sdpa_bwd)
    row["kernel_device_ms"] = call_device_ms(kernel_bwd)
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


def window_backward_times(q, k, v, do, window: int, name: str) -> dict:
    """The windowed backward (causal) against the same call without a
    window (CUDA events over the backward kernel alone), autograd of the
    plain version and SDPA's backward with a boolean mask of the window
    (the yardstick only); the bounds of both from ``cost.py``."""
    bh, s, hd = q.shape
    _, lse = fa._forward(q, k, v, True, with_lse=True, sliding_window=window)
    _, lse0 = fa._forward(q, k, v, True, with_lse=True)
    row = dict(kernel_ms=time_ms(lambda: fa.flash_attention_bwd(
        q, k, v, lse, do, causal=True, sliding_window=window), 10),
        kernel_no_window_ms=time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, lse0, do, causal=True), 10))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_bhsd_plain(*leaves, causal=True, sliding_window=window)
    row["plain_ms"] = time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 2)
    del out
    pos = torch.arange(s, device="cuda")
    keep = (pos[None, :] > pos[:, None] - window) & (pos[None, :] <= pos[:, None])
    q4, k4, v4 = (t.view(1, -1, s, hd) for t in leaves)
    out = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep,
                                                           enable_gqa=True)
    row["library_ms"] = time_ms(lambda: torch.autograd.grad(
        out, leaves, do.view(1, -1, s, hd), retain_graph=True), 5)
    del out
    row["bound_ms"], row["bound_by"] = bwd_bound_ms(bh, k.shape[0], s, hd, True, name,
                                                    q.element_size(), window)
    row["bound_no_window_ms"], _ = bwd_bound_ms(bh, k.shape[0], s, hd, True, name,
                                                q.element_size())
    row["kernel_tflops"] = bwd_flops(bh, s, hd, True, window) / row["kernel_ms"] / 1e9
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    row["no_window_over_window"] = row["kernel_no_window_ms"] / row["kernel_ms"]
    row["kernel_over_library"] = row["kernel_ms"] / row["library_ms"]
    return row


def phase_backward_window() -> tuple[dict, list]:
    """Phase 8's windowed calls: both backward kernels under a sliding window
    (``WINDOW_CASES``, f32 and bf16, through ``flash_attention_bhsd``'s
    autograd Function) vs autograd of the plain version with the same
    window, at phase 8's limits; a planted fault (the last query's dO row
    zeroed in the plain run: a V row would not do, since at W = 1 every
    p is 1 and dS = 0, so no gradient reads V); a window of S and 2S
    bit-equal to none;
    the tensor-core backward run twice for identical bits.  Times at
    ``WINDOW_SHAPE``, keyed by dtype."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    timed, rows = {}, []
    for b, s, h, hkv, hd, window, masks in WINDOW_CASES:
        for name, dt in dtypes.items():
            q, k, v, do = (torch.randn((b * n, s, hd), generator=gen, device="cuda").to(dt)
                           for n in (h, hkv, hkv, h))
            for causal in masks:
                fa.reset_launch_counts()
                _, grads = attention_grads(fa.flash_attention_bhsd, q, k, v, do, causal, window)
                by_mask = dict(fa.flash_attention_bhsd.mask_launches)
                _, ref = attention_grads(fa.flash_attention_bhsd_plain, q, k, v, do, causal,
                                         window)
                torch.cuda.synchronize()
                atol, rtol = TOL[name]
                ratios = {g: limit_ratio(out.float(), r.float(), atol, rtol)
                          for g, out, r in zip(("dq", "dk", "dv"), grads, ref)}
                fwd, bwd = fa.kernel_variant(dt, hd), fa.backward_variant(dt, hd)
                mask = fa.mask_name(causal, window, s)
                row = dict(shape=[b, s, h, hkv, hd], window=window, dtype=name, causal=causal,
                           forward_kernel=fwd, backward_kernel=bwd, mask_launches=by_mask,
                           max_abs_err=max(float((g.float() - r.float()).abs().max())
                                           for g, r in zip(grads, ref)),
                           limit_ratio_by_grad=ratios, limit_ratio=max(ratios.values()),
                           atol=atol, rtol=rtol)
                row["ok"] = row["limit_ratio"] <= 1
                bad_do = do.clone()
                bad_do[:, s - 1] = 0
                bad = attention_grads(fa.flash_attention_bhsd_plain, q, k, v, bad_do, causal,
                                      window)[1]
                del bad_do
                row["fault_limit_ratio"] = max(limit_ratio(x.float(), r.float(), atol, rtol)
                                               for x, r in zip(bad, ref))
                row["fault_rejected"] = row["fault_limit_ratio"] > 1
                del bad, ref
                if bwd == "backward_wgmma":
                    again = attention_grads(fa.flash_attention_bhsd, q, k, v, do, causal,
                                            window)[1]
                    row["two_calls_bit_equal"] = all(torch.equal(a, g)
                                                     for a, g in zip(again, grads))
                    del again
                def out_and_grads(w):
                    out, g = attention_grads(fa.flash_attention_bhsd, q, k, v, do, causal, w)
                    return (out, *g)
                none = out_and_grads(0)
                row["window_ge_s_bit_equal"] = all(
                    all(torch.equal(a, x) for a, x in zip(none, out_and_grads(w)))
                    for w in (s, 2 * s))
                del none
                if (b, s, h, hkv, hd) == WINDOW_SHAPE and causal:
                    row.update(window_backward_times(q, k, v, do, window, name))
                    timed[name] = row
                emit("backward_window", **row)
                rows.append(row)
                check(by_mask == {f"{fwd}/{mask}": 1, f"{bwd}/{mask}": 1},
                      f"a windowed call under grad counted {by_mask}")
                check(row["ok"], f"the windowed backward disagrees with autograd of the plain "
                                 f"version: {row}")
                check(row["fault_rejected"], f"the limit lets a zeroed V row through: {row}")
                check(row.get("two_calls_bit_equal", True),
                      f"two identical windowed backward calls differ: {row}")
                check(row["window_ge_s_bit_equal"],
                      f"a window of S or 2S does not give the bits of none: {row}")
                del grads
            del q, k, v, do
    return timed, rows


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


# phase 8c: olmoe_1b_7b at 8 of 16 layers, the benchmark's training cell
ADAMW_LAYERS = 8
ADAMW_REPS = {"kernel": 5, "plain": 2}
ADAMW_NORM_RTOL = 1e-5
# the kernels' launch counts over each training phase, by phase
ADAMW_LAUNCHES: dict = {}


def counting_adamw(name: str, phase, *args, **kwargs):
    """Run a training phase between a reset and a read of the AdamW
    kernels' launch counts, kept under ``name``: its steps on the card
    launch a sum of squares and at least one update each."""
    fused_adamw.reset_launch_counts()
    out = phase(*args, **kwargs)
    got = dict(fused_adamw.update.launches)
    ADAMW_LAUNCHES[name] = got
    check(got["sumsq"] > 0 and got["update"] >= got["sumsq"],
          f"{name}: AdamW kernel launches {got}, want a sum of squares and updates each step")
    return out


def adamw_bytes(n: int, param_size: int, moment_size: int, clipped: bool) -> int:
    """HBM bytes of one leaf's fused update: the grad read (and written
    back clipped unless the scale is 1), m and v read and written, the
    f32 master read and written, the param written."""
    return n * (param_size * (3 if clipped else 2) + 4 * moment_size + 8)


def phase_adamw() -> dict:
    """Phase 8c: both AdamW kernels at olmoe_1b_7b's training leaves (8
    layers), against the eager path, with times and bounds."""
    cfg = replace(get_config("olmoe_1b_7b"), n_layers=ADAMW_LAYERS)
    shapes = {name: tuple(t.shape) for name, t in flatten_tree(param_tree(
        LM(cfg, param_dtype=torch.bfloat16, device="meta"))).items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    draw = lambda shape, scale=1.0, dtype=torch.float32: (  # noqa: E731
        scale * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    # the norm pass over every grad leaf at once, as a step runs it
    grads = [draw(shape, dtype=torch.bfloat16) for shape in shapes.values()]
    sums = fused_adamw.grad_sumsq(grads)
    again = fused_adamw.grad_sumsq(grads)
    norm, want = torch.sqrt(sums[-1]), global_norm(grads)
    grad_bytes = sum(g.numel() * g.element_size() for g in grads)
    norm_row = dict(rel_err=float(abs(norm.double() - want.double()) / want.double()),
                    tol_rel=ADAMW_NORM_RTOL, repeat_bits_equal=bool(torch.equal(
                        sums.view(torch.int32), again.view(torch.int32))),
                    ms=time_ms(lambda: fused_adamw.grad_sumsq(grads), ADAMW_REPS["kernel"]),
                    plain_ms=time_ms(lambda: global_norm(grads), ADAMW_REPS["plain"]),
                    bound_ms=grad_bytes / PEAK_BYTES * 1e3, grad_gb=grad_bytes / 1e9)
    del grads, sums, again
    free()
    # each leaf's update beside the eager one, given the norm's clip scale
    # and step 3's bias corrections at the warmup-cosine scale 0.7
    opt = AdamWConfig()
    scale = _clip_scale(norm, opt.grad_clip)
    bc1, bc2, lr = _bias_and_lr(opt, torch.tensor(3, dtype=torch.int32, device="cuda"), 0.7)
    consts = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps, weight_decay=opt.weight_decay)
    leaves, unequal = {}, []
    for name, shape in shapes.items():
        master = draw(shape, 0.02)
        mine = (master.bfloat16(), draw(shape, dtype=torch.bfloat16), draw(shape, 1e-3),
                draw(shape, 1e-3).square_(), master)
        plain = tuple(t.clone() for t in mine)
        fused_adamw.update(*mine, scale, bc1, bc2, lr, **consts)
        plain[1].mul_(scale.to(plain[1].dtype))
        _update_eager(opt, [plain], bc1, bc2, lr)
        torch.cuda.synchronize()
        unequal += [f"{name}.{part}" for part, a, b in zip(
            ("param", "grad", "m", "v", "master"), mine, plain)
            if not torch.equal(a.view(torch.int16 if a.element_size() == 2 else torch.int32),
                               b.view(torch.int16 if b.element_size() == 2 else torch.int32))]

        def plain_update():
            plain[1].mul_(scale.to(plain[1].dtype))
            _update_eager(opt, [plain], bc1, bc2, lr)
        n = master.numel()
        leaves[name] = dict(
            shape=list(shape), elements=n,
            ms=time_ms(lambda: fused_adamw.update(*mine, scale, bc1, bc2, lr, **consts),
                       ADAMW_REPS["kernel"]),
            plain_ms=time_ms(plain_update, ADAMW_REPS["plain"]),
            bound_ms=adamw_bytes(n, 2, 4, True) / PEAK_BYTES * 1e3)
        del master, mine, plain
        free()
    total = lambda key: sum(r[key] for r in leaves.values())  # noqa: E731
    update_row = dict(ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
                      params=total("elements"), bytes_per_param=adamw_bytes(1, 2, 4, True),
                      clip_scale=float(scale), unequal=unequal, leaves=leaves)
    row = dict(arch=cfg.name, layers=cfg.n_layers, leaves=len(shapes),
               params=update_row["params"], norm=norm_row, update=update_row)
    emit("adamw", **row)
    check(norm_row["rel_err"] <= ADAMW_NORM_RTOL and norm_row["repeat_bits_equal"],
          f"the AdamW norm pass: {norm_row}")
    check(float(scale) < 1.0, f"the clip is not engaged: scale {float(scale)}")
    check(not unequal, f"the fused AdamW update differs from the eager one in {unequal}")
    return row


def adamw_rows(row: dict) -> list:
    """The kernels-line entries of both AdamW kernels: phase 8c's checks
    and times, and their launches over each training phase."""
    where = "each training phase, its launch counts reset before it and read after it"
    common = dict(route="cuda", source="src/repro_torch/kernels/csrc/adamw.cu",
                  replaces="none: the eager AdamW of src/repro_torch/optim/adamw.py "
                           "(JAX's AdamW is jnp that XLA fuses)",
                  launches_counted_on=where, bound_by="hbm",
                  shape=f"{row['arch']} at {row['layers']} layers: {row['leaves']} bf16 leaves, "
                        f"{row['params']} parameters", dtype="bf16 params and grads, f32 state")
    norm, upd = row["norm"], row["update"]
    return [
        {"name": "adamw_sumsq", **common,
         "kernels_a_call": ["sumsq_kernel", "sumsq_finish_kernel"],
         "launches": {phase: 2 * n["sumsq"] for phase, n in ADAMW_LAUNCHES.items()},
         "rel_err": norm["rel_err"], "tol_rel": norm["tol_rel"],
         "repeat_bits_equal": norm["repeat_bits_equal"], "ms": norm["ms"],
         "plain_ms": norm["plain_ms"], "bound_ms": norm["bound_ms"],
         "bound_share": norm["bound_ms"] / norm["ms"]},
        {"name": "adamw_update", **common, "kernels_a_call": ["adamw_update_kernel"],
         "launches": {phase: n["update"] for phase, n in ADAMW_LAUNCHES.items()},
         "bit_equal_to_eager": not upd["unequal"], "ms": upd["ms"],
         "plain_ms": upd["plain_ms"], "bound_ms": upd["bound_ms"],
         "bound_share": upd["bound_ms"] / upd["ms"], "bytes_per_param": upd["bytes_per_param"]}]


def phase_gradients(cfg_full, **cut) -> int:
    """``LM.loss`` and every gradient leaf through the kernels (CUDA-core
    forward, backward kernel) vs the same with self-attention routed to the
    chunked torch scan: full width, 4 layers unless ``cut`` says otherwise,
    f32, TF32 off; archs with a frontend get seeded embeddings of
    ``GRAD_CHECK``'s length.  Returns the backward kernel's launches in the
    kernel route."""
    cfg = replace(cfg_full, **{"n_layers": 4, **cut})
    model = LM(cfg, param_dtype=torch.float32, seed=SEED, device="cuda")
    for p in model.parameters():
        p.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    b, s = GRAD_CHECK
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend_tokens:
        batch["frontend"] = torch.randn((b, s, cfg.frontend_dim), generator=gen, device="cuda")
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
    row = dict(arch=cfg.name, layers=cfg.n_layers, encoder_layers=cfg.n_encoder_layers,
               d_model=cfg.d_model, batch=b, seq=s,
               dtype="f32", loss_kernels=loss_k, loss_scan=loss_s, loss_abs_err=abs(loss_k - loss_s),
               leaves=len(errs), worst_leaf=worst, worst_rel_err=errs[worst],
               median_rel_err=statistics.median(errs.values()), limit=GRAD_TOL,
               kernel_launches=launches, scan_route_flash_launches=scan_launches)
    emit("gradients", **row)
    n_attn = attention_layers(model)
    check(launches == flash_counts(cuda_core=n_attn, backward=n_attn),
          f"kernel-route launches {launches}")
    check(scan_launches == 0, "the scan route launched a flash kernel")
    check(all(e <= GRAD_TOL for e in errs.values()) and abs(loss_k - loss_s) < 1e-4,
          f"gradients through the kernels differ from the scan route: {row}")
    del model, grads_k, grads_s
    return launches["backward"]


def train_step_timed(trainer, params, opt_state, batch):
    """One ``Trainer.step_fn`` step after a full collection: (params,
    opt_state, loss, wall seconds, split ms by phase from CUDA events, the
    peak memory up to the end of the backward pass in bytes)."""
    events, peak = {}, {}

    def mark(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()
        if name == "adamw":             # the allocator's peak so far is host state
            peak["fwd_bwd"] = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt_state, metrics = trainer.step_fn(params, opt_state, batch, mark=mark)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    split = {name: events[name].elapsed_time(events[nxt]) for name, nxt in
             (("forward", "backward"), ("backward", "adamw"), ("adamw", "end"))}
    return params, opt_state, loss, secs, split, peak["fwd_bwd"]


def train_cell(cfg, read_launches, profile_named: str, remats=("full",),
               attn_chunk: int = 64) -> dict:
    """Full-width ``cfg`` with bf16 params and f32 AdamW state:
    ``Trainer.step_fn`` on one repeated B x S = ``TRAIN_SHAPE`` batch,
    timed at the trainer's default AdamW; two steps under each policy of
    ``remats``; then fresh weights at peak lr ``TRAIN_LR``, where the loss
    must fall.  The training main path: the launch counts are reset just
    before the timed steps and read (``read_launches()``) just after.
    Peaks: the step's, and the forward and backward pass's (read as AdamW
    starts), where the activations that ``remat`` keeps show.  ``attn_chunk``
    is the Trainer's (the KV chunk of the chunked attention scan)."""
    seq, batch_size = TRAIN_SHAPE[1], TRAIN_SHAPE[0]
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(cfg, ShapeConfig("train_4k_b1", seq, batch_size, "train"),
                          TrainerConfig(steps=TRAIN_STEPS, ckpt_dir=ckpt_dir),
                          param_dtype=torch.bfloat16, attn_chunk=attn_chunk, device="cuda")
        params = trainer.params()
        opt_state = adamw_init(params)
        n_params = sum(p.numel() for p in tree_leaves(params))
        batch = trainer.batch(trainer.data.batch_at(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, secs, splits, fwd_bwd_peaks = [], [], [], []
        for _ in range(TRAIN_STEPS):
            params, opt_state, loss, sec, split, fb_peak = train_step_timed(
                trainer, params, opt_state, batch)
            losses.append(loss)
            secs.append(sec)
            splits.append(split)
            fwd_bwd_peaks.append(fb_peak)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        profile = profile_window(lambda: trainer.step_fn(params, opt_state, batch), 1, top=10,
                                 named=profile_named)
        # steps with each layer checkpointed: every layer recomputed
        # ("full"), or all but its products without a batch dim ("dots")
        remat = {}
        for policy in remats:
            trainer.model.remat = policy
            runs = []
            for _ in range(2):
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                params, opt_state, loss, sec, split, fb_peak = train_step_timed(
                    trainer, params, opt_state, batch)
                runs.append(dict(loss=loss, step_s=sec, split_ms=split,
                                 launches=read_launches(),
                                 peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                                 peak_fwd_bwd_gb=fb_peak / 1e9))
            remat[policy] = {**runs[-1], "step_s_by_step": [r["step_s"] for r in runs],
                             "train_tokens_per_s": batch_size * seq / runs[-1]["step_s"]}
        # the falling-loss check: fresh weights and state, peak lr TRAIN_LR
        del params, opt_state
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
               # step 0's: no AdamW has run before it
               peak_fwd_bwd_gb=fwd_bwd_peaks[0] / 1e9,
               launches=launches, launches_per_step={n: c / TRAIN_STEPS
                                                     for n, c in launches.items()},
               remat=remat, profile=profile)
    return row


def check_training(row: dict) -> None:
    """Finite losses, and from fresh weights a falling loss."""
    falling = row["losses_falling"]
    check(all(np.isfinite(row["losses"] + falling)), f"training losses are not finite: {row}")
    # warmup-cosine's first scale is 0: steps 0 and 1 see the same weights
    check(falling[0] == falling[1] and falling[-1] < falling[2] < falling[1],
          f"the loss does not fall on a repeated batch at lr {TRAIN_LR}: {falling}")


def phase_train(cfg_full) -> dict:
    """llama3_8b at full width, ``TRAIN_LAYERS`` layers (:func:`train_cell`):
    8 tensor-core flash forwards and backwards a step."""
    cfg = replace(cfg_full, n_layers=TRAIN_LAYERS)
    row = train_cell(cfg, lambda: dict(fa.flash_attention_bhsd.variant_launches), "flash")
    emit("train", **row)
    check_training(row)
    want = flash_counts(wgmma=cfg.n_layers * TRAIN_STEPS,
                        backward_wgmma=cfg.n_layers * TRAIN_STEPS)
    check(row["launches"] == want, f"training launches {row['launches']}, want {want}")
    check(row["remat"]["full"]["launches"] == flash_counts(wgmma=2 * cfg.n_layers,
                                                           backward_wgmma=cfg.n_layers),
          f"remat='full' step launches {row['remat']['full']['launches']}")
    return row


def phase_rwkv_train(cfg) -> dict:
    """rwkv6_1b6 at full width and full depth (:func:`train_cell`): 24
    chunked WKV forwards and 24 chunk-parallel WKV backwards a step (none
    of the ``backward`` kernel), no dout copied, no flash kernel; the WKV
    kernels' own device time in the profile."""
    row = train_cell(cfg, lambda: {**wkv.wkv_bhsd.variant_launches,
                                   "dout_copies": wkv.wkv_bhsd.dout_copies,
                                   "flash": fa.flash_attention_bhsd.launches}, "wkv_")
    emit("rwkv_train", **row)
    check_training(row)
    n = cfg.n_layers
    want = {**wkv_counts(chunked=n * TRAIN_STEPS, backward_chunked=n * TRAIN_STEPS),
            "dout_copies": 0, "flash": 0}
    check(row["launches"] == want, f"RWKV training launches {row['launches']}, want {want}")
    want = {**wkv_counts(chunked=2 * n, backward_chunked=n), "dout_copies": 0, "flash": 0}
    check(row["remat"]["full"]["launches"] == want,
          f"remat='full' RWKV step launches {row['remat']['full']['launches']}")
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
    # RWKV's training launcher on the card: its smoke config (f32, hd 32)
    # takes the sequential forward kernel and the backward kernel
    with tempfile.TemporaryDirectory() as root:
        argv = [*RWKV_TRAIN_MAIN, "--ckpt-dir", root]
        reset_launches()
        t0 = time.perf_counter()
        rc = train_launch.main(argv)
        torch.cuda.synchronize()
        wkv_launches = dict(wkv.wkv_bhsd.variant_launches)
    n = get_smoke_config("rwkv6_1b6").n_layers * 30     # 30 steps: main's default
    rwkv_row = dict(argv=argv, rc=rc, seconds=time.perf_counter() - t0,
                    wkv_launches=wkv_launches, flash_launches=fa.flash_attention_bhsd.launches)
    emit("trainer_rwkv_main", **rwkv_row)
    check(rc == 0, f"launch.train.main exited {rc}")
    check(wkv_launches == wkv_counts(sequential=n, backward=n),
          f"launch.train.main --arch rwkv6_1b6 WKV launches {wkv_launches}")
    check(fa.flash_attention_bhsd.launches == 0, "RWKV training launched flash attention")
    row["rwkv_main"] = rwkv_row
    return row


# the operators under which the MoE layer's work runs on the card: the
# expert products (einsum: bmm and its layout copies), the routing's sorts
# and scatters, the gathers into and out of the expert slots, and the
# products without a batch dim (projections, router, unembedding)
MOE_OPS = ("aten::einsum", "aten::bmm", "aten::mm", "aten::sort", "aten::index",
           "aten::scatter", "aten::scatter_")


def moe_drops(model, tokens, layers: int) -> dict:
    """The MoE layers' routing in one prefill of ``tokens``, from the
    program's counters (kept while a profiler records): the (token,
    expert) pairs routed, the expert slots, the slots that took a token,
    and the pairs that no expert slot took.  Checks that ``layers`` MoE
    layers each routed every token's k choices to E x C slots, and that
    no more slots took a token than there are pairs or slots."""
    from torch.profiler import ProfilerActivity, profile
    cfg, (g, t) = model.cfg, tokens.shape
    cap = moe_mod.moe_capacity(t, cfg.n_experts, cfg.experts_per_token, model.capacity_factor)
    before = METRICS.snapshot()
    with profile(activities=[ProfilerActivity.CPU]):
        serve.prefill(model, tokens)
    moved = METRICS.delta(before).get("counters", {})
    routed, slots, taken = (moved.get(f"moe.{k}", 0)
                            for k in ("pairs_routed", "slots", "slots_taken"))
    out = dict(routed=routed, slots=slots, taken=taken, dropped=routed - taken)
    check(routed == layers * g * t * cfg.experts_per_token
          and slots == layers * g * cfg.n_experts * cap and 0 <= taken <= min(routed, slots),
          f"MoE routing counts {out} over {layers} layers")
    return out


def phase_olmoe(model) -> dict:
    """Full olmoe_1b_7b serving: the prefill of phase 4 (16 tensor-core
    launches a call), the tokens its MoE layers drop, where the time goes, and
    ``ServeLoop``."""
    cfg = model.cfg
    row = phase_prefill(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    tokens = torch.randint(0, cfg.vocab_size, PREFILL, generator=gen, device="cuda")
    drops = moe_drops(model, tokens, cfg.n_layers)
    emit("olmoe_drops", arch=cfg.name, batch=PREFILL[0], seq=PREFILL[1],
         capacity_factor=model.capacity_factor,
         capacity=moe_mod.moe_capacity(PREFILL[1], cfg.n_experts, cfg.experts_per_token,
                                       model.capacity_factor),
         **drops, dropped_share=drops["dropped"] / drops["routed"],
         slot_fill=drops["taken"] / drops["slots"])
    prefill = phase_profile(model, top=10, ops=MOE_OPS)
    row["profile"] = prefill
    row["expert_products_share"] = prefill["op_device_share"]["aten::bmm"]
    row["serve"] = phase_serve(model, **OLMOE_SERVE)
    return row


def phase_olmoe_train(cfg_full) -> dict:
    """olmoe_1b_7b at full width, ``OLMOE_TRAIN_LAYERS`` layers
    (:func:`train_cell`): 6 tensor-core flash forwards and backwards a
    step, twice the forwards under "full" and "dots", the "dots" peaks
    between "full"'s and "none"'s, and the operators "dots" saved."""
    cfg = replace(cfg_full, n_layers=OLMOE_TRAIN_LAYERS)
    saved, policy = {}, transformer_mod._save_dots

    def counting(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and decision == transformer_mod.CheckpointPolicy.MUST_SAVE:
            saved[str(op)] = saved.get(str(op), 0) + 1
        return decision
    transformer_mod._save_dots = counting
    try:
        row = train_cell(cfg, lambda: dict(fa.flash_attention_bhsd.variant_launches), "flash",
                         remats=("full", "dots"))
    finally:
        transformer_mod._save_dots = policy
    row["dots_saved_ops_per_step"] = {op: n / 2 for op, n in saved.items()}  # two steps
    emit("olmoe_train", **row)
    check_training(row)
    n = cfg.n_layers
    want = flash_counts(wgmma=n * TRAIN_STEPS, backward_wgmma=n * TRAIN_STEPS)
    check(row["launches"] == want, f"olmoe training launches {row['launches']}, want {want}")
    for policy_name in ("full", "dots"):
        got = row["remat"][policy_name]["launches"]
        check(got == flash_counts(wgmma=2 * n, backward_wgmma=n),
              f"remat={policy_name!r} olmoe step launches {got}")
    # wq, wk, wv, wo and the router: the expert products are bmm
    check(row["dots_saved_ops_per_step"] == {"aten.mm.default": 5 * n},
          f"remat='dots' saved {row['dots_saved_ops_per_step']}, want {5 * n} aten.mm")
    full, dots = row["remat"]["full"], row["remat"]["dots"]
    for key in ("peak_fwd_bwd_gb", "peak_memory_gb"):
        check(full[key] <= dots[key] <= row[key],
              f"{key}: 'dots' {dots[key]} not between 'full' {full[key]} and 'none' {row[key]}")
    return row


def phase_mixtral(cfg_full) -> dict:
    """mixtral_8x7b at full width, ``MIXTRAL_LAYERS`` layers, bf16: a
    prefill whose 4096 window masks nothing (the tensor-core kernel, GQA
    32/8), its k/v written into a decode cache, then decode steps past the
    window, which ``decode_attention`` masks."""
    cfg = replace(cfg_full, n_layers=MIXTRAL_LAYERS)
    model = LM(cfg, seed=SEED, device="cuda")        # bf16
    check(model.period == 1, f"mixtral's layer period {model.period}")
    b, s = MIXTRAL_PREFILL
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    captured, original = [], transformer_mod.attn.gqa_attention

    def capturing(q, k, v, **kw):
        captured.append((k, v))
        return original(q, k, v, **kw)
    reset_launches()
    transformer_mod.attn.gqa_attention = capturing
    try:
        logits, secs, gc_secs = timed_call(lambda: serve.prefill(model, tokens))
    finally:
        transformer_mod.attn.gqa_attention = original
    launches = dict(fa.flash_attention_bhsd.variant_launches)
    check(launches == flash_counts(wgmma=cfg.n_layers),
          f"mixtral prefill launches {launches}, want {cfg.n_layers} of the tensor-core kernel")
    check(bool(torch.isfinite(logits).all()), "mixtral prefill logits are not finite")
    # what a prefill that fills the cache would leave there: every layer's
    # rotated k and its v at positions 0 .. S-1
    cache = model.init_cache(b, s + MIXTRAL_DECODE)
    for r, (k, v) in enumerate(captured):
        cache[0]["k"][r, :, :s] = k
        cache[0]["v"][r, :, :s] = v
    del captured
    tok = logits.argmax(dim=-1, keepdim=True)
    reset_launches()
    steps, masked = [], []
    with torch.no_grad():
        for t in range(MIXTRAL_DECODE):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = model.decode_step(cache, tok, s + t)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            check(bool(torch.isfinite(lg).all()), f"mixtral decode step {t} logits not finite")
            tok = lg[:, -1:].argmax(dim=-1)
            # keys at or before (cache length - 1) - window fall outside it
            masked.append(max(0, s + t - cfg.sliding_window + 1))
    row = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, params=sum(
        p.numel() for p in model.parameters()), batch=b, seq=s, window=cfg.sliding_window,
        dtype="bf16", prefill_seconds=secs, prefill_gc_seconds=gc_secs,
        prefill_tokens_per_s=b * s / secs, prefill_launches=launches,
        decode_steps=MIXTRAL_DECODE, decode_step_ms_median=statistics.median(steps) * 1e3,
        decode_flash_launches=fa.flash_attention_bhsd.launches,
        keys_masked_by_window_per_step=masked)
    emit("mixtral", **row)
    check(masked[0] >= 1, "the decode steps never reach past the window")
    check(fa.flash_attention_bhsd.launches == 0, "mixtral decode launched a flash kernel")
    del cache
    row["long_prefill"] = mixtral_long_prefill(model)
    del model
    return row


def mixtral_long_prefill(model) -> dict:
    """``prefill`` on ``MIXTRAL_LONG_PREFILL`` tokens, 8 windows long, twice:
    every layer's attention through the windowed tensor-core kernel (one
    ``wgmma/causal+window`` launch a layer, counted from 0 around each
    call), finite logits, tokens/s of the second call; then a profiler
    window over one more call."""
    cfg = model.cfg
    b, s = MIXTRAL_LONG_PREFILL
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    want = {"wgmma/causal+window": cfg.n_layers}
    torch.cuda.reset_peak_memory_stats()
    secs, by_mask = [], []
    for _ in range(2):
        reset_launches()
        logits, sec, gc_sec = timed_call(lambda: serve.prefill(model, tokens))
        secs.append(sec)
        by_mask.append(dict(fa.flash_attention_bhsd.mask_launches))
        check(tuple(logits.shape) == (b, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
              f"mixtral 32k prefill logits {tuple(logits.shape)} not finite")
        check(by_mask[-1] == want, f"mixtral 32k prefill launches {by_mask[-1]}, want {want}")
    row = dict(arch=cfg.name, layers=cfg.n_layers, batch=b, seq=s, window=cfg.sliding_window,
               dtype="bf16", seconds=secs, tokens_per_s=b * s / secs[-1],
               mask_launches_per_call=by_mask, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    # where the time goes: the top kernels and the windowed kernel's device time
    row["profile"] = profile_window(lambda: serve.prefill(model, tokens), 1, top=8,
                                    named="flash")
    emit("mixtral_long_prefill", **row)
    return row


def phase_mixtral_window(cfg_full) -> dict:
    """mixtral_8x7b's windowed cells beside phase 15's: the f32 check at
    ``MIXTRAL_F32_LAYERS`` layers over ``WINDOW_SHAPE``'s length (prefill
    logits through the CUDA-core windowed kernel vs the chunked scan, within
    phase 5's 2e-3; capacity factor 16, so no token drops in either route)
    and one bf16 training step at ``MIXTRAL_TRAIN_LAYERS`` layer on 1 x that
    length through the windowed tensor-core forward and backward."""
    s = WINDOW_SHAPE[1]
    cfg = replace(cfg_full, n_layers=MIXTRAL_F32_LAYERS)
    model = LM(cfg, param_dtype=torch.float32, capacity_factor=16.0, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device="cuda")
    reset_launches()
    logits = serve.prefill(model, tokens)
    by_mask = dict(fa.flash_attention_bhsd.mask_launches)
    original = transformer_mod.attn.gqa_attention
    transformer_mod.attn.gqa_attention = scan_route
    try:
        reset_launches()
        scan_logits = serve.prefill(model, tokens)
        scan_launches = fa.flash_attention_bhsd.launches
    finally:
        transformer_mod.attn.gqa_attention = original
    err = float((logits - scan_logits).abs().max())
    f32 = dict(arch=cfg.name, layers=cfg.n_layers, batch=1, seq=s, window=cfg.sliding_window,
               dtype="f32", max_abs_err=err, tol=2e-3, mask_launches=by_mask,
               scan_route_flash_launches=scan_launches)
    emit("mixtral_window_f32", **f32)
    want = {"cuda_core/causal+window": cfg.n_layers}
    check(by_mask == want, f"mixtral f32 prefill launches {by_mask}, want {want}")
    check(scan_launches == 0, "the scan route launched a flash kernel")
    check(err < 2e-3, f"mixtral f32 windowed prefill differs from the scan route: {f32}")
    del model, logits, scan_logits
    free()

    cfg = replace(cfg_full, n_layers=MIXTRAL_TRAIN_LAYERS)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(cfg, ShapeConfig("mixtral_window_train", s, 1, "train"),
                          TrainerConfig(steps=1, ckpt_dir=ckpt_dir), param_dtype=torch.bfloat16,
                          device="cuda")
        params = trainer.params()
        opt_state = adamw_init(params)
        batch = trainer.batch(trainer.data.batch_at(0))
        reset_launches()
        params, opt_state, loss, secs, split, fb_peak = train_step_timed(
            trainer, params, opt_state, batch)
        launches = dict(fa.flash_attention_bhsd.variant_launches)
        train_mask = dict(fa.flash_attention_bhsd.mask_launches)
        del trainer, params, opt_state, batch
    train = dict(arch=cfg.name, layers=cfg.n_layers, batch=1, seq=s, window=cfg.sliding_window,
                 dtype="bf16 params, f32 AdamW state", loss=loss, step_s=secs, split_ms=split,
                 train_tokens_per_s=s / secs, peak_fwd_bwd_gb=fb_peak / 1e9,
                 launches=launches, mask_launches=train_mask)
    emit("mixtral_window_train", **train)
    check(np.isfinite(loss), f"mixtral windowed training loss is not finite: {train}")
    want = {"wgmma/causal+window": cfg.n_layers, "backward_wgmma/causal+window": cfg.n_layers}
    check(launches == flash_counts(wgmma=cfg.n_layers, backward_wgmma=cfg.n_layers) and
          train_mask == want, f"mixtral windowed step launches {train_mask}, want {want}")
    return dict(f32=f32, train=train)


@contextlib.contextmanager
def counting_calls(module, name: str, seen: dict):
    """Count the calls of ``module.name`` into ``seen[name]`` while inside."""
    original = getattr(module, name)

    def counted(*args, **kwargs):
        seen[name] = seen.get(name, 0) + 1
        return original(*args, **kwargs)
    setattr(module, name, counted)
    try:
        yield seen
    finally:
        setattr(module, name, original)


def greedy_row(model, tokens, frontend=None, **counted) -> dict:
    """``greedy_decode`` of ``NEW_DECODE``'s teacher-forced prompt and new
    tokens (with the memory of ``frontend`` where given): tokens in range,
    the seconds, the flash launches (by mask) and the calls of each
    ``counted`` (name: module) function."""
    cfg = model.cfg
    b, plen, new = NEW_DECODE
    seen: dict = {}
    reset_launches()
    with contextlib.ExitStack() as stack:
        for name, module in counted.items():
            stack.enter_context(counting_calls(module, name, seen))
        out, secs, gc_secs = timed_call(lambda: serve.greedy_decode(
            model, tokens[:b, :plen], new, None if frontend is None else frontend[:b]))
    check(tuple(out.shape) == (b, new) and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"greedy_decode gave {tuple(out.shape)} tokens out of range")
    return dict(batch=b, prompt=plen, new_tokens=new, seconds=secs, gc_seconds=gc_secs,
                steps=plen + new, ms_per_step=secs * 1e3 / (plen + new),
                flash_launches=dict(fa.flash_attention_bhsd.mask_launches), calls=seen,
                sample=out[0].tolist())


def full_size_refusal(arch: str) -> dict:
    """``serve.main --full-size`` of a config whose bf16 weights exceed
    the card must raise ``ValueError`` before it allocates anything."""
    before = torch.cuda.memory_allocated()
    try:
        serve.main(["--arch", arch, "--full-size"])
    except ValueError as err:
        refused = str(err)
    else:
        refused = None
    check(refused is not None and "bytes" in refused,
          f"serve.main --arch {arch} --full-size did not refuse: {refused}")
    check(torch.cuda.memory_allocated() == before, "the refused serve.main allocated memory")
    return dict(arch=arch, refused=refused)


def scan_event_ms(model, tokens) -> tuple[float, float]:
    """(device ms of the selective scan's chunks, CUDA events around each
    chunk; the prefill's wall seconds) over one prefill of ``tokens``: the
    scan's share without the profiler."""
    spans, original = [], transformer_mod.ssm_mod._selective_scan_chunk

    def timed_chunk(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = original(*args)
        end.record()
        spans.append((start, end))
        return out
    transformer_mod.ssm_mod._selective_scan_chunk = timed_chunk
    try:
        _, secs, _ = timed_call(lambda: serve.prefill(model, tokens))
    finally:
        transformer_mod.ssm_mod._selective_scan_chunk = original
    return sum(a.elapsed_time(b) for a, b in spans), secs


def phase_jamba(cfg_full) -> dict:
    """jamba_15_large at full width, ``JAMBA_CUT``, bf16: prefill (one
    tensor-core flash launch a call: its one attention layer; the three
    Mamba layers' selective scan in plain torch), the tokens its two MoE
    layers drop, a profile with the device time under the scan's device
    span, a teacher-forced ``greedy_decode`` through ``mamba_step``, and
    the whole config's refusal."""
    cfg = replace(cfg_full, **JAMBA_CUT)
    model = LM(cfg, seed=SEED, device="cuda")        # bf16
    layout = [(spec.kind, spec.moe) for spec in model.specs]
    check(layout == [("mamba", False), ("mamba", True), ("mamba", False), ("attn", True)],
          f"jamba's layer pattern {layout}")
    seen: dict = {}
    with counting_calls(transformer_mod.ssm_mod, "mamba_seq", seen):
        row = phase_prefill(model)
    check(seen == {"mamba_seq": 3 * 2}, f"mamba_seq calls in two prefills {seen}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    tokens = torch.randint(0, cfg.vocab_size, PREFILL, generator=gen, device="cuda")
    drops = moe_drops(model, tokens, 2)
    prof = profile_window(lambda: serve.prefill(model, tokens), 1, top=10,
                          ops=("repro_torch.mamba.scan", *MOE_OPS))
    scan_ms, prefill_s = scan_event_ms(model, tokens)
    decode = greedy_row(model, tokens, mamba_step=transformer_mod.ssm_mod)
    b, plen, new = NEW_DECODE
    check(decode["calls"] == {"mamba_step": 3 * (plen + new)} and not decode["flash_launches"],
          f"jamba decode: {decode['calls']}, flash {decode['flash_launches']}")
    row = dict(prefill=row, params=sum(p.numel() for p in model.parameters()),
               layout=layout, capacity_factor=model.capacity_factor,
               dropped=drops["dropped"], dropped_share=drops["dropped"] / drops["routed"],
               profile=prof, scan_share=prof["op_device_share"]["repro_torch.mamba.scan"],
               scan_event_ms=scan_ms, scan_event_share_of_wall=scan_ms / (prefill_s * 1e3),
               decode=decode)
    del model
    free()
    row["whole_config"] = full_size_refusal("jamba_15_large")
    emit("jamba", **row)
    return row


def phase_vision(cfg_full) -> dict:
    """llama32_vision_90b at full width, ``VISION_CUT``, bf16, over 6404
    frontend tokens: prefill (one tensor-core launch a layer, none from its
    two cross-attention layers, which run the chunked scan), a teacher-forced
    ``greedy_decode`` with memory, int8 vs bf16 KV decode with memory, and
    the whole config's refusal."""
    cfg = replace(cfg_full, **VISION_CUT)
    model = LM(cfg, seed=SEED, device="cuda")        # bf16
    n_cross = model.n_rep * sum(spec.cross for spec in model.specs)
    check(n_cross == 2, f"{n_cross} cross layers in {cfg.n_layers}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    frontend = torch.randn((PREFILL[0], cfg.frontend_tokens, cfg.frontend_dim), generator=gen,
                           device="cuda")
    seen: dict = {}
    with counting_calls(transformer_mod.attn, "cross_attention", seen):
        row = phase_prefill(model, frontend)
    check(seen == {"cross_attention": n_cross * 2}, f"cross-attention calls {seen}")
    tokens = torch.randint(0, cfg.vocab_size, PREFILL, generator=gen, device="cuda")
    decode = greedy_row(model, tokens, frontend, cross_attention=transformer_mod.attn)
    b, plen, new = NEW_DECODE
    check(decode["calls"] == {"cross_attention": n_cross * (plen + new)}
          and not decode["flash_launches"],
          f"vision decode: {decode['calls']}, flash {decode['flash_launches']}")
    kv = phase_kv_int8(model, frontend[:KV_INT8[0]])
    row = dict(prefill=row, params=sum(p.numel() for p in model.parameters()),
               cross_layers=n_cross, decode=decode, kv_int8_rel_gap=kv["rel_gap"])
    del model, frontend
    free()
    row["whole_config"] = full_size_refusal("llama32_vision_90b")
    emit("vision", **row)
    return row


def phase_seamless(cfg) -> dict:
    """seamless_m4t_v2 whole, bf16, over 2 x 4096 frames: ``encode_memory``
    (24 non-causal launches), prefill (24 non-causal encoder and 24 causal
    decoder launches; the decoder's 24 cross-attentions run the chunked
    scan) and a teacher-forced ``greedy_decode`` (one encoding)."""
    model = LM(cfg, seed=SEED, device="cuda")        # bf16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
    frontend = torch.randn((PREFILL[0], cfg.frontend_tokens, cfg.frontend_dim), generator=gen,
                           device="cuda")
    n = cfg.n_layers
    reset_launches()
    mem, enc_s, _ = timed_call(lambda: model.encode_memory(frontend))
    enc_masks = dict(fa.flash_attention_bhsd.mask_launches)
    check(tuple(mem.shape) == (PREFILL[0], cfg.frontend_tokens, cfg.d_model)
          and bool(torch.isfinite(mem).all()), "encode_memory's memory")
    check(enc_masks == {"wgmma/full": cfg.n_encoder_layers},
          f"encode_memory launches {enc_masks}")
    seen: dict = {}
    with counting_calls(transformer_mod.attn, "cross_attention", seen):
        row = phase_prefill(model, frontend, masks={"wgmma/full": cfg.n_encoder_layers,
                                                    "wgmma/causal": n})
    check(seen == {"cross_attention": n * 2}, f"cross-attention calls {seen}")
    tokens = torch.randint(0, cfg.vocab_size, PREFILL, generator=gen, device="cuda")
    decode = greedy_row(model, tokens, frontend)
    check(decode["flash_launches"] == {"wgmma/full": cfg.n_encoder_layers},
          f"seamless decode launches {decode['flash_launches']}")
    row = dict(prefill=row, params=sum(p.numel() for p in model.parameters()),
               encode_seconds=enc_s, encode_frames_per_s=PREFILL[0] * PREFILL[1] / enc_s,
               encode_launches=enc_masks, decode=decode)
    emit("seamless", **row)
    del model, frontend, mem
    return row


def phase_seamless_train(cfg) -> dict:
    """seamless_m4t_v2 whole (:func:`train_cell`), B=1 x S=4096 over 4096
    frames: 24 non-causal and 24 causal tensor-core forwards and as many
    backwards a step, twice the forwards under "full"."""
    read = lambda: {**fa.flash_attention_bhsd.variant_launches,  # noqa: E731
                    **fa.flash_attention_bhsd.mask_launches}
    row = train_cell(cfg, read, "flash", attn_chunk=SEAMLESS_TRAIN_ATTN_CHUNK)
    emit("seamless_train", **row)
    check_training(row)
    e, d = cfg.n_encoder_layers, cfg.n_layers

    def want(fwd):
        return {**flash_counts(wgmma=fwd * (e + d), backward_wgmma=e + d),
                "wgmma/full": fwd * e, "wgmma/causal": fwd * d,
                "backward_wgmma/full": e, "backward_wgmma/causal": d}
    steps = {k: v * TRAIN_STEPS for k, v in want(1).items()}
    check(row["launches"] == steps,
          f"seamless training launches {row['launches']}, want {steps}")
    check(row["remat"]["full"]["launches"] == want(2),
          f"remat='full' seamless step launches {row['remat']['full']['launches']}")
    return row


def seeded_tokens(cfg, b, s, seed) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda",
                         dtype=torch.int32)


def phase_steps_prefill(cfg, mesh) -> tuple:
    """``build_prefill_step`` of full llama3_8b on the mesh of one: the
    bundle's step on the DTensor parameters (the plain model's own storage)
    against ``serve.prefill`` of the same model on ``PREFILL`` tokens,
    within the bf16 bar of phase 2; 32 tensor-core flash launches a call.
    Returns (the model, now on the bundle's placements, and the row)."""
    model = LM(cfg, seed=SEED, device="cuda")
    b, s = PREFILL
    tokens = seeded_tokens(cfg, b, s, SEED + 21)
    plain_secs = []
    for _ in range(2):
        plain, sec, _ = timed_call(lambda: serve.prefill(model, tokens))
        plain_secs.append(sec)
    bundle = build_prefill_step(cfg.name, STEPS_PREFILL.name, mesh, cfg=cfg)
    params, _ = place_state(bundle, model)
    inputs = place_like({"tokens": tokens}, {"tokens": bundle.input_specs["tokens"]})
    secs, launches, memory = [], [], {}
    for _ in range(2):
        reset_launches()
        logits = None
        with step_memory((params, inputs), memory):
            logits, sec, _ = timed_call(lambda: bundle.step_fn(params, **inputs))
        secs.append(sec)
        launches.append(dict(fa.flash_attention_bhsd.variant_launches))
    logits = logits.to_local()
    ratio = limit_ratio(logits, plain, *TOL["bf16"])
    row = dict(arch=cfg.name, layers=cfg.n_layers, batch=b, seq=s, mesh=list(mesh.shape),
               policy=bundle.policy, placements=sorted({str(t.placements) for t in
                                                        tree_leaves(params)}),
               launches_per_call=launches, seconds=secs, tokens_per_s=b * s / secs[-1],
               plain_seconds=plain_secs, plain_tokens_per_s=b * s / plain_secs[-1],
               dtensor_over_plain=secs[-1] / plain_secs[-1],
               max_abs_err=float((logits - plain).abs().max()), limit_ratio=ratio,
               bit_equal=bool(torch.equal(logits, plain)), tol=TOL["bf16"], memory=memory)
    emit("steps_prefill", **row)
    check(tuple(logits.shape) == (b, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          "step logits are not finite [B, V]")
    check(all(n == flash_counts(wgmma=cfg.n_layers) for n in launches),
          f"step prefill launches {launches}")
    check(ratio <= 1.0, f"step logits differ from serve.prefill: {row}")
    return model, row


def phase_steps_decode(model, mesh) -> dict:
    """``build_serve_step`` of full llama3_8b on the mesh of one at
    ``STEPS_DECODE`` (caches of 4096 for 8 rows, 4.3 GB, filled with seeded
    values): its logits and its new cache entries against
    ``LM.decode_step`` at position S - 1 on a copy of the same caches; no
    flash launch."""
    cfg = model.cfg
    b, s = STEPS_DECODE.global_batch, STEPS_DECODE.seq_len
    bundle = build_serve_step(cfg.name, STEPS_DECODE.name, mesh, cfg=cfg)
    params, _ = place_state(bundle, model)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    cache = model.init_cache(b, s, dtype=torch.bfloat16)
    for t in tree_leaves(cache):
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    ref_cache = tree_map(lambda t: t.clone(), cache)
    tokens = seeded_tokens(cfg, b, 1, SEED + 23)
    inputs = place_like({"cache": cache, "tokens": tokens},
                        {"cache": bundle.input_specs["cache"],
                         "tokens": bundle.input_specs["tokens"]})
    secs, memory = [], {}
    for _ in range(3):
        reset_launches()
        logits = new_cache = None
        with step_memory((params, inputs), memory):
            (logits, new_cache), sec, _ = timed_call(lambda: bundle.step_fn(params, **inputs))
        secs.append(sec)
    launches = fa.flash_attention_bhsd.launches
    with gathered(model):
        plain_secs = []
        for _ in range(3):
            (ref, _), sec, _ = timed_call(lambda: model.decode_step(ref_cache, tokens, s - 1))
            plain_secs.append(sec)
    logits = logits.to_local()
    ratio = limit_ratio(logits, ref, *TOL["bf16"])
    cache_equal = all(torch.equal(a.to_local(), r) for a, r in
                      zip(tree_leaves(new_cache), tree_leaves(ref_cache)))
    row = dict(arch=cfg.name, batch=b, cache_len=s, position=s - 1,
               cache_gb=sum(t.numel() * t.element_size() for t in tree_leaves(cache)) / 1e9,
               step_seconds=secs, plain_step_seconds=plain_secs,
               dtensor_over_plain=secs[-1] / plain_secs[-1], flash_launches=launches,
               max_abs_err=float((logits - ref).abs().max()), limit_ratio=ratio,
               bit_equal=bool(torch.equal(logits, ref)), caches_equal=cache_equal,
               memory=memory)
    emit("steps_decode", **row)
    check(tuple(logits.shape) == (b, 1, cfg.vocab_size), f"decode logits {logits.shape}")
    check(launches == 0, "the decode step launched a flash kernel")
    check(ratio <= 1.0 and cache_equal, f"the decode step differs from LM.decode_step: {row}")
    return row


def plain_train_step(model, params, opt_state, batch, grad_accum: int = 1):
    """The bundles' train step on plain tensors (the JAX builder's step):
    ``grad_accum`` microbatches summed in a bf16 accumulator and divided,
    the eager AdamW at the default ``warmup_cosine``."""
    leaves = tree_leaves(params)
    if grad_accum == 1:
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, leaves)
    else:
        micro = batch["tokens"].shape[0] // grad_accum
        gsum = [torch.zeros_like(p, dtype=torch.bfloat16) for p in leaves]
        loss = 0.0
        for i in range(grad_accum):
            part = model.loss({k: v[i * micro:(i + 1) * micro] for k, v in batch.items()})
            g = torch.autograd.grad(part, leaves)
            gsum = [a + b.to(a.dtype) for a, b in zip(gsum, g)]
            loss = loss + part.detach()
        grads = [g / grad_accum for g in gsum]
        loss = loss / grad_accum
    by_param = {id(p): g for p, g in zip(leaves, grads)}
    # the eager AdamW: the plain version of the kernels the bundles run
    params, opt_state, metrics = adamw_update_eager(
        AdamWConfig(), params, tree_map(lambda p: by_param[id(p)], params), opt_state,
        warmup_cosine(opt_state["step"]))
    metrics["loss"] = loss.detach()
    return params, opt_state, metrics


def steps_reference(cfg, batch, grad_accum: int, n_steps: int) -> dict:
    """``n_steps`` of :func:`plain_train_step` from the seed: the losses, and
    m (and after more than one step the f32 master) after them, copied to
    the host: the card does not hold two states of 45 GB."""
    model = LM(cfg, seed=SEED, remat="full", device="cuda")
    for p in model.parameters():
        p.requires_grad_(True)
    params = param_tree(model)
    opt_state = adamw_init(params)
    losses, secs = [], []
    for _ in range(n_steps):
        (params, opt_state, metrics), sec, _ = timed_call(
            lambda: plain_train_step(model, params, opt_state, batch, grad_accum))
        losses.append(float(metrics["loss"]))
        secs.append(sec)
    kept = ("m", "master") if n_steps > 1 else ("m",)
    out = {"losses": losses, "seconds": secs,
           **{k: {n: t.cpu() for n, t in flatten_tree(opt_state[k]).items()} for k in kept}}
    del model, params, opt_state
    free()
    return out


def steps_errors(opt_state, ref) -> dict:
    """Each leaf's m error over its largest |m| and, where the reference
    kept it, its master error: the worst of each, compared on the card."""
    def errs(key, rel):
        out = {}
        for n, t in flatten_tree(opt_state[key]).items():
            want = ref[key][n].to(t.device)
            err = (t.to_local() - want).abs().max()
            out[n] = float(err / want.abs().max().clamp(min=1e-30) if rel else err)
        return out
    m = errs("m", True)
    row = {"m_rel_worst": max(m.values()), "m_rel_worst_leaf": max(m, key=m.get)}
    if "master" in ref:
        master = errs("master", False)
        row.update(master_abs_worst=max(master.values()),
                   master_abs_worst_leaf=max(master, key=master.get))
    return row


def run_bundle_steps(bundle, batch, n_steps, read_launches, ref=None) -> dict:
    """``n_steps`` of ``bundle.step_fn`` from a fresh placed state: the
    losses, wall seconds and launches of each, the first step's memory
    (:func:`step_memory`) and the peak from then on; with ``ref`` (of
    :func:`steps_reference`), the state's errors against it after as many
    steps as it ran."""
    params, opt_state = place_state(bundle, seed=SEED)
    inputs = place_like(batch, bundle.input_specs["batch"])
    row = dict(losses=[], seconds=[], launches=[], first_step_memory={})
    for i in range(n_steps):
        reset_launches()
        with (step_memory((params, opt_state, inputs), row["first_step_memory"]) if i == 0
              else contextlib.nullcontext()):
            (params, opt_state, metrics), sec, _ = timed_call(
                lambda: bundle.step_fn(params, opt_state, inputs))
        row["losses"].append(float(metrics["loss"].to_local()))
        row["seconds"].append(sec)
        row["launches"].append(read_launches())
        if ref is not None and i + 1 == len(ref["losses"]):
            row["errors"] = steps_errors(opt_state, ref)
    row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, opt_state
    free()
    return row


def phase_steps_train(cfg_full, mesh, trainer_full_step_s: float) -> dict:
    """``build_train_step`` of llama3_8b at 8 layers on the mesh of one:
    ``STEPS_TRAIN_STEPS`` steps on one sequence of 4096 (remat "full": 16
    tensor-core forward and 8 backward launches a step), finite losses;
    the first two steps' losses, m and master held against
    :func:`plain_train_step` from the same seed; then ``grad_accum=2`` on
    two sequences, one step, against the plain bf16-accumulator route.
    The step time beside the Trainer's under "full" (phase 10)."""
    cfg = replace(cfg_full, n_layers=TRAIN_LAYERS)
    read = lambda: dict(fa.flash_attention_bhsd.variant_launches)  # noqa: E731
    out = {}
    # grad_accum 1: two reference steps (the master moves first at the
    # second, warmup's first scale being 0); grad_accum 2: one, its m
    for shape, accum, n_steps, n_ref in ((STEPS_TRAIN, 1, STEPS_TRAIN_STEPS, 2),
                                         (STEPS_TRAIN_ACCUM, 2, 1, 1)):
        b, s = shape.global_batch, shape.seq_len
        toks = seeded_tokens(cfg, b, s + 1, SEED + 24)
        batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
        ref = steps_reference(cfg, batch, accum, n_ref)
        bundle = build_train_step(cfg.name, shape.name, mesh, cfg=cfg, grad_accum=accum)
        row = run_bundle_steps(bundle, batch, n_steps, read, ref)
        row = dict(batch=b, seq=s, grad_accum=accum, policy=bundle.policy, remat=bundle.model.remat,
                   **row, ref_losses=ref["losses"], ref_seconds=ref["seconds"],
                   loss_rel_errs=[abs(a - r) / abs(r) for a, r in zip(row["losses"],
                                                                      ref["losses"])])
        out[f"grad_accum_{accum}"] = row
        del bundle, ref
        free()
    main = out["grad_accum_1"]
    step_s = statistics.median(main["seconds"][1:])
    emit("steps_train", arch=cfg.name, layers=cfg.n_layers, median_step_s=step_s,
         train_tokens_per_s=STEPS_TRAIN.seq_len / step_s,
         trainer_full_step_s=trainer_full_step_s, dtensor_over_trainer=step_s / trainer_full_step_s,
         **out)
    for row in out.values():
        accum = row["grad_accum"]
        check(all(np.isfinite(row["losses"])), f"step losses are not finite: {row['losses']}")
        fwd = 2 * cfg.n_layers * accum            # remat "full": each layer twice
        check(all(n == flash_counts(wgmma=fwd, backward_wgmma=cfg.n_layers * accum)
                  for n in row["launches"]), f"train step launches {row['launches']}")
        errs = row["errors"]
        check(max(row["loss_rel_errs"]) <= STEPS_LOSS_REL and errs["m_rel_worst"] <= STEPS_M_REL
              and errs.get("master_abs_worst", 0.0) <= STEPS_MASTER_ATOL,
              f"the train step (grad_accum {accum}) differs from the plain route: {row}")
    return out


def phase_steps_rwkv_train(cfg, mesh, trainer_full_step_s: float) -> dict:
    """``build_train_step`` of rwkv6_1b6 at full depth on the mesh of one,
    B=1 x S=4096: a step launches 48 chunked WKV forwards (24 recomputed
    under remat "full") and 24 ``backward_chunked``; finite losses."""
    b, s = STEPS_TRAIN.global_batch, STEPS_TRAIN.seq_len
    toks = seeded_tokens(cfg, b, s + 1, SEED + 25)
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    bundle = build_train_step(cfg.name, STEPS_TRAIN.name, mesh, cfg=cfg)
    read = lambda: {**wkv.wkv_bhsd.variant_launches,  # noqa: E731
                    "flash": fa.flash_attention_bhsd.launches}
    row = run_bundle_steps(bundle, batch, 3, read)
    step_s = statistics.median(row["seconds"][1:])
    row = dict(arch=cfg.name, layers=cfg.n_layers, batch=b, seq=s, policy=bundle.policy,
               remat=bundle.model.remat, **row, median_step_s=step_s,
               train_tokens_per_s=b * s / step_s, trainer_full_step_s=trainer_full_step_s,
               dtensor_over_trainer=step_s / trainer_full_step_s)
    emit("steps_rwkv_train", **row)
    n = cfg.n_layers
    want = {**wkv_counts(chunked=2 * n, backward_chunked=n), "flash": 0}
    check(all(np.isfinite(row["losses"])), f"RWKV step losses are not finite: {row['losses']}")
    check(all(x == want for x in row["launches"]), f"RWKV step launches {row['launches']}")
    return row


def phase_jamba_train(cfg_full) -> dict:
    """jamba_15_large at full width with ``JAMBA_TRAIN_CUT`` (layer 0: Mamba
    and a dense FFN) through ``Trainer.step_fn`` (:func:`train_cell`):
    the Mamba path's backward on the card, no flash launch, the falling
    loss; then its f32 gradients through the card's route vs the torch
    scan route (phase 9)."""
    cfg = replace(cfg_full, **JAMBA_TRAIN_CUT)
    row = train_cell(cfg, lambda: dict(fa.flash_attention_bhsd.variant_launches),
                     "selective_scan")
    emit("jamba_train", **row)
    check_training(row)
    check(row["launches"] == flash_counts(), f"jamba training launches {row['launches']}")
    free()
    phase_gradients(cfg_full, **JAMBA_TRAIN_CUT)
    return row


def phase_vision_train(cfg_full) -> dict:
    """llama32_vision_90b at full width with ``VISION_TRAIN_CUT`` (a layer
    of self-attention, then one of self- and cross-attention) over its 6404
    frontend tokens (:func:`train_cell`): one tensor-core flash forward and
    one backward a step for each self-attention (twice the forward under
    "full"), none for the cross-attention (the chunked scan), the falling
    loss; then its f32 gradients vs the scan route (phase 9)."""
    cfg = replace(cfg_full, **VISION_TRAIN_CUT)
    row = train_cell(cfg, lambda: dict(fa.flash_attention_bhsd.variant_launches), "flash",
                     attn_chunk=SEAMLESS_TRAIN_ATTN_CHUNK)
    emit("vision_train", **row)
    check_training(row)
    # every layer holds self-attention; the cross layer adds cross-attention
    n = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    want = flash_counts(wgmma=n * TRAIN_STEPS, backward_wgmma=n * TRAIN_STEPS)
    check(row["launches"] == want, f"vision training launches {row['launches']}, want {want}")
    check(row["remat"]["full"]["launches"] == flash_counts(wgmma=2 * n, backward_wgmma=n),
          f"remat='full' vision step launches {row['remat']['full']['launches']}")
    free()
    phase_gradients(cfg_full, **VISION_TRAIN_CUT)
    return row


def launch_names(flash: dict) -> dict:
    """Nonzero flash ``variant_launches`` under the kernels line's names, as
    the dry run's ``kernel_launches`` names them."""
    return {f"flash_attention_{'bwd' if v.startswith('backward') else 'bhsd'}[{v}]": n
            for v, n in flash.items() if n}


def phase_dryrun_steps(cfg_full, prefill_row, decode_row, train_rows) -> dict:
    """The dry run (``dryrun.run_cell``) of the three llama3_8b step cells of
    phases 20-22 on a meta mesh of one, against what those phases measured
    on the card: the predicted peak over the step's measured peak
    (``step_memory``) within ``DRYRUN_PEAK_RATIO``, the predicted kernel
    launches equal to the measured ones; the predicted FLOPs over the
    measured step time (achieved TFLOP/s) and the measured roofline
    fraction beside the predicted one."""
    mesh1 = make_local_mesh(1, 1, device="cpu")
    train = train_rows["grad_accum_1"]
    cells = {
        "prefill": (STEPS_PREFILL, cfg_full, prefill_row["memory"],
                    launch_names(prefill_row["launches_per_call"][-1]), prefill_row["seconds"][-1]),
        "train": (STEPS_TRAIN, replace(cfg_full, n_layers=TRAIN_LAYERS),
                  train["first_step_memory"], launch_names(train["launches"][0]),
                  statistics.median(train["seconds"][1:])),
        "decode": (STEPS_DECODE, cfg_full, decode_row["memory"],
                   launch_names(flash_counts(wgmma=decode_row["flash_launches"])),
                   decode_row["step_seconds"][-1]),
    }
    out = {}
    for name, (shape, cfg, memory, launches, step_s) in cells.items():
        t0 = time.perf_counter()
        cell = dryrun.run_cell(cfg.name, shape.name, multi_pod=False, overrides={"cfg": cfg},
                               mesh=mesh1, verbose=False)
        row = dict(shape=shape.name, layers=cfg.n_layers, batch=shape.global_batch,
                   seq=shape.seq_len, seconds=time.perf_counter() - t0,
                   predicted_peak_bytes=cell["per_device_bytes"],
                   predicted_argument_bytes=cell["argument_bytes"],
                   measured=memory,
                   peak_ratio=cell["per_device_bytes"] / memory["step_peak_bytes"],
                   argument_ratio=cell["argument_bytes"] / memory["input_bytes"],
                   predicted_launches=cell["kernel_launches"], measured_launches=launches,
                   predicted_flops=cell["flops_per_device"],
                   predicted_flops_by_rate=cell["flops_by_rate"],
                   predicted_bytes=cell["bytes_per_device"], n_ops=cell["n_ops"],
                   predicted_s={k: cell[k] for k in ("compute_s", "memory_s", "collective_s")},
                   dominant=cell["dominant"], measured_step_s=step_s,
                   achieved_tflops=cell["flops_per_device"] / step_s / 1e12,
                   useful_flop_frac=cell["useful_flop_frac"],
                   roofline_frac_predicted=cell["roofline_frac"],
                   roofline_frac_measured=(cell["model_flops_per_device"] / PEAK_FLOPS["bf16"]
                                           / step_s))
        out[name] = row
        emit("dryrun_step", cell=name, **row)
    for name, row in out.items():
        lo, hi = DRYRUN_PEAK_RATIO
        check(lo <= row["peak_ratio"] <= hi,
              f"dry run {name}: predicted peak / measured {row['peak_ratio']:.4f} "
              f"outside [{lo}, {hi}]: {row}")
        check(row["predicted_launches"] == row["measured_launches"],
              f"dry run {name}: predicted launches {row['predicted_launches']} != "
              f"measured {row['measured_launches']}")
    return out


def phase_production_dryrun() -> dict:
    """Both ``--production`` flags (the full-size llama3_8b cells' dry runs
    on the 16 x 16 production mesh over a fake group of 256 ranks) and the
    dry run of mixtral_8x7b's ``prefill_32k`` there (its windowed attention
    through the kernel's meta branch), each in a process of its own (this
    one holds an NCCL group of one), the three together; each must exit 0
    and write an "ok" cell."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    runs = {"train": (["repro_torch.launch.train", "--arch", "llama3_8b", "--production"],
                      "llama3_8b", "train_4k"),
            "serve": (["repro_torch.launch.serve", "--arch", "llama3_8b", "--production"],
                      "llama3_8b", "decode_32k"),
            "mixtral_prefill_32k": (["repro_torch.launch.dryrun", "--arch", "mixtral_8x7b",
                                     "--shape", "prefill_32k", "--force"],
                                    "mixtral_8x7b", "prefill_32k")}
    t0 = time.time()
    procs = {}
    for name, (argv, _, _) in runs.items():
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", *argv], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.perf_counter())
    def wait(proc, start):
        log, _ = proc.communicate(timeout=PRODUCTION_DRYRUN_TIMEOUT_S)
        return log, time.perf_counter() - start

    out = {}
    try:
        with ThreadPoolExecutor(len(procs)) as pool:
            waits = {name: pool.submit(wait, *pr) for name, pr in procs.items()}
        for name, (proc, _) in procs.items():
            log, wall_s = waits[name].result()
            path = dryrun.cell_path(*runs[name][1:], False)
            cell = (json.loads(path.read_text())
                    if path.exists() and path.stat().st_mtime >= t0 else {})
            out[name] = dict(rc=proc.returncode, wall_s=wall_s,
                             cell={k: cell.get(k) for k in (
                                 "arch", "shape", "mesh", "status", "trace_s", "per_device_gib",
                                 "argument_gib", "fits_hbm", "dominant", "useful_flop_frac",
                                 "roofline_frac", "kernel_launches", "flops_by_rate",
                                 "collectives")},
                             log_tail=log[-1500:])
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    emit("production_dryrun", **out)
    for name, row in out.items():
        check(row["rc"] == 0 and row["cell"]["status"] == "ok",
              f"{runs[name][0][0]} ({name}): rc {row['rc']}, cell {row['cell']}")
    return out


def phase_train_lm_example() -> dict:
    """``examples/train_lm_torch.py --preset tiny`` on the card, as a
    process of its own with its own time limit: it trains the tiny preset
    through the port's Trainer, checkpoints and restart loop (f32 at hd 16:
    the CUDA-core flash forward and backward); it must exit 0 with a
    falling loss."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        argv = [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"), "--preset", "tiny",
                "--ckpt-dir", ckpt_dir]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=TRAIN_LM_EXAMPLE_TIMEOUT_S)
        wall_s = time.perf_counter() - t0
    found = re.search(r"loss: ([\d.]+) -> ([\d.]+) \(([\d.]+)s, (\d+) tok/s", proc.stdout)
    row = dict(argv=["examples/train_lm_torch.py", *argv[2:4]], rc=proc.returncode, wall_s=wall_s,
               stdout_tail=proc.stdout[-800:], stderr_tail=proc.stderr[-800:])
    if found:
        row.update(loss_first=float(found.group(1)), loss_last=float(found.group(2)),
                   train_s=float(found.group(3)), tokens_per_s=int(found.group(4)))
    emit("train_lm_example", **row)
    check(proc.returncode == 0 and found is not None and row["loss_last"] < row["loss_first"],
          f"examples/train_lm_torch.py on the card: {row}")
    return row


def phase_pipeline(cfg_full) -> dict:
    """GPipe (``runtime/pipeline.py``) with one stage on the NCCL mesh of
    one: llama3_8b's blocks at ``TRAIN_LAYERS`` layers, bf16, on
    ``PIPELINE_BATCH`` hidden states (the embedded tokens) in
    ``PIPELINE_MICROBATCHES`` microbatches, against the same blocks on the
    whole batch, within phase 2's bf16 bar; one tensor-core flash launch a
    layer a microbatch."""
    cfg = replace(cfg_full, n_layers=TRAIN_LAYERS)
    model = LM(cfg, seed=SEED, device="cuda")
    (spec,), (block,) = model.specs, param_tree(model)["blocks"]
    b, s = PIPELINE_BATCH
    tokens = seeded_tokens(cfg, b, s, SEED + 26)
    x = model.embed[tokens.long()].to(torch.bfloat16)
    cos_sin = model._rope(s)
    positions = torch.arange(s, device="cuda")[None, :]

    def stage_fn(p, h):
        for r in range(model.n_rep):
            h, _ = model._layer_seq(tree_map(lambda t: t[r], p), spec, h, None, cos_sin,
                                    positions)
        return h

    stage_mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
    stacked = stack_stage_params([block])
    stage_params = tree_map(lambda t: DTensor.from_local(t, stage_mesh, [Shard(0)],
                                                         run_check=False), stacked)
    with torch.no_grad():
        reset_launches()
        ref, ref_s, _ = timed_call(lambda: stage_fn(block, x))
        ref_launches = dict(fa.flash_attention_bhsd.variant_launches)
        secs = []
        for _ in range(2):
            reset_launches()
            out, sec, _ = timed_call(lambda: pipeline_apply(
                stage_fn, stage_params, x, mesh=stage_mesh,
                microbatches=PIPELINE_MICROBATCHES))
            secs.append(sec)
        launches = dict(fa.flash_attention_bhsd.variant_launches)
    ratio = limit_ratio(out, ref, *TOL["bf16"])
    row = dict(arch=cfg.name, layers=cfg.n_layers, batch=b, seq=s, stages=1,
               microbatches=PIPELINE_MICROBATCHES, seconds=secs, whole_batch_seconds=ref_s,
               launches=launches, whole_batch_launches=ref_launches,
               max_abs_err=float((out.float() - ref.float()).abs().max()), limit_ratio=ratio,
               bit_equal=bool(torch.equal(out, ref)), tol=TOL["bf16"])
    emit("pipeline", **row)
    check(tuple(out.shape) == tuple(x.shape) and bool(torch.isfinite(out).all()),
          f"pipeline output {tuple(out.shape)} is not finite {tuple(x.shape)}")
    check(launches == flash_counts(wgmma=cfg.n_layers * PIPELINE_MICROBATCHES),
          f"pipeline launches {launches}")
    check(ratio <= 1.0, f"the one-stage pipeline differs from the whole batch: {row}")
    del model, stacked, stage_params
    return row


def schedule_row(wf, platform, algorithm: str) -> tuple[dict, object]:
    """One ``schedule()`` of ``wf`` and a rerun: feasible, valid, and the
    rerun's makespan, blocks and processors bit-equal to the first run's.
    Returns the row and the first run's report."""
    t0 = time.perf_counter()
    rep = schedule(wf, platform, algorithm=algorithm)
    wall_s = time.perf_counter() - t0
    check(rep.feasible, f"{wf.name} {algorithm}: infeasible: {rep.infeasibility}")
    errors = validate_mapping(wf, rep.best)
    check(errors == [], f"{wf.name} {algorithm}: invalid mapping: {errors[:3]}")
    t0 = time.perf_counter()
    again = schedule(wf, platform, algorithm=algorithm)
    rerun_s = time.perf_counter() - t0
    same = (again.makespan == rep.makespan
            and again.summary.block_of_task == rep.summary.block_of_task
            and again.summary.proc_of_block == rep.summary.proc_of_block)
    check(same, f"{wf.name} {algorithm}: a rerun gave {again.makespan!r}, "
          f"not {rep.makespan!r} with the same blocks")
    return dict(makespan=rep.makespan, k_used=rep.summary.k_used,
                k_prime=rep.summary.k_prime, sweep_points=len(rep.sweep), wall_s=wall_s,
                rerun_wall_s=rerun_s, rerun_bit_equal=same), rep


def pool_leftovers() -> dict:
    """The child processes and process-pool manager threads alive now."""
    return dict(children=sorted(p.pid for p in multiprocessing.active_children()),
                manager_threads=[t.name for t in threading.enumerate()
                                 if isinstance(t, _ExecutorManagerThread)])


def parallel_schedule_row(wf, platform, algorithm: str, serial, serial_s: float,
                          smi: str) -> dict:
    """Phase 29: ``schedule()`` of ``wf`` on a pool of ``SCHED_WORKERS``:
    the mapping bit-equal to the serial run's (makespan, blocks,
    processors), and no child process or pool manager thread alive after
    it returns.  ``serial_s`` is the serial rerun's seconds: like this
    call, it follows a first call of the same workflow."""
    t0 = time.perf_counter()
    rep = schedule(wf, platform, algorithm=algorithm, workers=SCHED_WORKERS)
    wall_s = time.perf_counter() - t0
    left = pool_leftovers()
    same = (rep.makespan == serial.makespan
            and rep.summary.block_of_task == serial.summary.block_of_task
            and rep.summary.proc_of_block == serial.summary.proc_of_block)
    row = dict(workers=SCHED_WORKERS, bit_equal_to_serial=same,
               serial_rerun_wall_s=serial_s, wall_s=wall_s, over_serial_rerun=wall_s / serial_s,
               left_after=left, nvidia_smi=smi)
    check(same, f"{wf.name} {algorithm}: workers={SCHED_WORKERS} gave {rep.makespan!r}, "
          f"not the serial {serial.makespan!r} with the same blocks")
    check(not left["children"] and not left["manager_threads"],
          f"{wf.name} {algorithm}: the pool outlived schedule(): {left}")
    return row


def phase_scheduler(smi: str, prefill_rows: dict) -> dict:
    """Phase 29: the paper's scheduler on the card's host, then its plan of
    the port's models against what phases 4 and 12 measured on the card
    (``prefill_rows``: arch -> that phase's row).  Returns the rows, the 14
    schedule reports by (family, algorithm) with their workflows, and
    mixtral_8x7b's two-card plan, for phase 30."""
    platform = default_cluster()
    families, reports = {}, {}
    for family in FAMILIES:
        wf = generate_workflow(family, SCHED_N, seed=SCHED_SEED, platform=platform)
        row = {}
        for algo in ("dag_het_part", "dag_het_mem"):
            row[algo], rep = schedule_row(wf, platform, algo)
            if len(rep.sweep) > 1:      # a pool only where the k' sweep has points to share
                row[algo]["parallel"] = parallel_schedule_row(wf, platform, algo, rep,
                                                              row[algo]["rerun_wall_s"], smi)
            reports[(family, algo)] = (wf, rep)
        check("parallel" in row["dag_het_part"],
              f"{family}: dag_het_part's k' sweep has one point, so no pool ran")
        row["dag_het_mem_over_dag_het_part"] = (row["dag_het_mem"]["makespan"]
                                                / row["dag_het_part"]["makespan"])
        emit("scheduler", family=family, tasks=wf.n, seed=SCHED_SEED, platform=platform.name,
             procs=platform.k, nvidia_smi=smi, **row)
        families[family] = row
    b, s = PREFILL
    shape = ShapeConfig("chip_smoke_prefill", seq_len=s, global_batch=b, kind="prefill")
    one, two = h100_fleet_si({"h100": 1}), h100_fleet_si({"h100": 2})
    plans = {}
    for arch, measured in prefill_rows.items():
        p = plan(get_config(arch), shape, one)
        check(p is not None and p.n_stages == 1 and p.valid,
              f"{arch}: no valid one-stage plan on one H100: {p}")
        measured_s = measured["seconds"][-1]
        row = dict(arch=arch, batch=b, seq=s, cards=1, stages=p.n_stages, valid=p.valid,
                   stage_gb=p.stage_memory[0] / 1e9, stage_gib=p.stage_memory[0] / 2**30,
                   measured_peak_gb=measured["peak_memory_gb"],
                   est_step_s=p.est_step_s, est_bottleneck_s=p.est_bottleneck_s,
                   measured_prefill_s=measured_s, nvidia_smi=smi)
        row["stage_gb_over_measured_peak"] = row["stage_gb"] / row["measured_peak_gb"]
        row["est_step_s_over_measured"] = p.est_step_s / measured_s
        emit("plan", **row)
        plans[arch] = row
    mixtral = get_config("mixtral_8x7b")
    check(plan(mixtral, shape, one) is None, "mixtral_8x7b planned onto one H100")
    wf, _ = build_model_graph(mixtral, shape, microbatches=default_microbatches(shape))
    report = Scheduler(SchedulerConfig()).schedule(wf, one)
    infeas = report.infeasibility
    check(not report.feasible and infeas is not None and bool(infeas.stage)
          and bool(infeas.reason), f"mixtral_8x7b on one H100: {report.infeasibility}")
    p = plan(mixtral, shape, two)
    check(p is not None and p.n_stages == 2 and p.valid,
          f"mixtral_8x7b: no valid two-stage plan on two H100s: {p}")
    row = dict(arch="mixtral_8x7b", batch=b, seq=s,
               one_card={"infeasible_stage": infeas.stage, "reason": infeas.reason,
                         "tightest_gap_gib": (None if infeas.tightest_gap is None
                                              else infeas.tightest_gap / 2**30),
                         "attempts": infeas.attempts},
               two_cards={"stages": p.n_stages, "valid": p.valid,
                          "stage_gib": [m / 2**30 for m in p.stage_memory],
                          "proc_of_stage": p.proc_of_stage, "est_step_s": p.est_step_s},
               nvidia_smi=smi)
    emit("plan_mixtral", **row)
    plans["mixtral_8x7b"] = row
    return {"families": families, "plans": plans, "reports": reports, "mixtral_plan": p}


def wall(fn):
    """``fn()`` and its wall seconds on the host."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def replay_row(wf, rep, smi: str) -> dict:
    """Phase 30 (a): one of phase 29's schedules through the simulator."""
    res = rep.best
    cf, cf_s = wall(lambda: simulate(res))
    check(cf.makespan == cf.analytic_makespan == rep.makespan and cf.exact_anchor,
          f"{wf.name}: the contention-free replay {cf.makespan!r} is not the analytic "
          f"makespan {rep.makespan!r} (exact_anchor {cf.exact_anchor})")
    fs, fs_s = wall(lambda: simulate(res, comm="fair-share"))
    check(fs.makespan >= cf.makespan,
          f"{wf.name}: fair-share {fs.makespan!r} under contention-free {cf.makespan!r}")
    amount, replicas, seed = SIM_JITTER
    jitter = dict(jitter=amount, replicas=replicas, seed=seed, memory=False)
    env, env_s = wall(lambda: simulate(res, **jitter).envelope)
    again = simulate(res, **jitter).envelope
    check(again.makespans == env.makespans, f"{wf.name}: a second jitter replay differs")
    errors, trace_s = wall(lambda: validate_mapping(wf, res, memory_trace=True))
    check(errors == [] and cf.memory.feasible,
          f"{wf.name}: memory trace: {errors[:3]} (feasible {cf.memory.feasible})")
    return dict(makespan=cf.makespan, exact_anchor=cf.exact_anchor,
                fair_share_over_contention_free=fs.makespan / cf.makespan,
                envelope_over_makespan={"lo": env.lo / cf.makespan, "hi": env.hi / cf.makespan,
                                        "mean": env.mean / cf.makespan},
                envelope_rerun_equal=True, memory_trace_violations=len(errors),
                wall_s={"contention_free": cf_s, "fair_share": fs_s,
                        f"jitter_{replicas}": env_s, "memory_trace": trace_s},
                nvidia_smi=smi)


def rescale_row(report) -> dict:
    p, q = report.old_plan, report.new_plan
    infeas = report.infeasibility
    return dict(feasible=report.feasible, stages_before=p and p.n_stages,
                stages_after=q and q.n_stages, valid_after=q and q.valid,
                est_step_before_s=report.est_step_before_s,
                est_step_after_s=report.est_step_after_s, moved_tasks=report.moved_tasks,
                migrations=len(report.timeline.migrations),
                stitched_makespan_s=report.timeline.makespan,
                infeasibility=infeas and {"stage": infeas.stage, "reason": infeas.reason})


def phase_replan(smi: str, llama_prefill: dict, mixtral_plan) -> dict:
    """Phase 30 (b): the port's models replanned after a lost card."""
    b, s = PREFILL
    shape = ShapeConfig("chip_smoke_prefill", seq_len=s, global_batch=b, kind="prefill")
    mixtral, three = get_config("mixtral_8x7b"), h100_fleet_si({"h100": 3})
    rows = {}
    healthy, rows_s = wall(lambda: rescale_plan(mixtral, shape, three, {0}))
    rows["mixtral_3_lose_0"] = dict(rescale_row(healthy), wall_s=rows_s)
    check(healthy.feasible and healthy.old_plan.n_stages == 2
          and healthy.new_plan.n_stages == 2 and healthy.new_plan.valid,
          f"mixtral_8x7b on 3 cards losing {{0}}: {rows['mixtral_3_lose_0']}")
    lost, rows_s = wall(lambda: rescale_plan(mixtral, shape, three, {1, 2}))
    rows["mixtral_3_lose_1_2"] = dict(rescale_row(lost), wall_s=rows_s)
    check(not lost.feasible and lost.old_plan is not None and lost.infeasibility is not None
          and bool(lost.infeasibility.stage) and bool(lost.infeasibility.reason),
          f"mixtral_8x7b on 3 cards losing {{1, 2}}: {rows['mixtral_3_lose_1_2']}")
    at = 0.5 * healthy.est_step_before_s
    mid, rows_s = wall(lambda: rescale_plan(mixtral, shape, three, {0}, at=at,
                                            policy="pinned-warm-start"))
    rows["mixtral_3_lose_0_mid_step"] = dict(rescale_row(mid), wall_s=rows_s, at_s=at,
                                             healthy_est_step_s=healthy.est_step_before_s)
    check(mid.feasible and len(mid.timeline.migrations) == 1 and mid.new_plan.valid,
          f"mixtral_8x7b on 3 cards losing {{0}} mid-step: {rows['mixtral_3_lose_0_mid_step']}")
    llama, rows_s = wall(lambda: rescale_plan(get_config("llama3_8b"), shape,
                                              h100_fleet_si({"h100": 2}), {0}))
    row = dict(rescale_row(llama), wall_s=rows_s)
    check(llama.feasible and llama.new_plan.n_stages == 1 and llama.new_plan.valid,
          f"llama3_8b on 2 cards losing {{0}}: {row}")
    measured_s = llama_prefill["seconds"][-1]
    row.update(stage_gb=llama.new_plan.stage_memory[0] / 1e9,
               measured_peak_gb=llama_prefill["peak_memory_gb"], measured_prefill_s=measured_s)
    row["stage_gb_over_measured_peak"] = row["stage_gb"] / row["measured_peak_gb"]
    row["est_step_s_over_measured"] = llama.est_step_after_s / measured_s
    rows["llama_2_lose_0"] = row
    replays = {comm: simulate(mixtral_plan.mapping, comm=comm, memory=False).makespan
               for comm in ("contention-free", "fair-share")}
    rows["mixtral_2_card_replay"] = dict(est_step_s=mixtral_plan.est_step_s, **replays)
    check(replays["contention-free"] == mixtral_plan.est_step_s
          and replays["fair-share"] >= replays["contention-free"],
          f"mixtral_8x7b's 2-card plan replayed: {rows['mixtral_2_card_replay']}")
    for name, row in rows.items():
        emit("replan", case=name, batch=b, seq=s, nvidia_smi=smi, **row)
    return rows


def phase_elastic_example() -> dict:
    """Phase 30 (c): ``examples/elastic_serving_torch.py`` on the card, as
    a process of its own with its own time limit: it must exit 0 and print
    the migration, the stitched Gantt and its prefill's flash launches."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    argv = [sys.executable, str(ROOT / "examples" / "elastic_serving_torch.py")]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=ELASTIC_EXAMPLE_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    found = re.search(r"^flash launches: (\{.*\})$", proc.stdout, re.MULTILINE)
    launches = json.loads(found.group(1).replace("'", '"')) if found else None
    row = dict(argv=["examples/elastic_serving_torch.py"], rc=proc.returncode, wall_s=wall_s,
               flash_launches=launches, migration=re.findall(r"^migration: .*$", proc.stdout,
                                                             re.MULTILINE),
               stdout_tail=proc.stdout[-1200:], stderr_tail=proc.stderr[-800:])
    emit("elastic_example", **row)
    check(proc.returncode == 0 and row["migration"] and "▼" in proc.stdout
          and "first token agrees with the prefill: True" in proc.stdout
          and bool(launches) and sum(launches.values()) > 0,
          f"examples/elastic_serving_torch.py on the card: {row}")
    return row


def phase_sim(smi: str, sched: dict, llama_prefill: dict) -> dict:
    """Phase 30: phase 29's schedules replayed (a), the port's models
    replanned after a lost card (b), the elastic example on the card (c)."""
    replays = {}
    for (family, algo), (wf, rep) in sched["reports"].items():
        replays[(family, algo)] = row = replay_row(wf, rep, smi)
        emit("sim_replay", family=family, algorithm=algo, **row)
    return {"replays": replays,
            "replan": phase_replan(smi, llama_prefill, sched["mixtral_plan"]),
            "example": phase_elastic_example()}


def identity_anchor(best, platform) -> dict:
    """One instance at 0 through the pipelined replay against ``simulate``
    of the same mapping: makespan and horizon to the bit."""
    ref = simulate(best)
    solo = simulate_pipelined(best, platform, arrivals=[0.0])
    row = dict(single_makespan=solo.single_makespan, horizon=solo.horizon,
               simulate_makespan=ref.makespan, simulate_horizon=ref.horizon)
    row["bit_equal"] = (solo.single_makespan == ref.makespan and solo.horizon == ref.horizon
                        and solo.instances[0].finish == solo.horizon)
    check(row["bit_equal"], f"identity anchor: {row}")
    return row


def throughput_row(family: str, wf, platform, smi: str) -> tuple[dict, object]:
    """Phase 31 (a): one of phase 29's workflows planned for sustained
    traffic and replayed with 64 instances in flight."""
    tr, plan_s = wall(lambda: plan_throughput(wf, platform))
    check(tr.feasible, f"{family}: plan_throughput infeasible: {tr.report.infeasibility}")
    anchor = identity_anchor(tr.best, platform)
    offered = THROUGHPUT_LOAD * tr.rate
    replay = lambda: simulate_pipelined(tr.best, platform, rate=offered,  # noqa: E731
                                        n_instances=THROUGHPUT_INSTANCES, seed=THROUGHPUT_SEED)
    rep, replay_s = wall(replay)
    again = replay()
    rerun_equal = json.dumps(again.to_dict()) == json.dumps(rep.to_dict())
    check(rerun_equal, f"{family}: a second pipelined replay differs")
    violations = len(rep.memory.violations)
    expected = PIPELINED_VIOLATIONS.get(family, 0)
    check(violations == expected and rep.memory.feasible == (violations == 0),
          f"{family}: {violations} memory violations over {THROUGHPUT_INSTANCES} instances, "
          f"the reference counts {expected}")
    lat = sorted(rep.latencies)
    row = dict(tasks=wf.n, rate=tr.rate, replicas=tr.plan.n_replicas, k_prime=tr.k_prime,
               period=tr.plan.period, latency=tr.latency, plan_wall_s=plan_s,
               identity_anchor=anchor, instances=THROUGHPUT_INSTANCES,
               replayed_tasks=THROUGHPUT_INSTANCES * wf.n, offered=offered,
               achieved=rep.achieved_rate, achieved_over_offered=rep.achieved_rate / offered,
               p50=rep.percentile_latency(50), p99=rep.percentile_latency(99),
               max_latency=lat[-1], horizon=rep.horizon, memory_feasible=rep.memory.feasible,
               memory_violations=violations, rerun_equal=rerun_equal, replay_wall_s=replay_s,
               nvidia_smi=smi)
    return row, tr


def phase_throughput_families(smi: str) -> dict:
    """Phase 31 (a): the seven families, then genome's saturation ladder."""
    platform = default_cluster()
    rows, genome = {}, None
    for family in FAMILIES:
        wf = generate_workflow(family, SCHED_N, seed=SCHED_SEED, platform=platform)
        rows[family], tr = throughput_row(family, wf, platform, smi)
        emit("throughput", family=family, platform=platform.name, **rows[family])
        if family == "genome":
            genome = tr
    sweep, sweep_s = wall(lambda: saturation_sweep(
        genome.best, platform, plan=genome.plan, rates=[f * genome.rate for f in SATURATION_RUNGS],
        n_instances=THROUGHPUT_INSTANCES))
    got = [tuple(r[k] for k in ("offered", "achieved", "p50", "p99", "saturated")) for r in sweep]
    ratios = [r["achieved"] / r["offered"] for r in sweep]
    row = dict(family="genome", rungs=list(SATURATION_RUNGS), rows=sweep,
               achieved_over_offered=ratios, equal_to_reference=got == GENOME_SATURATION,
               wall_s=sweep_s, nvidia_smi=smi)
    emit("saturation", **row)
    check(got == GENOME_SATURATION, f"genome's saturation rows differ from the reference's: {got}")
    check(all(a > b for a, b in zip(ratios, ratios[1:])),
          f"achieved over offered does not fall rung to rung: {ratios}")
    rows["saturation"] = row
    return rows


def phase_throughput_models(smi: str, llama_prefill: dict) -> dict:
    """Phase 31 (b): the port's models replicated on four H100s, and
    llama3_8b's sustained stream planned cold, then seeded from the cache."""
    b, s = PREFILL
    shape = ShapeConfig("chip_smoke_prefill", seq_len=s, global_batch=b, kind="prefill")
    fleet = h100_fleet_si(THROUGHPUT_FLEET)
    rows, graphs = {}, {}
    for arch, replicas in THROUGHPUT_REPLICAS.items():
        wf, _ = build_model_graph(get_config(arch), shape,
                                  microbatches=default_microbatches(shape))
        graphs[arch] = wf
        tr, plan_s = wall(lambda: plan_throughput(wf, fleet))
        check(tr.feasible and tr.plan.n_replicas == replicas,
              f"{arch} on {fleet.k} H100s: {tr.plan and tr.plan.n_replicas} replicas, "
              f"not {replicas}")
        rows[arch] = dict(arch=arch, batch=b, seq=s, cards=fleet.k, tasks=wf.n,
                          replicas=tr.plan.n_replicas, k_prime=tr.k_prime,
                          stages=len(tr.plan.groups[0].procs), period_s=tr.plan.period,
                          rate_per_s=tr.rate, makespan_s=tr.best.makespan, plan_wall_s=plan_s,
                          identity_anchor=identity_anchor(tr.best, fleet), nvidia_smi=smi)
    llama = rows["llama3_8b"]
    measured_s = llama_prefill["seconds"][-1]
    llama["measured_prefill_s"] = measured_s
    llama["rate_over_measured"] = llama["rate_per_s"] / (fleet.k / measured_s)
    cache, runs = PlanCache(), {}
    for path in ("cold", "seeded"):
        rep, run_s = wall(lambda: run_sustained(
            graphs["llama3_8b"], fleet, rate=THROUGHPUT_LOAD * llama["rate_per_s"],
            n_instances=THROUGHPUT_INSTANCES, seed=THROUGHPUT_SEED, cache=cache))
        check(rep.jobs[0].planning_path == path and len(rep.jobs) == THROUGHPUT_INSTANCES
              and all(j.status == "completed" for j in rep.jobs)
              and rep.pipelined.memory.feasible,
              f"llama3_8b sustained run {path}: {rep.jobs[0].planning_path}, "
              f"{len(rep.jobs)} jobs")
        runs[path] = rep
        rows[f"sustained_{path}"] = dict(
            arch="llama3_8b", planning_path=path, instances=len(rep.jobs),
            offered_per_s=THROUGHPUT_LOAD * llama["rate_per_s"],
            achieved_per_s=rep.instances_per_s, latency_s=rep.instance_latency_percentiles,
            plan_wall_s=rep.plan_wall_s, wall_s=run_s,
            cache_stats={k: v for k, v in rep.cache_stats.items() if k.startswith("service")},
            nvidia_smi=smi)
    timings = lambda rep: [(j.arrival_t, j.dispatch_t, j.finish_t) for j in rep.jobs]  # noqa: E731
    same = timings(runs["cold"]) == timings(runs["seeded"])
    rows["sustained_seeded"]["instance_timings_equal_to_cold"] = same
    check(same, "llama3_8b: the seeded sustained run's instance timings differ from the cold run's")
    for name, row in rows.items():
        emit("throughput_model", case=name, **row)
    return rows


def service_run(obs=None, workers: int = 1):
    """Phase 31 (c)'s service run: the seven families twice each, two
    malformed payloads, a failure while a job runs and a later arrival."""
    platform = default_cluster()
    config = ServiceConfig(
        scheduler=SchedulerConfig(simulate=True, kprime=SERVICE_KPRIME, workers=workers),
        quotas=QuotaConfig(tenants={"alice": TenantQuota(weight=2.0),
                                    "bob": TenantQuota(max_running=1)}),
        name="chip_smoke", obs=obs)
    subs = []
    for i, family in enumerate(FAMILIES):
        wf = generate_workflow(family, SCHED_N, seed=SCHED_SEED, platform=platform)
        subs.append(Submission(wf, tenant="alice", arrival_t=SERVICE_SPACING * i, name=family))
        subs.append(Submission(wf, tenant="bob", arrival_t=SERVICE_SPACING * (i + 0.5),
                               name=family))
    subs += [Submission("{definitely not json", tenant="mallory", arrival_t=1.0, name="junk"),
             Submission('{"workflow": {"specification": {"tasks": []}}}', tenant="mallory",
                        arrival_t=2.0, name="hollow")]
    events = [ProcFailure(time=SERVICE_FAILURE_T, procs={platform.k - 2, platform.k - 1}),
              ProcArrival(time=SERVICE_ARRIVAL_T, procs=(Processor("spare-0", 2.5, 192.0),))]
    return subs, run_service(subs, platform, events, config)


#: histograms whose observations are wall-clock seconds
WALL_HISTOGRAMS = ("service_plan_latency_s", "sched_sweep_point_s")
#: the sweep's counters that a pooled run counts apart from a serial one:
#: each pool worker keeps its own memo, where the serial sweep shares one,
#: so Steps 1 and 2 do other work for the same decisions
SWEEP_WORK_COUNTERS = ("step1_moves", "step1_passes", "step1_scalar_calls",
                       "step2_flat_blocks", "step2_memo_hits", "step2_memo_misses",
                       "step2_scalar_blocks")


def untimed_service(rep) -> dict:
    """``ServiceReport.to_json()`` with the wall-clock fields set aside, as
    the port's parity tests compare it: ``total_time_s``, each planning
    call's seconds (the paths and the number of calls stay) and the
    wall-clock histograms, of which only the count stays.  A copy of
    ``tests/_torch_parity.untimed_service_json`` (this script imports no
    test module): keep the two in step."""
    d = json.loads(rep.to_json())
    d["total_time_s"] = 0.0
    d["plan_wall_s"] = {k: [0.0] * len(v) for k, v in d["plan_wall_s"].items()}
    hists = d["metrics"].get("histograms", {})
    for name in WALL_HISTOGRAMS:
        if name in hists:
            hists[name] = {"count": hists[name]["count"]}
    return d


def pool_neutral(d: dict) -> dict:
    """``d``, an ``untimed_service`` dict, with what a pooled run may
    count apart from a serial one set aside: ``SWEEP_WORK_COUNTERS`` and
    each histogram's ``min``, ``max`` and ``sum`` (a report's histogram is
    a delta of the process's running one, so its sum can round apart in
    the last bit, and a pool worker's delta carries its earlier
    observations, as ``_pool_neutral`` in the throughput parity tests
    says).  Everything else must be equal."""
    for name in SWEEP_WORK_COUNTERS:
        d["cache_stats"].pop(name, None)
    for hist in d["metrics"].get("histograms", {}).values():
        for field in ("min", "max", "sum"):
            hist.pop(field, None)
    return d


def phase_service(smi: str) -> dict:
    """Phase 31 (c): the service at the paper's size, run three times, then
    once with a parallel k' sweep (``SERVICE_WORKERS``)."""
    (subs, rep), run_s = wall(service_run)
    (_, again), rerun_s = wall(service_run)
    (_, traced), traced_s = wall(lambda: service_run(ObsConfig(enabled=True)))
    (_, pooled), pooled_s = wall(lambda: service_run(workers=SERVICE_WORKERS))
    pooled_left = pool_leftovers()
    serial_d, pooled_d = untimed_service(rep), untimed_service(pooled)
    pooled_differs = sorted(k for k in serial_d if serial_d[k] != pooled_d.get(k))
    pooled_equal = pool_neutral(serial_d) == pool_neutral(pooled_d)
    jobs = rep.jobs
    terminal = ("completed", "infeasible", "rejected")
    statuses = {s: sum(j.status == s for j in jobs) for s in terminal}
    accounted = len(jobs) == len(subs) and sum(statuses.values()) == len(subs)
    replans = [e for e in rep.trace.log if e["kind"] == "replan"]
    hits = rep.cache_stats.get("service_cache_hits", 0)
    trace = rep.trace.to_json()
    row = dict(submissions=len(subs), statuses=statuses, accounted_once=accounted,
               rejections=[j.rejection["code"] for j in jobs if j.status == "rejected"],
               planning_paths={p: sum(j.planning_path == p for j in jobs)
                               for p in ("cold", "seeded")},
               replans=[(e["t"], e["job"], e["path"]) for e in replans],
               cache_stats={k: v for k, v in rep.cache_stats.items() if k.startswith("service")},
               horizon=rep.trace.horizon, utilization=rep.utilization,
               rerun_trace_equal=again.trace.to_json() == trace,
               traced_trace_equal=traced.trace.to_json() == trace, spans=len(traced.spans),
               plan_wall_s={path: {"calls": len(v), "sum": sum(v), "mean": sum(v) / len(v),
                                   "max": max(v)} for path, v in rep.plan_wall_s.items()},
               pooled={"workers": SERVICE_WORKERS,
                       "trace_equal": pooled_d["trace"] == serial_d["trace"],
                       "untimed_report_keys_that_differ": pooled_differs,
                       "report_equal_but_sweep_work_and_histogram_sums": pooled_equal,
                       "plan_wall_s_sum": sum(sum(v) for v in pooled.plan_wall_s.values()),
                       "left_after": pooled_left},
               wall_s={"run": run_s, "rerun": rerun_s, "traced": traced_s,
                       "pooled": pooled_s, "pooled_over_rerun": pooled_s / rerun_s},
               nvidia_smi=smi)
    emit("service", **row)
    check(accounted and statuses["rejected"] == 2 and statuses["infeasible"] == 0,
          f"service: the {len(subs)} submissions end as {statuses}")
    check(hits >= 1, f"service: no plan-cache hit ({row['cache_stats']})")
    check(any(e["t"] == SERVICE_FAILURE_T and e["path"] == "warm" for e in replans),
          f"service: no warm replan at the failure ({row['replans']})")
    check(row["rerun_trace_equal"] and row["traced_trace_equal"] and row["spans"] > 0,
          "service: the trace differs on a rerun or with tracing on")
    check(row["pooled"]["trace_equal"] and pooled_equal,
          f"service: workers={SERVICE_WORKERS} differs from the serial run beyond "
          f"the sweep's work counters and the histograms' sums in {pooled_differs}")
    check(not pooled_left["children"] and not pooled_left["manager_threads"],
          f"service: a pool outlived run_service(): {pooled_left}")
    return row


def phase_host_examples() -> dict:
    """Phase 31 (d): the three host-only examples, each a process of its own
    with its own time limit."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    rows = {}
    for script, expect in HOST_EXAMPLES.items():
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "examples" / script)], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=HOST_EXAMPLE_TIMEOUT_S)
        rows[script] = row = dict(rc=proc.returncode, wall_s=time.perf_counter() - t0,
                                  lines=len(proc.stdout.splitlines()),
                                  stdout_tail=proc.stdout[-600:], stderr_tail=proc.stderr[-800:])
        emit("host_example", script=f"examples/{script}", **row)
        check(proc.returncode == 0 and expect in proc.stdout, f"examples/{script}: {row}")
    return rows


def phase_throughput(smi: str, llama_prefill: dict) -> dict:
    """Phase 31: the seven families (a), the port's models on four cards
    (b), the service at the paper's size (c), the host-only examples (d)."""
    return {"families": phase_throughput_families(smi),
            "models": phase_throughput_models(smi, llama_prefill),
            "service": phase_service(smi),
            "examples": phase_host_examples()}


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def backward_row(main_row: dict, checks: list, variant: str, launches: int, path: str,
                 at: str = "") -> dict:
    """The kernels-line entry of one backward kernel: errors over the
    phase-8 rows it served, times at the training shape in the dtype it
    serves there; ``at`` names the arch of another layer shape (a second
    entry)."""
    mine = [r for r in checks if r["backward_kernel"] == variant]
    row = {
        "name": f"flash_attention_bwd[{variant}]" + (f"@{at}" if at else ""),
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
        "kernel_windows_ms": main_row["kernel_windows_ms"],
        "library_windows_ms": main_row["library_windows_ms"],
        "library_device_ms": main_row["library_device_ms"],
        "kernel_device_ms": main_row["kernel_device_ms"],
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


def window_entry(kind: str, variant: str, timed_row: dict, checks: list, launches: int,
                 path: str, long: dict | None = None) -> dict:
    """The kernels-line entry of one kernel under mixtral_8x7b's sliding
    window: errors over the windowed rows of phase 2 (forward) or 8
    (backward) it served, times at ``WINDOW_SHAPE`` beside the same call
    without a window, SDPA with a boolean mask as the library call."""
    key = "variant" if kind == "flash_attention_bhsd" else "backward_kernel"
    mine = [r for r in checks if r[key] == variant]
    row = {
        "name": f"{kind}[{variant}]@mixtral_8x7b+window",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "replaces_note": ("with the JAX model's sliding window "
                          "(src/repro/models/attention.py:79), which that kernel lacks"),
        "launches": launches,
        "launches_counted_on": path,
        "mask": "causal+window",
        "window": MIXTRAL_WINDOW,
        "max_abs_err": max(r["max_abs_err"] for r in mine),
        "max_abs_err_by_dtype": {d: max(r["max_abs_err"] for r in mine if r["dtype"] == d)
                                 for d in TOL if any(r["dtype"] == d for r in mine)},
        "tol": {d: {"atol": a, "rtol": r} for d, (a, r) in TOL.items()},
        "limit_ratio": max(r["limit_ratio"] for r in mine),
        "fault_limit_ratio_min": min(r["fault_limit_ratio"] for r in mine),
        "window_ge_s_bit_equal": all(r["window_ge_s_bit_equal"] for r in mine),
        "checked": sorted({(*r["shape"], r["window"], r["causal"]) for r in mine}),
        "ms": timed_row["kernel_ms"],
        "plain_ms": timed_row["plain_ms"],
        "bound_ms": timed_row["bound_ms"],
        "bound_by": timed_row["bound_by"],
        "library_ms": timed_row["library_ms"],
        "library": "scaled_dot_product_attention with a boolean attn_mask of the window",
        "ms_no_window": timed_row["kernel_no_window_ms"],
        "bound_no_window_ms": timed_row["bound_no_window_ms"],
        "bound_share": timed_row["bound_share"],
        "kernel_over_library": timed_row["kernel_over_library"],
        "shape": timed_row["shape"],
        "dtype": timed_row["dtype"],
    }
    if long is not None:
        row.update({f"at_{long['shape'][1]}_{k}": long[k] for k in (
            "max_abs_err", "limit_ratio", "fault_limit_ratio", "kernel_ms",
            "kernel_no_window_ms", "plain_ms", "plain_block_rows", "bound_ms",
            "bound_no_window_ms", "bound_share")})
        row["max_abs_err"] = max(row["max_abs_err"], long["max_abs_err"])
        row["max_abs_err_by_dtype"]["bf16"] = max(row["max_abs_err_by_dtype"]["bf16"],
                                                  long["max_abs_err"])
        row["limit_ratio"] = max(row["limit_ratio"], long["limit_ratio"])
        row["fault_limit_ratio_min"] = min(row["fault_limit_ratio_min"],
                                           long["fault_limit_ratio"])
        row["checked"].append((*long["shape"], long["window"], long["causal"]))
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
    wkv_bwd_timed, wkv_bwd_checks = phase_wkv_backward()
    # phases 2 and 8's windowed calls, after the WKV phases' profiler windows
    window_timed, window_checks = phase_kernel_window()
    bwd_window_timed, bwd_window_checks = phase_backward_window()
    free()
    adamw = phase_adamw()

    cfg = get_config("llama3_8b")
    model = LM(cfg, seed=SEED, device="cuda")        # bf16, full depth
    llama_prefill = phase_prefill(model)
    cuda_core_launches = phase_consistency(cfg)
    phase_serve(model)
    phase_profile(model)
    phase_kv_int8(model)
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
    phase_rwkv_gradients(rwkv_cfg)
    torch.cuda.empty_cache()
    train = counting_adamw("train", phase_train, cfg)
    torch.cuda.empty_cache()
    rwkv_train = counting_adamw("rwkv_train", phase_rwkv_train, rwkv_cfg)
    torch.cuda.empty_cache()
    trainer = counting_adamw("trainer", phase_trainer)
    torch.cuda.empty_cache()

    olmoe_cfg = get_config("olmoe_1b_7b")
    model = LM(olmoe_cfg, seed=SEED, device="cuda")  # bf16, full depth
    olmoe_prefill = phase_olmoe(model)
    del model
    torch.cuda.empty_cache()
    olmoe_launches = phase_main_path("olmoe_1b_7b")
    torch.cuda.empty_cache()
    olmoe_train = counting_adamw("olmoe_train", phase_olmoe_train, olmoe_cfg)
    torch.cuda.empty_cache()
    phase_consistency(olmoe_cfg, capacity_factor=16.0)
    torch.cuda.empty_cache()
    phase_gradients(olmoe_cfg)
    torch.cuda.empty_cache()
    mixtral = phase_mixtral(get_config("mixtral_8x7b"))
    free()
    mixtral_window = counting_adamw("mixtral_window", phase_mixtral_window,
                                    get_config("mixtral_8x7b"))
    free()

    jamba_cfg = get_config("jamba_15_large")
    jamba = phase_jamba(jamba_cfg)
    free()
    phase_consistency(jamba_cfg, capacity_factor=16.0, **JAMBA_F32_CUT)
    free()
    vision_cfg = get_config("llama32_vision_90b")
    vision = phase_vision(vision_cfg)
    free()
    phase_consistency(vision_cfg, **VISION_F32_CUT)
    free()
    seamless_cfg = get_config("seamless_m4t_v2")
    phase_seamless(seamless_cfg)
    free()
    seamless_masks = {"wgmma/full": 2 * seamless_cfg.n_encoder_layers,
                      "wgmma/causal": seamless_cfg.n_layers}
    seamless_launches = phase_main_path("seamless_m4t_v2", masks=seamless_masks)
    free()
    seamless_train = counting_adamw("seamless_train", phase_seamless_train, seamless_cfg)
    free()
    phase_gradients(seamless_cfg, **SEAMLESS_F32_CUT)
    free()

    # the step builders on a mesh of one, then the two training cuts
    mesh = make_local_mesh(1, 1)
    model, steps_prefill = phase_steps_prefill(cfg, mesh)
    steps_decode = phase_steps_decode(model, mesh)
    del model
    free()
    steps_train = counting_adamw("steps_train", phase_steps_train, cfg, mesh,
                                 train["remat"]["full"]["step_s"])
    free()
    steps_rwkv = counting_adamw("steps_rwkv_train", phase_steps_rwkv_train, rwkv_cfg, mesh,
                                rwkv_train["remat"]["full"]["step_s"])
    free()
    jamba_train = counting_adamw("jamba_train", phase_jamba_train, jamba_cfg)
    free()
    vision_train = counting_adamw("vision_train", phase_vision_train, vision_cfg)
    free()
    # the dry run against phases 20-22, both --production flags, GPipe
    dry_steps = phase_dryrun_steps(cfg, steps_prefill, steps_decode, steps_train)
    free()
    production = phase_production_dryrun()
    pipeline = phase_pipeline(cfg)
    free()
    phase_train_lm_example()
    sched = phase_scheduler(smi, {"llama3_8b": llama_prefill, "olmoe_1b_7b": olmoe_prefill})
    phase_sim(smi, sched, llama_prefill)
    phase_throughput(smi, llama_prefill)

    olmoe, jamba_id, vision_id, seamless = ("olmoe_1b_7b", "jamba_15_large",
                                            "llama32_vision_90b", "seamless_m4t_v2")
    heads = lambda *shape: [r for r in checks if r["shape"][2:] == list(shape)]  # noqa: E731
    seamless_row = flash_row(timed[(seamless, "bf16", False)], heads(16, 16, 64), "wgmma",
                             seamless_launches,
                             "serve.main --arch seamless_m4t_v2 --full-size (two encodings: "
                             "the prefill's and greedy_decode's; one decoder prefill)",
                             at=seamless)
    causal_row = timed[(seamless, "bf16", True)]
    seamless_row["mask"] = "full (the encoder's); causal_* keys: the decoder's"
    seamless_row.update({f"causal_{key}": causal_row[key] for key in (
        "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "bound_share")})
    kernels = [flash_row(timed[("llama3_8b", "bf16", True)], checks, "wgmma", launches,
                         "every llama3_8b prefill (serve.main --full-size)"),
               flash_row(timed[("llama3_8b", "f32", True)], checks, "cuda_core",
                         cuda_core_launches, "the 4-layer f32 prefill of phase 5"),
               flash_row(timed[(olmoe, "bf16", True)], heads(16, 16, 128), "wgmma",
                         olmoe_launches,
                         "every olmoe_1b_7b prefill (serve.main --arch olmoe_1b_7b --full-size)",
                         at=olmoe),
               flash_row(timed[(jamba_id, "bf16", True)], heads(64, 8, 128), "wgmma",
                         jamba["prefill"]["launches_per_call"][-1]["wgmma"],
                         f"every jamba_15_large prefill ({JAMBA_CUT['n_layers']} layers, one "
                         f"of them attention)", at=jamba_id),
               flash_row(timed[(jamba_id, "bf16", True)], heads(64, 8, 128), "wgmma",
                         vision["prefill"]["launches_per_call"][-1]["wgmma"],
                         f"every llama32_vision_90b prefill ({VISION_CUT['n_layers']} layers; "
                         f"its cross-attention launches none)", at=vision_id),
               seamless_row]
    main_decode = (RWKV_MAIN_PATH[0], 1, *WKV_MAIN[2:])
    kernels += [wkv_row(wkv_timed["bf16"], wkv_checks, "chunked", wkv_launches["chunked"],
                        "every rwkv6_1b6 bf16 prefill (serve.main --full-size)"),
                wkv_row(wkv_timed[("decode", main_decode[0])], wkv_checks, "sequential",
                        wkv_launches["sequential"],
                        "every rwkv6_1b6 decode step (serve.main --full-size)",
                        at_prefill_ms=wkv_timed["bf16"]["sequential_kernel_ms"],
                        decode_batch4=wkv_timed[("decode", WKV_DECODE[0])])]
    kernels += [backward_row(bwd_timed[("llama3_8b", "bf16")], bwd_checks, "backward_wgmma",
                             train["launches"]["backward_wgmma"],
                             f"every full-width llama3_8b train step ({TRAIN_LAYERS} "
                             f"layers, {TRAIN_STEPS} steps of Trainer.step_fn)"),
                backward_row(bwd_timed[("llama3_8b", "f32")], bwd_checks, "backward",
                             grad_launches, "the 4-layer f32 loss gradient of phase 9"),
                backward_row(bwd_timed[(olmoe, "bf16")],
                             [r for r in bwd_checks if r["shape"][2:] == [16, 16, 128]],
                             "backward_wgmma", olmoe_train["launches"]["backward_wgmma"],
                             f"every full-width olmoe_1b_7b train step ({OLMOE_TRAIN_LAYERS} "
                             f"layers, {TRAIN_STEPS} steps of Trainer.step_fn)", at=olmoe),
                backward_row(bwd_timed[(seamless, "bf16")],
                             [r for r in bwd_checks if r["shape"][2:] == [16, 16, 64]],
                             "backward_wgmma", seamless_train["launches"]["backward_wgmma"],
                             f"every seamless_m4t_v2 train step (whole, {TRAIN_STEPS} steps of "
                             f"Trainer.step_fn; half of them non-causal)", at=seamless),
                wkv_bwd_row(wkv_bwd_timed["bf16"], wkv_bwd_checks, "backward_chunked",
                            rwkv_train["launches"]["backward_chunked"],
                            f"every full-width rwkv6_1b6 train step ({rwkv_cfg.n_layers} "
                            f"layers, {TRAIN_STEPS} steps of Trainer.step_fn)"),
                wkv_bwd_row(wkv_bwd_timed["bf16"], wkv_bwd_checks, "backward",
                            trainer["rwkv_main"]["wkv_launches"]["backward"],
                            "launch.train.main --arch rwkv6_1b6 (smoke config, f32) of "
                            "phase 11")]
    # launches of each kernel on the step builders' paths and the new
    # training cuts, each read just after its own run
    per_call = lambda rows: rows[-1]  # noqa: E731
    entry = lambda name: next(k for k in kernels if k["name"] == name)  # noqa: E731
    entry("flash_attention_bhsd[wgmma]")["launches_on_step_paths"] = {
        "steps_prefill (llama3_8b, one call)": per_call(steps_prefill["launches_per_call"])["wgmma"],
        "steps_train (llama3_8b 8 layers, one step, remat full)":
            steps_train["grad_accum_1"]["launches"][-1]["wgmma"],
        "steps_train grad_accum 2 (one step)": steps_train["grad_accum_2"]["launches"][-1]["wgmma"],
        "steps_decode (one step)": steps_decode["flash_launches"],
        f"vision_train ({TRAIN_STEPS} steps)": vision_train["launches"]["wgmma"],
        f"pipeline (llama3_8b {TRAIN_LAYERS} layers, one stage, {PIPELINE_MICROBATCHES} "
        f"microbatches, one call)": pipeline["launches"]["wgmma"]}
    entry("flash_attention_bhsd[wgmma]")["launches_predicted_by_dry_run"] = {
        f"{name} (mesh of one)": row["predicted_launches"] for name, row in dry_steps.items()}
    entry("flash_attention_bhsd[wgmma]")["launches_predicted_by_production_dry_run"] = {
        f"{name} ({row['cell']['arch']} {row['cell']['shape']}, 16 x 16, per rank)":
            row["cell"]["kernel_launches"] for name, row in production.items()}
    # the windowed calls: mixtral_8x7b's 32k prefill, its f32 check, its
    # training step
    long_prefill = mixtral["long_prefill"]["mask_launches_per_call"][-1]
    kernels += [
        window_entry("flash_attention_bhsd", "wgmma", window_timed["bf16"], window_checks,
                     long_prefill["wgmma/causal+window"],
                     f"mixtral_8x7b's prefill of {MIXTRAL_LONG_PREFILL[0]} x "
                     f"{MIXTRAL_LONG_PREFILL[1]} ({MIXTRAL_LAYERS} layers, one call)",
                     long=window_timed["long"]),
        window_entry("flash_attention_bhsd", "cuda_core", window_timed["f32"], window_checks,
                     mixtral_window["f32"]["mask_launches"]["cuda_core/causal+window"],
                     f"mixtral_8x7b's f32 prefill of 1 x {WINDOW_SHAPE[1]} "
                     f"({MIXTRAL_F32_LAYERS} layers) of phase 15"),
        window_entry("flash_attention_bwd", "backward_wgmma", bwd_window_timed["bf16"],
                     bwd_window_checks,
                     mixtral_window["train"]["mask_launches"]["backward_wgmma/causal+window"],
                     f"one mixtral_8x7b train step ({MIXTRAL_TRAIN_LAYERS} layer, 1 x "
                     f"{WINDOW_SHAPE[1]})"),
        window_entry("flash_attention_bwd", "backward", bwd_window_timed["f32"],
                     bwd_window_checks, 0,
                     "no main path (phase 8 only): no path here trains with a window in f32")]
    entry("flash_attention_bwd[backward_wgmma]")["launches_on_step_paths"] = {
        "steps_train (one step)": steps_train["grad_accum_1"]["launches"][-1]["backward_wgmma"],
        "steps_train grad_accum 2 (one step)":
            steps_train["grad_accum_2"]["launches"][-1]["backward_wgmma"],
        f"vision_train ({TRAIN_STEPS} steps)": vision_train["launches"]["backward_wgmma"],
        f"jamba_train ({TRAIN_STEPS} steps)": sum(jamba_train["launches"].values())}
    entry("wkv_bhsd[chunked]")["launches_on_step_paths"] = {
        "steps_rwkv_train (rwkv6_1b6, one step, remat full)": steps_rwkv["launches"][-1]["chunked"]}
    entry("wkv_bhsd_bwd[backward_chunked]")["launches_on_step_paths"] = {
        "steps_rwkv_train (one step)": steps_rwkv["launches"][-1]["backward_chunked"]}
    kernels += adamw_rows(adamw)
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
