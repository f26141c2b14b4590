#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the build of every CUDA kernel from ``csrc/`` (one nvcc
   per source, all started together).
2. Kernel phase: each kernel against its plain PyTorch version.
   ``hot_gather`` against ``index_select`` too, on the reference's test
   shapes and the serving path's shape, and with duplicate hot ids (Hn
   40, the first match wins) under half-cold traffic, bit for bit.
   ``ssd_scan`` on
   the reference's four test shapes (f32 and bf16, that test's
   tolerances), a G = 2 case and the mamba2-1.3b serving shape with a
   non-zero initial state (tolerance stated at ``SSD_TOL``), plus equal
   bits for a None and a zero initial state and from call to call.
   ``flash_attention`` on the reference's six test shapes in f32 and
   bf16 (that test's tolerances, ``FA_TOL``), a gemma2-shaped case (D 256,
   GQA 16/8, window, softcap), the split-K decode path at gemma2's decode
   shape and at G * Sq = 8 x 4, a wgmma prefill whose rows are not a
   multiple of 128, a strided cache slice equal to its copy bit for bit,
   and equal bits from call to call; each case names the kernel path it
   took.  Before it, the count of ``HGMMA`` and ``UTMALDG`` instructions
   per ``flash_attention`` path in the built library's SASS
   (``cuobjdump -sass``): the wgmma prefill must hold both; so must
   ``flash_attention_bwd``'s wgmma dk / dv and dq kernels, whose
   registers and spills (``-Xptxas -v``) it prints beside them.
3. Serving phase at full width (the widths of
   ``src/repro/configs/phi3p5_moe.py``; 2 layers instead of 32, because
   f32 params at 32 layers do not fit one card): generic steps, a
   blocking recompile, specialized steps.  The plan must hold
   ``hot_cache`` at ``vocab_embed#0`` and ``moe_fastpath`` on ``router``,
   the kernels must have been launched by the specialized steps, the
   specialized output must equal the generic oracle bit for bit, a
   control update must deopt, and a second recompile must restore the
   plan.
3b. Frontend phase over the serving phase's params (no copy): a fresh
   specialized runtime and a fresh generic oracle (the DeadCodePass-only
   registry of the conformance harness).  ``step_many`` at K 1, 2, 4
   beside ``step`` on full buckets of 8 and 16 (ms per step); then
   ``ServingFrontend`` on its batcher thread under an ``OpenLoopDriver``:
   384 requests of Poisson arrivals at half the measured capacity C
   (16 requests over the bucket-16 K-1 step time), a blocking recompile
   from the arrival profile, 384 more under ON/OFF arrivals.  Per run it
   prints offered and achieved req/s, the request accounting, SLO
   attainment, latency quantiles, windows by (bucket, K), the pad share
   and locked stats calls per window.  It fails unless every request is
   accounted with none failed, the recompiled plan holds ``hot_cache``
   at ``vocab_embed#0``, ``moe_fastpath`` and the
   ``__frontend__#batch_shape`` site, ``hot_gather`` launched, and every
   call the runtime ran, replayed on the oracle, gives equal outputs
   and tables bit for bit.
3c. Chaos phase over the same params: a fresh specialized runtime under
   a controller with the chaos harness's health knobs, and a generic
   oracle.  One arc per fault kind: a step fault and a device loss (the
   faulted batch retried on the degraded plane), a failed recompile
   (the scheduler's retry lands while serving goes on) and a straggler
   stall (a StragglerMonitor fed real step times, then a 10x stall).
   Each degraded arc serves 8 degraded steps (no ``hot_gather``
   launch), recovers through ``controller.schedule`` + ``drain`` and
   serves 8 specialized steps (``hot_gather`` launched); every step
   equals the oracle's bit for bit.  Then one open-loop run of 192
   requests at 0.5 C through the frontend with a window fault armed
   mid-run: every request accounted, the faulted window's requests
   failed with ``PLANE_FAULT``, rejections ``PLANE_DEGRADED`` until the
   recovery, every window replayed on the oracle bit for bit.
3d. ``launch.serve.run_serve`` at the same widths (fuse 4, inflight 2)
   and ``launch.serve.main`` at its default config, on the card.
4. Arch-zoo phase at the full width of mamba2-1.3b
   (``src/repro/configs/mamba2_1p3b.py``; its plane's one distinct block,
   as the plane compresses depth; seq 1024 = 4 chunks, batch 4): generic
   steps, an ``ssm_state`` flush and a blocking recompile that must plan
   ``hot_cache`` at ``vocab_embed#0`` and ``ssd_fastpath`` on
   ``ssm_state``, specialized steps equal to the generic oracle bit for
   bit on a fresh batch (the fast branch) and a warm one (the gather
   branch), a warming control update that must deopt, a recompile
   that must decline ``ssd_fastpath``, then a step fault whose retried
   batch and ``ssm_state`` table equal the generic executable's on the
   pre-fault state, and the recompile that recovers the plane.
   Phases 3, 3b, 3c and 4 each zero the launch counts just before and read them
   just after, and fail unless every kernel of their path launched; both
   print ms/step (host clock, synchronized), a torch.profiler breakdown
   of device time by kernel, and phase 4 the host syncs per step.
5. Conformance on the card at smoke scale: ``run_conformance`` of
   mamba2-1.3b in the plain, fused and frontend modes, jamba-v0.1-52b
   plain and phi3.5-MoE fused; each mamba2 report must equal the same
   run's on the host.  Then the chaos cells: ``run_chaos`` of llama3-8b
   plain and frontend and mamba2-1.3b plain, whose report must equal
   the host's.  Then the fingerprint check (``[fingerprint]``): the
   warmup scenario's plan fingerprints of llama3-8b and mamba2-1.3b on
   the card in this process, on the card in a subprocess under another
   ``PYTHONHASHSEED`` (``python -m repro_torch.testing.fingerprint``)
   and on the host must be equal.
6. Each kernel timed on the inputs its main path gave it (device time:
   calls captured in a CUDA graph, replays timed with CUDA events),
   beside its plain version, its library call where one exists, and its
   bound; ``hot_gather`` also with every other token cold (its own
   ``[time]`` line), ``ssd_scan`` also by pass (torch.profiler) and with
   its bound on the tensor cores (3xTF32) beside the CUDA cores' figure.
7. Model phase: gemma2-9b (``src/repro/configs/gemma2_9b.py``) at full
   width and depth, bf16 weights from seed 0, through
   ``make_prefill_step`` / ``make_decode_step``: a prefill of 2 x 6144
   random tokens (past the 4096 window) and 32 greedy decode steps, run
   twice.  It fails unless ``flash_attention`` launched 42 times in every
   prefill and every decode step, through the wgmma prefill at prefill
   and the split-K decode at decode, the logits are finite, the two runs
   give equal tokens and logits bit for bit, and the decode logits lie
   within ``MODEL_TOL`` of a prefill's rows over the same tokens.  It
   prints prefill ms, decode ms/token, host syncs per decode step and a
   profile; then the kernel is held against its plain version on the
   path's own q, k, v (a local and a global layer, prefill and decode)
   and timed beside the plain version and SDPA (the kernels JSON carries
   the global prefill call).  The earlier phases' tensors are released
   first.
8. MoE model phase: phi3.5-MoE (``src/repro/configs/phi3p5_moe.py``) at
   every published width, cut to 24 of its 32 layers (the whole model's
   78.0 GiB of bf16 params leave no room on one card), after gemma2's
   params are released, the same way: 2 x 4096 random tokens and 32
   greedy decode steps, twice.  It fails unless ``flash_attention``
   launched 24 times in every call through the same two paths, the
   logits are finite, the two runs are equal bit for bit, each layer's
   ``expert_counts`` row sums to B*S*K at prefill and B*K at decode, and
   every layer of the decode path, fed the prefill's input and cache at
   that layer, gives the prefill's output within ``LAYER_TOL`` (the
   comment at ``LAYER_TOL`` says why not the logits after all 24
   layers).  It prints the free-running decode's routing flips against
   the prefill by layer and its logits' difference from the prefill's
   rows, the experts each layer used, host syncs per decode
   step (one per MoE layer) and a profile split into expert and other
   GEMMs, ``flash_*``, sort and gather/scatter work; then the kernel on
   its layer 0's own q, k, v against its plain version and SDPA.

9. SSM model phase: mamba2-1.3b (``src/repro/configs/mamba2_1p3b.py``)
   whole, after phi3.5-MoE's params are released, the same way: 4 x 4096
   random tokens and 32 greedy decode steps, twice, through the Mamba
   branch of the transformer.  It fails unless ``ssd_scan`` launched 48
   times in every prefill and never in a decode step, ``flash_attention``
   never, the logits are finite, the two runs are equal bit for bit and
   every layer of the decode path, fed the prefill's input (a prefill of
   the same 4128 tokens) over the state that layer's prefill of the
   prompt's rows leaves, gives the prefill's output within ``LAYER_TOL``
   (random-weight mamba2 in bf16 is as sensitive in depth as phi3.5:
   the comment at ``LAYER_TOL``); the logits' difference is printed.
   It prints prefill ms, decode ms/token, host syncs per decode step and
   a profile by kernel class; then the kernel
   on its layer 0's own bf16 inputs (strided views of the conv output)
   against its plain version (``SSD_TOL``'s bf16 and state entries),
   timed, by pass and against its bound.
10. MLA model phase: deepseek-v2-236b
   (``src/repro/configs/deepseek_v2_236b.py``) at every published
   width, cut to 8 of its 60 layers (the dense prefix layer and 7 MoE
   layers of 160 experts top-6 and 2 shared; 55.6 GiB of bf16 params),
   after mamba2's are released, the same way: 2 x 4096 random tokens and
   32 greedy decode steps, twice.  MLA attends in plain PyTorch, the
   naive form at prefill and the absorbed form at decode, so it fails
   unless ``flash_attention`` and ``ssd_scan`` never launched; and, as
   phase 8, unless the logits are finite, the two runs are equal bit for
   bit, the expert counts sum right and every layer of the decode path,
   the prefix layer included, gives the prefill's output within
   ``LAYER_TOL`` where it routes as the prefill did.  It prints the
   cache's size, prefill ms, decode ms/token, host syncs per decode step
   (one per MoE layer), a profile by kernel class with ``mla_forward``'s
   share of the device time, and the peak memory.
11. Encoder-decoder model phase: seamless-m4t-medium
   (``src/repro/configs/seamless_m4t_medium.py``) whole (12 encoder and
   12 decoder layers, d_model 1024, 16 / 16 heads x 64, vocab 256206),
   after deepseek-v2's params are released, the same way: 4 x 4096
   random tokens with 4 x 1024 frames from the seed (the stub frontend's
   embeddings, S / 4, and ``enc_cap`` 1024) and 32 greedy decode steps,
   twice, every prefill (the check's of 4128 tokens too) fed the same
   frames.  It fails unless ``flash_attention`` launched 36 times in
   every prefill (12 encoder, 12 causal self- and 12 cross-attention
   calls) and 24 in every decode step, never ``ssd_scan``, the logits
   are finite, the two runs are equal bit for bit and every decoder
   layer of the decode path, fed the prefill's input and cache (its
   cross-attention slots included), lies no farther from the prefill's
   output than bf16 rounding moves that layer (the same layer in f32 on
   the same input; random-weight seamless is chaotic in depth: the
   comment at ``LAYER_TOL``); the logits' difference is printed.  It
   prints prefill ms, decode ms/token, host syncs per decode step (0), a
   profile with ``encoder_forward``'s share of the prefill's device time
   and the peak memory; then the kernel on the path's own q, k, v (the
   encoder's layer 0, the decoder's layer 0 self- and cross-attention at
   prefill and at the last decode step) against its plain version and
   SDPA.

12. VLM model phase: pixtral-12b (``src/repro/configs/pixtral_12b.py``)
   whole (40 layers, d_model 5120, 32 / 8 heads x 128, d_ff 14336, vocab
   131072), after seamless's params are released, the same way: each of
   2 sequences is 1024 media embeddings from the seed (the stub
   frontend's, bf16) followed by 3072 random text tokens, then 32 greedy
   decode steps from position 4096, twice.  It fails unless
   ``flash_attention`` launched 40 times in every prefill and every
   decode step, never ``ssd_scan``, the logits cover all 4096 positions
   and are finite, the two runs are equal bit for bit and every layer of
   the decode path, fed the prefill's input and cache (the media's slots
   included), lies no farther from the prefill's output than bf16
   rounding moves that layer, as phase 11 holds seamless.  Then the
   kernel on its layer 0's own q, k, v against its plain version and
   SDPA.
13. Hybrid model phase: jamba-v0.1-52b
   (``src/repro/configs/jamba_v0p1_52b.py``) at every published width,
   cut to 16 of its 32 layers (two periods of 8: an attention layer at
   position 2, Mamba layers elsewhere, MoE FFNs of 16 experts top-2 on
   the odd positions), after pixtral's params are released, the same
   way: 2 x 4096 random tokens and 32 greedy decode steps, twice.  It
   fails unless ``flash_attention`` launched twice in every call,
   ``ssd_scan`` 14 times in every prefill and never in a decode step,
   the logits are finite, the two runs are equal bit for bit, the expert
   counts sum right and every layer of the decode path (a Mamba layer
   over the state its prefill of the prompt's rows leaves) gives the
   prefill's output within ``LAYER_TOL`` where it routes as the prefill
   did.  It prints the routing flips, host syncs per decode step (one
   per MoE layer), the profile and the peak memory; then ``ssd_scan`` on
   its layer 0's own bf16 inputs (H 128 at B 2) against its plain
   version, timed and against its bound.

14. Train-kernel phase (``[train-kernel]``): ``flash_attention_bwd``
   (``csrc/flash_attention_bwd.cu``) against the plain backward
   (autograd through ``flash_attention_ref``) on ``BWD_SHAPES``: the
   reference kernel test's flash shapes, starcoder2-3b's layer (B 4,
   S 2048, 24 / 2 heads x 128, causal), gemma2-9b's local layer (D 256,
   window 4096, softcap 50) and seamless's encoder layer (D 64, MHA, not
   causal).  The backward takes the forward's output and logsumexp
   (``return_lse=True``), as ``FlashAttentionFn`` saves them.  The
   yardstick is the plain backward in f32; the kernel's bf16 gradients
   must lie within ``BWD_BF16_REL`` times the plain version's own bf16
   distance from it (normwise over dq, dk, dv), two calls must give
   equal bits, and each shape must take ``bwd_path``'s path (``wgmma``
   at D 64 / 128, with ``bwd_head_groups``'s groups; the CUDA cores at
   D 256).  Per shape it prints the path, the kernel's time under
   CUDA-graph replay, the plain version's, SDPA's backward where one
   call computes the same function (no window, no softcap), and the
   bound, 10 B H (visible pairs) D FLOP at the bf16 peak; at
   starcoder2-3b's layer also the forward's time without and with the
   logsumexp, in turns, and the backward's host enqueue time a call.
15. Train-dense phase (``[train-dense]``): starcoder2-3b whole (30
   layers, every published width, 3.03 B params) through
   ``repro_torch.launch.train.main`` at batch 4 x seq 2048, 6 steps,
   lr 1e-4, remat on, no checkpoints: the state reckoned from the
   config's shapes, the losses and gradient norms (finite; the loss does
   not fall in 6 steps from the reference's random init, ``TRAIN``
   says why), step ms (the
   median of steps 2-5), tokens/s, the device's busy share over the
   last step (torch.profiler) and its time by kernel class,
   ``flash_attention`` forward (60) and backward (30) launches every
   step, the peak memory.  Then a 2-layer cut at the same widths: the
   first step's loss and layer-0 gradients through the kernels against
   the same step with attention through the plain version, within that
   step's own bf16 noise (the plain version's bf16 step against its f32
   step).
16. Train-resume phase (``[train-resume]``): starcoder2-3b at full
   width, 2 of 30 layers, lr 1e-4: 10 steps uninterrupted (the loss must
   fall: the last below the first), then ``--fail-at-step 7
   --ckpt-every 5`` and ``--resume``, synchronous and then
   ``--ckpt-async``: every final leaf (params, master, m, v, step)
   equals the uninterrupted run's bit for bit.
17. Train-MoE phase (``[train-moe]``): phi3.5-MoE at every published
   width, 2 of 32 layers, ``--respecialize-every 4 --hot-coverage 0.7
   --step-fault-at 8``: a specialized plan activates and its steps run
   ``moe_ffn_hotpath`` (the step before the fault among them), the
   faulted step runs the generic step on the same batch, and the
   optimizer's step counter equals the batches taken after every step.
   Phases 15-17 each zero the launch counts just before and read them
   just after, and fail unless ``flash_attention`` and
   ``flash_attention_bwd`` launched.
18. SSD-backward kernel phase (``[ssd-bwd-kernel]``): ``ssd_scan_bwd``
   (``csrc/ssd_scan_bwd.cu``, after the forward kernel whose ``dacs``
   and ``states`` it reads) against the plain backward (autograd through
   ``ssd_scan_ref``) and the blocked one on ``test_torch_ssd_bwd.py``'s
   shapes (f32 and bf16, an initial state, a final-state cotangent) and
   on mamba2-1.3b's training layer (``SSD_BWD_MAIN``: strided bf16, as
   the model calls it), each gradient within ``SSD_BWD_TOL``, two calls
   equal bit for bit; there its time, the plain version's, its passes and
   its bound (3xTF32 operations, beside the CUDA cores' figure).
19. Train-SSM phase (``[train-ssm]``): mamba2-1.3b whole (``TRAIN_SSM``)
   through ``repro_torch.launch.train.main``: finite losses and gradient
   norms, 96 ``ssd_scan`` (forward and remat recompute) and 48
   ``ssd_scan_bwd`` launches every step, step ms, the last step's device
   time by class, the peak memory; then a crash after a checkpoint and
   ``--resume``: every final leaf equals the uninterrupted run's bit for
   bit.
20. Train-hybrid phase (``[train-hybrid]``): jamba-v0.1-52b at every
   width, cut to layers 0-1 (``TRAIN_HYBRID``: Mamba with a dense FFN,
   Mamba with the MoE FFN), the state reckoned; finite losses, 4
   ``ssd_scan`` and 2 ``ssd_scan_bwd`` launches a step, step ms, peak.
   Phases 19-20 each zero the launch counts just before and read them
   just after, and fail unless ``ssd_scan`` and ``ssd_scan_bwd``
   launched.

In every model phase the kernels JSON counts ``flash_attention``'s and
``ssd_scan``'s launches over the two served runs alone (counts zeroed
just before the first, read just after the second), not over the checks
after them; ``flash_attention``'s and ``ssd_scan``'s counts add the
training phases', and ``flash_attention_bwd``'s and ``ssd_scan_bwd``'s
are theirs.

The last three lines are the kernels JSON, the nvidia-smi line and the
device JSON.  Any failure raises (exit code != 0) and prints no result;
without CUDA, or without the repository's ``src/`` beside this file, the
script exits with 2.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOP_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12        # H100 SXM, dense TF32 tensor cores
KERNELS = {                     # name -> (source, TPU kernel it replaces)
    "hot_gather": ("src/repro_torch/kernels/csrc/hot_gather.cu",
                   "src/repro/kernels/hot_gather.py:42"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:73"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:82"),
    # no pallas_call: the reference differentiates attend_blocked
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/models/attention.py:70"),
    # no pallas_call: the reference differentiates its ssd_scan_ref
    "ssd_scan_bwd": ("src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                     "src/repro/kernels/ref.py:36"),
}
# ssd_scan against its plain version.  On the reference kernel test's
# shapes, that test's elementwise tolerances (abs + rel): y 2e-5 in f32,
# 2e-2 in bf16 (y is rounded to 8 bits), the state 1e-3.  At the serving
# shapes (128-term dot products, 256-step chunks, a carried state) y
# sums terms of both signs, so an error relative to each element is the
# wrong yardstick: the two versions sum in other orders, and f32 rounding
# of a K-term sum grows like sqrt(K) * 2^-24 times the terms' magnitude,
# which for K ~ 400 and terms up to ~10x the outputs is ~1e-5 of max|y|
# (worst case ~2e-4).  There y (f32) is held normwise:
# max|y - y_plain| <= 1e-4 * max|y_plain|.
SSD_TOL = {"f32": 2e-5, "bf16": 2e-2, "state": 1e-3, "f32_normwise": 1e-4}
# ssd_scan_bwd against its plain version (autograd through ssd_scan_ref on
# the same inputs) and its blocked one, normwise per gradient (dx, ddt,
# dA, dB, dC, dinit): max|kernel - plain| <= tol * max|plain|.  f32: the
# sums run in other orders (up to 4.9e-5 of the largest entry on the
# test shapes, dA the worst: its sum over every step cancels); bf16: dx,
# dB and dC are rounded to 8 bits on both sides, and a tie broken the
# other way is ~4e-3 of an entry.
SSD_BWD_TOL = {"f32": 1e-4, "bf16": 1e-2}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA
    graph, the graph replayed ``replays`` times between two events; the
    median replay over ``calls``.  Host-side launch overhead is out of
    the measurement (eager calls of a small kernel are host-bound)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def eager_ms(torch, fn, iters: int = 50) -> float:
    """Median time of one eager call, host enqueue included (CUDA events
    around each call)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


# device kernels by class, from their names (the first pattern that
# matches); the rest is elementwise and other work
KERNEL_CLASSES = (("GEMM", r"gemm|Gemm|GEMM|cutlass|xmma|nvjet|cublas"),
                  ("flash", r"flash_"),
                  ("ssd_scan bwd", r"bwd_(local|state|cols|rows|finish|"
                                    r"reduce_bc|reduce_da)\b"),
                  ("flash bwd", r"bwd_delta|bwd_dkdv|bwd_dq|bwd_reduce"),
                  ("ssd_scan", r"chunk_state|state_pass|chunk_out"),
                  ("sort", r"[Ss]ort|[Rr]adix"),
                  ("gather/scatter", r"[Ii]ndex|[Ss]catter|[Gg]ather|Cat"))


def profile_steps(torch, label: str, step, batches,
                  gemm_dim=None) -> None:
    """Device time by kernel over one ``step`` per batch (torch.profiler),
    by kernel class, and the share of the window's wall time the device
    was busy (the profiler's own overhead included).  With ``gemm_dim``,
    the GEMMs (``aten::mm`` by input shape) split into those with an
    operand dimension of ``gemm_dim`` (a MoE's expert width) and the
    rest."""
    from torch.profiler import ProfilerActivity, profile as prof_
    n = len(batches)
    torch.cuda.synchronize()
    with prof_(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
               record_shapes=gemm_dim is not None) as prof:
        t = time.perf_counter()
        for b in batches:
            step(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    dev = lambda e: getattr(e, "self_device_time_total", 0)
    # the kernels themselves (the ops that launched them carry the same
    # device time again, as does a span's range on the device timeline)
    on_device = lambda e: str(e.device_type).endswith("CUDA")
    events = [e for e in prof.key_averages()
              if on_device(e) and dev(e) > 0 and e.key not in SPANS]
    busy = sum(dev(e) for e in events)
    if not events:
        print(f"[profile] {label}: no device time in the trace "
              f"(not measured)")
        return
    print(f"[profile] {label}: {n} steps, wall {wall_us:.0f} us, "
          f"device busy {busy:.0f} us ({busy / wall_us:.1%}), "
          f"{sum(e.count for e in events) / n:.0f} kernel launches per step")
    for e in sorted(events, key=dev, reverse=True)[:12]:
        print(f"[profile]   {dev(e) / n:9.1f} us/step "
              f"{e.count / n:6.1f} calls/step  {e.key[:90]}")
    by_class = {}
    for e in events:
        cls = next((c for c, pat in KERNEL_CLASSES if re.search(pat, e.key)),
                   "elementwise and other")
        by_class[cls] = by_class.get(cls, 0) + dev(e)
    print(f"[profile]   by class, us/step: " + ", ".join(
        f"{c} {v / n:.1f} ({v / busy:.1%})" for c, v in by_class.items()))
    # a span's host-side range: the device time of the kernels it launched
    spans = [e for e in prof.key_averages()
             if e.key in SPANS and not on_device(e)]
    for e in spans:
        t = getattr(e, "device_time_total", 0)
        print(f"[profile]   span {e.key}: {t / n:.1f} us/step of device "
              f"time ({t / busy:.1%}), {e.count / n:.0f} calls/step")
    if gemm_dim is not None:
        mm = [e for e in prof.key_averages(group_by_input_shape=True)
              if e.key in ("aten::mm", "aten::addmm", "aten::bmm")]
        expert = sum(dev(e) for e in mm
                     if any(gemm_dim in s for s in e.input_shapes))
        rest = sum(dev(e) for e in mm) - expert
        print(f"[profile]   GEMMs by operand: expert (a dimension "
              f"{gemm_dim}) {expert / n:.1f} us/step, attention "
              f"projections, router and unembedding {rest / n:.1f} us/step")


# the functions ``span`` wraps in a profiler range; profile_steps
# reports the device time of the kernels each range launched
SPANS = ("mla_forward", "encoder_forward")


@contextlib.contextmanager
def span(torch, module, name: str):
    """While open, ``module.<name>`` runs inside a profiler range of its
    name."""
    real = getattr(module, name)

    def wrapped(*a, **kw):
        with torch.profiler.record_function(name):
            return real(*a, **kw)
    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


def tree_bytes(torch, tree) -> int:
    """Bytes of every tensor in a nested dict."""
    if isinstance(tree, dict):
        return sum(tree_bytes(torch, v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def host_syncs(torch, step, batches) -> float:
    """Device-to-host synchronizations per ``step`` call, counted with
    PyTorch's sync debug mode (one warning per synchronizing call)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for b in batches:
                step(b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = sum("synchroniz" in str(w.message) for w in caught)
    return n / len(batches)


# flash_attention's kernels by their path (kernels/flash_attention.py)
FA_PATHS = {"flash_decode": "split_k_decode",
            "flash_combine": "split_k_decode",
            "flash_prefill_wgmma": "wgmma_prefill", "flash_bf16": "mma_sync",
            "flash_f32": "f32"}
# flash_attention_bwd's kernels (csrc/flash_attention_bwd.cu): the wgmma
# path's dk / dv and dq must each hold HGMMA and UTMALDG
BWD_KERNELS = {"bwd_dkdv_wgmma": "wgmma dk/dv", "bwd_dq_wgmma": "wgmma dq",
               "bwd_reduce": "wgmma reduce", "bwd_delta": "delta",
               "bwd_dkdv": "cuda_cores dk/dv", "bwd_dq": "cuda_cores dq"}


def sass_counts(build, name: str = "flash_attention",
                paths: dict = FA_PATHS) -> dict:
    """HGMMA (wgmma) and UTMALDG (TMA load) instructions per kernel path
    (the first key of ``paths`` in a function's name) in the SASS of
    ``csrc/<name>.cu``'s built library."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass",
                           str(build.library_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, path = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            path = next((v for k, v in paths.items()
                         if k in fn.group(1)), None)
            if path:
                counts.setdefault(path, {"HGMMA": 0, "UTMALDG": 0,
                                         "functions": 0})["functions"] += 1
            continue
        if path:
            for op in ("HGMMA", "UTMALDG"):
                counts[path][op] += len(re.findall(rf"\b{op}\b", line))
    return counts


def ptxas_usage(log: str, pattern: str) -> dict:
    """``{entry: (registers, spill store bytes, spill load bytes)}`` for
    the entry functions whose mangled name matches ``pattern``, from
    nvcc's ``-Xptxas -v`` output."""
    usage, entry, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and re.search(pattern, entry):
            usage[entry] = (int(m.group(1)),) + spills
    return usage


def kernel_phase(torch, hot_gather_cuda, hot_gather_ref) -> float:
    """Every shape of the reference's hot_gather tests plus the serving
    path's, f32 and bf16; returns the largest |kernel - plain|."""
    gen = torch.Generator().manual_seed(0)
    cases = []
    for V, D, Hn, T in [(64, 16, 4, 32), (512, 64, 8, 100),
                        (128, 32, 1, 7), (32064, 4096, 32, 512)]:
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.randn(V, D, generator=gen).to(dtype)
            hot_ids = torch.randperm(V, generator=gen)[:Hn].int()
            idx = torch.randint(0, V, (T,), generator=gen).int()
            cases.append((f"V{V}_D{D}_H{Hn}_T{T}_{dtype}", table,
                          hot_ids, idx))
    table = torch.randn(32, 8, generator=gen)
    hot_ids = torch.tensor([1, 2, 3], dtype=torch.int32)
    cases.append(("all_hot", table, hot_ids,
                  torch.tensor([1, 2, 3, 1, 2], dtype=torch.int32)))
    cases.append(("all_cold", table, hot_ids,
                  torch.tensor([9, 10, 11], dtype=torch.int32)))
    # duplicate hot ids (each of 20 twice, so Hn = 40: two ballot steps),
    # half the tokens cold, at a small width and the serving width
    for V, D, T in [(64, 16, 200), (32064, 4096, 512)]:
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.randn(V, D, generator=gen).to(dtype)
            ids = torch.randperm(V, generator=gen)[:20].int()
            hot_ids = torch.cat([ids, ids.flip(0)])
            cold = torch.arange(V)[~torch.isin(torch.arange(V), ids)]
            pick = torch.rand(T, generator=gen) < 0.5
            idx = torch.where(
                pick, ids[torch.randint(0, 20, (T,), generator=gen)],
                cold[torch.randint(0, cold.numel(), (T,), generator=gen)])
            cases.append((f"dup_V{V}_D{D}_H40_T{T}_half_cold_{dtype}",
                          table, hot_ids, idx.int()))
    worst = 0.0
    for name, table, hot_ids, idx in cases:
        table, hot_ids, idx = (t.cuda() for t in (table, hot_ids, idx))
        hot_rows = table.index_select(0, hot_ids)
        if name.startswith("dup"):
            # the second copy of each id differs: a later match would show
            hot_rows[20:] = -hot_rows[20:]
        out = hot_gather_cuda(table, hot_rows, hot_ids, idx)
        plain = hot_gather_ref(table, hot_rows, hot_ids, idx)
        lib = table.index_select(0, idx)
        torch.cuda.synchronize()
        check(torch.equal(out, plain), f"hot_gather != plain on {name}")
        check(torch.equal(out, lib), f"hot_gather != index_select on {name}")
        worst = max(worst, (out.float() - plain.float()).abs().max().item())
        print(f"[kernel] hot_gather {name}: equal to plain and index_select")
    return worst


def serving_phase(torch, ops):
    from repro_torch.core import EngineConfig, MorpheusRuntime, SketchConfig
    from repro_torch.serving import ServeConfig, build_params, \
        build_tables, make_serve_step, make_synthetic_batch

    cfg = ServeConfig(d_model=4096, n_experts=16, top_k=2, d_ff=6400,
                      vocab=32064, n_layers=2, seq=64, n_classes=64,
                      n_slots=256)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    t0 = time.perf_counter()
    params = build_params(cfg, seed=0, device="cuda")
    for lp in params["layers"]:            # a domain-skewed router
        with torch.no_grad():
            lp["moe"]["b_router"][:3] = 6.0
    rt = MorpheusRuntime(
        make_serve_step(cfg), build_tables(cfg), params,
        make_synthetic_batch(cfg, seed=0),
        cfg=EngineConfig(
            sketch=SketchConfig(sample_every=4, max_hot=32,
                                hot_coverage=0.8),
            features={"vision_enabled": False, "track_sessions": True},
            moe_router_table="router"))
    torch.cuda.synchronize()
    print(f"[serve] setup {time.perf_counter() - t0:.1f} s, params "
          f"{sum(p.numel() for p in params.parameters()) * 4 / 2**30:.2f} "
          f"GiB f32, analysis {rt.analysis['mutability']}")
    try:
        def run(seed0: int, n: int = 16) -> float:
            ts = []
            for i in range(n):
                b = make_synthetic_batch(cfg, seed=seed0 + i, locality="high")
                t = time.perf_counter()
                out = rt.step(b)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t)
            check(out.shape == (8, cfg.seq, cfg.vocab)
                  and bool(torch.isfinite(out).all()),
                  f"bad step output {tuple(out.shape)}")
            return statistics.median(ts) * 1e3

        def profile(label: str, seed0: int, n: int = 3) -> None:
            profile_steps(torch, label, rt.step,
                          [make_synthetic_batch(cfg, seed=seed0 + i)
                           for i in range(n)])

        def assert_plan(when: str):
            sites = dict(rt.plan.sites)
            vocab = sites.get("vocab_embed#0")
            check(vocab is not None and vocab.impl == "hot_cache",
                  f"{when}: vocab_embed#0 planned {vocab}")
            check(rt.hot_experts() is not None,
                  f"{when}: no moe_fastpath on router: {rt.plan.sites}")
            return {sid: s.impl for sid, s in rt.plan.sites}

        ms_generic = run(1000)
        profile("generic", 1500)
        info = rt.recompile(block=True)
        plan = assert_plan("first recompile")
        print(f"[serve] plan {plan} hot_experts={rt.hot_experts()} "
              f"passes={info['pass_stats']}")
        before = ops.launches().get("hot_gather", 0)
        ms_spec = run(2000)
        check(ops.launches().get("hot_gather", 0) > before,
              "specialized steps did not launch hot_gather")
        profile("specialized", 2500)

        b = make_synthetic_batch(cfg, seed=4242, locality="high")
        out_g = rt.run_generic(b)
        out_s = rt.step(b)
        check(torch.equal(out_s, out_g),
              "specialized output != generic output")
        print("[serve] specialized == generic bit for bit")

        d0 = rt.stats.deopt_steps
        temps = torch.linspace(0.5, 1.5, cfg.n_classes).numpy()
        rt.control_update("req_class", {"temperature": temps})
        out_d = rt.step(b)
        check(rt.stats.deopt_steps == d0 + 1, "control update did not deopt")
        check(torch.equal(out_d, rt.run_generic(b)),
              "deopted output != generic output")
        rt.recompile(block=True)
        assert_plan("second recompile")
        out_r = rt.step(b)
        check(torch.equal(out_r, rt.run_generic(b)),
              "re-specialized output != generic output")
        print(f"[serve] generic {ms_generic:.3f} ms/step, specialized "
              f"{ms_spec:.3f} ms/step (batch 8 x seq {cfg.seq}, median of "
              f"16), deopt_steps={rt.stats.deopt_steps}")
        snap = rt.stats.snapshot()
        print(f"[serve] counters "
              f"{ {k: v for k, v in snap.items() if isinstance(v, int)} }")
        print(f"[serve] recompile cycles (s): t1 {snap['t1_history']} "
              f"t2 {snap['t2_history']} swap {snap['swap_history']}")
        # the main path's own hot_gather inputs, for timing, and the
        # params for the frontend phase
        table = rt.state.tables["vocab_embed"]["vec"]
        hot_ids = torch.tensor(dict(rt.plan.sites)["vocab_embed#0"].hot_keys,
                               dtype=torch.int32, device="cuda")
        idx = b["tokens"].reshape(-1).contiguous()
        return table, hot_ids, idx, cfg, params
    finally:
        rt.close()


def _serving_pair(cfg, params, controller):
    """A specialized serving runtime under ``controller`` (None: its
    own) and a DeadCodePass-only generic oracle (the conformance
    harness's), both over ``params`` (no copy)."""
    from repro_torch.core import EngineConfig, MorpheusRuntime, \
        PassRegistry, SketchConfig
    from repro_torch.core.passes.dead_code import DeadCodePass
    from repro_torch.serving import build_tables, make_serve_step, \
        make_synthetic_batch
    sketch = dict(sample_every=4, max_hot=32, hot_coverage=0.8)
    features = {"vision_enabled": False, "track_sessions": True}
    example = make_synthetic_batch(cfg, seed=0)
    spec = MorpheusRuntime(
        make_serve_step(cfg), build_tables(cfg), params, example,
        cfg=EngineConfig(sketch=SketchConfig(**sketch),
                         features=dict(features), moe_router_table="router"),
        controller=controller)
    oracle = MorpheusRuntime(
        make_serve_step(cfg), build_tables(cfg), params, example,
        cfg=EngineConfig(sketch=SketchConfig(**sketch),
                         features=dict(features),
                         passes=PassRegistry((DeadCodePass(),))))
    return spec, oracle


def _mirror(oracle, version: int) -> None:
    """Bump the oracle's table version up to ``version`` (the specialized
    side's after a call), so guard windows stay aligned."""
    while oracle.tables.version < version:
        oracle.tables.bump_version("mirror")


def _tables_equal(torch, spec, oracle, where: str) -> None:
    for name, fields in spec.state.tables.items():
        for f, v in fields.items():
            check(torch.equal(v, oracle.state.tables[name][f]),
                  f"{where}: table {name}.{f} differs from the oracle's")


def frontend_phase(torch, cfg, params) -> float:
    """The request path at the serving phase's full width: requests
    through ``ServingFrontend`` over a fresh specialized runtime built on
    the serving phase's params (no copy), every window the runtime ran
    replayed on a fresh generic oracle (the DeadCodePass-only registry
    conformance uses) and held to it bit for bit.  Returns the measured
    capacity C in req/s."""
    from repro_torch.core import BATCH_SHAPE_SITE, plan_batch_shape
    from repro_torch.serving import make_request_batch, make_request_rows
    from repro_torch.serving.frontend import FrontendConfig, \
        OpenLoopDriver, ServingFrontend, bursty_onoff_gaps, poisson_gaps

    t0 = time.perf_counter()
    spec, oracle = _serving_pair(cfg, params, None)
    # everything the specialized runtime runs is captured, in order, with
    # its table version after the call (frontend mispredict deopts bump it)
    captured = []
    real_many, real_step = spec.step_many, spec.step

    def tap_many(batches, k=None):
        out = real_many(batches, k=k)
        captured.append((batches, k, out, spec.tables.version))
        return out

    def tap_step(batch):
        out = real_step(batch)
        captured.append((batch, None, out, spec.tables.version))
        return out

    def replay(label: str) -> int:
        n = len(captured)
        for batch, k, out, v in captured:
            _mirror(oracle, v)
            ref = (oracle.step(batch) if k is None
                   else oracle.step_many(batch, k=k))
            check(torch.equal(out, ref),
                  f"frontend {label}: a window differs from the oracle's "
                  f"replay")
        captured.clear()
        _mirror(oracle, spec.tables.version)
        _tables_equal(torch, spec, oracle, f"frontend {label}")
        print(f"[frontend] {label}: {n} calls replayed on the generic "
              f"oracle, outputs and tables equal bit for bit")
        return n

    spec.step_many, spec.step = tap_many, tap_step
    fe = None
    try:
        torch.cuda.synchronize()
        print(f"[frontend] two runtimes over the serving phase's params "
              f"(specialized, and a DeadCodePass-only oracle): "
              f"{time.perf_counter() - t0:.1f} s")

        # 1. fused windows against single steps, full buckets
        def timed(fn, n: int = 8) -> float:
            fn()                                 # builds its executable
            ts = []
            for _ in range(n):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t)
            return statistics.median(ts) * 1e3

        rows = make_request_rows(cfg, 100, 16, locality="high")
        per_step = {}
        for bucket in (8, 16):
            b = spec.place_batch(make_request_batch(rows[:bucket], bucket))
            line = {"step": timed(lambda: spec.step(b))}
            for k in (1, 2, 4):
                w = spec.place_batch([b] * k, fused=True)
                line[f"K{k}"] = timed(lambda: spec.step_many(w, k=k)) / k
            per_step[bucket] = line
            print(f"[frontend] bucket {bucket} x seq {cfg.seq}, ms per step "
                  f"(host clock, synchronized, median of 8 calls): "
                  f"{ {k: round(v, 3) for k, v in line.items()} }")
            replay(f"timing, bucket {bucket}")
        step_s = per_step[16]["K1"] / 1e3
        capacity = 16 / step_s
        print(f"[frontend] capacity C = 16 / {step_s * 1e3:.3f} ms = "
              f"{capacity:.1f} req/s (bucket 16, K 1)")

        # 2. open loop: Poisson, a blocking recompile, then ON/OFF
        fe = ServingFrontend(spec, FrontendConfig(
            capacity=256, max_batch=16, max_wait_s=2e-3, window_k_max=4,
            inflight=2, default_slo_s=20 * step_s), keep_outputs=False)
        fe.start()
        reqs = make_request_rows(cfg, 0, 768, locality="high")
        rate = 0.5 * capacity
        series = ("request_total_s", "request_queue_wait_s",
                  "request_batch_wait_s", "request_execute_s")
        keys = ("requests_submitted", "requests_completed",
                "requests_rejected", "requests_shed", "requests_failed",
                "slo_met", "slo_missed", "pad_rows", "batches_formed",
                "locked_calls", "steps", "deopt_steps", "instr_steps")

        def open_loop(label: str, payloads, gaps) -> None:
            spec.stats.reset_hist(*series)
            before = spec.stats.snapshot()
            n0 = len(captured)
            driver = OpenLoopDriver([fe], payloads, gaps)
            t = time.perf_counter()
            driver.start()
            driver.join(timeout=300)
            check(fe.drain(timeout=300), f"frontend {label}: no drain")
            wall = time.perf_counter() - t
            after = spec.stats.snapshot()
            d = {k: after[k] - before[k] for k in keys}
            check(d["requests_submitted"] == len(payloads),
                  f"frontend {label}: submitted {d}")
            check(d["requests_submitted"] == d["requests_completed"]
                  + d["requests_rejected"] + d["requests_shed"]
                  + d["requests_failed"], f"frontend {label}: accounting {d}")
            check(d["requests_failed"] == 0, f"frontend {label}: failed {d}")
            windows = {}
            for batch, k, _, _ in captured[n0:]:
                key = (int(batch["tokens"].shape[1]), k)
                windows[key] = windows.get(key, 0) + 1
            n_win = len(captured) - n0
            pad = d["pad_rows"] / max(d["pad_rows"] + d["requests_completed"],
                                      1)
            q = lambda name, p: spec.stats.quantile(name, p) * 1e3
            slo = d["slo_met"] + d["slo_missed"]
            # the driver's sleeps slip behind the batcher thread's GIL
            # hold, so the arrivals' own span gives the rate that came
            ts = [r.arrival_ts for r in driver.requests]
            arrived = (len(ts) - 1) / (ts[-1] - ts[0])
            print(f"[frontend] {label}: offered {rate:.1f} req/s, arrived "
                  f"{arrived:.1f} req/s, achieved "
                  f"{d['requests_completed'] / wall:.1f} req/s over {wall:.2f}"
                  f" s; submitted {d['requests_submitted']}, completed "
                  f"{d['requests_completed']}, rejected "
                  f"{d['requests_rejected']}, shed {d['requests_shed']}, "
                  f"failed {d['requests_failed']}; SLO "
                  f"{20 * step_s * 1e3:.1f} ms met "
                  f"{d['slo_met'] / max(slo, 1):.1%}")
            print(f"[frontend] {label}: request_total_s p50 "
                  f"{q('request_total_s', 0.5):.3f} ms, p99 "
                  f"{q('request_total_s', 0.99):.3f} ms; p50 queue wait "
                  f"{q('request_queue_wait_s', 0.5):.3f} ms, batch wait "
                  f"{q('request_batch_wait_s', 0.5):.3f} ms, execute "
                  f"{q('request_execute_s', 0.5):.3f} ms")
            print(f"[frontend] {label}: {n_win} windows by (bucket, K) "
                  f"{dict(sorted(windows.items()))}; pad rows {pad:.1%}; "
                  f"locked_calls per window "
                  f"{d['locked_calls'] / max(n_win, 1):.2f} (requests per "
                  f"window {d['requests_completed'] / max(n_win, 1):.2f}); "
                  f"deopt steps {d['deopt_steps']}, instrumented steps "
                  f"{d['instr_steps']}")

        open_loop("run 1 (Poisson)", reqs[:384], poisson_gaps(rate, 384, 0))
        replay("run 1")
        info = spec.recompile(block=True)
        oracle.recompile(block=True)
        _mirror(oracle, spec.tables.version)
        sites = dict(spec.plan.sites)
        vocab = sites.get("vocab_embed#0")
        check(vocab is not None and vocab.impl == "hot_cache",
              f"frontend recompile: vocab_embed#0 planned {vocab}")
        check(spec.hot_experts() is not None,
              f"frontend recompile: no moe_fastpath on router: {sites}")
        check(BATCH_SHAPE_SITE in sites,
              f"frontend recompile: no {BATCH_SHAPE_SITE}: {sites}")
        print(f"[frontend] recompile from the profile: BatchShapePass "
              f"selected (buckets, K) = {plan_batch_shape(spec.plan)}; plan "
              f"{ {k: v.impl for k, v in sites.items()} }, hot_experts="
              f"{spec.hot_experts()}, passes {info['pass_stats']}")
        open_loop("run 2 (ON/OFF)", reqs[384:],
                  bursty_onoff_gaps(rate, 384, 1))
        fe.stop()
        fe = None
        replay("run 2")
        return capacity
    finally:
        if fe is not None:
            fe.stop(drain=False)
        del spec.step_many, spec.step
        spec.close()
        oracle.close()


def chaos_phase(torch, ops, cfg, params) -> None:
    """The fault boundary at the serving phase's full width: a fresh
    specialized runtime under a controller with the chaos harness's
    health knobs, held bit for bit to a generic oracle through one arc
    of each fault kind (step, device loss, compile, straggler)."""
    from repro_torch.core.controller import HEALTHY, ControllerConfig, \
        MorpheusController
    from repro_torch.distributed.fault import FailureInjector, \
        SimulatedDeviceLoss, SimulatedFailure, StragglerMonitor
    from repro_torch.serving import make_synthetic_batch
    from repro_torch.testing.chaos import chaos_health_config

    ctl = MorpheusController(ControllerConfig(
        health=chaos_health_config("plain")))
    spec, oracle = _serving_pair(cfg, params, ctl)
    health = ctl.health_for(spec.plane_id)
    inj = FailureInjector()
    seed = [3000]
    fault_at = {}                 # when the arc's degrade happened

    def hot() -> int:
        return ops.launches().get("hot_gather", 0)

    def serve(n: int, label: str):
        """``n`` steps on both sides, equal bit for bit; a step that
        faults is retried once on the (now degraded) plane.  Returns the
        spec side's ms per step (host clock, synchronized), the number of
        retries and hot_gather launches over the spec steps."""
        ts, retried, launched = [], 0, 0
        for _ in range(n):
            b = make_synthetic_batch(cfg, seed=seed[0], locality="high")
            seed[0] += 1
            torch.cuda.synchronize()
            h0, t = hot(), time.perf_counter()
            try:
                out = spec.step(b)
            except SimulatedFailure:
                check(spec.degraded, f"chaos {label}: a fault did not "
                                     f"degrade the plane")
                fault_at["t"] = time.perf_counter()
                retried += 1
                t = time.perf_counter()
                out = spec.step(b)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
            launched += hot() - h0
            check(torch.equal(out, oracle.step(b)),
                  f"chaos {label}: a step differs from the oracle's")
        _tables_equal(torch, spec, oracle, f"chaos {label}")
        return statistics.median(ts) * 1e3, retried, launched, ts

    def recover(label: str):
        """The health-gated schedule + drain loop; returns the seconds
        to HEALTHY and what the last cycle did."""
        r0 = spec.stats.revalidations
        t = time.perf_counter()
        for _ in range(20):
            ctl.schedule(spec)
            ctl.drain(timeout=120.0)
            if health.state == HEALTHY and not spec.degraded:
                break
        else:
            raise SmokeFailure(f"chaos {label}: the plane never recovered "
                               f"({health.state}, degraded={spec.degraded})")
        secs = time.perf_counter() - t
        oracle.recompile(block=True)
        _mirror(oracle, spec.tables.version)
        snap = spec.stats.snapshot()
        how = ("revalidated" if snap["revalidations"] > r0 else
               f"swap {snap['swap_history'][-1] * 1e3:.3f} ms")
        return secs, f"t1 {snap['t1_history'][-1]:.3f} s, {how}"

    def counters() -> dict:
        s = spec.stats
        return {"faults": s.faults, "degraded_steps": s.degraded_steps,
                "recoveries": s.recoveries,
                "straggler_events": s.straggler_events}

    try:
        serve(8, "warm-up")
        spec.recompile(block=True)
        oracle.recompile(block=True)
        _mirror(oracle, spec.tables.version)
        check(dict(spec.plan.sites)["vocab_embed#0"].impl == "hot_cache",
              f"chaos: no hot_cache after the first recompile: "
              f"{spec.plan.sites}")
        spec.set_fault_injector(inj)
        for kind in ("step", "device_loss", "compile", "straggler"):
            fault_at.clear()
            ms_spec, _, _, base = serve(8, f"{kind} (before)")
            if kind == "compile":
                # a control update makes the next cycle a real rebuild;
                # the armed fault fails it once and the scheduler's
                # backoff retry lands it while serving goes on
                temps = torch.linspace(0.6, 1.4, cfg.n_classes).numpy()
                spec.control_update("req_class", {"temperature": temps})
                oracle.control_update("req_class", {"temperature": temps})
                _mirror(oracle, spec.tables.version)
                retries0 = ctl.stats().scheduler["retries"]
                spec.arm_compile_faults(1)
                t = time.perf_counter()
                ctl.schedule(spec)
                _, _, _, during = serve(8, "compile (during the retry)")
                check(ctl.drain(timeout=120.0), "chaos compile: no drain")
                secs = time.perf_counter() - t
                sched = ctl.stats().scheduler
                oracle.recompile(block=True)
                _mirror(oracle, spec.tables.version)
                check(sched["retries"] > retries0 and not spec.degraded
                      and health.state == HEALTHY
                      and spec.plan.version == spec.tables.version,
                      f"chaos compile: the retry did not land "
                      f"({sched}, degraded={spec.degraded}, "
                      f"{health.state})")
                ms_after, _, launched, _ = serve(8, "compile (after)")
                check(launched > 0, "chaos compile: no hot_gather after "
                                    "the retried cycle")
                print(f"[chaos] compile: the cycle failed once, the "
                      f"scheduler's retry landed {secs:.3f} s after the "
                      f"schedule (retries {sched['retries'] - retries0}, "
                      f"t1 {spec.stats.t1_history[-1]:.3f} s); never "
                      f"degraded, {health.state}; slowest step during the"
                      f" retry {max(during) * 1e3:.3f} ms against the "
                      f"median {statistics.median(during) * 1e3:.3f} ms "
                      f"(before: {ms_spec:.3f} ms/step); {ms_after:.3f} "
                      f"ms/step after with {launched} hot_gather launches;"
                      f" every step equal to the oracle's; {counters()}")
                continue
            if kind == "step":
                inj.arm_next(SimulatedFailure("chaos: injected step fault"))
            elif kind == "device_loss":
                inj.arm_next(SimulatedDeviceLoss("chaos: injected device "
                                                 "loss"))
            else:
                def fired(step, secs):
                    spec.stats.bump(straggler_events=1)
                    spec.degrade_to_generic(f"straggler stall @step {step}")
                    fault_at["t"] = time.perf_counter()
                mon = StragglerMonitor(threshold=2.0, patience=2, window=16,
                                       on_straggler=fired)
                for i, s in enumerate(base):        # real step latencies
                    mon.observe(i, s)
                stall = 10 * statistics.median(base)
                for i in range(8, 16):              # a 10x stall
                    if mon.observe(i, stall):
                        break
                check(spec.degraded, "chaos straggler: the monitor did "
                                     "not degrade the plane")
            # the faulted batch and its retry, then 8 degraded steps
            _, retried, launched_deg, _ = (
                serve(1, f"{kind} (fault)") if kind != "straggler"
                else (0, 0, 0, None))
            ms_deg, _, launched, _ = serve(8, f"{kind} (degraded)")
            launched_deg += launched
            check(spec.degraded and health.state != HEALTHY,
                  f"chaos {kind}: not degraded after the fault")
            check(retried == (kind != "straggler"),
                  f"chaos {kind}: {retried} retried steps")
            check(launched_deg == 0, f"chaos {kind}: {launched_deg} "
                                     f"hot_gather launches while degraded")
            secs, cycle = recover(kind)
            to_healthy = time.perf_counter() - fault_at["t"]
            ms_rec, _, launched_rec, _ = serve(8, f"{kind} (recovered)")
            check(launched_rec > 0, f"chaos {kind}: no hot_gather after "
                                    f"the recovery")
            print(f"[chaos] {kind}: degraded, "
                  f"{'the faulted batch retried, ' if retried else ''}"
                  f"{ms_deg:.3f} ms/step degraded against {ms_spec:.3f} "
                  f"specialized before and {ms_rec:.3f} after (median of 8"
                  f"); hot_gather launches {launched_deg} degraded, "
                  f"{launched_rec} after recovery; fault to HEALTHY "
                  f"{to_healthy:.3f} s (8 degraded steps served), schedule "
                  f"to HEALTHY {secs:.3f} s ({cycle}); every step equal "
                  f"to the oracle's, tables equal; {counters()}")
        print(f"[chaos] controller health {health.snapshot()}")
    finally:
        spec.close()
        oracle.close()
        ctl.close()


def chaos_frontend_arc(torch, cfg, params, capacity: float) -> None:
    """One open-loop run through the serving frontend at 0.5 C with a
    window fault armed mid-run: every request is accounted, the faulted
    window's requests fail with PLANE_FAULT, the degraded plane rejects
    with PLANE_DEGRADED until the controller's recovery, and every
    window that ran equals the oracle's replay bit for bit."""
    import threading
    from repro_torch.core.controller import HEALTHY, ControllerConfig, \
        MorpheusController
    from repro_torch.distributed.fault import FailureInjector, \
        SimulatedFailure
    from repro_torch.serving import make_request_rows, make_synthetic_batch
    from repro_torch.serving.frontend import FrontendConfig, \
        OpenLoopDriver, ServingFrontend, poisson_gaps
    from repro_torch.testing.chaos import chaos_health_config

    ctl = MorpheusController(ControllerConfig(
        health=chaos_health_config("frontend")))
    spec, oracle = _serving_pair(cfg, params, ctl)
    health = ctl.health_for(spec.plane_id)
    captured, marks = [], {}
    real_many = spec.step_many

    def tap(batches, k=None):
        try:
            out = real_many(batches, k=k)
        except SimulatedFailure:
            marks.setdefault("fault", time.perf_counter())
            raise
        captured.append((batches, k, out, spec.tables.version))
        return out

    fe = None
    try:
        for i in range(4):
            b = make_synthetic_batch(cfg, seed=4000 + i)
            check(torch.equal(spec.step(b), oracle.step(b)),
                  "chaos frontend: a warm-up step differs")
        spec.recompile(block=True)
        oracle.recompile(block=True)
        _mirror(oracle, spec.tables.version)
        inj = FailureInjector()
        spec.set_fault_injector(inj)
        spec.step_many = tap
        step_s = 16 / capacity
        fe = ServingFrontend(spec, FrontendConfig(
            capacity=256, max_batch=16, max_wait_s=2e-3, window_k_max=4,
            inflight=2, default_slo_s=20 * step_s), keep_outputs=False)
        fe.start()
        n, rate = 192, 0.5 * capacity
        driver = OpenLoopDriver(
            [fe], make_request_rows(cfg, 5, n, locality="high"),
            poisson_gaps(rate, n, 5))
        arm = threading.Timer(0.4 * n / rate, lambda: inj.arm_next(
            SimulatedFailure("chaos: window fault")))
        def poll() -> None:
            # the recovery ticker: a degraded plane is scheduled (the
            # controller's health gate decides), and HEALTHY is timed
            if spec.degraded:
                ctl.schedule(spec)
            elif "fault" in marks and health.state == HEALTHY:
                marks.setdefault("healthy", time.perf_counter())
            check(time.perf_counter() - t < 120, "chaos frontend: stuck")
            time.sleep(0.002)

        t = time.perf_counter()
        driver.start()
        arm.start()
        while driver._thread.is_alive():
            poll()
        driver.join()
        arm.join()
        check(fe.drain(timeout=120), "chaos frontend: no drain")
        wall = time.perf_counter() - t
        while spec.degraded or ("fault" in marks and "healthy" not in marks):
            poll()
        fe.stop()
        fe = None
        ctl.drain(timeout=120.0)
        check("fault" in marks, "chaos frontend: the armed window fault "
                                "never fired")
        s = spec.stats
        reasons = {}
        for r in driver.requests:
            reasons[r.reason] = reasons.get(r.reason, 0) + 1
        terminal = (s.requests_completed + s.requests_rejected
                    + s.requests_shed + s.requests_failed)
        check(s.requests_submitted == n == terminal,
              f"chaos frontend: accounting {s.snapshot()}")
        check(s.requests_failed >= 1
              and reasons.get("PLANE_FAULT", 0) == s.requests_failed,
              f"chaos frontend: failed {s.requests_failed}, {reasons}")
        check(reasons.get("PLANE_DEGRADED", 0)
              == s.requests_rejected_degraded,
              f"chaos frontend: rejections {reasons}")
        for batches, k, out, v in captured:
            _mirror(oracle, v)
            check(torch.equal(out, oracle.step_many(batches, k=k)),
                  "chaos frontend: a window differs from the oracle's")
        _mirror(oracle, spec.tables.version)
        _tables_equal(torch, spec, oracle, "chaos frontend")
        q = lambda p: s.quantile("request_total_s", p) * 1e3
        print(f"[chaos] frontend: {n} requests at {rate:.1f} req/s "
              f"(0.5 C) over {wall:.2f} s: submitted "
              f"{s.requests_submitted} = completed {s.requests_completed} "
              f"+ rejected {s.requests_rejected} + shed {s.requests_shed} "
              f"+ failed {s.requests_failed}; PLANE_FAULT "
              f"{reasons.get('PLANE_FAULT', 0)}, PLANE_DEGRADED "
              f"{s.requests_rejected_degraded}; request_total_s p50 "
              f"{q(0.5):.3f} ms, p99 {q(0.99):.3f} ms; window fault to "
              f"HEALTHY {marks['healthy'] - marks['fault']:.3f} s "
              f"(t1 {s.t1_history[-1]:.3f} s); {len(captured)} windows "
              f"replayed on the oracle, outputs and tables equal bit for "
              f"bit; faults {s.faults}, recoveries {s.recoveries}")
    finally:
        if fe is not None:
            fe.stop(drain=False)
        spec.__dict__.pop("step_many", None)     # un-shadow the method
        spec.close()
        oracle.close()
        ctl.close()


def serve_cli_phase(torch, ops, cfg) -> None:
    """``launch.serve.run_serve`` at the serving phase's widths with
    fused windows of 4 and two in flight, then the CLI's ``main`` at its
    default config, both on the card."""
    from repro_torch.launch import serve as serve_mod
    ops.reset_launches()
    t = time.perf_counter()
    stats, rt = serve_mod.run_serve(steps=64, recompile_every=32,
                                    serve_cfg=cfg, fuse=4, inflight=2)
    try:
        counts = ops.launches()
        plan = {k: v.impl for k, v in rt.plan.sites}
        check(stats["steps"] == 64 and rt.stats.recompiles == 2,
              f"run_serve: {stats['steps']} steps, "
              f"{rt.stats.recompiles} recompiles")
        check("hot_cache" not in plan.values()
              or counts.get("hot_gather", 0) > 0,
              f"run_serve planned hot_cache but launched no hot_gather "
              f"{counts}")
        print(f"[serve-cli] run_serve at the [serve] widths, fuse 4, "
              f"inflight 2 ({time.perf_counter() - t:.1f} s, params "
              f"built): {stats['req_per_s']:.1f} req/s, p50 "
              f"{stats['p50_ms']:.3f} ms/step, p99 {stats['p99_ms']:.3f} "
              f"ms/step (each window timed from its dispatch to its "
              f"CUDA event, so a window waits behind the one before it), "
              f"straggler_events {stats['straggler_events']}, plan {plan},"
              f" hot_experts {stats['hot_experts']}, launches {counts}")
    finally:
        rt.close()
        del rt, stats
        gc.collect()
        torch.cuda.empty_cache()
    ops.reset_launches()
    t = time.perf_counter()
    check(serve_mod.main(["--steps", "60", "--recompile-every", "30"]) == 0,
          "launch.serve.main did not return 0")
    print(f"[serve-cli] launch.serve.main(['--steps', '60', "
          f"'--recompile-every', '30']) on the card: "
          f"{time.perf_counter() - t:.1f} s, launches {ops.launches()}")


def chaos_conformance_phase() -> None:
    """The chaos cells on the card at smoke scale: llama3-8b in both
    modes, mamba2-1.3b plain, whose report must equal the host's."""
    from repro_torch.testing import run_chaos
    for arch, mode in (("llama3-8b", "plain"), ("llama3-8b", "frontend"),
                       ("mamba2-1.3b", "plain")):
        t = time.perf_counter()
        rep = run_chaos(arch, mode, seed=0)
        print(f"[chaos-conformance] {arch} {mode} on the card "
              f"({time.perf_counter() - t:.1f} s): {rep}")
        if arch == "mamba2-1.3b":
            host = run_chaos(arch, mode, seed=0, device="cpu")
            check(rep == host,
                  f"{arch} {mode}: card report != host report {host}")
            print(f"[chaos-conformance] {arch} {mode}: the card's report "
                  f"equals the host's")


FP_ARCHS = ("llama3-8b", "mamba2-1.3b")


def fingerprint_phase() -> None:
    """The cross-process fingerprint check on the card: the warmup
    scenario's plan fingerprints in this process, in a subprocess under
    another ``PYTHONHASHSEED`` (``python -m
    repro_torch.testing.fingerprint``) and on the host must be equal, so
    planning on the card depends on nothing salted per process and
    nothing that varies by device."""
    from repro_torch.testing import run_fingerprints
    t = time.perf_counter()
    card = run_fingerprints(FP_ARCHS, seed=0, device="cuda")
    env = dict(os.environ, PYTHONHASHSEED="271828",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.testing.fingerprint",
         "--device", "cuda", *FP_ARCHS],
        capture_output=True, text=True, env=env, timeout=600)
    check(res.returncode == 0,
          f"fingerprint CLI exited {res.returncode}: {res.stderr[-2000:]}")
    other = json.loads(res.stdout)
    host = run_fingerprints(FP_ARCHS, seed=0, device="cpu")
    for label, fps in (("card, this process", card),
                       ("card, PYTHONHASHSEED=271828", other),
                       ("host", host)):
        print(f"[fingerprint] {label}: {json.dumps(fps, sort_keys=True)}")
    check(card == other == host, "plan fingerprints differ across "
          "processes or devices")
    print(f"[fingerprint] the three maps are equal "
          f"({time.perf_counter() - t:.1f} s)")


def time_hot_gather(torch, hot_gather_cuda, hot_gather_ref, table, hot_ids,
                    idx, label: str = "serving path"):
    hot_rows = table.index_select(0, hot_ids)
    T, (V, D) = idx.shape[0], table.shape
    row = D * table.element_size()
    cold = idx[~torch.isin(idx, hot_ids)]
    n_cold_rows = int(torch.unique(cold).numel())
    # each input read once (only the rows this run needs), output written
    nbytes = (idx.numel() * 4 + hot_ids.numel() * 4 + hot_rows.numel()
              * table.element_size() + n_cold_rows * row + T * row)
    from repro_torch.kernels import ops
    kern = lambda: hot_gather_cuda(table, hot_rows, hot_ids, idx)
    plain = lambda: hot_gather_ref(table, hot_rows, hot_ids, idx)
    lib = lambda: table.index_select(0, idx)
    check(torch.equal(kern(), plain()) and torch.equal(kern(), lib()),
          f"hot_gather differs on the {label}'s inputs")
    n0 = ops.launches().get("hot_gather", 0)
    res = {
        "ms": device_ms(torch, kern),
        "plain_ms": device_ms(torch, plain),
        "library_ms": device_ms(torch, lib),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }
    check(ops.launches()["hot_gather"] > n0, "timing did not launch")
    eager = {k: eager_ms(torch, f) for k, f in
             (("kernel", kern), ("plain", plain), ("index_select", lib))}
    print(f"[time] hot_gather {label} eager calls, host enqueue included "
          f"(ms): {eager}")
    print(f"[time] hot_gather {label} V={V} D={D} Hn={hot_ids.numel()} T={T} "
          f"{table.dtype}: {n_cold_rows} cold rows, {nbytes} bytes, {res}")
    return res


def ssd_inputs(torch, gen, B, S, H, P, N, G, dtype, init: bool):
    """Random SSD scan inputs of the reference test's distributions, on
    the card."""
    f = lambda *shape: torch.randn(*shape, generator=gen)
    x = f(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(f(B, S, H))
    A = -torch.exp(f(H) * 0.5)
    Bm = (f(B, S, G, N) * 0.3).to(dtype)
    Cm = (f(B, S, G, N) * 0.3).to(dtype)
    s0 = f(B, H, P, N) * 0.1 if init else None
    return tuple(None if t is None else t.cuda()
                 for t in (x, dt, A, Bm, Cm, s0))


def ssd_compare(torch, ssd_scan_cuda, ssd_scan_ref, name, args, chunk,
                init, y_tol, normwise=False):
    """Kernel against plain on one input; returns max |y - y_plain| and
    max |state - state_plain|.  y is held elementwise (abs + rel), or
    with ``normwise`` against ``y_tol * max|y_plain|``."""
    y, fin = ssd_scan_cuda(*args, chunk=chunk, init_state=init)
    yr, finr = ssd_scan_ref(*args, chunk, init_state=init)
    torch.cuda.synchronize()
    check(y.dtype == args[0].dtype and fin.dtype == torch.float32,
          f"ssd_scan {name}: output dtypes {y.dtype} {fin.dtype}")
    dy = (y.float() - yr.float()).abs()
    ds = (fin - finr).abs()
    scale = yr.float().abs().max().item()
    if normwise:
        ok = dy.max().item() <= y_tol * scale
    else:
        ok = bool((dy <= y_tol + y_tol * yr.float().abs()).all())
    check(ok, f"ssd_scan {name}: y differs from plain by "
              f"{dy.max().item()} (max|y_plain| {scale})")
    check(bool((ds <= SSD_TOL["state"] + SSD_TOL["state"] * finr.abs())
               .all()),
          f"ssd_scan {name}: state differs from plain by "
          f"{ds.max().item()}")
    print(f"[kernel] ssd_scan {name}: max |y - plain| "
          f"{dy.max().item():.3e} ({dy.max().item() / max(scale, 1e-30):.2e}"
          f" of max|y_plain| {scale:.3e}; tol {y_tol}"
          f"{' x max|y_plain|' if normwise else ' abs + rel'}), max |state "
          f"- plain| {ds.max().item():.3e}")
    return dy.max().item(), ds.max().item()


def ssd_kernel_phase(torch, ssd_scan_cuda, ssd_scan_ref) -> float:
    """The reference test's shapes, a G = 2 case and the serving shape;
    returns the largest f32 |kernel - plain| of y and the state."""
    gen = torch.Generator().manual_seed(1)
    worst = 0.0
    # (B, S, H, P, N, chunk, G): tests/test_kernels.py's four, G = 2,
    # and mamba2-1.3b's serving shape
    shapes = [(1, 32, 4, 8, 16, 8, 1), (2, 48, 8, 16, 32, 16, 1),
              (1, 40, 2, 8, 16, 16, 1), (2, 64, 8, 16, 16, 32, 1),
              (2, 50, 8, 16, 32, 16, 2), (4, 1024, 64, 64, 128, 256, 1)]
    for B, S, H, P, N, Q, G in shapes:
        serving = (B, S, H) == (4, 1024, 64)
        for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            *args, init = ssd_inputs(torch, gen, B, S, H, P, N, G, dtype,
                                     init=serving)
            normwise = serving and key == "f32"
            tol = SSD_TOL["f32_normwise" if normwise else key]
            name = f"B{B}_S{S}_H{H}_P{P}_N{N}_Q{Q}_G{G}_{key}"
            dy, ds = ssd_compare(torch, ssd_scan_cuda, ssd_scan_ref, name,
                                 args, Q, init, tol, normwise)
            if key == "f32":
                worst = max(worst, dy, ds)
    # a None initial state is bitwise a zero one, and calls repeat bits
    *args, _ = ssd_inputs(torch, gen, 4, 1024, 64, 64, 128, 1,
                          torch.float32, init=False)
    y0, f0 = ssd_scan_cuda(*args, chunk=256)
    y1, f1 = ssd_scan_cuda(*args, chunk=256, init_state=torch.zeros_like(f0))
    y2, f2 = ssd_scan_cuda(*args, chunk=256)
    check(torch.equal(y0, y1) and torch.equal(f0, f1),
          "ssd_scan: None and zero initial states differ")
    check(torch.equal(y0, y2) and torch.equal(f0, f2),
          "ssd_scan: two calls differ")
    print("[kernel] ssd_scan: None init == zero init and call == call, "
          "bit for bit")
    return worst


def archzoo_phase(torch, ops):
    """mamba2-1.3b's arch-zoo plane at full width under MorpheusRuntime.
    Returns the (args, kwargs) one specialized step gave ssd_scan."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import MorpheusRuntime
    from repro_torch.testing.archzoo import ArchPlane, _distinct_blocks, \
        build_params, build_tables, conformance_engine_config, \
        make_batch, make_step
    from repro_torch.testing.churn import _mv_ssm_flush, _mv_ssm_warm

    cfg = get_config("mamba2-1.3b")            # unreduced widths
    blocks = _distinct_blocks(cfg)
    check(len(blocks) == 1 and blocks[0].kind == "mamba",
          f"mamba2-1.3b blocks {blocks}")
    plane = ArchPlane(arch_id=cfg.name, cfg=cfg, blocks=blocks, seq=1024,
                      vocab=cfg.padded_vocab, has_ssm=True, has_moe=False,
                      has_cross=False, has_media=False)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    params = build_params(plane, seed=0, device="cuda")
    tables = build_tables(plane, seed=0)
    rt = MorpheusRuntime(make_step(plane), tables, params,
                         make_batch(plane, rng),
                         conformance_engine_config(plane))
    rt.sampler.pin(2)                          # the harness's cadence
    torch.cuda.synchronize()
    table_gib = sum(v.nbytes for t in tables.tables.values()
                    for v in t.fields.values()) / 2**30
    print(f"[archzoo] {cfg.name}: d_model {cfg.d_model}, "
          f"{cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} SSD heads x "
          f"P {cfg.ssm.head_dim}, N {cfg.ssm.d_state}, chunk "
          f"{cfg.ssm.chunk}, vocab {plane.vocab}, batch 4 x seq "
          f"{plane.seq}; setup {time.perf_counter() - t0:.1f} s, params "
          f"{sum(p.numel() for p in params.parameters()) * 4 / 2**30:.2f}"
          f" GiB f32, tables {table_gib:.2f} GiB, analysis "
          f"{rt.analysis['mutability']}")

    def batches(n):
        return [make_batch(plane, rng) for _ in range(n)]

    def on_card(bs):
        return [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
                for b in bs]

    def run(bs) -> float:
        ts = []
        for b in bs:
            t = time.perf_counter()
            out = rt.step(b)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        check(out.shape == (4, plane.seq, plane.vocab)
              and bool(torch.isfinite(out).all()),
              f"bad step output {tuple(out.shape)}")
        return statistics.median(ts) * 1e3

    def counts(b):
        slot = torch.as_tensor(b["slot"]).long().cuda()
        return rt.state.tables["ssm_state"]["count"][slot]

    def same(b, what: str):
        # the oracle first: the step writes the slots' state it reads
        out_g = rt.run_generic(b)
        out_s = rt.step(b)
        check(torch.equal(out_s, out_g), f"{what}: specialized != generic")
        return out_s

    try:
        ms_generic = run(batches(8))
        profile_steps(torch, "archzoo generic", rt.step, batches(3))
        sync_generic = host_syncs(torch, rt.step, on_card(batches(2)))

        rt.control_update("ssm_state",
                          _mv_ssm_flush(plane, rng, None).payload["fields"])
        info = rt.recompile(block=True)
        sites = dict(rt.plan.sites)
        vocab = sites.get("vocab_embed#0")
        check(vocab is not None and vocab.impl == "hot_cache",
              f"archzoo: vocab_embed#0 planned {vocab}")
        check(rt.plan.fastpath_keys("ssm_state", "ssd_fastpath")
              is not None, f"archzoo: no ssd_fastpath: {rt.plan.sites}")
        print(f"[archzoo] plan {({k: v.impl for k, v in sites.items()})} "
              f"passes={info['pass_stats']}")

        fresh = batches(1)[0]
        check(bool((counts(fresh) == 0).all()), "fresh batch is warm")
        same(fresh, "fresh batch (zero-init branch)")
        warm = next(b for b in batches(16) if bool((counts(b) > 0).any()))
        captured = {}
        real = ops.ssd_scan

        def tap(*args, **kw):
            captured["args"], captured["kw"] = args, kw
            return real(*args, **kw)

        ops.ssd_scan = tap            # models.ssd calls ops.ssd_scan
        try:
            same(warm, "warm batch (state-gather branch)")
        finally:
            ops.ssd_scan = real
        check(captured["kw"]["init_state"] is not None
              and bool(captured["kw"]["init_state"].abs().sum() > 0),
              "warm batch gave ssd_scan no saved state")
        print("[archzoo] specialized == generic bit for bit on a fresh "
              "batch (zero init) and a warm one (saved state)")
        ms_spec = run(batches(8))
        profile_steps(torch, "archzoo specialized", rt.step, batches(3))
        sync_spec = host_syncs(torch, rt.step, on_card(batches(2)))

        d0 = rt.stats.deopt_steps
        rt.control_update("ssm_state",
                          _mv_ssm_warm(plane, rng, None).payload["fields"])
        same(batches(1)[0], "the step after ssm_warm")
        check(rt.stats.deopt_steps == d0 + 1, "ssm_warm did not deopt")
        rt.recompile(block=True)
        check(rt.plan.fastpath_keys("ssm_state", "ssd_fastpath") is None,
              f"recompile after ssm_warm kept ssd_fastpath: "
              f"{rt.plan.sites}")
        same(batches(1)[0], "after the declining recompile")
        print(f"[archzoo] ssm_warm deopted; the next recompile declined "
              f"ssd_fastpath: plan "
              f"{({k: v.impl for k, v in rt.plan.sites})}")
        print(f"[archzoo] generic {ms_generic:.3f} ms/step, specialized "
              f"{ms_spec:.3f} ms/step (batch 4 x seq {plane.seq}, median "
              f"of 8); host syncs per step: generic {sync_generic:g}, "
              f"specialized {sync_spec:g}; deopt_steps="
              f"{rt.stats.deopt_steps}")
        step_fault_arc(torch, ops, rt, batches)
        return captured["args"], captured["kw"]
    finally:
        rt.close()


def step_fault_arc(torch, ops, rt, batches) -> None:
    """A step fault on the arch-zoo plane: the step aborts with nothing
    committed, the plane degrades, and the retried batch's output and
    the RW SSM state table equal the generic executable's on the
    pre-fault state bit for bit; the recompile recovers it."""
    from repro_torch.distributed.fault import FailureInjector, \
        SimulatedFailure
    inj = FailureInjector()
    rt.set_fault_injector(inj)
    b = rt.place_batch(batches(1)[0])
    pre = rt.state
    n0 = dict(ops.launches())
    inj.arm_next(SimulatedFailure("chaos: injected step fault"))
    try:
        rt.step(b)
        raise SmokeFailure("archzoo: the armed step fault did not fire")
    except SimulatedFailure:
        pass
    check(rt.degraded and rt.state is pre,
          "archzoo: the faulted step degraded nothing or committed state")
    out_o, st_o = rt.generic_exec(rt.params, pre, b)   # the oracle
    out = rt.step(b)                                   # the retry
    torch.cuda.synchronize()
    check(torch.equal(out, out_o), "archzoo: the retried step differs "
                                   "from the generic oracle")
    for f, v in rt.state.tables["ssm_state"].items():
        check(torch.equal(v, st_o.tables["ssm_state"][f]),
              f"archzoo: ssm_state.{f} differs from the oracle's after "
              f"the retried step")
    degraded = {k: v - n0.get(k, 0) for k, v in ops.launches().items()}
    check(degraded.get("ssd_scan", 0) > 0
          and degraded.get("hot_gather", 0) == 0,
          f"archzoo: launches while degraded {degraded}")
    t = time.perf_counter()
    info = rt.recompile(block=True)
    secs = time.perf_counter() - t
    check(info.get("recovered") is True and not rt.degraded,
          f"archzoo: the recompile did not recover the plane {info}")
    n1 = dict(ops.launches())
    b2 = batches(1)[0]
    out_g = rt.run_generic(b2)
    check(torch.equal(rt.step(b2), out_g),
          "archzoo: the recovered step differs from generic")
    after = {k: v - n1.get(k, 0) for k, v in ops.launches().items()}
    check(after.get("hot_gather", 0) > 0 and after.get("ssd_scan", 0) > 0,
          f"archzoo: launches after recovery {after}")
    s = rt.stats
    print(f"[archzoo] step fault: aborted with nothing committed, degraded;"
          f" the retried batch and the ssm_state table equal the generic "
          f"oracle's bit for bit; launches while degraded {degraded}; "
          f"recovered by one recompile in {secs:.3f} s "
          f"({'revalidated' if info.get('revalidated') else 'swapped'}); "
          f"launches after {after}; faults {s.faults}, degraded_steps "
          f"{s.degraded_steps}, recoveries {s.recoveries}")
    rt.set_fault_injector(None)


def conformance_phase() -> None:
    """The differential harness on the card at smoke scale, in every
    serving mode; mamba2's reports (weights play no part in its plans)
    must equal the host's."""
    from repro_torch.testing import run_conformance
    for arch, mode in (("mamba2-1.3b", "plain"), ("jamba-v0.1-52b", "plain"),
                       ("mamba2-1.3b", "fused"), ("mamba2-1.3b", "frontend"),
                       ("phi3.5-moe-42b-a6.6b", "fused")):
        t = time.perf_counter()
        rep = run_conformance(arch, mode, seed=0)
        print(f"[conformance] {arch} {mode} on the card "
              f"({time.perf_counter() - t:.1f} s): {rep}")
        if arch == "mamba2-1.3b":
            host = run_conformance(arch, mode, seed=0, device="cpu")
            check(rep == host,
                  f"{arch} {mode}: card report != host report {host}")
            print(f"[conformance] {arch} {mode}: the card's report equals "
                  f"the host's")


def kernel_times(torch, fn, calls: int = 20) -> dict:
    """Device microseconds per launch by kernel function name
    (torch.profiler over ``calls`` calls after a warm-up; the mean over
    the launches the trace holds, which at 5 calls of 2.7 ms held only 2
    of each kernel); empty when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile as prof_
    fn()
    torch.cuda.synchronize()
    with prof_(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        name = re.search(r"(\w+)(<[^(]*>)?\(", e.key)
        if us > 0 and name:
            key = name.group(1)
            out[key] = out.get(key, 0.0) + us / e.count
    return out


def time_ssd_scan(torch, ssd_scan_cuda, ssd_scan_ref, args, kw,
                  label="serving path", tol="f32_normwise", calls=20):
    """The kernel against its plain version on a main path's own inputs
    (``tol``: the ``SSD_TOL`` entry for y, normwise for
    ``f32_normwise``), then its device time (``calls`` calls a graph)
    beside the plain version's, by pass, and its bound."""
    x, dt, A, Bm, Cm = args
    chunk, init = kw["chunk"], kw.get("init_state")
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    kern = lambda: ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk,
                                 init_state=init)
    plain = lambda: ssd_scan_ref(x, dt, A, Bm, Cm, chunk, init_state=init)
    dy, ds = ssd_compare(torch, ssd_scan_cuda, ssd_scan_ref, label, args,
                         chunk, init, SSD_TOL[tol],
                         normwise=tol == "f32_normwise")
    # multiply-adds these inputs need: the lower triangle of C.B per
    # group, of the scores times x per head, C.state and the state update
    tri = sum(L * (L + 1) // 2 for L in
              (min(chunk, S - c0) for c0 in range(0, S, chunk)))
    macs = B * (G * tri * N + H * tri * P + 2 * H * S * P * N)
    elt = x.element_size()
    nbytes = (2 * x.numel() * elt + dt.numel() * 4 + A.numel() * 4
              + (Bm.numel() + Cm.numel()) * elt
              + (2 if init is not None else 1) * B * H * P * N * 4)
    # the same work to the same tolerance on the tensor cores: three TF32
    # products (3xTF32) for each f32 one; on the CUDA cores beside it
    t_ops = 3 * 2 * macs / TF32_FLOP_PER_S
    t_cuda_cores = 2 * macs / F32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    from repro_torch.kernels import ops
    n0 = ops.launches().get("ssd_scan", 0)
    replays = 10 if calls >= 20 else 5
    res = {
        "ms": device_ms(torch, kern, calls, replays),
        "plain_ms": device_ms(torch, plain, calls, replays),
        "library_ms": None,            # no one PyTorch call computes it
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    check(ops.launches()["ssd_scan"] > n0, "timing did not launch ssd_scan")
    eager = {k: eager_ms(torch, f, iters=10) for k, f in
             (("kernel", kern), ("plain", plain))}
    print(f"[time] ssd_scan {label} eager calls, host enqueue included "
          f"(ms): {eager}")
    passes = kernel_times(torch, kern, calls)
    print(f"[time] ssd_scan {label} passes, device us per call: "
          f"{ {k: round(v, 1) for k, v in passes.items()} or 'not measured'}")
    print(f"[time] ssd_scan {label} bound: {t_ops * 1e3:.4f} ms by 3xTF32 "
          f"operations "
          f"at {TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s, {t_bytes * 1e3:.4f} ms "
          f"by bytes; {t_cuda_cores * 1e3:.4f} ms on the CUDA cores at "
          f"{F32_FLOP_PER_S / 1e12:.0f} TFLOP/s")
    print(f"[time] ssd_scan {label} B={B} S={S} H={H} P={P} N={N} G={G} "
          f"chunk={chunk} {x.dtype} strides x {x.stride()} Bm {Bm.stride()}"
          f": {2 * macs / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB, max |y - plain| {dy:.3e}, max |state - "
          f"plain| {ds:.3e}, {res}")
    return res, max(dy, ds)


# flash_attention against its plain version: on the reference kernel
# test's shapes that test's elementwise tolerances (abs + rel), 2e-5 in
# f32, 2e-2 in bf16.  On the model path's own inputs (bf16, 6144 keys of
# head dim 256) the outputs are held normwise, max|out - plain| <=
# 2e-2 * max|plain|: both round p to bf16 before p . v, but against
# running maxima taken over other key blocks (64 against 512).
FA_TOL = {"f32": 2e-5, "bf16": 2e-2, "path_normwise": 2e-2}
BF16_FLOP_PER_S = 989e12        # H100 SXM, dense bf16 tensor cores
# gemma2-9b decode logits at position p against row p of a prefill of the
# same tokens, normwise (max|decode - prefill| <= tol * max|prefill|).
# Both are bf16 through 42 layers; the GEMMs of a 2-row decode and of a
# 12,352-row prefill are different cuBLAS kernels that round at other
# places, and the attention kernel tiles the two differently.
MODEL_TOL = 0.1
# the model phases, each through make_prefill_step / make_decode_step with
# bf16 params from the seed: gemma2-9b whole; phi3.5-MoE at every
# published width, cut to 24 of its 32 layers (whole it is 41.87 B params,
# 78.0 GiB in bf16, which leaves no room for a cache and activations on an
# 80 GB card; cut, 31.47 B and 58.6 GiB, plus a 0.76 GiB cache)
MODEL = dict(tag="model", arch="gemma2-9b", batch=2, prompt=6144,
             decode=32, seed=0, layers=None, per_layer=False)
MOE_MODEL = dict(tag="moe-model", arch="phi3.5-moe-42b-a6.6b", batch=2,
                 prompt=4096, decode=32, seed=0, layers=24, per_layer=True)
# mamba2-1.3b whole (1.34 B params, 2.5 GiB in bf16; its A_log, D,
# dt_bias and norm_scale in f32): every prefill reaches ssd_scan.cu in
# bf16 at 16 chunks of 256, the check's prefill of 4128 tokens at 17
# with a ragged last; decode steps take the plain single-token update
SSM_MODEL = dict(tag="ssm-model", arch="mamba2-1.3b", batch=4, prompt=4096,
                 decode=32, seed=0, layers=None, per_layer=True)
# deepseek-v2-236b at every published width (d_model 5120, 128 heads, MLA
# kv_lora 512, q.k 128 + 64, v 128; 160 experts top-6 x 1536 + 2 shared;
# vocab 102400), cut to 8 of its 60 layers: the dense prefix layer (d_ff
# 12288) and 7 MoE layers, 29.83 B params, 55.6 GiB in bf16 (whole,
# ~240 B params are ~448 GiB).  MLA attends in plain PyTorch (the
# reference's blocked jnp loop: the naive form at prefill, the absorbed
# form at decode), so no kernel launches on this path.  Random weights,
# so it is held per layer as phi3.5-MoE is.
MLA_MODEL = dict(tag="mla-model", arch="deepseek-v2-236b", batch=2,
                 prompt=4096, decode=32, seed=0, layers=8, per_layer=True)
# seamless-m4t-medium whole (977.86 M params, 1.82 GiB in bf16): 12
# encoder layers over 1024 frames from the seed (S / enc_seq_divisor, as
# configs/shapes.py sizes them), 12 decoder layers of causal self- and
# cross-attention, all through flash_attention at D 64 and G 1.  Random
# weights make it chaotic in depth (the comment at LAYER_TOL), so it is
# held per layer.
ENCDEC_MODEL = dict(tag="encdec-model", arch="seamless-m4t-medium", batch=4,
                    prompt=4096, decode=32, seed=0, layers=None,
                    per_layer=True, noise=True)
# pixtral-12b whole (12.25 B params, 22.8 GiB in bf16): each of 2
# sequences is 1024 media embeddings from the seed (the stub frontend's,
# bf16) then 3072 text tokens, the 4096 positions configs/shapes.py
# carves; every prefill and decode step of its 40 layers through
# flash_attention at D 128, GQA 4.  Its random wq and wk make it chaotic
# in depth as seamless is (the comment at LAYER_TOL), so it is held per
# layer against each layer's own bf16 noise.
PIXTRAL_MODEL = dict(tag="vlm-model", arch="pixtral-12b", batch=2,
                     prompt=3072, media=1024, decode=32, seed=0, layers=None,
                     per_layer=True, noise=True)
# jamba-v0.1-52b at every published width (d_model 4096, 32 / 8 heads x
# 128; Mamba2 of 128 SSD heads x P 64, N 128, G 1, conv 4, chunk 256; 16
# experts top-2 x 14336 on the odd layers, dense d_ff 14336 on the even;
# vocab 65536), cut to 16 of its 32 layers, two periods of 8: 2
# attention layers, 14 Mamba layers, 8 MoE FFNs, 26.01 B params and
# 48.4 GiB in bf16 (whole, 51.49 B params are 95.9 GiB, past one 80 GB
# card).  The one stack where attention, Mamba and MoE layers meet:
# flash_attention in 2 layers a call, ssd_scan in 14 a prefill, 8 host
# reads a decode step.
HYBRID_MODEL = dict(tag="hybrid-model", arch="jamba-v0.1-52b", batch=2,
                    prompt=4096, decode=32, seed=0, layers=16,
                    per_layer=True)
# phi3.5-MoE from random weights is chaotic in depth: a difference in
# the last bits grows many times over in every layer, in the reference as
# in the port (tools/moe_depth_witness.py runs both on the CPU at these
# widths), and a token whose top-2 router logits nearly tie then takes
# another expert.  So its decode logits cannot be held against the
# prefill's after 24 layers; the decode path is held to the prefill path
# one layer at a time instead (teacher_forced): each layer's decode
# output, fed the prefill's input at that layer and its cache, within
# LAYER_TOL of the prefill's output (max|decode - prefill| <= LAYER_TOL *
# max|prefill| over the layer's decode rows: bf16 outputs rounded in
# other orders, a few 2^-8 steps), except where that layer's routing
# flips, which at most FLIP_MAX of the (layer, token) pairs may.
# mamba2-1.3b from random weights in bf16 is as sensitive: one bf16 ulp
# in every input element moves a layer's output by ~7 % of its max, and
# by ~50 % after 14 layers, in the reference as in the port
# (tools/ssm_depth_witness.py --dtype bf16), so its decode path is held
# to the prefill the same way (a Mamba layer over the state its prefill
# of the prompt's rows leaves, ``teacher_forced``).  So is seamless-m4t-
# medium, a dense model: its random wq and wk are drawn with the
# reference's fan_in of shape[-2] (the head count), so its attention
# logits have a std of ~64 with no softcap and its attention is close to
# an argmax, and one ulp in every input element moves a bf16 layer's
# output by 13-52 % of its max after one layer and by > 100 % after a
# few, in the reference as in the port (tools/encdec_depth_witness.py).
# Even one layer's bf16 rounding moves its output by several % of its
# max, most in the first layer (the same layer in f32 on the same input;
# the phase prints it by layer), so a fixed LAYER_TOL is no yardstick
# there: each decoder layer's decode is held, as the CPU tests
# hold bf16 results, within BF16_REL times that layer's own bf16-vs-f32
# distance over the decode rows (``layer_noise``); a decode step reads
# the prefill's cross-attention slots.  pixtral-12b is held the same way
# (a spec's ``noise``): its wq and wk are drawn the same way at d_model
# 5120 and 32 heads, so its attention logits have a std of ~300 and one
# bf16 ulp in every input element moves a layer's output by 26 % of its
# max after one layer and by > 100 % after five, in the reference as in
# the port (tools/vlm_depth_witness.py).
LAYER_TOL, FLIP_MAX, BF16_REL = 2e-2, 0.05, 1.0


@contextlib.contextmanager
def route_tap(sink: list):
    """Appends the router's top-k ids of every MoE layer call to ``sink``
    while open (references to its output: no copy, no launch)."""
    from repro_torch.models import moe as moe_mod
    real = moe_mod.route

    def tap(*a, **kw):
        out = real(*a, **kw)
        sink.append(out[1])
        return out
    moe_mod.route = tap
    try:
        yield sink
    finally:
        moe_mod.route = real


def fa_inputs(torch, gen, B, Sq, Sk, H, Hkv, D, dtype):
    f = lambda *shape: torch.randn(*shape, generator=gen).to(dtype).cuda()
    return f(B, Sq, H, D), f(B, Sk, Hkv, D), f(B, Sk, Hkv, D)


def fa_kernel_phase(torch, flash_attention_cuda, flash_attention_ref):
    """The reference test's six shapes in both dtypes, a gemma2-shaped
    case, the decode and ragged prefill shapes, a strided cache slice, and
    equal bits from call to call; returns the largest f32 |kernel -
    plain|."""
    from repro_torch.kernels import flash_attention as fa_mod
    gen = torch.Generator().manual_seed(2)
    worst = 0.0
    # (B, Sq, Sk, H, Hkv, D, causal, window, cap): tests/test_kernels.py's
    # six, then gemma2's local-layer shape cut to 1 x 1000 tokens
    shapes = [(1, 64, 64, 4, 4, 32, True, None, 0.0),
              (2, 100, 100, 4, 2, 32, True, None, 0.0),
              (1, 64, 64, 4, 1, 64, True, None, 0.0),
              (1, 96, 96, 2, 2, 32, True, 32, 50.0),
              (1, 64, 64, 4, 4, 32, False, None, 0.0),
              (2, 1, 128, 4, 2, 32, True, None, 0.0),
              (1, 1000, 1000, 16, 8, 256, True, 512, 50.0),
              # split-K decode: gemma2's decode shape, 4 rows x G 8
              (2, 1, 6176, 16, 8, 256, False, None, 50.0),
              (2, 4, 1000, 16, 2, 128, True, 700, 30.0),
              # wgmma prefill, rows not a multiple of 128 (3 tiles)
              (2, 333, 333, 16, 8, 128, True, 256, 50.0)]
    for B, Sq, Sk, H, Hkv, D, causal, window, cap in shapes:
        for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k, v = fa_inputs(torch, gen, B, Sq, Sk, H, Hkv, D, dtype)
            kw = dict(causal=causal, window=window, logit_softcap=cap)
            out = flash_attention_cuda(q, k, v, **kw)
            ref = flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            d = (out.float() - ref.float()).abs()
            tol = FA_TOL[key]
            check(out.dtype == dtype and out.shape == q.shape,
                  f"flash_attention: output {out.dtype} {tuple(out.shape)}")
            check(bool((d <= tol + tol * ref.float().abs()).all()),
                  f"flash_attention B{B}_Sq{Sq}_Sk{Sk}_H{H}_{Hkv}_D{D} {key}:"
                  f" differs from plain by {d.max().item()}")
            if key == "f32":
                worst = max(worst, d.max().item())
            print(f"[kernel] flash_attention B{B} Sq{Sq} Sk{Sk} H{H}/{Hkv} "
                  f"D{D} causal={causal} window={window} cap={cap} {key} "
                  f"({fa_mod.last_path}): "
                  f"max |out - plain| {d.max().item():.3e} (tol {tol} abs "
                  f"+ rel)")
    # a decode over a strided slice of a cache, in place and as a copy
    for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        q, ck, cv = fa_inputs(torch, gen, 2, 1, 3000, 16, 8, 256, dtype)
        ks, vs = ck[:, 900:2901], cv[:, 900:2901]
        out = flash_attention_cuda(q, ks, vs, causal=False,
                                   logit_softcap=50.0)
        copy = flash_attention_cuda(q, ks.contiguous(), vs.contiguous(),
                                    causal=False, logit_softcap=50.0)
        ref = flash_attention_ref(q, ks, vs, causal=False, logit_softcap=50.0)
        d = (out.float() - ref.float()).abs()
        check(torch.equal(out, copy), "flash_attention: strided slice != "
                                      "its contiguous copy")
        check(bool((d <= FA_TOL[key] + FA_TOL[key] * ref.float().abs()).all()),
              f"flash_attention strided {key}: differs by {d.max().item()}")
        if key == "f32":
            worst = max(worst, d.max().item())
        print(f"[kernel] flash_attention strided cache slice (2001 of 3000 "
              f"slots) {key}: equal to the copy's bits, max |out - plain| "
              f"{d.max().item():.3e}")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = fa_inputs(torch, gen, 2, 777, 777, 16, 8, 256, dtype)
        a = flash_attention_cuda(q, k, v, window=300, logit_softcap=50.0)
        b = flash_attention_cuda(q, k, v, window=300, logit_softcap=50.0)
        check(torch.equal(a, b), f"flash_attention {dtype}: two calls differ")
    print("[kernel] flash_attention: call == call, bit for bit")
    return worst


def visible_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """(q, k) pairs the mask leaves, positions the implicit aranges."""
    n = 0
    for q in range(Sq):
        hi = min(Sk, q + 1) if causal else Sk
        lo = max(0, q - window + 1) if window is not None else 0
        n += max(0, hi - lo)
    return n


def model_phase(torch, ops, spec):
    """One model (``MODEL``, ``MOE_MODEL``, ``SSM_MODEL``, ``MLA_MODEL``,
    ``ENCDEC_MODEL``, ``PIXTRAL_MODEL`` or ``HYBRID_MODEL``) at full width
    through ``make_prefill_step`` / ``make_decode_step``: prefill B x S
    tokens (after a VLM's M media embeddings, so P = M + S positions; and
    an encoder-decoder model's frames), then N greedy decode steps from
    position P, twice (the main path), then checks.  Every GQA attention layer launches ``flash_attention``
    once per call, a cross-attention layer once more, an encoder layer
    once per prefill, an MLA layer never (it attends in plain PyTorch);
    every Mamba layer launches ``ssd_scan`` once per prefill and never at
    a decode step.  Returns the main path's own kernel inputs
    (``flash_attention``'s for each pattern position's first layer at
    prefill and at the last decode step, and an encoder-decoder model's
    encoder layer 0 and decoder layer 0's cross-attention beside them;
    ``ssd_scan``'s for layer 0 at the first prefill) and the kernels'
    launches, counted from 0 over the two served runs alone."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.model import Model
    from repro_torch.models import encdec as encdec_mod
    from repro_torch.models import transformer as tf_mod
    from repro_torch.models.params import param_count
    from repro_torch.models.transformer import lm_forward
    from repro_torch.kernels import flash_attention as fa_mod

    tag = spec["tag"]
    card = nvidia_smi()            # the label of every time and size

    def say(msg):
        print(f"[{tag}] {msg}")

    whole = get_config(spec["arch"])
    cfg = (whole if spec["layers"] is None
           else whole.replace(n_layers=spec["layers"]))
    B, S, N = spec["batch"], spec["prompt"], spec["decode"]
    M = spec.get("media", 0)
    P = M + S                      # positions a prefill covers
    moe = cfg.moe
    # launches each call kind must make, by kernel
    n_attn = cfg.first_k_dense + cfg.n_periods * sum(
        s.kind == "attn" for s in cfg.pattern)
    n_gqa = 0 if cfg.mla else n_attn
    n_mamba = cfg.n_layers - n_attn
    n_cross = cfg.n_periods * sum(s.cross_attn for s in cfg.pattern)
    n_enc = cfg.n_enc_layers if cfg.encdec else 0
    want = {"flash_attention": (n_enc + n_gqa + n_cross, n_gqa + n_cross),
            "ssd_scan": (n_mamba, 0)}              # (prefill, decode step)
    model = Model(cfg)
    # shapes on the meta device first: the params must fit beside the
    # cache and the activations
    meta = model.init(device="meta")
    nbytes = sum(p.numel() * p.element_size() for p in meta.parameters())
    free = torch.cuda.mem_get_info()[0]
    check(nbytes < 0.9 * free, f"{cfg.name}: {nbytes / 2**30:.1f} GiB of "
                               f"params, {free / 2**30:.1f} GiB free")
    if cfg is not whole:
        n_whole = param_count(Model(whole).init(device="meta"))
        say(f"depth cut: {cfg.n_layers} of {whole.n_layers} layers, every "
            f"width as published ({n_whole / 1e9:.2f} B params, "
            f"{2 * n_whole / 2**30:.1f} GiB in bf16 whole; "
            f"{param_count(meta) / 1e9:.2f} B, {nbytes / 2**30:.1f} GiB "
            f"cut), so that the params fit one card beside a cache")
    del meta
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(spec["seed"], device="cuda")
    torch.cuda.synchronize()
    ffn = (f"{moe.num_experts} experts top-{moe.top_k} x d_ff "
           f"{moe.expert_d_ff}" if moe else f"d_ff {cfg.d_ff}")
    if moe is not None and moe.num_shared:
        ffn += f" + {moe.num_shared} shared x {moe.shared_d_ff}"
    attn = (f"{n_attn} attention layers, {cfg.n_heads}/{cfg.n_kv_heads} "
            f"heads x {cfg.head_dim_}, window {cfg.pattern[0].window}, "
            f"softcaps {cfg.attn_logit_softcap}/{cfg.final_logit_softcap}"
            if n_gqa else "no attention layer")
    if cfg.mla:
        m = cfg.mla
        attn = (f"{n_attn} MLA attention layers, {cfg.n_heads} heads, "
                f"kv_lora {m.kv_lora_rank}, q.k {m.qk_nope_dim} + "
                f"{m.qk_rope_dim}, v {m.v_head_dim}, {cfg.first_k_dense} "
                f"dense prefix layer(s) of d_ff {cfg.first_dense_d_ff}")
    if cfg.encdec:
        attn += (f"; {n_enc} bidirectional encoder layers, cross-attention "
                 f"in {n_cross} decoder layers")
    ssm = cfg.ssm
    mamba = (f"{n_mamba} Mamba2 layers, "
             f"{ssm.expand * cfg.d_model // ssm.head_dim} SSD heads x P "
             f"{ssm.head_dim}, N {ssm.d_state}, G {ssm.n_groups}, conv "
             f"{ssm.conv_width}, chunk {ssm.chunk}"
             if n_mamba else "no Mamba layer")
    say(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{attn}; {mamba}; {ffn}, vocab {cfg.padded_vocab}; "
        f"{param_count(params) / 1e9:.3f} B params bf16 "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card) in "
        f"{time.perf_counter() - t0:.1f} s")
    # an encoder-decoder model's frames: S / enc_seq_divisor of them, as
    # configs/shapes.py sizes its inputs and cross-attention slots
    enc_cap = S // cfg.enc_seq_divisor if cfg.encdec else 0
    cache_bytes = tree_bytes(torch, model.init_cache(B, P + N, "meta",
                                                     enc_cap=enc_cap))
    slots = f"{P + N} slots" + (f" and {enc_cap} cross-attention slots"
                                if enc_cap else "")
    say(f"cache of {slots}: {cache_bytes / 2**20:.1f} MiB")
    gen = torch.Generator(device="cuda").manual_seed(spec["seed"])
    prompt = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    batch = {"tokens": prompt}
    if cfg.encdec:
        batch["frames"] = torch.randn((B, enc_cap, cfg.d_model),
                                      generator=gen, device="cuda",
                                      dtype=torch.bfloat16)
        say(f"frames {tuple(batch['frames'].shape)} bf16 from seed "
            f"{spec['seed']} (the stub frontend's embeddings)")
    if M:
        batch["media"] = torch.randn((B, M, cfg.d_model), generator=gen,
                                     device="cuda", dtype=torch.bfloat16)
        say(f"media {tuple(batch['media'].shape)} bf16 from seed "
            f"{spec['seed']} (the stub frontend's embeddings) before {S} "
            f"text tokens: {P} positions a sequence")
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    count = lambda: {k: ops.launches().get(k, 0) for k in want}
    n_pattern = len(cfg.pattern)
    n_moe = cfg.n_periods * sum(s.ffn == "moe" for s in cfg.pattern)

    captured = {}
    real, real_ssd = ops.flash_attention, ops.ssd_scan
    # copies in the same (strided) layout
    keep = lambda t: None if t is None else torch.empty_strided(
        t.shape, t.stride(), dtype=t.dtype, device=t.device).copy_(t)

    # the calls to keep, by their index within a call: layer i of the
    # first period is pattern position i (gemma2: 0 local, 1 global); an
    # encoder-decoder model runs its encoder layers first, then each
    # decoder layer's self- and cross-attention
    keep_calls = {kind: {i: f"{kind}{i}" for i in range(n_pattern)}
                  for kind in ("prefill", "decode")}
    if cfg.encdec:
        keep_calls = {"prefill": {0: "prefill-encoder0",
                                  n_enc: "prefill-self0",
                                  n_enc + 1: "prefill-cross0"},
                      "decode": {0: "decode-self0", 1: "decode-cross0"}}

    def tap(label):
        n = itertools.count()

        def f(q, k, v, **kw):
            name = keep_calls[label].get(next(n))
            if name is not None:
                captured[name] = (keep(q), keep(k), keep(v), dict(kw))
            return real(q, k, v, **kw)
        return f

    def tap_ssd(*args, **kw):
        if "ssd_scan" not in captured:         # layer 0 (models.ssd)
            captured["ssd_scan"] = (tuple(keep(t) for t in args),
                                    {k: keep(v) if k == "init_state" else v
                                     for k, v in kw.items()})
        return real_ssd(*args, **kw)

    def taps(on: bool, label: str):
        ops.flash_attention = tap(label) if on else real
        ops.ssd_scan = tap_ssd if on and label == "prefill" else real_ssd

    # the router's top-k ids of every MoE layer call of run 1
    served = []

    def since(n0):
        return {k: v - n0[k] for k, v in count().items()}

    def serve(capture: bool):
        cache = model.init_cache(B, P + N, enc_cap=enc_cap)
        torch.cuda.synchronize()
        n0, t = count(), time.perf_counter()
        with route_tap(served) if capture else contextlib.nullcontext():
            # models.attention and models.ssd call them through ops
            taps(capture, "prefill")
            try:
                logits, cache = prefill(params, cache, batch)
            finally:
                taps(False, "")
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t
            paths["prefill"] = fa_mod.last_path
            per_call = [since(n0)]
            nxt = logits[:, -1:].argmax(-1).to(torch.int32)
            fed, dec = [nxt], []
            t = time.perf_counter()
            for step in range(N):
                n0 = count()
                taps(capture and step == N - 1, "decode")
                try:
                    lg, cache = decode(params, cache, nxt, P + step)
                finally:
                    taps(False, "")
                per_call.append(since(n0))
                paths["decode"] = fa_mod.last_path
                dec.append(lg)
                nxt = lg[:, -1:].argmax(-1).to(torch.int32)
                fed.append(nxt)
            torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t) / N
        check(cache["filled"] == P + N, f"cache filled {cache['filled']}")
        del cache
        return (logits, torch.cat(dec, 1), torch.cat(fed, 1), per_call,
                t_pre, t_dec)

    def check_calls(calls):
        for name, (per_prefill, per_decode) in want.items():
            got = [c[name] for c in calls]
            check(got == [per_prefill] + [per_decode] * N,
                  f"{name} launches per call {got}: expected {per_prefill} "
                  f"per prefill and {per_decode} per decode step")

    paths = {}
    fa_mod.last_path = None
    ops.reset_launches()        # the main path: the two served runs
    pre1, dec1, fed1, calls1, t_pre, t_dec = serve(capture=True)
    if n_gqa:
        check(paths == {"prefill": "wgmma_prefill",
                        "decode": "split_k_decode"},
              f"flash_attention paths {paths}")
        say(f"flash_attention path per call kind: {paths}")
    check_calls(calls1)
    check(bool(torch.isfinite(pre1).all())
          and bool(torch.isfinite(dec1).all()), "non-finite logits")
    check(pre1.shape == (B, P, cfg.padded_vocab)
          and dec1.shape == (B, N, cfg.padded_vocab),
          f"logits {tuple(pre1.shape)} {tuple(dec1.shape)}")
    say(f"run 1 on {card}: prefill {B} x {P} positions {t_pre * 1e3:.1f} ms, "
        f"decode {t_dec * 1e3:.2f} ms/token (batch {B}, {N} steps); "
        f"launches per call {calls1[0]} (prefill), {calls1[1]} (each "
        f"decode step)")
    pre2, dec2, fed2, calls2, t_pre2, t_dec2 = serve(capture=False)
    check_calls(calls2)
    launches = count()
    say(f"launches during the two served runs on {card}: "
        f"{ops.launches()}")
    for name in want:
        total = sum(c[name] for c in calls1 + calls2)
        check(launches[name] == total,
              f"{name} launches {launches[name]} against {total} counted "
              f"per call")
    check(torch.equal(fed1, fed2) and torch.equal(pre1, pre2)
          and torch.equal(dec1, dec2),
          "two runs differ: greedy tokens or logits are not bit for bit")
    say(f"run 2 on {card}: prefill {t_pre2 * 1e3:.1f} ms, decode "
        f"{t_dec2 * 1e3:.2f} ms/token; greedy tokens and all logits equal "
        f"to run 1's bit for bit")
    del pre1, pre2, dec2
    torch.cuda.empty_cache()

    # decode logits at position P + j against row P + j of one prefill
    # of the same media and S + N tokens (causal: row p reads 0..p only)
    tokens = torch.cat([prompt, fed1[:, :N]], dim=1)
    cache = model.init_cache(B, P + N, enc_cap=enc_cap)
    routes = []
    # each layer's input (a Mamba layer's all rows, an attention layer's
    # rows P..) and output rows P..
    layers = []
    real_layer = tf_mod.layer_forward

    # with a spec's ``noise``, each (decoder) layer's whole input and the
    # encoder output (None without one), for the bf16 yardstick
    # (``layer_noise``)
    full = []

    def tap_layer(p, cfg_, spec_, x, *a, **kw):
        out = real_layer(p, cfg_, spec_, x, *a, **kw)
        layers.append((x.clone() if spec_.kind != "attn" else
                       x[:, P:].clone(), out[0][:, P:].clone()))
        if spec.get("noise"):
            full.append((x, a[2] if cfg.encdec else None))
        return out
    if spec["per_layer"]:
        tf_mod.layer_forward = tap_layer
    try:
        with route_tap(routes):
            ref, cache = prefill(params, cache, {**batch, "tokens": tokens})
    finally:
        tf_mod.layer_forward = real_layer
    ref = ref[:, P:].float()
    got = dec1.float()
    del dec1
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    if not spec["per_layer"]:
        check(err <= MODEL_TOL * scale,
              f"decode logits differ from the prefill's rows by {err} "
              f"(max|prefill| {scale}, tol {MODEL_TOL} normwise)")
    elif spec.get("noise"):
        # an encoder-decoder model's decoder: its encoder ran once for
        # both paths
        dec = params["decoder"] if cfg.encdec else params
        noise = layer_noise(torch, cfg, dec, full, layers, P)
        del full
        teacher_forced(torch, say, cfg, dec, cache, layers, routes, P,
                       noise)
    elif moe is None:
        teacher_forced(torch, say, cfg, params, cache, layers, routes, P)
    else:
        # the served decode tokens' top-k sets against the check's
        # prefill's, by layer: where decode and prefill part
        srt = lambda t: t.sort(-1).values
        K = moe.top_k
        dec_ids = srt(torch.stack(served[n_moe:]).view(N, n_moe, B, K))
        ref_ids = srt(torch.stack(routes).view(n_moe, B, P + N, K))
        flips = (dec_ids.permute(1, 2, 0, 3) != ref_ids[:, :, P:]).any(-1)
        say(f"routing: the served decode tokens' top-{K} sets differ from "
            f"the check prefill's at {flips.sum().item()} of "
            f"{flips.numel()} (layer, token) pairs; by layer "
            f"{flips.sum((1, 2)).tolist()}")
        teacher_forced(torch, say, cfg, params, cache, layers, routes, P)
    held = ("not held, see LAYER_TOL; tol" if spec["per_layer"]
            else "tol")
    say(f"decode vs prefill of the same {P + N} positions, all {N} "
        f"positions: max |decode - prefill| {err:.4f} = "
        f"{err / scale:.4f} of max|prefill| {scale:.3f} ({held} "
        f"{MODEL_TOL}); greedy tokens agree at {agree:.1%} of positions")
    del ref, got, tokens, cache, served, routes, layers
    torch.cuda.empty_cache()

    # the metrics of a prefill through forward, host syncs per decode
    # step, the device's busy share, the metrics of one decode step
    cache = model.init_cache(B, P + N, enc_cap=enc_cap)
    with torch.no_grad():
        _, cache, met = model.forward(params, batch, cache)
    if moe is not None:
        counts = met["expert_counts"]
        per_layer = B * P * moe.top_k * n_moe // cfg.n_periods
        check(tuple(counts.shape) == (cfg.n_periods, moe.num_experts)
              and bool((counts.sum(1) == per_layer).all()),
              f"prefill expert_counts {counts.tolist()}: rows must sum to "
              f"{per_layer}")
        say(f"experts used per layer at prefill (of {moe.num_experts}): "
            f"{(counts > 0).sum(1).tolist()}; tokens per expert min / max "
            f"{counts.min().item()} / {counts.max().item()} (mean "
            f"{per_layer / moe.num_experts:g}); aux_loss "
            f"{met['aux_loss'].item():.4f}")
    nxt = fed1[:, :1]
    steps = iter(range(8))             # 4 steps each, positions P..P+7
    dstep = lambda _: decode(params, cache, nxt, P + next(steps))
    syncs = host_syncs(torch, dstep, [None] * 4)
    # the expert GEMMs by their width, unless a dense FFN shares it (jamba)
    dense_dims = {cfg.d_ff for s in cfg.pattern if s.ffn == "dense"}
    gemm_dim = (moe.expert_d_ff if moe is not None
                and moe.expert_d_ff not in dense_dims else None)
    spans = contextlib.ExitStack()
    if cfg.mla:
        spans.enter_context(span(torch, tf_mod, "mla_forward"))
    if cfg.encdec:
        spans.enter_context(span(torch, encdec_mod, "encoder_forward"))
    with spans:
        profile_steps(torch, f"{cfg.name} decode on {card}", dstep,
                      [None] * 4, gemm_dim)
        profile_steps(torch, f"{cfg.name} prefill on {card}",
                      lambda _: prefill(params, cache, batch), [None],
                      gemm_dim)
    if moe is not None:
        # at the filled position: P + 8 after the steps above, P over a
        # Mamba state, which the profile's prefill restarted
        with torch.no_grad():
            _, cache, met = lm_forward(params, cfg, nxt, cache["filled"],
                                       cache=cache)
        counts = met["expert_counts"]
        per_layer = B * moe.top_k * n_moe // cfg.n_periods
        check(bool((counts.sum(1) == per_layer).all()),
              f"decode expert_counts {counts.tolist()}: rows must sum to "
              f"{per_layer}")
        say(f"decode step expert_counts rows sum to {per_layer}; experts "
            f"used per layer {(counts > 0).sum(1).tolist()}")
    expected = (f"one per MoE layer, {n_moe}" if moe is not None else "0")
    say(f"on {card}: host syncs per decode step: {syncs:g} (expected "
        f"{expected}); "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del cache, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return captured, launches


def layer_noise(torch, cfg, params, full, layers, S):
    """Each (decoder) layer's own bf16 noise over the decode rows: the
    layer in f32 (its weights cast up) on the bf16 prefill's whole input
    (and encoder output, if any), against that prefill's bf16 output, max
    |difference| over max |bf16 output|.  ``params``: the decoder-only
    tree (an encoder-decoder model's ``decoder``); ``full``: each layer
    call's (input, encoder output or None), in ``lm_forward``'s order;
    ``layers``: its (rows S.. of the input, rows S.. of the output)."""
    from repro_torch.models.params import index_tree
    from repro_torch.models.transformer import layer_forward
    check(cfg.first_k_dense == 0, "layer_noise walks no dense prefix")
    walk = [(f"pos{pos}", i, spec) for i in range(cfg.n_periods)
            for pos, spec in enumerate(cfg.pattern)]
    check(len(full) == len(walk) == len(layers),
          f"layer_noise: {len(full)} layer calls, {len(walk)} layers")
    up = lambda t: ({k: up(v) for k, v in t.items()} if isinstance(t, dict)
                    else t.float())
    noise = []
    with torch.no_grad():
        for (key, i, spec), (x, enc), (_, out) in zip(walk, full, layers):
            lp = up(index_tree(params["blocks"][key], i))
            y32 = layer_forward(lp, cfg, spec, x.float(), 0, None,
                                None if enc is None else enc.float())
            y32 = y32[0][:, S:]
            noise.append(((out.float() - y32).abs().max()
                          / out.float().abs().max()).item())
            del lp, y32
    return noise


def teacher_forced(torch, say, cfg, params, cache, layers, routes, S,
                   noise=None):
    """Each layer of the decode path against the prefill path where no
    depth has amplified anything: for every layer l and decode position
    p = S + j, ``layer_forward`` on one token, fed the prefill's input
    to layer l at row p, at start p, the layers walked in
    ``lm_forward``'s order (the dense prefix layers first, with their own
    params and caches).  An attention layer steps over the prefill's
    cache of layer l (the step writes its own k, v, or an MLA layer's
    ``ckv`` and ``k_rope``, at p, as a decode does; a cross-attention
    layer reads the ``enc_len`` slots of ``xkv`` the prefill wrote, as a
    decode does); a Mamba layer over
    its own state, made by a prefill of layer l on the prefill's inputs
    at rows 0..S-1 and advanced by the steps j = 0, 1, ... in turn.  Its output must lie within
    ``LAYER_TOL`` of the prefill's output at row p (normwise over the
    layer's decode rows) wherever the step routes as the prefill did; at
    most ``FLIP_MAX`` of the (MoE layer, token) pairs may route
    otherwise.  ``layers``: each layer call's (input, output), the input
    of a Mamba layer all rows, the rest rows S..; ``routes``: each MoE
    layer call's top-k ids.  With ``noise`` (``layer_noise``, for a spec
    with ``noise``: seamless, pixtral) each layer's output is held within
    ``BF16_REL`` times its own bf16 noise instead of ``LAYER_TOL``."""
    from repro_torch.models.config import LayerSpec
    from repro_torch.models.params import index_tree
    from repro_torch.models.transformer import init_layer_cache, \
        layer_forward
    B, N = layers[0][1].shape[:2]
    K = cfg.moe.top_k if cfg.moe is not None else 0
    srt = lambda t: t.sort(-1).values
    # the layers in lm_forward's order: the dense prefix, then the stacks
    dense = LayerSpec(kind="attn", ffn="dense")
    walk = [(params[f"prefix{i}"], cache[f"prefix{i}"], dense)
            for i in range(cfg.first_k_dense)]
    walk += [(index_tree(params["blocks"][f"pos{pos}"], i),
              index_tree(cache["blocks"][f"pos{pos}"], i), spec)
             for i in range(cfg.n_periods)
             for pos, spec in enumerate(cfg.pattern)]
    check(len(layers) == len(walk) == cfg.n_layers,
          f"teacher-forced: {len(layers)} layer calls captured, "
          f"{len(walk)} layers walked, {cfg.n_layers} in the config")
    errs, flips, m, picked = [], [], 0, []
    with route_tap(picked), torch.no_grad():
        for (lp, lc, spec), (x_in, x_out) in zip(walk, layers):
            if spec.kind != "attn":
                lc = init_layer_cache(cfg, spec, B, 0, x_in.device)
                layer_forward(lp, cfg, spec, x_in[:, :S], 0, lc,
                              aux_loss=False)
                x_in = x_in[:, S:]
            ref_ids = None
            if spec.ffn == "moe":
                ref_ids = routes[m].view(B, -1, K)[:, S:]
                m += 1
            row_err, row_flip = [], []
            for j in range(N):
                picked.clear()
                y, _, _ = layer_forward(
                    lp, cfg, spec, x_in[:, j:j + 1], S + j, lc,
                    aux_loss=False, enc_len=cache.get("enc_len"))
                row_err.append((y[:, 0] - x_out[:, j]).abs().amax(-1))
                row_flip.append(
                    (srt(picked[-1]) != srt(ref_ids[:, j])).any(-1)
                    if ref_ids is not None else
                    torch.zeros(B, dtype=torch.bool, device=y.device))
            errs.append(torch.stack(row_err, 1)
                        / x_out.float().abs().max())    # (B, N)
            flips.append(torch.stack(row_flip, 1))
    err = torch.stack(errs).float()                 # (layers, B, N)
    flip = torch.stack(flips)
    kept = err[~flip]
    by_layer = err.masked_fill(flip, 0).amax((1, 2))
    say(f"teacher-forced decode, layer by layer ({err.shape[0]} layers x "
        f"{B * N} tokens, each fed the prefill's input, over the prefill's "
        f"cache or the state after the prompt): routing differs from the "
        f"prefill's at {flip.sum().item()} of {m * B * N} (MoE layer, "
        f"token) pairs (tol {FLIP_MAX:.0%}); output vs the prefill's, "
        f"normwise, by layer {[round(x, 4) for x in by_layer.tolist()]} "
        f"({'held below' if noise is not None else f'tol {LAYER_TOL}'})")
    check(flip.sum().item() <= FLIP_MAX * m * B * N,
          f"teacher-forced decode routes otherwise than the prefill at "
          f"{flip.sum().item()} of {m * B * N} (MoE layer, token) pairs")
    if noise is not None:
        ratio = [e / n for e, n in zip(by_layer.tolist(), noise)]
        say(f"each layer's own bf16 noise (the layer in f32 on the same "
            f"input), normwise, by layer {[round(x, 4) for x in noise]}; "
            f"decode error / noise {[round(x, 3) for x in ratio]} (tol "
            f"{BF16_REL}; {LAYER_TOL} is no yardstick here)")
        check(max(ratio) <= BF16_REL,
              f"a teacher-forced decode layer differs from the prefill's "
              f"by {max(ratio)} x its own bf16 noise (tol {BF16_REL})")
        return
    check(kept.numel() == 0 or kept.max().item() <= LAYER_TOL,
          f"a teacher-forced decode layer differs from the prefill's by "
          f"{kept.max().item()} (normwise, tol {LAYER_TOL})")


def time_flash_attention(torch, flash_attention_cuda, flash_attention_ref,
                         captured, label):
    """The main path's own inputs: the kernel against its plain version
    (normwise), its device time beside the plain version's, SDPA's on the
    same shapes without softcap and window (a yardstick the port never
    calls) and its bound.  Returns each captured call's numbers and the
    largest normwise error."""
    from repro_torch.kernels import flash_attention as fa_mod
    F = torch.nn.functional
    rows, worst = {}, 0.0
    for name in sorted(captured):
        q, k, v, kw = captured[name]
        B, Sq, H, D = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        out = flash_attention_cuda(q, k, v, **kw)
        path = fa_mod.last_path
        plain = flash_attention_ref(q, k, v, **kw)
        err = (out.float() - plain.float()).abs().max().item()
        scale = plain.float().abs().max().item()
        check(err <= FA_TOL["path_normwise"] * scale,
              f"flash_attention {name} on the main path's inputs differs "
              f"from plain by {err} (max|plain| {scale})")
        worst = max(worst, err / scale)
        pairs = visible_pairs(Sq, Sk, kw["causal"], kw["window"])
        flops = 4 * D * pairs * B * H
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=kw["causal"], enable_gqa=True)
        big = Sq > 1
        calls, replays = (3, 3) if big else (20, 10)
        row = {
            "ms": device_ms(torch, lambda: flash_attention_cuda(q, k, v, **kw),
                            calls, replays),
            "plain_ms": device_ms(torch, lambda: flash_attention_ref(
                q, k, v, **kw), calls, replays),
            "library_ms": device_ms(torch, lib, calls, replays),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
        rows[name] = row
        print(f"[time] flash_attention {name} ({label(name)}, {path}) q "
              f"{tuple(q.shape)} k/v {tuple(k.shape)} strides {k.stride()}"
              f" causal={kw['causal']} window={kw['window']} "
              f"cap={kw['logit_softcap']}: {pairs} visible pairs per (b, h), "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; max |out - "
              f"plain| {err:.3e} = {err / scale:.2e} of max|plain|; {row}")
    return rows, worst


# ---------------------------------------------------------------------------
# Training (phases 14-17)
# ---------------------------------------------------------------------------

# flash_attention's backward against its plain version (autograd through
# flash_attention_ref): the yardstick is the plain version's gradient in
# f32, and the kernel's bf16 gradient must lie within BWD_BF16_REL times
# the plain version's own bf16 distance from it, normwise over dq, dk and
# dv together (a row that sees one key has dq = 0 exactly)
BWD_BF16_REL = 2.0
# (B, Sq, Sk, H, Hkv, D, causal, window, cap, label): tests/test_kernels.py's
# flash shapes, starcoder2-3b's layer, gemma2-9b's local layer and
# seamless-m4t-medium's encoder layer
BWD_SHAPES = [(1, 64, 64, 4, 4, 32, True, None, 0.0, "test MHA causal"),
              (2, 100, 100, 4, 2, 32, True, None, 0.0, "test GQA ragged"),
              (1, 64, 64, 4, 1, 64, True, None, 0.0, "test MQA"),
              (1, 96, 96, 2, 2, 32, True, 32, 50.0, "test window+cap"),
              (1, 64, 64, 4, 4, 32, False, None, 0.0, "test bidirectional"),
              (2, 1, 128, 4, 2, 32, True, None, 0.0, "test decode-shaped"),
              (4, 2048, 2048, 24, 2, 128, True, None, 0.0,
               "starcoder2-3b layer"),
              (1, 6144, 6144, 16, 8, 256, True, 4096, 50.0,
               "gemma2-9b local layer"),
              (4, 1024, 1024, 16, 16, 64, False, None, 0.0,
               "seamless-m4t-medium encoder layer")]
TRAIN_MAIN_SHAPE = "starcoder2-3b layer"
# lr 1e-4 (the driver's default 1e-3 is a smoke config's rate: at 2
# layers it spikes the loss to 17.9 before it falls).  The whole model's
# loss does not fall in 6 steps at any rate: with the reference's random
# init its gradient grows 2-3x a layer and is chaotic in depth, in the
# reference as in the port (tools/train_depth_witness.py), so the
# clip-by-global-norm leaves all but the first layers' updates ~0.  The
# 2-layer run of the resume phase is where the loss is held to fall.
TRAIN = dict(arch="starcoder2-3b", batch=4, seq=2048, steps=6, lr=1e-4)
RESUME = dict(arch="starcoder2-3b", layers=2, batch=4, seq=2048, steps=10,
              crash=7, every=5, lr=1e-4)
TRAIN_MOE = dict(arch="phi3.5-moe-42b-a6.6b", layers=2, batch=4, seq=2048,
                 steps=16, every=4, coverage=0.7, fault=8)


def bwd_inputs(torch, gen, B, Sq, Sk, H, Hkv, D):
    f = lambda *shape: torch.randn(*shape, generator=gen).cuda()
    return f(B, Sq, H, D), f(B, Sk, Hkv, D), f(B, Sk, Hkv, D), \
        f(B, Sq, H, D)


def train_kernel_phase(torch, smi):
    """``[train-kernel]``: the backward kernel against the plain backward
    on ``BWD_SHAPES``, equal bits from call to call, and its times.
    Returns (the main shape's max |kernel - plain f32| normwise share,
    its timing row)."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels.ref import flash_attention_bwd_ref
    F = torch.nn.functional
    gen = torch.Generator().manual_seed(5)
    main_row, main_err = None, None
    for B, Sq, Sk, H, Hkv, D, causal, window, cap, label in BWD_SHAPES:
        kw = dict(causal=causal, window=window, logit_softcap=cap)
        q, k, v, do = bwd_inputs(torch, gen, B, Sq, Sk, H, Hkv, D)
        ref32 = flash_attention_bwd_ref(q, k, v, do, **kw)
        qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
        plain = flash_attention_bwd_ref(qb, kb, vb, dob, **kw)
        # the forward's output and logsumexp, as FlashAttentionFn saves
        ob, lseb = fa_mod.flash_attention_cuda(qb, kb, vb, return_lse=True,
                                               **kw)
        run = lambda: fa_mod.flash_attention_bwd_cuda(qb, kb, vb, ob, lseb,
                                                      dob, **kw)
        got = run()
        path = fa_mod.last_bwd_path
        again = run()
        torch.cuda.synchronize()
        check(path == fa_mod.bwd_path(D, torch.bfloat16),
              f"flash_attention_bwd {label}: took {path}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash_attention_bwd {label}: two calls differ")
        d = lambda a, b: (a.float() - b.float()).abs().max().item()
        err = max(d(g, r) for g, r in zip(got, ref32))
        noise = max(d(p, r) for p, r in zip(plain, ref32))
        scale = max(r.abs().max().item() for r in ref32)
        check(all(torch.isfinite(g).all() for g in got)
              and err <= BWD_BF16_REL * noise,
              f"flash_attention_bwd {label}: max |kernel - plain f32| {err} "
              f"> {BWD_BF16_REL} x the plain version's own bf16 {noise}")
        pairs = visible_pairs(Sq, Sk, causal, window)
        flops = 10 * B * H * pairs * D
        # q, o, do, k, v read once; dq, dk, dv written once (bf16)
        nbytes = (4 * qb.numel() + 4 * kb.numel()) * 2
        t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        big = Sq * Sk > 1e6
        row = {"ms": device_ms(torch, run, *((3, 3) if big else (20, 10))),
               "plain_ms": eager_ms(torch, lambda: flash_attention_bwd_ref(
                   qb, kb, vb, dob, **kw), 5 if big else 20),
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": None}
        if window is None and not cap:
            # SDPA computes the same function: time its backward alone
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (qb, kb, vb))
            out = F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal,
                                                 enable_gqa=True)
            dot = dob.transpose(1, 2)
            row["library_ms"] = eager_ms(
                torch, lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                   retain_graph=True),
                5 if big else 20)
        groups = (f", {fa_mod.bwd_head_groups(B, Hkv, Sk, H // Hkv)} head "
                  f"groups" if path == "wgmma" else "")
        print(f"[train-kernel] flash_attention_bwd {label} B{B} Sq{Sq} Sk{Sk}"
              f" H{H}/{Hkv} D{D} causal={causal} window={window} cap={cap} "
              f"bf16 ({path}{groups}): max |kernel - "
              f"plain f32| {err:.3e} ({err / scale:.2e} "
              f"of max), the plain version's own bf16 {noise:.3e}; call == "
              f"call bit for bit; {pairs} visible pairs per (b, h), "
              f"{flops / 1e9:.1f} GFLOP; kernel {row['ms']:.4f} ms (graph "
              f"replay), plain {row['plain_ms']:.4f} ms, SDPA backward "
              + (f"{row['library_ms']:.4f} ms" if row["library_ms"]
                 is not None else "none")
              + f", bound {row['bound_ms']:.4f} ms ({row['bound_by']}) on "
              f"{smi}")
        if label == TRAIN_MAIN_SHAPE:
            main_row, main_err = row, err
            # what asking for the logsumexp costs the forward
            fwd = lambda lse: (lambda: fa_mod.flash_attention_cuda(
                qb, kb, vb, return_lse=lse, **kw))
            t_no, t_lse, t_no2, t_lse2 = (device_ms(torch, fwd(x))
                                          for x in (False, True, False, True))
            print(f"[train-kernel] flash_attention forward {label} "
                  f"({fa_mod.last_path}): {t_no:.4f} / {t_no2:.4f} ms "
                  f"without the logsumexp, {t_lse:.4f} / {t_lse2:.4f} ms "
                  f"with it (graph replay, in turns) on {smi}")
            # the host's cost a call (checks, scratch, four tensor maps,
            # launches): 50 calls enqueued, the host clock stopped before
            # the device is waited for (the queue holds their launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                run()
            host = (time.perf_counter() - t0) / 50 * 1e3
            torch.cuda.synchronize()
            print(f"[train-kernel] flash_attention_bwd {label} host "
                  f"enqueue {host:.4f} ms a call")
        del q, k, v, do, ref32, plain, got, again
        gc.collect()
        torch.cuda.empty_cache()
    return main_err, main_row


def train_reckon(torch, cfg, batch: int, seq: int) -> dict:
    """Bytes the training state and the biggest activations take, from the
    config's shapes (the ``meta`` device allocates nothing)."""
    from repro_torch.models.model import Model
    from repro_torch.models.params import param_count
    n = param_count(Model(cfg).init(device="meta"))
    T = batch * seq
    return {"params": n, "bf16 params": 2 * n, "f32 master, m, v": 12 * n,
            "bf16 grads": 2 * n,
            "f32 logits": T * cfg.padded_vocab * 4,
            "remat boundaries": cfg.n_layers * T * cfg.d_model * 2}


def gib(n: float) -> str:
    return f"{n / 2**30:.1f} GiB"


def train_dense_phase(torch, ops, smi) -> None:
    """``[train-dense]``: starcoder2-3b whole through
    ``repro_torch.launch.train.main``; step ms, tokens/s, the device's
    busy share over one profiled step, flash launches a step, losses."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    t = TRAIN
    cfg = get_config(t["arch"])
    r = train_reckon(torch, cfg, t["batch"], t["seq"])
    total = sum(v for k, v in r.items() if k != "params")
    print(f"[train-dense] {cfg.name} whole: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {r['params'] / 1e9:.2f} B params; reckoned "
          + ", ".join(f"{k} {gib(v)}" for k, v in r.items() if k != "params")
          + f": {gib(total)} of the card's 80 GB")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = {"loss": [], "s": [], "launches": [], "gnorm": []}
    prof = {}
    profile_at = profile_last_step(t["steps"], prof)

    def on_step(step, state, metrics, dt, sup):
        rec["loss"].append(float(metrics["loss"]))
        rec["gnorm"].append(float(metrics["grad_norm"]))
        rec["s"].append(dt)
        rec["launches"].append(ops.launches())
        profile_at(step)
    rc = T.main(["--arch", t["arch"], "--batch", str(t["batch"]),
                 "--seq", str(t["seq"]), "--steps", str(t["steps"]),
                 "--lr", str(t["lr"]), "--ckpt-every", "0",
                 "--log-every", "1"], on_step=on_step)
    check(rc == 0, f"train main returned {rc}")
    print(f"[train-dense] losses {rec['loss']}, grad norms {rec['gnorm']}")
    peak = torch.cuda.max_memory_allocated()
    losses = rec["loss"]
    check(all(math.isfinite(x) for x in losses + rec["gnorm"]),
          f"train-dense losses {losses}, grad norms {rec['gnorm']}")
    per = [{k: b.get(k, 0) - a.get(k, 0) for k in b}
           for a, b in zip([{}] + rec["launches"], rec["launches"])]
    for p in per[1:]:
        check(p.get("flash_attention") == 2 * cfg.n_layers
              and p.get("flash_attention_bwd") == cfg.n_layers,
              f"train-dense: flash launches a step {p}")
    ms = statistics.median(rec["s"][1:5]) * 1e3
    share, by = step_by_class(prof)
    print(f"[train-dense] step ms (median of steps 2-5) {ms:.1f}, "
          f"{t['batch'] * t['seq'] / ms * 1e3:.0f} tokens/s, device busy "
          f"{share} (the profiled last step), flash_attention {per[-1]} "
          f"launches a step; peak {gib(peak)} allocated; on {smi}")
    if by:
        print(f"[train-dense] device time by class, ms/step: {by}")


def profile_last_step(steps: int, prof: dict):
    """An ``on_step`` piece: torch.profiler over the last step alone,
    into ``prof`` (``p`` the profiler, ``wall`` the step's seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_

    def at(step):
        if step == steps - 2:
            torch.cuda.synchronize()
            prof["p"] = prof_(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA])
            prof["p"].__enter__()
            prof["t"] = time.perf_counter()
        elif step == steps - 1:
            torch.cuda.synchronize()
            prof["wall"] = time.perf_counter() - prof["t"]
            prof["p"].__exit__(None, None, None)
    return at


def step_by_class(prof: dict):
    """(the device's busy share of the profiled step, its device ms by
    ``KERNEL_CLASSES`` as a printable string, "" without device time)."""
    events = [e for e in prof["p"].key_averages()
              if str(e.device_type).endswith("CUDA")
              and getattr(e, "self_device_time_total", 0) > 0]
    if not events:
        return "not measured (no device time in the trace)", ""
    busy = sum(e.self_device_time_total for e in events) / 1e6
    by = {}
    for e in events:
        cls = next((c for c, pat in KERNEL_CLASSES if re.search(pat, e.key)),
                   "elementwise and other")
        by[cls] = by.get(cls, 0) + e.self_device_time_total
    return (f"{busy / prof['wall']:.1%} of {prof['wall'] * 1e3:.0f} ms",
            ", ".join(f"{c} {v / 1e3:.1f}" for c, v in
                      sorted(by.items(), key=lambda kv: -kv[1])))


def train_plain_check(torch, ops) -> None:
    """The first step's loss and layer-0 grads of a 2-layer starcoder2-3b
    at full width, attention through the kernels, against the same step
    with attention through the plain version: within that step's own
    bf16 noise (the plain version's bf16 run against its f32 run)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models.model import Model
    from repro_torch.models.params import flat_tree, trainable
    cfg = get_config(TRAIN["arch"]).replace(n_layers=2)
    model = Model(cfg)
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq=TRAIN["seq"],
                                     global_batch=TRAIN["batch"]),
                          "cuda").next_batch()
    real = ops.flash_attention

    def plain(q, k, v, *, causal=True, window=None, logit_softcap=0.0,
              **_):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_softcap=logit_softcap)

    def step(f32: bool, through_plain: bool):
        params = trainable(model.init(0, "cuda"))
        if f32:
            params = params.float()
        ops.flash_attention = plain if through_plain else real
        try:
            loss, _ = model.loss(params, batch)
            loss.backward()
        finally:
            ops.flash_attention = real
        out = {k: p.grad[0].float() for k, p in flat_tree(params).items()
               if k.startswith("blocks/")}
        return loss.item(), out

    ops.reset_launches()
    lk, gk = step(False, False)
    n = ops.launches()
    check(n.get("flash_attention_bwd") == cfg.n_layers,
          f"the kernel step launched {n}")
    lp, gp = step(False, True)
    l32, g32 = step(True, True)
    noise = max(abs(lp - l32), 2 ** -8 * abs(l32))
    check(abs(lk - lp) <= noise,
          f"loss through the kernels {lk} vs plain {lp} (f32 {l32})")
    worst = 0.0
    for key in gk:
        err = (gk[key] - gp[key]).abs().max().item()
        nz = (gp[key] - g32[key]).abs().max().item()
        check(err <= nz, f"layer-0 grad {key}: |kernel - plain| {err} > the "
                         f"plain version's own bf16 noise {nz}")
        worst = max(worst, err / max(nz, 1e-30))
    print(f"[train-dense] first step of a 2-layer cut at full width: loss "
          f"through the kernels {lk:.6f}, through the plain attention "
          f"{lp:.6f} (f32 {l32:.6f}); every layer-0 grad within its own "
          f"bf16 noise (worst {worst:.2f} of it)")


def train_resume_phase(torch, ops, smi) -> None:
    """``[train-resume]``: 10 steps uninterrupted, then a crash at step 7
    after a checkpoint at 5 and ``--resume``, synchronous and async: the
    final params, master, m and v equal the uninterrupted run's bit for
    bit."""
    import shutil
    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_config
    from repro_torch.distributed.fault import SimulatedFailure
    from repro_torch.launch import train as T
    from repro_torch.models.params import flat_tree
    t = RESUME
    cfg = get_config(t["arch"]).replace(n_layers=t["layers"])
    r = train_reckon(torch, cfg, t["batch"], t["seq"])
    print(f"[train-resume] {cfg.name} at full width, {t['layers']} of "
          f"{get_config(t['arch']).n_layers} layers, {r['params'] / 1e9:.3f} B"
          f" params, state {gib(r['bf16 params'] + r['f32 master, m, v'])}")
    base = ["--arch", t["arch"], "--layers", str(t["layers"]),
            "--batch", str(t["batch"]), "--seq", str(t["seq"]),
            "--steps", str(t["steps"]), "--lr", str(t["lr"]),
            "--log-every", "1"]
    ckpt = ROOT / "build" / "train_resume_ckpt"
    finals, seen, losses = {}, {}, []

    def keep(tag):
        def on_step(step, state, metrics, dt, sup):
            seen.setdefault(tag, step)
            if tag == "uninterrupted":
                losses.append(float(metrics["loss"]))
            if step == t["steps"] - 1:
                finals[tag] = {k: v.detach().clone() for k, v in
                               flat_tree(state).items()}
        return on_step

    def run(tag, *extra, crash=False):
        t0 = time.perf_counter()
        try:
            rc = T.main(base + list(extra), on_step=keep(tag))
            check(not crash and rc == 0, f"train-resume {tag}: rc {rc}")
        except SimulatedFailure:
            check(crash, f"train-resume {tag}: crashed")
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[train-resume] run {tag}: {time.perf_counter() - t0:.1f} s")

    run("uninterrupted", "--ckpt-every", "0")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"train-resume: the 2-layer model's losses {losses}")
    print(f"[train-resume] uninterrupted losses {losses}")
    for mode in ("sync", "async"):
        shutil.rmtree(ckpt, ignore_errors=True)
        extra = ["--ckpt-every", str(t["every"]), "--ckpt-dir", str(ckpt),
                 "--keep-last", "1"] + (["--ckpt-async"] if mode == "async"
                                        else [])
        run(f"crash-{mode}", *extra, "--fail-at-step", str(t["crash"]),
            crash=True)
        check(latest_step(str(ckpt)) == t["every"],
              f"train-resume {mode}: latest checkpoint "
              f"{latest_step(str(ckpt))}")
        run(f"resume-{mode}", *extra, "--resume")
        check(seen[f"resume-{mode}"] == t["every"],
              f"train-resume {mode}: resumed at {seen[f'resume-{mode}']}")
        ref, got = finals["uninterrupted"], finals[f"resume-{mode}"]
        bad = [k for k in ref if not torch.equal(ref[k], got[k])]
        check(not bad, f"train-resume {mode}: {len(bad)} of {len(ref)} "
                       f"leaves differ from the uninterrupted run: {bad[:6]}")
        print(f"[train-resume] {mode} checkpoint, crash at step "
              f"{t['crash']}, resume from {t['every']}: all {len(ref)} leaves "
              f"(params, master, m, v, step) equal the uninterrupted run's "
              f"bit for bit")
        del finals[f"resume-{mode}"]
    shutil.rmtree(ckpt, ignore_errors=True)


def train_moe_phase(torch, ops, smi) -> None:
    """``[train-moe]``: phi3.5-MoE at every width, 2 of 32 layers, with
    respecialization every 4 steps and a step fault after the first
    activation: a specialized plan activates and its steps run
    ``moe_ffn_hotpath``; the fault deopts and retries the same batch; the
    optimizer's step counter advances once per batch."""
    from repro_torch.configs import get_config
    from repro_torch.core.passes import branch_inject
    from repro_torch.launch import train as T
    t = TRAIN_MOE
    cfg = get_config(t["arch"]).replace(n_layers=t["layers"])
    r = train_reckon(torch, cfg, t["batch"], t["seq"])
    print(f"[train-moe] {cfg.name} at every published width, {t['layers']} "
          f"of {get_config(t['arch']).n_layers} layers, "
          f"{r['params'] / 1e9:.2f} B params; reckoned "
          + ", ".join(f"{k} {gib(v)}" for k, v in r.items() if k != "params"))
    real = branch_inject.moe_ffn_hotpath
    hot_calls = []

    def spy(*a, **kw):
        hot_calls.append(a[3])
        return real(*a, **kw)
    rec = []

    def on_step(step, state, metrics, dt, sup):
        rec.append(dict(step=step, hot=len(hot_calls), dt=dt,
                        plan=sup.active_plan.label,
                        opt=int(state["opt"]["step"]),
                        loss=float(metrics["loss"]), stats=sup.stats()))
    torch.cuda.reset_peak_memory_stats()
    branch_inject.moe_ffn_hotpath = spy
    try:
        rc = T.main(["--arch", t["arch"], "--layers", str(t["layers"]),
                     "--batch", str(t["batch"]), "--seq", str(t["seq"]),
                     "--steps", str(t["steps"]), "--ckpt-every", "0",
                     "--respecialize-every", str(t["every"]),
                     "--hot-coverage", str(t["coverage"]),
                     "--step-fault-at", str(t["fault"]), "--log-every", "1"],
                    on_step=on_step)
    finally:
        branch_inject.moe_ffn_hotpath = real
    check(rc == 0, f"train-moe: rc {rc}")
    hot_steps = [x["step"] for x, prev in zip(rec, [{"hot": 0}] + rec)
                 if x["hot"] > prev["hot"]]
    s = rec[-1]["stats"]
    f = t["fault"]
    check(s["activations"] >= 1 and hot_steps,
          f"train-moe: no specialized step ({s})")
    check(f - 1 in hot_steps and f not in hot_steps,
          f"train-moe: the step before the fault should run the hot path and "
          f"the faulted one the generic step: hot steps {hot_steps}")
    check(s["step_faults"] == 1 and s["retried_steps"] == 0,
          f"train-moe: fault stats {s}")
    check([x["opt"] for x in rec] == list(range(1, t["steps"] + 1)),
          f"train-moe: optimizer steps {[x['opt'] for x in rec]}")
    check(all(math.isfinite(x["loss"]) for x in rec), "train-moe: losses")
    print(f"[train-moe] hot-path steps {hot_steps} (hot sets "
          f"{sorted(set(hot_calls))}); fault at step {f} deopted and retried "
          f"the batch; optimizer step == batches at every step; "
          f"activations {s['activations']}, step_faults {s['step_faults']}, "
          f"respecialize_recoveries {s['respecialize_recoveries']}, health "
          f"{s['health']}, active {s['active']}; losses "
          f"{[round(x['loss'], 4) for x in rec]}; step ms (median) "
          f"{statistics.median(x['dt'] for x in rec) * 1e3:.0f}; peak "
          f"{gib(torch.cuda.max_memory_allocated())} on {smi}")


# mamba2-1.3b's training layer: B 4 x S 2048 (TRAIN_SSM), 64 heads x 64,
# N 128, chunk 256, G 1, x / B / C slices of one bf16 projection
SSD_BWD_MAIN = (4, 2048, 64, 64, 128, 256, 1)
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")
# mamba2-1.3b whole: 48 layers, 1.34 B params, 19 GB of training state;
# the crash at step 4 after a checkpoint at step 3 resumes into steps 3-5
TRAIN_SSM = dict(arch="mamba2-1.3b", batch=4, seq=2048, steps=6, every=3,
                 crash=4, lr=1e-4)
# jamba-v0.1-52b cut to layers 0-1 (Mamba + dense FFN, Mamba + 16-expert
# MoE FFN): 3.8 B params, ~53 GB of training state; a cut with two MoE
# layers (~6.6 B params, ~93 GB) does not fit the card's 80 GB
TRAIN_HYBRID = dict(arch="jamba-v0.1-52b", layers=2, batch=2, seq=2048,
                    steps=4, lr=1e-4)


def ssd_bwd_case(torch, gen, B, S, H, P, N, G, dtype, init: bool,
                 strided: bool = False):
    """``ssd_inputs`` with the cotangents of y and the final state; with
    ``strided`` x, B and C are slices of one projection, as the Mamba2
    block passes them."""
    x, dt, A, Bm, Cm, s0 = ssd_inputs(torch, gen, B, S, H, P, N, G, dtype,
                                      init)
    if strided:
        xBC = torch.cat([x.flatten(2), Bm.flatten(2), Cm.flatten(2)], -1)
        x = xBC[..., :H * P].unflatten(2, (H, P))
        Bm = xBC[..., H * P:H * P + G * N].unflatten(2, (G, N))
        Cm = xBC[..., H * P + G * N:].unflatten(2, (G, N))
    dy = torch.randn(B, S, H, P, generator=gen).to(dtype).cuda()
    dfin = torch.randn(B, H, P, N, generator=gen).cuda()
    return (x, dt, A, Bm, Cm), s0, dy, dfin


def ssd_bwd_compare(torch, label, args, s0, dy, dfin, chunk, key):
    """The kernel (after the forward kernel, whose scratch it reads)
    against the plain backward and the blocked one on one input, each
    gradient normwise within ``SSD_BWD_TOL[key]``; two calls equal bit for
    bit.  Returns (the kernel call, max |kernel - plain| over the
    gradients)."""
    from repro_torch.kernels.ref import ssd_scan_bwd_blocked_ref, \
        ssd_scan_bwd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, \
        ssd_scan_cuda
    _, fin, dacs, states = ssd_scan_cuda(*args, chunk=chunk, init_state=s0,
                                         return_scratch=True)
    run = lambda: ssd_scan_bwd_cuda(*args, dacs, states, fin, dy, dfin,
                                    chunk=chunk)
    got, again = run(), run()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"ssd_scan_bwd {label}: two calls differ")
    kw = dict(dfinal=dfin, init_state=s0)
    worst, rel = 0.0, {}
    for what, ref in (("plain", ssd_scan_bwd_ref(*args, chunk, dy, **kw)),
                      ("blocked", ssd_scan_bwd_blocked_ref(*args, chunk, dy,
                                                           **kw))):
        for name, a, r in zip(SSD_BWD_NAMES, got, ref):
            if r is None:
                continue
            check(a.dtype == r.dtype and bool(torch.isfinite(a).all()),
                  f"ssd_scan_bwd {label} {name}: {a.dtype} vs {r.dtype}")
            err = (a.float() - r.float()).abs().max().item()
            scale = r.float().abs().max().item()
            check(err <= SSD_BWD_TOL[key] * scale,
                  f"ssd_scan_bwd {label} {name}: max |kernel - {what}| "
                  f"{err} > {SSD_BWD_TOL[key]} x {scale}")
            rel[f"{what} {name}"] = err / max(scale, 1e-30)
            if what == "plain":
                worst = max(worst, err)
        del ref
    print(f"[ssd-bwd-kernel] ssd_scan_bwd {label}: call == call bit for "
          f"bit; normwise |kernel - plain| / |kernel - blocked| (tol "
          f"{SSD_BWD_TOL[key]}): " + ", ".join(
              f"{n} {rel[f'plain {n}']:.2e}/{rel[f'blocked {n}']:.2e}"
              for n in SSD_BWD_NAMES if f"plain {n}" in rel))
    return run, worst


def ssd_bwd_kernel_phase(torch, smi):
    """``[ssd-bwd-kernel]``: ``ssd_scan_bwd`` against its plain version
    and its blocked one on ``test_torch_ssd_bwd.py``'s shapes (f32 and
    bf16, an initial state, a final-state cotangent) and on mamba2-1.3b's
    training layer (strided bf16, no initial state, as the model calls
    it); there its device time, the plain version's, the passes' and the
    bound.  Returns (the main shape's max |kernel - plain|, its row)."""
    from repro_torch.kernels.ref import ssd_scan_bwd_ref
    gen = torch.Generator().manual_seed(11)
    # (B, S, H, P, N, chunk, G): tests/test_kernels.py's four, G = 2 and
    # G = 3 with ragged chunks, a 300-step chunk of mamba2's widths
    for B, S, H, P, N, Q, G in [
            (1, 32, 4, 8, 16, 8, 1), (2, 48, 8, 16, 32, 16, 1),
            (1, 40, 2, 8, 16, 16, 1), (2, 64, 8, 16, 16, 32, 1),
            (2, 50, 8, 16, 32, 16, 2), (1, 37, 6, 8, 16, 16, 3),
            (1, 300, 4, 64, 128, 256, 1)]:
        for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            args, s0, dy, dfin = ssd_bwd_case(torch, gen, B, S, H, P, N, G,
                                              dtype, init=True)
            ssd_bwd_compare(torch, f"B{B}_S{S}_H{H}_P{P}_N{N}_Q{Q}_G{G}_"
                            f"{key}", args, s0, dy, dfin, Q, key)
    B, S, H, P, N, Q, G = SSD_BWD_MAIN
    args, s0, dy, _ = ssd_bwd_case(torch, gen, B, S, H, P, N, G,
                                   torch.bfloat16, init=False, strided=True)
    label = "mamba2-1.3b training layer"
    kern, err = ssd_bwd_compare(torch, label, args, None, dy, None, Q,
                                "bf16")
    plain = lambda: ssd_scan_bwd_ref(*args, Q, dy)
    # multiply-adds these inputs need: per chunk the lower triangle of
    # C.B per group; of dy.x, the scores times dy (dx), times C (dB) and
    # times B (dC) per head; the state's four products per head (the
    # local sums, dS B, dS^T x, S^T dy)
    tri = sum(L * (L + 1) // 2 for L in
              (min(Q, S - c0) for c0 in range(0, S, Q)))
    macs = B * (G * tri * N + H * tri * (2 * P + 2 * N) + 4 * H * S * P * N)
    elt = args[0].element_size()
    nc = -(-S // Q)
    # read: x, B, C, dy, dt, A and the forward's dacs, states and final
    # state; written: dx, dB, dC, ddt, dA, dinit
    nbytes = (3 * B * S * H * P * elt + 4 * B * S * G * N * elt
              + 2 * B * S * H * 4 + 2 * H * 4 + B * H * nc * Q * 4
              + B * H * nc * P * N * 4 + 2 * B * H * P * N * 4)
    t_ops = 3 * 2 * macs / TF32_FLOP_PER_S
    t_cuda_cores = 2 * macs / F32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    row = {"ms": device_ms(torch, kern, 3, 5),
           "plain_ms": eager_ms(torch, plain, 3),
           "library_ms": None,          # no one PyTorch call computes it
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    passes = kernel_times(torch, kern, 3)
    print(f"[ssd-bwd-kernel] ssd_scan_bwd {label} B={B} S={S} H={H} P={P} "
          f"N={N} G={G} chunk={Q} bf16 strides x {args[0].stride()}: "
          f"{2 * macs / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; kernel "
          f"{row['ms']:.4f} ms (graph replay), plain {row['plain_ms']:.4f} "
          f"ms, bound {row['bound_ms']:.4f} ms (3xTF32 operations at "
          f"{TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s; {t_bytes * 1e3:.4f} ms by "
          f"bytes; {t_cuda_cores * 1e3:.4f} ms on the CUDA cores at "
          f"{F32_FLOP_PER_S / 1e12:.0f} TFLOP/s, where its products run) on "
          f"{smi}")
    print(f"[ssd-bwd-kernel] ssd_scan_bwd {label} passes, device us per "
          f"call: {({k: round(v, 1) for k, v in passes.items()} or 'not measured')}")
    saved = B * H * nc * (Q + P * N) * 4 + B * H * P * N * 4
    print(f"[ssd-bwd-kernel] the forward's saved scratch at this shape: "
          f"dacs, states and the final state, {saved / 1e6:.1f} MB a layer")
    return err, row


def train_ssm_phase(torch, ops, smi) -> None:
    """``[train-ssm]``: mamba2-1.3b whole through
    ``repro_torch.launch.train.main``: losses and gradient norms finite,
    ``ssd_scan`` (forward and remat recompute) and ``ssd_scan_bwd``
    launches every step, step ms, the last step's device time by class,
    the peak memory; then a crash after a checkpoint and ``--resume``,
    whose final state equals the uninterrupted run's bit for bit."""
    import shutil
    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_config
    from repro_torch.distributed.fault import SimulatedFailure
    from repro_torch.launch import train as T
    from repro_torch.models.params import flat_tree
    t = TRAIN_SSM
    cfg = get_config(t["arch"])
    r = train_reckon(torch, cfg, t["batch"], t["seq"])
    print(f"[train-ssm] {cfg.name} whole: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {r['params'] / 1e9:.2f} B params; reckoned "
          + ", ".join(f"{k} {gib(v)}" for k, v in r.items() if k != "params"))
    base = ["--arch", t["arch"], "--batch", str(t["batch"]),
            "--seq", str(t["seq"]), "--steps", str(t["steps"]),
            "--lr", str(t["lr"]), "--log-every", "1"]
    ckpt = ROOT / "build" / "train_ssm_ckpt"
    rec = {"loss": [], "gnorm": [], "s": [], "launches": []}
    prof, finals, seen = {}, {}, {}
    profile_at = profile_last_step(t["steps"], prof)

    def keep(tag):
        def on_step(step, state, metrics, dt, sup):
            seen.setdefault(tag, step)
            if tag == "uninterrupted":
                rec["loss"].append(float(metrics["loss"]))
                rec["gnorm"].append(float(metrics["grad_norm"]))
                rec["s"].append(dt)
                rec["launches"].append(ops.launches())
                profile_at(step)
            if step == t["steps"] - 1:   # the state on the host
                finals[tag] = {k: v.detach().cpu() for k, v in
                               flat_tree(state).items()}
        return on_step

    def run(tag, *extra, crash=False):
        t0 = time.perf_counter()
        try:
            rc = T.main(base + list(extra), on_step=keep(tag))
            check(not crash and rc == 0, f"train-ssm {tag}: rc {rc}")
        except SimulatedFailure:
            check(crash, f"train-ssm {tag}: crashed")
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[train-ssm] run {tag}: {time.perf_counter() - t0:.1f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run("uninterrupted", "--ckpt-every", "0")
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in rec["loss"] + rec["gnorm"]),
          f"train-ssm losses {rec['loss']}, grad norms {rec['gnorm']}")
    per = [{k: b.get(k, 0) - a.get(k, 0) for k in b}
           for a, b in zip([{}] + rec["launches"], rec["launches"])]
    for p in per[1:]:
        check(p.get("ssd_scan") == 2 * cfg.n_layers
              and p.get("ssd_scan_bwd") == cfg.n_layers
              and not p.get("flash_attention"),
              f"train-ssm: launches a step {p}")
    ms = statistics.median(rec["s"][1:]) * 1e3
    share, by = step_by_class(prof)
    print(f"[train-ssm] losses {rec['loss']}, grad norms {rec['gnorm']}")
    print(f"[train-ssm] step ms (median of steps 2-{t['steps']}) {ms:.1f}, "
          f"{t['batch'] * t['seq'] / ms * 1e3:.0f} tokens/s, device busy "
          f"{share} (the profiled last step), launches a step {per[-1]}; "
          f"peak {gib(peak)} allocated; on {smi}")
    if by:
        print(f"[train-ssm] device time by class, ms/step: {by}")
    shutil.rmtree(ckpt, ignore_errors=True)
    extra = ["--ckpt-every", str(t["every"]), "--ckpt-dir", str(ckpt),
             "--keep-last", "1"]
    run("crash", *extra, "--fail-at-step", str(t["crash"]), crash=True)
    check(latest_step(str(ckpt)) == t["every"],
          f"train-ssm: latest checkpoint {latest_step(str(ckpt))}")
    run("resume", *extra, "--resume")
    check(seen["resume"] == t["every"],
          f"train-ssm: resumed at {seen['resume']}")
    ref, got = finals["uninterrupted"], finals["resume"]
    bad = [k for k in ref if not torch.equal(ref[k], got[k])]
    check(not bad, f"train-ssm: {len(bad)} of {len(ref)} leaves differ from "
                   f"the uninterrupted run: {bad[:6]}")
    print(f"[train-ssm] checkpoint at step {t['every']}, crash at step "
          f"{t['crash']}, resume: all {len(ref)} leaves (params, master, m, "
          f"v, step) equal the uninterrupted run's bit for bit")
    finals.clear()
    shutil.rmtree(ckpt, ignore_errors=True)


def train_hybrid_phase(torch, ops, smi) -> None:
    """``[train-hybrid]``: jamba-v0.1-52b at every published width, cut to
    layers 0-1 (``TRAIN_HYBRID``): the Mamba layers' scans through
    ``ssd_scan`` and ``ssd_scan_bwd`` beside the MoE FFN, losses and
    gradient norms finite, step ms, peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    t = TRAIN_HYBRID
    full = get_config(t["arch"])
    cfg = T.cut_layers(full, t["layers"])
    r = train_reckon(torch, cfg, t["batch"], t["seq"])
    kinds = [f"{s.kind}+{s.ffn}" for s in cfg.pattern]
    print(f"[train-hybrid] {cfg.name} at every published width, layers "
          f"0-{t['layers'] - 1} of {full.n_layers} ({', '.join(kinds)}), "
          f"{r['params'] / 1e9:.2f} B params; reckoned "
          + ", ".join(f"{k} {gib(v)}" for k, v in r.items() if k != "params")
          + f": {gib(sum(v for k, v in r.items() if k != 'params'))} of the "
          f"card's 80 GB")
    mamba = sum(s.kind == "mamba" for s in cfg.pattern)
    rec = []

    def on_step(step, state, metrics, dt, sup):
        rec.append(dict(loss=float(metrics["loss"]), dt=dt,
                        gnorm=float(metrics["grad_norm"]),
                        n=ops.launches()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rc = T.main(["--arch", t["arch"], "--layers", str(t["layers"]),
                 "--batch", str(t["batch"]), "--seq", str(t["seq"]),
                 "--steps", str(t["steps"]), "--lr", str(t["lr"]),
                 "--ckpt-every", "0", "--log-every", "1"], on_step=on_step)
    check(rc == 0, f"train-hybrid: rc {rc}")
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x["loss"]) and math.isfinite(x["gnorm"])
              for x in rec), f"train-hybrid: {rec}")
    per = [{k: b["n"].get(k, 0) - a.get(k, 0) for k in b["n"]}
           for a, b in zip([{}] + [x["n"] for x in rec], rec)]
    for p in per[1:]:
        check(p.get("ssd_scan") == 2 * mamba
              and p.get("ssd_scan_bwd") == mamba,
              f"train-hybrid: launches a step {p}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train-hybrid] losses {[round(x['loss'], 4) for x in rec]}, grad"
          f" norms {[round(x['gnorm'], 3) for x in rec]}; step ms (median) "
          f"{statistics.median(x['dt'] for x in rec[1:]) * 1e3:.0f}; "
          f"launches a step {per[-1]}; peak {gib(peak)} allocated on {smi}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.hot_gather import hot_gather_cuda
    from repro_torch.kernels.ref import flash_attention_ref, \
        hot_gather_ref, ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    smi = nvidia_smi()
    print(f"[header] {smi}")
    print(f"[header] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for name, _ in zip(KERNELS, pool.map(build.build, KERNELS)):
            secs, log = build.build_info[name]
            print(f"[build] {name}: {secs:.1f} s\n{log.strip()}")
    print(f"[build] all kernels {time.perf_counter() - t0:.1f} s")
    sass = sass_counts(build)
    for path, c in sorted(sass.items()):
        print(f"[sass] flash_attention {path}: {c['HGMMA']} HGMMA, "
              f"{c['UTMALDG']} UTMALDG in {c['functions']} functions")
    wg = sass.get("wgmma_prefill", {})
    check(wg.get("HGMMA", 0) > 0 and wg.get("UTMALDG", 0) > 0,
          f"the wgmma prefill's SASS holds no HGMMA or UTMALDG: {sass}")
    bwd = sass_counts(build, "flash_attention_bwd", BWD_KERNELS)
    for path, c in sorted(bwd.items()):
        print(f"[sass] flash_attention_bwd {path}: {c['HGMMA']} HGMMA, "
              f"{c['UTMALDG']} UTMALDG in {c['functions']} functions")
    for path in ("wgmma dk/dv", "wgmma dq"):
        c = bwd.get(path, {})
        check(c.get("HGMMA", 0) > 0 and c.get("UTMALDG", 0) > 0,
              f"flash_attention_bwd's {path} SASS holds no HGMMA or "
              f"UTMALDG: {bwd}")
    log = build.build_info["flash_attention_bwd"][1]
    for entry, (regs, st, ld) in sorted(ptxas_usage(
            log, r"bwd_(dkdv|dq)_wgmma|bwd_(dkdv|dq)I13__nv_bfloat16Li256E"
    ).items()):
        name = re.search(r"bwd_(?:dkdv|dq)\w*?I[^E]*E", entry)
        print(f"[sass] flash_attention_bwd {name.group(0) if name else entry}"
              f": {regs} registers at launch, spill stores {st} B, spill "
              f"loads {ld} B")

    err = {"hot_gather": kernel_phase(torch, hot_gather_cuda,
                                      hot_gather_ref),
           "ssd_scan": ssd_kernel_phase(torch, ssd_scan_cuda, ssd_scan_ref),
           "flash_attention": fa_kernel_phase(torch, flash_attention_cuda,
                                              flash_attention_ref)}

    # each main path: counts zeroed just before it, read just after it
    launches = {}

    def main_path(phase, run, kernels):
        ops.reset_launches()
        t = time.perf_counter()
        out = run()
        counts = ops.launches()
        print(f"[{phase}] launches during the phase: {counts} "
              f"({time.perf_counter() - t:.1f} s)")
        for name in kernels:
            check(counts.get(name, 0) > 0,
                  f"{name} never launched in the {phase} phase")
            launches[name] = launches.get(name, 0) + counts[name]
        return out

    table, hot_ids, idx, serve_cfg, serve_params = main_path(
        "serving", lambda: serving_phase(torch, ops), ("hot_gather",))
    capacity = main_path(
        "frontend", lambda: frontend_phase(torch, serve_cfg, serve_params),
        ("hot_gather",))
    main_path("chaos",
              lambda: chaos_phase(torch, ops, serve_cfg, serve_params),
              ("hot_gather",))
    main_path("chaos-frontend",
              lambda: chaos_frontend_arc(torch, serve_cfg, serve_params,
                                         capacity), ("hot_gather",))
    serve_cli_phase(torch, ops, serve_cfg)
    del serve_params
    gc.collect()
    torch.cuda.empty_cache()
    ssd_args, ssd_kw = main_path("archzoo", lambda: archzoo_phase(torch, ops),
                                 ("ssd_scan", "hot_gather"))

    conformance_phase()
    chaos_conformance_phase()
    fingerprint_phase()

    timing = {"hot_gather": time_hot_gather(torch, hot_gather_cuda,
                                            hot_gather_ref, table, hot_ids,
                                            idx)}
    # the serving shape with every other token replaced by a cold id
    gen = torch.Generator(device="cuda").manual_seed(3)
    cold = torch.arange(table.shape[0], device="cuda", dtype=torch.int32)
    cold = cold[~torch.isin(cold, hot_ids)]
    half_cold = idx.clone()
    half_cold[::2] = cold[torch.randint(0, cold.numel(),
                                        (half_cold[::2].numel(),),
                                        generator=gen, device="cuda")]
    time_hot_gather(torch, hot_gather_cuda, hot_gather_ref, table, hot_ids,
                    half_cold, label="half cold")
    timing["ssd_scan"], path_err = time_ssd_scan(
        torch, ssd_scan_cuda, ssd_scan_ref, ssd_args, ssd_kw)
    err["ssd_scan"] = max(err["ssd_scan"], path_err)

    # the earlier phases' tensors go before the model's 18.5 GB of params
    del table, hot_ids, idx, ssd_args, ssd_kw
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    captured, served = model_phase(torch, ops, MODEL)
    print(f"[model] phase {time.perf_counter() - t:.1f} s")
    check(served["flash_attention"] > 0,
          "flash_attention never launched in the model phase")
    launches["flash_attention"] = served["flash_attention"]
    rows, path_err = time_flash_attention(
        torch, flash_attention_cuda, flash_attention_ref, captured,
        lambda name: "local layer" if name.endswith("0") else "global layer")
    timing["flash_attention"] = rows["prefill1"]
    print(f"[time] flash_attention main-path normwise error {path_err:.3e}")
    del captured
    gc.collect()
    torch.cuda.empty_cache()

    # phi3.5-MoE, after gemma2's params and inputs are gone
    t = time.perf_counter()
    captured, served = model_phase(torch, ops, MOE_MODEL)
    print(f"[moe-model] phase {time.perf_counter() - t:.1f} s")
    check(served["flash_attention"] > 0,
          "flash_attention never launched in the moe-model phase")
    launches["flash_attention"] += served["flash_attention"]
    _, moe_err = time_flash_attention(
        torch, flash_attention_cuda, flash_attention_ref, captured,
        lambda name: "phi3.5-MoE layer 0")
    print(f"[time] flash_attention phi3.5-MoE path normwise error "
          f"{moe_err:.3e}")
    del captured
    gc.collect()
    torch.cuda.empty_cache()

    # mamba2-1.3b, after phi3.5-MoE's params and inputs are gone
    t = time.perf_counter()
    captured, served = model_phase(torch, ops, SSM_MODEL)
    print(f"[ssm-model] phase {time.perf_counter() - t:.1f} s")
    check(served["ssd_scan"] > 0 and served["flash_attention"] == 0,
          f"ssm-model launches {served}")
    launches["ssd_scan"] += served["ssd_scan"]
    args, kw = captured["ssd_scan"]
    _, ssm_err = time_ssd_scan(torch, ssd_scan_cuda, ssd_scan_ref, args, kw,
                               label="mamba2-1.3b layer 0 prefill",
                               tol="bf16", calls=5)
    err["ssd_scan"] = max(err["ssd_scan"], ssm_err)
    del captured, args, kw
    gc.collect()
    torch.cuda.empty_cache()

    # deepseek-v2, after mamba2's params and inputs are gone: MLA attends
    # in plain PyTorch, so the phase launches no kernel
    t = time.perf_counter()
    captured, served = model_phase(torch, ops, MLA_MODEL)
    print(f"[mla-model] phase {time.perf_counter() - t:.1f} s")
    check(not captured and served == {"flash_attention": 0, "ssd_scan": 0},
          f"mla-model launches {served}")
    launches["flash_attention"] += served["flash_attention"]
    launches["ssd_scan"] += served["ssd_scan"]

    # seamless-m4t-medium whole, after deepseek-v2's params are gone
    t = time.perf_counter()
    captured, served = model_phase(torch, ops, ENCDEC_MODEL)
    print(f"[encdec-model] phase {time.perf_counter() - t:.1f} s")
    check(served["flash_attention"] > 0 and served["ssd_scan"] == 0,
          f"encdec-model launches {served}")
    launches["flash_attention"] += served["flash_attention"]
    _, encdec_err = time_flash_attention(
        torch, flash_attention_cuda, flash_attention_ref, captured,
        lambda name: f"seamless-m4t-medium {name.split('-')[1][:-1]} "
                     f"layer 0 on {smi}")
    print(f"[time] flash_attention seamless-m4t-medium path normwise error "
          f"{encdec_err:.3e}")
    del captured
    gc.collect()
    torch.cuda.empty_cache()

    # pixtral-12b whole, media before the text, after seamless's params
    t = time.perf_counter()
    captured, served = model_phase(torch, ops, PIXTRAL_MODEL)
    print(f"[vlm-model] phase {time.perf_counter() - t:.1f} s")
    check(served["flash_attention"] > 0 and served["ssd_scan"] == 0,
          f"vlm-model launches {served}")
    launches["flash_attention"] += served["flash_attention"]
    _, vlm_err = time_flash_attention(
        torch, flash_attention_cuda, flash_attention_ref, captured,
        lambda name: f"pixtral-12b layer 0 on {smi}")
    print(f"[time] flash_attention pixtral-12b path normwise error "
          f"{vlm_err:.3e}")
    del captured
    gc.collect()
    torch.cuda.empty_cache()

    # jamba-v0.1-52b, 16 of 32 layers, after pixtral's params are gone
    t = time.perf_counter()
    captured, served = model_phase(torch, ops, HYBRID_MODEL)
    print(f"[hybrid-model] phase {time.perf_counter() - t:.1f} s")
    check(served["flash_attention"] > 0 and served["ssd_scan"] > 0,
          f"hybrid-model launches {served}")
    launches["flash_attention"] += served["flash_attention"]
    launches["ssd_scan"] += served["ssd_scan"]
    args, kw = captured["ssd_scan"]
    _, hybrid_err = time_ssd_scan(torch, ssd_scan_cuda, ssd_scan_ref, args,
                                  kw, label="jamba-v0.1-52b layer 0 prefill",
                                  tol="bf16", calls=5)
    err["ssd_scan"] = max(err["ssd_scan"], hybrid_err)
    del captured, args, kw
    gc.collect()
    torch.cuda.empty_cache()
    # training, after jamba's params are gone
    err["flash_attention_bwd"], timing["flash_attention_bwd"] = \
        train_kernel_phase(torch, smi)
    main_path("train-dense", lambda: train_dense_phase(torch, ops, smi),
              ("flash_attention", "flash_attention_bwd"))
    train_plain_check(torch, ops)
    main_path("train-resume", lambda: train_resume_phase(torch, ops, smi),
              ("flash_attention", "flash_attention_bwd"))
    main_path("train-moe", lambda: train_moe_phase(torch, ops, smi),
              ("flash_attention", "flash_attention_bwd"))
    err["ssd_scan_bwd"], timing["ssd_scan_bwd"] = ssd_bwd_kernel_phase(
        torch, smi)
    gc.collect()
    torch.cuda.empty_cache()
    main_path("train-ssm", lambda: train_ssm_phase(torch, ops, smi),
              ("ssd_scan", "ssd_scan_bwd"))
    main_path("train-hybrid", lambda: train_hybrid_phase(torch, ops, smi),
              ("ssd_scan", "ssd_scan_bwd"))
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches[name],
                            max_abs_err=err[name], **timing[name]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
