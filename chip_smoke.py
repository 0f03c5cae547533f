#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_reid_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases kernels,serve,...]

With `--phases` only the named phases run (kernels, minsum, grad, zero_shot,
rerank, serve, vehicle, eva02, train, cli, multitask, resnet, variants, cache,
multidevice, tp, tools); such a run
is no pass: it prints {"ok": false, "partial": [...]} as its last line and
exits with code 3.

1. Prints the card and sets fp32 matmuls and convolutions to full fp32.
2. Builds the hand-written kernels from tpu_reid_torch/csrc/ into
   build/kernels/ (one nvcc per source, all at once).
3. kernels: holds every kernel against its plain PyTorch version on the
   card: each block kernel alone at the main path's shapes (ViT-B/16,
   256x128, stride 12: 211 tokens, 128 images per pass, bf16), timed with
   CUDA events beside the plain version and a library yardstick, then
   fused_mha (pre-LN and without, timed beside F.layer_norm +
   F.multi_head_attention_forward), fused_mlp (beside F.layer_norm +
   F.linear + QuickGELU + F.linear) and the whole block composed from them
   (beside nn.TransformerEncoderLayer(norm_first=True) with QuickGELU);
   fused_mha / fused_mlp / mha_core at B=64 for S=211, S=213 with the
   deep-prompt splice and the causal text S=77, exact and fast, bf16
   and fp32; whole blocks at B=64 for every variant the main paths take;
   the CLS tail at B=128 and B=512 (both timed, by CUDA events and by the
   kernels' own durations in a profiler trace, beside the FMA kernel it
   replaced in bf16, the library call and the design that lost) and at the
   shapes that leave its fast lane. Then the bf16 GEMM and
   attention kernels at edge shapes (B 1 to 512, S 77 / 211 / 213 spliced,
   K 32 to 3072, N 512 to 3072 and tails; attention at S 1 to 256, 8 and 12
   heads, qkv views and contiguous), LayerNorm in the kernel against
   LayerNorm done beforehand bit for bit, 50 launches bit-equal, and the
   host time of a wrapper call. Then the fp32 route (the training CLIs'
   default dtype; 3xTF32 GEMM, attention and CLS-tail kernels): the
   GEMM at edge shapes in both modes with all three epilogues, the splice
   and the scalar operands off 16 bytes, attention at S 1 to 444 (77
   causal), each kernel at B=128 S=211 (attention at S=442 too) against
   its plain version within 1e-4, 50 launches bit-equal, timed beside its
   plain version, the fp32 library call (cuBLAS SGEMM with TF32 off, fp32
   SDPA), the bound of three TF32 passes and the CUDA cores' fp32 FMA
   figure; the tail at B = 1, 37, 64, 128, 512 and edge shapes (the FMA
   kernel where the route leaves the tf32x3 kernel's domain), timed at
   B = 64, 128, 512 by device time beside F.layer_norm + matmul, its plain
   version and the FMA kernel it replaced. The build's ptxas lines are
   printed; the run fails if a wgmma kernel spills, or if the log does not
   show every instantiation of the wgmma kernels.
4. minsum: the minsum kernel at awkward shapes in fp8, bf16 and fp32, then
   timed at the Market-1501 streamed shape (4096 x 16384 x 20480, fp8) and
   on one 1024-row query slab of the MSMT17 shape.
5. grad: the block and CLS-tail autograd Functions against plain autograd
   at full width (B=16, S=213 with the splice, fp32).
6. zero_shot: the zero-shot main path at full width with random weights
   from a seed (convert_clip -> zeroshot_classifier -> flip-TTA extraction
   of 128 query and 512 gallery images in bf16 -> evaluate_zero_shot), the
   extraction watchdog's cost (extract_embeddings against a bare loop of the
   same extractor calls), and the same slice in fp32 through the plain path
   and the kernels.
7. rerank: re-ranks at Market-1501 scale through the Evaluator, exact and
   streamed routes, held within JAX's bounds.
8. serve: eval_embed of the IVLP flagship (bench.py's model: 213 tokens,
   751 classes, random weights from seed 0) at bench.py's profile (batch
   512, bf16, fast softmax, folded input norm, no flip-TTA): emb/s, a
   trace; every block and tail call of one timed batch against its plain
   version on the run's own inputs, its embeddings against the plain path;
   fp32 kernels against the plain path.
9. vehicle: the vehicle geometry (256x256, stride 12: 442 tokens, 444 with
   IVLP's prompts), where mha_core runs its key-tile kernel: mha_core at
   S = 257, 300, 442, 444 against its plain version (8 and 12 heads, views
   and contiguous, exact and fast, masked and not, bf16 and fp32), 50
   launches bit-equal, whole blocks at 442 and 444 tokens with the splice,
   the kernel timed at B=128, S=442 beside SDPA; eval_embed of the flagship
   at 256x256 (batch 256, bf16, fast softmax) as in phase 8; then the
   zero-shot CLI (--rerank --mm) and the prompt-learning CLI on a synthetic
   VeRi directory at full width.
10. eva02: EVA02-CLIP-L/14 (configs.eva02_l14_reid, IVLP prompts in all
   24 blocks, 256x256: 327 tokens, random bf16 weights from a seed): each
   EVA02 mode of the block kernels against its plain version at the
   eva-veri.embed cell's shapes (B 256, S 327, F 2730 stored as 2752)
   within one bf16 rounding (ln_rows as LN_1 with the splice and as the
   sub-LN over the padded hidden width, ln_gemm with RoPE and with SwiGLU,
   gemm_bias_residual with the sub-LN prologue and the residual); then
   eval_embed through the extractor (batch 256, bf16, fast softmax, folded
   input norm, flip-TTA): emb/s, the launch counters (23 EVA02 blocks a
   pass on the kernels, none plain), every block and the tail of a batch
   against their plain versions on the run's own inputs, the embeddings
   against the plain bf16 tower and against the fp32 tower, and an fp32
   pass counted on the plain path.
11. train: three live IVLP stage-1 steps and three stage-2 steps of the
   flagship at bs 64 in bf16 activations (ms per step, peak memory, traces,
   launches), an fp32 stage-1 step's peak memory, and an fp32 stage-2 loss
   and gradient through the kernels against the plain path; then fp32
   stage-2 and live stage-1 steps, each the median of 6 warm steps on the
   host loop and as CUDA-graph replays, their launches per step (and the
   cached coop stage 1's), a trace of each that must show the 3xTF32
   kernels and no FMA kernel, one more step of each with its CLS-tail calls
   held against the plain version on the step's own inputs, and one
   captured fp32 stage-2 step against its eager step bit for bit.
12. cli: the zero-shot CLI with --rerank --mm, then the prompt-learning CLI
   (ivlp, one epoch of each stage, --rerank, bf16), at full ViT-B/16 width
   on a synthetic Market1501 directory and a random checkpoint; both must
   launch every kernel; the prompt-learning command again with --resume
   skips both stages and gives the same mAP within 1e-5; the fp32
   prompt-learning CLI in this process and in a subprocess (torch's
   defaults, none of this script's flags), their final checkpoints'
   features within 1e-4.
13. multitask: the hard_ivlp multitask model at full width (task 0 256x128,
   213 tokens, 751 classes; task 1 256x256, 444 tokens, 576 classes), two
   stage-1 and two stage-2 steps per task at bs 64 in bf16 activations (ms
   per step per task, peak memory, launches: the key-tile mha_core from
   task 1); run_mt_stage2 straight against a run resumed from its
   checkpoint files (save and restore seconds, bytes on disk); then the
   multitask CLI (hard_ivlp, Market1501 + VeRi, --rerank) and the same
   command with --resume.
14. resnet: the RN50 zero-shot tower at full width (random weights from a
   seed, 256x128: a 16x8 layer-4 map, 129 tokens in the attention pool) on
   the zero-shot main path's sizes (emb/s, peak memory, a trace), the text
   classifier's blocks against their plain version, the tower in fp32 on
   the card against the CPU (TF32 off), then the zero-shot CLI with an RN50
   checkpoint and --rerank. The convolutions are cuDNN's and the attention
   pool plain PyTorch, as both are plain XLA in the JAX package.
15. variants: MaPLe (213 tokens): three live stage-1 and three stage-2
   steps at bs 64, its spliced blocks forward on the computed prompts
   against their plain version, the gradient of a computed prompt plane
   through the block Function against plain autograd; coop with JPM and SIE
   (211 tokens, 6 cameras): three stage-2 steps, eval_embed (2048 wide) at
   batch 512 in bf16 with the fast softmax, every block of a batch (the
   full-sequence 12th and the JPM block) against its plain version; then
   the prompt-learning CLI with --training_mode maple and with coop --jpm
   --sie_camera --augmented_prompts, one epoch per stage, --rerank.
16. cache: the device-resident training input. A DeviceImageCache of a
   synthetic Market1501 split at Market-1501's scale (751 identities x 17
   training JPEGs at 256x128; upload seconds, MiB, the build's peak memory),
   its gathers of 4 PK batches against BatchLoader's rows bit for bit and
   timed; then at full width, bs 64, bf16 activations, 2 epochs x 6 steps
   each: run_stage2_cached (the IVLP flagship, a CUDA graph per step) against
   run_stage2 fed the same gathers and draws, run_stage1_live_cached against
   run_stage1, and the cached coop stage 1 against the same steps through
   make_stage1_step(cached=True) eagerly: per-step losses and final leaves
   (bit-equal, or within 2e-2 with the cause), ms per step, capture seconds,
   peak memory, a traced epoch of replays against an eager one; the guard on
   the graph path (an inf leaf rolled back in place); device_prefetch on a
   copy stream against depth 0; then both training CLIs with --cache_device
   against the same commands without it, and --resume.
17. multidevice: the data mesh of parallel/mesh.py and parallel/launch.py
   (one process per card, NCCL) in worlds of one rank, started and
   destroyed inside the phase (a world of more ranks needs more cards; the
   CPU tests hold the cross-rank behaviour over gloo): the IVLP flagship
   through extract_embeddings over the mesh (4 batches of 512, bench.py's
   profile) against the single-device sweep; three live stage-1 and three
   stage-2 steps at bs 64 with mesh= against the same steps without; one
   run_stage2_cached epoch over a sharded cache (eager, no graph) against
   the graph path; the sharded streamed re-ranking at Market-1501 scale
   (3368 x 15913, D=1280) against the single-device route; the zero-shot
   and prompt-learning CLIs with --multihost 127.0.0.1:<port> --num_hosts 1
   --host_id 0 against the same commands without it; --devices 2 on a
   one-card host raises and names the visible count. Each prints ms or emb/s
   of both paths.
18. tp: tensor parallelism (parallel/tp.py) at full ViT-B/16 width from
   random_clip_state_dict(0) (211 tokens, 12 heads of 64, MLP 3072, bf16,
   B=128). The card host has one card, so for T in 2, 4 and 12 every shard
   of a layout runs on it in turn: tp_attn_partial and tp_mlp_partial
   (ln_gemm, mha_core, gemm_bias_residual on the shard's heads and hidden
   units), the partials summed where a model group all-reduces; the summed
   block against fused_block, each shard's kernels against their plain
   versions, one shard's two halves timed against the whole block beside
   the shard's bound, the whole apply_vit_tp(cls_only=True) (every shard on
   a thread, a reduce across the threads) against apply_vit(cls_only=True);
   make_tp_extractor over an NCCL world of one rank, 4 x 128 images with
   flip-TTA, against the single-device extractor; the zero-shot CLI with
   --tp 2 on this one-card host raises naming the card count.
19. tools: tpu_reid_torch.tools.parity_run --synthetic --mm on the card
   (both tails' results and their |d|), entry()'s forward on its 8 example
   images against eval_embed's plain path, and the native decoder: built
   or not; if built, its pixels against PIL's on a write_market_dir
   directory and decode images/s of both.

It prints the kernels' JSON record on the line before the last (each
kernel's launches on the main path of the slice that brought it: IVLP
serving, for minsum the re-ranking path, for the key-tile mha_core kernel
IVLP serving at the vehicle geometry, for the fp32 route (`*_fp32`) the
fp32 stage-2 training step; and its launches on every path), and
as the last line
{"ok": true, "device": {...}}.
Any failed phase exits non-zero; with no CUDA device, or without the
tpu_reid_torch package beside it, the script exits non-zero before printing
a result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# fp32 instructions on the CUDA cores (132 SMs x 128 lanes x 1.98 GHz): the
# peak of the minsum kernel, whose fminf and fadd are no tensor-core product
PEAK_FP32_CUDA_CORE_OPS = 132 * 128 * 1.98e9

# TF32 tensor cores, dense (NVIDIA data sheet): the fp32 block kernels'
# bound is three TF32 passes (hi*hi + hi*lo + lo*hi), the least an
# fp32-accurate product takes on the card; the fp32 FMA rate on the CUDA
# cores (2 x PEAK_FP32_CUDA_CORE_OPS FLOP/s) is printed beside it
PEAK_TF32_FLOPS = 494.7e12
TF32_PASSES = 3

# minsum: max|kernel - plain| / max|plain|; only the order of fp32 sums differs
MINSUM_TOL = 1e-5

# tolerances on max|kernel - plain| / max|plain|, with their reasons
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TOL_REASON = {
    torch.float32: "fp32 differs only in the order of sums",
    torch.bfloat16: "bf16 may flip a last-bit rounding of an intermediate that the "
                    "next product carries",
}

REPO = os.path.dirname(os.path.abspath(__file__))


class PhaseFailed(Exception):
    pass


def say(msg: str = "") -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn() after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def graph_ms(fn, reps: int = 20) -> float:
    """Median of `reps` CUDA-event timings of a CUDA-graph replay of fn()
    (captured after a warm-up call on a side stream): the device time of
    fn's kernels without the host's cost of launching them one by one,
    which exceeds the device time of short kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    try:
        return time_ms(graph.replay, reps=reps)
    finally:
        del graph


def device_us(fn, kernels: int | None = None, reps: int = 20, tries: int = 5):
    """Device time of one fn() call in microseconds: the durations of the
    kernels the profiler records on the card over `reps` calls, summed and
    divided by reps. No host time and no gap between kernels is in it, so it
    is what a kernel far below a launch's host cost is held to. A trace that
    missed a kernel would read low, so the trace must hold reps x the kernels
    one call launches (`kernels`, or where None the larger count of two
    traces of one call: a trace may come back empty); one that does not is
    taken again, up to `tries` traces. None if no trace was whole."""
    from torch.profiler import ProfilerActivity, profile

    def trace(calls):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return device_events(prof)

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = max(len(trace(1)) for _ in range(2)) if kernels is None else kernels
    held = []
    for _ in range(tries if per_call else 0):
        events = trace(reps)
        if len(events) == reps * per_call:
            return sum(e.time_range.end - e.time_range.start for e in events) / reps
        held.append(len(events))
    say(f"  device_us: not measured: traces held {held} device events, not {reps} x {per_call}")
    return None


def device_events(prof):
    """The events of a torch.profiler run that ran on the card."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max|got - want|, that over max|want|)."""
    got, want = got.detach().float(), want.detach().float()
    if not torch.isfinite(got).all():
        return float("inf"), float("inf")
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_fp32(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time for an fp32-accurate product: three TF32 passes of
    `flops` on the tensor cores against `nbytes` at the memory rate."""
    return bound(TF32_PASSES * flops, nbytes, PEAK_TF32_FLOPS)


def fma_peak_ms(flops: float) -> float:
    """`flops` at the fp32 FMA peak of the CUDA cores, in ms: a figure for
    PERF.md's table, worked out and not measured, so kept off the kernels line."""
    return flops / (2 * PEAK_FP32_CUDA_CORE_OPS) * 1e3


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def block_params(rng, d, hid, dtype, dev):
    def t(*shape, std=1.0, mean=0.0, dt=dtype):
        a = rng.standard_normal(shape).astype(np.float32) * std + mean
        return torch.from_numpy(a).to(dev, dt)

    return dict(
        ln1_scale=t(d, std=0.05, mean=1.0, dt=torch.float32),
        ln1_bias=t(d, std=0.05, dt=torch.float32),
        w_in=t(d, 3 * d, std=d ** -0.5), b_in=t(3 * d, std=0.02),
        w_out=t(d, d, std=d ** -0.5), b_out=t(d, std=0.02),
        ln2_scale=t(d, std=0.05, mean=1.0, dt=torch.float32),
        ln2_bias=t(d, std=0.05, dt=torch.float32),
        w_fc=t(d, hid, std=d ** -0.5), b_fc=t(hid, std=0.02),
        w_proj=t(hid, d, std=hid ** -0.5), b_proj=t(d, std=0.02),
    )


def kernel_phase(dev):
    from tpu_reid_torch.ops import attention as TA
    from tpu_reid_torch.ops import fused_attention as FA
    from tpu_reid_torch.ops import fused_tail as FT

    rng = np.random.default_rng(0)
    failures = []
    record = {}
    for dt, tol in TOL.items():
        say(f"tolerance {str(dt)[6:]}: max|kernel - plain| <= {tol:.0e} * max|plain| "
            f"({TOL_REASON[dt]})")

    def check(label, got, want, dtype):
        err, rel = rel_err(got, want)
        ok = rel <= TOL[dtype]
        say(f"  {label}: max|d| {err:.3e}, rel {rel:.3e} (tol {TOL[dtype]:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
        return err

    # --- each kernel alone at the main path's shapes: one extraction pass of
    # 128 images, S=211, ViT-B/16 width, bf16, exact softmax
    bf = torch.bfloat16
    b, s, d, hid, heads = 128, 211, 768, 3072, 12
    m = b * s
    p = block_params(rng, d, hid, bf, dev)
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).to(dev, bf)
    say(f"kernels alone at B={b} S={s} D={d} hid={hid} bf16 "
        f"(times: median of 20 CUDA-event runs)")

    # the times of the mma.sync kernels these three replaced, on the same card
    # model and shapes (NVIDIA H100 80GB HBM3, 700 W): printed beside the new
    # times, and kept out of the kernels' record, which holds this run's numbers
    ms_before = {"ln_gemm": 1.7198, "gemm_bias_residual": 0.7187, "mha_core": 0.3133}

    def entry(name, source, replaces, parts, **extra):
        """parts: [(label, kernel_fn, plain_fn, library_fn or None, flops,
        bytes)] — the kernel's launches in one vision block, summed; the
        library time is null unless every part has a library call."""
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
        errs = []
        for label, kfn, pfn, lfn, flops, nbytes in parts:
            errs.append(check(f"{name}[{label}]", kfn(), pfn(), bf))
            k_ms, p_ms = time_ms(kfn), time_ms(pfn)
            l_ms = time_ms(lfn) if lfn is not None else None
            bnd, by = bound(flops, nbytes)
            lib = f"library {l_ms:.4f} ms, " if l_ms is not None else ""
            say(f"    {name}[{label}]: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                f"{lib}bound {bnd:.4f} ms ({by}); {flops / k_ms / 1e9:.1f} TFLOP/s")
            tot["ms"] += k_ms
            tot["plain_ms"] += p_ms
            tot["library_ms"] = None if l_ms is None or tot["library_ms"] is None \
                else tot["library_ms"] + l_ms
            tot["flops"] += flops
            tot["bytes"] += nbytes
        bnd, by = bound(tot["flops"], tot["bytes"])
        if name in ms_before:
            say(f"    {name}: {tot['ms']:.4f} ms, {ms_before[name]:.4f} ms before the redesign "
                f"({ms_before[name] / tot['ms']:.2f}x)")
        record[name] = dict(name=name, route="cuda", source=source, replaces=replaces,
                            max_abs_err=max(errs), ms=tot["ms"], plain_ms=tot["plain_ms"],
                            bound_ms=bnd, bound_by=by, library_ms=tot["library_ms"], **extra)

    def ln_gemm_part(label, xin, g, gb, w, bias, gelu):
        k, n = w.shape
        x2 = xin.reshape(-1, k)
        return (label,
                lambda: FA.ln_gemm(xin, g, gb, w, bias, gelu),
                lambda: FA.ln_gemm_reference(xin, g, gb, w, bias, gelu),
                lambda: torch.addmm(bias, F.layer_norm(x2, (k,), g.to(bf), gb.to(bf)), w),
                2.0 * m * n * k, 2.0 * (m * k + k * n + n + m * n) + 8.0 * k)

    qkv = FA.ln_gemm(x, p["ln1_scale"], p["ln1_bias"], p["w_in"], p["b_in"])
    h = FA.ln_gemm(x, p["ln2_scale"], p["ln2_bias"], p["w_fc"], p["b_fc"], True)
    src_block = "tpu_reid_torch/csrc/block_kernels.cu"
    entry("ln_gemm", src_block, "tpu_reid/ops/fused_attention.py:427", [
        ln_gemm_part("qkv", x, p["ln1_scale"], p["ln1_bias"], p["w_in"], p["b_in"], False),
        ln_gemm_part("c_fc", x, p["ln2_scale"], p["ln2_bias"], p["w_fc"], p["b_fc"], True),
    ])

    q, kk, v = (t.reshape(b, s, heads, 64).transpose(1, 2).contiguous()
                for t in qkv.split(d, dim=-1))
    views = FA._qkv_views(qkv, heads)  # (B, S, H, 64) views, row stride 3D: no copy
    entry("mha_core", src_block, "tpu_reid/ops/attention.py:37", [(
        "exact, qkv views",
        lambda: TA.mha_core(*views),
        lambda: TA.mha_core_reference(*views),
        lambda: F.scaled_dot_product_attention(q, kk, v),
        4.0 * b * heads * s * s * 64, 2.0 * (b * s * 3 * d + b * s * d),
    )])

    a = TA.mha_core(*views).reshape(b, s, d)

    def gemm_res_part(label, ain, w, bias, res):
        k, n = w.shape
        a2 = ain.reshape(-1, k)
        return (label,
                lambda: FA.gemm_bias_residual(ain, w, bias, res),
                lambda: FA.gemm_bias_residual_reference(ain, w, bias, res),
                lambda: torch.addmm(bias, a2, w),
                2.0 * m * n * k, 2.0 * (m * k + k * n + n + 2 * m * n))

    entry("gemm_bias_residual", src_block, "tpu_reid/ops/fused_attention.py:427", [
        gemm_res_part("out_proj", a, p["w_out"], p["b_out"], x),
        gemm_res_part("c_proj", h, p["w_proj"], p["b_proj"], x),
    ])

    # the composed kernels at the same shape: fused_mha (pre-LN: the
    # block's half; without LN: timed beside F.multi_head_attention_forward),
    # fused_mlp, and the whole block built from them
    mha_w = (p["w_in"], p["b_in"], p["w_out"], p["b_out"], heads)
    ln1 = (p["ln1_scale"], p["ln1_bias"])
    mha_flops = 2.0 * b * s * d * (4 * d + 2 * s)
    mha_bytes = 2.0 * (2 * b * s * d + 4 * d * d + 4 * d) + 8.0 * d
    xt = x.transpose(0, 1).contiguous()  # (S, B, D) for the library call
    w_in_t, w_out_t = p["w_in"].t().contiguous(), p["w_out"].t().contiguous()
    no_ln = ("no LN",
             lambda: FA.fused_mha(x, *mha_w),
             lambda: FA.fused_mha_reference(x, *mha_w),
             lambda: F.multi_head_attention_forward(
                 xt, xt, xt, d, heads, w_in_t, p["b_in"], None, None, False, 0.0, w_out_t,
                 p["b_out"], training=False, need_weights=False),
             mha_flops, mha_bytes - 8.0 * d)
    entry("fused_mha_no_ln", src_block, "tpu_reid/ops/fused_attention.py:212", [no_ln])
    no_ln_rec = record.pop("fused_mha_no_ln")
    ln1_bf = (p["ln1_scale"].to(bf), p["ln1_bias"].to(bf))
    ln2_bf = (p["ln2_scale"].to(bf), p["ln2_bias"].to(bf))

    def library_mha():  # F.layer_norm + F.multi_head_attention_forward + residual
        xn = F.layer_norm(xt, (d,), *ln1_bf)
        return xt + F.multi_head_attention_forward(
            xn, xn, xn, d, heads, w_in_t, p["b_in"], None, None, False, 0.0, w_out_t,
            p["b_out"], training=False, need_weights=False)[0]

    entry("fused_mha", src_block, "tpu_reid/ops/fused_attention.py:212", [
        ("pre-LN", lambda: FA.fused_mha(x, *mha_w, None, *ln1),
         lambda: FA.fused_mha_reference(x, *mha_w, None, *ln1), library_mha, mha_flops,
         mha_bytes)],
        **{f"no_ln_{k}": no_ln_rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")})
    mlp_args = (p["ln2_scale"], p["ln2_bias"], p["w_fc"], p["b_fc"], p["w_proj"], p["b_proj"])
    mlp_flops = 4.0 * b * s * d * hid
    mlp_bytes = 2.0 * (2 * b * s * d + 2 * d * hid + hid + d) + 8.0 * d
    w_fc_t, w_proj_t = p["w_fc"].t().contiguous(), p["w_proj"].t().contiguous()

    def library_mlp():  # F.layer_norm + F.linear + QuickGELU + F.linear + add
        hh = F.linear(F.layer_norm(x, (d,), *ln2_bf), w_fc_t, p["b_fc"])
        return x + F.linear(hh * torch.sigmoid(1.702 * hh), w_proj_t, p["b_proj"])

    entry("fused_mlp", src_block, "tpu_reid/ops/fused_attention.py:341", [
        ("ln_2 + MLP + residual", lambda: FA.fused_mlp(x, *mlp_args),
         lambda: FA.fused_mlp_reference(x, *mlp_args), library_mlp, mlp_flops, mlp_bytes)])
    # the library's whole pre-norm block: nn.TransformerEncoderLayer with
    # QuickGELU, carrying the same weights
    layer = torch.nn.TransformerEncoderLayer(
        d, heads, hid, dropout=0.0, activation=lambda t: t * torch.sigmoid(1.702 * t),
        batch_first=True, norm_first=True, device=dev, dtype=bf).eval()
    with torch.no_grad():
        for dst, src in ((layer.self_attn.in_proj_weight, w_in_t),
                         (layer.self_attn.in_proj_bias, p["b_in"]),
                         (layer.self_attn.out_proj.weight, w_out_t),
                         (layer.self_attn.out_proj.bias, p["b_out"]),
                         (layer.linear1.weight, w_fc_t), (layer.linear1.bias, p["b_fc"]),
                         (layer.linear2.weight, w_proj_t), (layer.linear2.bias, p["b_proj"]),
                         (layer.norm1.weight, ln1_bf[0]), (layer.norm1.bias, ln1_bf[1]),
                         (layer.norm2.weight, ln2_bf[0]), (layer.norm2.bias, ln2_bf[1])):
            dst.copy_(src)

    def library_block():
        with torch.no_grad():
            return layer(x)

    entry("fused_block", src_block, "tpu_reid/ops/fused_attention.py:483", [
        ("whole block", lambda: FA.fused_block(x, **p, n_heads=heads),
         lambda: FA.fused_block_reference(x, **p, n_heads=heads), library_block,
         mha_flops + mlp_flops, mha_bytes + mlp_bytes - 4.0 * b * s * d)])
    # the yardsticks compute the same functions (printed, not gated: they are
    # no code of the port)
    for name, lib, plain in (
            ("fused_mha", lambda: library_mha().transpose(0, 1),
             lambda: FA.fused_mha_reference(x, *mha_w, None, *ln1)),
            ("fused_mlp", library_mlp, lambda: FA.fused_mlp_reference(x, *mlp_args)),
            ("fused_block", library_block,
             lambda: FA.fused_block_reference(x, **p, n_heads=heads))):
        err, rel = rel_err(lib(), plain())
        say(f"  {name}'s library yardstick against its plain version: max|d| {err:.3e}, "
            f"rel {rel:.3e}")
    del layer

    # fused_mha (pre-LN and without, exact and fast, vision S=211 and S=213
    # with the splice, text S=77 causal), fused_mlp and mha_core in both
    # types, at B=64
    say("fused_mha / fused_mlp / mha_core against their plain versions at B=64")
    from tpu_reid_torch.models.layers import causal_mask as _causal

    for dt in (torch.bfloat16, torch.float32):
        for kind, seq, dd, hh, nh in (("vision", 211, 768, 3072, 12), ("vision", 213, 768, 3072, 12),
                                      ("text", 77, 512, 2048, 8)):
            pb = block_params(rng, dd, hh, dt, dev)
            xb = torch.from_numpy(rng.standard_normal((64, seq, dd)).astype(np.float32)).to(dev, dt)
            mask = _causal(seq, device=dev) if kind == "text" else None
            kw = {}
            if seq == 213:  # the 2 IVLP prompt rows at the end of the sequence
                pm = torch.zeros(seq, 1, device=dev)
                pm[seq - 2:] = 1.0
                kw = dict(prompt_plane=torch.from_numpy(rng.standard_normal(
                    (seq, dd)).astype(np.float32)).to(dev, dt), prompt_mask=pm)
            w = (pb["w_in"], pb["b_in"], pb["w_out"], pb["b_out"], nh, mask)
            tag = f"{kind} B=64 S={seq} {str(dt)[6:]}{' causal' if mask is not None else ''}"
            for fast in (False, True):
                mode = "fast" if fast else "exact"
                check(f"fused_mha[{tag} pre-LN {mode}{' splice' if kw else ''}]",
                      FA.fused_mha(xb, *w, pb["ln1_scale"], pb["ln1_bias"], fast, **kw),
                      FA.fused_mha_reference(xb, *w, pb["ln1_scale"], pb["ln1_bias"], fast, **kw),
                      dt)
                if not kw:
                    check(f"fused_mha[{tag} no LN {mode}]", FA.fused_mha(xb, *w, fast=fast),
                          FA.fused_mha_reference(xb, *w, fast=fast), dt)
            if not kw:
                qkvb = torch.from_numpy(rng.standard_normal((64, seq, 3 * dd)).astype(
                    np.float32)).to(dev, dt)
                for fast in (False, True):
                    vb = FA._qkv_views(qkvb, nh)
                    check(f"mha_core[{tag} qkv views {'fast' if fast else 'exact'}]",
                          TA.mha_core(*vb, mask, fast=fast),
                          TA.mha_core_reference(*vb, mask, fast=fast), dt)
                    cb = tuple(t.contiguous() for t in vb)
                    check(f"mha_core[{tag} contiguous {'fast' if fast else 'exact'}]",
                          TA.mha_core(*cb, mask, fast=fast),
                          TA.mha_core_reference(*cb, mask, fast=fast), dt)
                mlp = (pb["ln2_scale"], pb["ln2_bias"], pb["w_fc"], pb["b_fc"], pb["w_proj"],
                       pb["b_proj"])
                check(f"fused_mlp[{tag}]", FA.fused_mlp(xb, *mlp), FA.fused_mlp_reference(xb, *mlp),
                      dt)

    # CLS tail: the main path's shape is one pass over a 128-image batch;
    # B=512 is checked and timed too, and the shapes that leave the wgmma
    # kernel's fast lane (a ragged row tile, E off the 64-column tile, D =
    # 1024 whose proj slice refills the ring, D off the 64-wide K block: FMA)
    e = 512
    gt = torch.from_numpy(1 + 0.05 * rng.standard_normal(d).astype(np.float32)).to(dev)
    bt_ = torch.from_numpy(0.05 * rng.standard_normal(d).astype(np.float32)).to(dev)
    proj = torch.from_numpy(rng.standard_normal((d, e)).astype(np.float32) * d ** -0.5).to(dev, bf)
    tails, xs = {}, {}
    for bt in (128, 512):
        xt = xs[bt] = torch.from_numpy(
            rng.standard_normal((bt, d)).astype(np.float32)).to(dev, bf)
        for dt in (bf, torch.float32):
            xd, pd = xt.to(dt), proj.to(dt)
            yk, pk = FT.ln_proj_tail_kernel(xd, gt, bt_, pd)
            yr, pr = FT.ln_proj_tail_reference(xd, gt, bt_, pd)
            tag = f"B={bt} {str(dt)[6:]}"
            tails[(bt, dt)] = max(check(f"ln_proj_tail[{tag} y]", yk, yr, dt),
                                  check(f"ln_proj_tail[{tag} p]", pk, pr, dt))
        yk, pk = FT.ln_proj_tail_fma(xt, gt, bt_, proj)
        yr, pr = FT.ln_proj_tail_reference(xt, gt, bt_, proj)
        check(f"ln_proj_tail[B={bt} bfloat16, the FMA kernel y]", yk, yr, bf)
        check(f"ln_proj_tail[B={bt} bfloat16, the FMA kernel p]", pk, pr, bf)
    for bb, dd, ee in ((100, 768, 512), (1, 768, 512), (130, 768, 520), (70, 1024, 768),
                       (64, 64, 8), (33, 96, 40)):
        xe = torch.from_numpy(rng.standard_normal((bb, dd)).astype(np.float32)).to(dev, bf)
        ge = torch.from_numpy(1 + 0.05 * rng.standard_normal(dd).astype(np.float32)).to(dev)
        be = torch.from_numpy(0.05 * rng.standard_normal(dd).astype(np.float32)).to(dev)
        pe = torch.from_numpy(rng.standard_normal((dd, ee)).astype(np.float32)
                              * dd ** -0.5).to(dev, bf)
        route = FT.tail_kernel_route(bb, dd, ee, True, {})
        yk, pk = FT.ln_proj_tail_kernel(xe, ge, be, pe)
        yr, pr = FT.ln_proj_tail_reference(xe, ge, be, pe)
        check(f"ln_proj_tail[B={bb} {dd} -> {ee} bf16 ({route}) y]", yk, yr, bf)
        check(f"ln_proj_tail[B={bb} {dd} -> {ee} bf16 ({route}) p]", pk, pr, bf)
    first = FT.ln_proj_tail_kernel(xs[128], gt, bt_, proj)
    same = all(all(torch.equal(a, c) for a, c in zip(first, FT.ln_proj_tail_kernel(
        xs[128], gt, bt_, proj))) for _ in range(49))
    say(f"  ln_proj_tail: 50 launches on one input {'bit-equal' if same else 'DIFFER'}")
    if not same:
        failures.append("ln_proj_tail repeat")

    # Times. CUDA events around host-driven launches (`ms`) measure mostly the
    # host at this size, so the kernels' own durations from the profiler stand
    # beside them (`device_us`): the wgmma kernel, the FMA kernel it replaced
    # in bf16, the library call (F.layer_norm + matmul: two kernels), and the
    # design that lost: ln_gemm's LayerNorm mode with a zero bias, which gives
    # p from the 128-row panel of the block GEMM (it would still have to store
    # y, so its time is a lower bound of that design's)
    zero_bias = torch.zeros(e, device=dev, dtype=bf)
    tail_times = {}
    for bt in (128, 512):
        xt = xs[bt]
        fns = {"kernel": lambda: FT.ln_proj_tail_kernel(xt, gt, bt_, proj),
               "fma": lambda: FT.ln_proj_tail_fma(xt, gt, bt_, proj),
               "library": lambda: F.layer_norm(xt, (d,), gt.to(bf), bt_.to(bf)) @ proj,
               "ln_gemm_mode": lambda: FA.ln_gemm(xt[None], gt, bt_, proj, zero_bias),
               "plain": lambda: FT.ln_proj_tail_reference(xt, gt, bt_, proj)}
        # kernel, the others, kernel again: the two readings bracket the rest
        order = ["kernel", "fma", "library", "ln_gemm_mode", "plain", "kernel"]
        ms, us = {}, {}
        for name in order:
            ms.setdefault(name, []).append(time_ms(fns[name]))
            if name != "plain":
                us.setdefault(name, []).append(
                    device_us(fns[name], 1 if name in ("kernel", "fma") else None))
        tail_times[bt] = (ms, us)
        bnd, by = bound(2.0 * bt * d * e, 2.0 * (bt * d + d * e + bt * d + bt * e) + 8.0 * d)
        say(f"CLS tail alone at B={bt}, {d} -> {e}, bf16 (ms: median of 20 CUDA-event runs of "
            f"a host-driven launch; device us: the kernels' durations in a profiler trace of "
            f"20 calls), bound {bnd:.5f} ms ({by})")
        for name in ("kernel", "fma", "library", "ln_gemm_mode", "plain"):
            u = us.get(name)
            dev_txt = "not measured" if not u or None in u else "/".join(f"{v:.2f}" for v in u)
            say(f"    {name}: {'/'.join(f'{v:.4f}' for v in ms[name])} ms, device {dev_txt} us")
        k_us, f_us, l_us = us["kernel"], us["fma"][0], us["library"][0]
        if None not in k_us and f_us and l_us:
            worst = max(k_us)
            say(f"    targets at B={bt}: device time <= 1/5 of the FMA kernel's: {worst:.2f} us "
                f"against {f_us / 5:.2f} us ({f_us / worst:.1f}x) "
                f"{'met' if worst <= f_us / 5 else 'MISSED'}; no slower than the library "
                f"call's {l_us:.2f} us ({worst / l_us:.2f}x) "
                f"{'met' if worst <= l_us else 'MISSED'}")
    bt = 128
    ms, us = tail_times[bt]
    ms512, us512 = tail_times[512]
    bnd, by = bound(2.0 * bt * d * e, 2.0 * (bt * d + d * e + bt * d + bt * e) + 8.0 * d)
    record["ln_proj_tail"] = dict(
        name="ln_proj_tail", route="cuda", source="tpu_reid_torch/csrc/tail_kernel.cu",
        replaces="tpu_reid/ops/fused_tail.py:31", max_abs_err=tails[(bt, bf)],
        ms=min(ms["kernel"]), plain_ms=ms["plain"][0], bound_ms=bnd, bound_by=by,
        library_ms=ms["library"][0], fma_ms=ms["fma"][0], ln_gemm_mode_ms=ms["ln_gemm_mode"][0],
        device_us={k: v for k, v in us.items()},
        b512=dict(ms={k: v for k, v in ms512.items()}, device_us={k: v for k, v in us512.items()}))

    # --- whole blocks at B=64: every variant the main paths take
    say("whole blocks: fused_block (kernels) against fused_block_reference")
    from tpu_reid_torch.models.layers import causal_mask

    cases = []
    for dt in (torch.bfloat16, torch.float32):
        for seq, splice in ((211, False), (213, True)):
            for fast in (False, True):
                cases.append(("vision", 64, seq, 768, 3072, 12, dt, splice, fast, False))
    for dt in (torch.float32, torch.bfloat16):
        for fast in (False, True):
            cases.append(("text", 64, 77, 512, 2048, 8, dt, False, fast, True))
    for kind, bb, seq, dd, hh, nh, dt, splice, fast, causal in cases:
        pb = block_params(rng, dd, hh, dt, dev)
        xb = torch.from_numpy(rng.standard_normal((bb, seq, dd)).astype(np.float32)).to(dev, dt)
        kw = {}
        if splice:  # the 2 IVLP prompt rows at the end of the sequence
            kw["prompt_plane"] = torch.from_numpy(
                rng.standard_normal((seq, dd)).astype(np.float32)).to(dev, dt)
            pm = torch.zeros(seq, 1, device=dev)
            pm[seq - 2:] = 1.0
            kw["prompt_mask"] = pm
        mask = causal_mask(seq, device=dev) if causal else None
        got = FA.fused_block(xb, **pb, n_heads=nh, mask=mask, fast=fast, **kw)
        want = FA.fused_block_reference(xb, **pb, n_heads=nh, mask=mask, fast=fast, **kw)
        check(f"{kind} block B={bb} S={seq} {str(dt)[6:]} "
              f"{'fast' if fast else 'exact'}{' splice' if splice else ''}"
              f"{' causal' if causal else ''}", got, want, dt)
    edge_checks(dev, rng, check, bf)
    ln_repeat_host_checks(dev, rng, failures)
    ln_prologue_times(dev)
    record.update(fp32_kernels(dev, rng, check, failures))
    torch.cuda.synchronize()
    if failures:
        raise PhaseFailed(f"kernels disagree with their plain versions: {failures}")
    return record


def fp32_kernels(dev, rng, check, failures, b=128, s=211, d=768, hid=3072, heads=12):
    """The fp32 route of the block kernels and the tail, the training CLIs'
    default dtype, at the main path's shapes (B=128, S=211; mha_core at
    S=442 too): each against its plain version, 50 launches bit-equal, and
    timed (median of 20 CUDA-event runs) beside its plain version, the fp32
    library call (F.layer_norm + torch.addmm with TF32 off, i.e. cuBLAS
    SGEMM; SDPA in fp32), the bound of three TF32 passes and the fp32 FMA
    figure of the CUDA cores; the tail as `fp32_tail` says. Returns the
    kernels-line records."""
    from tpu_reid_torch.ops import attention as TA
    from tpu_reid_torch.ops import fused_attention as FA
    from tpu_reid_torch.ops import fused_tail as FT

    f32 = torch.float32
    m = b * s
    p = block_params(rng, d, hid, f32, dev)
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).to(dev)
    say(f"fp32 kernels at B={b} S={s} D={d} hid={hid} (median of 20 CUDA-event runs; bound: "
        f"{TF32_PASSES} TF32 passes at {PEAK_TF32_FLOPS / 1e12:.1f} TF/s or the bytes at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s; FMA figure: the FLOPs at "
        f"{2 * PEAK_FP32_CUDA_CORE_OPS / 1e12:.1f} TF/s)")
    record = {}

    def repeat(label, fn):
        first = fn()
        first = first if isinstance(first, tuple) else (first,)
        same = all(all(torch.equal(a, c) for a, c in zip(first, o if isinstance(o, tuple)
                                                          else (o,)))
                   for o in (fn() for _ in range(49)))
        say(f"  {label}: 50 launches on one input {'bit-equal' if same else 'DIFFER'}")
        if not same:
            failures.append(f"{label} repeat")

    def entry(name, source, replaces, parts, **extra):
        """parts: [(label, kernel_fn, plain_fn, library_fn, flops, bytes)],
        summed as in the bf16 records"""
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
        errs = []
        for label, kfn, pfn, lfn, flops, nbytes in parts:
            errs.append(check(f"{name}[{label}]", kfn(), pfn(), f32))
            repeat(f"{name}[{label}]", kfn)
            k_ms, p_ms, l_ms = time_ms(kfn), time_ms(pfn, reps=5, warmup=1), time_ms(lfn)
            bnd, by = bound_fp32(flops, nbytes)
            say(f"    {name}[{label}]: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
                f"{l_ms:.4f} ms ({k_ms / l_ms:.2f}x), bound {bnd:.4f} ms ({by}; "
                f"{100 * bnd / k_ms:.1f}% of it), FMA figure {fma_peak_ms(flops):.4f} ms; "
                f"{flops / k_ms / 1e9:.1f} TFLOP/s")
            for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                           ("flops", flops), ("bytes", nbytes)):
                tot[key] += v
        bnd, by = bound_fp32(tot["flops"], tot["bytes"])
        record[name] = dict(name=name, route="cuda", source=source, replaces=replaces,
                            max_abs_err=max(errs), ms=tot["ms"], plain_ms=tot["plain_ms"],
                            bound_ms=bnd, bound_by=by, library_ms=tot["library_ms"],
                            dtype="float32", **extra)

    def ln_gemm_part(label, g, gb, w, bias, gelu):
        k, n = w.shape
        x2 = x.reshape(-1, k)

        def library():
            acc = torch.addmm(bias, F.layer_norm(x2, (k,), g, gb), w)
            return acc * torch.sigmoid(1.702 * acc) if gelu else acc

        return (label, lambda: FA.ln_gemm(x, g, gb, w, bias, gelu),
                lambda: FA.ln_gemm_reference(x, g, gb, w, bias, gelu), library,
                2.0 * m * n * k, 4.0 * (m * k + k * n + n + m * n + 2 * k))

    src = "tpu_reid_torch/csrc/block_kernels.cu"
    entry("ln_gemm_fp32", src, "tpu_reid/ops/fused_attention.py:427", [
        ln_gemm_part("qkv", p["ln1_scale"], p["ln1_bias"], p["w_in"], p["b_in"], False),
        ln_gemm_part("c_fc", p["ln2_scale"], p["ln2_bias"], p["w_fc"], p["b_fc"], True)])
    qkv = FA.ln_gemm(x, p["ln1_scale"], p["ln1_bias"], p["w_in"], p["b_in"])
    h = FA.ln_gemm(x, p["ln2_scale"], p["ln2_bias"], p["w_fc"], p["b_fc"], True)

    def attention_part(label, qkv_, seq):
        views = FA._qkv_views(qkv_, heads)
        q, kk, v = (t.transpose(1, 2).contiguous() for t in views)
        return (label, lambda: TA.mha_core(*views), lambda: TA.mha_core_reference(*views),
                lambda: F.scaled_dot_product_attention(q, kk, v),
                4.0 * b * heads * seq * seq * 64, 4.0 * (b * seq * 3 * d + b * seq * d))

    entry("mha_core_fp32", src, "tpu_reid/ops/attention.py:37",
          [attention_part(f"exact S={s}, qkv views", qkv, s)])
    qkv_long = torch.from_numpy(rng.standard_normal((b, 442, 3 * d)).astype(np.float32)).to(dev)
    long = {}
    for fast in (False, True):
        views = FA._qkv_views(qkv_long, heads)
        label = f"mha_core_fp32[S=442 {'fast' if fast else 'exact'}, qkv views]"
        check(label, TA.mha_core(*views, fast=fast),
              TA.mha_core_reference(*views, fast=fast), f32)
        repeat(label, lambda: TA.mha_core(*views, fast=fast))
        long["fast_ms" if fast else "ms"] = time_ms(lambda: TA.mha_core(*views, fast=fast))
    q, kk, v = (t.transpose(1, 2).contiguous() for t in FA._qkv_views(qkv_long, heads))
    long["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(q, kk, v))
    long["bound_ms"], long["bound_by"] = bound_fp32(4.0 * b * heads * 442 * 442 * 64,
                                                    4.0 * (b * 442 * 4 * d))
    say(f"    mha_core_fp32 at B={b} S=442: exact {long['ms']:.4f} ms, fast "
        f"{long['fast_ms']:.4f} ms, library (SDPA fp32) {long['library_ms']:.4f} ms, bound "
        f"{long['bound_ms']:.4f} ms ({long['bound_by']}), FMA figure "
        f"{fma_peak_ms(4.0 * b * heads * 442 * 442 * 64):.4f} ms")
    record["mha_core_fp32"]["s442"] = long
    del qkv_long, q, kk, v
    record["mha_core_backward_fp32"] = fp32_attention_backward(dev, check, repeat)
    a = TA.mha_core(*FA._qkv_views(qkv, heads)).reshape(b, s, d)

    def gemm_part(label, ain, w, bias):
        k, n = w.shape
        a2 = ain.reshape(-1, k)
        x2 = x.reshape(-1, n)
        return (label, lambda: FA.gemm_bias_residual(ain, w, bias, x),
                lambda: FA.gemm_bias_residual_reference(ain, w, bias, x),
                lambda: torch.addmm(bias, a2, w) + x2,
                2.0 * m * n * k, 4.0 * (m * k + k * n + n + 2 * m * n))

    entry("gemm_bias_residual_fp32", src, "tpu_reid/ops/fused_attention.py:427", [
        gemm_part("out_proj", a, p["w_out"], p["b_out"]),
        gemm_part("c_proj", h, p["w_proj"], p["b_proj"])])
    del qkv, h, a

    edge_checks(dev, rng, check, f32)

    record["ln_proj_tail_fp32"] = fp32_tail(dev, rng, check, repeat, failures)
    return record


def fp32_attention_backward(dev, check, repeat, b=64):
    """The fp32 block backward's attention core, q, k and v as views of a
    packed qkv as the chain hands them over: `mha_core_backward` against its
    plain version on the card at a stage-2 step's shape (B 64, S 213,
    ViT-B/16's 12 heads) and at the fp32 live stage-1 step's text tower
    (B 64, S 77, 8 heads, causal mask), 50 launches bit-equal at each; then,
    at S 213, timed (median of 20 CUDA-event runs) beside the recompute that
    feeds it (`mha_core_lse`), the plain version, the core it replaced
    (`xla_mha_core` differentiated under autograd, with the copy into the
    qkv layout) and the library yardstick, SDPA's fp32 forward + backward on
    contiguous heads (never called by the port). Bound: the five products
    the gradient needs (2 S^2 64 each per image and head) in three TF32
    passes, or its bytes (q, k, v, o, dO and the log-sum-exp in, dq, dk, dv
    out). Returns the kernels-line record."""
    from tpu_reid_torch.models import layers as TL
    from tpu_reid_torch.ops import attention as TA
    from tpu_reid_torch.ops import fused_attention as FA

    gen = torch.Generator(device="cpu").manual_seed(21)
    errs = {}
    for s, heads, causal in ((77, 8, True), (213, 12, False)):
        d = 64 * heads
        qkv = torch.randn(b, s, 3 * d, generator=gen).to(dev)
        do = torch.randn(b, s, heads, 64, generator=gen).to(dev)
        mask = TL.causal_mask(s, dev) if causal else None
        views = FA._qkv_views(qkv, heads)
        o, lse = TA.mha_core_lse(*views, mask)
        label = f"mha_core_backward_fp32[S={s}{', causal' if causal else ''}, qkv views]"
        errs[label] = check(label, TA.mha_core_backward(*views, o, do, lse, mask), torch.cat(
            [t.reshape(b, s, d)
             for t in TA.mha_core_backward_reference(*views, o, do, lse, mask)], -1),
            torch.float32)
        repeat(label, lambda: TA.mha_core_backward(*views, o, do, lse, mask))

    def replaced():
        with torch.enable_grad():
            x = qkv.detach().requires_grad_()
            a = TA.xla_mha_core(*FA._qkv_views(x, heads))
            return torch.autograd.grad(a, x, do)[0].contiguous()

    q4, k4, v4 = (t.transpose(1, 2).contiguous().requires_grad_() for t in views)
    do4 = do.transpose(1, 2).contiguous()

    def library():
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(q4, k4, v4)
            return torch.autograd.grad(out, (q4, k4, v4), do4)

    k_ms = time_ms(lambda: TA.mha_core_backward(*views, o, do, lse))
    lse_ms = time_ms(lambda: TA.mha_core_lse(*views))
    p_ms = time_ms(lambda: TA.mha_core_backward_reference(*views, o, do, lse), reps=5, warmup=1)
    r_ms = time_ms(replaced, reps=5, warmup=1)
    l_ms = time_ms(library)
    flops = 5 * 2.0 * b * heads * s * s * 64
    bnd, by = bound_fp32(flops, 4.0 * (b * s * 3 * d + 2 * b * s * d + b * heads * s
                                       + b * s * 3 * d))
    say(f"    {label}: kernel {k_ms:.4f} ms ({100 * bnd / k_ms:.1f}% of the bound "
        f"{bnd:.4f} ms, {by}; {TF32_PASSES * flops / k_ms / 1e9:.1f} TF/s of TF32), recompute "
        f"with its log-sum-exp {lse_ms:.4f} ms, both {k_ms + lse_ms:.4f} ms; plain {p_ms:.4f} "
        f"ms; the core it replaced (autograd of xla_mha_core) {r_ms:.4f} ms; library (SDPA "
        f"fp32 forward + backward) {l_ms:.4f} ms")
    return dict(name="mha_core_backward_fp32", route="cuda",
                source="tpu_reid_torch/csrc/block_kernels.cu",
                replaces="none: the JAX package differentiates the plain core",
                max_abs_err=max(errs.values()), max_abs_errs=errs, ms=k_ms, recompute_ms=lse_ms, plain_ms=p_ms, replaced_ms=r_ms,
                bound_ms=bnd, bound_by=by, library_ms=l_ms, dtype="float32")


# the fp32 CLS tail's checks, (B, D, E, route): the main path's width at every
# B the tail meets (1 row, a ragged tile, the training batch of 64, an
# extraction pass of 128, IVLP serving's 512), the widest row (ViT-L/14's
# 1024 -> 768), E off the 64-column tile (520, 516: a multiple of 4 and not of
# 8), D split unevenly over the cluster (640 = 20 K blocks), the narrowest D;
# and what the tf32x3 kernel does not take: D off the 32-wide K block, E off 4
FP32_TAIL_SHAPES = ((1, 768, 512, "tf32x3"), (37, 768, 512, "tf32x3"),
                    (64, 768, 512, "tf32x3"), (128, 768, 512, "tf32x3"),
                    (512, 768, 512, "tf32x3"), (70, 1024, 768, "tf32x3"),
                    (130, 768, 520, "tf32x3"), (33, 768, 516, "tf32x3"),
                    (65, 640, 200, "tf32x3"), (5, 32, 16, "tf32x3"), (9, 80, 24, "fma"),
                    (9, 768, 514, "fma"))


def tail_operands(rng, bb, dd, ee, dev, offset=0):
    """The CLS tail's fp32 operands from rng: x (bb, dd) `offset` floats past
    an allocation's base, the LayerNorm's scale and bias, proj (dd, ee)."""
    flat = torch.from_numpy(rng.standard_normal(bb * dd + offset).astype(np.float32))
    xt = flat.to(dev)[offset:].view(bb, dd)
    gt = torch.from_numpy(1 + 0.05 * rng.standard_normal(dd).astype(np.float32)).to(dev)
    bt_ = torch.from_numpy(0.05 * rng.standard_normal(dd).astype(np.float32)).to(dev)
    pr = torch.from_numpy(rng.standard_normal((dd, ee)).astype(np.float32) * dd ** -0.5).to(dev)
    return xt, gt, bt_, pr


FP32_TAIL_TIMED_B = (64, 128, 512)


def fp32_tail_fns(xt, gt, bt_, pr):
    """The fp32 tail's timed calls: the kernel, the FMA kernel it replaced,
    the library call (F.layer_norm + matmul) and the plain version."""
    from tpu_reid_torch.ops import fused_tail as FT

    return {"kernel": lambda: FT.ln_proj_tail_kernel(xt, gt, bt_, pr),
            "fma": lambda: FT.ln_proj_tail_fma(xt, gt, bt_, pr),
            "library": lambda: F.layer_norm(xt, (xt.shape[1],), gt, bt_) @ pr,
            "plain": lambda: FT.ln_proj_tail_reference(xt, gt, bt_, pr)}


def fp32_tail_device_us(seed: int, d: int = 768, e: int = 512) -> dict:
    """{B: {call: device us or None}} of fp32_tail_fns at FP32_TAIL_TIMED_B,
    on operands made from `seed` in that order. fp32_tail runs it in a fresh
    interpreter (FP32_TAIL_DEVICE_US): late in a long process the profiler
    returned traces with no kernel, or with too few, try after try."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    out = {}
    for bb in FP32_TAIL_TIMED_B:
        fns = fp32_tail_fns(*tail_operands(rng, bb, d, e, dev))
        out[bb] = {name: device_us(fn, 1 if name in ("kernel", "fma") else None)
                   for name, fn in fns.items()}
    return out


# run in a fresh interpreter: `python -c FP32_TAIL_DEVICE_US SEED` prints
# fp32_tail_device_us(SEED) as JSON on its last line
FP32_TAIL_DEVICE_US = r"""
import json, sys
import chip_smoke
print(json.dumps(chip_smoke.fp32_tail_device_us(int(sys.argv[1]))))
"""


def fp32_tail(dev, rng, check, repeat, failures, d=768, e=512):
    """The CLS tail in fp32 (ln_proj_tail_tf32x3_kernel; the FMA kernel outside
    its domain) against ln_proj_tail_reference within 1e-4 of max|plain|, y
    and p, at FP32_TAIL_SHAPES and at the training shape with x 4 bytes off a
    16-byte boundary (the FMA kernel), each with the route tail_kernel_route
    gives, which must be the one listed; 50 launches bit-equal at the training
    shape (B=64); device times from the profiler, read in a fresh interpreter
    on the same operands (CUDA events around one launch read the host), at
    FP32_TAIL_TIMED_B beside the library call (F.layer_norm + matmul), the
    plain version and the FMA kernel it replaced, with the card's name and
    power limit. Returns the kernels-line record: B=64 (`b`), the fp32
    training step's CLS rows, with B=128 and 512 inside."""
    from tpu_reid_torch.ops import _build
    from tpu_reid_torch.ops import fused_tail as FT

    f32 = torch.float32
    say("fp32 CLS tail against ln_proj_tail_reference (y and p; route from tail_kernel_route)")
    errs, wrong_route = {}, []
    for bb, dd, ee, want, offset in ([c + (0,) for c in FP32_TAIL_SHAPES]
                                     + [(64, 768, 512, "fma", 1)]):
        xt, gt, bt_, pr = tail_operands(rng, bb, dd, ee, dev, offset)
        route = FT.tail_kernel_route(bb, dd, ee, False, {"x": _build.ptr(xt)})
        tag = f"B={bb} {dd} -> {ee}{', x 4 bytes off' if offset else ''} ({route})"
        if route != want:
            wrong_route.append(tag)
        yk, pk = FT.ln_proj_tail_kernel(xt, gt, bt_, pr)
        yr, pp = FT.ln_proj_tail_reference(xt, gt, bt_, pr)
        errs[(bb, dd, ee, offset)] = max(check(f"ln_proj_tail_fp32[{tag} y]", yk, yr, f32),
                                         check(f"ln_proj_tail_fp32[{tag} p]", pk, pp, f32))
    if wrong_route:
        failures.append(f"ln_proj_tail_fp32 routes {wrong_route}")
        say(f"  FAIL: routes other than listed: {wrong_route}")

    seed = int(rng.integers(2 ** 31))
    times_rng = np.random.default_rng(seed)
    inputs = {bb: tail_operands(times_rng, bb, d, e, dev) for bb in FP32_TAIL_TIMED_B}
    repeat("ln_proj_tail_fp32[B=64]", lambda: FT.ln_proj_tail_kernel(*inputs[64]))
    torch.cuda.synchronize()
    proc = subprocess.run([sys.executable, "-c", FP32_TAIL_DEVICE_US, str(seed)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or not lines:
        raise PhaseFailed(f"the fp32 tail's device times in a subprocess exited with "
                          f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    for ln in lines[:-1]:
        say(f"  (device times) {ln}")
    device = {int(bb): v for bb, v in json.loads(lines[-1]).items()}
    say(f"  times on {card_line()} (device us: the kernels' durations in a profiler trace of "
        f"20 calls, in a fresh interpreter; ms: median of 20 CUDA-event runs of a "
        f"host-driven launch)")
    by_batch = {}
    for bb, ops in inputs.items():
        fns = fp32_tail_fns(*ops)
        us = device[bb]
        ms = {name: time_ms(fns[name]) for name in ("kernel", "library", "plain")}
        flops = 2.0 * bb * d * e
        bnd, by = bound_fp32(flops, 4.0 * (2 * bb * d + d * e + bb * e + 2 * d))
        by_batch[bb] = dict(ms=ms, device_us=us, bound_ms=bnd, bound_by=by)
        txt = {k: "not measured" if u is None else f"{u:.2f}" for k, u in us.items()}
        say(f"    B={bb}, {d} -> {e}: device kernel {txt['kernel']} us, FMA kernel {txt['fma']}, "
            f"library {txt['library']}, plain {txt['plain']}; events kernel "
            f"{ms['kernel']:.4f} ms, library {ms['library']:.4f}, plain {ms['plain']:.4f}; "
            f"bound {bnd * 1e3:.2f} us ({by}), FMA figure {fma_peak_ms(flops) * 1e3:.2f} us")
        k_us, l_us = us["kernel"], us["library"]
        if k_us is not None and l_us is not None:
            say(f"    B={bb}: the kernel's device time {k_us:.2f} us against the library "
                f"call's {l_us:.2f} us ({k_us / l_us:.2f}x): "
                f"{'at or below' if k_us <= l_us else 'ABOVE'} it")
    r64 = by_batch[64]
    return dict(name="ln_proj_tail_fp32", route="cuda", source="tpu_reid_torch/csrc/tail_kernel.cu",
                replaces="tpu_reid/ops/fused_tail.py:31", max_abs_err=errs[(64, d, e, 0)],
                ms=r64["ms"]["kernel"], plain_ms=r64["ms"]["plain"], bound_ms=r64["bound_ms"],
                bound_by=r64["bound_by"], library_ms=r64["ms"]["library"],
                device_us=r64["device_us"], dtype="float32", b=64,
                b128=by_batch[128], b512=by_batch[512])


# the GEMM and attention kernels' edge shapes, by dtype. ln_gemm: (B, S, K,
# N, gelu, splice, odd), K <= 768 taking the bf16 kernel's 128-row panel and
# K = 1024 its 64-row one; ln_gemm without LN: (B, S, K, N, gelu);
# gemm_bias_residual: (B, S, K, N, residual, splice, odd); attention: the S
# (causal or not) and the (B, H). odd: the operands the fp32 kernel reads one
# by one (FP32_SCALAR_OPERANDS) at 4 bytes past a 16-byte boundary.
EDGE_SHAPES = {
    torch.bfloat16: dict(
        ln_gemm=((1, 77, 512, 1536, False, False, False), (3, 77, 512, 2048, True, False, False),
                 (64, 77, 512, 512, False, False, False), (1, 211, 768, 2304, False, False, False),
                 (3, 213, 768, 3072, True, True, False), (64, 213, 768, 2304, False, True, False),
                 (128, 211, 768, 3072, True, False, False),
                 (512, 213, 768, 2304, False, True, False),
                 (512, 213, 768, 3072, True, False, False), (3, 211, 768, 776, False, False, False),
                 (3, 50, 1024, 520, True, False, False), (64, 211, 1024, 768, False, False, False)),
        no_ln=((3, 77, 2048, 512, False), (64, 211, 3072, 768, True)),
        gemm=((1, 77, 512, 512, True, False, False), (3, 77, 2048, 512, True, False, False),
              (64, 213, 768, 768, True, True, False), (128, 211, 3072, 768, True, False, False),
              (512, 213, 768, 768, True, True, False), (512, 213, 3072, 768, True, False, False),
              (3, 211, 768, 776, True, False, False), (1, 211, 3072, 1536, False, False, False),
              (64, 77, 512, 2304, False, False, False), (3, 213, 32, 3072, True, True, False)),
        attention=(((1, False), (8, False), (50, False), (77, True), (211, False), (213, False),
                    (256, False), (200, True)), ((3, 8), (64, 12)))),
    torch.float32: dict(
        ln_gemm=((1, 77, 512, 1536, False, False, False), (3, 77, 512, 2048, True, False, True),
                 (64, 213, 768, 2304, False, True, False), (3, 213, 768, 3072, True, True, True),
                 (128, 211, 768, 3072, True, False, False), (3, 211, 768, 776, False, False, False),
                 (3, 50, 1024, 520, True, False, True), (2, 5, 32, 8, False, False, False)),
        no_ln=((3, 77, 2048, 512, False), (64, 211, 3072, 768, True), (1, 3, 64, 24, True)),
        gemm=((1, 77, 512, 512, True, False, False), (3, 77, 2048, 512, True, False, True),
              (64, 213, 768, 768, True, True, False), (128, 211, 3072, 768, True, False, False),
              (3, 211, 768, 776, True, False, True), (1, 211, 3072, 1536, False, False, False),
              (3, 213, 32, 3072, True, True, True), (5, 7, 96, 40, False, False, True)),
        attention=(((1, False), (8, False), (50, False), (77, True), (200, True), (211, False),
                    (213, False), (256, False), (257, False), (442, False), (444, True)),
                   ((3, 8), (16, 12)))),
}


def edge_checks(dev, rng, check, dtype):
    """The GEMM and attention kernels of one dtype at the shapes that break
    pipelines and edges (EDGE_SHAPES), against their plain versions: both
    GEMM modes (with LayerNorm and without), the three epilogues (bias,
    QuickGELU, residual), the deep-prompt splice on the LayerNorm's rows and
    on the residual, ragged row tiles, N and K tails, rings that wrap many
    times; in fp32 the scalar operands off 16 bytes; attention at every S
    that changes its tiling (the text tower's causal S = 77 among them),
    qkv views and contiguous, exact and fast, masked and not."""
    from tpu_reid_torch.models.layers import causal_mask
    from tpu_reid_torch.ops import attention as TA
    from tpu_reid_torch.ops import fused_attention as FA

    shapes, name = EDGE_SHAPES[dtype], str(dtype)[6:]
    tag = "" if dtype == torch.bfloat16 else f" {name}"

    def t(*shape, std=1.0, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * std).to(dev, dt)

    def off16(v):
        """v at an address 4 bytes past a 16-byte boundary"""
        if v is None:
            return None
        buf = torch.empty(v.numel() + 1, device=dev, dtype=v.dtype)
        buf[1:] = v.reshape(-1)
        return buf[1:].view(v.shape)

    def splice(seq, width):
        pm = torch.zeros(seq, 1, device=dev)
        pm[seq - 2:] = 1.0
        return t(seq, width), pm

    def flags(*named):
        return "".join(f" {n}" for n, on in named if on)

    say(f"ln_gemm / gemm_bias_residual ({name}) at edge shapes against their plain versions")
    for b, s, k, n, gelu, sp, odd in shapes["ln_gemm"]:
        x, w, bias = t(b, s, k), t(k, n, std=k ** -0.5), t(n, std=0.02)
        g, gb = 1 + t(k, std=0.05, dt=torch.float32), t(k, std=0.05, dt=torch.float32)
        plane, pm = splice(s, k) if sp else (None, None)
        if odd:
            bias, g, gb, pm = off16(bias), off16(g), off16(gb), off16(pm)
        check(f"ln_gemm{tag}[B={b} S={s} K={k} N={n}"
              f"{flags(('gelu', gelu), ('splice', sp), ('odd addresses', odd))}]",
              FA.ln_gemm(x, g, gb, w, bias, gelu, plane, pm),
              FA.ln_gemm_reference(x, g, gb, w, bias, gelu, plane, pm), dtype)
        del x, w
    for b, s, k, n, gelu in shapes["no_ln"]:
        x, w, bias = t(b, s, k), t(k, n, std=k ** -0.5), t(n, std=0.02)
        check(f"ln_gemm{tag}[no LN B={b} S={s} K={k} N={n}{flags(('gelu', gelu))}]",
              FA.ln_gemm(x, None, None, w, bias, gelu),
              FA.ln_gemm_reference(x, None, None, w, bias, gelu), dtype)
    for b, s, k, n, res, sp, odd in shapes["gemm"]:
        a, w, bias = t(b, s, k), t(k, n, std=k ** -0.5), t(n, std=0.02)
        r = t(b, s, n) if res else None
        plane, pm = splice(s, n) if sp else (None, None)
        if odd:
            bias, r, pm = off16(bias), off16(r), off16(pm)
        check(f"gemm_bias_residual{tag}[B={b} S={s} K={k} N={n}"
              f"{flags(('residual', res), ('splice', sp), ('odd addresses', odd))}]",
              FA.gemm_bias_residual(a, w, bias, r, plane, pm),
              FA.gemm_bias_residual_reference(a, w, bias, r, plane, pm), dtype)
        del a, w, r

    say(f"mha_core ({name}) at every S that changes its tiling, qkv views and contiguous")
    seqs, batches = shapes["attention"]
    for s, causal in seqs:
        for b, h in batches:
            qkv = t(b, s, 3 * h * 64)
            views = FA._qkv_views(qkv, h)
            contiguous = tuple(v.contiguous() for v in views)
            mask = causal_mask(s, device=dev) if causal else None
            for fast in (False, True):
                for label, ops in (("qkv views", views), ("contiguous", contiguous)):
                    check(f"mha_core{tag}[B={b} S={s} H={h}{flags(('causal', causal))} {label} "
                          f"{'fast' if fast else 'exact'}]",
                          TA.mha_core(*ops, mask, fast=fast),
                          TA.mha_core_reference(*ops, mask, fast=fast), dtype)


def ln_repeat_host_checks(dev, rng, failures):
    """The bf16 kernels: LayerNorm against precomputed LayerNorm bit for bit;
    50 launches bit-equal; the host cost of a wrapper call in both dtypes."""
    from tpu_reid_torch.ops import attention as TA
    from tpu_reid_torch.ops import fused_attention as FA

    bf = torch.bfloat16

    def t(*shape, std=1.0, dt=bf):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * std).to(dev, dt)

    # LayerNorm in the call against LayerNorm done beforehand: with W = I and
    # no bias the call hands out its own normalised rows exactly (a product
    # with the identity adds only zeros); fed back without LN, the same
    # mainloop runs on the same bf16 operands, so the outputs must be
    # bit-equal. Those rows are also held against the plain version's rule.
    say("ln_gemm with LN against ln_gemm without LN on the precomputed LayerNorm output")
    for b, s, k, n in ((128, 211, 768, 2304), (64, 77, 512, 1536), (16, 50, 1024, 1024)):
        x, w, bias = t(b, s, k), t(k, n, std=k ** -0.5), t(n, std=0.02)
        g, gb = 1 + t(k, std=0.05, dt=torch.float32), t(k, std=0.05, dt=torch.float32)
        eye = torch.eye(k, device=dev, dtype=bf)
        h_kernel = FA.ln_gemm(x, g, gb, eye, torch.zeros(k, device=dev, dtype=bf))
        h_plain = FA.layer_norm({"scale": g, "bias": gb}, x)
        with_ln = FA.ln_gemm(x, g, gb, w, bias)
        same = torch.equal(with_ln, FA.ln_gemm(h_kernel, None, None, w, bias))
        differ = int((h_kernel != h_plain).sum())
        err, rel = rel_err(h_kernel, h_plain)
        same_plain = torch.equal(with_ln, FA.ln_gemm(h_plain, None, None, w, bias))
        ok = same and rel <= 2.0 ** -7 and (differ > 0 or same_plain)
        say(f"  B={b} S={s} K={k} N={n}: LN in the kernel vs the kernel's own LN output fed back: "
            f"{'bit-equal' if same else 'DIFFERENT'}; that output vs the plain rule: {differ} of "
            f"{h_plain.numel()} elements differ (max|d| {err:.3e}: one bf16 rounding where the "
            f"fp32 sums are taken in another order), outputs "
            f"{'bit-equal' if same_plain else 'differ there'} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"LN vs precomputed LN at K={k}")
        del x, w, eye

    # 50 launches on one input: a wrong barrier phase or a race shows as a
    # changed bit once the rings have wrapped
    b, s, d, hid = 128, 211, 768, 3072
    x, hh, qkv = t(b, s, d), t(b, s, hid), t(b, s, 3 * d)
    g, gb = 1 + t(d, std=0.05, dt=torch.float32), t(d, std=0.05, dt=torch.float32)
    w_fc, b_fc = t(d, hid, std=d ** -0.5), t(hid, std=0.02)
    w_pr, b_pr = t(hid, d, std=hid ** -0.5), t(d, std=0.02)
    views = FA._qkv_views(qkv, 12)
    for label, fn in (("ln_gemm c_fc", lambda: FA.ln_gemm(x, g, gb, w_fc, b_fc, True)),
                      ("gemm_bias_residual c_proj", lambda: FA.gemm_bias_residual(hh, w_pr, b_pr, x)),
                      ("mha_core exact", lambda: TA.mha_core(*views)),
                      ("mha_core fast", lambda: TA.mha_core(*views, fast=True))):
        first = fn()
        same = all(torch.equal(first, fn()) for _ in range(49))
        say(f"  {label}: 50 launches on one input {'bit-equal' if same else 'DIFFER'}")
        if not same:
            failures.append(f"{label} repeat")

    # host cost of a wrapper call, bf16 (two or three tensor maps encoded per
    # launch) beside fp32 (no tensor map): small shapes, so the card keeps
    # ahead of the host
    for dt in (bf, torch.float32):
        xs, ws, bs = t(1, 77, 512, dt=dt), t(512, 512, std=512 ** -0.5, dt=dt), t(512, std=0.02, dt=dt)
        gs, gbs = 1 + t(512, std=0.05, dt=torch.float32), t(512, std=0.05, dt=torch.float32)
        vs = FA._qkv_views(t(1, 77, 3 * 512, dt=dt), 8)
        for label, fn in (("ln_gemm", lambda: FA.ln_gemm(xs, gs, gbs, ws, bs)),
                          ("gemm_bias_residual", lambda: FA.gemm_bias_residual(xs, ws, bs, xs)),
                          ("mha_core", lambda: TA.mha_core(*vs))):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            say(f"  host time of one {label} call at B=1 S=77 width 512, {str(dt)[6:]}: "
                f"{host_us:.1f} us")


# the bf16 LayerNorm products' shapes: (label, B, S, K, N, mode); mode qkv
# (the deep-prompt splice), gelu, bias, or residual (EVA02's sub-LN with the
# residual, epsilon 1e-6, through gemm_bias_residual); the TP shards' at
# market.embed's batch, N split T ways
LN_PROLOGUE_SHAPES = (
    ("kernel phase qkv", 128, 211, 768, 2304, "qkv"),
    ("kernel phase c_fc", 128, 211, 768, 3072, "gelu"),
    ("market.embed qkv", 512, 213, 768, 2304, "qkv"),
    ("market.embed c_fc", 512, 213, 768, 3072, "gelu"),
    ("veri.embed qkv", 256, 444, 768, 2304, "qkv"),
    ("veri.embed c_fc", 256, 444, 768, 3072, "gelu"),
    ("eva-veri.embed out-projection", 256, 327, 1024, 1024, "residual"),
    ("text tower qkv", 751, 77, 512, 1536, "bias"),
    ("one query qkv", 1, 213, 768, 2304, "qkv"),
    ("one query c_fc", 1, 213, 768, 3072, "gelu"),
    ("one query, flipped, qkv", 2, 213, 768, 2304, "qkv"),
    ("TP 2 qkv shard", 512, 213, 768, 1152, "qkv"),
    ("TP 2 c_fc shard", 512, 213, 768, 1536, "gelu"),
    ("TP 4 qkv shard", 512, 213, 768, 576, "qkv"),
    ("TP 4 c_fc shard", 512, 213, 768, 768, "gelu"),
    ("TP 12 qkv shard", 512, 213, 768, 192, "qkv"),
    ("TP 12 c_fc shard", 512, 213, 768, 256, "gelu"),
)


def ln_prologue_operands(b, s, k, n, mode, dev):
    """Seeded operands of one LN_PROLOGUE_SHAPES entry: x, gamma, beta, w,
    bias, the plane and mask (qkv: of the input; residual: of the residual)
    and the residual (or None)."""
    gen = torch.Generator(device="cpu").manual_seed(0)

    def t(*shape, std=1.0, mean=0.0, dt=torch.bfloat16):
        return (mean + std * torch.randn(*shape, generator=gen)).to(dt).to(dev)

    x = t(b, s, k)
    g, gb = t(k, std=0.1, mean=1.0, dt=torch.float32), t(k, std=0.1, dt=torch.float32)
    w, bias = t(k, n, std=k ** -0.5), t(n, std=0.02)
    plane = pmask = None
    if mode in ("qkv", "residual"):
        plane, pmask = t(s, k if mode == "qkv" else n), torch.zeros(s, device=dev)
        pmask[1:3] = 1.0
    res = t(b, s, n) if mode == "residual" else None
    return x, g, gb, w, bias, plane, pmask, res


def ln_prologue_times(dev):
    """The bf16 LayerNorm products (ln_gemm and gemm_bias_residual with
    LayerNorm: `ln_rows`' kernel, then the product without LN) at the shapes
    that run them: CUDA-event medians of 20 (one call each, host time
    included where it is the longer), beside the product alone on rows
    normalised beforehand, with the operations' bound against 989 TF/s."""
    from tpu_reid_torch.ops import fused_attention as FA

    say("the bf16 LayerNorm products: ln_rows + the product in one call, and the product alone")
    for label, b, s, k, n, mode in LN_PROLOGUE_SHAPES:
        x, g, gb, w, bias, plane, pmask, res = ln_prologue_operands(b, s, k, n, mode, dev)
        eps = 1e-6 if mode == "residual" else 1e-5
        if mode == "residual":
            h = FA.ln_rows(x, g, gb, k, eps)
            with_ln = lambda: FA.gemm_bias_residual(x, w, bias, res, plane, pmask,  # noqa: E731
                                                    ln_scale=g, ln_bias=gb, eps=eps)
            alone = lambda: FA.gemm_bias_residual(h, w, bias, res, plane, pmask)  # noqa: E731
        else:
            gelu, lp, lm = mode == "gelu", (plane if mode == "qkv" else None), pmask
            h = FA.ln_rows(x, g, gb, k, eps, lp, lm)
            with_ln = lambda: FA.ln_gemm(x, g, gb, w, bias, gelu, lp, lm, eps=eps)  # noqa: E731
            alone = lambda: FA.ln_gemm(h, None, None, w, bias, gelu)  # noqa: E731
        ms, ms_alone = time_ms(with_ln), time_ms(alone)
        flops = 2.0 * b * s * k * n
        bnd, by = bound(flops, 2.0 * (b * s * k + k * n + b * s * n))
        say(f"  {label} (B={b} S={s} K={k} N={n}): {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
            f"bound {bnd:.4f} ms by {by}); the product alone {ms_alone:.4f} ms")
        del x, w, plane, h, res
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: the minsum kernel against its plain version, and its times
# ---------------------------------------------------------------------------


def minsum_operands(na, nb, c, dtype, dev, seed):
    """Non-negative rows (uniform cubed) quantized per row as re-ranking
    does: values in `dtype` with the row max at 448 for fp8 and at 1
    otherwise, and the fp32 scales."""
    g = torch.Generator(device=dev).manual_seed(seed)
    fmax = 448.0 if dtype == torch.float8_e4m3fn else 1.0
    out = []
    for n in (na, nb):
        x = torch.rand(n, c, device=dev, generator=g) ** 3
        scale = x.max(dim=1).values / fmax
        out += [(x / scale[:, None]).to(dtype), scale]
    return out


def minsum_phase(dev):
    from tpu_reid_torch.ops import minsum as MS

    fp8, bf = torch.float8_e4m3fn, torch.bfloat16
    say(f"minsum: kernel against minsum_reference on the card, tolerance max|kernel - plain| "
        f"<= {MINSUM_TOL:.0e} * max|plain| (only the order of the fp32 sums differs)")
    cases = [("fp8", fp8, 70, 130, 300, False), ("fp8 16-byte rows", fp8, 70, 130, 304, False),
             ("bf16", bf, 1000, 1500, 2500, False),
             ("fp32 unit scales", torch.float32, 257, 513, 1029, True),
             ("fp32 zero-padding", torch.float32, 9, 17, 130, True)]
    errs, failures = [], []
    for label, dt, na, nb, c, unit in cases:
        a, sa, b, sb = minsum_operands(na, nb, c, dt, dev, seed=len(errs))
        if unit:
            sa, sb = torch.ones_like(sa), torch.ones_like(sb)
        got = MS.minsum_kernel(a, sa, b, sb)
        want = MS.minsum_reference(a, sa, b, sb)
        err, rel = rel_err(got, want)
        errs.append(err)
        ok = rel <= MINSUM_TOL
        say(f"  minsum[{label} {na}x{c} by {nb}x{c}]: max|d| {err:.3e}, rel {rel:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)

    # the Market-1501 streamed contraction: (4096, 20480) x (16384, 20480) fp8
    na, nb, c = 4096, 16384, 20480
    a, sa, b, sb = minsum_operands(na, nb, c, fp8, dev, seed=7)
    out = MS.minsum_kernel(a, sa, b, sb)
    slab = 64
    plain = MS.minsum_reference(a[:slab], sa[:slab], b, sb)
    err, rel = rel_err(out[:slab], plain)
    ok = rel <= MINSUM_TOL
    say(f"  minsum[fp8 Market {na}x{c} by {nb}x{c}, first {slab} rows]: max|d| {err:.3e}, "
        f"rel {rel:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("Market shape")
    errs.append(err)
    torch.cuda.synchronize()
    if failures:
        raise PhaseFailed(f"the minsum kernel disagrees with its plain version: {failures}")
    del out, plain

    ops = 2.0 * na * nb * c
    nbytes = (na + nb) * c + 4.0 * (na + nb) + 4.0 * na * nb
    bnd, by = bound(ops, nbytes, PEAK_FP32_CUDA_CORE_OPS)
    k_ms = time_ms(lambda: MS.minsum_kernel(a, sa, b, sb), reps=5, warmup=2)
    p_ms = time_ms(lambda: MS.minsum_reference(a[:slab], sa[:slab], b, sb), reps=3, warmup=1)
    af = a.float() * sa[:, None]
    bf_ = b.float() * sb[:, None]
    del a, b
    # yardstick: min(x, y) = (x + y - |x - y|) / 2, so t = (sum a_i + sum b_j - L1) / 2
    l_ms = time_ms(lambda: torch.cdist(af, bf_, p=1), reps=3, warmup=1)
    del af, bf_
    say(f"  minsum at the Market-1501 streamed shape ({na} x {nb} x {c}, fp8): kernel "
        f"{k_ms:.3f} ms, bound {bnd:.3f} ms ({by}, {ops / 1e12:.2f}e12 fminf+fadd at "
        f"{PEAK_FP32_CUDA_CORE_OPS / 1e12:.1f}e12/s: {100 * bnd / k_ms:.1f}% of it), "
        f"cdist(p=1) yardstick {l_ms:.3f} ms, plain {p_ms:.3f} ms on a {slab}-row query slab "
        f"(x{na // slab} = {p_ms * na / slab:.0f} ms for all rows)")

    # one 1024-row query slab of the MSMT17 contraction: 1024 x 82944 x 94208
    sna, snb, sc = 1024, 82944, 94208
    g = torch.Generator(device=dev).manual_seed(11)
    # random non-negative finite e4m3fn bytes (0x00-0x7e; 0x7f is NaN)
    a8 = torch.randint(0, 0x7F, (sna, sc), device=dev, dtype=torch.uint8,
                       generator=g).view(fp8)
    b8 = torch.randint(0, 0x7F, (snb, sc), device=dev, dtype=torch.uint8,
                       generator=g).view(fp8)
    ssa = torch.rand(sna, device=dev, generator=g) / 448
    ssb = torch.rand(snb, device=dev, generator=g) / 448
    s_ms = time_ms(lambda: MS.minsum_kernel(a8, ssa, b8, ssb), reps=3, warmup=1)
    s_bnd, _ = bound(2.0 * sna * snb * sc, (sna + snb) * sc + 4.0 * sna * snb,
                     PEAK_FP32_CUDA_CORE_OPS)
    del a8, b8
    say(f"  minsum on one MSMT17 query slab ({sna} x {snb} x {sc}, fp8): kernel {s_ms:.3f} ms, "
        f"bound {s_bnd:.3f} ms ({100 * s_bnd / s_ms:.1f}% of it)")
    torch.cuda.empty_cache()
    return dict(name="minsum", route="cuda", source="tpu_reid_torch/csrc/minsum_kernel.cu",
                replaces="tpu_reid/ops/minsum.py:41", max_abs_err=max(errs), ms=k_ms,
                plain_ms=p_ms, plain_rows=slab, bound_ms=bnd, bound_by=by, library_ms=l_ms,
                msmt17_slab_ms=s_ms, msmt17_slab_bound_ms=s_bnd)


# ---------------------------------------------------------------------------
# phase 6: the zero-shot main path
# ---------------------------------------------------------------------------

SENTENCE_TEMPLATES = (
    "itap of a {}", "a bad photo of the {}", "a origami {}",
    "a photo of the large {}", "a {} in a video game", "art of the {}",
    "a photo of the small {}",
)


def make_images(n_ids, n_query, n_gallery, seed, mix=0.35):
    """Per-identity base images plus noise (uint8 NHWC); query camera 0,
    gallery cameras 1..5, so every query keeps all its positives."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (n_ids, 16, 8, 3)).astype(np.float32)
    base = base.repeat(16, axis=1).repeat(16, axis=2)  # blocky 256x128

    def draw(pids):
        noise = rng.uniform(0, 255, (len(pids), 256, 128, 3)).astype(np.float32)
        return np.clip(mix * base[pids] + (1 - mix) * noise, 0, 255).astype(np.uint8)

    q_pids = np.arange(n_query) % n_ids
    g_pids = np.arange(n_gallery) % n_ids
    q_cam = np.zeros(n_query, np.int64)
    g_cam = 1 + rng.integers(0, 5, n_gallery)
    return draw(q_pids), q_pids, q_cam, draw(g_pids), g_pids, g_cam


def batches(images, pids, camids, bs):
    for i in range(0, len(images), bs):
        sl = slice(i, i + bs)
        n = len(images[sl])
        yield SimpleNamespace(images=images[sl], pids=pids[sl], camids=camids[sl],
                              seqids=np.zeros(n, np.int64), valid=np.ones(n, bool))


def make_zero_shot_extractor(params, cfg, dtype, dev):
    """The main path's step at 256x128 with flip-TTA: for a ViT the
    normalization folded into the patch embed, for a ResNet ImageNet
    statistics and no fold (as the zero-shot CLI does)."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models.vit import fold_visual_input_norm
    from tpu_reid_torch.parallel.extract import make_extractor
    from tpu_reid_torch.pipelines import zero_shot as Z

    vit = cfg.vision is not None
    pp = DevicePreprocess((256, 128), "vit" if vit else "rn", dtype=dtype)
    fold = None
    if vit:
        fold = lambda p: dict(p, visual=fold_visual_input_norm(p["visual"], "vit"))  # noqa: E731
    return make_extractor(Z.make_zeroshot_embed(params, cfg), pp, flip_tta=True,
                          dtype=dtype, fold=fold, device=dev)


def zero_shot_run(params, cfg, tokenizer, ids, templates, data, dtype, bs, dev):
    """classifier -> extraction -> scoring; returns the results and timings."""
    from tpu_reid_torch.parallel.extract import extract_embeddings
    from tpu_reid_torch.pipelines import zero_shot as Z

    qi, qp, qc, gi, gp, gc = data
    t = {}
    t0 = time.perf_counter()
    zs = Z.zeroshot_classifier(params, cfg, tokenizer, ids, templates, augmented=True,
                               device=dev)
    torch.cuda.synchronize()
    t["classifier_s"] = time.perf_counter() - t0
    extractor = make_zero_shot_extractor(params, cfg, dtype, dev)
    t0 = time.perf_counter()
    qf, qpids, qcams, _ = extract_embeddings(extractor, params, batches(qi, qp, qc, bs),
                                             device=dev)
    gf, gpids, gcams, _ = extract_embeddings(extractor, params, batches(gi, gp, gc, bs),
                                             device=dev)
    torch.cuda.synchronize()
    t["extract_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cmc, mAP, mINP = Z.evaluate_zero_shot(qf, gf, qpids, gpids, qcams, gcams,
                                          zs_weights=zs, proj_dim=cfg.embed_dim,
                                          multimodal=True, with_minp=True, device=dev)
    torch.cuda.synchronize()
    t["score_s"] = time.perf_counter() - t0
    return dict(zs=zs, qf=qf, gf=gf, cmc=cmc, mAP=mAP, mINP=mINP, times=t)


KERNEL_GROUPS = (("attention_long_bf16_kernel", "mha_core (S > 256)"),
                 ("ln_proj_tail_bf16_kernel", "ln_proj_tail"),
                 ("gemm_bf16_kernel", "ln_gemm / gemm_bias_residual"),
                 ("ln_rows_bf16_kernel", "ln_rows (bf16 LayerNorm)"),
                 ("gemm_tf32x3_kernel<true", "ln_gemm fp32"),
                 ("gemm_tf32x3_kernel<(bool)1", "ln_gemm fp32"),
                 ("gemm_tf32x3_kernel<false", "gemm_bias_residual / no-LN ln_gemm fp32"),
                 ("gemm_tf32x3_kernel<(bool)0", "gemm_bias_residual / no-LN ln_gemm fp32"),
                 ("attention_bf16_kernel", "mha_core"),
                 ("attention_tf32x3_kernel_bwd", "mha_core_backward fp32"),
                 ("attention_tf32x3_kernel", "mha_core fp32"),
                 ("ln_proj_tail_tf32x3_kernel", "ln_proj_tail fp32"),
                 ("ln_proj_tail_kernel", "ln_proj_tail (FMA)"),
                 ("minsum_kernel", "minsum"))


def profiled(fn):
    """torch.profiler over fn() (run once before, outside the trace): the
    events that ran on the card and the host wall time in microseconds."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return device_events(prof), wall_us


def trace(fn, label, top=12):
    """Device time by kernel of one fn() and the device's busy share of the
    host wall time."""
    return report_trace(*profiled(fn), label, top)


def busy_us(kernels) -> float:
    """The union of the kernels' spans on the card, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def report_trace(kernels, wall_us, label, top=12):
    """Print the device time by kernel and the busy share of `wall_us`;
    returns {"busy_ms", "wall_ms", "kernels"} (None without kernels)."""
    if not kernels:
        say(f"trace of {label}: the profiler recorded no kernel on the card "
            f"(device split not measured)")
        return None
    busy = busy_us(kernels)
    groups = {}
    for e in kernels:
        name = next((g for k, g in KERNEL_GROUPS if k in e.name), e.name[:70])
        t, n = groups.get(name, (0.0, 0))
        groups[name] = (t + e.time_range.end - e.time_range.start, n + 1)
    say(f"trace of {label}: host wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
        f"({100 * busy / wall_us:.1f}% of the wall; idle {100 * (1 - busy / wall_us):.1f}%), "
        f"{len(kernels)} kernels")
    for name, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:top]:
        say(f"  {t / 1e3:8.3f} ms  {100 * t / busy:5.1f}%  x{n:<4d} {name}")
    return {"busy_ms": busy / 1e3, "wall_ms": wall_us / 1e3, "kernels": len(kernels)}


def trace_step(params, cfg, images, dev):
    """One extraction step (128 images, bf16, flip-TTA) under the profiler."""
    extractor = make_zero_shot_extractor(params, cfg, torch.bfloat16, dev)
    x = torch.from_numpy(images).to(dev)
    trace(lambda: extractor(params, x),
          f"one extraction step ({len(images)} images, bf16, flip-TTA)")


def watchdog_cost(params, cfg, data, dev, rounds=2):
    """The extraction watchdog's cost: extract_embeddings (a CUDA event per
    batch, a StepWatchdog armed around the wait on the previous batch's)
    against a bare loop of the same extractor calls on the same 512 gallery
    images in batches of 128, in turns (bare, guarded, guarded, bare) for
    `rounds` rounds; the best time of each."""
    from tpu_reid_torch.parallel.extract import extract_embeddings

    extractor = make_zero_shot_extractor(params, cfg, torch.bfloat16, dev)
    gallery = list(batches(data[3], data[4], data[5], 128))

    def bare():
        return torch.cat([extractor(params, torch.as_tensor(b.images).to(dev))
                          for b in gallery])

    def watched():
        return extract_embeddings(extractor, params, gallery, device=dev)[0]

    times = {"bare": [], "watched": []}
    for name in ("bare", "watched", "watched", "bare") * rounds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (bare if name == "bare" else watched)()
        torch.cuda.synchronize()
        times[name].append(1e3 * (time.perf_counter() - t0))
    cost = min(times["watched"]) / min(times["bare"]) - 1.0
    say(f"  extraction watchdog: extract_embeddings {min(times['watched']):.3f} ms against a "
        f"bare loop of the same extractor calls {min(times['bare']):.3f} ms per "
        f"{len(data[3])}-image sweep, best of {2 * rounds} each (all: "
        + "; ".join(f"{k} {', '.join(f'{v:.3f}' for v in vs)}" for k, vs in times.items())
        + f"): cost {100 * cost:+.2f}%")


def zero_shot_prompts(n_ids=16):
    """(tokenizer, identity names, augmented templates) of the zero-shot
    phases: a BPE table of a few merges, 7 sentence templates per identity."""
    from tpu_reid_torch.models.tokenizer import ClipTokenizer, write_test_merges

    merges_dir = os.path.join(REPO, "build", "smoke")
    os.makedirs(merges_dir, exist_ok=True)
    merges = os.path.join(merges_dir, "merges.txt")
    write_test_merges(merges, [("p", "h"), ("ph", "o"), ("t", "o</w>"), ("pho", "to</w>"),
                               ("p", "e"), ("r", "s"), ("o", "n</w>"), ("a", "r")])
    ids = [str(i) for i in range(n_ids)]
    templates = {i: [st.format(f"person no.{i}") for st in SENTENCE_TEMPLATES] for i in ids}
    return ClipTokenizer(merges), ids, templates


def main_path_phase(dev, counters):
    from tpu_reid_torch.ops._build import kernel_impl
    from tpu_reid_torch.weights.convert import convert_clip, random_clip_state_dict

    t0 = time.perf_counter()
    sd = random_clip_state_dict(0)  # ViT-B/16 shapes, 14x14 pretrained grid
    cfg, params = convert_clip(sd, image_hw=(256, 128), stride=12, device=dev)
    torch.cuda.synchronize()
    say(f"weights: random ViT-B/16 state dict -> convert_clip (256x128, stride 12): "
        f"{cfg.vision.h_grid}x{cfg.vision.w_grid} grid, {cfg.vision.seq_len} tokens, "
        f"{time.perf_counter() - t0:.1f} s")
    if cfg.vision.seq_len != 211 or cfg.vision.width != 768 or cfg.vision.layers != 12:
        raise PhaseFailed(f"unexpected geometry {cfg.vision}")

    tokenizer, ids, templates = zero_shot_prompts()
    n_ids = len(ids)
    data = make_images(n_ids, 128, 512, seed=1)

    # warm-up (library loads, allocator), outside the counted run
    zero_shot_run(params, cfg, tokenizer, ids[:2],
                  {i: templates[i] for i in ids[:2]},
                  tuple(a[:8] for a in data[:3]) + tuple(a[:8] for a in data[3:]),
                  torch.bfloat16, 8, dev)

    for c in counters.values():
        c.launches = 0
    res = zero_shot_run(params, cfg, tokenizer, ids, templates, data, torch.bfloat16, 128, dev)
    launches = {name: c.launches for name, c in counters.items()}
    n_img = len(data[0]) + len(data[3])
    qf, gf = res["qf"], res["gf"]
    t = res["times"]
    say(f"main path (bf16, flip-TTA, fold, batches of 128): {len(data[0])} query + "
        f"{len(data[3])} gallery images, {n_ids} identities")
    say(f"  classifier {t['classifier_s']:.3f} s, extraction {t['extract_s']:.3f} s "
        f"({n_img / t['extract_s']:.1f} emb/s), scoring {t['score_s']:.3f} s")
    say(f"  Rank-1 {res['cmc'][0]:.4f}, Rank-5 {res['cmc'][4]:.4f}, mAP {res['mAP']:.4f}, "
        f"mINP {res['mINP']:.4f}")
    say(f"  launches in the run: {launches}")
    for name, f in (("query", qf), ("gallery", gf)):
        if f.shape != (len(data[0] if name == "query" else data[3]), 768 + 512) \
                or not torch.isfinite(f).all():
            raise PhaseFailed(f"{name} embeddings {tuple(f.shape)} not finite/expected")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise PhaseFailed(f"the main path never launched {missing}")
    if not 0.02 < res["mAP"] < 0.98:
        raise PhaseFailed(f"mAP {res['mAP']:.4f} too close to 0 or 1 to hold anything")
    watchdog_cost(params, cfg, data, dev)
    trace_step(params, cfg, data[3][:128], dev)

    # --- the same slice in fp32 on a subset, plain path vs kernels
    sub = (data[0][:32], data[1][:32], data[2][:32], data[3][:96], data[4][:96], data[5][:96])
    runs = {}
    for impl in ("plain", "auto"):
        with kernel_impl(impl):
            runs[impl] = zero_shot_run(params, cfg, tokenizer, ids, templates, sub,
                                       torch.float32, 32, dev)
    pl, kr = runs["plain"], runs["auto"]
    tol = 1e-3
    ok = True
    for key in ("zs", "qf", "gf"):
        err, rel = rel_err(kr[key], pl[key])
        good = rel <= tol
        ok &= good
        say(f"  fp32 slice {key}: kernels vs plain max|d| {err:.3e}, rel {rel:.3e} "
            f"(tol {tol:.0e}: fp32 sums in another order over 12 blocks) "
            f"{'ok' if good else 'FAIL'}")
    dm = max(float(np.abs(kr["cmc"] - pl["cmc"]).max()), abs(kr["mAP"] - pl["mAP"]),
             abs(kr["mINP"] - pl["mINP"]))
    say(f"  fp32 slice CMC/mAP/mINP: kernels {kr['cmc'][0]:.4f}/{kr['mAP']:.4f}/"
        f"{kr['mINP']:.4f}, plain {pl['cmc'][0]:.4f}/{pl['mAP']:.4f}/{pl['mINP']:.4f}, "
        f"max|d| {dm:.2e} (tol 1e-3) {'ok' if dm <= 1e-3 else 'FAIL'}")
    if not ok or dm > 1e-3:
        raise PhaseFailed("the kernel path disagrees with the plain path in fp32")
    return launches, n_img / t["extract_s"]


# ---------------------------------------------------------------------------
# phase 7: k-reciprocal re-ranking at Market-1501 scale
# ---------------------------------------------------------------------------


class PhaseTimes:
    """Seconds of named phases: the `log` the Evaluator hands its
    device-synchronised re-ranking passes to."""

    def __init__(self):
        self.seconds = {}

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


def market_features(dev, seed=0, noise=3.2, nuisance=0.0, rank=16):
    """Market-1501-sized synthetic features, numpy seed 0: 751 identities,
    6 cameras, 3368 queries and 15913 gallery rows of D = 1280 (ViT-B/16's
    cat(x12 CLS, xproj CLS)). Each row is an identity centre plus isotropic
    noise, L2-normalised; with `nuisance` > 0 also a shared low-rank part
    (`rank` directions, as pose or viewpoint would add) that makes
    identities confusable and keeps re-ranked mAP away from 1."""
    rng = np.random.default_rng(seed)
    n_ids, cams, nq, ng, d = 751, 6, 3368, 15913, 1280
    centers = rng.standard_normal((n_ids, d), dtype=np.float32)
    basis = nuisance * rng.standard_normal((rank, d), dtype=np.float32)
    q_pids, g_pids = np.arange(nq) % n_ids, np.arange(ng) % n_ids

    def draw(pids):
        x = (centers[pids] + rng.standard_normal((len(pids), rank), dtype=np.float32) @ basis
             + noise * rng.standard_normal((len(pids), d), dtype=np.float32))
        return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True)).to(dev)

    qf, gf = draw(q_pids), draw(g_pids)
    return qf, gf, q_pids, g_pids, rng.integers(0, cams, nq), rng.integers(0, cams, ng)


def evaluate_market(label, feats, **kw):
    """Evaluator(with_minp=True) over Market-sized features; prints and
    returns (cmc, mAP, mINP)."""
    from tpu_reid_torch.retrieval.metrics import Evaluator

    qf, gf, qp, gp, qc, gc = feats
    ev = Evaluator(len(qp), with_minp=True, **kw)
    ev.update(torch.cat([qf, gf]), np.concatenate([qp, gp]), np.concatenate([qc, gc]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cmc, mAP, mINP = ev.compute()
    torch.cuda.synchronize()
    say(f"  {label}: Rank-1 {cmc[0]:.4f}, Rank-5 {cmc[4]:.4f}, Rank-10 {cmc[9]:.4f}, "
        f"mAP {mAP:.4f}, mINP {mINP:.4f}, {time.perf_counter() - t0:.3f} s")
    return cmc, mAP, mINP


def hold_streamed_to_exact(exact, streamed):
    d_map, d_r1 = abs(streamed[1] - exact[1]), abs(streamed[0][0] - exact[0][0])
    ok = d_map < 0.005 and d_r1 < 0.02
    say(f"    streamed fp8 against exact: |dmAP| {d_map:.5f} (< 0.005), |dRank-1| {d_r1:.5f} "
        f"(< 0.02) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("the streamed route is out of JAX's bounds against the exact one")


def streamed_fp32_rows(feats, n_rows=256):
    """The streamed route without quantization: its metrics, and the
    re-ranked distances of the first n_rows queries with the exact route's
    (both on the Evaluator's normalised inputs)."""
    from tpu_reid_torch.retrieval.distance import l2_normalize
    from tpu_reid_torch.retrieval.metrics import cmc_map_from_rows
    from tpu_reid_torch.retrieval.rerank import k_reciprocal_rerank
    from tpu_reid_torch.retrieval.rerank_stream import k_reciprocal_rerank_streamed_rows

    qf, gf, qp, gp, qc, gc = feats
    qn, gn = l2_normalize(qf, axis=1), l2_normalize(gf, axis=1)
    exact_rows = k_reciprocal_rerank(qn, gn)[:n_rows]
    t0 = time.perf_counter()
    row_fn, q_chunk = k_reciprocal_rerank_streamed_rows(
        qn, gn, val_dtype=torch.float32, qe_dtype=torch.float32)
    metrics = cmc_map_from_rows(row_fn, q_chunk, qp, gp, qc, gc, with_minp=True)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return metrics, sec, (row_fn(0)[:n_rows] - exact_rows).abs()


def rerank_phase(dev):
    """Evaluator without re-ranking, then the exact and the streamed routes
    (bf16/fp8, and fp32) at Market-1501 scale; returns the minsum launches
    of the two Evaluator routes."""
    from tpu_reid_torch.ops._build import kernel_impl
    from tpu_reid_torch.ops import minsum as MS
    from tpu_reid_torch.retrieval.distance import l2_normalize
    from tpu_reid_torch.retrieval.metrics import Evaluator, cmc_map
    from tpu_reid_torch.retrieval.rerank import k_reciprocal_rerank

    feats = market_features(dev)
    qf, gf, qp, gp, qc, gc = feats
    say(f"re-ranking at Market-1501 scale: {len(qp)} queries, {len(gp)} gallery, 751 "
        f"identities, 6 cameras, D={qf.shape[1]}, synthetic features (numpy seed 0: identity "
        f"centre + isotropic noise); k1=50, k2=15, lambda=0.3")
    base = evaluate_market("no re-ranking", feats)
    if not 0.2 < base[1] < 0.8:
        raise PhaseFailed(f"mAP without re-ranking {base[1]:.4f} is outside (0.2, 0.8)")
    MS.minsum_kernel.launches = 0
    exact = evaluate_market("exact route", feats, reranking=True, rerank_mode="exact")
    n_exact = MS.minsum_kernel.launches
    times = PhaseTimes()
    streamed = evaluate_market("streamed route (bf16 V, fp8 V_qe)", feats, reranking=True,
                               rerank_mode="streamed", log=times)
    launches = MS.minsum_kernel.launches
    say("    streamed passes: " + ", ".join(
        f"{k.split('.')[-1]} {v:.3f} s" for k, v in times.seconds.items()))
    say(f"    minsum launches: exact route {n_exact}, streamed route {launches - n_exact}")
    if n_exact == 0 or launches == n_exact:
        raise PhaseFailed("a re-ranking route did not launch the minsum kernel")
    hold_streamed_to_exact(exact, streamed)
    for mode in ("exact", "streamed"):
        ev = Evaluator(len(qp), with_minp=True, reranking=True, rerank_mode=mode)
        ev.update(torch.cat([qf, gf]), np.concatenate([qp, gp]), np.concatenate([qc, gc]))
        trace(ev.compute, f"the {mode} route's Evaluator.compute", top=8)

    s32, sec, diff = streamed_fp32_rows(feats)
    err = float(diff.max())
    say(f"  streamed route, fp32 V and V_qe: Rank-1 {s32[0][0]:.4f}, mAP {s32[1]:.4f}, "
        f"mINP {s32[2]:.4f}, {sec:.3f} s; distances of the first 256 queries against exact: "
        f"max|d| {err:.3e} (atol 2e-5) {'ok' if err <= 2e-5 else 'FAIL'}")
    if not err <= 2e-5:
        raise PhaseFailed("streamed fp32 distances disagree with the exact route")

    # the exact route through the kernel against the plain min-sum
    qn, gn = l2_normalize(qf, axis=1)[:512], l2_normalize(gf, axis=1)[:2048]
    kd = k_reciprocal_rerank(qn, gn)
    with kernel_impl("plain"):
        pd = k_reciprocal_rerank(qn, gn)
    err = float((kd - pd).abs().max())
    ids = (qp[:512], gp[:2048], qc[:512], gc[:2048])
    km = cmc_map(kd, *ids, with_minp=True)
    pm = cmc_map(pd, *ids, with_minp=True)
    same = bool(np.array_equal(km[0], pm[0])) and km[1:] == pm[1:]
    say(f"  exact route on 512 + 2048, kernel against plain min-sum: max|d| {err:.3e} "
        f"(atol 1e-5), mAP {km[1]:.6f} / {pm[1]:.6f}, metrics "
        f"{'equal' if same else 'DIFFER'}")
    if not (err <= 1e-5 and same):
        raise PhaseFailed("the exact route through the kernel disagrees with the plain one")

    # confusable identities: re-ranked mAP away from 1, where the routes'
    # agreement on the metrics says more
    feats = market_features(dev, noise=2.0, nuisance=0.3)
    say("re-ranking at Market-1501 scale, confusable identities (isotropic noise + a shared "
        "16-direction nuisance part, numpy seed 0)")
    evaluate_market("no re-ranking", feats)
    exact = evaluate_market("exact route", feats, reranking=True, rerank_mode="exact")
    streamed = evaluate_market("streamed route (bf16 V, fp8 V_qe)", feats, reranking=True,
                               rerank_mode="streamed")
    hold_streamed_to_exact(exact, streamed)
    s32, sec, diff = streamed_fp32_rows(feats)
    say(f"  streamed route, fp32 V and V_qe: Rank-1 {s32[0][0]:.4f}, mAP {s32[1]:.4f}, "
        f"mINP {s32[2]:.4f}; distances of the first 256 queries against exact: max|d| "
        f"{float(diff.max()):.3e}, rows within 2e-5: {int((diff.amax(1) <= 2e-5).sum())} of "
        f"256 (near-tied neighbour lists may order differently in the two formulations)")
    return launches


# ---------------------------------------------------------------------------
# phase 11: both CLIs at full ViT-B/16 width
# ---------------------------------------------------------------------------


def write_market_dir(root, n_ids=32, n_query=2, n_gallery=8, n_train=8, seed=2, mix=0.45):
    """A Market1501-layout directory of 256x128 JPEGs: a blocky base image
    per identity plus noise; n_ids test identities (queries on camera 1,
    gallery on cameras 2-6) and n_ids other training identities of n_train
    images each."""
    import concurrent.futures as cf

    from PIL import Image

    base_dir = os.path.join(root, "Market1501")
    for sub in ("bounding_box_train", "query", "bounding_box_test"):
        os.makedirs(os.path.join(base_dir, sub))
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (2 * n_ids, 16, 8, 3))

    def save(img, path):
        Image.fromarray(img).save(path, quality=90)

    # the draws in order on this thread, the JPEG encoding on a pool
    with cf.ThreadPoolExecutor(8) as pool:
        pending = []
        for pid in range(2 * n_ids):
            test = pid < n_ids
            big = base[pid].repeat(16, axis=0).repeat(16, axis=1)
            for k in range(n_query + n_gallery if test else n_train):
                noise = rng.uniform(0, 255, (256, 128, 3))
                img = np.clip(mix * big + (1 - mix) * noise, 0, 255).astype(np.uint8)
                if test:
                    sub, cam = ("query", 1) if k < n_query else ("bounding_box_test", 2 + k % 5)
                else:
                    sub, cam = "bounding_box_train", 1 + k % 6
                pending.append(pool.submit(save, img, os.path.join(
                    base_dir, sub, f"{pid + 1:04d}_c{cam}s1_{k:06d}_00.jpg")))
        for f in pending:
            f.result()
    return n_ids * n_query, n_ids * n_gallery


def cli_phase(counters):
    """The zero-shot CLI, then the prompt-learning CLI, on one synthetic
    directory and checkpoint; returns each run's launches."""
    import tempfile

    from tpu_reid_torch.cli import prompt_learning as pl_cli
    from tpu_reid_torch.cli import zero_shot as cli
    from tpu_reid_torch.models.tokenizer import write_test_merges
    from tpu_reid_torch.weights.convert import random_clip_state_dict

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        nq, ng = write_market_dir(tmp)
        ckpt = os.path.join(tmp, "vit_b16_random.pth")
        torch.save({k: torch.from_numpy(v) for k, v in random_clip_state_dict(0).items()}, ckpt)
        merges = os.path.join(tmp, "merges.txt")
        write_test_merges(merges, [("p", "e"), ("r", "s"), ("o", "n</w>"), ("n", "o")])
        say(f"CLI: {nq} query + {ng} gallery JPEGs (32 identities) and a random ViT-B/16 "
            f"checkpoint written in {time.perf_counter() - t0:.1f} s; running "
            f"python -m tpu_reid_torch.cli.zero_shot --rerank --mm --height 256 --ratio 0.5 "
            f"--stride 12 --bs 128")
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        cmc, mAP = cli.main(["--root", tmp, "--model_path", ckpt, "--bpe_path", merges,
                             "--rerank", "--mm", "--height", "256", "--ratio", "0.5",
                             "--stride", "12", "--bs", "128", "--test_dataset", "market1501"])
        torch.cuda.synchronize()
        launches = runs["zero_shot_cli"] = {name: c.launches for name, c in counters.items()}
        say(f"  CLI run {time.perf_counter() - t0:.1f} s; launches {launches}")
        missing = [n for n, c in launches.items() if c == 0]
        if missing:
            raise PhaseFailed(f"the CLI never launched {missing}")
        if len(cmc) != min(50, ng) or not np.isfinite(cmc).all() or not 0.0 < mAP <= 1.0:
            raise PhaseFailed(f"CLI result out of range: cmc {len(cmc)} entries, mAP {mAP}")

        argv = ["--root", tmp, "--model_path", ckpt, "--bpe_path", merges,
                "--training_mode", "ivlp", "--epochs_stage1", "1", "--epochs_stage2", "1",
                "--rerank", "--dtype", "bf16", "--height", "256", "--ratio", "0.5",
                "--stride", "12", "--bs", "64", "--train_dataset", "market1501",
                "--save_path", os.path.join(tmp, "checkpoints")]
        say("prompt-learning CLI at full ViT-B/16 width: python -m "
            "tpu_reid_torch.cli.prompt_learning " + " ".join(argv[6:]) + " (32 training "
            "identities x 8 images, 64 query + 256 gallery)")
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        cmc, mAP = pl_cli.main(argv)
        torch.cuda.synchronize()
        launches = runs["prompt_learning_cli"] = {name: c.launches for name, c in counters.items()}
        say(f"  prompt-learning CLI run {time.perf_counter() - t0:.1f} s (phase seconds on the "
            f"[phase] lines above); launches {launches}")
        missing = [n for n, c in launches.items() if c == 0]
        if missing:
            raise PhaseFailed(f"the prompt-learning CLI never launched {missing}")
        if not np.isfinite(cmc).all() or not 0.0 < mAP <= 1.0:
            raise PhaseFailed(f"prompt-learning CLI result out of range: mAP {mAP}")
        resume_cli(pl_cli, argv, os.path.join(tmp, "checkpoints", "ivlp", "market1501"), 2,
                   mAP)
        fp32_cli_in_subprocess(tmp, ckpt, merges)
    return runs


# run in a fresh interpreter: `python -c FIRST_FP32_CONV OUT MODE ARGS...`
# runs the prompt-learning CLI with ARGS and saves its first fp32
# convolution (8 images of the input, the weights, the output, cuDNN's TF32
# flag at that call) to OUT. MODE "control" makes full_fp32_convs a no-op
# and ends the process after the save.
FIRST_FP32_CONV = r"""
import os, sys
import torch
import torch.nn.functional as F
import tpu_reid_torch.device as D

out, mode, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
conv2d = F.conv2d


def recorder(x, w, *args, **kwargs):
    y = conv2d(x, w, *args, **kwargs)
    if x.dtype == torch.float32 and x.is_cuda and not os.path.exists(out):
        torch.save(dict(x=x[:8].detach().clone(), w=w.detach().clone(), args=args,
                        kwargs=kwargs, y=y[:8].detach().clone(),
                        tf32=torch.backends.cudnn.allow_tf32), out)
        if mode == "control":
            os._exit(0)
    return y


F.conv2d = recorder
if mode == "control":
    D.full_fp32_convs = lambda: None
from tpu_reid_torch.cli import prompt_learning
prompt_learning.main(argv)
"""


def fp32_cli_in_subprocess(root, ckpt, merges, device="cuda"):
    """The prompt-learning CLI at its default --dtype fp32 in this process
    and again in a subprocess, a fresh interpreter with torch's defaults
    (cuDNN's TF32 on) that inherits none of this script's flags: the CLI's
    main must run its convolutions in full fp32 itself. The subprocess saves
    its first fp32 convolution (FIRST_FP32_CONV), which must be within the
    fp32 tolerance of that convolution in fp64; a control subprocess, whose
    full_fp32_convs does nothing, must miss it, or the check could not see
    TF32. Both CLI runs train from the same seed; the fp32 IVLP features of
    32 images under each run's final checkpoint must agree within the fp32
    tolerance."""
    from tpu_reid_torch.cli import prompt_learning as pl_cli
    from tpu_reid_torch.data.datasets import get_dataset
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.runtime.checkpoint import CheckpointManager

    common = ["--root", root, "--model_path", ckpt, "--bpe_path", merges, "--training_mode",
              "ivlp", "--epochs_stage1", "1", "--epochs_stage2", "1", "--height", "256",
              "--ratio", "0.5", "--stride", "12", "--bs", "64", "--train_dataset", "market1501",
              "--device", device]
    dirs = {w: os.path.join(root, f"fp32_{w}") for w in ("in_process", "subprocess", "control")}
    say("the fp32 prompt-learning CLI (its default dtype) in this process and in a subprocess: "
        "python -m tpu_reid_torch.cli.prompt_learning " + " ".join(common[6:]))
    t0 = time.perf_counter()
    _, map_in = pl_cli.main(common + ["--save_path", dirs["in_process"]])
    t_in = time.perf_counter() - t0
    torch.cuda.empty_cache()  # the subprocesses need the card's memory
    convs, t_sub, tail = {}, {}, {}
    for mode in ("subprocess", "control"):
        convs[mode] = os.path.join(root, f"first_fp32_conv_{mode}.pt")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", FIRST_FP32_CONV, convs[mode], mode,
                               *common, "--save_path", dirs[mode]], cwd=REPO,
                              capture_output=True, text=True, timeout=900)
        t_sub[mode] = time.perf_counter() - t0
        if proc.returncode != 0 or not os.path.exists(convs[mode]):
            raise PhaseFailed(f"the fp32 prompt-learning CLI in a {mode} subprocess exited "
                              f"with {proc.returncode}:\n{proc.stderr[-4000:]}")
        tail[mode] = [ln for ln in proc.stdout.splitlines() if "mAP" in ln][-1:]
    dev = torch.device(device)
    conv_rel, tf32_flag = {}, {}
    for mode, path in convs.items():
        rec = torch.load(path, map_location=dev)
        want = F.conv2d(rec["x"].double(), rec["w"].double(), *rec["args"], **rec["kwargs"])
        conv_rel[mode], tf32_flag[mode] = rel_err(rec["y"], want)[1], rec["tf32"]
    tol = TOL[torch.float32]
    conv_ok = conv_rel["subprocess"] <= tol and not tf32_flag["subprocess"]
    control_seen = conv_rel["control"] > tol
    say(f"  the first fp32 convolution of the CLI, {rec['x'].shape[0]} of its images against "
        f"fp64: subprocess rel {conv_rel['subprocess']:.3e} (cudnn.allow_tf32 "
        f"{tf32_flag['subprocess']}, tol {tol:.0e}) {'ok' if conv_ok else 'FAIL'}; control "
        f"with full_fp32_convs a no-op rel {conv_rel['control']:.3e} (cudnn.allow_tf32 "
        f"{tf32_flag['control']}, must exceed {tol:.0e}) "
        f"{'ok' if control_seen else 'FAIL'}, {t_sub['control']:.1f} s")
    if not control_seen:
        raise PhaseFailed("the control subprocess's TF32 convolution is within the fp32 "
                          "tolerance: the check cannot see TF32")
    if not conv_ok:
        raise PhaseFailed("the fp32 CLI in a subprocess runs its convolutions in TF32")
    args = pl_cli.params_parser(common)
    ds = get_dataset(root, "market1501")
    mcfg, _, (h, w) = pl_cli.build_model(args, ds.num_train_pids, ds.car_types_train, device=dev)
    pp32 = DevicePreprocess((h, w), "vit")
    images = pp32.eval_batch(torch.randint(0, 255, (32, h, w, 3), dtype=torch.uint8, device=dev,
                                           generator=torch.Generator(device=dev).manual_seed(4)))
    feats = {}
    for k in ("in_process", "subprocess"):
        mgr = CheckpointManager(os.path.join(dirs[k], "ivlp", "market1501"))
        params = mgr.restore(device=dev)["params"]
        mgr.close()
        with torch.no_grad():
            feats[k] = M.eval_embed(params, mcfg, images)
        del params
    err, rel = rel_err(feats["subprocess"], feats["in_process"])
    ok = rel <= tol
    say(f"  in process {t_in:.1f} s (mAP {map_in:.6f}), subprocess {t_sub['subprocess']:.1f} s "
        f"({tail['subprocess']}); fp32 features of 32 images under each final checkpoint: "
        f"max|d| {err:.3e}, rel {rel:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("the fp32 CLI in a subprocess trains other weights than in process")


def resume_cli(cli, argv, ckpt_dir, last_epoch, mAP):
    """After a finished CLI run: its final checkpoint is there (stage 2 done
    at epoch `last_epoch`), and the same command with --resume skips both
    stages and gives the mAP again within 1e-5."""
    from tpu_reid_torch.runtime.checkpoint import CheckpointManager

    mgr = CheckpointManager(ckpt_dir)
    epochs, latest = mgr.epochs(), mgr.latest_epoch()
    size = sum(os.path.getsize(os.path.join(ckpt_dir, f)) for f in os.listdir(ckpt_dir)
               if f.endswith(".pt"))
    stage = mgr.restore(latest)["stage"] if latest is not None else None
    mgr.close()
    if latest != last_epoch or stage != 2:
        raise PhaseFailed(f"{ckpt_dir}: checkpoints {epochs}, the newest stage {stage}; "
                          f"expected stage 2 at epoch {last_epoch}")
    t0 = time.perf_counter()
    cmc, mAP2 = cli.main(argv + ["--resume"])
    torch.cuda.synchronize()
    ok = abs(mAP2 - mAP) <= 1e-5
    say(f"  --resume: checkpoints {epochs} ({size / 2**20:.1f} MiB), both stages skipped, "
        f"{time.perf_counter() - t0:.1f} s; mAP {mAP2:.6f} against {mAP:.6f} (|d| "
        f"{abs(mAP2 - mAP):.1e}, tol 1e-5) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("the resumed CLI run does not reproduce the finished run's mAP")



# ---------------------------------------------------------------------------
# phase 5: gradients through the kernels, the autograd Functions against plain
# autograd
# ---------------------------------------------------------------------------


def gradient_phase(dev):
    """The block Function (kernels forward; backward the recompute with every
    gradient product on the fp32 GEMM kernel) against plain autograd of
    _block_xla_impl after the splice, at full width, B=16, S=213 with the
    splice, fp32, under one fixed grad_outputs; then the CLS-tail Function
    against ln_proj_tail_reference."""
    from tpu_reid_torch.ops import fused_attention as FA
    from tpu_reid_torch.ops import fused_tail as FT

    rng = np.random.default_rng(5)
    b, s, d, hid, heads = 16, 213, 768, 3072, 12
    f32 = torch.float32

    def t(*shape, std=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * std).to(dev)

    w = [v.requires_grad_() for v in block_params(rng, d, hid, f32, dev).values()]
    x, plane = t(b, s, d).requires_grad_(), t(s, d).requires_grad_()
    pm = torch.zeros(s, 1, device=dev)
    pm[s - 2:] = 1.0
    g = t(b, s, d)
    inputs = [x, plane, *w]
    out_k = FA.fused_block_autograd(x, *w, heads, None, prompt_plane=plane, prompt_mask=pm)
    grads_k = torch.autograd.grad(out_k, inputs, g)
    out_p = FA._block_xla_impl(FA._block_params(w), FA.splice_plane(x, plane, pm), heads, None)
    grads_p = torch.autograd.grad(out_p, inputs, g)
    names = ["x", "plane", "ln1_scale", "ln1_bias", "w_in", "b_in", "w_out", "b_out",
             "ln2_scale", "ln2_bias", "w_fc", "b_fc", "w_proj", "b_proj"]
    failures = []
    _, rel = rel_err(out_k, out_p)
    say(f"gradients: block Function vs plain autograd (B={b}, S={s} with the splice, fp32): "
        f"outputs rel {rel:.3e} (tol {TOL[f32]:.0e}) {'ok' if rel <= TOL[f32] else 'FAIL'}")
    if rel > TOL[f32]:
        failures.append("block output")
    worst = 0.0
    for name, gk, gp in zip(names, grads_k, grads_p):
        _, rel = rel_err(gk, gp)
        worst = max(worst, rel)
        if rel > 1e-5:
            failures.append(f"d{name}")
    say(f"  gradients of x, the plane and the 12 block tensors: worst rel {worst:.3e} "
        f"(tol 1e-5 of max|plain grad|: the kernel chain against cuBLAS fp32, both "
        f"fp32-accurate) "
        f"{'ok' if not failures else 'FAIL ' + str(failures)}")

    xt = t(b, d).requires_grad_()
    ln_s = (1 + t(d, std=0.05)).requires_grad_()
    ln_b = t(d, std=0.05).requires_grad_()
    proj = t(d, 512, std=d ** -0.5).requires_grad_()
    gy, gp = t(b, d), t(b, 512)
    yk, pk = FT._TailFn.apply(xt, ln_s, ln_b, proj, None, 1e-5)
    yp, pp = FT.ln_proj_tail_reference(xt, ln_s, ln_b, proj)
    tk = torch.autograd.grad((yk, pk), [xt, ln_s, ln_b, proj], (gy, gp))
    tp = torch.autograd.grad((yp, pp), [xt, ln_s, ln_b, proj], (gy, gp))
    out_rel = max(rel_err(yk, yp)[1], rel_err(pk, pp)[1])
    grad_rel = max(rel_err(a, c)[1] for a, c in zip(tk, tp))
    ok = out_rel <= TOL[f32] and grad_rel <= 1e-5
    say(f"  tail Function vs plain autograd (B={b}, {d} -> 512, fp32): outputs rel "
        f"{out_rel:.3e}, gradients worst rel {grad_rel:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("tail")
    torch.cuda.synchronize()
    if failures:
        raise PhaseFailed(f"gradients through the kernels disagree: {failures}")


# ---------------------------------------------------------------------------
# phases 8 and 10: the IVLP flagship, serving (eval_embed) and training
# ---------------------------------------------------------------------------


def flagship(dev, n_cls=751, image_hw=(256, 128), seq_len=213):
    """bench.py's model in the port (tpu_reid_torch.entry.flagship): IVLP
    ViT-B/16 at 256x128, stride 12, prompt depth 12 with 2 context tokens
    (213 vision tokens), 751 classes, random weights from seed 0 (fp32); at
    image_hw (256, 256) the vehicle geometry, 444 vision tokens."""
    from tpu_reid_torch.entry import flagship as build

    return build(dev, n_cls=n_cls, image_hw=image_hw, seq_len=seq_len)


def random_template(cfg, clip, dev):
    """(embedded, token ids) of a random prompt template
    (tpu_reid_torch.entry.random_template)."""
    from tpu_reid_torch.entry import random_template as template

    return template(cfg, clip, dev)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


@contextlib.contextmanager
def held_against_plain(module, name, plain, errs):
    """For the scope, `module.<name>` runs the kernel wrapper and then its
    plain version on the same inputs, appending (max|d|, rel) of each output
    to `errs`, and returns the kernel's result."""
    kernel = getattr(module, name)

    def both(*a, **kw):
        got, want = kernel(*a, **kw), plain(*a, **kw)
        pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
        errs.extend(rel_err(g, w) for g, w in pairs)
        return got

    # a wrapper counts on its module-level name, so the scope's launches
    # land here and not on the kernel's counter
    both.launches = 0
    setattr(module, name, both)
    try:
        yield
    finally:
        setattr(module, name, kernel)


def ivlp_serving_phase(dev, counters, mcfg, params, k_batches=8, batch=512,
                       hw=(256, 128)):
    """eval_embed of the flagship at bench.py's profile (batch 512, bf16
    weights and activations, fast softmax, input normalisation folded into
    the patch embed, no flip-TTA) over 8 batches; a trace of one batch; the
    first batch again with every block and tail call held against its plain
    version, and its embeddings against the plain path; then an fp32 batch
    through the kernels against the plain path. The input size and the token
    count are the model's (`hw` 256x128 and 213, or 256x256 and 444)."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.ops._build import kernel_impl
    from tpu_reid_torch.ops import fused_attention as FA
    from tpu_reid_torch.ops import fused_tail as FT
    from tpu_reid_torch.ops.attention import set_fast_softmax
    from tpu_reid_torch.parallel.extract import make_extractor

    bf = torch.bfloat16
    tokens = mcfg.clip.vision.seq_len
    pbf = _cast(params, bf)
    fold = lambda p: M.fold_input_norm(p, mcfg, "vit")  # noqa: E731
    embed = lambda p, im: M.eval_embed(p, mcfg, im)  # noqa: E731
    ext = make_extractor(embed, DevicePreprocess(hw, "vit", dtype=bf), flip_tta=False,
                         dtype=bf, fold=fold, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.randint(0, 255, (k_batches, batch, *hw, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
    set_fast_softmax(True)
    try:
        ext(pbf, images[0])  # warm-up
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        outs = [ext(pbf, images[k]) for k in range(k_batches)]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
        emb_s = k_batches * batch / sec
        say(f"IVLP serving (eval_embed of the flagship, {hw[0]}x{hw[1]}, {tokens} tokens, batch "
            f"{batch}, bf16, fast "
            f"softmax, folded input norm, no flip-TTA): {k_batches} batches in {sec:.3f} s, "
            f"{emb_s:.1f} emb/s, {1e3 * sec / k_batches:.2f} ms per batch")
        say(f"  launches in the run: {launches}")
        trace(lambda: ext(pbf, images[0]),
              f"one IVLP eval_embed batch ({batch} images, {tokens} tokens, bf16)")
        # the timed profile itself against plain, on the first timed batch:
        # every fused block (spliced) and the CLS tail held against
        # its plain version on the very inputs the run hands it, then the
        # embeddings against the plain path
        errs = {"fused_block": [], "ln_proj_tail": []}
        with held_against_plain(FA, "fused_block", FA.fused_block_reference,
                                errs["fused_block"]), \
                held_against_plain(FT, "ln_proj_tail_kernel", FT.ln_proj_tail_reference,
                                   errs["ln_proj_tail"]):
            ek = ext(pbf, images[0])
        with kernel_impl("plain"):
            ep = ext(pbf, images[0])
    finally:
        set_fast_softmax(False)
    tol = TOL[bf]
    for name, es in errs.items():
        worst = max((rel for _, rel in es), default=float("inf"))
        say(f"  {name} at batch {batch}, bf16 fast, {len(es)} outputs of one batch, each against "
            f"its plain version on the run's own inputs: worst rel {worst:.3e} (tol {tol:.0e}) "
            f"{'ok' if worst <= tol else 'FAIL'}")
        if not es or worst > tol:
            raise PhaseFailed(f"IVLP serving: {name} disagrees with its plain version at "
                              f"batch {batch}")
    same = rel_err(ek, outs[0])[1]
    say(f"  the held batch against the same batch of the timed run: rel {same:.3e}")
    if same > 1e-3:
        raise PhaseFailed("IVLP serving: the held run differs from the timed run")
    err, rel = rel_err(ek, ep)
    cos = float(F.cosine_similarity(ek.float(), ep.float(), dim=-1).min())
    say(f"  bf16 IVLP embeddings ({batch} images, fast softmax), kernels vs plain path: max|d| "
        f"{err:.3e}, rel {rel:.3e}, least cosine {cos:.6f} (tol 0.99: the plain path's softmax "
        f"rounds its probabilities in bf16 where the kernels take exp2 in fp32, over 11 "
        f"blocks) {'ok' if cos >= 0.99 else 'FAIL'}")
    if cos < 0.99:
        raise PhaseFailed("the bf16 IVLP kernel path disagrees with the plain path")
    bad = [tuple(o.shape) for o in outs if o.shape != (batch, 768 + 512)
           or not torch.isfinite(o).all()]
    if bad:
        raise PhaseFailed(f"IVLP embeddings not finite / of the expected shape: {bad[:3]}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise PhaseFailed(f"IVLP serving never launched {missing}")
    del outs, images, ek, ep

    # fp32, 32 images: the kernels against the plain path
    ext32 = make_extractor(embed, DevicePreprocess(hw, "vit"), flip_tta=True,
                           dtype=torch.float32, fold=fold, device=dev)
    x = torch.randint(0, 255, (min(32, batch), *hw, 3), dtype=torch.uint8, device=dev,
                      generator=gen)
    ek = ext32(params, x)
    with kernel_impl("plain"):
        ep = ext32(params, x)
    err, rel = rel_err(ek, ep)
    say(f"  fp32 IVLP embeddings (32 images, flip-TTA), kernels vs plain: max|d| {err:.3e}, "
        f"rel {rel:.3e} (tol 1e-3: fp32 sums in another order over 12 blocks) "
        f"{'ok' if rel <= 1e-3 else 'FAIL'}")
    if rel > 1e-3:
        raise PhaseFailed("the IVLP kernel path disagrees with the plain path in fp32")
    return launches, emb_s


def timed_steps(stage, step, counters, losses, n=3):
    """n calls of step() (the first a warm-up), their losses appended to
    `losses`: ms per step after the warm-up, peak memory, launches in the n
    steps (each counter must have moved), then a traced step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    losses.append(step())  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n - 1):
        losses.append(step())
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (n - 1)
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"  {stage}: {ms:.1f} ms per step after a warm-up step, peak memory {peak:.2f} GiB, "
        f"launches in {n} steps {launches}")
    missing = [k for k, c in launches.items() if c == 0]
    if missing:
        raise PhaseFailed(f"{stage} never launched {missing}")
    trace(step, f"one {stage} step")
    return dict(ms=ms, peak_gib=peak, launches=launches)


def fp32_steps(dev, counters, mcfg, params, images, labels, valid, text, draws, bs, n=6):
    """fp32 activations over fp32 master weights (the training CLIs' default
    --dtype): a stage-2 step and a live stage-1 step of the flagship at bs
    64, each timed as the median of n warm steps (CUDA events around each
    step, no synchronisation between steps) on the host loop (eager, as
    run_stage2 / run_stage1 step) and as replays of one CUDA graph
    (StepGraph, as the cached runners replay); the fp32 kernels' launches
    per step on both and on the cached coop stage 1 (its text tower); a
    trace of each step (the 3xTF32 kernels, no FMA or bf16 kernel); one more
    step of each with every CLS-tail call held against its plain version on
    the step's own CLS rows; one captured stage-2 step against an eager step
    from the same state, loss and every updated tensor bit for bit."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.ops import fused_attention as FA
    from tpu_reid_torch.ops import fused_tail as FT
    from tpu_reid_torch.train import optim as O
    from tpu_reid_torch.train import trainer as TR
    from tpu_reid_torch.train.step_graph import StepGraph

    pp32 = DevicePreprocess((256, 128), "vit")
    tcfg = TR.TrainConfig()
    batch1 = {"images": pp32.eval_batch(images), "labels": labels, "valid": valid}
    imgs2 = pp32.train_batch(images, draws)

    def make(stage, capturable):
        capturable = capturable and dev.type == "cuda"  # Adam's capturable mode is CUDA-only
        if stage == "stage 2":
            tr, fr = O.partition(params, lambda q: M.stage2_trainable(q, mcfg))
            fr, bn = TR._bn_state(fr, mcfg)
            tr = TR._trainable_copy(tr)
            opt = O.make_stage_optimizer(tr, tcfg.lr_stage2, tcfg.weight_decay,
                                         bias_lr_mult=2.0, capturable=capturable)
            step = TR.make_stage2_step(mcfg, tcfg, opt)
            return (lambda: step(tr, fr, imgs2, labels, text, valid)), TR._TrainState(
                tr, opt, bn)
        tr, fr = O.partition(params, lambda q: M.stage1_trainable(q, mcfg))
        tr = TR._trainable_copy(tr)
        opt = O.make_stage_optimizer(tr, tcfg.lr_stage1, tcfg.weight_decay,
                                     capturable=capturable)
        step = TR.make_stage1_step(mcfg, opt, cached=False)
        return (lambda: step(tr, fr, batch1)), TR._TrainState(tr, opt)

    def median_ms(fn):
        fn()  # warm
        events = []
        for _ in range(n):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in events]

    say(f"fp32 training steps of the flagship at bs {bs} (fp32 activations and weights; "
        f"median of {n} warm steps, CUDA events around each)")
    report = {}
    for stage in ("stage 2", "live stage 1"):
        body, state = make(stage, False)
        body()
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        plain = FA.fused_block_backward.plain
        body()
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        # every block backward on the kernels, each with its attention core's
        # gradient: the 11 kernel blocks of the vision tower in stage 2 (the
        # 12th is the CLS block)
        plain = FA.fused_block_backward.plain - plain
        got = launches["mha_core_backward_fp32"]
        want = 11 if stage == "stage 2" else launches["fused_block_backward"]
        say(f"  fp32 {stage} step: {got} attention backward launches, {plain} plain")
        if plain or got != want or got != launches["fused_block_backward"]:
            raise PhaseFailed(f"the fp32 {stage} step ran {got} attention backward kernels in "
                              f"{launches['fused_block_backward']} block backwards on the "
                              f"kernels and {plain} plain")
        host = median_ms(body)
        kernels, wall_us = profiled(body)
        report_trace(kernels, wall_us, f"one fp32 {stage} step (host loop)")
        names = {e.name for e in kernels}
        absent = RETIRED_FP32_KERNELS + BF16_BLOCK_KERNELS
        found = {k: sum(k in n for n in names) for k in FP32_KERNELS + absent}
        say(f"  the block kernels in that trace (distinct names): {found}")
        if any(found[k] == 0 for k in FP32_KERNELS) or any(found[k] for k in absent):
            raise PhaseFailed(f"the fp32 {stage} step's trace shows {found}: the 3xTF32 "
                              f"kernels must run, and neither the FMA nor the bf16 ones")
        # one more step with its tail calls held against the plain version on
        # the step's own CLS rows
        errs = []
        with held_against_plain(FT, "ln_proj_tail_kernel", FT.ln_proj_tail_reference, errs):
            body()
        torch.cuda.synchronize()
        worst = max((rel for _, rel in errs), default=float("inf"))
        tol = TOL[torch.float32]
        say(f"  the fp32 {stage} step's CLS tail: {len(errs)} outputs, each against its plain "
            f"version on the step's own inputs: worst rel {worst:.3e} (tol {tol:.0e}) "
            f"{'ok' if errs and worst <= tol else 'FAIL'}")
        if not errs or worst > tol:
            raise PhaseFailed(f"the fp32 {stage} step's CLS tail disagrees with its plain "
                              f"version ({len(errs)} outputs, worst rel {worst:.3e})")
        del body, state
        body, state = make(stage, True)
        run = StepGraph(body, state.tensors, dev, name=f"fp32 {stage} step")
        graph = median_ms(run)
        run.release(TR._leaves(state.trainable))
        del body, state, run
        torch.cuda.empty_cache()
        report[f"fp32 {stage}"] = dict(host_ms=float(np.median(host)),
                                       graph_ms=float(np.median(graph)), host_all=host,
                                       graph_all=graph, launches=launches)
        say(f"  fp32 {stage} step: host loop {np.median(host):.2f} ms (steps "
            f"{', '.join(f'{v:.2f}' for v in host)}), CUDA graph {np.median(graph):.2f} ms "
            f"(replays {', '.join(f'{v:.2f}' for v in graph)}); launches in one step "
            f"{launches}")
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise PhaseFailed(f"the fp32 {stage} step never launched {missing}")

    # one captured stage-2 step against an eager step from the same state.
    # cuDNN's default fp32 weight-gradient algorithm of the patch-embed conv
    # is not deterministic (two eager steps differ in that leaf's Adam
    # moments by ~1e-9), so the comparison runs with cuDNN's deterministic
    # algorithms.
    def named(state):
        names = {id(t): "/".join(q) for q, t in O.paths(state.trainable) if t is not None}
        out = list(names.values())
        out += ["bn/" + "/".join(q) for q, t in O.paths(state.bn) if t is not None]
        for grp in state.optimizer.param_groups:
            for t in grp["params"]:
                out += [f"adam/{names[id(t)]}/{k}" for k, v in state.optimizer.state[t].items()
                        if isinstance(v, torch.Tensor)]
        return out

    def differing(sa, sb):
        return [(n, float((a.float() - b.float()).abs().max()))
                for n, a, b in zip(named(sa), sa.tensors(), sb.tensors())
                if not torch.equal(a, b)]

    def eager_and_captured():
        body_e, state_e = make("stage 2", True)
        loss_e = body_e()
        body_g, state_g = make("stage 2", True)
        run = StepGraph(body_g, state_g.tensors, dev, name="fp32 stage-2 step")
        loss_g = run()
        torch.cuda.synchronize()
        out = (loss_e, loss_g, differing(state_e, state_g), len(state_e.tensors()))
        run.release(TR._leaves(state_g.trainable))
        return out

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        loss_e, loss_g, captured, n_updated = eager_and_captured()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()
    same = torch.equal(loss_e, loss_g) and not captured
    say(f"  one captured fp32 stage-2 step against its eager step from the same state "
        f"(cuDNN deterministic): loss {float(loss_g):.6f} / {float(loss_e):.6f}, {n_updated} "
        f"updated tensors, {len(captured)} differ {captured}: "
        f"{'bit-equal' if same else 'DIFFERENT'}")
    if not same:
        raise PhaseFailed("a captured fp32 stage-2 step differs from its eager step")
    return report


def coop_stage1_fp32_launches(dev, counters, bs):
    """The fp32 kernels' launches in one cached coop stage-1 step (the text
    tower over all classes from precomputed image features) at bs 64."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.train import optim as O
    from tpu_reid_torch.train import trainer as TR

    mcfg, params = variant_model(dev, "coop")
    tcfg = TR.TrainConfig()
    gen = torch.Generator(device=dev).manual_seed(3)
    labels = torch.as_tensor(np.repeat(np.random.RandomState(3).choice(
        mcfg.n_cls, bs // 4, replace=False), 4), device=dev)
    pp32 = DevicePreprocess((256, 128), "vit")
    with torch.no_grad():
        e = M.encode_image_features(params, mcfg, pp32.eval_batch(torch.zeros(
            1, 256, 128, 3, dtype=torch.uint8, device=dev)))["proj"].shape[-1]
    batch = {"image_features": torch.randn(bs, e, device=dev, generator=gen), "labels": labels,
             "valid": torch.ones(bs, dtype=torch.bool, device=dev)}
    tr, fr = O.partition(params, lambda q: M.stage1_trainable(q, mcfg))
    tr = TR._trainable_copy(tr)
    step = TR.make_stage1_step(mcfg, O.make_stage_optimizer(tr, tcfg.lr_stage1,
                                                            tcfg.weight_decay), cached=True)
    step(tr, fr, batch)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    step(tr, fr, batch)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    say(f"  fp32 cached coop stage-1 step (bs {bs}): launches in one step {launches}")
    return launches


def training_phase(dev, counters, mcfg, params, bs=64):
    """Three live IVLP stage-1 steps and three stage-2 steps of the flagship
    at bs 64 (PK 16 x 4) in bf16 activations over fp32 master weights: ms
    per step after the warm-up step, peak memory, a traced step, launches;
    the peak memory of an fp32 stage-1 step; one fp32 stage-2 loss and
    gradient through the kernels against kernel_impl("plain")."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.ops._build import kernel_impl
    from tpu_reid_torch.ops import fused_attention as FA
    from tpu_reid_torch.train import optim as O
    from tpu_reid_torch.train import trainer as TR

    bf, f32 = torch.bfloat16, torch.float32
    tcfg = TR.TrainConfig()
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randint(0, 255, (bs, 256, 128, 3), dtype=torch.uint8, device=dev,
                           generator=gen)
    labels = torch.as_tensor(np.repeat(np.random.RandomState(1).choice(
        mcfg.n_cls, bs // 4, replace=False), 4), device=dev)
    valid = torch.ones(bs, dtype=torch.bool, device=dev)
    pp, pp32 = DevicePreprocess((256, 128), "vit", dtype=bf), DevicePreprocess((256, 128), "vit")
    losses = []
    report = {}

    def run(stage, step):
        report[stage] = timed_steps(stage, step, counters, losses)

    say(f"training the flagship ({mcfg.n_cls} classes) at bs {bs} (PK {bs // 4}x4), bf16 "
        f"activations, fp32 master weights")
    tr1, fr1 = O.partition(params, lambda p: M.stage1_trainable(p, mcfg))
    tr1 = TR._trainable_copy(tr1)
    step1 = TR.make_stage1_step(mcfg, O.make_stage_optimizer(tr1, tcfg.lr_stage1,
                                                             tcfg.weight_decay), cached=False)
    batch1 = {"images": pp.eval_batch(images), "labels": labels, "valid": valid}
    run("stage-1 live IVLP step", lambda: step1(tr1, fr1, batch1))

    with torch.no_grad():
        text = M.all_class_text_features(params, mcfg)
    tr2, fr2 = O.partition(params, lambda p: M.stage2_trainable(p, mcfg))
    frozen2 = fr2
    fr2 = TR._bn_state(fr2, mcfg)[0]  # the steps write the BN statistics in place
    tr2 = TR._trainable_copy(tr2)
    step2 = TR.make_stage2_step(mcfg, tcfg, O.make_stage_optimizer(
        tr2, tcfg.lr_stage2, tcfg.weight_decay, bias_lr_mult=2.0))
    draws = pp.train_draws(gen, bs)
    imgs2 = pp.train_batch(images, draws)
    run("stage-2 step", lambda: step2(tr2, fr2, imgs2, labels, text, valid))
    vals = [float(v) for v in losses]
    say(f"  losses: {', '.join(f'{v:.4f}' for v in vals)}")
    if not np.isfinite(vals).all():
        raise PhaseFailed(f"non-finite training losses {vals}")
    del tr2, step2

    # fp32 stage-1 step: both towers train prompts, the peak memory
    tr1f = TR._trainable_copy(O.partition(params, lambda p: M.stage1_trainable(p, mcfg))[0])
    step1f = TR.make_stage1_step(mcfg, O.make_stage_optimizer(tr1f, tcfg.lr_stage1,
                                                              tcfg.weight_decay), cached=False)
    batch1f = {"images": pp32.eval_batch(images), "labels": labels, "valid": valid}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = float(step1f(tr1f, fr1, batch1f))
    torch.cuda.synchronize()
    say(f"  fp32 stage-1 live step: {1e3 * (time.perf_counter() - t0):.1f} ms (first fp32 "
        f"step), loss {loss:.4f}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB")
    del tr1f, step1f, batch1f

    # fp32 stage-2 loss and gradients: kernels against the plain path
    imgs32 = pp32.train_batch(images, draws)
    res = {}
    for impl in ("auto", "plain"):
        with kernel_impl(impl):
            trc = TR._trainable_copy(O.partition(params, lambda p: M.stage2_trainable(p, mcfg))[0])
            loss, _ = TR.stage2_loss(mcfg, tcfg, O.combine(trc, frozen2), imgs32, labels, text,
                                     valid)
            named = [(p, t) for p, t in O.paths(trc) if t is not None]
            grads = torch.autograd.grad(loss, [t for _, t in named])
            res[impl] = (float(loss.detach()), [p for p, _ in named], grads)
        del trc
    lk, paths_, gk = res["auto"]
    lp, _, gp = res["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    worst, worst_path = 0.0, None
    for path, a, b in zip(paths_, gk, gp):
        _, rel = rel_err(a, b)
        if rel > worst:
            worst, worst_path = rel, "/".join(path)
    ok = loss_rel <= 1e-5 and worst <= 1e-3
    say(f"  fp32 stage-2 loss through the kernels {lk:.6f} vs plain {lp:.6f} (rel "
        f"{loss_rel:.2e}, tol 1e-5); gradients of {len(paths_)} leaves, worst rel {worst:.2e} "
        f"at {worst_path} (tol 1e-3 of each leaf's max|grad|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("the fp32 stage-2 step through the kernels disagrees with the plain one")
    del res, gk, gp
    torch.cuda.empty_cache()
    # beside the kernels' counters, the block backward's (no kernel record of
    # their own): the blocks whose backward ran on the kernels, their
    # recompute and dgrad products (the wgrads run only where weights train:
    # not in stage 1)
    counters32 = dict(fp32_counters(), fused_block_backward=FA.fused_block_backward,
                      gemm_product=FA.gemm_product, gemm_dgrad=FA.gemm_dgrad)
    report.update(fp32_steps(dev, counters32, mcfg, params, images, labels, valid, text, draws,
                             bs))
    report["fp32 cached coop stage 1"] = dict(launches=coop_stage1_fp32_launches(
        dev, counters32, bs))
    return report


def fp32_counters():
    """The fp32 records' names -> their wrappers' launch counters. The fp32
    steps, zeroed just before, launch the wrappers in fp32 only (their
    traces show no bf16 block kernel), so the counters read fp32 launches."""
    from tpu_reid_torch.ops import attention as TA
    from tpu_reid_torch.ops import fused_attention as FA
    from tpu_reid_torch.ops import fused_tail as FT

    return {"ln_gemm_fp32": FA.ln_gemm, "mha_core_fp32": TA.mha_core,
            "gemm_bias_residual_fp32": FA.gemm_bias_residual,
            "ln_proj_tail_fp32": FT.ln_proj_tail_kernel,
            "mha_core_backward_fp32": TA.mha_core_backward}


# ---------------------------------------------------------------------------
# phase 9: the vehicle geometry (256x256, stride 12: 442 tokens, 444 with
# IVLP's prompts), where mha_core runs its key-tile kernel
# ---------------------------------------------------------------------------

VERI_TYPES = ("sedan", "suv", "van", "hatchback", "mpv", "pickup", "bus", "truck", "estate")


def write_veri_dir(root, n_ids=32, n_query=2, n_gallery=8, n_train=8, hw=(256, 256), seed=3,
                   mix=0.45):
    """A VeRi-776-layout directory of JPEGs of size hw: image_train /
    image_query / image_test with `{pid:04d}_c{cam:03d}_{frame:08d}_0.jpg`
    names, keypoint viewpoint files, gb2312 label XMLs with a car type per
    image, and list_type.txt. A blocky base image per identity plus noise;
    n_ids test identities (queries on camera 1, gallery on cameras 2-6) and
    n_ids other training identities of n_train images each. Returns the
    numbers of query and gallery images."""
    from PIL import Image

    base_dir = os.path.join(root, "VeRi")
    for sub in ("image_train", "image_query", "image_test"):
        os.makedirs(os.path.join(base_dir, sub))
    rng = np.random.default_rng(seed)
    h, w = hw
    base = rng.uniform(0, 255, (2 * n_ids, h // 16, w // 16, 3))
    base = base.repeat(16, axis=1).repeat(16, axis=2)  # blocky; hw multiples of 16
    car_type = 1 + rng.integers(0, len(VERI_TYPES), 2 * n_ids)
    keypoints, labels = {"train": [], "test": []}, {"train": [], "test": []}
    for pid in range(2 * n_ids):
        test = pid < n_ids
        for k in range(n_query + n_gallery if test else n_train):
            noise = rng.uniform(0, 255, (h, w, 3))
            img = np.clip(mix * base[pid] + (1 - mix) * noise, 0, 255).astype(np.uint8)
            if test:
                sub, cam = ("image_query", 1) if k < n_query else ("image_test", 2 + k % 5)
            else:
                sub, cam = "image_train", 1 + k % 20
            name = f"{pid + 1:04d}_c{cam:03d}_{k:08d}_0.jpg"
            Image.fromarray(img).save(os.path.join(base_dir, sub, name), quality=90)
            split = "test" if test else "train"
            keypoints[split].append(f"{sub}/{name} {int(rng.integers(0, 8))}")
            labels[split].append((name, int(car_type[pid])))
    for split in ("train", "test"):
        with open(os.path.join(base_dir, f"keypoint_{split}.txt"), "w") as f:
            f.write("\n".join(keypoints[split]) + "\n")
        items = "\n".join(
            f'  <Item imageName="{name}" vehicleID="{name[:4]}" cameraID="{name[5:9]}" '
            f'colorID="1" typeID="{tid}"/>' for name, tid in labels[split])
        xml = ('<?xml version="1.0" encoding="gb2312"?>\n<TrainingImages>\n'
               f"<Items>\n{items}\n</Items>\n</TrainingImages>\n")
        with open(os.path.join(base_dir, f"{split}_label.xml"), "wb") as f:
            f.write(xml.encode("gb2312"))
    with open(os.path.join(base_dir, "list_type.txt"), "w") as f:
        for i, t in enumerate(VERI_TYPES, start=1):
            f.write(f"{i} {t}\n")
    return n_ids * n_query, n_ids * n_gallery


def long_sequence_checks(dev, b=128, d=768, hid=3072, heads=12):
    """mha_core beyond 256 tokens against mha_core_reference (8 and 12 heads,
    views of a packed qkv buffer and contiguous tensors, exact and fast,
    with an additive mask and without, bf16 and fp32), 50 launches
    bit-equal, whole blocks at 442 and 444 tokens with the splice; then the
    kernel timed at the vehicle geometry (B=128, S=442, 12 heads, bf16)
    beside SDPA. Returns the kernels-line record of the key-tile kernel."""
    from tpu_reid_torch.ops import attention as TA
    from tpu_reid_torch.ops import fused_attention as FA

    rng = np.random.default_rng(17)
    bf = torch.bfloat16
    failures = []

    def t(*shape, std=1.0, dt=bf):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * std).to(dev, dt)

    def check(label, got, want, dtype, quiet=False):
        err, rel = rel_err(got, want)
        ok = rel <= TOL[dtype]
        if not ok or not quiet:
            say(f"  {label}: max|d| {err:.3e}, rel {rel:.3e} (tol {TOL[dtype]:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
        return rel

    say("mha_core beyond 256 tokens (the key-tile kernels) against mha_core_reference")
    for dt in (bf, torch.float32):
        for s in (257, 300, 442, 444):
            # an additive mask with -inf entries off the diagonal: every row keeps a key
            m = rng.standard_normal((s, s)).astype(np.float32)
            m[rng.random((s, s)) < 0.3] = -np.inf
            m[np.arange(s), np.arange(s)] = 0.0
            mask = torch.from_numpy(m).to(dev)
            worst, n = 0.0, 0
            for bb, hh in ((3, 8), (16, 12)):
                qkv = t(bb, s, 3 * hh * 64, dt=dt)
                views = FA._qkv_views(qkv, hh)
                contiguous = tuple(v.contiguous() for v in views)
                for mk in (None, mask):
                    for fast in (False, True):
                        for label, ops in (("qkv views", views), ("contiguous", contiguous)):
                            worst = max(worst, check(
                                f"mha_core[{str(dt)[6:]} B={bb} S={s} H={hh}"
                                f"{' masked' if mk is not None else ''} {label} "
                                f"{'fast' if fast else 'exact'}]",
                                TA.mha_core(*ops, mk, fast=fast),
                                TA.mha_core_reference(*ops, mk, fast=fast), dt, quiet=True))
                            n += 1
            say(f"  mha_core {str(dt)[6:]} S={s}: {n} cases (B=3 H=8 and B=16 H=12, masked and "
                f"not, exact and fast, qkv views and contiguous), worst rel {worst:.3e} "
                f"(tol {TOL[dt]:.0e})")

    s = 442
    qkv = t(b, s, 3 * d)
    views = FA._qkv_views(qkv, heads)
    for label, fn in (("exact", lambda: TA.mha_core(*views)),
                      ("fast", lambda: TA.mha_core(*views, fast=True))):
        first = fn()
        same = all(torch.equal(first, fn()) for _ in range(49))
        say(f"  mha_core {label} at B={b} S={s}: 50 launches on one input "
            f"{'bit-equal' if same else 'DIFFER'}")
        if not same:
            failures.append(f"mha_core long {label} repeat")

    say("whole blocks at the vehicle geometry: fused_block (kernels) against "
        "fused_block_reference")
    for dt in (bf, torch.float32):
        for seq, splice in ((442, False), (444, True)):
            for fast in (False, True):
                pb = block_params(rng, d, hid, dt, dev)
                xb = t(32, seq, d, dt=dt)
                kw = {}
                if splice:  # the 2 IVLP prompt rows at the end of the sequence
                    pm = torch.zeros(seq, 1, device=dev)
                    pm[seq - 2:] = 1.0
                    kw = dict(prompt_plane=t(seq, d, dt=dt), prompt_mask=pm)
                check(f"vision block B=32 S={seq} {str(dt)[6:]} {'fast' if fast else 'exact'}"
                      f"{' splice' if splice else ''}",
                      FA.fused_block(xb, **pb, n_heads=heads, fast=fast, **kw),
                      FA.fused_block_reference(xb, **pb, n_heads=heads, fast=fast, **kw), dt)
                del pb, xb

    # timed at the vehicle geometry, beside SDPA (timed only, never called by
    # the port); bound as in the kernel phase: q, k, v read once and the heads
    # written once, 4 B H S^2 64 operations
    q, kk, v = (x.transpose(1, 2).contiguous() for x in views)
    err, _ = rel_err(TA.mha_core(*views), TA.mha_core_reference(*views))
    flops, nbytes = 4.0 * b * heads * s * s * 64, 2.0 * (b * s * 3 * d + b * s * d)
    bnd, by = bound(flops, nbytes)
    k_ms = time_ms(lambda: TA.mha_core(*views))
    l_ms = time_ms(lambda: F.scaled_dot_product_attention(q, kk, v))
    f_ms = time_ms(lambda: TA.mha_core(*views, fast=True))
    k2_ms = time_ms(lambda: TA.mha_core(*views))
    p_ms = time_ms(lambda: TA.mha_core_reference(*views), reps=5, warmup=1)
    say(f"mha_core alone at B={b} S={s} H={heads} bf16 (median of 20 CUDA-event runs): exact "
        f"{k_ms:.4f} / {k2_ms:.4f} ms, fast {f_ms:.4f} ms, plain {p_ms:.4f} ms, library (SDPA) "
        f"{l_ms:.4f} ms, bound {bnd:.4f} ms ({by}); {flops / k_ms / 1e9:.1f} TFLOP/s, "
        f"{k_ms / l_ms:.2f}x SDPA")
    torch.cuda.synchronize()
    if failures:
        raise PhaseFailed(f"mha_core beyond 256 tokens disagrees with its plain version: "
                          f"{failures}")
    return dict(name="mha_core_long", route="cuda",
                source="tpu_reid_torch/csrc/block_kernels.cu",
                replaces="tpu_reid/ops/attention.py:37", max_abs_err=err, ms=min(k_ms, k2_ms),
                fast_ms=f_ms, plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=l_ms)


def vehicle_cli_phase(counters):
    """Both CLIs at the vehicle geometry (--height 256 --ratio 1.0 --stride
    12) on a synthetic VeRi directory and a random ViT-B/16 checkpoint;
    returns each run's launches."""
    import tempfile

    from tpu_reid_torch.cli import prompt_learning as pl_cli
    from tpu_reid_torch.cli import zero_shot as cli
    from tpu_reid_torch.models.tokenizer import write_test_merges
    from tpu_reid_torch.weights.convert import random_clip_state_dict

    runs = {}
    geometry = ["--height", "256", "--ratio", "1.0", "--stride", "12"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        nq, ng = write_veri_dir(tmp, n_ids=16, mix=0.2)
        ckpt = os.path.join(tmp, "vit_b16_random.pth")
        torch.save({k: torch.from_numpy(v) for k, v in random_clip_state_dict(0).items()}, ckpt)
        merges = os.path.join(tmp, "merges.txt")
        write_test_merges(merges, [("c", "a"), ("ca", "r</w>"), ("v", "a"), ("va", "n</w>")])
        common = ["--root", tmp, "--model_path", ckpt, "--bpe_path", merges, *geometry]
        argv = [*common, "--rerank", "--mm", "--bs", "64", "--test_dataset", "veri"]
        say(f"vehicle CLIs: a VeRi directory of {nq} query + {ng} gallery + 128 training "
            f"256x256 JPEGs (16 + 16 identities) and a random ViT-B/16 checkpoint written in "
            f"{time.perf_counter() - t0:.1f} s; running python -m tpu_reid_torch.cli.zero_shot "
            + " ".join(argv[6:]))
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        cmc, mAP = cli.main(argv)
        torch.cuda.synchronize()
        launches = runs["vehicle_zero_shot_cli"] = {n: c.launches for n, c in counters.items()}
        say(f"  CLI run {time.perf_counter() - t0:.1f} s: Rank-1 {cmc[0]:.4f}, mAP {mAP:.4f}; "
            f"launches {launches}")
        missing = [n for n, c in launches.items() if c == 0]
        if missing:
            raise PhaseFailed(f"the zero-shot CLI at 256x256 never launched {missing}")
        if len(cmc) != min(50, ng) or not np.isfinite(cmc).all() or not 0.0 < mAP <= 1.0:
            raise PhaseFailed(f"vehicle CLI result out of range: cmc {len(cmc)} entries, "
                              f"mAP {mAP}")

        argv = [*common, "--training_mode", "ivlp", "--epochs_stage1", "1",
                "--epochs_stage2", "1", "--dtype", "bf16", "--bs", "32",
                "--train_dataset", "veri", "--save_path", os.path.join(tmp, "checkpoints")]
        say("prompt-learning CLI at the vehicle geometry: python -m "
            "tpu_reid_torch.cli.prompt_learning " + " ".join(argv[6:]))
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        cmc, mAP = pl_cli.main(argv)
        torch.cuda.synchronize()
        launches = runs["vehicle_prompt_cli"] = {n: c.launches for n, c in counters.items()}
        saved = sorted(os.listdir(os.path.join(tmp, "checkpoints", "ivlp", "veri")))
    say(f"  prompt-learning CLI run {time.perf_counter() - t0:.1f} s: Rank-1 {cmc[0]:.4f}, mAP "
        f"{mAP:.4f}; saved {saved}; launches {launches}")
    missing = [n for n, c in launches.items() if c == 0 and n != "minsum"]
    if missing:
        raise PhaseFailed(f"the prompt-learning CLI at 256x256 never launched {missing}")
    if "2.pt" not in saved or not np.isfinite(cmc).all() or not 0.0 < mAP <= 1.0:
        raise PhaseFailed(f"vehicle prompt-learning CLI result out of range: saved {saved}, "
                          f"mAP {mAP}")
    return runs


# ---------------------------------------------------------------------------
# phase 12: multitask hard_ivlp (person 256x128 + vehicle 256x256) at full
# ViT-B/16 width: training steps, a stage-2 resume through files, the CLI
# ---------------------------------------------------------------------------

MT_CLASSES = (751, 576)  # Market-1501's and VeRi-776's training identities


def eva02_model(dev, image_hw=(256, 256), n_cls=576, seed=0):
    """EVA02-CLIP-L/14 as the IVLP ReID tower (configs.eva02_l14_reid: 1024 x
    24, 16 heads, SwiGLU 2730 stored as 2752; prompt depth 24 with 2 tokens;
    327 tokens at 256x256), random bf16 weights drawn on the card from a
    seed in EVA-CLIP's layout, converted by weights.convert.eva02_visual_params."""
    from tpu_reid_torch.configs import PromptDesign, eva02_l14_reid
    from tpu_reid_torch.models import prompts as P
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.weights.convert import eva02_visual_params

    design = PromptDesign(trainer="IVLP", vision_depth=24, vision_ctx=2, language_depth=24,
                          language_ctx=2)
    clip = eva02_l14_reid(image_hw, design)
    v = clip.vision
    mcfg = M.ReidModelConfig(mode="ivlp", clip=clip,
                             prompt=P.PromptLearnerConfig(n_cls, n_prefix=5, n_cls_ctx=4))
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, d, f, f32 = v.layers, v.width, v.hidden, torch.float32

    def t(*shape, std, mean=0.0, dtype=torch.bfloat16):
        return (mean + std * torch.randn(*shape, generator=gen, device=dev)).to(dtype)

    def ln(*lead):
        return {"scale": t(*lead, std=0.05, mean=1.0, dtype=f32),
                "bias": t(*lead, std=0.05, dtype=f32)}

    nat = {"conv": {"w": t(14, 14, 3, d, std=(3 * 196) ** -0.5), "b": t(d, std=0.02)},
           "class_embedding": t(d, std=d ** -0.5),
           "positional_embedding": t(1 + v.h_grid * v.w_grid, d, std=0.01),
           "blocks": {"ln_1": ln(n, d), "ln_2": ln(n, d),
                      "attn": {"qkv": {"w": t(n, d, 3 * d, std=d ** -0.5)},
                               "q_bias": t(n, d, std=0.01), "v_bias": t(n, d, std=0.01),
                               "inner_ln": ln(n, d),
                               "proj": {"w": t(n, d, d, std=d ** -0.5 / 2),
                                        "b": t(n, d, std=0.01)}},
                      "mlp": {"w1": {"w": t(n, d, f, std=d ** -0.5), "b": t(n, f, std=0.01)},
                              "w2": {"w": t(n, d, f, std=d ** -0.5), "b": t(n, f, std=0.01)},
                              "ffn_ln": ln(n, f),
                              "w3": {"w": t(n, f, d, std=f ** -0.5 / 4),
                                     "b": t(n, d, std=0.01)}}},
           "ln_post": ln(d), "head": {"w": t(d, 768, std=d ** -0.5), "b": t(768, std=0.01)},
           "vpt_shallow": t(2, d, std=0.02), "vpt_deep": t(n, 2, d, std=0.02)}
    return mcfg, {"clip": {"visual": eva02_visual_params(nat)}}


def one_rounding(got, want) -> float:
    """The largest |got - want| over 2^-7 |want| + 2^-9 max|want|: a kernel
    and its plain version round the same fp32 value, summed in another
    order, to bf16, so they may land one bf16 step apart (an 8-bit
    significand), and cancellation leaves values near zero. Above 1: off by
    more than a rounding."""
    g, w = got.detach().float(), want.detach().float()
    if not torch.isfinite(g).all():
        return float("inf")
    return float(((g - w).abs() / (2.0 ** -7 * w.abs() + 2.0 ** -9 * w.abs().max())).max())


def eva02_mode_checks(dev, b=256):
    """Each EVA02 mode of the block kernels against its plain version at the
    eva-veri.embed cell's shapes (B 256, S 327, D 1024, F 2730 stored as
    2752), within one bf16 rounding: ln_rows as LN_1 with the deep-prompt
    splice and as the sub-LN over the padded hidden width (statistics of
    the 2730 real columns), ln_gemm with RoPE (CLS, prompt rows and v left
    as the unrotated product gives them) and with SwiGLU (the padded columns
    zero), gemm_bias_residual with the sub-LN prologue, the residual and the
    splice. Returns {mode: worst ratio to the bound}."""
    from tpu_reid_torch.configs import PromptDesign, eva02_l14_reid
    from tpu_reid_torch.models.vit import rope_table
    from tpu_reid_torch.ops import fused_attention as FA
    from tpu_reid_torch.ops.fused_eva import padded_hidden
    from tpu_reid_torch.weights.convert import pack_swiglu

    design = PromptDesign(trainer="IVLP", vision_depth=24, vision_ctx=2, language_depth=24,
                          language_ctx=2)
    v = eva02_l14_reid((256, 256), design).vision
    s, d, f = v.seq_len, v.width, v.hidden
    fp = padded_hidden(f)
    gen = torch.Generator(device=dev).manual_seed(21)

    def t(*shape, std=1.0, mean=0.0, dtype=torch.bfloat16):
        return (mean + std * torch.randn(*shape, generator=gen, device=dev)).to(dtype)

    def gamma(k):
        return t(k, std=0.1, mean=1.0, dtype=torch.float32), t(k, std=0.1, dtype=torch.float32)

    eps, worst = v.ln_eps, {}
    plane, pmask = t(s, d), torch.zeros(s, 1, device=dev)
    pmask[s - 2:] = 1.0
    rope = rope_table(v, dev)
    with torch.no_grad():
        x = t(b, s, d)
        g, gb = gamma(d)
        h = FA.ln_rows(x, g, gb, d, eps, plane, pmask)
        worst["ln_rows (LN_1, splice)"] = one_rounding(
            h, FA.ln_rows_reference(x, g, gb, d, eps, plane, pmask))
        w, bias = t(d, 3 * d, std=d ** -0.5), t(3 * d, std=0.02)
        kw = dict(rope=rope, rope_cols=2 * d)
        got = FA.ln_gemm(h, None, None, w, bias, **kw)
        worst["ln_gemm rope"] = one_rounding(got, FA.ln_gemm_reference(h, None, None, w, bias,
                                                                       **kw))
        unrotated = FA.ln_gemm(h, None, None, w, bias)
        keep = torch.zeros(s, dtype=torch.bool, device=dev)
        keep[0] = keep[s - 2:] = True
        if not (torch.equal(got[:, keep], unrotated[:, keep])
                and torch.equal(got[..., 2 * d:], unrotated[..., 2 * d:])):
            raise PhaseFailed("eva02: the rope mode rotated CLS, a prompt row or v")
        del got, unrotated, w, bias
        w = pack_swiglu(t(d, f, std=d ** -0.5), t(d, f, std=d ** -0.5), fp)
        bias = pack_swiglu(t(f, std=0.02), t(f, std=0.02), fp)
        u = FA.ln_gemm(h, None, None, w, bias, swiglu=True)
        worst["ln_gemm swiglu"] = one_rounding(
            u, FA.ln_gemm_reference(h, None, None, w, bias, swiglu=True))
        if u.shape != (b, s, fp) or u[..., f:].any():
            raise PhaseFailed("eva02: the swiglu mode's padded columns are not zero")
        del w, bias, h
        g, gb = t(fp, std=0.1, mean=1.0, dtype=torch.float32), t(fp, std=0.1,
                                                                  dtype=torch.float32)
        g[f:] = 0
        gb[f:] = 0
        hn = FA.ln_rows(u, g, gb, f, eps)
        worst["ln_rows (sub-LN over F)"] = one_rounding(hn, FA.ln_rows_reference(u, g, gb, f, eps))
        if hn[..., f:].any():
            raise PhaseFailed("eva02: the sub-LN's padded columns are not zero")
        del u, hn
        a, w, bias = t(b, s, d), t(d, d, std=d ** -0.5), t(d, std=0.02)
        g, gb = gamma(d)
        kw = dict(ln_scale=g, ln_bias=gb, eps=eps)
        worst["gemm_bias_residual ln_residual"] = one_rounding(
            FA.gemm_bias_residual(a, w, bias, x, plane, pmask, **kw),
            FA.gemm_bias_residual_reference(a, w, bias, x, plane, pmask, **kw))
    for mode, r in worst.items():
        say(f"  eva02 {mode} at B {b}, S {s}: worst |d| / one bf16 rounding {r:.3f} "
            f"{'ok' if r <= 1 else 'FAIL'}")
    bad = [m for m, r in worst.items() if not r <= 1]
    if bad:
        raise PhaseFailed(f"eva02: {bad} off their plain versions by more than a rounding")
    return worst


def eva02_phase(dev, k_batches=4, batch=256):
    """EVA02-CLIP-L/14 on the eva-veri.embed cell's path: the mode checks,
    then eval_embed through the extractor (batch 256, bf16, fast softmax,
    the input normalisation folded in, flip-TTA) over k_batches batches:
    emb/s and the counters (every full block on the kernels: 23 a pass,
    none plain; three ln_rows a block; the key-tile attention); one batch
    again with every EVA02 block and the tail held against their plain
    versions on the run's own inputs, its embeddings against the plain bf16
    tower and the folded bf16 rows against the program's fp32 tower on
    normalised images; an fp32 pass, whose blocks take the plain path and
    are counted there."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.ops._build import kernel_impl
    from tpu_reid_torch.ops import attention as TA
    from tpu_reid_torch.ops import fused_attention as FA
    from tpu_reid_torch.ops import fused_eva as FE
    from tpu_reid_torch.ops import fused_tail as FT
    from tpu_reid_torch.ops.attention import set_fast_softmax
    from tpu_reid_torch.parallel.extract import make_extractor

    worst = eva02_mode_checks(dev, batch)
    torch.cuda.empty_cache()
    mcfg, params = eva02_model(dev)
    bf, hw = torch.bfloat16, (256, 256)
    blocks = mcfg.clip.vision.layers - 1
    counters = {"fused_eva_block": FE.fused_eva_block, "ln_rows": FA.ln_rows,
                "ln_gemm": FA.ln_gemm, "gemm_bias_residual": FA.gemm_bias_residual,
                "mha_core": TA.mha_core, "mha_core_long": TA.mha_core_long,
                "ln_proj_tail": FT.ln_proj_tail_kernel}
    fold = lambda p: M.fold_input_norm(p, mcfg, "vit")  # noqa: E731
    embed = lambda p, im: M.eval_embed(p, mcfg, im)  # noqa: E731
    ext = make_extractor(embed, DevicePreprocess(hw, "vit", dtype=bf), flip_tta=True, dtype=bf,
                         fold=fold, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randint(0, 255, (k_batches, batch, *hw, 3), dtype=torch.uint8, device=dev,
                           generator=gen)
    set_fast_softmax(True)
    try:
        ext(params, images[0])  # warm-up
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        FE.fused_eva_block.plain = 0
        t0 = time.perf_counter()
        outs = [ext(params, images[k]) for k in range(k_batches)]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
        plain = FE.fused_eva_block.plain
        emb_s = k_batches * batch / sec
        say(f"EVA02-CLIP-L/14 serving (eval_embed, 256x256, {mcfg.clip.vision.seq_len} tokens, "
            f"batch {batch}, bf16, fast softmax, folded input norm, flip-TTA): {k_batches} "
            f"batches in {sec:.3f} s, {emb_s:.1f} emb/s")
        say(f"  launches in the run: {launches}, fused_eva_block.plain {plain}")
        passes = 2 * k_batches
        want_counts = {"fused_eva_block": blocks * passes, "ln_rows": 3 * blocks * passes,
                       "ln_gemm": 2 * blocks * passes, "gemm_bias_residual": 2 * blocks * passes,
                       "mha_core": blocks * passes, "mha_core_long": blocks * passes,
                       "ln_proj_tail": passes}
        if launches != want_counts or plain:
            raise PhaseFailed(f"eva02: launches {launches} and {plain} plain blocks, expected "
                              f"{want_counts} and none plain")
        errs = {"fused_eva_block": [], "ln_proj_tail": []}
        x = images[0]
        with held_against_plain(FE, "fused_eva_block", FE.eva_block_reference,
                                errs["fused_eva_block"]), \
                held_against_plain(FT, "ln_proj_tail_kernel", FT.ln_proj_tail_reference,
                                   errs["ln_proj_tail"]):
            ek = ext(params, x)
        with kernel_impl("plain"):
            ep = ext(params, x)
    finally:
        set_fast_softmax(False)
    tol = TOL[bf]
    for name, es in errs.items():
        w = max((rel for _, rel in es), default=float("inf"))
        say(f"  eva02 {name}, {len(es)} outputs of one batch, each against its plain version "
            f"on the run's own inputs: worst rel {w:.3e} (tol {tol:.0e}) "
            f"{'ok' if w <= tol else 'FAIL'}")
        if not es or w > tol:
            raise PhaseFailed(f"eva02: {name} disagrees with its plain version")
    same = rel_err(ek, outs[0])[1]
    rows = lambda a, b: (a.float() - b.float()).norm(dim=1) / b.float().norm(dim=1)  # noqa: E731
    gap = float(rows(ek, ep).max())
    say(f"  the held rows against the same rows of the timed run: rel {same:.3e}; kernels "
        f"against the plain bf16 tower: worst row {gap:.4f} (tol 3e-2: the plain tower rounds "
        f"elsewhere, 24 blocks deep) {'ok' if gap < 3e-2 else 'FAIL'}")
    if same > 1e-3 or gap >= 3e-2:
        raise PhaseFailed("eva02: the held run differs from the timed run or the plain tower")
    bad = [tuple(o.shape) for o in outs if o.shape != (batch, 1024 + 768)
           or not torch.isfinite(o).all()]
    if bad:
        raise PhaseFailed(f"eva02: embeddings not finite / of the expected shape: {bad[:3]}")
    del outs, ek, ep
    torch.cuda.empty_cache()

    # the folded bf16 rows against the program's fp32 tower on normalised
    # images (TF32 off), and that fp32 pass's blocks on the plain path
    x = images[0, :32]
    set_fast_softmax(True)
    try:
        eb = ext(params, x)
    finally:
        set_fast_softmax(False)
    p32 = _cast(params, torch.float32)
    ext32 = make_extractor(embed, DevicePreprocess(hw, "vit"), flip_tta=True,
                           dtype=torch.float32, device=dev)
    FE.fused_eva_block.plain = 0
    e32 = ext32(p32, x)
    plain32 = FE.fused_eva_block.plain
    gap32 = rows(eb, e32)
    say(f"  folded bf16 rows (32 images, flip-TTA) against the fp32 tower: worst "
        f"{float(gap32.max()):.4f}, median {float(gap32.median()):.4f} (tol 3e-2: bf16 "
        f"rounding through 24 blocks; a stem that rounds the raw images' mean into its "
        f"output and bias reads ~6%); fp32 blocks on the plain path: {plain32} (expected "
        f"{2 * blocks})")
    if float(gap32.max()) >= 3e-2 or plain32 != 2 * blocks:
        raise PhaseFailed("eva02: the bf16 tower strays from fp32, or fp32 blocks were not "
                          "counted plain")
    numbers = {"emb_s": emb_s, "modes": worst, "bf16_vs_fp32_worst": float(gap32.max())}
    return launches, numbers


EVAE_SHAPES = dict(s=165, d=1792, heads=16, dh=112, f=15360)  # the evae-market.embed cell's


def evae_model(dev, seed=10, n_cls=751):
    """EVA02-CLIP-E/14 as the IVLP ReID tower at the evae-market.embed cell's
    geometry (configs.eva02_e14_reid: 1792 x 64, 16 heads of 112, an
    exact-GELU MLP of 15360, post-norm; prompt depth 64 with 2 tokens; 165
    tokens at 256x128), random bf16 weights drawn on the card from a seed in
    EVA-CLIP's layout, converted by weights.convert.eva_e_params. The
    post-norm gains are drawn near 0.1, as the benchmark's stand-in draws
    them: at 1 the residual stream, which no LayerNorm precedes into q and k,
    saturates every softmax."""
    from tpu_reid_torch.configs import PromptDesign, eva02_e14_reid
    from tpu_reid_torch.models import prompts as P
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.weights.convert import eva_e_params

    design = PromptDesign(trainer="IVLP", vision_depth=64, vision_ctx=2, language_depth=64,
                          language_ctx=2)
    clip = eva02_e14_reid((256, 128), design)
    v = clip.vision
    mcfg = M.ReidModelConfig(mode="ivlp", clip=clip,
                             prompt=P.PromptLearnerConfig(n_cls, n_prefix=5, n_cls_ctx=4))
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, d, f = v.layers, v.width, v.hidden

    def t(*shape, std=1.0, mean=0.0, dtype=torch.bfloat16):
        return (mean + std * torch.randn(*shape, generator=gen, device=dev)).to(dtype)

    def ln(*lead, mean=1.0):
        return {"scale": t(*lead, std=0.01, mean=mean, dtype=torch.float32),
                "bias": t(*lead, std=0.02, dtype=torch.float32)}

    nat = {"conv": {"w": t(14, 14, 3, d, std=(3 * 196) ** -0.5), "b": t(d, std=0.02)},
           "class_embedding": t(d, std=d ** -0.5),
           "positional_embedding": t(1 + v.h_grid * v.w_grid, d, std=0.02),
           "blocks": {"norm1": ln(n, d, mean=0.1), "norm2": ln(n, d, mean=0.1),
                      "attn": {"qkv": {"w": t(n, d, 3 * d, std=d ** -0.5)},
                               "q_bias": t(n, d, std=0.02), "v_bias": t(n, d, std=0.02),
                               "proj": {"w": t(n, d, d, std=d ** -0.5), "b": t(n, d, std=0.02)}},
                      "mlp": {"fc1": {"w": t(n, d, f, std=d ** -0.5), "b": t(n, f, std=0.02)},
                              "fc2": {"w": t(n, f, d, std=f ** -0.5), "b": t(n, d, std=0.02)}}},
           "norm": ln(d), "head": {"w": t(d, 1024, std=d ** -0.5), "b": t(1024, std=0.02)},
           "vpt_shallow": t(2, d, std=0.02), "vpt_deep": t(n, 2, d, std=0.02)}
    params = {"clip": {"visual": eva_e_params(nat)}}
    del nat
    torch.cuda.empty_cache()
    return mcfg, params


def evae_mode_checks(dev, b=256):
    """Each launch of EVA02-CLIP-E/14's post-norm block against its plain
    version (the wrapper's `_reference`, which rounds where the kernel does)
    at the evae-market.embed cell's shapes (B 256, S 165, D 1792, 16 heads of
    112, F 15360), within one bf16 rounding (`one_rounding`): the qkv product
    without LayerNorm; mha_core on heads of 112 from the qkv buffer's strided
    views, exact and fast; the out-projection; ln_residual, plain and with
    the next block's prompt rows spliced on store; fc1 with the exact GELU
    (QuickGELU's curve must miss the bound: the bound tells the two apart);
    fc2 over K 15360; the CLS tail at D 1792 (bf16: the wgmma kernel; fp32:
    the FMA kernel, within 1e-5 relative). The whole seven-launch block
    within 4e-3 relative L2 (seven roundings chained through two
    LayerNorms). Then each launch timed by CUDA-graph replay (`graph_ms`)
    beside what bounds it, and mha_core at heads of 112 on key tiles (S 259:
    EVA-CLIP's own 224 x 224 input) beside SDPA. Returns ({check: worst ratio
    to its bound}, [timing lines])."""
    from tpu_reid_torch.ops import attention as TA
    from tpu_reid_torch.ops import fused_attention as FA
    from tpu_reid_torch.ops import fused_eva_e as FEE
    from tpu_reid_torch.ops import fused_tail as FT

    s, d, h, dh, f = (EVAE_SHAPES[k] for k in ("s", "d", "heads", "dh", "f"))
    m, eps = b * s, 1e-6
    gen = torch.Generator(device=dev).manual_seed(31)

    def t(*shape, std=1.0, mean=0.0, dtype=torch.bfloat16):
        return (mean + std * torch.randn(*shape, generator=gen, device=dev)).to(dtype)

    x = t(b, s, d)
    w_qkv, b_qkv = t(d, 3 * d, std=d ** -0.5), t(3 * d, std=0.02)
    b_qkv[d:2 * d] = 0
    w_o, b_o = t(d, d, std=d ** -0.5), t(d, std=0.02)
    w_1, b_1 = t(d, f, std=d ** -0.5), t(f, std=0.02)
    w_2, b_2 = t(f, d, std=f ** -0.5), t(d, std=0.02)
    ln = [t(d, std=0.01, mean=0.1, dtype=torch.float32), t(d, std=0.02, dtype=torch.float32)]
    weights = [w_qkv, b_qkv, w_o, b_o, *ln, w_1, b_1, w_2, b_2, *ln]
    plane, pmask = t(s, d), torch.zeros(s, 1, device=dev)
    pmask[s - 2:] = 1.0
    worst = {}
    with torch.no_grad():
        qkv = FA.ln_gemm(x, None, None, w_qkv, b_qkv)
        worst["qkv"] = one_rounding(qkv, FA.ln_gemm_reference(x, None, None, w_qkv, b_qkv))
        for fast in (False, True):
            n0 = TA.mha_core_wide.launches
            a = FA._attention_kernel(qkv, h, None, fast)
            if TA.mha_core_wide.launches != n0 + 1:
                raise PhaseFailed("evae: mha_core on heads of 112 was not counted as such")
            worst[f"mha_core dh112 fast{int(fast)}"] = one_rounding(
                a, FA.attention_reference(qkv, h, None, fast))
        y = FA.ln_gemm(a, None, None, w_o, b_o)
        worst["out_proj"] = one_rounding(y, FA.ln_gemm_reference(a, None, None, w_o, b_o))
        x1 = FA.ln_residual(y, x, *ln, eps)
        worst["ln_residual"] = one_rounding(x1, FA.ln_residual_reference(y, x, *ln, eps))
        spliced = FA.ln_residual(y, x, *ln, eps, plane, pmask)
        worst["ln_residual splice"] = one_rounding(
            spliced, FA.ln_residual_reference(y, x, *ln, eps, plane, pmask))
        if not torch.equal(spliced[:, s - 2:], plane[s - 2:].expand(b, 2, d)):
            raise PhaseFailed("evae: ln_residual did not store the prompt rows in place")
        del spliced, y
        hid = FA.ln_gemm(x1, None, None, w_1, b_1, gelu_erf=True)
        want = FA.ln_gemm_reference(x1, None, None, w_1, b_1, gelu_erf=True)
        worst["fc1 gelu_erf"] = one_rounding(hid, want)
        quick = one_rounding(FA.ln_gemm_reference(x1, None, None, w_1, b_1, gelu=True), want)
        if not quick > 1:
            raise PhaseFailed(f"evae: QuickGELU lies within one rounding of the exact GELU "
                              f"({quick:.3f}): the bound cannot tell them apart")
        del want
        torch.cuda.empty_cache()
        worst["fc2"] = one_rounding(FA.ln_gemm(hid, None, None, w_2, b_2),
                                    FA.ln_gemm_reference(hid, None, None, w_2, b_2))
        del hid
        torch.cuda.empty_cache()
        got = FEE.fused_eva_e_block(x, weights, h, eps, plane, pmask, fast=True)
        want = FEE.eva_e_block_reference(x, weights, h, eps, plane, pmask, fast=True)
        block_gap = float((got.float() - want.float()).norm() / want.float().norm())
        del got, want
        torch.cuda.empty_cache()
        # the CLS tail at D 1792: 2b rows (a batch and its flips), E 1024
        xt, proj, hb = t(2 * b, d), t(d, 1024, std=d ** -0.5), t(1024, std=0.02,
                                                                dtype=torch.float32)
        g, gb = t(d, std=0.1, mean=1.0, dtype=torch.float32), t(d, std=0.1, dtype=torch.float32)
        if FT.tail_kernel_route(2 * b, d, 1024, True, {}) != "wgmma":
            raise PhaseFailed("evae: the tail at D 1792 is not on the wgmma kernel's route")
        yk, pk = FT.ln_proj_tail_kernel(xt, g, gb, proj, hb, eps)
        yr, pr = FT.ln_proj_tail_reference(xt, g, gb, proj, hb, eps)
        worst["tail y"], worst["tail p"] = one_rounding(yk, yr), one_rounding(pk, pr)
        x32, p32 = xt.float(), proj.float()
        tail32 = [rel_err(k_, r_)[1] for k_, r_ in zip(
            FT.ln_proj_tail_kernel(x32, g, gb, p32, hb, eps),
            FT.ln_proj_tail_reference(x32, g, gb, p32, hb, eps))]
    for mode, r in worst.items():
        say(f"  evae {mode} at B {b}, S {s}: worst |d| / one bf16 rounding {r:.3f} "
            f"{'ok' if r <= 1 else 'FAIL'}")
    say(f"  evae fc1: QuickGELU against the exact GELU: {quick:.1f} roundings (must pass 1)")
    say(f"  evae whole block (seven launches) against eva_e_block_reference: rel L2 "
        f"{block_gap:.2e} (tol 4e-3) {'ok' if block_gap < 4e-3 else 'FAIL'}")
    say(f"  evae fp32 tail at D 1792 (FMA kernel): worst rel {max(tail32):.2e} (tol 1e-5) "
        f"{'ok' if max(tail32) <= 1e-5 else 'FAIL'}")
    bad = [k for k, r in worst.items() if not r <= 1]
    if bad or not block_gap < 4e-3 or not max(tail32) <= 1e-5:
        raise PhaseFailed(f"evae: {bad or 'the block or the fp32 tail'} off the plain versions")
    worst["block_rel_l2"], worst["tail_fp32_rel"] = block_gap, max(tail32)

    card = card_line()
    lines = []

    def report(name, ms, **bounds):
        line = {"card": card, "name": name, "ms": ms}
        for key, seconds in bounds.items():
            line[key + "_ms"] = seconds * 1e3
            line[key + "_pct"] = 100.0 * seconds * 1e3 / ms if ms else None
        say("  evae time " + json.dumps(line))
        lines.append(line)

    def gemm_bound(k_, n_):
        return max(2.0 * m * k_ * n_ / PEAK_BF16_FLOPS,
                   2.0 * (m * k_ + k_ * n_ + m * n_) / PEAK_BYTES)

    with torch.no_grad():
        q, k, v = FA._qkv_views(qkv, h)
        qc, kc, vc = (z.transpose(1, 2).contiguous() for z in (q, k, v))  # (B, H, S, dh)
        att_flops = 4.0 * b * h * s * s * dh
        att_bound = max(att_flops / PEAK_BF16_FLOPS, 2.0 * 4 * m * d / PEAK_BYTES)
        for fast in (True, False):
            report(f"mha_core.dh112.fast{int(fast)}",
                   graph_ms(lambda: FA._attention_kernel(qkv, h, None, fast)), roofline=att_bound)
        report("sdpa.dh112", graph_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qc, kc, vc)),
            roofline=att_bound)
        report("plain_core.dh112", graph_ms(lambda: TA.xla_mha_core(q, k, v)), roofline=att_bound)
        del qc, kc, vc
        # the key-tile kernel at EVA-CLIP's own 224 x 224 input (257 tokens, 259 with prompts)
        sl = 259
        ql, kl, vl = (t(b, sl, h, dh) for _ in range(3))
        long_bound = max(4.0 * b * h * sl * sl * dh / PEAK_BF16_FLOPS,
                         2.0 * 4 * b * sl * d / PEAK_BYTES)
        report(f"mha_core.dh112.s{sl}.fast1", graph_ms(lambda: TA.mha_core(ql, kl, vl, fast=True)),
               roofline=long_bound)
        qt, kt, vt = (z.transpose(1, 2).contiguous() for z in (ql, kl, vl))
        report(f"sdpa.dh112.s{sl}", graph_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)),
            roofline=long_bound)
        del ql, kl, vl, qt, kt, vt
        report("qkv", graph_ms(lambda: FA.ln_gemm(x, None, None, w_qkv, b_qkv)),
               roofline=gemm_bound(d, 3 * d))
        report("out_proj", graph_ms(lambda: FA.ln_gemm(a, None, None, w_o, b_o)),
               roofline=gemm_bound(d, d))
        report("fc1.gelu_erf", graph_ms(
            lambda: FA.ln_gemm(x, None, None, w_1, b_1, gelu_erf=True)), roofline=gemm_bound(d, f))
        report("fc1.bias_only", graph_ms(lambda: FA.ln_gemm(x, None, None, w_1, b_1)),
               roofline=gemm_bound(d, f))
        report("fc1.cublas", graph_ms(lambda: x @ w_1), roofline=gemm_bound(d, f))
        hid = FA.ln_gemm(x, None, None, w_1, b_1, gelu_erf=True)
        report("fc2", graph_ms(lambda: FA.ln_gemm(hid, None, None, w_2, b_2)),
               roofline=gemm_bound(f, d))
        report("fc2.cublas", graph_ms(lambda: hid @ w_2), roofline=gemm_bound(f, d))
        del hid
        y = FA.ln_gemm(a, None, None, w_o, b_o)
        res_bytes = 2.0 * 3 * m * d / PEAK_BYTES
        report("ln_residual", graph_ms(lambda: FA.ln_residual(y, x, *ln, eps)),
               bytes_bound=res_bytes)
        report("ln_residual.splice", graph_ms(
            lambda: FA.ln_residual(y, x, *ln, eps, plane, pmask)), bytes_bound=res_bytes)
        block_flops = 2.0 * m * d * (3 * d + d + 2 * f) + att_flops
        report("block", graph_ms(
            lambda: FEE.fused_eva_e_block(x, weights, h, eps, plane, pmask, fast=True)),
            peak=block_flops / PEAK_BF16_FLOPS)
        tail_bound = max(2.0 * 2 * b * d * 1024 / PEAK_BF16_FLOPS,
                         2.0 * (2 * b * d * 2 + d * 1024 + 2 * b * 1024) / PEAK_BYTES)
        report("tail.d1792", graph_ms(lambda: FT.ln_proj_tail_kernel(xt, g, gb, proj, hb, eps)),
               roofline=tail_bound)
        report("tail.d1792.plain", graph_ms(
            lambda: FT.ln_proj_tail_reference(xt, g, gb, proj, hb, eps)), roofline=tail_bound)
    return worst, lines


def evae_phase(dev, batch=256):
    """EVA02-CLIP-E/14 on the evae-market.embed cell's path: the mode checks
    and times at B 256, S 165 (`evae_mode_checks`); then one batch of 256
    Market crops through the extractor (eval_embed, bf16, fast softmax, the
    input normalisation folded in, flip-TTA: two passes) with the counters
    zeroed just before it and read just after: every full block on the
    kernels (63 a pass, none plain), each on heads of 112 (`mha_core_wide`),
    four products and two ln_residual passes a block, the tail on its kernel
    once a pass; the same batch again with every block and the tail held
    against their plain versions on the run's own inputs; 32 of its rows
    against the plain bf16 tower."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.ops import attention as TA
    from tpu_reid_torch.ops import fused_attention as FA
    from tpu_reid_torch.ops import fused_eva_e as FEE
    from tpu_reid_torch.ops import fused_tail as FT
    from tpu_reid_torch.ops._build import kernel_impl
    from tpu_reid_torch.ops.attention import set_fast_softmax
    from tpu_reid_torch.parallel.extract import make_extractor

    worst, times = evae_mode_checks(dev, batch)
    torch.cuda.empty_cache()
    mcfg, params = evae_model(dev)
    bf, hw = torch.bfloat16, (256, 128)
    blocks = mcfg.clip.vision.layers - 1
    counters = {"fused_eva_e_block": FEE.fused_eva_e_block, "mha_core": TA.mha_core,
                "mha_core_wide": TA.mha_core_wide, "ln_gemm": FA.ln_gemm,
                "ln_residual": FA.ln_residual, "ln_rows": FA.ln_rows,
                "ln_proj_tail": FT.ln_proj_tail_kernel}
    fold = lambda p: M.fold_input_norm(p, mcfg, "vit")  # noqa: E731
    embed = lambda p, im: M.eval_embed(p, mcfg, im)  # noqa: E731
    ext = make_extractor(embed, DevicePreprocess(hw, "vit", dtype=bf), flip_tta=True, dtype=bf,
                         fold=fold, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    images = torch.randint(0, 255, (batch, *hw, 3), dtype=torch.uint8, device=dev,
                           generator=gen)
    set_fast_softmax(True)
    try:
        ext(params, images)  # warm-up
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        FEE.fused_eva_e_block.plain = 0
        t0 = time.perf_counter()
        out = ext(params, images)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
        plain = FEE.fused_eva_e_block.plain
        passes = 2
        say(f"EVA02-CLIP-E/14 serving (eval_embed, 256x128, {mcfg.clip.vision.seq_len} tokens, "
            f"batch {batch}, bf16, fast softmax, folded input norm, flip-TTA): one batch in "
            f"{sec:.3f} s ({batch / sec:.1f} emb/s, one batch: not the cell's figure)")
        say(f"  launches in the batch ({passes} passes): {launches}, fused_eva_e_block.plain "
            f"{plain}")
        want_counts = {"fused_eva_e_block": blocks * passes, "mha_core": blocks * passes,
                       "mha_core_wide": blocks * passes, "ln_gemm": 4 * blocks * passes,
                       "ln_residual": 2 * blocks * passes, "ln_rows": 0,
                       "ln_proj_tail": passes}
        if launches != want_counts or plain:
            raise PhaseFailed(f"evae: launches {launches} and {plain} plain blocks, expected "
                              f"{want_counts} and none plain")
        errs = {"fused_eva_e_block": [], "ln_proj_tail": []}
        with held_against_plain(FEE, "fused_eva_e_block", FEE.eva_e_block_reference,
                                errs["fused_eva_e_block"]), \
                held_against_plain(FT, "ln_proj_tail_kernel", FT.ln_proj_tail_reference,
                                   errs["ln_proj_tail"]):
            held = ext(params, images)
        x = images[:32]
        with kernel_impl("plain"):
            ep = ext(params, x)
    finally:
        set_fast_softmax(False)
    tol = TOL[bf]
    for name, es in errs.items():
        w = max((rel for _, rel in es), default=float("inf"))
        say(f"  evae {name}, {len(es)} outputs of one batch, each against its plain version "
            f"on the run's own inputs: worst rel {w:.3e} (tol {tol:.0e}) "
            f"{'ok' if w <= tol else 'FAIL'}")
        if not es or w > tol:
            raise PhaseFailed(f"evae: {name} disagrees with its plain version")
        worst[f"held {name}"] = w
    same = rel_err(held, out)[1]
    rows = lambda a, b: (a.float() - b.float()).norm(dim=1) / b.float().norm(dim=1)  # noqa: E731
    gap = float(rows(out[:32], ep).max())
    say(f"  the held batch against the counted one: rel {same:.3e}; kernels against the plain "
        f"bf16 tower on 32 rows: worst row {gap:.4f} (tol 3e-2: the plain tower rounds "
        f"elsewhere, 64 blocks deep) {'ok' if gap < 3e-2 else 'FAIL'}")
    if same > 1e-3 or gap >= 3e-2:
        raise PhaseFailed("evae: the held run differs from the counted run or the plain tower")
    if out.shape != (batch, 1792 + 1024) or not torch.isfinite(out).all():
        raise PhaseFailed(f"evae: embeddings not finite or of shape {tuple(out.shape)}")
    worst["rows_vs_plain_tower"] = gap
    del params, out, held, ep
    torch.cuda.empty_cache()
    return launches, {"checks": worst, "times": times}


def multitask_model(dev):
    """The hard_ivlp multitask model: IVLP ViT-B/16 (prompt depth 12, 2
    context tokens) shared by task 0 at 256x128 (213 tokens, 751 classes)
    and task 1 at 256x256 (444 tokens, 576 classes), a second text tower,
    random weights from seed 0 (fp32)."""
    from tpu_reid_torch.configs import PromptDesign
    from tpu_reid_torch.models import prompts as P
    from tpu_reid_torch.train import multitask as MT
    from tpu_reid_torch.weights.convert import convert_clip, init_vpt, random_clip_state_dict

    design = PromptDesign(trainer="IVLP", vision_depth=12, vision_ctx=2, language_depth=12,
                          language_ctx=2)
    cfg, clip = convert_clip(random_clip_state_dict(0), image_hw=(256, 128), stride=12,
                             design=design, device=dev)
    clip = init_vpt(torch.Generator().manual_seed(0), cfg, clip)
    hg, wg = cfg.vision.grid_for((256, 256), cfg.vision.patch_size, 12)
    cfg2 = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, h_grid=hg, w_grid=wg))
    mcfg = MT.MultitaskModelConfig("hard_ivlp", cfg, cfg2, *(
        P.PromptLearnerConfig.ivlp(n) for n in MT_CLASSES))
    template = random_template(cfg, clip, dev)
    params = MT.init_multitask_model(torch.Generator().manual_seed(0), mcfg, clip, *template,
                                     *template)
    if (cfg.vision.seq_len, cfg2.vision.seq_len) != (213, 444):
        raise PhaseFailed(f"unexpected multitask geometry {cfg.vision}, {cfg2.vision}")
    return mcfg, params


def multitask_phase(dev, counters, bs=64):
    """hard_ivlp at bs 64 (PK 16 x 4), bf16 activations over fp32 master
    weights: two stage-1 and two stage-2 steps per task, in turns (ms per
    step per task, peak memory, launches); then run_mt_stage2 for 2 epochs
    of 2 steps per task straight, against 1 epoch saved through a
    CheckpointManager, restored from the files and run to the end."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.train import multitask as MT
    from tpu_reid_torch.train import optim as O
    from tpu_reid_torch.train import trainer as TR
    from tpu_reid_torch.train import xbm as X

    bf = torch.bfloat16
    t0 = time.perf_counter()
    mcfg, params = multitask_model(dev)
    say(f"multitask hard_ivlp: task 0 256x128 (213 tokens, {MT_CLASSES[0]} classes), task 1 "
        f"256x256 (444 tokens, {MT_CLASSES[1]} classes), built in "
        f"{time.perf_counter() - t0:.1f} s; bs {bs} (PK {bs // 4}x4), bf16 activations, fp32 "
        f"master weights")
    tcfg = TR.TrainConfig()
    hws = ((256, 128), (256, 256))
    pps = [DevicePreprocess(hw, "vit", dtype=bf) for hw in hws]
    gen = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.RandomState(2)
    valid = torch.ones(bs, dtype=torch.bool, device=dev)

    def task_batches(task, n):
        return [(torch.randint(0, 255, (bs, *hws[task], 3), dtype=torch.uint8, device=dev,
                               generator=gen),
                 torch.as_tensor(np.repeat(rng.choice(MT_CLASSES[task], bs // 4,
                                                      replace=False), 4), device=dev))
                for _ in range(n)]

    data = [task_batches(t, 2) for t in (0, 1)]
    ms, losses = {}, []

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.setdefault(key, []).append(1e3 * (time.perf_counter() - t0))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    tr1, fr1 = O.partition(params, lambda p: MT.mt_stage1_trainable(p, mcfg))
    tr1 = TR._trainable_copy(tr1)
    opt1 = O.make_stage_optimizer(tr1, tcfg.lr_stage1, tcfg.weight_decay)
    steps1 = [MT.make_mt_stage1_step(mcfg, opt1, t) for t in (0, 1)]
    for i in range(2):
        for t in (0, 1):
            images, labels = data[t][i]
            losses.append(timed(("stage-1", t), lambda: steps1[t](
                tr1, fr1, pps[t].eval_batch(images), labels, valid)))
    peak1 = torch.cuda.max_memory_allocated() / 2**30
    del tr1, opt1, steps1
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        text = [MT.all_class_text_features_mt(params, mcfg, t) for t in (0, 1)]
    tr2, fr2 = O.partition(params, lambda p: MT.mt_stage2_trainable(p, mcfg))
    tr2 = TR._trainable_copy(tr2)
    opt2 = O.make_stage_optimizer(tr2, tcfg.lr_stage2, tcfg.weight_decay, bias_lr_mult=2.0)
    steps2 = [MT.make_mt_stage2_step(mcfg, tcfg, opt2, t) for t in (0, 1)]
    state = {"frozen": fr2, "xbms": [X.init_xbm(2 * bs, mcfg.clip.embed_dim, device=dev)
                                     for _ in (0, 1)]}
    for i in range(2):
        for t in (0, 1):
            images, labels = data[t][i]
            x = pps[t].train_batch(images, pps[t].train_draws(gen, bs))

            def s2(t=t, x=x, labels=labels):
                state["frozen"], state["xbms"][t], loss = steps2[t](
                    tr2, state["frozen"], x, labels, text[t], state["xbms"][t], True, valid)
                return loss

            losses.append(timed(("stage-2", t), s2))
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    peak2 = torch.cuda.max_memory_allocated() / 2**30
    del tr2, opt2, steps2, state
    for (stage, t), v in ms.items():
        say(f"  {stage} task {t} ({(213, 444)[t]} tokens): {v[1]:.1f} ms per step after a "
            f"{v[0]:.1f} ms first step")
    say(f"  peak memory: stage 1 {peak1:.2f} GiB, stage 2 {peak2:.2f} GiB; launches in the "
        f"8 steps {launches}")
    vals = [float(v) for v in losses]
    say(f"  losses: {', '.join(f'{v:.4f}' for v in vals)}")
    if not np.isfinite(vals).all():
        raise PhaseFailed(f"non-finite multitask losses {vals}")
    missing = [k for k, c in launches.items() if c == 0]
    if missing:
        raise PhaseFailed(f"the multitask steps never launched {missing}")
    multitask_resume(dev, mcfg, params, pps, data, gen, bs)
    return launches


def multitask_resume(dev, mcfg, params, pps, data, gen, bs):
    """run_mt_stage2, 2 epochs x 2 steps per task (memory triplet from epoch
    0), straight and resumed from files after epoch 1; the trained leaves
    within the Adam bound of the steps of both runs (each run's plain
    backward may sum in its own order: cuDNN's and the atomics' choices),
    the rest and the banks' labels, pointers and fill counts equal."""
    import tempfile

    from tpu_reid_torch.runtime import checkpoint as C
    from tpu_reid_torch.train import multitask as MT
    from tpu_reid_torch.train import optim as O
    from tpu_reid_torch.train import schedules as S
    from tpu_reid_torch.train import trainer as TR

    valid = torch.ones(bs, dtype=torch.bool, device=dev)
    epochs = {e: [(t, (pps[t].train_batch(images, pps[t].train_draws(gen, bs)), labels, valid))
                  for i in range(2) for t in (0, 1) for images, labels in [data[t][i]]]
              for e in range(2)}
    tcfg = TR.TrainConfig()

    class Interrupt(Exception):
        pass

    def run(p, cb=None, **kw):
        banks = {}

        def keep(e, q, state):
            banks["xbms"] = state["xbms"]
            if cb is not None:
                cb(e, q, state)

        out = MT.run_mt_stage2(p, mcfg, tcfg, lambda e: iter(epochs[e]), epochs=2,
                               xbm_capacity=2 * bs, xbm_start_epoch=0, log=lambda s: None,
                               checkpoint_cb=keep, **kw)
        return out, banks["xbms"]

    want, want_xbms = run(params)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = C.CheckpointManager(tmp, save_interval=1, max_to_keep=1)
        save = C.two_stage_cb(mgr, 1, lambda e: e)
        times = {}

        def stop(e, q, state):
            t0 = time.perf_counter()
            save(e, q, state)
            times["save"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            mgr.latest_epoch()  # waits for the writes
            times["write"] = time.perf_counter() - t0
            raise Interrupt

        try:
            run(params, stop)
        except Interrupt:
            pass
        size = {f: os.path.getsize(os.path.join(tmp, f)) for f in sorted(os.listdir(tmp))}
        t0 = time.perf_counter()
        restored, done, _, kw2 = C.two_stage_resume(
            mgr, params, lambda p: MT.mt_stage1_leaf_order(p, mcfg),
            lambda p: MT.mt_stage2_leaf_order(p, mcfg), True, True, xbms_used=True)
        torch.cuda.synchronize()
        times["restore"] = time.perf_counter() - t0
        mgr.close()
    got, got_xbms = run(restored, **kw2)
    say(f"  stage-2 checkpoint after epoch 1: save() returned after {times['save']:.2f} s "
        f"(host snapshot), the writes ended {times['write']:.2f} s later; "
        f"{sum(size.values()) / 2**20:.1f} MiB on disk "
        f"({', '.join(f'{k} {v / 2**20:.1f} MiB' for k, v in size.items())}); restore "
        f"{times['restore']:.2f} s; resumed at epoch {kw2['start_epoch'] + 1} of 2")
    trained = {path for path, leaf in O.paths(O.partition(
        want, lambda q: MT.mt_stage2_trainable(q, mcfg))[0]) if leaf is not None}
    lrs = [S.warmup_multistep_lr(e, tcfg.lr_stage2) for e in range(2) for _ in range(4)]
    bound = 2.0 * 2.0 * sum(lrs)  # the bias group runs at 2x lr
    worst, bn_rel, equal, frozen_bad = 0.0, 0.0, True, []
    for (path, a), (_, b) in zip(O.paths(got), O.paths(want), strict=True):
        same = torch.equal(a, b)
        equal &= same
        if path in trained:
            worst = max(worst, float((a.float() - b.float()).abs().max()))
        elif path[-1] in ("mean", "var"):  # BN statistics: state of the forward
            bn_rel = max(bn_rel, rel_err(a, b)[1])
        elif not same:
            frozen_bad.append("/".join(path))
    banks_ok = all(torch.equal(g["labels"], w["labels"]) and (g["ptr"], g["filled"]) ==
                   (w["ptr"], w["filled"]) for g, w in zip(got_xbms, want_xbms))
    feat_d = max(float((g["feats"] - w["feats"]).abs().max())
                 for g, w in zip(got_xbms, want_xbms))
    ok = done == 1 and worst <= bound and bn_rel <= 1e-2 and not frozen_bad and banks_ok
    say(f"  resumed against straight: {'bit-equal' if equal else 'not bit-equal'}; trained "
        f"leaves max|d| {worst:.3e} (Adam bound {bound:.1e}), BN statistics rel {bn_rel:.2e} "
        f"(tol 1e-2), other leaves "
        f"{'equal' if not frozen_bad else 'DIFFER ' + str(frozen_bad[:3])}; XBM banks labels, "
        f"pointers, fill counts {'equal' if banks_ok else 'DIFFER'}, features max|d| "
        f"{feat_d:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("the resumed multitask stage 2 does not follow the straight run")


def multitask_cli_phase(counters):
    """python -m tpu_reid_torch.cli.multitask --variant hard_ivlp on a
    synthetic Market1501 and a synthetic VeRi directory at full width, then
    the same command with --resume."""
    import tempfile

    from tpu_reid_torch.cli import multitask as mt_cli
    from tpu_reid_torch.models.tokenizer import write_test_merges
    from tpu_reid_torch.weights.convert import random_clip_state_dict

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        nq, ng = write_market_dir(tmp)
        write_veri_dir(tmp, n_ids=16, mix=0.2)
        ckpt = os.path.join(tmp, "vit_b16_random.pth")
        torch.save({k: torch.from_numpy(v) for k, v in random_clip_state_dict(0).items()}, ckpt)
        merges = os.path.join(tmp, "merges.txt")
        write_test_merges(merges, [("p", "e"), ("r", "s"), ("c", "a"), ("ca", "r</w>")])
        argv = ["--root", tmp, "--model_path", ckpt, "--bpe_path", merges,
                "--variant", "hard_ivlp", "--train_dataset", "market1501",
                "--train_dataset_multitask", "veri", "--height", "256", "--ratio", "0.5",
                "--height_multitask", "256", "--ratio_multitask", "1.0", "--stride", "12",
                "--dtype", "bf16", "--bs", "64", "--epochs_stage1", "1", "--epochs_stage2", "1",
                "--rerank", "--save_path", os.path.join(tmp, "checkpoints")]
        say(f"multitask CLI: Market1501 (256 training, {nq} query, {ng} gallery 256x128 JPEGs) "
            f"and VeRi (128 training 256x256 JPEGs) written in {time.perf_counter() - t0:.1f} "
            f"s; python -m tpu_reid_torch.cli.multitask " + " ".join(argv[6:]))
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        cmc, mAP = mt_cli.main(argv)
        torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
        say(f"  multitask CLI run {time.perf_counter() - t0:.1f} s: Rank-1 {cmc[0]:.4f}, mAP "
            f"{mAP:.4f}; launches {launches}")
        missing = [n for n, c in launches.items() if c == 0]
        if missing:
            raise PhaseFailed(f"the multitask CLI never launched {missing}")
        if not np.isfinite(cmc).all() or not 0.0 < mAP <= 1.0:
            raise PhaseFailed(f"multitask CLI result out of range: mAP {mAP}")
        resume_cli(mt_cli, argv, os.path.join(tmp, "checkpoints", "hard_ivlp", "coop",
                                              "market1501_veri"), 2, mAP)
    return launches


# ---------------------------------------------------------------------------
# phase 13: the RN50 zero-shot tower (convs and the attention pool are plain
# PyTorch, as they are plain XLA in the JAX package; the text classifier runs
# the block kernels, --rerank the minsum kernel)
# ---------------------------------------------------------------------------

# the kernels of a text tower: every block kernel, no CLS tail
BLOCK_KERNELS = ("ln_gemm", "mha_core", "gemm_bias_residual", "fused_mha", "fused_mlp",
                 "fused_block")


def launched(counters):
    return {name: c.launches for name, c in counters.items()}


def require(what, launches, names):
    missing = [n for n in names if launches.get(n, 0) == 0]
    if missing:
        raise PhaseFailed(f"{what} never launched {missing}")


RN_MIX = 0.1


def resnet_phase(dev, counters):
    """RN50 zero-shot at full width from random_clip_state_dict(vision="rn50")
    at 256x128 (a 16x8 layer-4 map, 129 tokens in the attention pool): the
    main path at the zero-shot phase's sizes (16 identities, 128 query and 512
    gallery images, bf16, flip-TTA, batches of 128) with emb/s, peak memory and
    a traced step; the text classifier's blocks held against their plain
    version; the tower in fp32 on the card against the same function on the
    CPU (4 images, TF32 off); then the zero-shot CLI with an RN50 checkpoint
    and --rerank. Returns ({path: launches}, emb/s)."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.device import to_device
    from tpu_reid_torch.models import resnet as R
    from tpu_reid_torch.ops import fused_attention as FA
    from tpu_reid_torch.pipelines import zero_shot as Z
    from tpu_reid_torch.weights.convert import convert_clip, random_clip_state_dict

    t0 = time.perf_counter()
    sd = random_clip_state_dict(0, vision="rn50")
    cfg, params = convert_clip(sd, image_hw=(256, 128), device=dev)
    torch.cuda.synchronize()
    r = cfg.resnet
    say(f"RN50: random state dict -> convert_clip (256x128): layers {r.layers}, width "
        f"{r.width}, a {r.h_grid}x{r.w_grid} layer-4 map (attention pool over "
        f"{1 + r.h_grid * r.w_grid} tokens, {r.heads} heads), embed_dim {cfg.embed_dim}, "
        f"{time.perf_counter() - t0:.1f} s")
    if (r.h_grid, r.w_grid) != (16, 8):
        raise PhaseFailed(f"unexpected RN50 geometry {cfg}")
    tokenizer, ids, templates = zero_shot_prompts()
    # less of each identity's base image than the ViT phase's 0.35: the RN's
    # pooled features tell the blocky bases apart at 0.35 (mAP 0.998)
    data = make_images(len(ids), 128, 512, seed=1, mix=RN_MIX)
    zero_shot_run(params, cfg, tokenizer, ids[:2], {i: templates[i] for i in ids[:2]},
                  tuple(a[:8] for a in data), torch.bfloat16, 8, dev)  # warm-up

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    res = zero_shot_run(params, cfg, tokenizer, ids, templates, data, torch.bfloat16, 128, dev)
    launches = launched(counters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_img = len(data[0]) + len(data[3])
    t = res["times"]
    emb_s = n_img / t["extract_s"]
    say(f"RN50 zero-shot main path (bf16, flip-TTA, batches of 128): {len(data[0])} query + "
        f"{len(data[3])} gallery images, {len(ids)} identities")
    say(f"  classifier {t['classifier_s']:.3f} s, extraction {t['extract_s']:.3f} s "
        f"({emb_s:.1f} emb/s), scoring {t['score_s']:.3f} s; peak memory {peak:.2f} GiB")
    say(f"  Rank-1 {res['cmc'][0]:.4f}, Rank-5 {res['cmc'][4]:.4f}, mAP {res['mAP']:.4f}, "
        f"mINP {res['mINP']:.4f}; launches in the run {launches}")
    width = r.width * 32 + cfg.embed_dim
    for name, f, n in (("query", res["qf"], len(data[0])), ("gallery", res["gf"], len(data[3]))):
        if f.shape != (n, width) or not torch.isfinite(f).all():
            raise PhaseFailed(f"RN50 {name} embeddings {tuple(f.shape)} not finite/({n}, {width})")
    require("the RN50 zero-shot path", launches, BLOCK_KERNELS)
    if not 0.02 < res["mAP"] < 0.98:
        raise PhaseFailed(f"RN50 mAP {res['mAP']:.4f} too close to 0 or 1 to hold anything")
    trace_step(params, cfg, data[3][:128], dev)

    # the classifier's text blocks (fp32, causal S=77) against their plain version
    errs = []
    with held_against_plain(FA, "fused_block", FA.fused_block_reference, errs):
        Z.zeroshot_classifier(params, cfg, tokenizer, ids, templates, augmented=True, device=dev)
    worst = max((rel for _, rel in errs), default=float("inf"))
    tol = TOL[torch.float32]
    say(f"  the classifier's {len(errs)} text blocks (fp32, causal, 77 tokens), each against "
        f"its plain version on the run's own inputs: worst rel {worst:.3e} (tol {tol:.0e}) "
        f"{'ok' if worst <= tol else 'FAIL'}")
    if worst > tol:
        raise PhaseFailed("the RN50 classifier's blocks disagree with their plain version")

    # the tower in fp32 on the card against the CPU (TF32 is off: main())
    x = DevicePreprocess((256, 128), "rn").eval_batch(torch.from_numpy(data[3][:4]))
    with torch.no_grad():
        got = R.apply_resnet(params["visual"], r, x.to(dev))
        want = R.apply_resnet(to_device(params["visual"], torch.device("cpu")), r, x)
    rels = [rel_err(g.cpu(), w)[1] for g, w in zip(got, want)]
    ok = max(rels) <= 2e-4 and not torch.backends.cudnn.allow_tf32
    say(f"  RN50 tower fp32 on the card vs the CPU (4 images; x3, x4, xproj): rel "
        f"{', '.join(f'{v:.2e}' for v in rels)} (tol 2e-4 of max|CPU|: cuDNN's and the CPU's "
        f"convolutions sum in other orders; TF32 {torch.backends.cudnn.allow_tf32}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("the RN50 tower on the card disagrees with the CPU")
    del params, res
    torch.cuda.empty_cache()
    return {"resnet_zero_shot": launches, "resnet_cli": resnet_cli(sd, counters)}, emb_s


def resnet_cli(sd, counters):
    """python -m tpu_reid_torch.cli.zero_shot with the RN50 checkpoint on the
    synthetic Market1501 directory, --rerank (minsum)."""
    import tempfile

    from tpu_reid_torch.cli import zero_shot as cli
    from tpu_reid_torch.models.tokenizer import write_test_merges

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        nq, ng = write_market_dir(tmp)
        ckpt = os.path.join(tmp, "rn50_random.pth")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
        merges = os.path.join(tmp, "merges.txt")
        write_test_merges(merges, [("p", "e"), ("r", "s"), ("o", "n</w>"), ("n", "o")])
        argv = ["--root", tmp, "--model_path", ckpt, "--bpe_path", merges, "--rerank",
                "--height", "256", "--ratio", "0.5", "--bs", "128", "--test_dataset",
                "market1501"]
        say(f"RN50 CLI: {nq} query + {ng} gallery JPEGs and a random RN50 checkpoint written "
            f"in {time.perf_counter() - t0:.1f} s; python -m tpu_reid_torch.cli.zero_shot "
            + " ".join(argv[6:]))
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        cmc, mAP = cli.main(argv)
        torch.cuda.synchronize()
    launches = launched(counters)
    say(f"  RN50 CLI run {time.perf_counter() - t0:.1f} s: Rank-1 {cmc[0]:.4f}, mAP {mAP:.4f}; "
        f"launches {launches}")
    require("the RN50 zero-shot CLI", launches, BLOCK_KERNELS + ("minsum",))
    if len(cmc) != min(50, ng) or not np.isfinite(cmc).all() or not 0.0 < mAP <= 1.0:
        raise PhaseFailed(f"RN50 CLI result out of range: cmc {len(cmc)} entries, mAP {mAP}")
    return launches


# ---------------------------------------------------------------------------
# phase 14: the prompt-learning variants at full ViT-B/16 width: MaPLe, and
# coop with the JPM branch and SIE
# ---------------------------------------------------------------------------

N_CAMERAS = 6  # Market-1501's


def variant_model(dev, mode, use_jpm=False, sie_ids=0, n_cls=751):
    """ViT-B/16 at 256x128, stride 12, random weights from seed 0, in `mode`
    (maple: prompt depth 12 with 2 context tokens, 213 tokens; coop: 211),
    with the JPM branch and an SIE table of `sie_ids` rows."""
    from tpu_reid_torch.configs import PromptDesign
    from tpu_reid_torch.models import prompts as P
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.weights.convert import convert_clip, init_vpt, random_clip_state_dict

    design = PromptDesign()
    if mode == "maple":
        design = PromptDesign(trainer="MaPLe", vision_depth=12, vision_ctx=2, language_depth=12,
                              language_ctx=2, maple_length=2)
    cfg, clip = convert_clip(random_clip_state_dict(0), image_hw=(256, 128), stride=12,
                             design=design, device=dev)
    if design.has_vision_prompts:
        clip = init_vpt(torch.Generator().manual_seed(0), cfg, clip)
    pcfg = (P.PromptLearnerConfig.ivlp(n_cls) if mode == "maple"
            else P.PromptLearnerConfig.coop(n_cls))
    mcfg = M.ReidModelConfig(mode=mode, clip=cfg, prompt=pcfg, use_jpm=use_jpm, sie_ids=sie_ids)
    params = M.init_reid_model(torch.Generator().manual_seed(0), mcfg, clip,
                               *random_template(cfg, clip, dev))
    return mcfg, params


def variant_batch(dev, mcfg, bs, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randint(0, 255, (bs, 256, 128, 3), dtype=torch.uint8, device=dev,
                           generator=gen)
    labels = torch.as_tensor(np.repeat(np.random.RandomState(seed).choice(
        mcfg.n_cls, bs // 4, replace=False), 4), device=dev)
    cams = torch.randint(0, N_CAMERAS, (bs,), device=dev, generator=gen)
    return images, labels, cams, gen


def stage2_steps(dev, counters, mcfg, params, name, bs, losses):
    """Three stage-2 steps at bs `bs` in bf16 activations (SIE camera ids
    when the model has a table): timed_steps' report. The JPM path runs no
    CLS tail (plain LayerNorm and product, as in JAX), so its steps are held
    to the block kernels only."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.train import optim as O
    from tpu_reid_torch.train import trainer as TR

    tcfg = TR.TrainConfig()
    images, labels, cams, gen = variant_batch(dev, mcfg, bs, seed=3)
    pp = DevicePreprocess((256, 128), "vit", dtype=torch.bfloat16)
    x = pp.train_batch(images, pp.train_draws(gen, bs))
    valid = torch.ones(bs, dtype=torch.bool, device=dev)
    cv = cams if mcfg.sie_ids else None
    with torch.no_grad():
        text = M.all_class_text_features(params, mcfg)
    tr, fr = O.partition(params, lambda p: M.stage2_trainable(p, mcfg))
    tr = TR._trainable_copy(tr)
    fr = TR._bn_state(fr, mcfg)[0]  # the steps write the BN statistics in place
    step = TR.make_stage2_step(mcfg, tcfg, O.make_stage_optimizer(
        tr, tcfg.lr_stage2, tcfg.weight_decay, bias_lr_mult=2.0))
    held = {k: c for k, c in counters.items() if not (mcfg.use_jpm and k == "ln_proj_tail")}
    report = timed_steps(f"{name} stage-2", lambda: step(tr, fr, x, labels, text, valid, cv),
                         held, losses)
    if mcfg.use_jpm:
        moved = float((fr["jpm_head"]["bn"]["mean"]
                       - params["jpm_head"]["bn"]["mean"]).abs().max())
        say(f"  JPM BNNeck running mean moved by up to {moved:.3e} over the steps")
        if not moved > 0:
            raise PhaseFailed("the JPM BNNeck's running statistics were not threaded")
    return report


def maple_plane_gradients(dev, maple):
    """One spliced block at full width (B=16, S=213, fp32) whose prompt plane
    is computed from MaPLe's couplings (layer 0's rows: shared_ctx through
    proj[0]; layer 1's: text_deep[0] through proj[1]): the block Function's
    gradients to those leaves against plain autograd through the plain
    block, under one fixed grad_output."""
    from tpu_reid_torch.device import clone
    from tpu_reid_torch.models.maple_prompts import maple_prompt_stacks
    from tpu_reid_torch.ops import fused_attention as FA
    from tpu_reid_torch.train.optim import paths

    rng = np.random.default_rng(7)
    d = maple["proj"]["w"].shape[-1]
    b, s, hid, heads = 16, 213, 4 * d, d // 64
    f32 = torch.float32
    w = list(block_params(rng, d, hid, f32, dev).values())
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).to(dev)
    pm = torch.zeros(s, 1, device=dev)
    pm[s - 2:] = 1.0
    worst, names = 0.0, []
    for layer, reached in ((0, ("shared_ctx", "proj/w", "proj/b")),
                           (1, ("text_deep", "proj/w", "proj/b"))):
        grads = {}
        for impl in ("kernel", "plain"):
            m = clone(maple)
            leaves = {"/".join(p): t.requires_grad_() for p, t in paths(m)}
            _, vdeep, _ = maple_prompt_stacks(m, 2)
            plane = vdeep.new_zeros(s, d)
            plane[s - 2:] = vdeep[layer]
            if impl == "kernel":
                out = FA.fused_block_autograd(x, *w, heads, None, prompt_plane=plane,
                                              prompt_mask=pm)
            else:
                out = FA._block_xla_impl(FA._block_params(w), FA.splice_plane(x, plane, pm),
                                         heads, None)
            grads[impl] = torch.autograd.grad(out, [leaves[k] for k in reached], g)
        for k, gk, gp in zip(reached, grads["kernel"], grads["plain"]):
            _, rel = rel_err(gk, gp)
            worst = max(worst, rel)
            names.append(f"{k}@{layer}")
    ok = worst <= 1e-5
    say(f"  MaPLe's computed prompt plane through the block Function (B={b}, S={s}, fp32): "
        f"gradients of {', '.join(names)} against plain autograd, worst rel {worst:.3e} (tol "
        f"1e-5: the kernel chain against cuBLAS fp32) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("the gradient of MaPLe's prompt plane disagrees with plain autograd")


def variants_phase(dev, counters, bs=64, batch=512):
    """MaPLe (213 tokens, 751 classes): 3 live stage-1 and 3 stage-2 steps at
    bs 64 in bf16 activations, the spliced blocks forward on MaPLe's computed
    prompts against their plain version, the plane's gradient against plain
    autograd. coop with JPM and SIE (211 tokens, 6 cameras): 3 stage-2 steps,
    then eval_embed (2048 wide) at batch 512, bf16, fast softmax, 4 batches,
    with every block (the full-sequence 12th and the JPM block included)
    held against its plain version. Then the prompt-learning CLI with both.
    Returns ({path: launches}, {name: number})."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.ops._build import kernel_impl
    from tpu_reid_torch.ops import fused_attention as FA
    from tpu_reid_torch.ops.attention import set_fast_softmax
    from tpu_reid_torch.parallel.extract import make_extractor
    from tpu_reid_torch.train import optim as O
    from tpu_reid_torch.train import trainer as TR

    bf = torch.bfloat16
    by_path, numbers, losses = {}, {}, []
    steps_counters = {k: counters[k] for k in BLOCK_KERNELS + ("ln_proj_tail",)}
    t0 = time.perf_counter()
    mcfg, params = variant_model(dev, "maple")
    if mcfg.clip.vision.seq_len != 213:
        raise PhaseFailed(f"unexpected MaPLe geometry {mcfg.clip.vision}")
    say(f"variants: MaPLe ViT-B/16 (213 tokens, prompt depth 12, 2 context tokens, "
        f"{mcfg.n_cls} classes) built in {time.perf_counter() - t0:.1f} s; bs {bs}, bf16 "
        f"activations, fp32 master weights")
    tcfg = TR.TrainConfig()
    images, labels, _, _ = variant_batch(dev, mcfg, bs, seed=1)
    pp = DevicePreprocess((256, 128), "vit", dtype=bf)
    valid = torch.ones(bs, dtype=torch.bool, device=dev)
    tr1, fr1 = O.partition(params, lambda p: M.stage1_trainable(p, mcfg))
    tr1 = TR._trainable_copy(tr1)
    step1 = TR.make_stage1_step(mcfg, O.make_stage_optimizer(tr1, tcfg.lr_stage1,
                                                             tcfg.weight_decay), cached=False)
    batch1 = {"images": pp.eval_batch(images), "labels": labels, "valid": valid}
    r1 = timed_steps("MaPLe stage-1 live", lambda: step1(tr1, fr1, batch1), steps_counters,
                     losses)
    moved = float((tr1["maple"]["proj"]["w"].detach() - params["maple"]["proj"]["w"]).abs().max())
    say(f"  the couplings moved by up to {moved:.3e} in 3 steps")
    if not moved > 0:
        raise PhaseFailed("MaPLe's stage 1 did not train the couplings")
    del tr1, step1
    r2 = stage2_steps(dev, steps_counters, mcfg, params, "MaPLe", bs, losses)
    by_path["maple_stage1"], by_path["maple_stage2"] = r1["launches"], r2["launches"]
    numbers.update(maple_stage1_ms=r1["ms"], maple_stage2_ms=r2["ms"])

    # the spliced blocks forward on MaPLe's computed prompts (bf16)
    errs = []
    pbf = _cast(params, bf)
    with torch.no_grad(), held_against_plain(FA, "fused_block", FA.fused_block_reference, errs):
        M.encode_image_features(pbf, mcfg, pp.eval_batch(images))
        M.encode_text_features(pbf, mcfg, labels)
    worst = max((rel for _, rel in errs), default=float("inf"))
    say(f"  MaPLe's spliced blocks (vision 213 tokens, text 77, bf16): {len(errs)} block calls "
        f"on computed prompts, each against its plain version, worst rel {worst:.3e} (tol "
        f"{TOL[bf]:.0e}) {'ok' if worst <= TOL[bf] else 'FAIL'}")
    if worst > TOL[bf]:
        raise PhaseFailed("MaPLe's spliced blocks disagree with their plain version")
    maple_plane_gradients(dev, params["maple"])
    del params, pbf
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mcfg, params = variant_model(dev, "coop", use_jpm=True, sie_ids=N_CAMERAS)
    if mcfg.clip.vision.seq_len != 211:
        raise PhaseFailed(f"unexpected coop geometry {mcfg.clip.vision}")
    say(f"variants: coop ViT-B/16 with JPM and SIE ({N_CAMERAS} cameras; 211 tokens) built in "
        f"{time.perf_counter() - t0:.1f} s")
    r3 = stage2_steps(dev, steps_counters, mcfg, params, "JPM + SIE", bs, losses)
    by_path["jpm_sie_stage2"] = r3["launches"]
    numbers["jpm_sie_stage2_ms"] = r3["ms"]
    vals = [float(v) for v in losses]
    say(f"  losses: {', '.join(f'{v:.4f}' for v in vals)}")
    if not np.isfinite(vals).all():
        raise PhaseFailed(f"non-finite variant losses {vals}")

    # serving: eval_embed with the JPM part, batch 512
    k_batches = 4
    pbf = _cast(params, bf)
    ext = make_extractor(lambda p, im, cv: M.eval_embed(p, mcfg, im, cv),
                         DevicePreprocess((256, 128), "vit", dtype=bf), flip_tta=False,
                         dtype=bf, with_cv_ids=True, fold=lambda p: M.fold_input_norm(p, mcfg),
                         device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    xs = torch.randint(0, 255, (k_batches, batch, 256, 128, 3), dtype=torch.uint8, device=dev,
                       generator=gen)
    cams = torch.randint(0, N_CAMERAS + 2, (k_batches, batch), device=dev, generator=gen)
    set_fast_softmax(True)
    try:
        ext(pbf, xs[0], cams[0])  # warm-up
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        outs = [ext(pbf, xs[k], cams[k]) for k in range(k_batches)]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = launched(counters)
        emb_s = k_batches * batch / sec
        say(f"JPM + SIE serving (eval_embed, 256x128, 211 tokens + the JPM block, batch {batch}, "
            f"bf16, fast softmax, folded input norm, no flip-TTA): {k_batches} batches in "
            f"{sec:.3f} s, {emb_s:.1f} emb/s, {1e3 * sec / k_batches:.2f} ms per batch; "
            f"launches {launches}")
        trace(lambda: ext(pbf, xs[0], cams[0]),
              f"one JPM + SIE eval_embed batch ({batch} images, bf16)")
        errs = []
        with held_against_plain(FA, "fused_block", FA.fused_block_reference, errs):
            ek = ext(pbf, xs[0], cams[0])
        with kernel_impl("plain"):
            ep = ext(pbf, xs[0], cams[0])
    finally:
        set_fast_softmax(False)
    worst = max((rel for _, rel in errs), default=float("inf"))
    say(f"  {len(errs)} block calls of one batch (11 blocks, the full-sequence 12th, the JPM "
        f"block), each against its plain version: worst rel {worst:.3e} (tol {TOL[bf]:.0e}) "
        f"{'ok' if worst <= TOL[bf] else 'FAIL'}")
    if len(errs) != mcfg.clip.vision.layers + 1 or worst > TOL[bf]:
        raise PhaseFailed("the JPM serving blocks disagree with their plain version")
    cos = float(F.cosine_similarity(ek.float(), ep.float(), dim=-1).min())
    say(f"  bf16 JPM + SIE embeddings, kernels vs plain path: least cosine {cos:.6f} (tol 0.99, "
        f"as for IVLP serving) {'ok' if cos >= 0.99 else 'FAIL'}")
    if cos < 0.99:
        raise PhaseFailed("the bf16 JPM kernel path disagrees with the plain path")
    width = 2 * mcfg.clip.vision.width + mcfg.clip.embed_dim  # 2048 for ViT-B/16
    bad = [tuple(o.shape) for o in outs if o.shape != (batch, width)
           or not torch.isfinite(o).all()]
    if bad:
        raise PhaseFailed(f"JPM embeddings not finite / not {width} wide: {bad[:3]}")
    require("JPM + SIE serving", launches, BLOCK_KERNELS)
    by_path["jpm_sie_serve"] = launches
    numbers["jpm_sie_emb_s"] = emb_s
    del params, pbf, xs, outs, ext
    torch.cuda.empty_cache()
    by_path.update(variant_cli_phase(counters))
    return by_path, numbers


def variant_cli_phase(counters):
    """The prompt-learning CLI on the synthetic Market1501 directory at full
    width, one epoch per stage, bf16, --rerank: --training_mode maple, and
    --training_mode coop --jpm --sie_camera --augmented_prompts."""
    import tempfile

    from tpu_reid_torch.cli import prompt_learning as pl_cli
    from tpu_reid_torch.models.tokenizer import write_test_merges
    from tpu_reid_torch.weights.convert import random_clip_state_dict

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        nq, ng = write_market_dir(tmp)
        ckpt = os.path.join(tmp, "vit_b16_random.pth")
        torch.save({k: torch.from_numpy(v) for k, v in random_clip_state_dict(0).items()}, ckpt)
        merges = os.path.join(tmp, "merges.txt")
        write_test_merges(merges, [("p", "e"), ("r", "s"), ("o", "n</w>"), ("n", "o")])
        common = ["--root", tmp, "--model_path", ckpt, "--bpe_path", merges,
                  "--epochs_stage1", "1", "--epochs_stage2", "1", "--rerank", "--dtype", "bf16",
                  "--height", "256", "--ratio", "0.5", "--stride", "12", "--bs", "64",
                  "--train_dataset", "market1501", "--save_path", os.path.join(tmp, "ckpt")]
        for name, extra, needs in (
                ("maple_cli", ["--training_mode", "maple"], ("ln_proj_tail",)),
                ("jpm_sie_cli", ["--training_mode", "coop", "--jpm", "--sie_camera",
                                 "--augmented_prompts"], ())):
            say("prompt-learning CLI: python -m tpu_reid_torch.cli.prompt_learning "
                + " ".join(common[6:] + extra) + f" (256 training, {nq} query, {ng} gallery)")
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            cmc, mAP = pl_cli.main(common + extra)
            torch.cuda.synchronize()
            launches = runs[name] = launched(counters)
            say(f"  {name} run {time.perf_counter() - t0:.1f} s: Rank-1 {cmc[0]:.4f}, mAP "
                f"{mAP:.4f}; launches {launches}")
            require(name, launches, BLOCK_KERNELS + ("minsum",) + needs)
            if not np.isfinite(cmc).all() or not 0.0 < mAP <= 1.0:
                raise PhaseFailed(f"{name} result out of range: mAP {mAP}")
    return runs


# ---------------------------------------------------------------------------
# phase 15: the device-resident training input: a DeviceImageCache at
# Market-1501 scale, the cached epochs as CUDA-graph replays against their
# eager counterparts, the guard on the graph path, device_prefetch, and
# --cache_device in both training CLIs
# ---------------------------------------------------------------------------

CACHE_STEPS = 6  # steps per epoch of each graph-against-eager comparison
CACHE_EPOCHS = 3  # the first holds the capture, the second is timed, the third traced
CACHE_TOL = 2e-2


def _write_identity(args):
    """One identity's JPEGs of write_market_scale_dir (a pool worker)."""
    from PIL import Image

    base_dir, pid, test, n_train, seed, mix = args
    rng = np.random.default_rng([seed, pid])
    base = rng.integers(0, 256, (16, 8, 3)).repeat(16, axis=0).repeat(16, axis=1)
    noise = rng.integers(0, 256, (2 if test else n_train, 256, 128, 3), dtype=np.uint8)
    imgs = (mix * base + (1 - mix) * noise.astype(np.float32)).astype(np.uint8)
    for k, img in enumerate(imgs):
        if test:
            sub, cam = ("query", 1) if k == 0 else ("bounding_box_test", 2)
        else:
            sub, cam = "bounding_box_train", 1 + k % 6
        Image.fromarray(img).save(
            os.path.join(base_dir, sub, f"{pid:04d}_c{cam}s1_{k:06d}_00.jpg"), quality=90)


def write_market_scale_dir(root, n_train_ids=751, n_train=17, n_test_ids=750, seed=5, mix=0.45):
    """A Market1501-layout directory at Market-1501's training scale: n_train_ids
    identities x n_train 256x128 training JPEGs (751 x 17 = 12,767; the real
    split has 12,936), and n_test_ids test identities with one query and one
    gallery image each (Market's identity numbers end at 1501). As
    write_market_dir's images (a blocky base per identity plus noise), each
    identity drawn from a generator of its own, on a pool of processes (the
    pool touches no CUDA)."""
    import concurrent.futures as cf
    import multiprocessing as mp

    base_dir = os.path.join(root, "Market1501")
    for sub in ("bounding_box_train", "query", "bounding_box_test"):
        os.makedirs(os.path.join(base_dir, sub))
    jobs = [(base_dir, pid, pid <= n_test_ids, n_train, seed, mix)
            for pid in range(1, n_test_ids + n_train_ids + 1)]
    with cf.ProcessPoolExecutor(min(8, os.cpu_count() or 1),
                                mp_context=mp.get_context("fork")) as pool:
        list(pool.map(_write_identity, jobs, chunksize=32))
    return n_train_ids * n_train


class LossLog:
    """A guard that keeps no snapshot: the loss pipeline hands it every
    step's loss as the host reads it; `times` are those moments."""

    def __init__(self):
        self.losses, self.times = [], []

    def will_snapshot(self, step):
        return False

    def maybe_snapshot(self, step, *state):
        pass

    def check(self, loss, *state):
        self.losses.append(float(loss))
        self.times.append(time.perf_counter())
        return state, True

    def ms_per_step(self, first, last=-1):
        """Host ms per step between the reads of steps `first` and `last`."""
        last %= len(self.times)
        return 1e3 * (self.times[last] - self.times[first]) / (last - first)


class CapturedLaunches:
    """The kernel launches of one captured step, from the Python counters
    around each capture (train/step_graph.CAPTURE_HOOKS); replays launch
    no Python, so a graph path's launches are these times its replays."""

    def __init__(self, counters):
        self.counters = counters
        self.per_step = []

    def __enter__(self):
        from tpu_reid_torch.train import step_graph

        step_graph.CAPTURE_HOOKS.append(self.hook)
        return self

    def __exit__(self, *exc):
        from tpu_reid_torch.train import step_graph

        step_graph.CAPTURE_HOOKS.remove(self.hook)

    def hook(self, when):
        now = launched(self.counters)
        if when == "before":
            self._before = now
        else:
            self.per_step.append({k: now[k] - self._before[k] for k in now})


class EpochTrace:
    """A run's `log`: the profiler runs from the second epoch's log line to
    the third's (the third epoch, ending with its loss read); `report`
    gives the device's busy share of that window and its kernels."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.marks = []

    def __call__(self, _msg):
        self.marks.append(time.perf_counter())
        if len(self.marks) == 2:
            self.prof.start()
        elif len(self.marks) == 3:
            torch.cuda.synchronize()
            self.prof.stop()

    def report(self, label):
        if len(self.marks) != 3:
            raise PhaseFailed(f"{label}: expected three epochs, logged {len(self.marks)}")
        return report_trace(device_events(self.prof), 1e6 * (self.marks[2] - self.marks[1]),
                            label, top=6)


def held(got, want, got_losses, want_losses, paths_of):
    """(bit-equal, losses' max|d| / max|want|, the leaves' worst rel, its path)
    of two runs' per-step losses and final leaves (paths_of(tree) -> [(path,
    tensor)])."""
    if len(got_losses) != len(want_losses) or not got_losses:
        raise PhaseFailed(f"{len(got_losses)} losses against {len(want_losses)}")
    lg, lw = np.asarray(got_losses), np.asarray(want_losses)
    loss_rel = float(np.abs(lg - lw).max() / np.abs(lw).max()) if np.isfinite(lg).all() \
        else float("inf")
    worst, worst_path, equal = 0.0, None, bool((lg == lw).all())
    gp = dict(paths_of(got))
    for path, t in paths_of(want):
        _, rel = rel_err(gp[path], t)
        equal = equal and torch.equal(gp[path], t)
        if rel > worst:
            worst, worst_path = rel, "/".join(path)
    return equal, loss_rel, worst, worst_path


def compare_runs(label, graph, eager, g_losses, e_losses, paths_of, eager_again):
    """A graph path's per-step losses and final leaves against its eager
    counterpart's (both with the same capturable Adam): bit-equal, or each
    within CACHE_TOL of max|eager|. When they differ, eager_again() runs the
    eager path once more, to tell the graph from the eager path's own
    run-to-run variation."""
    equal, loss_rel, worst, worst_path = held(graph, eager, g_losses, e_losses, paths_of)
    ok = loss_rel <= CACHE_TOL and worst <= CACHE_TOL
    msg = (f"  {label}: graph against eager over {len(g_losses)} steps: "
           + ("bit-equal (every loss and leaf)" if equal else
              f"losses rel {loss_rel:.3e}, leaves worst rel {worst:.3e} at {worst_path} (tol "
              f"{CACHE_TOL:.0e})"))
    out = {"bit_equal": equal, "loss_rel": loss_rel, "leaf_rel": worst}
    if not equal:
        again, again_losses = eager_again()
        e2 = held(again, eager, again_losses, e_losses, paths_of)
        out["eager_again"] = {"bit_equal": e2[0], "loss_rel": e2[1], "leaf_rel": e2[2]}
        msg += ("; the eager path run again: " + ("bit-equal to its first run, so the graph "
                "is the difference" if e2[0] else
                f"losses rel {e2[1]:.3e}, leaves worst rel {e2[2]:.3e} at {e2[3]} against its "
                f"first run: the eager path itself varies from run to run (the order of "
                f"atomic additions in the backward), the graph no more than that"
                if e2[1] >= loss_rel / 10 else
                f"losses rel {e2[1]:.3e} against its first run, less than the graph's"))
    say(msg + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed(f"{label}: the graph path disagrees with the eager one")
    return out


PRIMITIVE_KERNELS = ("ln_gemm", "mha_core", "gemm_bias_residual", "ln_proj_tail")


def graph_against_eager(label, graph_run, eager_run, paths_of, counters, needs=()):
    """Both runs (run(log, guard) -> params, CACHE_EPOCHS epochs of
    CACHE_STEPS steps): ms per step over the second epoch (the first holds
    the capture), a trace of the third, peak memory, capture seconds; every
    loss and the final leaves held graph against eager; one captured step
    must launch the block kernels and `needs`."""
    from tpu_reid_torch.train import step_graph

    out, res = {}, {}
    for kind, run in (("graph", graph_run), ("eager", eager_run)):
        rec, tr = LossLog(), EpochTrace()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n_hist = len(step_graph.history)
        with CapturedLaunches(counters) as cl:
            params = run(tr, rec)
        torch.cuda.synchronize()
        r = {"ms": rec.ms_per_step(CACHE_STEPS, 2 * CACHE_STEPS - 1),
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "losses": rec.losses}
        if kind == "graph":
            hist = step_graph.history[n_hist:]
            if len(hist) != 1 or len(cl.per_step) != 1:
                raise PhaseFailed(f"{label}: expected one captured step graph, got {hist}")
            r.update(capture_s=hist[0]["capture_s"], warmup_s=hist[0]["warmup_s"],
                     replays=hist[0]["replays"],
                     launches={k: v * hist[0]["replays"] for k, v in cl.per_step[0].items()})
            require(f"{label} (one captured step)", cl.per_step[0], BLOCK_KERNELS + needs)
        say(f"  {label} {kind}: {r['ms']:.2f} ms per step (the second epoch, by the host's "
            f"reads of the losses), peak memory {r['peak_gib']:.2f} GiB"
            + (f", warm-up {r['warmup_s']:.2f} s, capture {r['capture_s']:.3f} s, "
               f"{r['replays']} replays" if kind == "graph" else ""))
        r["trace"] = tr.report(f"the third epoch of the {label} {kind} run "
                               f"({CACHE_STEPS} steps)")
        if r["trace"] is None and kind == "graph":
            raise PhaseFailed(f"{label}: the trace of the graph's replays holds no kernel")
        out[kind], res[kind] = params, r
        del params

    def eager_again():
        rec = LossLog()
        return eager_run(lambda s: None, rec), rec.losses

    res["held"] = compare_runs(label, out["graph"], out["eager"], res["graph"]["losses"],
                               res["eager"]["losses"], paths_of, eager_again)
    del out
    per_step = sum(v for k, v in res["graph"]["launches"].items() if k in PRIMITIVE_KERNELS)
    per_step /= max(res["graph"]["replays"], 1)
    seen = res["graph"]["trace"]["kernels"] / CACHE_STEPS
    res["graph"]["trace"]["shows_kernels"] = shows = seen >= per_step
    say(f"  the graph's trace: {seen:.0f} kernels on the card per replay, against "
        f"{per_step:.0f} launches of the port's kernels in one captured step: "
        + ("the trace shows the graph's own kernels, not only its launch" if shows else
           "the trace shows fewer kernels than the graph holds"))
    return res


def trainable_paths(pred):
    from tpu_reid_torch.train import optim as O

    def paths_of(tree):
        return [(p, t) for p, t in O.paths(tree) if t is not None
                and (pred(p) or p[-1] in ("mean", "var"))]
    return paths_of


def cache_phase(dev, counters, bs=64):
    """The device-resident training input at full ViT-B/16 width."""
    import tempfile

    from tpu_reid_torch.data.datasets import get_dataset
    from tpu_reid_torch.data.device_cache import DeviceImageCache
    from tpu_reid_torch.data.loader import BatchLoader
    from tpu_reid_torch.data.sampler import PKSampler
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.train import trainer as TR

    report, runs = {}, {}
    bf = torch.bfloat16
    tcfg = TR.TrainConfig()
    pp = DevicePreprocess((256, 128), "vit", dtype=bf)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        n_train = write_market_scale_dir(tmp)
        ds = get_dataset(tmp, "market1501")
        say(f"cache: a Market1501 directory of {n_train} training JPEGs at 256x128 "
            f"({ds.num_train_pids} identities x 17) and 750 + 750 test JPEGs (one query and "
            f"one gallery image per test identity: cut from Market's 3368 / 15913, the "
            f"phase reads only the training split) written in {time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        cache = DeviceImageCache(ds.train, (256, 128), device=dev)
        upload_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        mib = cache.nbytes() / 2**20
        say(f"  DeviceImageCache: {cache.n} images, {mib:.1f} MiB on the card, decode + upload "
            f"{upload_s:.2f} s ({cache.nbytes() / upload_s / 1e9:.2f} GB/s of uint8 rows), "
            f"peak memory of the build {peak:.1f} MiB (the split itself: preallocated, no "
            f"second copy)")
        if peak > mib * 1.05:
            raise PhaseFailed(f"the cache build peaked at {peak:.1f} MiB for {mib:.1f} MiB")
        report["cache"] = {"n": cache.n, "mib": mib, "upload_s": upload_s, "peak_mib": peak}

        labels = [r[1] for r in ds.train]
        order = list(PKSampler(labels, bs, 4, seed=0).epoch())[:4]
        for hb, (sel, pids, camids, valid) in zip(
                BatchLoader(ds.train, bs, (256, 128), order=iter(order)),
                cache.epoch_index_batches(order, bs)):
            got = cache.gather(sel).cpu().numpy()
            if not (np.array_equal(hb.images[valid], got[valid])
                    and np.array_equal(hb.pids, pids) and np.array_equal(hb.valid, valid)
                    and np.array_equal(hb.camids, camids)):
                raise PhaseFailed("a cache gather differs from BatchLoader's rows")
        idx = torch.as_tensor(order[0], device=dev)
        gather_ms = time_ms(lambda: cache.gather(idx))
        say(f"  the gathers of 4 PK batches of {bs} equal BatchLoader's valid rows, pids, "
            f"camids and valid bit for bit; gather {gather_ms:.4f} ms per {bs}-row batch "
            f"({bs * 256 * 128 * 3 * 2 / gather_ms / 1e6:.1f} GB/s read + written)")
        report["cache"]["gather_ms"] = gather_ms

        def order2(epoch):
            pk = PKSampler(labels, bs, 4, seed=epoch).epoch()
            return list(cache.epoch_index_batches(pk, bs))[:CACHE_STEPS]

        def gen2(epoch):
            return torch.Generator(device=dev).manual_seed(10_000 + epoch)

        def host2(epoch):
            g = gen2(epoch)
            for sel, pids, _c, valid in order2(epoch):
                yield pp.train_batch(cache.gather(sel), pp.train_draws(g, bs)), pids, valid

        mcfg, params = flagship(dev)
        say(f"stage 2 of the IVLP flagship (751 classes, 213 tokens) at bs {bs} (PK "
            f"{bs // 4}x4), bf16 activations over fp32 master weights, {CACHE_EPOCHS} epochs x "
            f"{CACHE_STEPS} steps: run_stage2_cached (a CUDA graph per step) against "
            f"run_stage2 fed the same gathers and draws")
        report["stage2"] = graph_against_eager(
            "stage 2",
            lambda log, g: TR.run_stage2_cached(params, mcfg, tcfg, cache, order2, pp, gen2,
                                                epochs=CACHE_EPOCHS, log=log, guard=g),
            lambda log, g: TR.run_stage2(params, mcfg, tcfg, host2, epochs=CACHE_EPOCHS,
                                         log=log, guard=g),
            trainable_paths(lambda p: M.stage2_trainable(p, mcfg)), counters,
            needs=("ln_proj_tail",))
        runs["cache_stage2"] = report["stage2"]["graph"]["launches"]

        def order1(epoch):
            perm = np.random.default_rng(epoch).permutation(cache.n)[:CACHE_STEPS * bs]
            return cache.epoch_index_batches(perm, bs, drop_tail=True)

        def host1(epoch):
            for sel, pids, _c, valid in order1(epoch):
                yield pp.eval_batch(cache.gather(sel)), pids, valid

        say(f"live IVLP stage 1, the same model and batch: run_stage1_live_cached (graph) "
            f"against run_stage1 on the same gathers")
        report["stage1_live"] = graph_against_eager(
            "live stage 1",
            lambda log, g: TR.run_stage1_live_cached(params, mcfg, tcfg, cache, order1, pp,
                                                     epochs=CACHE_EPOCHS, log=log, guard=g),
            lambda log, g: TR.run_stage1(params, mcfg, tcfg, host1, epochs=CACHE_EPOCHS,
                                         batch_size=bs, log=log, guard=g),
            trainable_paths(lambda p: M.stage1_trainable(p, mcfg)), counters,
            needs=("ln_proj_tail",))
        runs["cache_stage1_live"] = report["stage1_live"]["graph"]["launches"]
        report["guard"] = graph_guard(mcfg, params, cache, order1, pp, tcfg)
        report["prefetch"] = prefetch_effect(dev, mcfg, params, ds, pp, bs, tcfg)
        del params
        torch.cuda.empty_cache()

        coop, cparams = variant_model(dev, "coop")
        pre = [(pp.eval_batch(cache.gather(np.arange(i, i + bs))),
                torch.as_tensor(cache.pids[i:i + bs], device=dev), np.ones(bs, bool))
               for i in range(0, 8 * bs, bs)]

        def coop_order(epoch, n):
            perm = np.random.default_rng(epoch).permutation(n)
            return [perm[i * bs:(i + 1) * bs] for i in range(CACHE_STEPS)]

        say(f"cached coop stage 1 (ViT-B/16, 211 tokens, features of {8 * bs} cached images "
            f"precomputed): run_stage1 (a CUDA graph per step) against the same steps through "
            f"make_stage1_step(cached=True), eager")
        report["coop"] = graph_against_eager(
            "cached coop stage 1",
            lambda log, g: TR.run_stage1(cparams, coop, tcfg, lambda e: iter(pre),
                                         epochs=CACHE_EPOCHS, batch_size=bs, log=log, guard=g,
                                         cached_order=lambda e, lab: coop_order(e, len(lab))),
            lambda log, g: eager_coop_stage1(cparams, coop, tcfg, pre, coop_order, bs, log, g),
            trainable_paths(lambda p: M.stage1_trainable(p, coop)), counters)
        runs["cache_coop_stage1"] = report["coop"]["graph"]["launches"]
        del cparams, pre, cache
        torch.cuda.empty_cache()
    runs.update(cache_cli_phase(counters))
    return report, runs


def eager_coop_stage1(params, cfg, tcfg, pre, coop_order, bs, log, guard):
    """The cached coop stage 1 by hand: the same precompute, epochs, lr and
    index rows through make_stage1_step(cached=True), each step eager, the
    losses read one step late as the runners do."""
    from tpu_reid_torch.train import optim as O
    from tpu_reid_torch.train import trainer as TR

    feats, labels = TR.precompute_image_features(params, cfg, iter(pre))
    tr, fr = O.partition(params, lambda p: TR.M.stage1_trainable(p, cfg))
    tr = TR._trainable_copy(tr)
    opt = O.make_stage_optimizer(tr, tcfg.lr_stage1, tcfg.weight_decay,
                                 capturable=feats.is_cuda)
    step = TR.make_stage1_step(cfg, opt, cached=True)
    state = TR._TrainState(tr, opt)
    pipe = TR.LossPipeline(guard, state.get, state.set)
    valid = torch.ones(bs, dtype=torch.bool, device=feats.device)
    gstep = 0
    for epoch in range(1, CACHE_EPOCHS + 1):
        O.set_lr(opt, TR.S.cosine_warmup_lr(epoch, tcfg.lr_stage1, CACHE_EPOCHS))
        for sel in coop_order(epoch, labels.shape[0]):
            idx = torch.as_tensor(sel, device=feats.device)
            batch = {"image_features": feats[idx], "labels": labels[idx], "valid": valid}
            pipe.before_step(gstep)
            gstep += 1
            pipe.after_step(step(tr, fr, batch), redo=lambda b=batch: step(tr, fr, b))
        losses = pipe.drain_epoch()
        log(f"[stage1] epoch {epoch}/{CACHE_EPOCHS} loss {np.mean(losses):.4f}")
    return O.combine(TR._detached(tr), fr)


def graph_guard(mcfg, params, cache, order1, pp, tcfg):
    """The guard on the graph path: live IVLP stage 1, one epoch of
    CACHE_STEPS replays, a snapshot every 2 steps; right after the snapshot
    of step 2 a trained leaf is set to inf in place, so step 2's loss is not
    finite. The guard rolls back: every state tensor keeps its address, the
    restored leaves equal the snapshot bit for bit, and the losses that
    follow are finite."""
    from tpu_reid_torch.runtime.guard import TrainGuard, _to_host
    from tpu_reid_torch.train import trainer as TR

    class PoisonGuard(TrainGuard):
        def __init__(self):
            super().__init__(snapshot_every=2, max_restores=1, log=say)
            self.ptrs, self.losses, self.restored_equal = [], [], None

        def _ptrs(self, state):
            out = []
            for s in state:
                out += [t.data_ptr() for t in _tensors(s)]
            self.ptrs.append(out)

        def maybe_snapshot(self, step, *state):
            super().maybe_snapshot(step, *state)
            self._ptrs(state)
            if step == 2:
                with torch.no_grad():
                    state[0]["clip"]["visual"]["vpt_shallow"].fill_(float("inf"))

        def check(self, loss, *state):
            self.losses.append(float(loss))
            out, ok = super().check(loss, *state)
            self._ptrs(out)
            if not ok:
                snap = self._snap[1]
                self.restored_equal = all(
                    torch.equal(a, b) for s_live, s_snap in zip(_to_host(out), snap)
                    for a, b in zip(_tensors(s_live), _tensors(s_snap)))
            return out, ok

    guard = PoisonGuard()
    TR.run_stage1_live_cached(params, mcfg, tcfg, cache, order1, pp, epochs=1, guard=guard,
                              log=lambda s: None)
    after = guard.losses[guard.losses.index(next(v for v in guard.losses
                                                  if not np.isfinite(v))) + 1:]
    same_ptrs = all(p == guard.ptrs[0] for p in guard.ptrs)
    ok = (guard.restores == 1 and guard.restored_equal and same_ptrs and after
          and np.isfinite(after).all())
    say(f"  guard on the graph path: a trained leaf set to inf after the snapshot of step 2; "
        f"losses {', '.join(f'{v:.4f}' for v in guard.losses)}; {guard.restores} rollback, "
        f"restored leaves and Adam state equal the snapshot bit for bit: "
        f"{guard.restored_equal}; every state tensor's address unchanged over "
        f"{len(guard.ptrs)} snapshots and checks: {same_ptrs}; the {len(after)} losses after "
        f"it finite {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("the guard did not roll the graph path back in place")
    return {"restores": guard.restores, "losses": guard.losses}


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def prefetch_effect(dev, mcfg, params, ds, pp, bs, tcfg):
    """run_stage2 of the flagship on 6 PK batches from BatchLoader (host
    decode, the image copy to the card and the train transform in the
    batch source, as the CLI's), through device_prefetch on its copy stream
    (depth 2) against depth 0 (synchronous, the default stream): the same
    losses, and ms per step."""
    from tpu_reid_torch.data.loader import BatchLoader
    from tpu_reid_torch.data.sampler import PKSampler
    from tpu_reid_torch.parallel import prefetch as PF
    from tpu_reid_torch.train import trainer as TR

    labels = [r[1] for r in ds.train]

    def batches(epoch):
        gen = torch.Generator(device=dev).manual_seed(10_000 + epoch)
        order = list(PKSampler(labels, bs, 4, seed=epoch).epoch())[:CACHE_STEPS]
        for b in BatchLoader(ds.train, bs, (256, 128), order=iter(order)):
            images = torch.as_tensor(b.images).to(dev)
            yield pp.train_batch(images, pp.train_draws(gen, bs)), b.pids, b.valid

    res = {}
    for name, depth in (("depth 2", 2), ("depth 0", 0), ("depth 2 again", 2)):
        rec = LossLog()
        TR.device_prefetch = lambda src, place, depth=depth: PF.device_prefetch(src, place, depth)
        try:
            TR.run_stage2(params, mcfg, tcfg, batches, epochs=1, log=lambda s: None, guard=rec)
        finally:
            TR.device_prefetch = PF.device_prefetch
        res[name] = {"ms": rec.ms_per_step(0), "losses": rec.losses}
    same = res["depth 2"]["losses"] == res["depth 0"]["losses"] == res["depth 2 again"]["losses"]
    say(f"  device_prefetch on {CACHE_STEPS} stage-2 batches from BatchLoader: "
        + ", ".join(f"{k} {v['ms']:.2f} ms per step" for k, v in res.items())
        + f"; losses equal: {same} {'ok' if same else 'FAIL'}")
    if not same:
        raise PhaseFailed("the prefetched stage 2 differs from the synchronous one")
    return res


def cache_cli_phase(counters):
    """Both training CLIs on a synthetic Market1501 (and VeRi) directory at
    full width, each with --cache_device against the same command without
    it (mAP within 1e-5), then the cached prompt-learning command with
    --resume."""
    import tempfile

    from tpu_reid_torch.cli import multitask as mt_cli
    from tpu_reid_torch.cli import prompt_learning as pl_cli
    from tpu_reid_torch.models.tokenizer import write_test_merges
    from tpu_reid_torch.weights.convert import random_clip_state_dict

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_market_dir(tmp)
        write_veri_dir(tmp, n_ids=16, mix=0.2)
        ckpt = os.path.join(tmp, "vit_b16_random.pth")
        torch.save({k: torch.from_numpy(v) for k, v in random_clip_state_dict(0).items()}, ckpt)
        merges = os.path.join(tmp, "merges.txt")
        write_test_merges(merges, [("p", "e"), ("r", "s"), ("c", "a"), ("ca", "r</w>")])
        common = ["--root", tmp, "--model_path", ckpt, "--bpe_path", merges, "--dtype", "bf16",
                  "--height", "256", "--ratio", "0.5", "--stride", "12", "--bs", "64",
                  "--epochs_stage1", "1", "--epochs_stage2", "1", "--train_dataset", "market1501"]
        cases = (("ivlp", pl_cli, ["--training_mode", "ivlp"]),
                 ("coop", pl_cli, ["--training_mode", "coop"]),
                 ("multitask hard_ivlp", mt_cli,
                  ["--variant", "hard_ivlp", "--train_dataset_multitask", "veri",
                   "--height_multitask", "256", "--ratio_multitask", "1.0"]))
        for name, cli, extra in cases:
            maps = {}
            for flag in ((), ("--cache_device",)):
                save = os.path.join(tmp, "ckpt", name.replace(" ", "_") + "".join(flag))
                argv = common + extra + list(flag) + ["--save_path", save]
                for c in counters.values():
                    c.launches = 0
                t0 = time.perf_counter()
                _, maps[flag] = cli.main(argv)
                torch.cuda.synchronize()
                say(f"  {name} CLI{' --cache_device' if flag else ''}: "
                    f"{time.perf_counter() - t0:.1f} s, mAP {maps[flag]:.6f}; launches outside "
                    f"the graphs {launched(counters)}")
            d = abs(maps[()] - maps[("--cache_device",)])
            say(f"  {name}: --cache_device mAP against the loader path's: |d| {d:.1e} (tol "
                f"1e-5) {'ok' if d <= 1e-5 else 'FAIL'}")
            if d > 1e-5:
                raise PhaseFailed(f"{name}: --cache_device changes the mAP by {d:.3e}")
            runs[f"{name.replace(' ', '_')}_cache_cli"] = launched(counters)
            if name == "ivlp":
                resume_cli(pl_cli, argv, os.path.join(save, "ivlp", "market1501"), 2,
                           maps[("--cache_device",)])
    return runs


# ---------------------------------------------------------------------------
# phase 16: data parallelism over ranks (parallel/mesh.py, parallel/launch.py)
# in NCCL worlds of one rank on the one card, each against its single-device
# path. A world of more ranks needs more cards: the cross-rank behaviour is
# held on the CPU over gloo (tests/test_torch_sharded_*.py).
# ---------------------------------------------------------------------------


def nccl_world(dev):
    """An NCCL world of one rank on `dev`, started here and destroyed on the
    way out; yields its mesh."""
    from tpu_reid_torch.parallel import launch

    return launch.process_group(str(dev), f"tcp://127.0.0.1:{launch.free_port()}", 0, 1)


def rank_clock(mesh):
    """A rank's wall clock after its world's first collective (the spawn and
    rendezvous probe of multidevice_phase)."""
    from tpu_reid_torch.parallel.mesh import agree

    agree(mesh, True, "a flag")
    return time.time()


def adam_bound(lrs):
    """The most an Adam update of these learning rates moves a leaf (each
    step moves it by at most ~lr), doubled: 2 x sum(lr)."""
    return 2.0 * float(sum(lrs))


def sharded_serving(dev, counters, mcfg, params, k_batches=4, batch=512):
    """The flagship at bench.py's profile through extract_embeddings over a
    one-rank mesh against the same sweep without one: the features
    (bit-equal expected), emb/s of both in turns (single, mesh, mesh,
    single)."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.ops.attention import set_fast_softmax
    from tpu_reid_torch.parallel.extract import extract_embeddings, make_extractor

    bf = torch.bfloat16
    pbf = _cast(params, bf)
    fold = lambda p: M.fold_input_norm(p, mcfg, "vit")  # noqa: E731
    embed = lambda p, im: M.eval_embed(p, mcfg, im)  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [SimpleNamespace(images=torch.randint(0, 255, (batch, 256, 128, 3),
                                                    dtype=torch.uint8, device=dev,
                                                    generator=gen),
                               pids=np.arange(batch), camids=np.zeros(batch, np.int64),
                               seqids=np.zeros(batch, np.int64), valid=np.ones(batch, bool))
               for _ in range(k_batches)]
    out, secs = {}, {"single": [], "mesh": []}
    set_fast_softmax(True)
    try:
        with nccl_world(dev) as mesh:
            runs = {"single": (None, make_extractor(embed, DevicePreprocess(
                        (256, 128), "vit", dtype=bf), flip_tta=False, dtype=bf, fold=fold,
                        device=dev)),
                    "mesh": (mesh, make_extractor(embed, DevicePreprocess(
                        (256, 128), "vit", dtype=bf), flip_tta=False, dtype=bf, fold=fold,
                        mesh=mesh))}
            for kind in ("single", "mesh", "mesh", "single"):
                m, ext = runs[kind]
                extract_embeddings(ext, pbf, batches[:1], device=dev, mesh=m)  # warm-up
                torch.cuda.synchronize()
                if kind == "mesh":
                    for c in counters.values():
                        c.launches = 0
                t0 = time.perf_counter()
                f, *_ = extract_embeddings(ext, pbf, batches, device=dev, mesh=m)
                torch.cuda.synchronize()
                secs[kind].append(time.perf_counter() - t0)
                if kind == "mesh" and "launches" not in out:
                    out["launches"] = launched(counters)
                out.setdefault(kind, f)
    finally:
        set_fast_softmax(False)
    n = k_batches * batch
    emb_s = {k: n / min(v) for k, v in secs.items()}
    equal = torch.equal(out["single"], out["mesh"])
    err, rel = rel_err(out["mesh"], out["single"])
    width = mcfg.clip.vision.width + mcfg.clip.embed_dim  # 1280 at ViT-B/16
    ok = out["mesh"].shape == (n, width) and bool(torch.isfinite(out["mesh"]).all()) and (
        equal or rel <= TOL[bf])
    say(f"  sharded extractor (IVLP flagship, {k_batches} batches of {batch}, bf16, fast "
        f"softmax, folded norm): one-rank mesh {emb_s['mesh']:.1f} emb/s, single device "
        f"{emb_s['single']:.1f} emb/s (best of 2 each, in turns); features "
        + ("bit-equal" if equal else f"NOT bit-equal: max|d| {err:.3e}, rel {rel:.3e} (tol "
           f"{TOL[bf]:.0e})") + f" {'ok' if ok else 'FAIL'}")
    say(f"    launches in the mesh sweep: {out['launches']}")
    if not ok:
        raise PhaseFailed("the sharded extractor disagrees with the single-device one")
    require("the sharded extractor", out["launches"], BLOCK_KERNELS + ("ln_proj_tail",))
    return out["launches"], emb_s


def sharded_steps(dev, counters, mcfg, params, bs=64, rounds=6, k=2):
    """Live stage-1 and stage-2 steps of the flagship at bs 64 with mesh= (a
    one-rank NCCL world) against the same steps without one, on the same
    inputs: a warm-up step each, then `rounds` blocks of k steps per side
    in alternating order (single, mesh / mesh, single), each block timed
    with CUDA events. Per-step losses and final leaves (bit-equal, or the
    leaves within the Adam bound 2 x sum(lr)); ms per step of both, the
    median of the blocks and their range."""
    import functools
    import statistics

    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.parallel.mesh import shard_batch
    from tpu_reid_torch.train import optim as O
    from tpu_reid_torch.train import trainer as TR

    bf = torch.bfloat16
    tcfg = TR.TrainConfig()
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randint(0, 255, (bs, 256, 128, 3), dtype=torch.uint8, device=dev,
                           generator=gen)
    labels = torch.as_tensor(np.repeat(np.random.RandomState(1).choice(
        mcfg.n_cls, bs // 4, replace=False), 4), device=dev)
    valid = torch.ones(bs, dtype=torch.bool, device=dev)
    pp = DevicePreprocess((256, 128), "vit", dtype=bf)
    imgs1 = pp.eval_batch(images)
    imgs2 = pp.train_batch(images, pp.train_draws(gen, bs))
    with torch.no_grad():
        text = M.all_class_text_features(params, mcfg)
    n = 1 + rounds * k  # steps per side
    report, launches = {}, {}
    with nccl_world(dev) as mesh:
        for stage, pred, lr in (("stage-1 live", M.stage1_trainable, tcfg.lr_stage1),
                                ("stage-2", M.stage2_trainable, tcfg.lr_stage2)):
            sides = {}
            for kind, m in (("single", None), ("mesh", mesh)):
                tr, fr = O.partition(params, lambda p: pred(p, mcfg))
                tr = TR._trainable_copy(tr)
                if stage == "stage-1 live":
                    opt = O.make_stage_optimizer(tr, lr, tcfg.weight_decay)
                    step = TR.make_stage1_step(mcfg, opt, cached=False, mesh=m)
                    batch = {"images": imgs1 if m is None else shard_batch(m, imgs1),
                             "labels": labels, "valid": valid}
                    call = functools.partial(step, tr, fr, batch)
                else:
                    fr = TR._bn_state(fr, mcfg)[0]
                    opt = O.make_stage_optimizer(tr, lr, tcfg.weight_decay, bias_lr_mult=2.0)
                    step = TR.make_stage2_step(mcfg, tcfg, opt, mesh=m)
                    x = imgs2 if m is None else shard_batch(m, imgs2)
                    call = functools.partial(step, tr, fr, x, labels, text, valid)
                sides[kind] = (tr, fr, call, [call()])  # the warm-up step
            torch.cuda.synchronize()
            ms = {"single": [], "mesh": []}
            for r in range(rounds):
                for kind in ("single", "mesh") if r % 2 == 0 else ("mesh", "single"):
                    call, losses = sides[kind][2:]
                    counted = kind == "mesh" and stage not in launches
                    if counted:
                        for c in counters.values():
                            c.launches = 0
                    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    t0.record()
                    for _ in range(k):
                        losses.append(call())
                    t1.record()
                    t1.synchronize()
                    if counted:
                        launches[stage] = launched(counters)
                    ms[kind].append(t0.elapsed_time(t1) / k)
            res = {kind: (O.combine(tr, fr), [float(v) for v in losses], ms[kind])
                   for kind, (tr, fr, _, losses) in sides.items()}
            del sides
            got, want = res["mesh"], res["single"]
            paths_of = trainable_paths(lambda p: pred(p, mcfg))
            equal, loss_rel, worst, worst_path = held(got[0], want[0], got[1], want[1],
                                                      paths_of)
            gp = dict(paths_of(got[0]))
            max_d = max(float((gp[p] - t).detach().abs().max()) for p, t in paths_of(want[0]))
            bound = adam_bound([lr] * n)
            ok = equal or (loss_rel <= CACHE_TOL and max_d <= bound)
            med = {kind: statistics.median(v[2]) for kind, v in res.items()}
            say(f"  {stage} steps at bs {bs} (bf16), CUDA events over {rounds} blocks of {k} "
                f"steps per side in alternating order after a warm-up step: mesh median "
                f"{med['mesh']:.2f} ms per step (blocks {min(got[2]):.2f}-{max(got[2]):.2f}), "
                f"single device {med['single']:.2f} ms ({min(want[2]):.2f}-{max(want[2]):.2f}); "
                f"{n} losses " + ("and every leaf bit-equal" if equal else
                   f"rel {loss_rel:.3e}, leaves max|d| {max_d:.3e} (Adam bound {bound:.2e}), "
                   f"worst rel {worst:.3e} at {worst_path}") + f" {'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailed(f"the {stage} step over a mesh disagrees with one device")
            require(f"the {stage} step over a mesh", launches[stage], BLOCK_KERNELS)
            report[stage] = {"ms_mesh": med["mesh"], "ms_single": med["single"],
                             "ms_mesh_blocks": got[2], "ms_single_blocks": want[2],
                             "bit_equal": equal, "loss_rel": loss_rel, "leaf_max_d": max_d}
            del res, got, want
    return report, launches


def sharded_cached_epoch(dev, counters, mcfg, params, bs=64):
    """One run_stage2_cached epoch over a DeviceImageCache sharded over a
    one-rank mesh, which runs every step eagerly (no graph is captured),
    against the same epoch without a mesh (a CUDA graph per step)."""
    import tempfile

    from tpu_reid_torch.data.datasets import get_dataset
    from tpu_reid_torch.data.device_cache import DeviceImageCache
    from tpu_reid_torch.data.sampler import PKSampler
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.train import step_graph
    from tpu_reid_torch.train import trainer as TR

    tcfg = TR.TrainConfig()
    pp = DevicePreprocess((256, 128), "vit", dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        write_market_dir(tmp)
        ds = get_dataset(tmp, "market1501")
        labels = [r[1] for r in ds.train]

        def run(mesh, log):
            cache = DeviceImageCache(ds.train, (256, 128), device=dev, mesh=mesh)
            rec = LossLog()
            out = TR.run_stage2_cached(
                params, mcfg, tcfg, cache,
                lambda e: cache.epoch_index_batches(PKSampler(labels, bs, 4, seed=e).epoch(), bs),
                pp, lambda e: torch.Generator(device=dev).manual_seed(10_000 + e), epochs=1,
                log=log, guard=rec, mesh=mesh)
            torch.cuda.synchronize()
            return out, rec.losses

        n_hist = len(step_graph.history)
        t0 = time.perf_counter()
        want, want_losses = run(None, lambda s: None)
        t_graph = time.perf_counter() - t0
        captured = len(step_graph.history) - n_hist
        lines = []
        with nccl_world(dev) as mesh, CapturedLaunches(counters) as cl:
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            got, got_losses = run(mesh, lines.append)
            t_mesh = time.perf_counter() - t0
            launches = launched(counters)
    eager = (len(step_graph.history) == n_hist + captured and not cl.per_step
             and any("eagerly" in s for s in lines))
    paths_of = trainable_paths(lambda p: M.stage2_trainable(p, mcfg))
    equal, loss_rel, worst, worst_path = held(got, want, got_losses, want_losses, paths_of)
    ok = eager and captured == int(dev.type == "cuda") and (
        equal or (loss_rel <= CACHE_TOL and worst <= CACHE_TOL))
    say(f"  run_stage2_cached, one epoch of {len(got_losses)} steps at bs {bs}: over a "
        f"one-rank mesh {t_mesh:.2f} s, eager ({'no graph captured' if eager else 'A GRAPH'}"
        f"; the log says: {lines[0] if lines else 'nothing'}); without a mesh {t_graph:.2f} s "
        f"({captured} graph captured); losses and leaves "
        + ("bit-equal" if equal else f"losses rel {loss_rel:.3e}, leaves worst rel {worst:.3e} "
           f"at {worst_path} (tol {CACHE_TOL:.0e})") + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("run_stage2_cached over a mesh: not eager, or not the graph's result")
    require("run_stage2_cached over a mesh", launches, BLOCK_KERNELS)
    return launches


def sharded_rerank(dev):
    """The sharded streamed re-ranking at Market-1501 scale over a one-rank
    mesh (every pass, the gallery side of V_qe and t sharded; minsum on
    the rank's gallery slice) against the single-device route: the
    re-ranked distances of every query and the metrics; seconds of both
    (the best of two, in turns)."""
    from tpu_reid_torch.ops import minsum as MS
    from tpu_reid_torch.retrieval.distance import l2_normalize
    from tpu_reid_torch.retrieval.rerank_stream import k_reciprocal_rerank_streamed_rows

    feats = market_features(dev)
    qf, gf, qp, gp, qc, gc = feats
    qn, gn = l2_normalize(qf, axis=1), l2_normalize(gf, axis=1)

    def distances(mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        row_fn, q_chunk = k_reciprocal_rerank_streamed_rows(qn, gn, mesh=mesh)
        d = torch.cat([row_fn(s) for s in range(0, len(qp), q_chunk)])[:len(qp)]
        torch.cuda.synchronize()
        return d, time.perf_counter() - t0

    with nccl_world(dev) as mesh:
        # in turns (single, mesh, mesh, single): the first collective of a
        # world also builds its NCCL communicator
        want, t_single = distances(None)
        MS.minsum_kernel.launches = 0
        got, t_mesh = distances(mesh)
        launches = {"minsum": MS.minsum_kernel.launches}
        t_mesh = min(t_mesh, distances(mesh)[1])
        t_single = min(t_single, distances(None)[1])
        m_mesh = evaluate_market("sharded streamed route over a one-rank mesh", feats,
                                 reranking=True, rerank_mode="streamed", mesh=mesh)
    m_single = evaluate_market("streamed route on one device", feats, reranking=True,
                               rerank_mode="streamed")
    equal = torch.equal(got, want)
    err = float((got - want).abs().max())
    d_map = abs(m_mesh[1] - m_single[1])
    ok = err <= 1e-4 and d_map <= 1e-4 and launches["minsum"] > 0
    say(f"  sharded streamed re-ranking ({len(qp)} x {len(gp)}, D={qf.shape[1]}, bf16 V, fp8 "
        f"V_qe) over a one-rank mesh: {t_mesh:.3f} s, single device {t_single:.3f} s; "
        f"re-ranked distances of all {len(qp)} queries "
        + ("bit-equal" if equal else f"max|d| {err:.3e} (atol 1e-4: pass C's scatter_add_ "
           f"sums in the order of its atomics)") + f"; |dmAP| {d_map:.1e}; minsum launches "
        f"{launches['minsum']} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("the sharded streamed re-ranking disagrees with one device")
    del got, want
    return launches, {"mesh_s": t_mesh, "single_s": t_single}


def multihost_clis(counters):
    """The zero-shot and prompt-learning CLIs (ivlp, one epoch per stage) on
    the cli phase's synthetic Market1501 directory, each with --multihost
    127.0.0.1:<port> --num_hosts 1 --host_id 0 (an NCCL world of one rank
    in this process) against the same command without it; then --devices 2
    on this one-card host, which must raise and name the visible count."""
    import tempfile

    from tpu_reid_torch.cli import prompt_learning as pl_cli
    from tpu_reid_torch.cli import zero_shot as zs_cli
    from tpu_reid_torch.models.tokenizer import write_test_merges
    from tpu_reid_torch.parallel import launch
    from tpu_reid_torch.weights.convert import random_clip_state_dict

    runs, secs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        write_market_dir(tmp)
        ckpt = os.path.join(tmp, "vit_b16_random.pth")
        torch.save({k: torch.from_numpy(v) for k, v in random_clip_state_dict(0).items()}, ckpt)
        merges = os.path.join(tmp, "merges.txt")
        write_test_merges(merges, [("p", "e"), ("r", "s"), ("o", "n</w>"), ("n", "o")])
        common = ["--root", tmp, "--model_path", ckpt, "--bpe_path", merges, "--height", "256",
                  "--ratio", "0.5", "--stride", "12"]
        cases = (("zero_shot", zs_cli, ["--rerank", "--bs", "128",
                                        "--test_dataset", "market1501"]),
                 ("prompt_learning", pl_cli, ["--training_mode", "ivlp", "--epochs_stage1", "1",
                                              "--epochs_stage2", "1", "--rerank", "--dtype",
                                              "bf16", "--bs", "64",
                                              "--train_dataset", "market1501"]))
        for name, cli, extra in cases:
            maps = {}
            for kind in ("single", "multihost"):
                argv = common + extra + (["--save_path", os.path.join(tmp, kind)]
                                         if cli is pl_cli else [])
                if kind == "multihost":
                    argv += ["--multihost", f"127.0.0.1:{launch.free_port()}", "--num_hosts",
                             "1", "--host_id", "0"]
                for c in counters.values():
                    c.launches = 0
                t0 = time.perf_counter()
                _, maps[kind] = cli.main(argv)
                torch.cuda.synchronize()
                secs[f"{name}_{kind}"] = time.perf_counter() - t0
                if kind == "multihost":
                    runs[f"multihost_{name}_cli"] = launched(counters)
            d = abs(maps["multihost"] - maps["single"])
            ok = d <= 1e-5 and 0.0 < maps["single"] <= 1.0
            say(f"  {name} CLI with --multihost (NCCL, one rank): {secs[name + '_multihost']:.1f}"
                f" s, mAP {maps['multihost']:.6f}; without: {secs[name + '_single']:.1f} s, mAP "
                f"{maps['single']:.6f}; |d mAP| {d:.1e} (tol 1e-5: 0 expected; a training "
                f"backward sums in the order of its atomics) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailed(f"the {name} CLI with --multihost differs from one device")
            require(f"the {name} CLI with --multihost", runs[f"multihost_{name}_cli"],
                    BLOCK_KERNELS)
        try:
            zs_cli.main(common + cases[0][2] + ["--devices", "2"])
        except RuntimeError as e:
            msg = str(e)
        else:
            raise PhaseFailed("--devices 2 ran on a one-card host")
        ok = f"{torch.cuda.device_count()} visible CUDA device" in msg
        say(f"  --devices 2 on this {torch.cuda.device_count()}-card host raises: {msg!r} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailed("--devices 2 raised without naming the visible count")
    return runs, secs


def multidevice_phase(dev, counters):
    """Data parallelism over ranks at full ViT-B/16 width, in NCCL worlds of
    one rank: the sharded extractor, the sharded training steps and a cached
    epoch, the sharded streamed re-ranking, both CLIs with --multihost."""
    say("multidevice: the port's data mesh (one process per card, NCCL) in worlds of one "
        f"rank on this {torch.cuda.device_count()}-card host; each sub-check against its "
        "single-device path")
    from tpu_reid_torch.parallel.mesh import agree

    runs, numbers = {}, {}
    t0 = time.perf_counter()
    with nccl_world(dev) as mesh:
        t1 = time.perf_counter()
        agree(mesh, True, "a flag")  # the first collective builds the communicator
        t2 = time.perf_counter()
    numbers["world_s"] = {"init": t1 - t0, "first_collective": t2 - t1,
                          "destroy": time.perf_counter() - t2}
    say(f"  an NCCL world of one rank: init_process_group {t1 - t0:.3f} s, the first "
        f"collective {t2 - t1:.3f} s, destroy {numbers['world_s']['destroy']:.3f} s")
    # the launcher on this host's CPU (one card: no second NCCL rank): two
    # spawned gloo ranks, from run() to both past their first collective
    from tpu_reid_torch.parallel import launch

    t0 = time.time()
    ready = launch.run(rank_clock, devices=2, device="cpu", timeout_s=120, join_timeout_s=300)
    numbers["spawn_s"] = {"ready": ready - t0, "run": time.time() - t0}
    say(f"  launch.run of 2 gloo ranks on the host's CPU: spawn + rendezvous + first collective "
        f"{numbers['spawn_s']['ready']:.2f} s, the whole run {numbers['spawn_s']['run']:.2f} s")
    mcfg, params = flagship(dev)
    runs["multidevice_serve"], numbers["emb_s"] = sharded_serving(dev, counters, mcfg, params)
    numbers["steps"], steps = sharded_steps(dev, counters, mcfg, params)
    runs["multidevice_stage1"] = steps["stage-1 live"]
    runs["multidevice_stage2"] = steps["stage-2"]
    runs["multidevice_cached_stage2"] = sharded_cached_epoch(dev, counters, mcfg, params)
    del mcfg, params
    torch.cuda.empty_cache()
    runs["multidevice_rerank"], numbers["rerank"] = sharded_rerank(dev)
    torch.cuda.empty_cache()
    cli_runs, numbers["cli_s"] = multihost_clis(counters)
    runs.update(cli_runs)
    return runs, numbers


# ---------------------------------------------------------------------------
# phase 17: tensor parallelism on one card
# ---------------------------------------------------------------------------

TP_WIDTHS = (2, 4, 12)
TP_KERNELS = ("ln_gemm", "mha_core", "gemm_bias_residual")
# ViT-B/16 at 256x128, stride 12: (tokens, width, heads, head width, MLP)
TP_GEOMETRY = (211, 768, 12, 64, 3072)


def _bf16_shard(shard):
    """A block shard with its matrices and biases in bf16 (the block
    kernels' operands; the LayerNorm parameters stay fp32, as fused_block
    takes them)."""
    return {k: (v if k in ("ln_1", "ln_2") else v.to(torch.bfloat16)) for k, v in shard.items()}


def tp_shard_flops_bytes(b, s, d, hid, heads, dh, n_model):
    """(operations, bytes) of one shard's two halves: the four GEMMs and the
    attention on its heads; x, x1 and the shard's weights read once, the
    two partials written once (bf16)."""
    m, hl, hh = b * s, heads // n_model, hid // n_model
    n_qkv = 3 * hl * dh
    flops = (2.0 * m * d * n_qkv + 4.0 * b * hl * s * s * dh + 2.0 * m * hl * dh * d
             + 2.0 * m * d * hh + 2.0 * m * hh * d)
    weights = d * n_qkv + n_qkv + hl * dh * d + d * hh + hh + hh * d
    return flops, 2.0 * (2 * m * d + weights + 2 * m * d) + 16.0 * d


def tp_tower_in_threads(shards, vcfg, images):
    """apply_vit_tp(cls_only=True) of every shard of one model group, each
    on its own thread of this process, with a `reduce` that sums the
    threads' partials in rank order (a model group's all-reduce, in one
    process: the card host has one card and NCCL takes one rank per card).
    Returns shard 0's (x12, xproj) CLS rows; every shard's are the same."""
    import threading

    from tpu_reid_torch.parallel import tp as TP

    n = len(shards)
    slots, outs, errors = [None] * n, [None] * n, []
    barrier = threading.Barrier(n)

    def run(r):
        def reduce(t):
            slots[r] = t.float()
            barrier.wait()
            summed = sum(slots[1:], slots[0])
            barrier.wait()  # every thread has read the slots before the next write
            return summed

        try:
            with torch.no_grad():
                outs[r] = TP.apply_vit_tp(shards[r], vcfg, images, reduce, cls_only=True)[1:]
        except BaseException as e:  # handed to the caller below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise PhaseFailed(f"apply_vit_tp over {n} threads failed: {errors or 'timed out'}")
    return outs[0]


def tp_phase(dev, counters, b=128, n_batches=4):
    """Tensor parallelism (parallel/tp.py) at full ViT-B/16 width from
    random_clip_state_dict(0): 211 tokens, 12 heads of 64, MLP 3072, bf16.
    For T in TP_WIDTHS every shard of one block runs on this card in turn
    (tp_attn_partial, tp_mlp_partial) and the partials are summed where a
    model group all-reduces; each shard's kernels against their plain
    versions, the summed block against fused_block, one shard's halves
    timed against the whole block beside the shard's bound; the whole
    apply_vit_tp(cls_only=True) against apply_vit(cls_only=True) (exact
    softmax); then make_tp_extractor over an NCCL world of one rank against
    the single-device extractor, and the CLI's --tp 2 on this one-card host.
    Returns ({path: launches}, numbers)."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models import layers as L
    from tpu_reid_torch.models import vit as V
    from tpu_reid_torch.ops import attention as TA
    from tpu_reid_torch.ops import fused_attention as FA
    from tpu_reid_torch.parallel import tp as TP
    from tpu_reid_torch.parallel.extract import extract_embeddings, make_extractor
    from tpu_reid_torch.pipelines import zero_shot as Z
    from tpu_reid_torch.weights.convert import convert_clip, random_clip_state_dict

    bf = torch.bfloat16
    tol = TOL[bf]
    cfg, clip = convert_clip(random_clip_state_dict(0), image_hw=(256, 128), stride=12,
                             device=dev)
    vcfg, visual = cfg.vision, clip["visual"]
    s, d, heads = vcfg.seq_len, vcfg.width, vcfg.heads
    dh, hid = d // heads, visual["blocks"]["mlp"]["c_fc"]["w"].shape[-1]
    if (s, d, heads, dh, hid) != TP_GEOMETRY:
        raise PhaseFailed(f"unexpected ViT-B/16 geometry {vcfg}")
    layout = TP.tp_visual_layout(visual, heads)
    blk = L.slice_layer(visual["blocks"], 0)
    a, m_ = blk["attn"], blk["mlp"]
    whole = (blk["ln_1"]["scale"], blk["ln_1"]["bias"], a["in_proj"]["w"].to(bf),
             a["in_proj"]["b"].to(bf), a["out_proj"]["w"].to(bf), a["out_proj"]["b"].to(bf),
             blk["ln_2"]["scale"], blk["ln_2"]["bias"], m_["c_fc"]["w"].to(bf),
             m_["c_fc"]["b"].to(bf), m_["c_proj"]["w"].to(bf), m_["c_proj"]["b"].to(bf))
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(b, s, d, device=dev, generator=gen).to(bf)
    images = torch.randn(b, 256, 128, 3, device=dev, generator=gen).to(bf)
    with torch.no_grad():
        block_ms = time_ms(lambda: FA.fused_block(x, *whole, heads))
        block_graph_ms = graph_ms(lambda: FA.fused_block(x, *whole, heads))
        want_block = FA.fused_block(x, *whole, heads)
        want_feats = torch.cat(V.apply_vit(visual, vcfg, images, cls_only=True)[1:], -1)[:, 0]
    say(f"tp: tensor parallelism at ViT-B/16 width (B={b}, S={s}, D={d}, {heads} heads of {dh}, "
        f"MLP {hid}, bf16), every shard of T in {TP_WIDTHS} on this one card in turn, the "
        f"partials summed where a model group all-reduces; fused_block {block_ms:.4f} ms "
        f"(median of 20 CUDA-event runs), {block_graph_ms:.4f} ms as a CUDA-graph replay")
    runs, numbers, failures = {}, {}, []

    def held(label, got, want):
        err, rel = rel_err(got, want)
        ok = rel <= tol
        if not ok:
            failures.append(label)
        return err, rel, ok

    for n_model in TP_WIDTHS:
        hl = heads // n_model
        shards = [_bf16_shard(L.slice_layer(TP.tp_shard(layout["blocks"], r, n_model), 0))
                  for r in range(n_model)]
        for sh in shards:
            TP.check_tp_kernels(sh, hl)
        # the TP block path, counted: every shard's halves, the partials summed
        for c in counters.values():
            c.launches = 0
        with torch.no_grad():
            attn = sum(TP.tp_attn_partial(sh, x, hl).float() for sh in shards)
            x1 = TP.add_reduced(x, attn, shards[0]["out_b"])
            mlp = sum(TP.tp_mlp_partial(sh, x1).float() for sh in shards)
            got_block = TP.add_reduced(x1, mlp, shards[0]["proj_b"])
        torch.cuda.synchronize()
        runs[f"tp{n_model}_block"] = launched(counters)
        require(f"the T={n_model} block", runs[f"tp{n_model}_block"], TP_KERNELS)
        err, block_rel, ok = held(f"T={n_model} block", got_block, want_block)
        say(f"  T={n_model} ({hl} heads, {hid // n_model} hidden units a shard): the summed "
            f"block against fused_block: max|d| {err:.3e}, rel {block_rel:.3e} (tol {tol:.0e}) "
            f"{'ok' if ok else 'FAIL'}; launches {runs[f'tp{n_model}_block']}")
        # each shard's kernels against their plain versions, on the shard's shapes
        worst = {}
        with torch.no_grad():
            for r, sh in enumerate(shards):
                qkv = FA.ln_gemm(x, sh["ln_1"]["scale"], sh["ln_1"]["bias"], sh["w_in"],
                                 sh["b_in"])
                views = FA._qkv_views(qkv, hl)
                att = TA.mha_core(*views).reshape(b, s, -1)
                zero = x.new_zeros(d)
                h = FA.ln_gemm(x1, sh["ln_2"]["scale"], sh["ln_2"]["bias"], sh["fc_w"],
                               sh["fc_b"], gelu=True)
                for label, got, want in (
                        ("ln_gemm qkv", qkv, FA.ln_gemm_reference(
                            x, sh["ln_1"]["scale"], sh["ln_1"]["bias"], sh["w_in"], sh["b_in"])),
                        ("mha_core", att, TA.mha_core_reference(*views).reshape(b, s, -1)),
                        ("gemm_bias_residual out-proj",
                         FA.gemm_bias_residual(att, sh["w_out"], zero),
                         FA.gemm_bias_residual_reference(att, sh["w_out"], zero)),
                        ("ln_gemm c_fc", h, FA.ln_gemm_reference(
                            x1, sh["ln_2"]["scale"], sh["ln_2"]["bias"], sh["fc_w"], sh["fc_b"],
                            gelu=True)),
                        ("gemm_bias_residual c_proj", FA.gemm_bias_residual(h, sh["proj_w"], zero),
                         FA.gemm_bias_residual_reference(h, sh["proj_w"], zero))):
                    e = held(f"T={n_model} shard {r} {label}", got, want)
                    if label not in worst or e[1] > worst[label][1]:
                        worst[label] = e
        say("    each shard's kernels against their plain versions (worst shard): " + "; ".join(
            f"{k} {v[0]:.3e} rel {v[1]:.3e} {'ok' if v[2] else 'FAIL'}" for k, v in worst.items()))
        # one shard's two halves, timed, beside the bound of its work; then
        # each of its five launches alone. CUDA events around a call measure
        # the host's launch cost once a shard's kernels are shorter than it,
        # so each is also timed as a CUDA-graph replay
        s0 = shards[0]

        def halves():
            return TP.tp_attn_partial(s0, x, hl), TP.tp_mlp_partial(s0, x1)

        shard_ms, shard_graph_ms = time_ms(halves), graph_ms(halves)
        bnd, by = bound(*tp_shard_flops_bytes(b, s, d, hid, heads, dh, n_model))
        say(f"    one shard's halves: {shard_graph_ms:.4f} ms as a graph replay (bound "
            f"{bnd:.4f} ms, {by}; {bnd / shard_graph_ms:.1%} of it), {shard_ms:.4f} ms by CUDA "
            f"events around the calls; the whole block's replay {block_graph_ms:.4f} ms: T x "
            f"shard = {n_model * shard_graph_ms:.4f} ms "
            f"({n_model * shard_graph_ms / block_graph_ms:.2f}x the block)")
        with torch.no_grad():
            qkv0 = FA.ln_gemm(x, s0["ln_1"]["scale"], s0["ln_1"]["bias"], s0["w_in"], s0["b_in"])
            att0 = TA.mha_core(*FA._qkv_views(qkv0, hl)).reshape(b, s, -1)
            h0 = FA.ln_gemm(x1, s0["ln_2"]["scale"], s0["ln_2"]["bias"], s0["fc_w"], s0["fc_b"],
                            gelu=True)
        zero = x.new_zeros(d)
        parts = {
            f"ln_gemm qkv N={qkv0.shape[-1]}": lambda: FA.ln_gemm(
                x, s0["ln_1"]["scale"], s0["ln_1"]["bias"], s0["w_in"], s0["b_in"]),
            f"mha_core {hl} heads": lambda: TA.mha_core(*FA._qkv_views(qkv0, hl)),
            f"gemm_bias_residual out K={att0.shape[-1]}": lambda: FA.gemm_bias_residual(
                att0, s0["w_out"], zero),
            f"ln_gemm c_fc N={h0.shape[-1]}": lambda: FA.ln_gemm(
                x1, s0["ln_2"]["scale"], s0["ln_2"]["bias"], s0["fc_w"], s0["fc_b"], gelu=True),
            f"gemm_bias_residual c_proj K={h0.shape[-1]}": lambda: FA.gemm_bias_residual(
                h0, s0["proj_w"], zero)}
        part_ms = {k: graph_ms(f) for k, f in parts.items()}
        say("    its launches alone, ms as graph replays: " + ", ".join(
            f"{k} {v:.4f}" for k, v in part_ms.items()))
        # the whole tower, every shard on a thread, against apply_vit (exact softmax)
        tower = [dict(layout, blocks=TP.tp_shard(layout["blocks"], r, n_model))
                 for r in range(n_model)]
        got_feats = torch.cat(tp_tower_in_threads(tower, vcfg, images), -1)[:, 0]
        err, rel, ok = held(f"T={n_model} apply_vit_tp", got_feats, want_feats)
        say(f"    apply_vit_tp(cls_only=True) over {n_model} threads, {b} images: cat(x12, "
            f"xproj) CLS against apply_vit(cls_only=True): max|d| {err:.3e}, rel {rel:.3e} "
            f"(tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
        numbers[f"T{n_model}"] = {"shard_graph_ms": shard_graph_ms, "shard_ms": shard_ms,
                                  "parts_graph_ms": part_ms, "bound_ms": bnd, "bound_by": by,
                                  "block_graph_ms": block_graph_ms, "block_ms": block_ms,
                                  "block_rel": block_rel, "tower_rel": rel}
        del shards, tower
        torch.cuda.empty_cache()
    if failures:
        raise PhaseFailed(f"tensor parallelism disagrees with its references: {failures}")

    # make_tp_extractor over an NCCL world of one rank against the
    # single-device extractor (no input-norm fold in either, as the TP route)
    pp = DevicePreprocess((256, 128), "vit", dtype=bf)
    u8 = [torch.randint(0, 255, (b, 256, 128, 3), dtype=torch.uint8, device=dev,
                        generator=gen) for _ in range(n_batches)]
    batches = [SimpleNamespace(images=im, pids=np.arange(b), camids=np.zeros(b, np.int64),
                               seqids=np.zeros(b, np.int64), valid=np.ones(b, bool))
               for im in u8]
    single = make_extractor(Z.make_zeroshot_embed(clip, cfg), pp, flip_tta=True, dtype=bf,
                            device=dev)
    want, *_ = extract_embeddings(single, clip, batches, device=dev)
    with nccl_world(dev) as mesh:
        ext = TP.make_tp_extractor(mesh, vcfg, pp, flip_tta=True, dtype=bf)
        params_tp = TP.shard_tp_visual(layout, mesh.model_rank, mesh.model_size)
        extract_embeddings(ext, params_tp, batches[:1], device=dev, mesh=mesh)  # warm-up
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        got, *_ = extract_embeddings(ext, params_tp, batches, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        runs["tp_extractor"] = launched(counters)
        shape = dict(mesh.shape)
    err, rel = rel_err(got, want)
    ok = got.shape == want.shape and rel <= tol
    say(f"  make_tp_extractor over an NCCL world of one rank ({shape}), {n_batches} x {b} "
        f"images with flip-TTA: {n_batches * b / secs:.1f} emb/s; against the single-device zero-shot extractor: "
        f"max|d| {err:.3e}, rel {rel:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}; launches "
        f"{runs['tp_extractor']}")
    if not ok:
        raise PhaseFailed("make_tp_extractor disagrees with the single-device extractor")
    require("make_tp_extractor", runs["tp_extractor"], TP_KERNELS + ("ln_proj_tail",))
    numbers["extractor"] = {"emb_s": n_batches * b / secs, "rel": rel}

    from tpu_reid_torch.cli import zero_shot as zs_cli

    try:
        zs_cli.main(["--root", ".", "--model_path", "unused.pth", "--bpe_path", "unused.gz",
                     "--tp", "2"])
    except RuntimeError as e:
        msg = str(e)
    else:
        raise PhaseFailed("--tp 2 ran on a one-card host")
    ok = f"{torch.cuda.device_count()} visible CUDA device" in msg and "--tp 2" in msg
    say(f"  the zero-shot CLI with --tp 2 on this {torch.cuda.device_count()}-card host raises: "
        f"{msg!r} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("--tp 2 raised without naming the card count")
    return runs, numbers


# ---------------------------------------------------------------------------
# phase 18: the tools, entry() and the native decoder
# ---------------------------------------------------------------------------


def tools_phase(dev, counters):
    """tpu_reid_torch.tools.parity_run --synthetic on the card (both result
    sets and their |d|), entry()'s forward on its 8 example images against
    eval_embed's plain path, and the native decoder: built or not; if built,
    its pixels against PIL's on a Market1501 directory of write_market_dir
    and decode images/s of both. Returns ({path: launches}, numbers)."""
    import tempfile

    from tpu_reid_torch import entry as E
    from tpu_reid_torch import native
    from tpu_reid_torch.data.datasets import get_dataset
    from tpu_reid_torch.data.loader import BatchLoader
    from tpu_reid_torch.ops._build import kernel_impl
    from tpu_reid_torch.tools import parity_run

    runs, numbers = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        res = parity_run.main(["--synthetic", "--synthetic_dir", tmp, "--bs", "16", "--mm"])
        torch.cuda.synchronize()
        runs["parity_run"] = launched(counters)
        numbers["parity_run"] = {"s": time.perf_counter() - t0, **res}
    say(f"tools: parity_run --synthetic --mm on the card ({numbers['parity_run']['s']:.1f} s): "
        f"framework {res['framework']}, reference math {res['reference_math']}, |d| "
        f"{res['abs_diff']} (max {res['max_abs_diff']:.2e}, tol 2e-3) ok; launches "
        f"{runs['parity_run']}")
    require("parity_run", runs["parity_run"], TP_KERNELS + ("ln_proj_tail",))

    fn, (params, example) = E.entry()
    for c in counters.values():
        c.launches = 0
    got = fn(params, example)
    torch.cuda.synchronize()
    runs["entry"] = launched(counters)
    with kernel_impl("plain"):  # the same eval_embed through the plain block and tail
        want = fn(params, example)
    err, rel = rel_err(got, want)
    ok = got.shape == want.shape and got.shape[0] == 8 and rel <= TOL[torch.bfloat16]
    say(f"  entry(): the flagship's eval_embed on its 8 example images (bf16) against the plain "
        f"path: max|d| {err:.3e}, rel {rel:.3e} (tol {TOL[torch.bfloat16]:.0e}) "
        f"{'ok' if ok else 'FAIL'}; launches {runs['entry']}")
    if not ok:
        raise PhaseFailed("entry()'s forward disagrees with the plain path")
    require("entry()", runs["entry"], BLOCK_KERNELS + ("ln_proj_tail",))
    numbers["entry"] = {"rel": rel}
    del fn, params, example
    torch.cuda.empty_cache()

    built = native.available()
    numbers["native"] = {"built": built}
    if not built:
        say(f"  native decoder: not built here ({native._error.strip()[:300]!r}); "
            "BatchLoader(backend='auto') decodes with PIL")
        return runs, numbers
    with tempfile.TemporaryDirectory() as tmp:
        write_market_dir(tmp)
        ds = get_dataset(tmp, "market1501")
        records = ds.gallery + ds.query + ds.train
        paths = [r[0] for r in records]
        t0 = time.perf_counter()
        ours = native.decode_resize_batch(paths, (256, 128))
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        pil = np.concatenate([bt.images[:bt.n_valid] for bt in BatchLoader(
            records, 64, (256, 128), backend="pil")])
        t_pil = time.perf_counter() - t0
    diff = np.abs(ours.astype(np.int16) - pil.astype(np.int16))
    numbers["native"].update(images=len(paths), max_level_diff=int(diff.max()),
                             share_differing=float((diff > 0).mean()),
                             native_img_s=len(paths) / t_native, pil_img_s=len(paths) / t_pil)
    ok = ours.shape == pil.shape and diff.max() <= 2
    say(f"  native decoder: built ({native.library_path().name}); {len(paths)} 256x128 JPEGs of "
        f"write_market_dir: max level difference to PIL {diff.max()}, "
        f"{numbers['native']['share_differing']:.4%} of the values differ (JAX's bound: 2 "
        f"levels) {'ok' if ok else 'FAIL'}; decode {len(paths) / t_native:.0f} images/s "
        f"against PIL's {len(paths) / t_pil:.0f} (BatchLoader, 8 threads)")
    if not ok:
        raise PhaseFailed("the native decoder's pixels are more than 2 levels off PIL's")
    return runs, numbers


# instantiations of the wgmma kernels that the sources launch: the GEMM's
# epilogues (bias, QuickGELU, residual, EVA02's rope and swiglu, EVA02-E's
# exact GELU); the whole-row and the key-tile attention kernels, each at
# heads of 64 and 112; the CLS tail up to D 1024 and up to 2048; the fp32
# route's (LN, epilogue) = 3 without LN + 2 with, its attention kernel and its
# CLS tail
WGMMA_ENTRIES = {"gemm_bf16_kernel": 6, "attention_bf16_kernel": 2,
                 "attention_long_bf16_kernel": 2, "ln_proj_tail_bf16_kernel": 2,
                 "gemm_tf32x3_kernel": 9, "attention_tf32x3_kernel": 3,
                 "attention_tf32x3_kernel_bwd_dq": 1, "attention_tf32x3_kernel_bwd_dkv": 1,
                 "ln_proj_tail_tf32x3_kernel": 1}
# the fp32 kernels of each wrapper: what an fp32 training step must launch,
# and the FMA kernels they replaced, which no trace may show (no name here is
# a substring of another kernel's name)
FP32_KERNELS = ("gemm_tf32x3_kernel", "attention_tf32x3_kernel(", "attention_tf32x3_kernel_bwd",
                "ln_proj_tail_tf32x3_kernel")
RETIRED_FP32_KERNELS = ("gemm_f32_kernel", "attention_f32_kernel", "attention_long_f32_kernel",
                        "ln_proj_tail_kernel")
BF16_BLOCK_KERNELS = ("gemm_bf16_kernel", "attention_bf16_kernel", "attention_long_bf16_kernel",
                      "ln_proj_tail_bf16_kernel")


def mangled_kernel_name(line: str) -> str:
    """`<name>_kernel` and its template arguments out of a mangled entry name
    (`...16gemm_bf16_kernelILi2EEEv...` -> gemm_bf16_kernelILi2EE)."""
    for m in re.finditer("_kernel", line):
        for n in range(7, 48):  # the identifier is preceded by its length
            name = line[m.end() - n:m.end()]
            if line[:m.end() - n].endswith(str(n)) and name[0].isalpha():
                args = re.match(r"(I[A-Za-z0-9_]*?E)E?v", line[m.end():])
                return name + (args.group(1) if args else "")
    return ""


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        from tpu_reid_torch.ops import _build
        from tpu_reid_torch.ops import attention as TA
        from tpu_reid_torch.ops import fused_attention as FA
        from tpu_reid_torch.ops import fused_tail as FT
        from tpu_reid_torch.ops import minsum as MS
    except ImportError as e:
        print(f"chip_smoke: the tpu_reid_torch package is missing: {e}", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    say(smi)
    say(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    secs = _build.build()
    say(f"build: {', '.join(f'{k} {v:.1f} s' for k, v in secs.items())} "
        f"(wall {time.perf_counter() - t0:.1f} s, into {_build.BUILD_DIR})")
    # the wgmma kernels must not spill. An entry is recognised by its name in
    # the raw ptxas line, and the run fails unless every instantiation that
    # block_kernels.cu launches was seen, so a change in the log's format
    # cannot switch the check off.
    spilled, seen = [], dict.fromkeys(WGMMA_ENTRIES, 0)
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            kernel, gated = "", True
            for line in log.read_text().splitlines():
                if "Compiling entry function" in line:
                    kernel = mangled_kernel_name(line)
                    hit = [k for k in WGMMA_ENTRIES if k in line]
                    for k in hit:
                        seen[k] += 1
                    gated = bool(hit) or not kernel
                if "Used" in line or "spill" in line:
                    say(f"  ptxas[{name}] {kernel}: {line.replace('ptxas info    :', '').strip()}")
                if ("spill" in line and gated
                        and "0 bytes spill stores, 0 bytes spill loads" not in line):
                    spilled.append(f"{kernel or 'unnamed entry'}: {line.strip()}")
    if spilled:
        print(f"chip_smoke: FAILED: a wgmma kernel spills registers: {spilled}", file=sys.stderr)
        return 1
    if any(seen[k] < n for k, n in WGMMA_ENTRIES.items()):
        print(f"chip_smoke: FAILED: the ptxas log shows {seen} entries of the wgmma kernels, "
              f"expected at least {WGMMA_ENTRIES}", file=sys.stderr)
        return 1

    block_counters = {"ln_gemm": FA.ln_gemm, "mha_core": TA.mha_core,
                      "gemm_bias_residual": FA.gemm_bias_residual, "fused_mha": FA.fused_mha,
                      "fused_mlp": FA.fused_mlp, "fused_block": FA.fused_block,
                      "ln_proj_tail": FT.ln_proj_tail_kernel}
    counters = dict(block_counters, minsum=MS.minsum_kernel)
    # the vehicle geometry also counts the launches that ran the key-tile kernel
    vehicle_counters = dict(block_counters, mha_core_long=TA.mha_core_long)
    record, by_path = {}, {}
    timings = {}

    state = {}

    def flagship_once():
        if "flagship" not in state:
            state["flagship"] = flagship(dev)
        return state["flagship"]

    def run_kernels():
        record.update(kernel_phase(dev))

    def run_minsum():
        record["minsum"] = minsum_phase(dev)

    def run_zero_shot():
        by_path["zero_shot"], emb_s = main_path_phase(dev, block_counters)
        say(f"emb/s (bf16 zero-shot main path, flip-TTA): {emb_s:.1f}")

    def run_rerank():
        by_path["rerank"] = {"minsum": rerank_phase(dev)}

    def run_serve():
        by_path["ivlp_serve"], emb_s = ivlp_serving_phase(dev, block_counters, *flagship_once())
        say(f"emb/s (bf16 IVLP eval_embed at bench.py's profile): {emb_s:.1f}")

    def run_vehicle():
        record["mha_core_long"] = long_sequence_checks(dev)
        mcfg, params = flagship(dev, image_hw=(256, 256), seq_len=444)
        by_path["vehicle_serve"], emb_s = ivlp_serving_phase(
            dev, vehicle_counters, mcfg, params, k_batches=4, batch=256, hw=(256, 256))
        say(f"emb/s (bf16 IVLP eval_embed at the vehicle geometry, 444 tokens): {emb_s:.1f}")
        del mcfg, params
        torch.cuda.empty_cache()
        by_path.update(vehicle_cli_phase(dict(vehicle_counters, minsum=MS.minsum_kernel)))

    def run_eva02():
        state.clear()
        torch.cuda.empty_cache()
        by_path["eva02_serve"], numbers = eva02_phase(dev)
        say("eva02: " + json.dumps(numbers, default=float))
        torch.cuda.empty_cache()

    def run_evae():
        state.clear()
        torch.cuda.empty_cache()
        by_path["evae_serve"], numbers = evae_phase(dev)
        say("evae: " + json.dumps(numbers, default=float))
        torch.cuda.empty_cache()

    def run_train():
        for stage, r in training_phase(dev, block_counters, *flagship_once()).items():
            by_path[stage] = r["launches"]

    def run_cli():
        state.clear()  # the flagship's weights: the CLIs build their own models
        torch.cuda.empty_cache()
        by_path.update(cli_phase(counters))

    def run_multitask():
        state.clear()
        torch.cuda.empty_cache()
        by_path["multitask"] = multitask_phase(dev, vehicle_counters)
        torch.cuda.empty_cache()
        by_path["multitask_cli"] = multitask_cli_phase(
            dict(vehicle_counters, minsum=MS.minsum_kernel))

    def run_resnet():
        state.clear()
        torch.cuda.empty_cache()
        runs, emb_s = resnet_phase(dev, counters)
        by_path.update(runs)
        say(f"emb/s (bf16 RN50 zero-shot main path, flip-TTA): {emb_s:.1f}")

    def run_variants():
        state.clear()
        torch.cuda.empty_cache()
        runs, numbers = variants_phase(dev, counters)
        by_path.update(runs)
        say("variants: " + ", ".join(f"{k} {v:.1f}" for k, v in numbers.items()))

    def run_cache():
        state.clear()
        torch.cuda.empty_cache()
        numbers, runs = cache_phase(dev, counters)
        by_path.update(runs)
        say("cache: " + json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "losses"}
                                    if k in ("cache", "guard") else
                                    {kind: {kk: vv for kk, vv in r.items() if kk != "losses"}
                                     for kind, r in v.items()}
                                    for k, v in numbers.items()}, default=float))

    def run_multidevice():
        state.clear()
        torch.cuda.empty_cache()
        runs, numbers = multidevice_phase(dev, counters)
        by_path.update(runs)
        say("multidevice: " + json.dumps(numbers, default=float))

    def run_tp():
        state.clear()
        torch.cuda.empty_cache()
        runs, numbers = tp_phase(dev, counters)
        by_path.update(runs)
        say("tp: " + json.dumps(numbers, default=float))

    def run_tools():
        state.clear()
        torch.cuda.empty_cache()
        runs, numbers = tools_phase(dev, counters)
        by_path.update(runs)
        say("tools: " + json.dumps(numbers, default=float))

    phases = (("kernels", run_kernels), ("minsum", run_minsum),
              ("grad", lambda: gradient_phase(dev)), ("zero_shot", run_zero_shot),
              ("rerank", run_rerank), ("serve", run_serve), ("vehicle", run_vehicle),
              ("eva02", run_eva02), ("evae", run_evae), ("train", run_train), ("cli", run_cli), ("multitask", run_multitask),
              ("resnet", run_resnet), ("variants", run_variants), ("cache", run_cache),
              ("multidevice", run_multidevice), ("tp", run_tp), ("tools", run_tools))
    # `--phases kernels,serve` runs only those phases (for work on one of
    # them); such a run is no pass: it ends with {"ok": false, ...} and code 3
    only = None
    if len(sys.argv) > 1:
        only = set(sys.argv[2].split(",")) if len(sys.argv) == 3 else set()
        if sys.argv[1] != "--phases" or not only or only - {n for n, _ in phases}:
            print(f"usage: chip_smoke.py [--phases {','.join(n for n, _ in phases)}]",
                  file=sys.stderr)
            return 2
    try:
        for name, fn in phases:
            if only is None or name in only:
                t = time.perf_counter()
                fn()
                timings[name] = time.perf_counter() - t
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    torch.cuda.synchronize()
    say("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in timings.items()))
    say(f"total {time.perf_counter() - t_start:.1f} s")
    if only is not None:
        say(json.dumps({"ok": False, "partial": sorted(only)}))
        return 3
    kernels = []
    for name in dict(counters, mha_core_long=TA.mha_core_long, **fp32_counters()):
        r = dict(record[name])
        # launches: the main path of the slice that brought the kernel: IVLP
        # serving for the block kernels and the tail, the re-ranking path for
        # minsum, IVLP serving at the vehicle geometry for the key-tile kernel,
        # the fp32 stage-2 training step for the fp32 route
        main = {"minsum": "rerank", "mha_core_long": "vehicle_serve"}.get(
            name, "fp32 stage 2" if name.endswith("_fp32") else "ivlp_serve")
        r["launches"] = by_path[main][name]
        r["launches_by_path"] = {p: c[name] for p, c in by_path.items() if name in c}
        kernels.append(r)
    say(json.dumps({"kernels": kernels, "note": "launches_by_path on the cache_* paths: one "
                    "captured step's launches times the graph's replays (a replay runs no "
                    "Python wrapper, so the counters see a captured step once); on the "
                    "multidevice_* and multihost_* paths: the launches of rank 0, the one rank "
                    "of its one-card world; on tp<T>_block: every shard of one block at "
                    "tensor-parallel width T, run in turn on the one card; on tp_extractor: "
                    "make_tp_extractor in an NCCL world of one rank"}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
