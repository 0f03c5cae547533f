#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_reid_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card and sets fp32 matmuls and convolutions to full fp32.
2. Builds the hand-written kernels from tpu_reid_torch/csrc/ into
   build/kernels/ (one nvcc per source, all at once).
3. kernels: holds every kernel against its plain PyTorch version on the
   card: each block kernel alone at the main path's shapes (ViT-B/16,
   256x128, stride 12: 211 tokens, 128 images per pass, bf16), timed with
   CUDA events beside the plain version and a library yardstick, then
   fused_mha (pre-LN and without, timed beside
   F.multi_head_attention_forward), fused_mlp and the whole block composed
   from them; fused_mha / fused_mlp / mha_core at B=64 for S=211, S=213 with
   the deep-prompt splice and the causal text S=77, exact and fast, bf16
   and fp32; whole blocks at B=64 for every variant the main paths take;
   the CLS tail at B=128 (timed) and B=512.
4. minsum: the minsum kernel at awkward shapes in fp8, bf16 and fp32, then
   timed at the Market-1501 streamed shape (4096 x 16384 x 20480, fp8) and
   on one 1024-row query slab of the MSMT17 shape.
5. grad: the block and CLS-tail autograd Functions against plain autograd
   at full width (B=16, S=213 with the splice, fp32).
6. zero_shot: the zero-shot main path at full width with random weights
   from a seed (convert_clip -> zeroshot_classifier -> flip-TTA extraction
   of 128 query and 512 gallery images in bf16 -> evaluate_zero_shot), and
   the same slice in fp32 through the plain path and the kernels.
7. rerank: re-ranks at Market-1501 scale through the Evaluator, exact and
   streamed routes, held within JAX's bounds.
8. serve: eval_embed of the IVLP flagship (bench.py's model: 213 tokens,
   751 classes, random weights from seed 0) at bench.py's profile (batch
   512, bf16, fast softmax, folded input norm, no flip-TTA): emb/s, a
   trace; every block and tail call of one timed batch against its plain
   version on the run's own inputs, its embeddings against the plain path;
   fp32 kernels against the plain path.
9. train: three live IVLP stage-1 steps and three stage-2 steps of the
   flagship at bs 64 in bf16 activations (ms per step, peak memory, traces,
   launches), an fp32 stage-1 step's peak memory, and an fp32 stage-2 loss
   and gradient through the kernels against the plain path.
10. cli: the zero-shot CLI with --rerank --mm, then the prompt-learning CLI
   (ivlp, one epoch of each stage, --rerank, bf16), at full ViT-B/16 width
   on a synthetic Market1501 directory and a random checkpoint; both must
   launch every kernel.

It prints the kernels' JSON record on the line before the last (each
kernel's launches on this slice's main path, IVLP serving, or for minsum
the re-ranking path, and its launches on every path), and as the last line
{"ok": true, "device": {...}}.
Any failed phase exits non-zero; with no CUDA device, or without the
tpu_reid_torch package beside it, the script exits non-zero before printing
a result.
"""

from __future__ import annotations

import contextlib
import json
import os
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
    entry("fused_mha", src_block, "tpu_reid/ops/fused_attention.py:212", [
        ("pre-LN", lambda: FA.fused_mha(x, *mha_w, None, *ln1),
         lambda: FA.fused_mha_reference(x, *mha_w, None, *ln1), None, mha_flops, mha_bytes)],
        **{f"no_ln_{k}": no_ln_rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")})
    mlp_args = (p["ln2_scale"], p["ln2_bias"], p["w_fc"], p["b_fc"], p["w_proj"], p["b_proj"])
    mlp_flops = 4.0 * b * s * d * hid
    mlp_bytes = 2.0 * (2 * b * s * d + 2 * d * hid + hid + d) + 8.0 * d
    entry("fused_mlp", src_block, "tpu_reid/ops/fused_attention.py:341", [
        ("ln_2 + MLP + residual", lambda: FA.fused_mlp(x, *mlp_args),
         lambda: FA.fused_mlp_reference(x, *mlp_args), None, mlp_flops, mlp_bytes)])
    entry("fused_block", src_block, "tpu_reid/ops/fused_attention.py:483", [
        ("whole block", lambda: FA.fused_block(x, **p, n_heads=heads),
         lambda: FA.fused_block_reference(x, **p, n_heads=heads), None,
         mha_flops + mlp_flops, mha_bytes + mlp_bytes - 4.0 * b * s * d)])

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
    # B=512 is checked too
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
    bt = 128
    xt = xs[bt]
    say(f"CLS tail alone at B={bt}, {d} -> {e}, bf16")
    k_ms = time_ms(lambda: FT.ln_proj_tail_kernel(xt, gt, bt_, proj))
    p_ms = time_ms(lambda: FT.ln_proj_tail_reference(xt, gt, bt_, proj))
    l_ms = time_ms(lambda: F.layer_norm(xt, (d,), gt.to(bf), bt_.to(bf)) @ proj)
    bnd, by = bound(2.0 * bt * d * e, 2.0 * (bt * d + d * e + bt * d + bt * e) + 8.0 * d)
    say(f"    ln_proj_tail: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
        f"library {l_ms:.4f} ms, bound {bnd:.4f} ms ({by})")
    record["ln_proj_tail"] = dict(
        name="ln_proj_tail", route="cuda", source="tpu_reid_torch/csrc/tail_kernel.cu",
        replaces="tpu_reid/ops/fused_tail.py:31", max_abs_err=tails[(bt, bf)], ms=k_ms,
        plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=l_ms)

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
    torch.cuda.synchronize()
    if failures:
        raise PhaseFailed(f"kernels disagree with their plain versions: {failures}")
    return record


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
    """The main path's step: normalization folded into the patch embed,
    flip-TTA, 256x128 input."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models.vit import fold_visual_input_norm
    from tpu_reid_torch.parallel.extract import make_extractor
    from tpu_reid_torch.pipelines import zero_shot as Z

    pp = DevicePreprocess((256, 128), "vit", dtype=dtype)
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


KERNEL_GROUPS = (("gemm_bf16_kernel<true>", "ln_gemm"),
                 ("gemm_bf16_kernel<false>", "gemm_bias_residual / no-LN ln_gemm"),
                 ("gemm_f32_kernel<true>", "ln_gemm fp32"),
                 ("gemm_f32_kernel<false>", "gemm_bias_residual fp32"),
                 ("attention_bf16_kernel", "mha_core"),
                 ("attention_f32_kernel", "mha_core fp32"),
                 ("ln_proj_tail_kernel", "ln_proj_tail"),
                 ("minsum_kernel", "minsum"))


def trace(fn, label, top=12):
    """torch.profiler over fn() (run once before, outside the trace): device
    time by kernel and the device's busy share of the host wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        say(f"trace of {label}: the profiler recorded no kernel on the card "
            f"(device split not measured)")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
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


def trace_step(params, cfg, images, dev):
    """One extraction step (128 images, bf16, flip-TTA) under the profiler."""
    extractor = make_zero_shot_extractor(params, cfg, torch.bfloat16, dev)
    x = torch.from_numpy(images).to(dev)
    trace(lambda: extractor(params, x),
          f"one extraction step ({len(images)} images, bf16, flip-TTA)")


def main_path_phase(dev, counters):
    from tpu_reid_torch.models.layers import kernel_impl
    from tpu_reid_torch.models.tokenizer import ClipTokenizer, write_test_merges
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

    merges_dir = os.path.join(REPO, "build", "smoke")
    os.makedirs(merges_dir, exist_ok=True)
    merges = os.path.join(merges_dir, "merges.txt")
    write_test_merges(merges, [("p", "h"), ("ph", "o"), ("t", "o</w>"), ("pho", "to</w>"),
                               ("p", "e"), ("r", "s"), ("o", "n</w>"), ("a", "r")])
    tokenizer = ClipTokenizer(merges)
    n_ids = 16
    ids = [str(i) for i in range(n_ids)]
    templates = {i: [st.format(f"person no.{i}") for st in SENTENCE_TEMPLATES] for i in ids}
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
    from tpu_reid_torch.models.layers import kernel_impl
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
# phase 10: both CLIs at full ViT-B/16 width
# ---------------------------------------------------------------------------


def write_market_dir(root, n_ids=32, n_query=2, n_gallery=8, n_train=8, seed=2, mix=0.45):
    """A Market1501-layout directory of 256x128 JPEGs: a blocky base image
    per identity plus noise; n_ids test identities (queries on camera 1,
    gallery on cameras 2-6) and n_ids other training identities of n_train
    images each."""
    from PIL import Image

    base_dir = os.path.join(root, "Market1501")
    for sub in ("bounding_box_train", "query", "bounding_box_test"):
        os.makedirs(os.path.join(base_dir, sub))
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (2 * n_ids, 16, 8, 3)).repeat(16, axis=1).repeat(16, axis=2)
    for pid in range(2 * n_ids):
        test = pid < n_ids
        for k in range(n_query + n_gallery if test else n_train):
            noise = rng.uniform(0, 255, (256, 128, 3))
            img = np.clip(mix * base[pid] + (1 - mix) * noise, 0, 255).astype(np.uint8)
            if test:
                sub, cam = ("query", 1) if k < n_query else ("bounding_box_test", 2 + k % 5)
            else:
                sub, cam = "bounding_box_train", 1 + k % 6
            Image.fromarray(img).save(
                os.path.join(base_dir, sub, f"{pid + 1:04d}_c{cam}s1_{k:06d}_00.jpg"),
                quality=90)
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
        saved = [f for f in ("stage1.pt", "stage2.pt")
                 if os.path.exists(os.path.join(tmp, "checkpoints", "ivlp", "market1501", f))]
    say(f"  prompt-learning CLI run {time.perf_counter() - t0:.1f} s (phase seconds on the "
        f"[phase] lines above); saved {saved}; launches {launches}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise PhaseFailed(f"the prompt-learning CLI never launched {missing}")
    if len(saved) != 2 or not np.isfinite(cmc).all() or not 0.0 < mAP <= 1.0:
        raise PhaseFailed(f"prompt-learning CLI result out of range: saved {saved}, mAP {mAP}")
    return runs



# ---------------------------------------------------------------------------
# phase 5: gradients through the kernels, the autograd Functions against plain
# autograd
# ---------------------------------------------------------------------------


def gradient_phase(dev):
    """The block Function (kernels forward, the plain block's recompute
    backward) against plain autograd of _block_xla_impl after the splice,
    at full width, B=16, S=213 with the splice, fp32, under one fixed
    grad_outputs; then the CLS-tail Function against ln_proj_tail_reference."""
    from tpu_reid_torch.models.layers import _apply_splice_plane, _block_xla_impl
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
    out_p = _block_xla_impl(FA._block_params(w), _apply_splice_plane(x, plane, pm), heads, None)
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
        f"(tol 1e-5 of max|plain grad|: both backwards are the same recompute) "
        f"{'ok' if not failures else 'FAIL ' + str(failures)}")

    xt = t(b, d).requires_grad_()
    ln_s = (1 + t(d, std=0.05)).requires_grad_()
    ln_b = t(d, std=0.05).requires_grad_()
    proj = t(d, 512, std=d ** -0.5).requires_grad_()
    gy, gp = t(b, d), t(b, 512)
    yk, pk = FT._TailFn.apply(xt, ln_s, ln_b, proj)
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
# phases 8-9: the IVLP flagship, serving (eval_embed) and training
# ---------------------------------------------------------------------------


def flagship(dev, n_cls=751):
    """bench.py's model in the port: IVLP ViT-B/16 at 256x128, stride 12,
    vision and language prompt depth 12 with 2 context tokens (213 vision
    tokens), 751 classes; random weights from seed 0 (fp32)."""
    from tpu_reid_torch.configs import PromptDesign
    from tpu_reid_torch.models import prompts as P
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.weights.convert import convert_clip, init_vpt, random_clip_state_dict

    design = PromptDesign(trainer="IVLP", vision_depth=12, vision_ctx=2, language_depth=12,
                          language_ctx=2)
    cfg, clip = convert_clip(random_clip_state_dict(0), image_hw=(256, 128), stride=12,
                             design=design, device=dev)
    clip = init_vpt(torch.Generator().manual_seed(0), cfg, clip)
    vocab = cfg.text.vocab_size
    tokens = np.zeros((1, cfg.text.context_length), np.int32)
    tokens[0, 0] = vocab - 2
    tokens[0, 1:10] = np.random.RandomState(0).randint(1, vocab - 2, 9)
    tokens[0, 10] = vocab - 1
    temb = clip["text"]["token_embedding"][torch.as_tensor(tokens, dtype=torch.long,
                                                           device=dev)]
    mcfg = M.ReidModelConfig(mode="ivlp", clip=cfg, prompt=P.PromptLearnerConfig.ivlp(n_cls))
    params = M.init_reid_model(torch.Generator().manual_seed(0), mcfg, clip, temb, tokens)
    if cfg.vision.seq_len != 213:
        raise PhaseFailed(f"unexpected IVLP geometry {cfg.vision}")
    return mcfg, params


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


def ivlp_serving_phase(dev, counters, mcfg, params, k_batches=8, batch=512):
    """eval_embed of the flagship at bench.py's profile (batch 512, bf16
    weights and activations, fast softmax, input normalisation folded into
    the patch embed, no flip-TTA) over 8 batches; a trace of one batch; the
    first batch again with every block and tail call held against its plain
    version, and its embeddings against the plain path; then an fp32 batch
    through the kernels against the plain path."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.models.layers import kernel_impl
    from tpu_reid_torch.ops import fused_attention as FA
    from tpu_reid_torch.ops import fused_tail as FT
    from tpu_reid_torch.ops.attention import set_fast_softmax
    from tpu_reid_torch.parallel.extract import make_extractor

    bf = torch.bfloat16
    pbf = _cast(params, bf)
    fold = lambda p: M.fold_input_norm(p, mcfg, "vit")  # noqa: E731
    embed = lambda p, im: M.eval_embed(p, mcfg, im)  # noqa: E731
    ext = make_extractor(embed, DevicePreprocess((256, 128), "vit", dtype=bf), flip_tta=False,
                         dtype=bf, fold=fold, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.randint(0, 255, (k_batches, batch, 256, 128, 3), dtype=torch.uint8,
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
        say(f"IVLP serving (eval_embed of the flagship, 213 tokens, batch {batch}, bf16, fast "
            f"softmax, folded input norm, no flip-TTA): {k_batches} batches in {sec:.3f} s, "
            f"{emb_s:.1f} emb/s, {1e3 * sec / k_batches:.2f} ms per batch")
        say(f"  launches in the run: {launches}")
        trace(lambda: ext(pbf, images[0]), f"one IVLP eval_embed batch ({batch} images, bf16)")
        # the timed profile itself against plain, on the first timed batch:
        # every fused block (S=213, spliced) and the CLS tail held against
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
    ext32 = make_extractor(embed, DevicePreprocess((256, 128), "vit"), flip_tta=True,
                           dtype=torch.float32, fold=fold, device=dev)
    x = torch.randint(0, 255, (min(32, batch), 256, 128, 3), dtype=torch.uint8, device=dev,
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


def training_phase(dev, counters, mcfg, params, bs=64):
    """Three live IVLP stage-1 steps and three stage-2 steps of the flagship
    at bs 64 (PK 16 x 4) in bf16 activations over fp32 master weights: ms
    per step after the warm-up step, peak memory, a traced step, launches;
    the peak memory of an fp32 stage-1 step; one fp32 stage-2 loss and
    gradient through the kernels against kernel_impl("plain")."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.models.layers import kernel_impl
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

    def run(stage, step, n=3):
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
        report[stage] = dict(ms=ms, peak_gib=peak, launches=launches)

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
    tr2 = TR._trainable_copy(tr2)
    step2 = TR.make_stage2_step(mcfg, tcfg, O.make_stage_optimizer(
        tr2, tcfg.lr_stage2, tcfg.weight_decay, bias_lr_mult=2.0))
    draws = pp.train_draws(gen, bs)
    imgs2 = pp.train_batch(images, draws)
    state = {"frozen": fr2}

    def s2():
        state["frozen"], loss = step2(tr2, state["frozen"], imgs2, labels, text, valid)
        return loss

    run("stage-2 step", s2)
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
    return report


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
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
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    say(f"  ptxas[{name}]: {line.strip()}")

    block_counters = {"ln_gemm": FA.ln_gemm, "mha_core": TA.mha_core,
                      "gemm_bias_residual": FA.gemm_bias_residual, "fused_mha": FA.fused_mha,
                      "fused_mlp": FA.fused_mlp, "fused_block": FA.fused_block,
                      "ln_proj_tail": FT.ln_proj_tail_kernel}
    counters = dict(block_counters, minsum=MS.minsum_kernel)
    record, by_path = {}, {}
    timings = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        timings[name] = time.perf_counter() - t
        return out

    try:
        record.update(timed("kernels", kernel_phase, dev))
        record["minsum"] = timed("minsum", minsum_phase, dev)
        timed("grad", gradient_phase, dev)
        by_path["zero_shot"], zs_emb_s = timed("zero_shot", main_path_phase, dev,
                                               block_counters)
        say(f"emb/s (bf16 zero-shot main path, flip-TTA): {zs_emb_s:.1f}")
        by_path["rerank"] = {"minsum": timed("rerank", rerank_phase, dev)}
        mcfg, params = flagship(dev)
        by_path["ivlp_serve"], emb_s = timed("serve", ivlp_serving_phase, dev, block_counters,
                                             mcfg, params)
        say(f"emb/s (bf16 IVLP eval_embed at bench.py's profile): {emb_s:.1f}")
        for stage, r in timed("train", training_phase, dev, block_counters, mcfg,
                              params).items():
            by_path[stage] = r["launches"]
        del params
        torch.cuda.empty_cache()
        by_path.update(timed("cli", cli_phase, counters))
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    torch.cuda.synchronize()
    say("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in timings.items()))
    say(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name in counters:
        r = dict(record[name])
        # launches: this slice's main path (IVLP serving) for the block
        # kernels and the tail, the re-ranking path for minsum
        main = "rerank" if name == "minsum" else "ivlp_serve"
        r["launches"] = by_path[main][name]
        r["launches_by_path"] = {p: c[name] for p, c in by_path.items() if name in c}
        kernels.append(r)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
