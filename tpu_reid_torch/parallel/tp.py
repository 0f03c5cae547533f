"""Tensor parallelism over the mesh's "model" axis (the counterpart of
tpu_reid/parallel/tp.py).

The JAX package shards the ViT tower Megatron-style inside a shard_map:
each model shard owns a block of attention heads (column-parallel qkv,
row-parallel out-projection) and a slice of the MLP's hidden units
(column-parallel c_fc, row-parallel c_proj), with one psum after each
half-block; LayerNorms, biases and embeddings are replicated and the biases
are added after the psum, so they count once. Its TP path is plain einsums.

In the port a rank of the model axis keeps only its slice of the weights
(memory is what TP is for), laid out for the block kernels of
ops/fused_attention.py, and each half-block is a kernel chain on the rank's
heads or hidden units:

    attention:  qkv = ln_gemm(x, ln_1, w_in, b_in)       N = 3 * Hl * dh
                a   = mha_core(q, k, v of qkv)             Hl heads, exact softmax
                partial = gemm_bias_residual(a, w_out, 0)  K = Hl * dh
    MLP:        h   = ln_gemm(x1, ln_2, fc_w, fc_b, gelu)  N = hid / T
                partial = gemm_bias_residual(h, proj_w, 0) K = hid / T

and between them x1 = x + (reduce(attn) + out_b), out = x1 + (reduce(mlp) +
proj_b), as in JAX. `reduce` is the model group's all-reduce (`model_reduce`),
taken in fp32 on every backend: gloo has no bf16 all-reduce, and the same code
runs over NCCL (the cost: 4 bytes per element where bf16 would send 2). On
CPU tensors the kernel wrappers take their plain versions. The CLS-only last
block is plain on the rank's heads (as JAX's and as the port's
layers.residual_block_cls), and the ln_post + proj tail goes through
ops/fused_tail.ln_proj_tail as apply_vit(cls_only=True) does.

The kernels take head width 64, K % 32 and N % 8 (`check_tp_kernels`): on
ViT-B/16 (12 heads of 64, MLP 3072) that admits T in {1, 2, 3, 4, 6, 12};
any other T raises a ValueError naming the sizes, on every device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from tpu_reid_torch.configs import VisionConfig
from tpu_reid_torch.models import layers as L
from tpu_reid_torch.models.vit import patch_embed
from tpu_reid_torch.ops.attention import HEAD_DIM, mha_core
from tpu_reid_torch.ops.fused_attention import (
    _qkv_views, check_gemm_operands, gemm_bias_residual, ln_gemm,
)
from tpu_reid_torch.ops.fused_tail import ln_proj_tail

Tensor = torch.Tensor
Reduce = Callable[[Tensor], Tensor]


# ---------------------------------------------------------------------------
# parameter layout
# ---------------------------------------------------------------------------


def tp_layout(blocks: dict, n_heads: int) -> dict:
    """Stacked block tree -> JAX's TP layout, with the shardable axes
    explicit (tpu_reid/parallel/tp.py:51, the same arrays):

      qkv_w (L, H, d, 3dh)  heads leading, [q | k | v] within a head
      qkv_b (L, H, 3dh)
      out_w (L, H, dh, d)
      out_b (L, d)          replicated, added after the reduce
      fc_w (L, d, hid), fc_b (L, hid), proj_w (L, hid, d)  the hid axis shards
      proj_b (L, d), ln_1, ln_2                             replicated
    """
    w_in = blocks["attn"]["in_proj"]["w"]
    b_in = blocks["attn"]["in_proj"]["b"]
    n_l, d, _ = w_in.shape
    dh = d // n_heads
    # packed columns are [q | k | v], head-major within each section
    qkv_w = (w_in.reshape(n_l, d, 3, n_heads, dh).permute(0, 3, 1, 2, 4)
             .reshape(n_l, n_heads, d, 3 * dh))
    qkv_b = b_in.reshape(n_l, 3, n_heads, dh).permute(0, 2, 1, 3).reshape(n_l, n_heads, 3 * dh)
    return {
        "qkv_w": qkv_w,
        "qkv_b": qkv_b,
        "out_w": blocks["attn"]["out_proj"]["w"].reshape(n_l, n_heads, dh, d),
        "out_b": blocks["attn"]["out_proj"]["b"],
        "fc_w": blocks["mlp"]["c_fc"]["w"],
        "fc_b": blocks["mlp"]["c_fc"]["b"],
        "proj_w": blocks["mlp"]["c_proj"]["w"],
        "proj_b": blocks["mlp"]["c_proj"]["b"],
        "ln_1": blocks["ln_1"],
        "ln_2": blocks["ln_2"],
    }


def tp_visual_layout(visual: dict, n_heads: int) -> dict:
    """Full ViT parameter tree -> TP layout (blocks re-laid, the rest kept)."""
    return dict(visual, blocks=tp_layout(visual["blocks"], n_heads))


def tp_shard(layout: dict, model_rank: int, n_model: int) -> dict:
    """Model rank `model_rank`'s slice of a `tp_layout` (stacked or one
    layer: any leading axes), laid out for the kernels:

      w_in (..., d, 3 * Hl * dh), b_in (..., 3 * Hl * dh): [q of the rank's
        heads | k | v], so `_qkv_views(qkv, Hl)` and mha_core read it as they
        read a whole model's qkv,
      w_out (..., Hl * dh, d), fc_w (..., d, hid/T), fc_b (..., hid/T),
      proj_w (..., hid/T, d); out_b, proj_b, ln_1, ln_2 as they are.

    The counterpart of JAX's tp_visual_specs / shard_tp_visual: a rank holds
    only its slice. ValueError unless T divides the heads and the hidden
    units."""
    qkv_w = layout["qkv_w"]
    n_heads, d, three_dh = qkv_w.shape[-3:]
    dh = three_dh // 3
    hid = layout["fc_w"].shape[-1]
    if n_model < 1 or n_heads % n_model or hid % n_model or not 0 <= model_rank < n_model:
        raise ValueError(f"tensor parallelism over {n_model} ranks (rank {model_rank}): the "
                         f"tower's {n_heads} heads and {hid} hidden units must divide by it")
    hl, hh = n_heads // n_model, hid // n_model
    heads = slice(model_rank * hl, (model_rank + 1) * hl)
    units = slice(model_rank * hh, (model_rank + 1) * hh)
    lead = tuple(qkv_w.shape[:-3])
    w_in = qkv_w[..., heads, :, :].reshape(*lead, hl, d, 3, dh).movedim(-4, -2)
    b_in = layout["qkv_b"][..., heads, :].reshape(*lead, hl, 3, dh).movedim(-3, -2)
    return {
        "w_in": w_in.reshape(*lead, d, 3 * hl * dh).contiguous(),
        "b_in": b_in.reshape(*lead, 3 * hl * dh).contiguous(),
        "w_out": layout["out_w"][..., heads, :, :].reshape(*lead, hl * dh, d).contiguous(),
        "out_b": layout["out_b"],
        "fc_w": layout["fc_w"][..., units].contiguous(),
        "fc_b": layout["fc_b"][..., units].contiguous(),
        "proj_w": layout["proj_w"][..., units, :].contiguous(),
        "proj_b": layout["proj_b"],
        "ln_1": layout["ln_1"],
        "ln_2": layout["ln_2"],
    }


def shard_tp_visual(visual_tp: dict, model_rank: int, n_model: int) -> dict:
    """A `tp_visual_layout` tree with its blocks cut to `tp_shard`'s slice of
    `model_rank` (the non-block leaves replicated)."""
    return dict(visual_tp, blocks=tp_shard(visual_tp["blocks"], model_rank, n_model))


def check_tp_kernels(p: dict, heads: int) -> None:
    """ValueError unless the block kernels take a shard of `heads` heads:
    head width 64 (mha_core) and the four GEMMs inside
    `check_gemm_operands`' domain (K % 32, N % 8, LayerNorm K <= 1024)."""
    d, n_in = p["w_in"].shape[-2:]
    hid = p["fc_w"].shape[-1]
    dh = n_in // (3 * heads)
    if dh != HEAD_DIM:
        raise ValueError(f"tensor-parallel block: {heads} heads of {dh}; the mha_core kernel "
                         f"takes heads of {HEAD_DIM}")
    for what, k, n, has_ln in (("qkv (ln_gemm)", d, n_in, True),
                               ("out-projection (gemm_bias_residual)", heads * dh, d, False),
                               ("c_fc (ln_gemm)", d, hid, True),
                               ("c_proj (gemm_bias_residual)", hid, d, False)):
        check_gemm_operands(f"tensor-parallel {what} of a shard of {heads} heads and {hid} "
                            "hidden units", 1, k, n, has_ln, {})


# ---------------------------------------------------------------------------
# forward on one rank's shard
# ---------------------------------------------------------------------------


def model_reduce(mesh) -> Reduce:
    """`reduce` for the blocks: the sum of a partial over the model group, in
    fp32 (a new tensor; no collective for a model axis of one or mesh
    None)."""

    def reduce(t: Tensor) -> Tensor:
        t32 = t.to(torch.float32, copy=True)
        if mesh is not None and mesh.model_size > 1:
            dist.all_reduce(t32, group=mesh.model_group)
        return t32

    return reduce


def add_reduced(x: Tensor, summed: Tensor, bias: Tensor) -> Tensor:
    """x + (summed + bias) in fp32, cast once to x's dtype (the bias counts
    once, after the reduce)."""
    return (x.float() + (summed + bias.float())).to(x.dtype)


def tp_attn_partial(p: dict, x: Tensor, heads: int) -> Tensor:
    """This shard's term of the attention half-block's output projection,
    (B, S, D) in x's dtype: ln_gemm -> mha_core on the shard's `heads` heads
    (exact softmax, whatever set_fast_softmax says: JAX's TP block takes
    jax.nn.softmax) -> gemm_bias_residual with a zero bias. The kernels on
    CUDA tensors, their plain versions on CPU tensors."""
    dt = x.dtype
    b, s, d = x.shape
    qkv = ln_gemm(x, p["ln_1"]["scale"], p["ln_1"]["bias"], p["w_in"].to(dt),
                  p["b_in"].to(dt))
    a = mha_core(*_qkv_views(qkv, heads), None, fast=False).reshape(b, s, -1)
    return gemm_bias_residual(a, p["w_out"].to(dt), x.new_zeros(d))


def tp_mlp_partial(p: dict, x1: Tensor) -> Tensor:
    """This shard's term of the MLP's c_proj, (B, S, D) in x1's dtype:
    ln_gemm(gelu) on the shard's hidden units -> gemm_bias_residual with a
    zero bias."""
    dt = x1.dtype
    h = ln_gemm(x1, p["ln_2"]["scale"], p["ln_2"]["bias"], p["fc_w"].to(dt), p["fc_b"].to(dt),
                gelu=True)
    return gemm_bias_residual(h, p["proj_w"].to(dt), x1.new_zeros(x1.shape[-1]))


def tp_residual_block(p: dict, x: Tensor, heads: int, reduce: Reduce) -> Tensor:
    """Pre-norm block on a shard of `heads` heads: two reduces in all."""
    x1 = add_reduced(x, reduce(tp_attn_partial(p, x, heads)), p["out_b"])
    return add_reduced(x1, reduce(tp_mlp_partial(p, x1)), p["proj_b"])


def tp_stack(stacked: dict, x: Tensor, heads: int, reduce: Reduce) -> Tensor:
    for i in range(L.num_layers(stacked)):
        x = tp_residual_block(L.slice_layer(stacked, i), x, heads, reduce)
    return x


def tp_residual_block_cls(p: dict, x: Tensor, heads: int, reduce: Reduce) -> Tensor:
    """The last block at the CLS position only, (B, 1, D), on a shard of
    `heads` heads: K and V from the whole sequence, plain math (as JAX's
    apply_vit_tp(cls_only=True) and the port's layers.residual_block_cls),
    one reduce per half."""
    b, s, _ = x.shape
    dt = x.dtype
    n = p["w_out"].shape[0]
    dh = n // heads
    h = L.layer_norm(p["ln_1"], x)
    wq, wk, wv = p["w_in"].to(dt).split(n, dim=1)
    bq, bk, bv = p["b_in"].to(dt).split(n)
    q = (h[:, :1] @ wq + bq).reshape(b, 1, heads, dh)
    k = (h @ wk + bk).reshape(b, s, heads, dh)
    v = (h @ wv + bv).reshape(b, s, heads, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (dh ** -0.5)
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, 1, n)
    x0 = add_reduced(x[:, :1], reduce(out @ p["w_out"].to(dt)), p["out_b"])
    hid = L.layer_norm(p["ln_2"], x0) @ p["fc_w"].to(dt) + p["fc_b"].to(dt)
    return add_reduced(x0, reduce(L.quick_gelu(hid) @ p["proj_w"].to(dt)), p["proj_b"])


def apply_vit_tp(params_tp: dict, cfg: VisionConfig, images: Tensor,
                 reduce: Optional[Reduce] = None, cls_only: bool = False):
    """TP twin of models.vit.apply_vit for the frozen-encoder paths (no
    prompt splicing: deep-prompt modes keep the data-parallel path), on this
    rank's shard (`shard_tp_visual`); `reduce` sums over the model axis
    (`model_reduce(mesh)`; None: a model axis of one). Returns the (x11, x12,
    xproj) triple of apply_vit; with cls_only x12 and xproj are the CLS row,
    (B, 1, ...), the tail through ln_proj_tail. On CUDA inputs the shard is
    checked against the kernels' domain before the first launch."""
    reduce = reduce or model_reduce(None)
    blocks = params_tp["blocks"]
    heads = blocks["w_out"].shape[-2] // (cfg.width // cfg.heads)  # this rank's
    if images.is_cuda:
        check_tp_kernels(blocks, heads)
    x = patch_embed(params_tp, cfg, images)
    b = x.shape[0]
    cls = params_tp["class_embedding"].to(x.dtype).expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + params_tp["positional_embedding"].to(x.dtype)
    x = L.layer_norm(params_tp["ln_pre"], x)

    n_layers = cfg.layers
    x11 = tp_stack(L.slice_layer(blocks, slice(0, n_layers - 1)), x, heads, reduce)
    tail = L.slice_layer(blocks, n_layers - 1)
    if cls_only:
        x12 = tp_residual_block_cls(tail, x11, heads, reduce)
        y, pr = ln_proj_tail(x12[:, 0], params_tp["ln_post"], params_tp["proj"])
        return x11, y[:, None], pr[:, None]
    x12 = L.layer_norm(params_tp["ln_post"], tp_residual_block(tail, x11, heads, reduce))
    return x11, x12, x12 @ params_tp["proj"].to(x12.dtype)


# ---------------------------------------------------------------------------
# 2-D extractor: batch over "data", width over "model"
# ---------------------------------------------------------------------------


def make_tp_extractor(mesh, cfg: VisionConfig, preprocess=None, flip_tta: bool = True,
                      dtype: torch.dtype = torch.bfloat16, cls_only: bool = True):
    """The 2-D parallel zero-shot embedding step: (this rank's shard of the
    visual tree, this rank's rows of a batch as uint8 images) -> cat(x12 CLS,
    xproj CLS) fp32 features of those rows, on the mesh's device. The ranks
    of one model group take the same rows and compute the same features;
    extract_embeddings(mesh=) and the multi-host sweep hand each data index
    its rows. preprocess None: the images go in as they are (cast to
    `dtype`)."""
    reduce = model_reduce(mesh)
    dev = mesh.device

    def embed(params, x):
        _, x12, xproj = apply_vit_tp(params, cfg, x, reduce, cls_only)
        return torch.cat([x12[:, 0], xproj[:, 0]], dim=-1)

    @torch.no_grad()
    def step(params, images_u8):
        images = torch.as_tensor(images_u8).to(dev)
        x = (preprocess.eval_batch(images) if preprocess is not None else images).to(dtype)
        feats = embed(params, x)
        if flip_tta:
            feats = (feats + embed(params, x.flip(2))) * 0.5
        return feats.float()

    return step
