"""The EVA02 vision tower of the port on the CPU (models/layers.eva_block,
ops/fused_eva.py, models/vit.py with cfg.block "eva02"), at a small size
with every mechanism of EVA02-CLIP-L/14: width 128, 2 heads of 64, 3
layers, SwiGLU hidden int(128 x 2.6667) = 341 (stored padded to 384, so the
padding and the real-column statistics are exercised), a 3 x 2 grid (not
square), IVLP's 2 prompt tokens in every block, seeded random weights.

Held against the plain reference of the benchmark
(portbench/configs/eva02_clip_reid.py, EVA-CLIP's equations in float32,
written without the port) and against closed forms. Tolerances, with their
reasons:
  * fp32 against the reference, 1e-5 relative: the same float32 arithmetic
    in another order (the port's products and LayerNorms, the reference's),
    3 blocks deep;
  * bf16 against the fp32 reference, 3e-2 relative L2 per embedding row:
    every product's output and every LayerNorm's is rounded to bf16 (8-bit
    significand, ~2^-9 relative), and the sub-LNs rescale the rounding of
    near-cancelling sums; 3e-2 is the bf16 tolerance of the JAX parity
    tests (the measured gaps are 1.1e-2 to 1.7e-2);
  * the autograd Function called in float32, against autograd through the
    plain block: 1e-5 relative, the same float32 functions (the forward's
    pieces in another order);
  * the stage-2 loss and gradients through the autograd Function in bf16
    against float32 autograd through the reference: the loss within 3.5e-3,
    each gradient's relative L2 gap within 0.06, about twice the measured
    gaps on these seeded weights and inputs (bf16 rounding of the recomputed
    activations and of every gradient product, the backward a plain bf16
    recompute; measured: the loss 1.68e-3, the gradients 1.89e-2 to
    3.47e-2, the largest the qkv weight's).
"""

import math

import pytest
import torch

from portbench import harness as H
from portbench.configs import eva02_clip_reid as R
from portbench.configs import ivlp_clip_reid as RI
from tpu_reid_torch.configs import PromptDesign, VisionConfig
from tpu_reid_torch.models import layers as L
from tpu_reid_torch.models import vit as V
from tpu_reid_torch.ops._build import kernel_impl
from tpu_reid_torch.ops import fused_attention as FA
from tpu_reid_torch.ops import fused_eva as FE
from tpu_reid_torch.weights.convert import eva02_visual_params

D, LAYERS, HEADS, F, E = 128, 3, 2, int(128 * 2.6667), 64
CFG = dict(image_hw=[24, 16], patch=8, stride=8, vision_width=D, vision_layers=LAYERS,
           vision_heads=HEADS, mlp_hidden=F, embed_dim=E, vision_ctx=2, prompt_depth=3,
           pt_hw_seq_len=16, ln_eps=1e-6, n_cls=8,
           pixel_mean=[0.48145466, 0.4578275, 0.40821073],
           pixel_std=[0.26862954, 0.26130258, 0.27577711])
VCFG = VisionConfig(layers=LAYERS, width=D, patch_size=8, stride=8, h_grid=3, w_grid=2,
                    output_dim=E, n_heads=HEADS, block="eva02", mlp_hidden=F, rope_grid=16,
                    ln_eps=1e-6,
                    design=PromptDesign(trainer="IVLP", vision_depth=3, vision_ctx=2,
                                        language_depth=3, language_ctx=2))
SEED = 2 ** 31 + 77


def _tree(raw: dict) -> dict:
    tree: dict = {}
    for name, t in raw.items():
        *path, leaf = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


@pytest.fixture(scope="module")
def weights():
    raw = H.make_raw(R.param_spec(CFG, ["visual"]), SEED, torch.device("cpu"), torch.float32)
    return raw, eva02_visual_params(_tree(raw)["clip"]["visual"])


def _images(n=3, seed=5):
    gen = torch.Generator().manual_seed(seed)
    u8 = torch.randint(0, 256, (n, 24, 16, 3), generator=gen, dtype=torch.uint8)
    return u8, R.normalize(CFG, u8)


def _to(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _embed(params, x):
    _, non_proj, proj = V.apply_vit(params, VCFG, x, cls_only=True)
    return torch.cat([non_proj[:, 0], proj[:, 0]], dim=-1)


def _reference(raw, x):
    P = R.Precision("fp32")
    with P.scope():
        return torch.cat(R.vision(P, raw, CFG, x)[1:], dim=-1)


def _gap(got, want):
    return (got.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1)


def test_plain_path_equals_the_reference_in_fp32(weights):
    raw, params = weights
    _, x = _images()
    with torch.no_grad(), kernel_impl("plain"):
        got = _embed(params, x)
    want = _reference(raw, x)
    assert got.shape == (3, D + E)
    assert float(_gap(got, want).max()) < 1e-5


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_bf16_paths_lie_near_the_reference(weights, impl):
    """bf16 through the plain block, and through the kernel route (its
    wrappers' plain versions on the CPU, the kernels' rounding points)."""
    raw, params = weights
    _, x = _images()
    plain0 = FE.fused_eva_block.plain
    with torch.no_grad(), kernel_impl(impl):
        got = _embed(_to(params, torch.bfloat16), x.bfloat16())
    assert FE.fused_eva_block.plain == plain0  # bf16 blocks take the kernel route
    gap = _gap(got, _reference(raw, x))
    assert float(gap.max()) < 3e-2, gap


def test_fp32_kernel_route_takes_the_plain_block_and_counts_it(weights):
    _, params = weights
    _, x = _images()
    plain0 = FE.fused_eva_block.plain
    with torch.no_grad(), kernel_impl("kernel"):
        got = _embed(params, x)
    assert FE.fused_eva_block.plain == plain0 + LAYERS - 1
    with torch.no_grad(), kernel_impl("plain"):
        want = _embed(params, x)
    assert torch.equal(got, want)


def test_rope_table_is_the_closed_form():
    table = V.rope_table(VCFG, "cpu")
    hg, wg, s = 3, 2, VCFG.seq_len
    assert table.shape == (s, 2, 64) and table.dtype == torch.float32
    want = torch.zeros(s, 2, 64, dtype=torch.float64)
    want[:, 0] = 1.0
    for r in range(hg):
        for c in range(wg):
            row = 1 + r * wg + c
            for p in range(16):
                omega = 10000.0 ** (-2 * p / 32)
                for half, t in ((0, r * 16 / hg), (1, c * 16 / wg)):
                    for d in (32 * half + 2 * p, 32 * half + 2 * p + 1):
                        want[row, 0, d] = math.cos(t * omega)
                        want[row, 1, d] = math.sin(t * omega)
    assert torch.allclose(table.double(), want, atol=1e-7)
    # CLS and the two prompt rows: identity, bit for bit
    x = torch.randn(2, s, HEADS, 64)
    y = FA.rotate_pairs(x, table)
    for row in (0, s - 2, s - 1):
        assert torch.equal(y[:, row], x[:, row])
    # the table is built once per geometry
    assert V.rope_table(VCFG, "cpu") is table


def test_rotating_halves_instead_of_pairs_fails(weights, monkeypatch):
    """The rotate-half convention of other RoPE models (dims d and d + 32 of
    a head as the pair) in place of EVA's interleaved pairs: the tower moves
    far outside the fp32 tolerance."""
    raw, params = weights
    _, x = _images()

    def halves(t, rope):
        cos, sin = rope[:, 0, None, :].float(), rope[:, 1, None, :].float()
        x1, x2 = t.float().chunk(2, dim=-1)
        return (t.float() * cos + torch.cat([-x2, x1], dim=-1) * sin).to(t.dtype)

    monkeypatch.setattr(FA, "rotate_pairs", halves)
    with torch.no_grad(), kernel_impl("plain"):
        got = _embed(params, x)
    assert float(_gap(got, _reference(raw, x)).min()) > 1e-3


def test_cls_block_is_row_zero_of_the_full_block(weights):
    _, params = weights
    tail = L.slice_layer(params["blocks"], LAYERS - 1)
    x = torch.randn(2, VCFG.seq_len, D)
    kw = dict(rope=V.rope_table(VCFG, "cpu"), eps=1e-6, f_real=F)
    with torch.no_grad(), kernel_impl("plain"):
        full = L.eva_block(tail, x, HEADS, **kw)
        cls = L.eva_block_cls(tail, x, HEADS, **kw)
    assert cls.shape == (2, 1, D)
    assert torch.allclose(cls[:, 0], full[:, 0], atol=1e-5, rtol=1e-5)


def test_folded_input_norm_carries_the_conv_bias(weights):
    _, params = weights
    u8, x = _images()
    mean, std = (torch.tensor(v) for v in ((0.5,) * 3, (0.5,) * 3))  # norm_stats("vit")
    folded = V.fold_visual_input_norm(params, "vit")
    assert "bias" not in folded["conv"] and "bias" in params["conv"]
    got = V.patch_embed(folded, VCFG, u8.float())
    want = V.patch_embed(params, VCFG, (u8.float() / 255.0 - mean) / std)
    assert torch.allclose(got, want, atol=1e-4)
    with pytest.raises(ValueError):
        V.fold_visual_input_norm(folded, "vit")


def test_block_function_in_fp32_equals_autograd_through_the_plain_block(weights):
    """`_EvaBlockFn` called directly in float32 on the CPU (forward: the
    wrappers' plain versions; backward: the plain block's recompute), with
    the deep-prompt splice, against autograd through the plain block after
    the splice: the output and the gradient of x, the plane and each of the
    16 tensors."""
    _, params = weights
    ws = [t.detach().clone().requires_grad_()
          for t in FE._eva_tensors(L.slice_layer(params["blocks"], 1), torch.float32)]
    gen = torch.Generator().manual_seed(11)
    s = VCFG.seq_len
    x = torch.randn(2, s, D, generator=gen).requires_grad_()
    plane = torch.randn(s, D, generator=gen).requires_grad_()
    pmask = torch.zeros(s, 1)
    pmask[-2:] = 1.0
    rope = V.rope_table(VCFG, "cpu")
    cot = torch.randn(2, s, D, generator=gen)
    leaves = [x, plane, *ws]
    got = FE._EvaBlockFn.apply(x, plane, pmask, rope, HEADS, F, 1e-6, False, *ws)
    got_g = torch.autograd.grad(got, leaves, cot)
    want = FE._eva_block_xla_impl(FE.eva_block_params(ws), FA.splice_plane(x, plane, pmask),
                                  HEADS, rope, 1e-6, F)
    want_g = torch.autograd.grad(want, leaves, cot)
    assert float(_gap(got.detach().flatten(1), want.detach().flatten(1)).max()) < 1e-5
    assert len(got_g) == 2 + FE.N_TENSORS
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        assert float(w.norm()) > 0, i
        assert float((g - w).norm() / w.norm()) < 1e-5, i


@pytest.mark.parametrize("conv_bias", [True, False])
def test_folded_patch_embedding_in_bf16_errs_no_more_than_the_unfolded(weights, conv_bias):
    """In bf16 the folded patch embedding on raw 0..255 images (crops near
    mid-grey, as a gallery's are) lies about as close to the float32
    embedding of the normalised images as the unfolded embedding of the
    normalised images in bf16 (measured: 0.94x with EVA02's conv bias, 1.22x
    without; the limit 1.5x). Raw images and a folded bias of the same size
    and opposite sign, each rounded to bf16, err 2.9x and 3.7x (0.0125
    against 0.0043, 0.0130 against 0.0035)."""
    _, params = weights
    if not conv_bias:
        params = dict(params, conv={"w": params["conv"]["w"]})
    gen = torch.Generator().manual_seed(3)
    u = (127.5 + 60 * torch.randn(4, 1, 1, 3, generator=gen)
         + 25 * torch.randn(4, 24, 16, 3, generator=gen)).clamp(0, 255).round()
    x = (u / 255.0 - 0.5) / 0.5  # norm_stats("vit")
    want = V.patch_embed(params, VCFG, x)
    p16 = _to(params, torch.bfloat16)
    unfolded = V.patch_embed(p16, VCFG, x.bfloat16())
    folded = V.patch_embed(V.fold_visual_input_norm(p16, "vit"), VCFG, u.bfloat16())
    assert folded.dtype == torch.bfloat16
    assert float(_gap(folded, want).max()) < 1.5 * float(_gap(unfolded, want).max())


def test_stage2_loss_and_gradients_through_the_block_function(weights, monkeypatch):
    """One stage-2 loss of the port (models through trainer.stage2_loss) in
    bf16, its blocks through `_EvaBlockFn` (kernel route: the wrappers'
    plain versions forward, the plain block's recompute backward), against
    float32 autograd through the reference (ivlp_clip_reid's heads and
    losses on the EVA02 reference's features)."""
    from tpu_reid_torch.configs import CLIPConfig, TextConfig
    from tpu_reid_torch.models import prompts as P
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.train import trainer as TR

    raw, _ = weights
    cfg = dict(CFG)
    head = H.make_raw(RI.param_spec(cfg, ["head"]), SEED + 1, torch.device("cpu"),
                      torch.float32)
    names = ["clip/visual/conv/w", "clip/visual/blocks/attn/qkv/w",
             "clip/visual/blocks/attn/inner_ln/scale", "clip/visual/blocks/mlp/w1/w",
             "clip/visual/blocks/mlp/ffn_ln/scale", "clip/visual/blocks/mlp/w3/w",
             "clip/visual/head/w", "head/cls/w"]
    leaves = {k: v.clone().requires_grad_(k in names) for k, v in {**raw, **head}.items()}
    gen = torch.Generator().manual_seed(9)
    labels = torch.arange(4).repeat_interleave(2)
    _, x = _images(8, seed=6)
    text = torch.randn(cfg["n_cls"], E, generator=gen)
    tr = dict(bn_momentum=0.1, label_smooth=0.1, id_loss_weight=0.25, triplet_margin=0.3)

    # the reference: float32 autograd
    monkeypatch.setattr(RI, "vision", R.vision)
    Pr = R.Precision("fp32")
    with Pr.scope():
        want, _ = RI.stage2_loss(Pr, leaves, cfg, tr, x, labels, text)
    want_g = torch.autograd.grad(want, [leaves[k] for k in names])

    # the port: bf16, the blocks through the autograd Function
    tree = _tree(leaves)
    visual = _to(eva02_visual_params(tree["clip"]["visual"]), torch.bfloat16)
    params = {"clip": {"visual": visual}, "head": tree["head"]}
    clip = CLIPConfig(vision=VCFG, text=TextConfig(layers=1, width=64, heads=1, output_dim=E),
                      embed_dim=E)
    mcfg = M.ReidModelConfig(mode="ivlp", clip=clip,
                             prompt=P.PromptLearnerConfig(cfg["n_cls"], n_prefix=5, n_cls_ctx=4))
    plain0 = FE.fused_eva_block.plain
    with kernel_impl("kernel"):
        got, _ = TR.stage2_loss(mcfg, TR.TrainConfig(), params, x.bfloat16(), labels, text)
    assert FE.fused_eva_block.plain == plain0
    got_g = torch.autograd.grad(got, [leaves[k] for k in names])
    assert abs(float(got.detach()) - float(want.detach())) < 3.5e-3 * abs(float(want.detach()))
    for k, g, w in zip(names, got_g, want_g):
        gap = float((g.float() - w).norm() / w.norm())
        assert gap < 0.06, (k, gap)
