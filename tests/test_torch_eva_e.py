"""EVA02-CLIP-E/14's post-norm vision tower of the port on the CPU
(models/layers.eva_e_block, ops/fused_eva_e.py, models/vit.py with cfg.block
"eva_e"), at a small size with every mechanism of the published tower:
width 224 = 2 heads of 112, an exact-GELU MLP of 1920, 3 layers, a 4 x 3
grid, IVLP's 2 prompt tokens in every block (spliced on each block's
store), seeded random weights.

Held against the plain reference of the benchmark
(portbench/configs/eva_e_clip_reid.py, EVA-CLIP's postnorm equations in
float32, written without the port) and against closed forms. Tolerances,
with their reasons:
  * fp32 against the reference, 1e-5 relative: the same float32 arithmetic
    in another order, 3 blocks deep;
  * bf16 against the fp32 reference, 3e-2 relative L2 per embedding row: the
    bf16 tolerance of the JAX parity tests (every product's and every
    LayerNorm's output rounded to an 8-bit significand);
  * the autograd Function in float32 against autograd through the plain
    block: 1e-5 relative, the same float32 functions in another order;
  * the exact GELU of the fc1 mode against F.gelu's erf form: 1e-6 of the
    largest value (the same fp32 function; the tanh form departs by ~1e-4).
"""

import pytest
import torch

from portbench import harness as H
from portbench.configs import eva_e_clip_reid as R
from tpu_reid_torch.configs import PromptDesign, VisionConfig, eva02_e14_reid
from tpu_reid_torch.models import layers as L
from tpu_reid_torch.models import vit as V
from tpu_reid_torch.ops import attention as A
from tpu_reid_torch.ops import fused_attention as FA
from tpu_reid_torch.ops import fused_eva_e as FEE
from tpu_reid_torch.ops import fused_tail as FT
from tpu_reid_torch.ops._build import kernel_impl
from tpu_reid_torch.weights.convert import eva_e_params, eva_e_visual_params

D, LAYERS, HEADS, DH, F, E = 224, 3, 2, 112, 1920, 64
CFG = dict(name="tiny-e", image_hw=[32, 24], patch=8, stride=8, vision_width=D,
           vision_layers=LAYERS, vision_heads=HEADS, head_width=DH, mlp_hidden=F, embed_dim=E,
           vision_ctx=2, prompt_depth=3, ln_eps=1e-6,
           pixel_mean=[0.48145466, 0.4578275, 0.40821073],
           pixel_std=[0.26862954, 0.26130258, 0.27577711])
DESIGN = PromptDesign(trainer="IVLP", vision_depth=3, vision_ctx=2, language_depth=3,
                      language_ctx=2)
VCFG = VisionConfig(layers=LAYERS, width=D, patch_size=8, stride=8, h_grid=4, w_grid=3,
                    output_dim=E, n_heads=HEADS, block="eva_e", mlp_hidden=F, ln_eps=1e-6,
                    design=DESIGN)
SEED = 2 ** 31 + 91


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
    return raw, eva_e_params(_tree(raw)["clip"]["visual"])


def _images(n=3, seed=5):
    gen = torch.Generator().manual_seed(seed)
    u8 = torch.randint(0, 256, (n, 32, 24, 3), generator=gen, dtype=torch.uint8)
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


def test_the_published_config():
    v = eva02_e14_reid(design=DESIGN).vision
    assert (v.layers, v.width, v.heads, v.width // v.heads, v.hidden) == (64, 1792, 16, 112,
                                                                         15360)
    assert (v.h_grid, v.w_grid, v.seq_len, v.block, v.ln_eps) == (18, 9, 165, "eva_e", 1e-6)


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
    plain0 = FEE.fused_eva_e_block.plain
    with torch.no_grad(), kernel_impl(impl):
        got = _embed(_to(params, torch.bfloat16), x.bfloat16())
    assert FEE.fused_eva_e_block.plain == plain0  # bf16 blocks take the kernel route
    gap = _gap(got, _reference(raw, x))
    assert float(gap.max()) < 3e-2, gap


def test_eval_embed_against_the_reference(weights):
    from tpu_reid_torch.configs import CLIPConfig, TextConfig
    from tpu_reid_torch.models import prompts as P
    from tpu_reid_torch.models import reid_clip as M

    raw, params = weights
    clip = CLIPConfig(vision=VCFG, text=TextConfig(layers=1, width=64, heads=1, output_dim=E),
                      embed_dim=E)
    mcfg = M.ReidModelConfig(mode="ivlp", clip=clip,
                             prompt=P.PromptLearnerConfig(8, n_prefix=5, n_cls_ctx=4))
    _, x = _images(4, seed=8)
    with torch.no_grad(), kernel_impl("kernel"):
        got = M.eval_embed({"clip": {"visual": _to(params, torch.bfloat16)}}, mcfg,
                           x.bfloat16())
    assert got.shape == (4, D + E)
    assert float(_gap(got, _reference(raw, x)).max()) < 3e-2


def test_fp32_kernel_route_takes_the_plain_block_and_counts_it(weights):
    _, params = weights
    _, x = _images()
    plain0 = FEE.fused_eva_e_block.plain
    with torch.no_grad(), kernel_impl("kernel"):
        got = _embed(params, x)
    assert FEE.fused_eva_e_block.plain == plain0 + LAYERS - 1
    with torch.no_grad(), kernel_impl("plain"):
        want = _embed(params, x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,s,route", [
    (torch.bfloat16, 165, "kernel"),   # the cell's sequence
    (torch.bfloat16, 256, "kernel"),   # the whole-row kernel's longest
    (torch.bfloat16, 257, "kernel"),   # the key-tile kernel: EVA-CLIP's own 224 x 224 input
    (torch.bfloat16, 444, "kernel"),   # the key-tile kernel, a ragged last tile
    (torch.float32, 165, "plain"),     # the fp32 kernels take heads of 64 only
])
def test_block_route_follows_the_attention_kernels(weights, dtype, s, route):
    _, params = weights
    ws = FEE.eva_e_tensors(L.slice_layer(params["blocks"], 0), dtype)
    x = torch.empty(2, s, D, dtype=dtype)
    assert FEE.eva_e_block_route(x, ws, HEADS) == route
    assert A.kernel_takes_heads(DH, dtype) == (route == "kernel")


def test_heads_of_112_take_the_bf16_kernels_only():
    assert A.kernel_takes_heads(64, torch.float32)
    assert A.kernel_takes_heads(112, torch.bfloat16)  # any S: whole rows, then key tiles
    assert not A.kernel_takes_heads(112, torch.float32)
    assert not A.kernel_takes_heads(128, torch.bfloat16)
    assert not A.kernel_takes_heads(96, torch.bfloat16)
    # views of a packed qkv buffer of 112-wide heads: heads 112 apart, row stride 3D
    qkv = torch.empty(4, 165, 3 * 1792, dtype=torch.bfloat16)
    for i, view in enumerate(FA._qkv_views(qkv, 16)):
        shape, strides = tuple(view.shape), tuple(view.stride())
        assert A.head_row_stride(shape, strides, (1 << 20) + 1792 * 2 * i, 2) == 3 * 1792
    with pytest.raises(ValueError):  # heads 128 apart are not heads of 112
        A.head_row_stride((2, 50, 12, 112), (50 * 1536, 1536, 128, 1), 1 << 20, 2)


def test_mha_core_at_heads_of_112_on_the_cpu_is_the_softmax():
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 15, 2, DH, generator=gen) for _ in range(3))
    got = A.mha_core(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / DH ** 0.5
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    assert torch.allclose(got, want, atol=1e-5)


def test_cls_block_is_row_zero_of_the_full_block(weights):
    _, params = weights
    tail = L.slice_layer(params["blocks"], LAYERS - 1)
    x = torch.randn(2, VCFG.seq_len, D)
    with torch.no_grad(), kernel_impl("plain"):
        full = L.eva_e_block(tail, x, HEADS)
        cls = L.eva_e_block_cls(tail, x, HEADS)
    assert cls.shape == (2, 1, D)
    assert torch.allclose(cls[:, 0], full[:, 0], atol=1e-5, rtol=1e-5)


def test_splice_after_is_the_splice_before_each_block(weights):
    """transformer_stack(splice_after=True) with the E block (each block
    storing the next one's prompt rows) against the same stack written with
    a splice before each block, as the reference has it."""
    _, params = weights
    gen = torch.Generator().manual_seed(12)
    s = VCFG.seq_len
    x = torch.randn(2, s, D, generator=gen)
    deep = torch.randn(LAYERS, 2, D, generator=gen)
    flags = [False, True, True]
    with torch.no_grad(), kernel_impl("kernel"):
        got = L.transformer_stack(params["blocks"], x, HEADS, deep_prompts=deep,
                                  prompt_flags=flags, block_fn=L.eva_e_block, splice_after=True)
    want = x
    for i in range(LAYERS):
        if flags[i]:
            want = L.splice_prompt_tokens(want, deep[i], text_side=False)
        want = FEE._eva_e_block_xla_impl(L.slice_layer(params["blocks"], i), want, HEADS, 1e-6)
    assert float(_gap(got.flatten(1), want.flatten(1)).max()) < 1e-5


def test_block_function_in_fp32_equals_autograd_through_the_plain_block(weights):
    """`_EvaEBlockFn` called directly in float32 on the CPU (forward: the
    wrappers' plain versions; backward: the plain block's recompute), with
    the splice on store, against autograd through the plain block and the
    splice: the output and the gradient of x, the plane and each of the 12
    tensors."""
    _, params = weights
    ws = [t.detach().clone().requires_grad_()
          for t in FEE.eva_e_tensors(L.slice_layer(params["blocks"], 1), torch.float32)]
    gen = torch.Generator().manual_seed(11)
    s = VCFG.seq_len
    x = torch.randn(2, s, D, generator=gen).requires_grad_()
    plane = torch.randn(s, D, generator=gen).requires_grad_()
    pmask = torch.zeros(s, 1)
    pmask[-2:] = 1.0
    cot = torch.randn(2, s, D, generator=gen)
    leaves = [x, plane, *ws]
    got = FEE._EvaEBlockFn.apply(x, plane, pmask, HEADS, 1e-6, False, *ws)
    got_g = torch.autograd.grad(got, leaves, cot)
    want = FA.splice_plane(FEE._eva_e_block_xla_impl(FEE.eva_e_block_params(ws), x, HEADS,
                                                     1e-6), plane, pmask)
    want_g = torch.autograd.grad(want, leaves, cot)
    assert float(_gap(got.detach().flatten(1), want.detach().flatten(1)).max()) < 1e-5
    assert len(got_g) == 2 + FEE.N_TENSORS
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        if i == 3:  # the packed qkv bias: its key slice gets none, the rest some
            assert not bool(g[D:2 * D].any())
        assert float(w.norm()) > 0, i
        assert float((g - w).norm() / w.norm()) < 1e-5, i


def test_gelu_erf_mode_is_the_exact_gelu():
    """The fc1 mode's plain version against F.gelu's erf form in fp32, within
    1e-6 of the largest value; the tanh approximation misses by far more."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(3, 7, 64, generator=gen)
    w, b = torch.randn(64, 96, generator=gen) / 8, torch.randn(96, generator=gen)
    got = FA.ln_gemm_reference(x, None, None, w, b, gelu_erf=True)
    acc = x @ w + b
    exact = torch.nn.functional.gelu(acc, approximate="none")
    tanh = torch.nn.functional.gelu(acc, approximate="tanh")
    tol = 1e-6 * float(exact.abs().max())
    assert float((got - exact).abs().max()) <= tol
    assert float((tanh - exact).abs().max()) > 20 * tol
    assert float((FA.quick_gelu(acc) - exact).abs().max()) > 20 * tol
    assert torch.equal(FA.gelu_erf(acc), exact)


def test_ln_residual_is_res_plus_layer_norm_with_the_splice_on_store():
    gen = torch.Generator().manual_seed(3)
    y, res = torch.randn(2, 5, 40, generator=gen) * 3 + 1, torch.randn(2, 5, 40, generator=gen)
    g, b = torch.randn(40, generator=gen), torch.randn(40, generator=gen)
    want = res + torch.nn.functional.layer_norm(y, (40,), g, b, eps=1e-6)
    got = FA.ln_residual(y, res, g, b, 1e-6)
    assert torch.allclose(got, want, atol=1e-5)
    plane, pmask = torch.randn(5, 40, generator=gen), torch.tensor([0., 0., 0., 1., 1.])
    spliced = FA.ln_residual(y, res, g, b, 1e-6, plane, pmask)
    assert torch.equal(spliced[:, 3:], plane[3:].expand(2, 2, 40))
    assert torch.equal(spliced[:, :3], got[:, :3])
    # bf16: one rounding of the fp32 sum
    y16, r16 = y.bfloat16(), res.bfloat16()
    got16 = FA.ln_residual(y16, r16, g, b, 1e-6)
    want16 = (r16.float() + torch.nn.functional.layer_norm(y16.float(), (40,), g, b, eps=1e-6))
    assert torch.equal(got16, want16.bfloat16())


def _state_dict(n_layers=2, d=D, f=F, e=E, grid=3, seed=7):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    sd = {"visual.cls_token": r(1, 1, d), "visual.pos_embed": r(1, 1 + grid * grid, d),
          "visual.patch_embed.proj.weight": r(d, 3, 14, 14), "visual.patch_embed.proj.bias": r(d),
          "visual.norm.weight": r(d), "visual.norm.bias": r(d),
          "visual.head.weight": r(e, d), "visual.head.bias": r(e)}
    for i in range(n_layers):
        p = f"visual.blocks.{i}."
        sd.update({p + "norm1.weight": r(d), p + "norm1.bias": r(d),
                   p + "norm2.weight": r(d), p + "norm2.bias": r(d),
                   p + "attn.qkv.weight": r(3 * d, d), p + "attn.q_bias": r(d),
                   p + "attn.v_bias": r(d), p + "attn.proj.weight": r(d, d),
                   p + "attn.proj.bias": r(d), p + "mlp.fc1.weight": r(f, d),
                   p + "mlp.fc1.bias": r(f), p + "mlp.fc2.weight": r(d, f),
                   p + "mlp.fc2.bias": r(d)})
    return sd


def test_converter_from_eva_clip_names():
    sd = _state_dict()
    p = eva_e_visual_params(sd)
    bl = p["blocks"]
    assert bl["attn"]["in_proj"]["w"].shape == (2, D, 3 * D)
    assert torch.equal(bl["attn"]["in_proj"]["w"][1], sd["visual.blocks.1.attn.qkv.weight"].t())
    b_in = bl["attn"]["in_proj"]["b"][0]
    assert torch.equal(b_in[:D], sd["visual.blocks.0.attn.q_bias"])
    assert not b_in[D:2 * D].any()
    assert torch.equal(b_in[2 * D:], sd["visual.blocks.0.attn.v_bias"])
    assert torch.equal(bl["mlp"]["fc1"]["w"][0], sd["visual.blocks.0.mlp.fc1.weight"].t())
    assert torch.equal(bl["mlp"]["fc2"]["w"][1], sd["visual.blocks.1.mlp.fc2.weight"].t())
    assert torch.equal(bl["ln_1"]["scale"][1], sd["visual.blocks.1.norm1.weight"])
    assert torch.equal(bl["ln_2"]["bias"][0], sd["visual.blocks.0.norm2.bias"])
    assert torch.equal(bl["attn"]["out_proj"]["w"][0], sd["visual.blocks.0.attn.proj.weight"].t())
    assert torch.equal(p["conv"]["w"], sd["visual.patch_embed.proj.weight"].permute(2, 3, 1, 0))
    assert torch.equal(p["proj"], sd["visual.head.weight"].t())
    assert torch.equal(p["proj_bias"], sd["visual.head.bias"])
    assert torch.equal(p["ln_post"]["scale"], sd["visual.norm.weight"])
    assert p["positional_embedding"].shape == (10, D)
    assert torch.equal(p["class_embedding"], sd["visual.cls_token"].reshape(-1))
    # the converted block runs: the plain block on its tensors
    x = torch.randn(1, 10, D)
    assert FEE._eva_e_block_xla_impl(L.slice_layer(bl, 0), x, HEADS, 1e-6).shape == x.shape


@pytest.mark.parametrize("missing", ["visual.blocks.1.attn.v_bias", "visual.head.bias",
                                     "visual.blocks.0.mlp.fc2.weight"])
def test_converter_names_a_missing_key(missing):
    sd = _state_dict()
    del sd[missing]
    with pytest.raises(KeyError, match=missing.replace(".", r"\.")):
        eva_e_visual_params(sd)


def test_tail_at_1792_takes_the_wgmma_kernel():
    """EVA02-CLIP-E/14's tail (D 1792, E 1024) is inside the bf16 wgmma
    kernel's domain (fp32: the FMA kernel), and the model's tail at that
    width goes through the tail's Function: on the CPU its plain version."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(4, 1792, generator=gen).bfloat16()
    ln = {"scale": torch.randn(1792, generator=gen), "bias": torch.randn(1792, generator=gen)}
    proj, hb = torch.randn(1792, 1024, generator=gen).bfloat16(), torch.randn(1024,
                                                                              generator=gen)
    assert FT.tail_kernel_route(256, 1792, 1024, True, {}) == "wgmma"
    assert FT.tail_kernel_route(256, 1792, 1024, False, {}) == "fma"
    with kernel_impl("kernel"):
        y, p = FT.ln_proj_tail(x, ln, proj, hb, 1e-6)
    yr, pr = FT.ln_proj_tail_reference(x, ln["scale"], ln["bias"], proj, hb, 1e-6)
    assert torch.equal(y, yr) and torch.equal(p, pr)
