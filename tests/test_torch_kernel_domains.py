"""What the bf16 TMA/wgmma kernels of the port take, decided without a card.

The kernels read their operands through tensor maps and 16-byte vectors, so
they need aligned bases and row strides, bounded boxes and fixed widths. Those
rules live in plain functions of shapes, strides and addresses
(`ops.attention.head_row_stride`, `ops.fused_attention.check_gemm_operands`),
which the wrappers call before a launch. Here each rule refuses what the
kernel does not take and accepts the main paths' shapes: vision 211 / 213
tokens of width 768 (442 / 444 at the vehicle geometry, where mha_core runs
its key-tile kernel), text 77 tokens of width 512, views of a packed qkv
buffer; the fp32 block backward's products (`check_wgrad_operands`,
`wgrad_splits`, `block_backward_route`); and
`ops.fused_tail.tail_kernel_route` picks the CLS tail's kernel.
"""

import pytest
import torch

from tpu_reid_torch.ops import attention as TA
from tpu_reid_torch.ops import fused_attention as FA
from tpu_reid_torch.ops import fused_tail as FT

BASE = 0x7F0000000000  # an allocation's base: 512-byte aligned


def _layout(t):
    return tuple(t.shape), tuple(t.stride())


# ---------------------------------------------------------------------------
# mha_core: head_row_stride
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,h,itemsize", [
    (128, 211, 12, 2),   # zero-shot vision tower, bf16
    (512, 213, 12, 2),   # IVLP serving
    (64, 77, 8, 2),      # text tower
    (64, 77, 8, 4),      # the fp32 text tower
    (1, 1, 12, 2),       # one token of one image
    (3, 256, 12, 2),     # the longest sequence of the whole-row kernels
    (2, 257, 12, 2),     # one past it: the key-tile kernel
    (128, 442, 12, 2),   # the vehicle geometry, 256x256 at stride 12
    (256, 444, 12, 2),   # the same with IVLP's two vision prompts
    (4, 300, 8, 4),      # fp32, 8 heads
])
def test_head_layout_accepts_views_of_a_packed_qkv_buffer(b, s, h, itemsize):
    d = h * 64
    qkv = torch.empty(b, s, 3 * d, dtype=torch.bfloat16 if itemsize == 2 else torch.float32)
    for i, view in enumerate(FA._qkv_views(qkv, h)):
        shape, strides = _layout(view)
        ld = TA.head_row_stride(shape, strides, BASE + i * d * itemsize, itemsize)
        # one token of one image has no row stride to speak of: the kernel is given H * 64
        assert ld == (3 * d if b * s > 1 else d)


@pytest.mark.parametrize("b,s,h", [(128, 211, 12), (64, 77, 8), (2, 1, 8), (1, 50, 1)])
def test_head_layout_accepts_contiguous_heads(b, s, h):
    t = torch.empty(b, s, h, 64, dtype=torch.bfloat16)
    assert TA.head_row_stride(*_layout(t), BASE, 2) == h * 64


@pytest.mark.parametrize("shape,strides,address,itemsize,why", [
    ((1, 2 ** 31, 1, 64), (2 ** 37, 64, 64, 1), BASE, 2, "S past the kernels' 32-bit sizes"),
    ((2 ** 31, 1, 1, 64), (64, 64, 64, 1), BASE, 2, "B past the kernels' 32-bit sizes"),
    ((2, 0, 12, 64), (0, 768, 64, 1), BASE, 2, "an empty sequence"),
    ((2, 50, 12, 32), (50 * 384, 384, 32, 1), BASE, 2, "head width 32"),
    ((2, 50, 12, 128), (50 * 1536, 1536, 128, 1), BASE, 2, "head width 128"),
    ((2, 50, 12, 64), (50 * 768, 768, 64, 2), BASE, 2, "element stride 2"),
    ((2, 50, 12, 64), (50 * 1536, 1536, 128, 1), BASE, 2, "heads 128 apart"),
    ((2, 50, 12, 64), (60 * 768, 768, 64, 1), BASE, 2, "batch stride is not S * ld"),
    ((2, 50, 12, 64), (50 * 768, 768, 64, 1), BASE + 2, 2, "base not 16-byte aligned"),
    ((2, 50, 12, 64), (50 * 772, 772, 64, 1), BASE, 2, "row stride not a multiple of 16 bytes"),
    ((2, 50, 12, 64), (50 * 770, 770, 64, 1), BASE, 4, "fp32 row stride not a multiple of 16 bytes"),
    ((2, 50, 12, 64), (50 * 512, 512, 64, 1), BASE, 2, "rows overlap: ld < H * 64"),
    ((4, 200, 12, 64), (200 * 2 ** 31, 2 ** 31, 64, 1), BASE, 2, "a stride past 2^40 bytes"),
])
def test_head_layout_refuses(shape, strides, address, itemsize, why):
    with pytest.raises(ValueError):
        TA.head_row_stride(shape, strides, address, itemsize)


def test_head_layout_refuses_transposed_heads():
    # (B, H, S, 64) viewed as (B, S, H, 64): the library layout, not the kernel's
    t = torch.empty(2, 12, 50, 64, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError):
        TA.head_row_stride(*_layout(t), BASE, 2)


def test_mha_core_on_the_cpu_takes_any_layout():
    # the plain version has no such domain: only CUDA tensors are held to it
    q = torch.randn(2, 12, 5, 64).transpose(1, 2)
    out = TA.mha_core(q, q, q)
    assert out.shape == (2, 5, 12, 64)


# ---------------------------------------------------------------------------
# ln_gemm / gemm_bias_residual: check_gemm_operands
# ---------------------------------------------------------------------------

ALIGNED = dict(x=BASE, w=BASE + 4096, b=BASE + 8192, out=BASE + 16384)


@pytest.mark.parametrize("m,k,n,has_ln", [
    (128 * 211, 768, 2304, True),    # vision qkv
    (512 * 213, 768, 3072, True),    # IVLP serving c_fc
    (64 * 77, 512, 1536, True),      # text qkv
    (64 * 77, 512, 2048, True),      # text c_fc
    (64 * 211, 3072, 768, False),    # vision c_proj
    (64 * 77, 2048, 512, False),     # text c_proj
    (1, 768, 768, False),            # one row: M is free
    (13504, 1024, 776, True),        # the widest LayerNorm; N a multiple of 8, not of 128
    (211, 32, 8, False),             # the smallest K and N
])
def test_gemm_domain_accepts(m, k, n, has_ln):
    FA.check_gemm_operands("gemm", m, k, n, has_ln, ALIGNED)


@pytest.mark.parametrize("m,k,n,has_ln,addresses,why", [
    (100, 48, 768, False, ALIGNED, "K not a multiple of 32"),
    (100, 0, 768, False, ALIGNED, "K = 0"),
    (100, 768, 772, False, ALIGNED, "N not a multiple of 8"),
    (100, 768, 0, False, ALIGNED, "N = 0"),
    (100, 1056, 768, True, ALIGNED, "LayerNorm wider than the panel"),
    (2 ** 31, 768, 768, False, ALIGNED, "M past a tensor map's extent"),
    (100, 768, 768, False, dict(ALIGNED, x=BASE + 2), "x not 16-byte aligned"),
    (100, 768, 768, False, dict(ALIGNED, w=BASE + 8), "w not 16-byte aligned"),
    (100, 768, 768, False, dict(ALIGNED, b=BASE + 4), "bias not 16-byte aligned"),
    (100, 768, 768, False, dict(ALIGNED, residual=BASE + 6), "residual not 16-byte aligned"),
    (100, 768, 768, True, dict(ALIGNED, ln_scale=BASE + 4), "gamma not 16-byte aligned"),
])
def test_gemm_domain_refuses(m, k, n, has_ln, addresses, why):
    with pytest.raises(ValueError):
        FA.check_gemm_operands("gemm", m, k, n, has_ln, addresses)


@pytest.mark.parametrize("name", sorted(FA.FP32_SCALAR_OPERANDS))
def test_gemm_domain_fp32_reads_these_by_element(name):
    # the fp32 kernel takes them at any address, the bf16 kernel does not
    addresses = dict(ALIGNED, **{name: BASE + 4})
    FA.check_gemm_operands("gemm", 100, 768, 768, True, addresses, fp32=True)
    with pytest.raises(ValueError):
        FA.check_gemm_operands("gemm", 100, 768, 768, True, addresses)


@pytest.mark.parametrize("name", ["x", "a", "w", "plane"])
def test_gemm_domain_fp32_still_needs_aligned_vectors(name):
    with pytest.raises(ValueError):
        FA.check_gemm_operands("gemm", 100, 768, 768, True,
                               dict(ALIGNED, **{name: BASE + 4}), fp32=True)


def test_gemm_domain_ignores_absent_operands():
    FA.check_gemm_operands("gemm", 100, 768, 768, False, dict(ALIGNED, residual=None, plane=None))


def test_wide_layernorm_without_ln_is_in_the_domain():
    # K > LN_MAX_WIDTH is only refused with the LayerNorm prologue
    FA.check_gemm_operands("gemm", 100, 3072, 768, False, ALIGNED)
    with pytest.raises(ValueError):
        FA.check_gemm_operands("gemm", 100, 3072, 768, True, ALIGNED)


# ---------------------------------------------------------------------------
# the fp32 block backward: gemm_dgrad, gemm_wgrad, the route
# ---------------------------------------------------------------------------

CELL_ROWS = 64 * 213  # a stage-2 step at bs 64: 13,632 rows, 426 stages of 32


@pytest.mark.parametrize("m,k,n", [
    (CELL_ROWS, 768, 3072),     # c_proj's dgrad (QuickGELU' in its epilogue): K = 768, N = hid
    (CELL_ROWS, 3072, 768),     # c_fc's
    (CELL_ROWS, 768, 768),      # out_proj's
    (CELL_ROWS, 2304, 768),     # in_proj's
    (64 * 77, 1536, 512),       # the text tower's in_proj
    (30, 256, 64),              # a ragged M
])
def test_dgrad_domain_accepts(m, k, n):
    # the weight is read as (N, K) rows: the reduction runs along them
    FA.check_gemm_operands("gemm_dgrad", m, k, n, False,
                           dict(dy=BASE, w=BASE + 4096, gelu_input=BASE + 8192), fp32=True)


@pytest.mark.parametrize("name", ["dy", "w", "gelu_input", "act"])
def test_dgrad_domain_refuses_an_unaligned_operand(name):
    # TMA reads dy and w; the epilogue reads the pre-activation and writes
    # the activation in 8-byte pairs
    addresses = dict(dy=BASE, w=BASE + 4096, gelu_input=BASE + 8192, act=BASE + 12288)
    addresses[name] += 4
    with pytest.raises(ValueError):
        FA.check_gemm_operands("gemm_dgrad", 100, 768, 3072, False, addresses, fp32=True)


@pytest.mark.parametrize("r,m,n", [
    (CELL_ROWS, 768, 2304),     # in_proj: h1^T dqkv
    (CELL_ROWS, 768, 768),      # out_proj
    (CELL_ROWS, 768, 3072),     # c_fc
    (CELL_ROWS, 3072, 768),     # c_proj: QuickGELU(h)^T g
    (CELL_ROWS + 1, 768, 768),  # a reduction not a multiple of 32: the last stage zero-filled
    (30, 64, 192),              # the CPU tests' tiny block, 30 rows
    (1, 4, 8),                  # one row, the narrowest output
])
def test_wgrad_domain_accepts(r, m, n):
    FA.check_wgrad_operands("gemm_wgrad", r, m, n, dict(x=BASE, dy=BASE + 4096))


@pytest.mark.parametrize("r,m,n,addresses,why", [
    (100, 770, 768, {}, "M not a multiple of 4: x's rows are not 16 bytes"),
    (100, 768, 772, {}, "N not a multiple of 8"),
    (0, 768, 768, {}, "no rows"),
    (100, 0, 768, {}, "M = 0"),
    (2 ** 31, 768, 768, {}, "R past a tensor map's extent"),
    (100, 768, 768, dict(x=BASE + 4), "x not 16-byte aligned"),
    (100, 768, 768, dict(dy=BASE + 8), "dy not 16-byte aligned"),
])
def test_wgrad_domain_refuses(r, m, n, addresses, why):
    with pytest.raises(ValueError):
        FA.check_wgrad_operands("gemm_wgrad", r, m, n, addresses)


def _split_ranges(r, splits):
    """The kernel's k-stage ranges (TileOrder::kspan): [s nk / S, (s+1) nk / S)."""
    nk = -(-r // 32)
    return [(s * nk // splits, (s + 1) * nk // splits) for s in range(splits)]


@pytest.mark.parametrize("r,m,n,splits", [
    (CELL_ROWS, 768, 768, 11),     # 36 tiles x 11 = 3 waves of 132 blocks, 39 stages each
    (CELL_ROWS, 768, 2304, 6),     # 108 tiles x 6 = 4.9 waves, 71 stages each
    (CELL_ROWS, 768, 3072, 11),    # 144 tiles x 11 = 12 waves, 39 stages each
    (CELL_ROWS, 3072, 768, 11),
    (30, 64, 192, 1),              # one stage: nothing to split
    (64 * 77, 512, 512, 8),        # the text tower: 16 tiles x 8 = 1 wave, 20 stages
])
def test_wgrad_splits_at_the_main_shapes(r, m, n, splits):
    assert FA.wgrad_splits(r, m, n, 132) == splits
    # within a tenth of a perfect spread of the tiles' stages over the SMs
    tiles, nk = -(-m // 128) * -(-n // 128), -(-r // 32)
    longest = -(-tiles * splits // 132) * -(-nk // splits)
    assert longest <= 1.1 * tiles * nk / 132 + nk / splits


@pytest.mark.parametrize("r", [1, 31, 32, 33, 100, 4095, CELL_ROWS, CELL_ROWS + 17])
@pytest.mark.parametrize("m,n", [(768, 768), (64, 64), (3072, 768)])
def test_wgrad_split_ranges_cover_the_reduction_once(r, m, n):
    splits = FA.wgrad_splits(r, m, n, 132)
    nk = -(-r // 32)
    assert 1 <= splits <= min(16, nk)
    ranges = _split_ranges(r, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == nk
    assert all(k0 < k1 for k0, k1 in ranges)                       # none empty
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))   # contiguous


def _route_case(d, hid, rows=(2, 9), dtype=torch.float32):
    w = [torch.ones(d), torch.zeros(d), torch.zeros(d, 3 * d), torch.zeros(3 * d),
         torch.zeros(d, d), torch.zeros(d), torch.ones(d), torch.zeros(d),
         torch.zeros(d, hid), torch.zeros(hid), torch.zeros(hid, d), torch.zeros(d)]
    return torch.zeros(*rows, d, dtype=dtype), w


@pytest.mark.parametrize("d,hid,rows,route", [
    (64, 256, (2, 9), "chain"),       # fp32 CPU tensors: the chain on the plain versions
    (768, 3072, (64, 213), "chain"),  # the cell's block, 13,632 rows
    (512, 2048, (3, 77), "chain"),    # the text tower, 231 rows: ragged
    (48, 192, (2, 9), "plain"),       # D not a multiple of 32: outside the kernels' domain
    (64, 200, (2, 9), "plain"),       # the hidden width not a multiple of 32
])
def test_block_backward_route(d, hid, rows, route):
    x, w = _route_case(d, hid, rows)
    heads = max(d // 64, 1)
    assert FA.block_backward_route(x, w, heads) == route
    assert FA.block_backward_route(x.bfloat16(), w, heads) == "plain"


def test_block_backward_outside_the_domain_counts_a_fallback():
    """A block whose width leaves the kernels' domain takes the plain block's
    recompute, counted in `fused_block_backward.plain`, with the gradients
    of plain autograd."""
    gen = torch.Generator().manual_seed(3)
    d, hid, heads = 48, 192, 4
    w = [1 + 0.1 * torch.randn(d, generator=gen), 0.1 * torch.randn(d, generator=gen),
         0.1 * torch.randn(d, 3 * d, generator=gen), 0.01 * torch.randn(3 * d, generator=gen),
         0.1 * torch.randn(d, d, generator=gen), 0.01 * torch.randn(d, generator=gen),
         1 + 0.1 * torch.randn(d, generator=gen), 0.1 * torch.randn(d, generator=gen),
         0.1 * torch.randn(d, hid, generator=gen), 0.01 * torch.randn(hid, generator=gen),
         0.05 * torch.randn(hid, d, generator=gen), 0.01 * torch.randn(d, generator=gen)]
    w = [t.requires_grad_() for t in w]
    x = torch.randn(2, 5, d, generator=gen).requires_grad_()
    before = (FA.fused_block_backward.launches, FA.fused_block_backward.plain)
    out = FA.fused_block_autograd(x, *w, heads)
    got = torch.autograd.grad(out.sum(), [x, *w])
    assert (FA.fused_block_backward.launches, FA.fused_block_backward.plain) == (
        before[0], before[1] + 1)
    want = torch.autograd.grad(FA._block_xla_impl(FA._block_params(w), x, heads, None).sum(),
                               [x, *w])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# mha_core: which kernel a sequence length runs
# ---------------------------------------------------------------------------


def test_long_sequences_share_the_layout_rules():
    # beyond 256 tokens everything but the length limit still holds
    ok = ((2, 442, 12, 64), (442 * 768, 768, 64, 1))
    assert TA.head_row_stride(*ok, BASE, 2) == 768
    for shape, strides, address in [
            ((2, 442, 12, 32), (442 * 384, 384, 32, 1), BASE),         # head width 32
            ((2, 442, 12, 64), (442 * 772, 772, 64, 1), BASE),         # rows not 16-byte multiples
            ((2, 442, 12, 64), (442 * 768, 768, 64, 1), BASE + 8),     # base not aligned
            ((2, 12, 442, 64), (442 * 768, 64, 442 * 64, 1), BASE)]:   # transposed heads
        with pytest.raises(ValueError):
            TA.head_row_stride(shape, strides, address, 2)


def test_whole_row_limit_matches_the_kernel_source():
    import os
    import re

    src = os.path.join(os.path.dirname(TA.__file__), "..", "csrc", "block_kernels.cu")
    m = re.search(r"ATT_WHOLE_ROW_MAX_S = (\d+);", open(src).read())
    assert m and int(m.group(1)) == TA.WHOLE_ROW_MAX_SEQ == 256


def _block_source_values(struct=None):
    """Every `constexpr int NAME = expr;` of csrc/block_kernels.cu (or of its
    `struct <struct> { ... };` alone) whose expression is integer arithmetic
    of earlier ones, evaluated in order."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(FA.__file__), "..", "csrc",
                            "block_kernels.cu")).read()
    if struct is not None:
        src = re.search(r"struct " + struct + r" \{(.*?)\n\};", src, re.S).group(1)
    values = {}
    for decl in re.findall(r"constexpr int (\w+\s*=[^;]+);", src, re.S):
        for part in decl.split(","):
            name, expr = (t.strip() for t in part.split("=", 1))
            try:
                values[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, dict(values))
            except (NameError, SyntaxError):
                pass  # an expression of a function's arguments
    return values


def test_ln_gemm_smem_fits_the_widest_row():
    """The bf16 GEMM behind ln_gemm and gemm_bias_residual, by its source's
    constants: the ring of four stages (256-row A tiles, two 64-column halves
    of a 64-deep W stage) and the barriers, with 1024 bytes of alignment,
    stay under the 232448 bytes a block can ask for, at every K; a bf16
    LayerNorm runs first in ln_rows' kernel, whose widest row covers
    LN_MAX_K."""
    v, sh = _block_source_values(), _block_source_values("GemmShape")
    assert v["LN_MAX_K"] == FA.LN_MAX_WIDTH == 1024
    assert v["LNR_MAX_K"] == FA.LN_ROWS_MAX_WIDTH >= v["LN_MAX_K"]
    assert sh["ROWS"] == 256 and sh["STAGES"] == 4 and sh["BK"] == 64
    assert sh["STAGE"] == sh["ROWS"] * 128 + 2 * sh["BK"] * 128
    assert sh["SMEM"] == 1024 + sh["STAGES"] * sh["STAGE"] + 256 <= v["SMEM_MAX"] == 232448
    assert 2 * 8 * sh["STAGES"] <= 256  # a full and an empty barrier per stage


@pytest.mark.parametrize("mode", ["qkv", "gelu", "residual"])
def test_bf16_layer_norm_is_ln_rows_then_the_plain_product(mode):
    """The bf16 LayerNorm of ln_gemm and gemm_bias_residual is ln_rows'
    LayerNorm followed by the product without it, bit for bit, which is how
    the card runs it: the qkv splice goes into the LayerNorm's input, the
    residual's stays with the residual (plain versions, CPU)."""
    gen = torch.Generator().manual_seed(7)

    def t(*shape, std=1.0, mean=0.0, dtype=torch.bfloat16):
        return (mean + std * torch.randn(*shape, generator=gen)).to(dtype)

    b, s, k, n = 2, 13, 64, 48
    x = t(b, s, k, mean=3.0)
    g, gb = t(k, mean=1.0, std=0.1, dtype=torch.float32), t(k, std=0.1, dtype=torch.float32)
    w, bias = t(k, n, std=k ** -0.5), t(n, std=0.02)
    pmask = torch.zeros(s)
    pmask[1:3] = 1.0
    if mode == "residual":
        res, plane = t(b, s, n), t(s, n)
        got = FA.gemm_bias_residual(x, w, bias, res, plane, pmask, ln_scale=g, ln_bias=gb,
                                    eps=1e-6)
        want = FA.gemm_bias_residual(FA.ln_rows(x, g, gb, k, 1e-6), w, bias, res, plane, pmask)
    else:
        plane = t(s, k) if mode == "qkv" else None
        mask = pmask if mode == "qkv" else None
        gelu = mode == "gelu"
        got = FA.ln_gemm(x, g, gb, w, bias, gelu, plane, mask)
        want = FA.ln_gemm(FA.ln_rows(x, g, gb, k, 1e-5, plane, mask), None, None, w, bias, gelu)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,has_ln,made", [
    (torch.bfloat16, True, True),
    (torch.bfloat16, False, False),
    (torch.float32, True, False),
])
def test_ln_scratch_only_for_the_bf16_prologue(dtype, has_ln, made):
    # the normalised rows of a bf16 LayerNorm, which ln_rows' kernel writes
    # and the product reads by TMA; the fp32 kernel normalises in registers
    x = torch.zeros(3, 213, 64, dtype=dtype)
    scratch = FA._ln_scratch(x, has_ln)
    if not made:
        assert scratch is None
        return
    assert scratch.dtype == x.dtype and scratch.shape == x.shape and scratch.is_contiguous()


# ---------------------------------------------------------------------------
# ln_proj_tail: tail_kernel_route
# ---------------------------------------------------------------------------

TAIL_ALIGNED = dict(x=BASE, proj=BASE + 2 ** 20, ln_scale=BASE + 2 ** 21,
                    ln_bias=BASE + 2 ** 21 + 4096, y=BASE + 2 ** 22, p=BASE + 2 ** 23)


@pytest.mark.parametrize("b,d,e,bf16,route", [
    (128, 768, 512, True, "wgmma"),    # ViT-B/16, one extraction pass
    (512, 768, 512, True, "wgmma"),    # IVLP serving
    (1, 768, 512, True, "wgmma"),      # one row: B is free
    (70, 1024, 768, True, "wgmma"),    # ViT-L/14
    (256, 1792, 1024, True, "wgmma"),  # EVA02-CLIP-E/14
    (3, 2048, 64, True, "wgmma"),      # the widest bf16 tail
    (64, 64, 8, True, "wgmma"),        # the smallest D and E
    (130, 768, 520, True, "wgmma"),    # E a multiple of 8, not of the 64-column tile
    (128, 768, 512, False, "tf32x3"),  # fp32: an extraction pass, the parity runs
    (33, 96, 40, True, "fma"),         # D off the 64-wide K block
    (33, 768, 516, True, "fma"),       # E not a multiple of 8
    (5, 32, 16, False, "tf32x3"),      # the narrowest fp32 tail: one K block of 32
    (64, 768, 512, False, "tf32x3"),   # fp32 training: the batch's 64 CLS rows
    (1, 768, 512, False, "tf32x3"),    # fp32, one row
    (512, 768, 512, False, "tf32x3"),  # fp32, IVLP serving's batch
    (70, 1024, 768, False, "tf32x3"),  # fp32, the 3xTF32 kernel's widest: ViT-L/14
    (256, 1792, 1024, False, "fma"),   # fp32 past it: EVA02-CLIP-E/14
    (9, 1056, 64, False, "fma"),       # one fp32 K block past it
    (33, 768, 516, False, "tf32x3"),   # fp32 rows of p are 16 bytes at E % 4 == 0
    (65, 640, 200, False, "tf32x3"),   # 20 K blocks: the cluster's ranks take 2 or 3
    (33, 96, 40, False, "tf32x3"),     # D off 64 is a whole number of fp32 K blocks
    (9, 80, 24, False, "fma"),         # D off the 32-wide fp32 K block
    (9, 768, 514, False, "fma"),       # E not a multiple of 4
])
def test_tail_route(b, d, e, bf16, route):
    assert FT.tail_kernel_route(b, d, e, bf16, TAIL_ALIGNED) == route


@pytest.mark.parametrize("name", sorted(TAIL_ALIGNED))
def test_tail_route_takes_the_fma_kernel_for_an_unaligned_base(name):
    # the wgmma kernel moves every operand as 16-byte vectors or by TMA
    addresses = dict(TAIL_ALIGNED, **{name: TAIL_ALIGNED[name] + 4})
    assert FT.tail_kernel_route(128, 768, 512, True, addresses) == "fma"
    assert FT.tail_kernel_route(128, 768, 512, False, addresses) == "fma"


@pytest.mark.parametrize("b,d,e,why", [
    (128, 2112, 512, "D wider than the rows a block keeps"),
    (128, 0, 512, "D = 0"),
    (128, 768, 0, "E = 0"),
    (2 ** 31, 768, 512, "B past 32 bits"),
])
def test_tail_route_refuses(b, d, e, why):
    for bf16 in (True, False):
        with pytest.raises(ValueError):
            FT.tail_kernel_route(b, d, e, bf16, TAIL_ALIGNED)


@pytest.mark.parametrize("name", sorted(TAIL_ALIGNED))
@pytest.mark.parametrize("offset", [4, 8])
def test_tail_fp32_route_takes_the_fma_kernel_off_16_bytes(name, offset):
    # the tf32x3 kernel reads x, gamma and beta and stores y and p as 16-byte
    # vectors, and TMA reads proj: any base off 16 bytes leaves its domain
    assert FT.tail_kernel_route(64, 768, 512, False, TAIL_ALIGNED) == "tf32x3"
    addresses = dict(TAIL_ALIGNED, **{name: TAIL_ALIGNED[name] + offset})
    assert FT.tail_kernel_route(64, 768, 512, False, addresses) == "fma"


def _tail_source_values():
    """Every `constexpr int NAME = expr;` of csrc/tail_kernel.cu, evaluated in
    order (integer arithmetic), and `tail_tf32_smem`'s return expression as a
    function of kb_max."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(FT.__file__), "..", "csrc", "tail_kernel.cu")).read()
    values = {}
    for decl in re.findall(r"constexpr int (\w+ = [^;]+);", src):
        for part in decl.split(","):  # `constexpr int A = 1, B = 2;`
            name, expr = (t.strip() for t in part.split("="))
            values[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, dict(values))
    body = re.search(r"int tail_tf32_smem\(int kb_max\) \{(.*?)\n\}", src, re.S).group(1)
    expr = re.search(r"return ([^;]+);", body).group(1)
    return values, lambda kb_max: eval(expr.replace("/", "//"), {"__builtins__": {}},
                                       dict(values, kb_max=kb_max))


def test_tail_tf32x3_smem_fits_from_the_source_constants():
    """The fp32 kernel's shared memory, by the source's own constants and
    formula (per K block of a rank: the proj slice and the split y tiles;
    the eight ranks' partial slabs, the row sums of both passes, the
    barriers, up to 1024 bytes of alignment): under the 232448 bytes a block
    can ask for at D = TF32_MAX_WIDTH (D / 32 K blocks over a cluster of 8,
    a lane of a rank owning one 16-byte chunk of the rank's share), and at
    ViT-B/16's 768 small enough for two blocks on an SM (233472 bytes, 1 KB
    reserved per block), as the kernel's launch bounds ask."""
    v, smem = _tail_source_values()
    assert v["TF_MAX_D"] == FT.TF32_MAX_WIDTH and v["TF_RANKS"] <= 8  # a portable cluster
    assert v["TF_ROWS"] == v["TF_COLS"] == 64 and v["TF_THREADS"] == 256
    assert v["TF_ROWS"] % v["TF_RANKS"] == 0

    def kb_max(d):
        return -(-(d // v["TF_KB"]) // v["TF_RANKS"])

    assert kb_max(FT.TF32_MAX_WIDTH) == v["TF_MAX_KB"]
    assert 8 * v["TF_MAX_KB"] <= 32  # 16-byte chunks of a rank's columns, one per lane
    assert smem(kb_max(FT.TF32_MAX_WIDTH)) <= 232448
    assert 2 * (smem(kb_max(768)) + 1024) <= 233472


def test_tail_smem_fits_the_widest_row():
    """The wgmma kernel's shared memory at D = MAX_WIDTH, from the constants
    of its source: the panel (32 rows per K block of 64), the ring of 64-row
    proj stages and the barriers stay under the 232448 bytes a block can ask
    for; a lane's chunks of a row cover the widest row."""
    v, _ = _tail_source_values()
    stages, max_d = v["TW_STAGES"], v["TW_MAX_D"]
    assert max_d == FT.MAX_WIDTH and stages % 2 == 0
    assert v["TW_PB"] == v["TW_ROWS"] * 128 and v["TW_KB"] == 64 * 128
    assert 1024 + max_d // 64 * v["TW_PB"] + stages * v["TW_KB"] + 8 * stages <= 232448
    assert 32 * (max_d // 256) * 8 >= max_d and 256 * v["TW_NV_NARROW"] == 1024
    # and the FMA kernel's 16 fp32 rows
    assert 16 * FT.MAX_WIDTH * 4 <= 232448
