"""The exact fp32 attention core's gradient on the CPU: `mha_core_lse` and
`mha_core_backward` take their plain versions for CPU tensors (the kernels,
csrc/block_kernels.cu, run only on the card:
tests/test_torch_block_backward_card.py), and `mha_core_backward_reference`
is held to float64 autograd through the plain core at the sequences the port
trains on; the kernels' shared memory, from the source's own constants, fits
a block."""

import math
import os
import re

import pytest
import torch

from tpu_reid_torch.models import layers as TL
from tpu_reid_torch.ops import attention as TA
from tpu_reid_torch.ops import fused_attention as FA

# fp32 scores, exponentials and sums over up to 444 keys against float64:
# ~1e-6 of a gradient's largest entry; 1e-5 leaves ten times that
TOL = 1e-5


def _case(b, s, heads, causal, seed):
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, s, 3 * 64 * heads, generator=gen)
    do = torch.randn(b, s, heads, 64, generator=gen)
    return qkv, do, TL.causal_mask(s) if causal else None


def _rel(got, want):
    return float((got.double() - want.detach()).abs().max() / want.detach().abs().max())


def core64(q, k, v, mask=None):
    """The exact softmax attention core in float64, written plainly: the
    tests' ground truth."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = s + mask.to(s)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("b,s,heads,causal", [
    (1, 213, 2, False),  # a stage-2 step's sequence
    (2, 77, 2, True),    # the text tower's, causal
    (1, 444, 1, False),  # the vehicle geometry's
    (2, 37, 3, False),   # ragged to every tile of the kernels
])
def test_backward_reference_matches_float64_autograd(b, s, heads, causal):
    qkv, do, mask = _case(b, s, heads, causal, seed=s + heads)
    views = FA._qkv_views(qkv, heads)
    o, lse = TA.mha_core_lse(*views, mask)
    got = TA.mha_core_backward_reference(*views, o, do, lse, mask)

    x = qkv.double().requires_grad_()
    want_o = core64(*FA._qkv_views(x, heads), mask)
    (want,) = torch.autograd.grad(want_o, x, do.double())
    d = 64 * heads
    for i, g in enumerate(got):
        assert g.shape == views[i].shape and g.dtype == torch.float32
        assert _rel(g, want[..., i * d:(i + 1) * d].reshape(g.shape)) <= TOL


def test_lse_is_the_rows_log_sum_exp():
    qkv, _, mask = _case(2, 77, 2, True, seed=1)
    q, k, v = FA._qkv_views(qkv, 2)
    o, lse = TA.mha_core_lse(q, k, v, mask)
    assert lse.shape == (2, 2, 77) and lse.dtype == torch.float32
    scores = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / math.sqrt(64)
    want = torch.logsumexp(scores + mask.double(), dim=-1)
    assert float((lse.double() - want).abs().max()) <= 1e-5
    assert torch.equal(o, TA.mha_core_reference(q, k, v, mask))


def test_backward_on_the_cpu_packs_the_plain_gradients():
    """On CPU tensors `mha_core_backward` is the plain version's dq | dk | dv
    in the layout of the packed qkv's gradient, and counts no launch."""
    qkv, do, _ = _case(2, 30, 2, False, seed=2)
    views = FA._qkv_views(qkv, 2)
    o, lse = TA.mha_core_lse(*views)
    before = TA.mha_core_backward.launches
    got = TA.mha_core_backward(*views, o, do, lse)
    assert TA.mha_core_backward.launches == before
    assert got.shape == qkv.shape
    for i, g in enumerate(TA.mha_core_backward_reference(*views, o, do, lse)):
        assert torch.equal(got[..., 128 * i:128 * (i + 1)], g.reshape(2, 30, 128))


def _source_values():
    """Every `constexpr int NAME = expr;` of csrc/block_kernels.cu up to the
    backward kernels' sizes, evaluated in order (integer arithmetic)."""
    src = open(os.path.join(os.path.dirname(TA.__file__), "..", "csrc",
                            "block_kernels.cu")).read()
    values = {}
    for decl in re.findall(r"constexpr int (\w+\s*=[^;]+);", src, re.S):
        for part in decl.split(","):
            name, expr = (t.strip() for t in part.split("=", 1))
            try:
                values[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, dict(values))
            except (NameError, SyntaxError):
                pass  # an expression of a function's arguments
    return values


def test_backward_kernels_shared_memory_fits_a_block():
    """Both passes' shared memory, by the source's own constants: the own
    rows' split operands, the ring of two raw stages, a streamed tile split
    twice, the row statistics, the barriers and up to 1024 bytes of
    alignment, under the 232448 bytes a block can ask for; every tile at a
    1024-byte multiple (the swizzle's period)."""
    v = _source_values()
    assert v["TB_ROWS"] == 128 and v["TB_T"] == 32 and v["TB_THREADS"] == 256
    for name in ("TB_DQ_SMEM", "TB_DKV_SMEM"):
        assert v[name] <= 232448, (name, v[name])
    for name in ("TB_OWN", "TB_TILE", "TB_TR", "TB_RAW"):
        assert v[name] % 1024 == 0, name
    # the transposed tile's rows are one 128-byte swizzle row of TB_T values
    assert v["TB_T"] * 4 == 128
    # every thread takes the own rows' loads in equal rounds (their sums shuffle
    # across 16 lanes)
    assert v["TB_ROWS"] * 16 % (v["TB_LOADS"] * v["TB_THREADS"]) == 0
