"""The precision argument of the fp32 block kernels (3xTF32), checked on the
CPU, where no tensor core runs.

csrc/block_kernels.cu computes its fp32 products on the tensor cores in
TF32, which keeps 10 of fp32's 23 mantissa bits. Each operand x is split
once as it reaches shared memory, hi = cvt.rna.tf32.f32(x) and
lo = cvt.rna.tf32.f32(x - hi), and every k8 step of the product adds
lo*hi, then hi*lo, then hi*hi into one fp32 accumulator: only lo*lo (about
2^-22 of a product) is dropped. Here a test-only emulation of the rounding
(round to nearest, ties away from zero, to 10 mantissa bits, by bit
operations on an int32 view) runs that product at the block's depths
(K = 768 and 3072) on operands from a numpy seed, against an fp64
reference: it stays within 1e-5 of max|ref| (the kernels are held to 1e-4
of their plain versions on the card) and within 4x of plain fp32
torch.matmul's own error, where a single TF32 pass misses 1e-4. The CLS
tail's kernel (csrc/tail_kernel.cu) splits D over the eight blocks of a
cluster, statistics and product alike: its order of sums is emulated too.
"""

import numpy as np
import pytest
import torch


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (ties away from zero), as fp32: the
    magnitude bits plus half of the 13 dropped bits' unit, then those bits
    cleared. A carry into the exponent is the round-up into the next
    binade."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, k_step: int = 8) -> torch.Tensor:
    """The kernels' product: per k8 step, lo*hi, hi*lo, then hi*hi added to
    one fp32 accumulator (each TF32 product is exact in fp32: 11 x 11
    significant bits)."""
    (ah, al), (bh, bl) = split(a), split(b)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], k_step):
        s = slice(k, k + k_step)
        acc = acc + al[:, s] @ bh[s]
        acc = acc + ah[:, s] @ bl[s]
        acc = acc + ah[:, s] @ bh[s]
    return acc


def test_the_rounding_keeps_ten_mantissa_bits_and_rounds_ties_away():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.integers(-8, 8, 4096)).astype(
        np.float32))
    hi, lo = split(x)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert bool(((x - hi).abs() <= x.abs() * 2.0 ** -11).all())
    # hi + lo carries all but about 2^-22 of x
    assert bool(((x.double() - hi.double() - lo.double()).abs()
                 <= x.abs().double() * 2.0 ** -21).all())
    one = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12])
    assert tf32_rna(one).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]


@pytest.mark.parametrize("k", [768, 3072])
def test_three_tf32_passes_are_as_good_as_fp32(k):
    rng = np.random.default_rng(k)
    a = rng.standard_normal((128, k)).astype(np.float32)
    b = (rng.standard_normal((k, 128)) * k ** -0.5).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    at, bt = torch.from_numpy(a), torch.from_numpy(b)

    def rel(t):
        return float(np.abs(t.double().numpy() - ref).max() / scale)

    three, fp32, one = rel(tf32x3_matmul(at, bt)), rel(at @ bt), rel(tf32_rna(at) @ tf32_rna(bt))
    assert three <= 1e-5, three
    assert three <= 4 * fp32, (three, fp32)
    assert one > 1e-4, one


def tail_tf32x3(x, g, b, proj, ranks=8, k_block=32, eps=1e-5):
    """The fp32 CLS tail kernel's arithmetic (csrc/tail_kernel.cu,
    ln_proj_tail_tf32x3_kernel): D is cut into K blocks of 32, rank r of a
    cluster of 8 takes blocks [r n / 8, (r + 1) n / 8); each statistics pass
    sums a rank's columns and the eight partial sums are added in rank
    order; a rank's k8 steps are halved between two warpgroups, each running
    the three TF32 passes, and the two partial tiles are added, then the
    eight ranks' tiles in rank order."""
    d = x.shape[1]
    nkb = d // k_block
    cuts = [(r * nkb // ranks * k_block, (r + 1) * nkb // ranks * k_block) for r in range(ranks)]

    def in_rank_order(parts):
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total

    mean = in_rank_order([x[:, lo:hi].sum(1) for lo, hi in cuts]) / d
    dev = x - mean[:, None]
    var = in_rank_order([(dev[:, lo:hi] ** 2).sum(1) for lo, hi in cuts]) / d
    y = dev * torch.rsqrt(var + eps)[:, None] * g + b
    tiles = []
    for lo, hi in cuts:
        mid = lo + (hi - lo) // 16 * 8  # half of the rank's k8 steps
        tiles.append(tf32x3_matmul(y[:, lo:mid], proj[lo:mid])
                     + tf32x3_matmul(y[:, mid:hi], proj[mid:hi]))
    return y, in_rank_order(tiles)


@pytest.mark.parametrize("b,d,e", [(64, 768, 512), (37, 1024, 768), (5, 640, 200)])
def test_the_tail_kernels_split_holds_fp32(b, d, e):
    """The fp32 tail kernel's K split (statistics and product over the eight
    ranks of a cluster, the product in three TF32 passes) against fp64 on
    operands from a numpy seed: y within 1e-6 and p within 1e-5 of max|ref|,
    and within 4x of the plain fp32 version's own error (the card holds the
    kernel to that plain version within 1e-4)."""
    from tpu_reid_torch.ops import fused_tail as FT

    rng = np.random.default_rng(d + b)
    x = (rng.standard_normal((b, d)) + 0.5).astype(np.float32)
    g = (1 + 0.05 * rng.standard_normal(d)).astype(np.float32)
    bb = (0.05 * rng.standard_normal(d)).astype(np.float32)
    proj = (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32)
    x64 = x.astype(np.float64)
    mu = x64.mean(1, keepdims=True)
    y64 = (x64 - mu) / np.sqrt(((x64 - mu) ** 2).mean(1, keepdims=True) + 1e-5) * g + bb
    p64 = y64 @ proj.astype(np.float64)
    t = [torch.from_numpy(v) for v in (x, g, bb, proj)]
    got_y, got_p = tail_tf32x3(*t)
    plain_y, plain_p = FT.ln_proj_tail_reference(*t)

    def rel(got, ref):
        return float(np.abs(got.double().numpy() - ref).max() / np.abs(ref).max())

    assert rel(got_y, y64) <= 1e-6, rel(got_y, y64)
    assert rel(got_p, p64) <= 1e-5, rel(got_p, p64)
    assert rel(got_p, p64) <= 4 * max(rel(plain_p, p64), 1e-7), (rel(got_p, p64), rel(plain_p, p64))
