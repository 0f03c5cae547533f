"""tpu_reid_torch.ops.minsum: the plain min-sum held against the JAX
package's Pallas kernel (interpret mode) and its XLA oracle on the same
row-quantized inputs; the fp8 row quantization bit for bit against JAX's;
the CUDA kernel against its plain version where a card is present."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_reid.ops import minsum as JM
from tpu_reid_torch.ops._build import kernel_impl
from tpu_reid_torch.ops import minsum as TM
from tpu_reid_torch.retrieval import rerank_stream as TS

JDT = {"fp8": jnp.float8_e4m3fn, "bf16": jnp.bfloat16, "fp32": jnp.float32}
TDT = {"fp8": torch.float8_e4m3fn, "bf16": torch.bfloat16, "fp32": torch.float32}
FMAX = {"fp8": 448.0, "bf16": 1.0, "fp32": 1.0}


def _operands(seed, na, nb, c, kind):
    """Non-negative rows quantized per row as the re-ranking pipeline does
    (values + one fp32 scale per row), as numpy bytes both packages read."""
    rng = np.random.RandomState(seed)
    a = (rng.rand(na, c) ** 3).astype(np.float32)
    b = (rng.rand(nb, c) ** 3).astype(np.float32)
    asc = (a.max(1) / FMAX[kind]).astype(np.float32)
    bsc = (b.max(1) / FMAX[kind]).astype(np.float32)
    aq = np.array(jnp.asarray(a / asc[:, None], JDT[kind]))
    bq = np.array(jnp.asarray(b / bsc[:, None], JDT[kind]))
    return aq, asc, bq, bsc


def _torch(x, kind):
    """numpy array of a JAX low-precision dtype -> torch tensor, bit for bit."""
    if kind == "fp8":
        return torch.from_numpy(x.view(np.uint8)).view(torch.float8_e4m3fn)
    if kind == "bf16":
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


@pytest.mark.parametrize("kind", ["fp8", "bf16", "fp32"])
@pytest.mark.parametrize("na,nb,c", [(70, 130, 300), (9, 17, 130)])
def test_minsum_reference_matches_jax(kind, na, nb, c):
    aq, asc, bq, bsc = _operands(1, na, nb, c, kind)
    ja = (jnp.asarray(aq), jnp.asarray(asc), jnp.asarray(bq), jnp.asarray(bsc))
    tiled = np.asarray(JM.minsum_tiled(*ja, block_a=32, block_b=128, block_c=128,
                                       interpret=True))
    oracle = np.asarray(JM.minsum_reference(*ja))
    got = TM.minsum_reference(_torch(aq, kind), torch.from_numpy(asc), _torch(bq, kind),
                              torch.from_numpy(bsc))
    assert got.dtype == torch.float32 and tuple(got.shape) == (na, nb)
    np.testing.assert_allclose(got.numpy(), tiled, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-4)


def test_minsum_zero_padding_exact():
    """Non-negative fp32 rows with unit scales, as the exact route's
    Jaccard: the chunked plain version against numpy and the Pallas
    kernel's zero-padded tiles, within 1e-6."""
    rng = np.random.RandomState(2)
    a = rng.rand(9, 130).astype(np.float32)
    b = rng.rand(17, 130).astype(np.float32)
    ones_a, ones_b = np.ones(9, np.float32), np.ones(17, np.float32)
    want = np.minimum(a[:, None, :], b[None, :, :]).sum(-1)
    tiled = np.asarray(JM.minsum_tiled(jnp.asarray(a), jnp.asarray(ones_a), jnp.asarray(b),
                                       jnp.asarray(ones_b), block_a=8, block_b=128,
                                       block_c=128, interpret=True))
    got = TM.minsum_reference(*map(torch.from_numpy, (a, ones_a, b, ones_b))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, tiled, rtol=1e-6, atol=1e-6)


def test_minsum_reference_chunks_do_not_change_the_result(monkeypatch):
    """Chunking over rows, columns and C (forced small here) is a
    re-association of the same fp32 sums."""
    aq, asc, bq, bsc = _operands(3, 37, 600, 2500, "bf16")
    args = (_torch(aq, "bf16"), torch.from_numpy(asc), _torch(bq, "bf16"),
            torch.from_numpy(bsc))
    whole = TM.minsum_reference(*args)
    monkeypatch.setattr(TM, "_CHUNK_ELEMS", 3 * 512 * 2048)
    chunked = TM.minsum_reference(*args)
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-5)


def test_fp8_cast_matches_jax_bit_for_bit():
    """torch's and JAX's fp32 -> float8_e4m3fn casts agree on every value
    the quantizer produces (round to nearest even, 448.5 -> 448)."""
    rng = np.random.RandomState(4)
    x = np.concatenate([rng.uniform(0, 460, 200_000).astype(np.float32),
                        np.float32([0.0, 448.0, 448.5, 1e-9, 0.0019531, 240.0])])
    got = torch.from_numpy(x).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(np.uint8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["fp8", "fp32"])
def test_row_quantization_matches_jax_bit_for_bit(kind):
    """The V_qe row quantization (scale = row max / dtype max, values cast,
    true row sums) against the JAX pipeline's on the same fp32 rows."""
    rng = np.random.RandomState(5)
    acc = (rng.rand(33, 257) ** 4 / 15).astype(np.float32)
    acc[3] = 0.0  # an empty row keeps the 1e-30 floor
    q, scale, qsum = TS.quantize_rows(torch.from_numpy(acc), TDT[kind])
    fmax = FMAX[kind]
    jscale = jnp.maximum(jnp.max(jnp.asarray(acc), axis=1), 1e-30) / fmax
    jq = (jnp.asarray(acc) / jscale[:, None]).astype(JDT[kind])
    jsum = jnp.sum(jq.astype(jnp.float32), axis=1) * jscale
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    if kind == "fp8":
        np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                      np.asarray(jq).view(np.uint8))
    else:
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(qsum.numpy(), np.asarray(jsum), rtol=1e-6)


@pytest.mark.parametrize("impl", ["auto", "kernel", "plain"])
def test_minsum_dispatch_takes_the_plain_version_on_the_cpu(impl):
    aq, asc, bq, bsc = _operands(6, 5, 7, 40, "fp32")
    args = tuple(map(torch.from_numpy, (aq, asc, bq, bsc)))
    before = TM.minsum_kernel.launches
    with kernel_impl(impl):
        got = TM.minsum(*args)
    assert TM.minsum_kernel.launches == before  # nothing launched on the host
    torch.testing.assert_close(got, TM.minsum_reference(*args))


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the minsum kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("kind,na,nb,c", [("fp8", 70, 130, 300), ("fp8", 70, 130, 304),
                                          ("bf16", 1000, 300, 2500),
                                          ("fp32", 257, 513, 1029), ("fp32", 9, 17, 130)])
def test_cuda_minsum_kernel_matches_plain(cuda, kind, na, nb, c):
    aq, asc, bq, bsc = _operands(7, na, nb, c, kind)
    args = (_torch(aq, kind).to(cuda), torch.from_numpy(asc).to(cuda),
            _torch(bq, kind).to(cuda), torch.from_numpy(bsc).to(cuda))
    got = TM.minsum_kernel(*args)
    want = TM.minsum_reference(*args)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
