"""tpu_reid_torch.retrieval re-ranking against tpu_reid.retrieval and the
host golden of tests/golden.py, on the same numpy features: the expansion
sets, the exact and streamed routes (fp32 and the production bf16/fp8
quantization, V_qe bit for bit), the row provider, the Evaluator in every
mode, ties, and the mesh rule."""

import warnings
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tests.golden import golden_k_reciprocal
from tpu_reid.parallel.mesh import make_mesh
from tpu_reid.retrieval import metrics as JM
from tpu_reid.retrieval import rerank as JR
from tpu_reid.retrieval import rerank_stream as JS
from tpu_reid_torch.ops._build import kernel_impl
from tpu_reid_torch.pipelines import zero_shot as TZ
from tpu_reid_torch.retrieval import metrics as TM
from tpu_reid_torch.retrieval import rerank as TR
from tpu_reid_torch.retrieval import rerank_stream as TS


def _workload(seed=0, n_ids=30, nq=60, ng=200, d=32, noise=0.7):
    """The workload of tests/test_rerank_stream.py: clustered, L2-normalised
    features."""
    rng = np.random.RandomState(seed)
    ids_q = rng.randint(0, n_ids, nq)
    ids_g = rng.randint(0, n_ids, ng)
    centers = rng.randn(n_ids, d).astype(np.float32)
    qf = centers[ids_q] + noise * rng.randn(nq, d).astype(np.float32)
    gf = centers[ids_g] + noise * rng.randn(ng, d).astype(np.float32)
    qf /= np.linalg.norm(qf, axis=1, keepdims=True)
    gf /= np.linalg.norm(gf, axis=1, keepdims=True)
    return qf, gf, ids_q, ids_g


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def test_neighbour_lists_and_expansion_sets_match_jax():
    """The stable top-k equals lax.top_k's order, and on those rank lists
    _expansion_sets gives identical integers."""
    qf, gf, _, _ = _workload()
    feat = np.concatenate([qf, gf])
    n, k1p, kh = len(feat), 21, 11
    od = np.array(JR.euclidean_distmat(jnp.asarray(feat), jnp.asarray(feat)))
    _, jrank = lax.top_k(-jnp.asarray(od), k1p)
    trank = TR.smallest_k(torch.from_numpy(od), k1p)
    np.testing.assert_array_equal(trank.numpy(), np.asarray(jrank))
    rows = np.arange(37, 101)
    je_idx, je_val = JR._expansion_sets(jnp.asarray(rows), jrank, jrank[:, :kh], n)
    te_idx, te_val = TR._expansion_sets(torch.from_numpy(rows), trank, trank[:, :kh], n)
    np.testing.assert_array_equal(te_idx.numpy(), np.asarray(je_idx))
    np.testing.assert_array_equal(te_val.numpy(), np.asarray(je_val))


@pytest.mark.parametrize("k1,k2", [(20, 6), (20, 1)])
def test_exact_rerank_matches_jax_and_golden(k1, k2):
    qf, gf, _, _ = _workload()
    want = np.asarray(JR.k_reciprocal_rerank(qf, gf, k1=k1, k2=k2))
    got = TR.k_reciprocal_rerank(*_t(qf, gf), k1=k1, k2=k2)
    assert tuple(got.shape) == (60, 200)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), golden_k_reciprocal(qf, gf, k1, k2, 0.3),
                               atol=2e-3)


def test_exact_rerank_blocks_and_kernel_impl_do_not_change_the_result():
    qf, gf, _, _ = _workload(seed=9, nq=21, ng=70)
    a = TR.k_reciprocal_rerank(*_t(qf, gf), k1=12, k2=4, row_block=8)
    with kernel_impl("kernel"):  # the kernel wrapper takes its plain version here
        b = TR.k_reciprocal_rerank(*_t(qf, gf), k1=12, k2=4, row_block=128)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_sharded_rerank_matches_jax():
    """Gallery shards of 50 (four shards), shard-local neighbourhoods and no
    row normalisation, against the JAX loop on the same shard size."""
    qf, gf, _, _ = _workload(seed=1)
    want = np.asarray(JR.k_reciprocal_rerank_sharded(qf, gf, k1=20, k2=6, shard_size=50))
    got = TR.k_reciprocal_rerank_sharded(*_t(qf, gf), k1=20, k2=6, shard_size=50)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("k2", [6, 1])
def test_streamed_fp32_matches_jax_and_the_exact_route(k2):
    qf, gf, _, _ = _workload(seed=5)
    got = TS.k_reciprocal_rerank_streamed(*_t(qf, gf), k1=20, k2=k2, val_dtype=torch.float32,
                                          qe_dtype=torch.float32)
    want = np.asarray(JS.k_reciprocal_rerank_streamed(
        qf, gf, k1=20, k2=k2, val_dtype=jnp.float32, qe_dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    exact = TR.k_reciprocal_rerank(*_t(qf, gf), k1=20, k2=k2)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=2e-5)


def test_streamed_passes_match_jax_with_v_qe_bit_for_bit():
    """Production dtypes (bf16 sparse V, fp8 V_qe): the rank lists and the
    sparse indices are identical integers and the sparse values agree to a
    bf16 rounding (the fp32 distance rows differ in the last bit); on the
    same sparse V the quantized V_qe values equal JAX's bit for bit (the
    scales to an fp32 rounding: XLA may divide by 448 as a product); the
    blended distances agree."""
    qf, gf, _, _ = _workload(seed=7, nq=47, ng=150)
    feat = np.concatenate([qf, gf])
    n, k1, k2, kh, rb = len(feat), 15, 5, 9, 64
    jmax, jrank = JS._global_ranks(jnp.asarray(feat), k1 + 1, rb)
    tmax, trank = TS._global_ranks(torch.from_numpy(feat), k1 + 1, rb)
    np.testing.assert_array_equal(trank.numpy(), np.asarray(jrank))
    np.testing.assert_allclose(tmax.numpy(), np.asarray(jmax), rtol=1e-6)
    jsidx, jsval = JS._sparse_v(jnp.asarray(feat), jmax, jrank, kh, rb, jnp.bfloat16)
    tsidx, tsval = TS._sparse_v(torch.from_numpy(feat), tmax, trank, kh, rb, torch.bfloat16)
    np.testing.assert_array_equal(tsidx.numpy(), np.asarray(jsidx))
    np.testing.assert_allclose(tsval.float().numpy(), np.asarray(jsval, np.float32),
                               rtol=2 ** -8, atol=0)
    args = (k2, 16, n - 47, 160, 47, 256)  # gallery rows, padded, as _streamed_core aligns
    jq, jscale, jsum = JS._qe_rows_quantized(jsidx, jsval, jrank[:, :k2], *args,
                                             jnp.float8_e4m3fn)
    sval = torch.from_numpy(np.array(jsval).view(np.int16)).view(torch.bfloat16)
    tq, tscale, tsum = TS._qe_rows_quantized(torch.from_numpy(np.array(jsidx)), sval,
                                             trank[:, :k2], *args, torch.float8_e4m3fn)
    assert tuple(tq.shape) == (160, 256) and tq.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(), np.asarray(jq).view(np.uint8))
    np.testing.assert_allclose(tscale.numpy(), np.asarray(jscale), rtol=1e-6)
    np.testing.assert_allclose(tsum.numpy(), np.asarray(jsum), rtol=1e-6)
    got = TS.k_reciprocal_rerank_streamed(*_t(qf, gf), k1=k1, k2=k2, row_block=rb)
    want = np.asarray(JS.k_reciprocal_rerank_streamed(qf, gf, k1=k1, k2=k2, row_block=rb))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_streamed_rows_match_dense():
    """The chunked row provider rebuilds the dense streamed result (a tail
    chunk that does not divide num_q included), and the metric layer
    consumes it to the same CMC/mAP."""
    qf, gf, ids_q, ids_g = _workload(seed=13, nq=37, ng=150, noise=0.8)
    kw = dict(k1=15, k2=5, val_dtype=torch.float32, qe_dtype=torch.float32)
    dense = TS.k_reciprocal_rerank_streamed(*_t(qf, gf), **kw)
    row_fn, qc = TS.k_reciprocal_rerank_streamed_rows(*_t(qf, gf), q_chunk=16, **kw)
    assert qc == 16
    rebuilt = torch.cat([row_fn(s) for s in range(0, 37, qc)])[:37]
    torch.testing.assert_close(rebuilt, dense, atol=1e-6, rtol=0)
    camq, camg = np.zeros(37, np.int64), np.ones(150, np.int64)
    cmc_d, map_d = TM.cmc_map(dense, ids_q, ids_g, camq, camg, max_rank=10)
    cmc_r, map_r = TM.cmc_map_from_rows(row_fn, qc, ids_q, ids_g, camq, camg, max_rank=10)
    np.testing.assert_allclose(cmc_r, cmc_d, atol=1e-6)
    assert abs(map_r - map_d) < 1e-6


@pytest.mark.parametrize("mode", ["auto", "exact", "streamed", "sharded"])
def test_evaluator_modes_match_jax(mode):
    qf, gf, ids_q, ids_g = _workload(seed=11, nq=50, ng=160, noise=0.8)
    rng = np.random.RandomState(3)
    feats = np.concatenate([qf, gf])
    pids = np.concatenate([ids_q, ids_g])
    cams = rng.randint(0, 3, len(pids))
    kw = dict(max_rank=10, reranking=True, rerank_params=(15, 5, 0.3), rerank_mode=mode,
              with_minp=True)
    jev = JM.Evaluator(num_query=len(ids_q), **kw)
    jev.update(jnp.asarray(feats), pids, cams)
    tev = TM.Evaluator(num_query=len(ids_q), **kw)
    tev.update(torch.from_numpy(feats[:20]), pids[:20], cams[:20])
    tev.update(torch.from_numpy(feats[20:]), pids[20:], cams[20:])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = jev.compute()
        got = tev.compute()
    if mode == "sharded":
        assert sum("shard-LOCAL" in str(w.message) for w in caught) == 2
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-6)
    assert abs(got[1] - want[1]) < 1e-6 and abs(got[2] - want[2]) < 1e-6
    assert 0.05 < got[1] < 0.999


def test_ties_from_duplicated_rows_match_jax():
    """Duplicated feature rows give exactly tied distances: the neighbour
    lists must break ties to the lower index, as lax.top_k does."""
    qf, gf, _, _ = _workload(seed=17, nq=20, ng=60)
    gf[10:20] = gf[0:10]
    gf[30:33] = qf[:3]
    qf[5] = qf[4]
    feat = np.concatenate([qf, gf])
    d = np.array(JR.euclidean_distmat(jnp.asarray(feat), jnp.asarray(feat)))
    assert (d[:, 20 + 10] == d[:, 20 + 0]).all()  # the ties are exact
    _, jrank = lax.top_k(-jnp.asarray(d), 16)
    np.testing.assert_array_equal(TR.smallest_k(torch.from_numpy(d), 16).numpy(),
                                  np.asarray(jrank))
    want = np.asarray(JR.k_reciprocal_rerank(qf, gf, k1=15, k2=4))
    got = TR.k_reciprocal_rerank(*_t(qf, gf), k1=15, k2=4)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    want = np.asarray(JS.k_reciprocal_rerank_streamed(qf, gf, k1=15, k2=4))
    got = TS.k_reciprocal_rerank_streamed(*_t(qf, gf), k1=15, k2=4)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_a_mesh_larger_than_one_device_raises(tmp_path):
    """A mesh that is not the port's (a JAX Mesh, or any object with a
    "data" axis) over more than one device raises: re-ranking over several
    devices takes a parallel/mesh.Mesh; one of a single device is the
    single-device route. The port's mesh runs the sharded core, which in a
    world of one rank gives the single-device answer
    (tests/test_torch_sharded_rerank.py holds two ranks)."""
    from tpu_reid_torch.parallel import launch

    qf, gf, _, _ = _workload(nq=4, ng=12)
    feats = torch.from_numpy(np.concatenate([qf, gf]))
    for mesh in (make_mesh(n_data=8), SimpleNamespace(shape={"data": 2, "model": 1})):
        calls = [
            lambda: TM.Evaluator(num_query=4, reranking=True, mesh=mesh),
            lambda: TS.k_reciprocal_rerank_streamed(*_t(qf, gf), mesh=mesh),
            lambda: TS.k_reciprocal_rerank_streamed_rows(*_t(qf, gf), mesh=mesh),
            lambda: TZ.evaluate_zero_shot(feats[:4], feats[4:], [0] * 4, [0] * 12, [0] * 4,
                                          [1] * 12, reranking=True, mesh=mesh, device="cpu"),
        ]
        for call in calls:
            with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
                call()
    single = SimpleNamespace(shape={"data": 1})
    ev = TM.Evaluator(num_query=4, max_rank=5, reranking=True, rerank_params=(5, 2, 0.3),
                      mesh=single)
    ev.update(feats, np.arange(16) % 3, np.arange(16) % 2)
    want = ev.compute()
    assert np.isfinite(want[1])
    with launch.process_group("cpu", f"file://{tmp_path}/rdv", 0, 1) as mesh:
        got = TS.k_reciprocal_rerank_streamed(*_t(qf, gf), k1=5, k2=2, mesh=mesh)
        ev = TM.Evaluator(num_query=4, max_rank=5, reranking=True, rerank_params=(5, 2, 0.3),
                          rerank_mode="streamed", mesh=mesh)
        ev.update(feats, np.arange(16) % 3, np.arange(16) % 2)
        sharded = ev.compute()
    assert torch.equal(got, TS.k_reciprocal_rerank_streamed(*_t(qf, gf), k1=5, k2=2))
    ev = TM.Evaluator(num_query=4, max_rank=5, reranking=True, rerank_params=(5, 2, 0.3),
                      rerank_mode="streamed")
    ev.update(feats, np.arange(16) % 3, np.arange(16) % 2)
    plain = ev.compute()
    np.testing.assert_array_equal(sharded[0], plain[0])
    assert sharded[1] == plain[1]


def test_evaluate_zero_shot_reranks_like_jax():
    from tpu_reid.pipelines import zero_shot as JZ

    qf, gf, ids_q, ids_g = _workload(seed=19, nq=30, ng=90, noise=0.8)
    cq, cg = np.zeros(30, np.int64), np.ones(90, np.int64)
    want = JZ.evaluate_zero_shot(qf, gf, ids_q, ids_g, cq, cg, reranking=True,
                                 with_minp=True)
    got = TZ.evaluate_zero_shot(*_t(qf, gf), ids_q, ids_g, cq, cg, reranking=True,
                                with_minp=True, device="cpu")
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-6)
    assert abs(got[1] - want[1]) < 1e-6 and abs(got[2] - want[2]) < 1e-6
