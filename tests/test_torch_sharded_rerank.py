"""The port's sharded streamed re-ranking (retrieval/rerank_stream.py
`_streamed_core_sharded`, the Evaluator with mesh=) on two gloo ranks
against the JAX package's on a 2-device mesh of its virtual CPU devices, on
the same features: odd query and gallery counts, so that every rank's share
is padded. In fp32 (no quantization) the min-sum t over every rank's
gallery columns, the row maxima and the V_qe row sums, and the re-ranked
distances; in the production dtypes (bf16 sparse V, fp8 V_qe) the distances
and the Evaluator's metrics; the row provider at a chunk smaller than a
rank's share of the queries."""

import numpy as np
import pytest

from tests import torch_dist_workers as W
from tests.test_torch_rerank import _workload
from tpu_reid.parallel.mesh import make_mesh
from tpu_reid.retrieval import metrics as JM
from tpu_reid.retrieval import rerank_stream as JS

KW = dict(k1=12, k2=4, row_block=16)
SHAPES = ((37, 101, 16), (13, 50, 32))


@pytest.fixture(scope="module")
def runs():
    import torch

    workloads = []
    for seed, (nq, ng, d) in enumerate(SHAPES):
        qf, gf, qp, gp = _workload(seed=seed + 3, n_ids=9, nq=nq, ng=ng, d=d)
        workloads.append((qf, gf, qp, gp))
    got = W.spawn(W.sharded_rerank, workloads, dict(KW, val_dtype=torch.float32,
                                                   qe_dtype=torch.float32))
    return workloads, got


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_sharded_core_matches_jax(runs, i):
    import jax.numpy as jnp

    workloads, got = runs
    qf, gf, qp, gp = workloads[i]
    mesh = make_mesh(n_data=2)
    t, rowmax, a_sum, b_sum = JS._streamed_core_sharded(
        jnp.asarray(qf), jnp.asarray(gf), mesh, KW["k1"], KW["k2"], KW["row_block"], 1024, 1024,
        2048, jnp.float32, jnp.float32, None)
    g = got[i]
    assert g["t"].shape == t.shape  # every rank's padded share of both sides
    np.testing.assert_allclose(g["t"].numpy(), np.asarray(t), atol=1e-5)
    np.testing.assert_allclose(g["rowmax"].numpy(), np.asarray(rowmax), rtol=1e-6)
    np.testing.assert_allclose(g["a_sum"].numpy(), np.asarray(a_sum), rtol=1e-5)
    np.testing.assert_allclose(g["b_sum"].numpy(), np.asarray(b_sum), rtol=1e-5)
    want = JS.k_reciprocal_rerank_streamed(qf, gf, mesh=mesh, val_dtype=jnp.float32,
                                           qe_dtype=jnp.float32, **KW)
    np.testing.assert_allclose(g["dist"].numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_sharded_production_route_and_metrics_match_jax(runs, i):
    """bf16 sparse V and fp8 V_qe: the distances equal the port's
    single-device route (1e-6) on both ranks; against JAX's 2-device route
    they agree within 2e-5 except where the bf16 rounding of a sparse V
    value (ROADMAP.md queue 3, in the single-device routes alike) moves an
    fp8 V_qe entry by one step: at most 1% of the entries, each within
    2e-3. The Evaluator's CMC / mAP / mINP over the mesh equal JAX's."""
    import torch

    from tpu_reid_torch.retrieval import rerank_stream as TS

    workloads, got = runs
    qf, gf, qp, gp = workloads[i]
    mesh = make_mesh(n_data=2)
    g = got[i]
    assert g["same"]
    single = TS.k_reciprocal_rerank_streamed(torch.from_numpy(qf), torch.from_numpy(gf), **KW)
    np.testing.assert_allclose(g["dist8"].numpy(), single.numpy(), atol=1e-6)
    want = np.asarray(JS.k_reciprocal_rerank_streamed(qf, gf, mesh=mesh, **KW))
    d = np.abs(g["dist8"].numpy() - want)
    assert d.max() <= 2e-3 and (d > 2e-5).mean() <= 0.01, (d.max(), (d > 2e-5).mean())
    ev = JM.Evaluator(len(qp), max_rank=5, reranking=True, rerank_params=(KW["k1"], KW["k2"], 0.3),
                      rerank_mode="streamed", mesh=mesh, with_minp=True)
    ev.update(np.concatenate([qf, gf]), np.concatenate([qp, gp]), np.concatenate([qp, gp]) % 3)
    cmc, mAP, mINP = ev.compute()
    np.testing.assert_allclose(g["metrics"][0], np.asarray(cmc), atol=1e-6)
    assert abs(g["metrics"][1] - mAP) < 1e-6 and abs(g["metrics"][2] - mINP) < 1e-6


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_sharded_row_provider_keeps_the_callers_chunk(runs, i):
    """On a mesh `k_reciprocal_rerank_streamed_rows` blends the caller's
    q_chunk (5 rows, under a rank's share of 24 or 8 queries), so its
    memory stays bounded; the chunks stitched together equal the mesh's
    whole distance matrix."""
    workloads, got = runs
    g = got[i]
    assert g["q_chunk"] == 5
    assert g["rows"].shape == g["dist8"].shape
    np.testing.assert_allclose(g["rows"].numpy(), g["dist8"].numpy(), atol=1e-6)
