"""tpu_reid_torch.retrieval against tpu_reid.retrieval and the host
goldens of tests/golden.py, on the same features."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden import golden_cmc_map, golden_minp
from tpu_reid.retrieval import distance as JD
from tpu_reid.retrieval import metrics as JM
from tpu_reid_torch.retrieval import distance as TD
from tpu_reid_torch.retrieval import metrics as TM


def _problem(seed, n_q=23, n_g=71, dim=16, n_ids=7, noise=1.0):
    """Clustered features so CMC/mAP sit away from 0 and 1; same-camera
    positives exist so the junk filter matters."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_ids, dim)
    q_pids = rng.randint(0, n_ids, n_q)
    g_pids = rng.randint(0, n_ids, n_g)
    qf = (centers[q_pids] + noise * rng.randn(n_q, dim)).astype(np.float32)
    gf = (centers[g_pids] + noise * rng.randn(n_g, dim)).astype(np.float32)
    return qf, gf, q_pids, g_pids, rng.randint(0, 3, n_q), rng.randint(0, 3, n_g)


def test_distances_match_jax():
    qf, gf, *_ = _problem(0)
    for tf, jf, atol in ((TD.euclidean_distmat, JD.euclidean_distmat, 1e-4),
                         (TD.cosine_distmat, JD.cosine_distmat, 1e-5)):
        np.testing.assert_allclose(tf(torch.from_numpy(qf), torch.from_numpy(gf)).numpy(),
                                   np.asarray(jf(jnp.asarray(qf), jnp.asarray(gf))),
                                   atol=atol, rtol=1e-5)
    np.testing.assert_allclose(TD.l2_normalize(torch.from_numpy(qf)).numpy(),
                               np.asarray(JD.l2_normalize(jnp.asarray(qf))), atol=1e-7)


@pytest.mark.parametrize("q_chunk", [2048, 5])
@pytest.mark.parametrize("max_rank", [50, 10])
def test_cmc_map_minp_match_jax_and_golden(q_chunk, max_rank):
    qf, gf, qp, gp, qc, gc = _problem(1)
    dm = np.array(JD.euclidean_distmat(jnp.asarray(qf), jnp.asarray(gf)))
    cmc, mAP, mINP = TM.cmc_map(torch.from_numpy(dm), qp, gp, qc, gc, max_rank=max_rank,
                                q_chunk=q_chunk, with_minp=True)
    jcmc, jmap, jminp = JM.cmc_map(jnp.asarray(dm), jnp.asarray(qp), jnp.asarray(gp),
                                   jnp.asarray(qc), jnp.asarray(gc), max_rank=max_rank,
                                   q_chunk=q_chunk, with_minp=True)
    gcmc, gmap = golden_cmc_map(dm, qp, gp, qc, gc, max_rank=max_rank)
    np.testing.assert_allclose(cmc, np.asarray(jcmc), atol=1e-6)
    np.testing.assert_allclose(cmc, gcmc, atol=1e-6)
    assert abs(mAP - float(jmap)) < 1e-6 and abs(mAP - gmap) < 1e-6
    assert abs(mINP - float(jminp)) < 1e-6
    assert abs(mINP - golden_minp(dm, qp, gp, qc, gc)) < 1e-6
    assert 0.05 < mAP < 0.95


def test_evaluator_matches_jax():
    qf, gf, qp, gp, qc, gc = _problem(2)
    ev = TM.Evaluator(num_query=len(qf), max_rank=20, with_minp=True)
    ev.update(torch.from_numpy(qf[:10]), qp[:10], qc[:10])
    ev.update(torch.from_numpy(np.concatenate([qf[10:], gf])), np.concatenate([qp[10:], gp]),
              np.concatenate([qc[10:], gc]))
    jev = JM.Evaluator(num_query=len(qf), max_rank=20, with_minp=True)
    jev.update(jnp.asarray(np.concatenate([qf, gf])), np.concatenate([qp, gp]),
               np.concatenate([qc, gc]))
    got, want = ev.compute(), jev.compute()
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    assert abs(got[1] - want[1]) < 1e-6 and abs(got[2] - want[2]) < 1e-6


def test_ties_rank_stably_like_jax():
    """Tied distances keep gallery order (stable sort), as jnp.argsort."""
    dm = np.array([[1.0, 1.0, 1.0, 0.5], [2.0, 2.0, 2.0, 2.0]], np.float32)
    qp, gp = np.array([0, 1]), np.array([1, 0, 1, 0])
    qc, gc = np.zeros(2, int), np.ones(4, int)
    got = TM.cmc_map(torch.from_numpy(dm), qp, gp, qc, gc, max_rank=4)
    want = JM.cmc_map(jnp.asarray(dm), jnp.asarray(qp), jnp.asarray(gp), jnp.asarray(qc),
                      jnp.asarray(gc), max_rank=4)
    np.testing.assert_allclose(got[0], np.asarray(want[0]))
    assert abs(got[1] - float(want[1])) < 1e-7


def test_reranking_names_its_slice():
    """Re-ranking over several devices takes the port's mesh
    (parallel/mesh.Mesh, tests/test_torch_sharded_rerank.py); another
    object with a "data" axis of several devices is refused, naming it."""
    from types import SimpleNamespace

    TM.Evaluator(num_query=1, reranking=True)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        TM.Evaluator(num_query=1, reranking=True, mesh=SimpleNamespace(shape={"data": 4}))
