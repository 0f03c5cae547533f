"""The port's data mesh (tpu_reid_torch/parallel/mesh.py, launch.py), its
copy of host_slice_records, and blockwise_topk / retrieve, against the JAX
package: the row layout of shard_batch against JAX's P("data") on its
virtual CPU devices, host_slice_records on the same records, the top-k
search on the same features; then two gloo ranks (spawned once for the
module) for the gather's gradient rule, the byte-wise collectives, the
replication checks and a rank that fails."""

import numpy as np
import pytest
import torch

from tests import torch_dist_workers as W
from tpu_reid.parallel import mesh as JM
from tpu_reid.parallel import multihost as JMH
from tpu_reid.retrieval import topk as JT
from tpu_reid_torch.parallel import launch
from tpu_reid_torch.parallel import mesh as PM
from tpu_reid_torch.parallel import multihost as TMH
from tpu_reid_torch.retrieval import topk as TT


def test_make_mesh_needs_a_group_and_refuses_a_model_axis(tmp_path):
    """No group: RuntimeError. A (data, model) shape that is not the
    world: ValueError naming both (the model axis itself runs,
    tests/test_torch_tp.py)."""
    with pytest.raises(RuntimeError, match="initialised torch.distributed"):
        PM.make_mesh()
    with launch.process_group("cpu", f"file://{tmp_path}/rdv", 0, 1):
        with pytest.raises(ValueError, match="n_data=1 x n_model=2 = 2, but the process group "
                                             "has 1 ranks"):
            PM.make_mesh(n_data=1, n_model=2)


def test_a_world_of_one_in_this_process(tmp_path):
    with launch.process_group("cpu", f"file://{tmp_path}/rdv", 0, 1) as mesh:
        assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
        assert mesh.shape == {"data": 1, "model": 1} == PM.make_mesh(n_data=1).shape
        with pytest.raises(ValueError, match="has 1 ranks"):
            PM.make_mesh(n_data=2)
        with pytest.raises(ValueError, match="has 1 ranks"):
            PM.make_mesh(n_model=2)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("n", [2, 4])
def test_shard_batch_takes_jax_p_data_rows(n):
    """Rank r's rows equal the shard JAX places on device r of a
    make_mesh(n_data=n)."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    jarr = JM.shard_batch(JM.make_mesh(n_data=n), x)
    shards = sorted(jarr.addressable_shards, key=lambda s: s.index[0].start)
    for r in range(n):
        mesh = PM.Mesh(rank=r, size=n, device=torch.device("cpu"))
        got = PM.shard_batch(mesh, {"x": torch.from_numpy(x), "ids": np.arange(8), "k": None})
        np.testing.assert_array_equal(got["x"].numpy(), np.asarray(shards[r].data))
        np.testing.assert_array_equal(got["ids"], np.arange(8)[r * 8 // n:(r + 1) * 8 // n])
        assert got["k"] is None
    with pytest.raises(ValueError, match="does not divide by the 3 ranks"):
        PM.shard_batch(PM.Mesh(0, 3, torch.device("cpu")), x)


@pytest.mark.parametrize("n,m", [(13, 4), (8, 8), (0, 5), (9, 1)])
def test_pad_to_multiple_matches_jax(n, m):
    assert PM.pad_to_multiple(n, m) == JM.pad_to_multiple(n, m)


@pytest.mark.parametrize("n_records,batch,count", [(13, 6, 3), (8, 4, 2), (5, 8, 4), (16, 4, 1)])
def test_host_slice_records_matches_jax(n_records, batch, count):
    """The padded wrap-around order and every rank's slice, the exact fit
    (13 = 2 x 6 + 1 and 8 = 2 x 4) included."""
    records = [(f"p{i}", i, i % 5, 0, i) for i in range(n_records)]
    for p in range(count):
        assert TMH.host_slice_records(records, batch, p, count) == \
            JMH.host_slice_records(records, batch, p, count)
    with pytest.raises(ValueError, match="must divide by process count"):
        TMH.host_slice_records(records, 6, 0, 4)


@pytest.mark.parametrize("k,block,squared", [(5, 7, True), (10, 64, False), (40, 16, True)])
def test_blockwise_topk_matches_jax(k, block, squared):
    """Distances within 1e-5 and the same indices (ties go to the lower
    gallery id in both), gallery blocks that do not divide it included."""
    rng = np.random.RandomState(k)
    q = rng.randn(9, 16).astype(np.float32)
    g = rng.randn(37, 16).astype(np.float32)
    g[5] = g[30]  # an exact tie
    jd, ji = JT.blockwise_topk(q, g, k, block=block, squared=squared)
    td, ti = TT.blockwise_topk(torch.from_numpy(q), torch.from_numpy(g), k, block=block,
                               squared=squared)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32 and ti.shape == (9, min(k, 37))


def test_retrieve_matches_jax():
    rng = np.random.RandomState(3)
    q, g = rng.randn(6, 8).astype(np.float32), rng.randn(50, 8).astype(np.float32)
    jd, ji = JT.retrieve(q, g, k=7, block=16)
    td, ti = TT.retrieve(torch.from_numpy(q), torch.from_numpy(g), k=7, block=16)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.fixture(scope="module")
def two_ranks():
    rng = np.random.RandomState(0)
    x = rng.randn(6, 3).astype(np.float32)
    w = rng.randn(6, 3).astype(np.float32)
    theta = rng.randn(3).astype(np.float32)
    return x, w, theta, W.spawn(W.mesh_checks, x, w, theta)


def test_the_gathered_loss_gives_the_single_device_gradient(two_ranks):
    """Each rank encodes its rows, the features are gathered, every rank
    computes the global loss (with a direct path in the parameters too);
    the averaged gradient is the single-device gradient of the global
    batch, the same on both ranks."""
    x, w, theta0, out = two_ranks
    theta = torch.tensor(theta0, requires_grad=True)
    loss = W.toy_loss(theta, torch.from_numpy(x), torch.from_numpy(w))
    loss.backward()
    assert out["rank_shape"] == (0, 2, {"data": 2, "model": 1})
    assert abs(out["loss"] - loss.item()) <= 1e-6 * abs(loss.item())
    np.testing.assert_allclose(out["grad"].numpy(), theta.grad.numpy(), rtol=1e-6, atol=1e-6)
    assert out["grad_same"]


def test_collectives_carry_bytes_gloo_lacks(two_ranks):
    *_, out = two_ranks
    for dt, got in out["bytes"].items():
        want = torch.cat([(torch.arange(4) + 10 * r).to(dt) for r in range(2)])
        assert got.dtype == dt and torch.equal(got, want), dt


def test_replication_checks(two_ranks):
    *_, out = two_ranks
    assert torch.equal(out["replicated"], torch.zeros(3))  # rank 0's values
    assert "different values in 1 of 1 leaves" in out["check_replicated"]
    assert out["agree_same"] is True
    assert "disagree on a flag: [1, 0]" in out["agree"]


def test_a_failed_rank_fails_the_run_with_its_output():
    with pytest.raises(RuntimeError, match="ranks exited with an error") as e:
        W.spawn(W.fail_on_rank1)
    assert "rank 1 (exit code 1)" in str(e.value)
    assert "rank 1 fails on purpose" in str(e.value)


def test_launch_refuses_what_it_cannot_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--devices 2: this host has 0 visible CUDA"):
        launch.run(W.fail_on_rank1, devices=2, device="cuda")
    with pytest.raises(ValueError, match="needs --multihost"):
        launch.run(W.fail_on_rank1, num_hosts=2, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        launch.run(W.fail_on_rank1, multihost="127.0.0.1:1", num_hosts=2, host_id=2,
                   device="cpu")
    assert launch.run(lambda mesh, a: (mesh, a), (3,), device="cpu") == (None, 3)
