"""The port's tensor parallelism (tpu_reid_torch/parallel/tp.py, the "model"
axis of parallel/mesh.py) against the JAX package's (tpu_reid/parallel/tp.py):
the layout bit for bit, one block on one shard, then the tower, its CLS-only
form and the flip-TTA extractor over 2 gloo ranks (a 1 x 2 mesh) and 4 gloo
ranks (2 x 2) against JAX's on a mesh of the same shape of its virtual CPU
devices, with the same weights (JAX's init carried across with
weights/convert.from_jax_params). fp32 tolerances are JAX's own
(tests/test_tp.py): 1e-5 for a block, 2e-5 for the tower. Each world is
spawned once for the module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tests import torch_dist_workers as W
from tpu_reid.configs import VisionConfig as JVisionConfig
from tpu_reid.models import layers as JL
from tpu_reid.models import vit as JV
from tpu_reid.parallel import tp as JTP
from tpu_reid.parallel.mesh import make_mesh as j_make_mesh, shard_map_nocheck
from tpu_reid_torch.configs import CLIPConfig, VisionConfig
from tpu_reid_torch.device import to_device
from tpu_reid_torch.models import layers as TL
from tpu_reid_torch.ops.fused_attention import check_gemm_operands
from tpu_reid_torch.parallel import tp as TP
from tpu_reid_torch.weights.convert import from_jax_params

KW = dict(layers=3, width=64, patch_size=8, stride=8, output_dim=32, n_heads=4)
HW = (32, 16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def tower():
    """JAX's tiny ViT (3 blocks, width 64, 4 heads of 16), its weights in
    the port, and 4 images."""
    hg, wg = JVisionConfig.grid_for(HW, 8, 8)
    jcfg = JVisionConfig(h_grid=hg, w_grid=wg, **KW)
    cfg = VisionConfig(h_grid=hg, w_grid=wg, **KW)
    jparams = JV.init_vit(jax.random.PRNGKey(3), jcfg)
    visual = from_jax_params({"visual": _np(jparams)}, CLIPConfig(vision=cfg),
                             device="cpu")["visual"]
    images = np.random.default_rng(0).normal(size=(4, *HW, 3)).astype(np.float32)
    return jcfg, jparams, cfg, visual, images


def test_tp_layout_equals_jax_bit_for_bit(tower):
    jcfg, jparams, cfg, visual, _ = tower
    want = JTP.tp_layout(jparams["blocks"], jcfg.n_heads)
    got = TP.tp_layout(visual["blocks"], cfg.heads)
    assert sorted(got) == sorted(want)
    for k in want:
        for g, w in zip(_leaves({k: {kk: v.numpy() for kk, v in got[k].items()}}
                                if isinstance(got[k], dict) else [got[k].numpy()]),
                        _leaves(want[k])):
            assert g.shape == w.shape and np.array_equal(g, w), k


@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_tp_residual_block_matches_jax_and_the_block(n_model):
    """tp_residual_block with an identity reduce over every shard of n_model
    (the partials summed, as an all-reduce would) equals JAX's
    tp_residual_block on a 1-device mesh and the port's residual_block."""
    d, h = 48, 4
    p = JL.init_block(jax.random.PRNGKey(5), d, 2)
    stacked = jax.tree.map(lambda a: a[None], p)
    jtp = jax.tree.map(lambda a: a[0], JTP.tp_layout(stacked, h))
    x = np.asarray(np.random.default_rng(1).normal(size=(2, 9, d)) * 0.3, np.float32)
    mesh1 = j_make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    want = shard_map_nocheck(lambda pp, xx: JTP.tp_residual_block(pp, xx), mesh=mesh1,
                             in_specs=(P(), P()), out_specs=P())(jtp, jnp.asarray(x))
    tp_p = to_device(_np(p), "cpu")
    layout = TP.tp_layout(to_device(_np(stacked), "cpu"), h)
    shards = [TL.slice_layer(TP.tp_shard(layout, r, n_model), 0) for r in range(n_model)]
    xt = torch.from_numpy(x)
    if n_model == 1:
        got = TP.tp_residual_block(shards[0], xt, h, TP.model_reduce(None))
    else:  # the reduce of every shard's partial, in one process
        hl = h // n_model
        attn = sum(TP.tp_attn_partial(s, xt, hl).float() for s in shards)
        x1 = TP.add_reduced(xt, attn, shards[0]["out_b"])
        got = TP.add_reduced(x1, sum(TP.tp_mlp_partial(s, x1).float() for s in shards),
                             shards[0]["proj_b"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), TL.residual_block(tp_p, xt, h).numpy(), atol=1e-5)


def _jax_tower(tower, n_data, n_model):
    """JAX's apply_vit_tp (whole and cls_only) and make_tp_extractor on an
    (n_data, n_model) mesh of its virtual CPU devices."""
    jcfg, jparams, _, _, images = tower
    mesh = j_make_mesh(n_data=n_data, n_model=n_model,
                       devices=jax.devices()[:n_data * n_model])
    params_tp = JTP.shard_tp_visual(mesh, JTP.tp_visual_layout(jparams, jcfg.n_heads))
    specs = JTP.tp_visual_specs(params_tp)
    x = jax.device_put(jnp.asarray(images), NamedSharding(mesh, P("data")))
    out = {}
    for name, cls_only in (("full", False), ("cls", True)):
        out[name] = jax.jit(shard_map_nocheck(
            lambda pp, xx, c=cls_only: JTP.apply_vit_tp(pp, jcfg, xx, cls_only=c), mesh=mesh,
            in_specs=(specs, P("data")), out_specs=(P("data"),) * 3))(params_tp, x)
    out["extract"] = JTP.make_tp_extractor(mesh, jcfg, preprocess=None, flip_tta=True,
                                           dtype=jnp.float32)(params_tp, x)
    out["devices"] = [tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
                      for d in jax.devices()[:n_data * n_model]]
    return out


@pytest.fixture(scope="module")
def worlds(tower):
    """The port's tp_checks in a world of 2 gloo ranks (1 x 2) and one of 4
    (2 x 2), and JAX's tower on meshes of the same shapes."""
    _, _, cfg, visual, images = tower
    out = {}
    for n_data, n_model in ((1, 2), (2, 2)):
        got = W.spawn(W.tp_checks, visual, cfg, images, devices=n_data, tp=n_model)
        out[(n_data, n_model)] = got, _jax_tower(tower, n_data, n_model)
    return out


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_apply_vit_tp_matches_jax(worlds, tower, shape):
    """x11, x12 and xproj of the whole sequence, and the CLS-only x12 and
    xproj (the tail through ln_proj_tail), within 2e-5 of JAX's; and within
    2e-5 of the single-device apply_vit."""
    from tpu_reid_torch.models import vit as TV

    got, want = worlds[shape]
    for name, n in (("full", 3), ("cls", 3)):
        for g, w in zip(got[name], want[name]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, err_msg=name)
        assert len(got[name]) == n
    _, _, cfg, visual, images = tower
    single = TV.apply_vit(visual, cfg, torch.from_numpy(images))
    for g, w in zip(got["full"], single):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_make_tp_extractor_matches_jax(worlds, shape):
    """The flip-TTA features (cls_only) within 2e-5 of JAX's extractor; the
    ranks of a model group computed the same features."""
    got, want = worlds[shape]
    assert got["extract"].shape == (4, 64 + 32)
    np.testing.assert_allclose(got["extract"].numpy(), np.asarray(want["extract"]), atol=2e-5)
    assert got["model_group_same"]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_make_mesh_gives_jax_indices(worlds, shape):
    """Global rank g is at (g // n_model, g % n_model), where JAX's
    make_mesh puts device g."""
    got, want = worlds[shape]
    assert got["shape"] == {"data": shape[0], "model": shape[1]}
    assert [(d, m) for _, d, m in sorted(got["indices"])] == want["devices"]


@pytest.mark.parametrize("n_model", [2, 3, 4, 6, 12, 5])
def test_tp_shard_at_vit_b16_sizes(n_model):
    """One ViT-B/16 block (12 heads of 64, MLP 3072): every shard of T in
    {2, 3, 4, 6, 12} has the kernels' shapes and passes check_gemm_operands
    and check_tp_kernels; T = 5 divides neither and raises, naming them."""
    rng = np.random.default_rng(0)
    d, hid, h = 768, 3072, 12

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    blocks = {"attn": {"in_proj": {"w": t(1, d, 3 * d), "b": t(1, 3 * d)},
                       "out_proj": {"w": t(1, d, d), "b": t(1, d)}},
              "mlp": {"c_fc": {"w": t(1, d, hid), "b": t(1, hid)},
                      "c_proj": {"w": t(1, hid, d), "b": t(1, d)}},
              "ln_1": {"scale": t(1, d), "bias": t(1, d)},
              "ln_2": {"scale": t(1, d), "bias": t(1, d)}}
    layout = TP.tp_layout(blocks, h)
    if n_model == 5:
        with pytest.raises(ValueError, match="12 heads and 3072 hidden units"):
            TP.tp_shard(layout, 0, n_model)
        return
    hl = h // n_model
    full_q = blocks["attn"]["in_proj"]["w"][0, :, :d].reshape(d, h, 64)
    for r in range(n_model):
        s = TL.slice_layer(TP.tp_shard(layout, r, n_model), 0)
        assert s["w_in"].shape == (d, 3 * hl * 64) and s["w_out"].shape == (hl * 64, d)
        assert s["fc_w"].shape == (d, hid // n_model) and s["proj_w"].shape == (hid // n_model, d)
        # the rank's q columns are its heads' columns of the whole model
        assert torch.equal(s["w_in"][:, :hl * 64].reshape(d, hl, 64),
                           full_q[:, r * hl:(r + 1) * hl])
        for k, n, ln in ((d, 3 * hl * 64, True), (hl * 64, d, False),
                         (d, hid // n_model, True), (hid // n_model, d, False)):
            check_gemm_operands("shard", 211, k, n, ln, {})
        TP.check_tp_kernels(s, hl)


def test_kernels_refuse_a_head_width_other_than_64(tower):
    _, _, cfg, visual, _ = tower
    shard = TP.tp_shard(TP.tp_layout(visual["blocks"], cfg.heads), 0, 2)
    with pytest.raises(ValueError, match="2 heads of 16"):
        TP.check_tp_kernels(TL.slice_layer(shard, 0), 2)
