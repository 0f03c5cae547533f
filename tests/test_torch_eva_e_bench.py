"""The EVA02-E cell of the benchmark on the CPU: the manifest loads
`evae-market.embed` with its metrics; at a tiny post-norm configuration
(width 224 = 2 heads of 112, 3 layers, hidden 1920, a 4 x 3 grid, 2 prompt
tokens) the program binding and the plain reference agree, through the
whole harness too; the metric readers read a traced window; and
yardstick_evae's FLOPs of the published configuration are the hand count."""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from portbench import harness as H
from portbench import run as R
from portbench import yardstick_evae as Y

CPU = torch.device("cpu")
SEED = 2**31 + 4999

TINY_E = dict(H.read_json(H.HERE / "configs" / "eva02-clip-e14-market.json"),
              name="tiny-e", image_hw=[32, 24], patch=8, stride=8, vision_width=224,
              vision_layers=3, vision_heads=2, head_width=112, mlp_hidden=1920, embed_dim=64,
              text_width=64, text_layers=2, text_heads=1, prompt_depth=3, n_cls=16, seq_len=15)


def tiny_cell() -> H.Cell:
    c = H.cell("evae-market.embed")
    return dataclasses.replace(c, config=dict(TINY_E), traffic=dict(
        c.traffic, batch=4, pool_batches=2, warmup_batches=1, trace_batches=1, check_rows=6,
        identities=5))


def test_manifest_loads_the_evae_cell():
    c = H.cell("evae-market.embed")
    assert c.config["name"] == "eva02-clip-e14-market" and c.chips == 1
    assert c.traffic["kind"] == "embed" and c.traffic["batch"] == 256
    assert {m["name"] for m in c.per_layer} == {"idle_pct.embed", "mfu.evae",
                                                "gemm_roofline.evae", "attn_roofline.evae"}
    assert {m["name"] for m in c.end_to_end} == {"emb_per_s", "setup_s"}
    assert H.kernel_names("evae_gemm") == ["gemm_bf16_kernel", "ln_rows_bf16_kernel"]
    assert H.kernel_names("evae_attn") == ["attention_bf16_kernel"]
    cfg = c.config
    assert cfg["vision_width"] == cfg["vision_heads"] * cfg["head_width"] == 1792
    assert cfg["mlp_hidden"] == int(cfg["vision_width"] * cfg["mlp_ratio"]) == 15360
    assert cfg["seq_len"] == Y.dims(cfg)[0] == 165


def test_binding_builds_the_published_model():
    c = H.cell("evae-market.embed")
    mcfg = H.config_module(c.config, "program").model_config(c.config)
    v = mcfg.clip.vision
    assert (v.block, v.layers, v.width, v.heads, v.hidden, v.seq_len) == (
        "eva_e", 64, 1792, 16, 15360, 165)
    assert mcfg.clip.embed_dim == 1024


def test_tiny_program_and_reference_agree():
    from portbench.kinds import embed
    from tpu_reid_torch.models import reid_clip as M

    cell = tiny_cell()
    run = embed.Run(cell, SEED, CPU, H.SetupClock(0.0))
    cfg = cell.config
    run.raw = H.make_raw(run.ref.param_spec(cfg, ["visual"]), SEED, CPU, torch.float32)
    params = run.prog.params(run.raw, cfg)
    mcfg = run.prog.model_config(cfg)
    gen = torch.Generator().manual_seed(3)
    crops = torch.randint(0, 256, (3, 32, 24, 3), generator=gen, dtype=torch.uint8)
    x = crops.float() / 255.0
    # the program's ViT preprocessing (mean 0.5, std 0.5), as the embed kind feeds it
    got = M.eval_embed(params, mcfg, (x - 0.5) / 0.5)
    P = run.ref.Precision("fp32")
    with P.scope():
        want = run.ref.eval_embeddings(P, run.raw, cfg, crops, flip_tta=False)
    assert got.shape == want.shape == (3, 224 + 64)
    gap = (got - want).norm(dim=1) / want.norm(dim=1)
    assert float(gap.max()) < 1e-5, gap


def test_reference_chunks_are_exact(monkeypatch):
    """The reference's row chunks (attention queries by image, the MLP by
    token rows) give the unchunked result: chunks of one image's rows."""
    from portbench.configs import eva_e_clip_reid as ref

    cfg = tiny_cell().config
    raw = H.make_raw(ref.param_spec(cfg, ["visual"]), SEED, CPU, torch.float32)
    gen = torch.Generator().manual_seed(4)
    crops = torch.randint(0, 256, (3, 32, 24, 3), generator=gen, dtype=torch.uint8)
    P = ref.Precision("fp32")
    with P.scope():
        whole = ref.eval_embeddings(P, raw, cfg, crops)
        monkeypatch.setattr(ref, "CHUNK_TOKENS", 16)
        chunked = ref.eval_embeddings(P, raw, cfg, crops)
    assert torch.allclose(whole, chunked, rtol=1e-6, atol=1e-6)


def test_tiny_cell_through_the_harness_is_correct():
    from tpu_reid_torch.ops.attention import set_fast_softmax

    try:  # the embed kind switches the process's softmax profile to the traffic's
        res = R.run_cell(tiny_cell(), SEED, 0.3, False, CPU, H.SetupClock(0.0))
    finally:
        set_fast_softmax(False)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def test_readers_read_a_traced_window():
    cell = H.cell("evae-market.embed")
    names = {"gemm_bf16_kernel<9>": 3.0, "ln_rows_bf16_kernel<8, true>": 0.5,
             "attention_bf16_kernel<112>": 0.2, "elementwise": 1.0}
    trace = SimpleNamespace(window_s=10.0,
                            device_seconds=lambda ks: sum(v for n, v in names.items()
                                                          if any(k in n for k in ks)))
    ctx = R.ReadContext(cell, trace, {"images": 2048, "passes": 2, "batch": 256})
    mfu = H.metric_reader("mfu.evae").read(ctx)
    gemm = H.metric_reader("gemm_roofline.evae").read(ctx)
    attn = H.metric_reader("attn_roofline.evae").read(ctx)
    flops = 2048 * 2 * Y.vision_forward_flops(cell.config)
    assert mfu == pytest.approx(100 * flops / 10.0 / 989e12)
    assert gemm == pytest.approx(100 * Y.block_gemm_bound_s(cell.config, 4096, 2, 989e12) / 3.5)
    assert attn == pytest.approx(100 * Y.attention_bound_s(cell.config, 4096, 2, 989e12) / 0.2)
    # a program without the E kernels: the rooflines read nothing
    empty = SimpleNamespace(window_s=10.0, device_seconds=lambda ks: 0.0)
    ctx = R.ReadContext(cell, empty, {"images": 2048, "passes": 2, "batch": 256})
    assert H.metric_reader("gemm_roofline.evae").read(ctx) is None
    assert H.metric_reader("attn_roofline.evae").read(ctx) is None


def test_published_flops_are_the_hand_count():
    cfg = H.read_json(H.HERE / "configs" / "eva02-clip-e14-market.json")
    parts = Y.block_flops(cfg)
    # S = 165, D = 1792, F = 15360, per image: qkv 2 S D 3D, out 2 S D^2,
    # fc1 and fc2 2 S D F each, attention 4 S^2 D (heads of 112: 16 x 112 = D)
    hand = {"qkv": 3.179e9, "out": 1.060e9, "fc1": 9.083e9, "fc2": 9.083e9,
            "attention": 0.1951e9}
    for k, v in hand.items():
        assert parts[k] == pytest.approx(v, rel=2e-3), k
    # 135.8 MFLOP a token in the products, 1.2 in attention
    assert (sum(parts.values()) - parts["attention"]) / 165 == pytest.approx(135.8e6, rel=2e-3)
    assert parts["fc1"] + parts["fc2"] == pytest.approx(0.804 * sum(parts.values()), rel=2e-3)
    # 63 full blocks, the CLS-only block, the stem and the head: ~1.43 TFLOP
    assert Y.vision_forward_flops(cfg) == pytest.approx(1.43e12, rel=5e-3)
