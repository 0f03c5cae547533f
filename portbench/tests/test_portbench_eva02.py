"""The EVA02 cell of the benchmark on the CPU: the manifest loads
`eva-veri.embed`; at a tiny EVA02 configuration (width 128, 2 heads of 64,
3 layers, hidden 341: the padding and the real-column statistics at work,
a 3 x 2 grid, 2 prompt tokens) the program and the plain reference agree,
through the whole harness too; and yardstick_eva's FLOPs of the published
configuration are the hand count."""

import dataclasses

import pytest
import torch

from portbench import harness as H
from portbench import run as R
from portbench import yardstick_eva as Y

CPU = torch.device("cpu")
SEED = 2**31 + 4321

TINY_EVA = dict(H.read_json(H.HERE / "configs" / "eva02-clip-l14-veri.json"),
                name="tiny-eva", image_hw=[24, 16], patch=8, stride=8, vision_width=128,
                vision_layers=3, vision_heads=2, mlp_hidden=int(128 * 2.6667), embed_dim=64,
                text_width=64, text_layers=2, text_heads=1, prompt_depth=3, n_cls=16,
                seq_len=9)


def tiny_eva_cell() -> H.Cell:
    c = H.cell("eva-veri.embed")
    return dataclasses.replace(c, config=dict(TINY_EVA), traffic=dict(
        c.traffic, batch=4, pool_batches=2, warmup_batches=1, trace_batches=1, check_rows=6,
        identities=5))


def test_manifest_loads_the_eva_cell():
    c = H.cell("eva-veri.embed")
    assert c.config["name"] == "eva02-clip-l14-veri" and c.chips == 1
    assert c.traffic["kind"] == "embed" and c.traffic["batch"] == 256
    assert {m["name"] for m in c.per_layer} == {"idle_pct.embed", "mfu.eva",
                                                "gemm_roofline.eva", "attn_roofline.eva"}
    assert {m["name"] for m in c.end_to_end} == {"emb_per_s", "setup_s"}
    assert H.kernel_names("eva_gemm") and H.kernel_names("eva_attn")


def test_tiny_program_and_reference_agree():
    from portbench.kinds import embed

    cell = tiny_eva_cell()
    run = embed.Run(cell, SEED, CPU, H.SetupClock(0.0))
    cfg = cell.config
    run.raw = H.make_raw(run.ref.param_spec(cfg, ["visual"]), SEED, CPU, torch.float32)
    params = run.prog.params(run.raw, cfg)
    mcfg = run.prog.model_config(cfg)
    from tpu_reid_torch.models import reid_clip as M

    gen = torch.Generator().manual_seed(3)
    crops = torch.randint(0, 256, (3, 24, 16, 3), generator=gen, dtype=torch.uint8)
    x = crops.float() / 255.0
    # the program's ViT preprocessing (mean 0.5, std 0.5), as the embed kind feeds it
    got = M.eval_embed(params, mcfg, (x - 0.5) / 0.5)
    P = run.ref.Precision("fp32")
    with P.scope():
        want = run.ref.eval_embeddings(P, run.raw, cfg, crops, flip_tta=False)
    assert got.shape == want.shape == (3, 128 + 64)
    gap = (got - want).norm(dim=1) / want.norm(dim=1)
    assert float(gap.max()) < 1e-5, gap


def test_tiny_cell_through_the_harness_is_correct():
    res = R.run_cell(tiny_eva_cell(), SEED, 0.3, False, CPU, H.SetupClock(0.0))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def test_published_flops_are_the_hand_count():
    cfg = H.read_json(H.HERE / "configs" / "eva02-clip-l14-veri.json")
    parts = Y.block_flops(cfg)
    # S = 327, D = 1024, F = 2730, per image: qkv 2 S D 3D, out 2 S D^2,
    # gate | up 2 S D 2F, down 2 S F D, attention 4 S^2 D
    hand = {"qkv": 2.06e9, "out": 0.686e9, "gate_up": 3.66e9, "down": 1.83e9,
            "attention": 0.438e9}
    for k, v in hand.items():
        assert parts[k] == pytest.approx(v, rel=5e-3), k
    assert sum(parts.values()) == pytest.approx(8.67e9, rel=5e-3)
    # 23 full blocks, the CLS-only block, the stem and the head: ~200 GFLOP
    assert Y.vision_forward_flops(cfg) == pytest.approx(201e9, rel=5e-3)
    assert parts["gate_up"] + parts["down"] == pytest.approx(0.633 * sum(parts.values()),
                                                             rel=5e-3)
