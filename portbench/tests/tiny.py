"""A tiny IVLP configuration with every mechanism of the real ones (deep
prompts in both towers, overlapping patches, PK batches), and cells of the
manifest cut down to it, for the CPU tests."""

import dataclasses

from portbench import harness as H

TINY = dict(name="tiny", reference="ivlp_clip_reid", program="ivlp_clip_reid_program",
            image_hw=[32, 16], pixel_mean=[0.5] * 3, pixel_std=[0.5] * 3, patch=8, stride=8,
            vision_width=64, vision_layers=2, vision_heads=2, embed_dim=32, text_width=64,
            text_layers=2, text_heads=2, context_length=12, vocab_size=100, prompt_depth=2,
            vision_ctx=2, language_ctx=2, n_prefix=5, n_cls_ctx=4, eot_index=11, n_cls=16,
            seq_len=11)

# what each traffic kind needs changed to fit the tiny configuration
SHRINK = {
    "embed": dict(batch=8, pool_batches=3, warmup_batches=1, trace_batches=2, check_rows=12,
                  identities=10),
    "train": dict(batch=16, p_ids=4, k_images=4, pool_batches=4, trace_steps=2),
}


def tiny_cell(name: str) -> H.Cell:
    c = H.cell(name)
    return dataclasses.replace(c, config=dict(TINY),
                               traffic=dict(c.traffic, **SHRINK[c.traffic["kind"]]))
