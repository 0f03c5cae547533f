"""MaPLe multi-modal prompt coupling (the port of
tpu_reid/models/maple_prompts.py).

The vision prompts are no parameters of their own: a shared text-side
context and per-layer deeper text prompts are projected into the vision
width by per-layer linear couplings, so one set of learnable tokens steers
both towers. `maple_prompt_stacks` gives the per-layer stacks the towers
already take:

  * models.vit.apply_vit(..., shallow_prompt=, deep_prompts=) — (n_ctx, d_vis)
    and (L, n_ctx, d_vis),
  * models.text.encode_text_embeddings(..., deep_prompts=) — (L, n_ctx, d_text).

Layer 0's vision prompts are the shallow ones (appended to the input);
layers 1..depth-1 replace the prompt tokens in flight, gated as IVLP's are.
The stacks are computed tensors: in stage 1 their gradient reaches the
couplings and the shared context through the block kernels' autograd
Function.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def init_maple(gen: torch.Generator, n_ctx: int, depth: int, d_text: int, d_vis: int) -> dict:
    """shared_ctx: the layer-0 text context; text_deep: the deeper text
    prompts of layers 1..depth-1; proj: one text -> vision coupling per
    prompted layer. Drawn from `gen` on the CPU."""

    def normal(*shape, std):
        return torch.randn(*shape, generator=gen, dtype=torch.float32) * std

    return {
        "shared_ctx": normal(n_ctx, d_text, std=0.02),
        "text_deep": normal(max(depth - 1, 0), n_ctx, d_text, std=0.02),
        "proj": {"w": normal(depth, d_text, d_vis, std=d_text ** -0.5),
                 "b": torch.zeros(depth, d_vis)},
    }


def maple_prompt_stacks(params: dict, n_layers: int) -> Tuple[Tensor, Tensor, Tensor]:
    """(vision_shallow (n_ctx, d_vis), vision_deep (n_layers, n_ctx, d_vis),
    text_deep (n_layers, n_ctx, d_text)). The deep stacks are zero-padded
    past the coupling depth; the towers' per-layer gating keeps the padded
    layers inert."""
    shared = params["shared_ctx"]
    depth = params["proj"]["w"].shape[0]
    text_all = torch.cat([shared[None], params["text_deep"]], dim=0)  # (depth, n_ctx, d_text)
    vis_all = (torch.einsum("lcd,lde->lce", text_all, params["proj"]["w"])
               + params["proj"]["b"][:, None, :])  # (depth, n_ctx, d_vis)
    pad = max(n_layers - depth, 0)

    def padded(a):
        return torch.cat([a[:n_layers], a.new_zeros((pad,) + tuple(a.shape[1:]))], dim=0)

    return vis_all[0], padded(vis_all), padded(text_all)
