"""Inputs made on the card from the seed: person or vehicle crops with an
identity's pattern in them, and PK batches of identities."""

from __future__ import annotations

import torch

PATTERN_CELLS = (8, 4)  # an identity's pattern: a coarse grid of colours


def identity_images(gen: torch.Generator, ids: torch.Tensor, hw, n_ids: int) -> torch.Tensor:
    """uint8 (len(ids), H, W, 3) images: each identity's coarse colour grid
    (the same for every image of it, drawn first from `gen`) under a
    brightness shift and pixel noise of the image's own."""
    dev = ids.device
    h, w = hw
    gh, gw = PATTERN_CELLS
    patterns = torch.randn(n_ids, gh, gw, 3, generator=gen, device=dev)
    n = ids.shape[0]
    shift = torch.randn(n, 1, 1, 1, generator=gen, device=dev)
    noise = torch.randn(n, h, w, 3, generator=gen, device=dev)
    base = patterns[ids].repeat_interleave(-(-h // gh), 1).repeat_interleave(-(-w // gw), 2)
    x = 127.5 + 60.0 * base[:, :h, :w] + 20.0 * shift + 25.0 * noise
    return x.clamp_(0, 255).round_().to(torch.uint8)


def pk_labels(gen: torch.Generator, n_ids: int, p: int, k: int, device) -> torch.Tensor:
    """A PK batch's labels: p distinct identities, k images of each."""
    ids = torch.randperm(n_ids, generator=gen, device=device)[:p]
    return ids.repeat_interleave(k)
