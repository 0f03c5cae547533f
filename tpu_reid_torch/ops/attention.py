"""Softmax-profile switch and the plain attention core.

The attention kernel itself is part of the block kernels
(`ops/fused_attention.py`); this module keeps the process-wide fast-softmax
profile and `xla_mha_core`, the plain PyTorch core of the plain block.
"""

from __future__ import annotations

import math

import torch

_FAST_SOFTMAX = False


def set_fast_softmax(enabled: bool) -> None:
    """Throughput profile for the attention softmax. Per path:

    * plain core (`xla_mha_core`, bf16 inputs only): probabilities cast to
      bf16 after a standard fp32 max-subtracted exp; the normalising sum
      stays fp32.
    * block kernels (`fused_attention.attention` with fast=True): exp2 with
      a saturating clamp replaces the max-reduce and subtract (masks are
      baked pre-scaled by log2(e)); probabilities are cast to the working
      type for the p@v product, as on the exact path.

    Parity-sensitive evals leave this off (default)."""
    global _FAST_SOFTMAX
    _FAST_SOFTMAX = enabled


def fast_softmax_enabled() -> bool:
    """Read of the fast-softmax profile flag (the block kernels switch to the
    exp2/saturating-clamp softmax when set)."""
    return _FAST_SOFTMAX


def xla_mha_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain attention core over (B, S, H, dh) q, k, v -> (B, S, H, dh).

    Scores in fp32; softmax in fp32 and the probabilities cast to the input
    dtype before p@v (the name keeps the JAX counterpart's)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s + mask.float()
    if _FAST_SOFTMAX and q.dtype == torch.bfloat16:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m).to(torch.bfloat16)
        p = e / e.float().sum(dim=-1, keepdim=True).to(torch.bfloat16)
    else:
        p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
