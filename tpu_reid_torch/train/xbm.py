"""XBM — cross-batch memory of embedding + label pairs (the port of
tpu_reid/train/xbm.py).

A ring buffer of fixed capacity (2 x batch in the reference) with
enqueue-dequeue semantics and an `is_full` gate. Validity is an explicit
fill counter, and enqueue returns the slots the batch landed in so that the
XBM triplet loss can exclude each anchor's own slot.

State is a plain dict: "feats" (capacity, dim) in the bank's dtype (fp32),
"labels" (capacity,) int32 with -1 for slots never written or written by a
padded row, and the Python ints "ptr" and "filled". Enqueue returns a new
dict and leaves the old one as it was, so a guard's snapshot of the state
before a step stays the state before the step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def init_xbm(capacity: int, dim: int, dtype: torch.dtype = torch.float32,
             device=None) -> dict:
    return {
        "feats": torch.zeros((capacity, dim), dtype=dtype, device=device),
        "labels": torch.full((capacity,), -1, dtype=torch.int32, device=device),
        "ptr": 0,
        "filled": 0,
    }


def xbm_enqueue(state: dict, feats: Tensor, labels: Tensor,
                valid: Optional[Tensor] = None) -> Tuple[dict, Tensor]:
    """Write a batch at the ring pointer. Returns (new_state, slots) where
    slots[i] is the bank position of feats[i]. The features are detached
    and cast to the bank's dtype.

    valid: optional (B,) bool mask — padded rows still take ring slots but
    are stored with label -1, which `xbm_get` reports as invalid."""
    cap = state["feats"].shape[0]
    b = feats.shape[0]
    if b > cap:
        raise ValueError(f"batch of {b} larger than the XBM capacity {cap}")
    if valid is not None:
        labels = torch.where(valid.bool(), labels, torch.full_like(labels, -1))
    slots = (state["ptr"] + torch.arange(b, device=feats.device)) % cap
    new = {
        "feats": state["feats"].index_copy(
            0, slots, feats.detach().to(state["feats"].dtype)),
        "labels": state["labels"].index_copy(0, slots, labels.to(torch.int32)),
        "ptr": (state["ptr"] + b) % cap,
        "filled": min(state["filled"] + b, cap),
    }
    return new, slots


def xbm_is_full(state: dict) -> bool:
    return state["filled"] >= state["feats"].shape[0]


def xbm_get(state: dict) -> Tuple[Tensor, Tensor, Tensor]:
    """(feats, labels, valid_mask). Unfilled slots, and slots a padded row
    was enqueued into (label -1), are reported invalid; the mining masks
    them out through the valid mask."""
    cap = state["feats"].shape[0]
    idx = torch.arange(cap, device=state["labels"].device)
    valid = (idx < state["filled"]) & (state["labels"] >= 0)
    return state["feats"], state["labels"], valid
