"""Device resolution shared by the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU: with no card
and no explicit ``device="cpu"`` they raise instead of carrying on on the
host.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_reid_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the host"
        )
    return dev


def to_device(tree, device: torch.device):
    """A nested dict of numpy arrays or tensors -> the same dict of tensors
    on `device` (tensors already there are returned as they are)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        if not tree.flags.writeable:  # e.g. a view of a JAX array: copy it
            tree = np.array(tree)
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
    return torch.as_tensor(tree).to(device)


def clone(tree):
    """A copy of a nested dict of tensors that shares no storage with it."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.clone()
