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


def full_fp32_convs() -> None:
    """Run cuDNN's fp32 convolutions in full fp32 in this process. PyTorch
    lets them round their operands to TF32's 10-bit mantissa by default
    (`torch.backends.cudnn.allow_tf32`), which the fp32 matmuls never do
    (`torch.backends.cuda.matmul.allow_tf32` stays False): the patch embed
    and the ResNet's convolutions would then differ from the JAX package and
    from the plain path on the host. Every entry point of the port calls it
    first, and so does each rank that `parallel/launch.run` spawns."""
    torch.backends.cudnn.allow_tf32 = False


def to_device(tree, device: torch.device):
    """A nested dict (or list, as a ResNet's layers) of numpy arrays or
    tensors -> the same structure of tensors on `device` (tensors already
    there are returned as they are)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    if isinstance(tree, np.ndarray):
        if not tree.flags.writeable:  # e.g. a view of a JAX array: copy it
            tree = np.array(tree)
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
    return torch.as_tensor(tree).to(device)


def clone(tree):
    """A copy of a nested dict (or list) of tensors that shares no storage
    with it."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.clone()
