"""PICASSO in PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

The package mirrors ``repro``'s module names (``configs``, ``core``,
``engine``, ``kernels``, ``models``, ``serve``, ``launch``) so each module's
counterpart is easy to find. It imports ``torch`` and never ``jax`` or
anything of ``repro``: what it needs of the framework-free planner is copied.

Entry points run on ``cuda`` unless the caller asks for the CPU; with no GPU
and no explicit CPU request they raise (``resolve_device``). Past world 1
the port runs one process per rank (``dist``): every entry point built for
``world > 1`` takes that rank's ``dist.Group`` and raises ``ValueError``
without it.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on. Asking for CUDA on a host without a
    usable GPU raises instead of carrying on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev
