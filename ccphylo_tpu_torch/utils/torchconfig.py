"""Device selection for the port (counterpart of utils/jaxconfig.py).

CCPHYLO_TORCH_DEVICE names the torch device the port computes on; it
defaults to ``cuda``.  Asking for CUDA on a machine without a usable
card raises: the port never carries on silently on the CPU.  The CPU
test suite sets ``CCPHYLO_TORCH_DEVICE=cpu`` explicitly, and then every
kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import os

import torch


def device() -> torch.device:
    dev = torch.device(os.environ.get("CCPHYLO_TORCH_DEVICE", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CCPHYLO_TORCH_DEVICE=%s but torch.cuda.is_available() is "
            "False; set CCPHYLO_TORCH_DEVICE=cpu to run the plain "
            "PyTorch versions" % dev)
    return dev
