"""`dist` subcommand of the port.

Argument parsing, sample loading, QuantCells and Phylip output are the
reference's own (ccphylo_tpu.cli.dist_cmd).  Its `fsa_matrix` looks
its two all-pairs seams, `_batch_shared` and `_batch_pairwise`, up as
module globals at call time, so the port runs that function with both
seams rebound to its own versions for the duration of the command
(`device_seams`) and restores them on exit; `fsa_matrix` itself is not
duplicated.

The port's seams compute on the torch device (ops/snp_torch) when
CCPHYLO_TORCH_DIST=device, and with the reference's numpy kernels
otherwise; they never reach the JAX device branches.  The
CCPHYLO_TPU_CKPT tile path stays on the host.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np

from ccphylo_tpu.cli import dist_cmd as host_dist
from ccphylo_tpu.ops import snp

from ..ops.snp_torch import (inc32_to_pairmask, snp_matrix,
                             snp_matrix_pairwise, u32_tensor, u64_to_u32)
from ..utils.torchconfig import device

_host_batch_shared = host_dist._batch_shared


def _use_device() -> bool:
    return os.environ.get("CCPHYLO_TORCH_DIST", "") == "device"


def _batch_shared(seqs, idxs, shared_inc):
    """All-pairs SNP counts of the included samples under the shared
    mask (reference dist_cmd._batch_shared)."""
    if os.environ.get("CCPHYLO_TPU_CKPT"):
        return _host_batch_shared(seqs, idxs, shared_inc)
    if not _use_device():
        return snp.pairwise_shared(np.stack([seqs[i] for i in idxs]),
                                   shared_inc)
    dev = device()
    s32 = u32_tensor(u64_to_u32(np.stack([seqs[i] for i in idxs])), dev)
    pm = u32_tensor(inc32_to_pairmask(shared_inc), dev)
    return snp_matrix(s32, pm).cpu().numpy()


def _batch_pairwise(seqs, includes, idxs):
    """All-pairs (dist, shared) with per-sample masks, proxi == 0
    (reference dist_cmd._batch_pairwise)."""
    S = np.stack([seqs[i] for i in idxs])
    I = np.stack([includes[i] for i in idxs])
    if not _use_device():
        return snp.pairwise_masked(S, I)
    dev = device()
    D, N = snp_matrix_pairwise(u32_tensor(u64_to_u32(S), dev),
                               u32_tensor(inc32_to_pairmask(I), dev))
    return D.cpu().numpy(), N.cpu().numpy()


@contextlib.contextmanager
def device_seams():
    saved = host_dist._batch_shared, host_dist._batch_pairwise
    host_dist._batch_shared = _batch_shared
    host_dist._batch_pairwise = _batch_pairwise
    try:
        yield
    finally:
        host_dist._batch_shared, host_dist._batch_pairwise = saved


def main_dist(argv: list[str]) -> int:
    with device_seams():
        return host_dist.main_dist(argv)
