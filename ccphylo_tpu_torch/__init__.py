"""ccphylo_tpu_torch — the PyTorch/CUDA port of ccphylo_tpu for NVIDIA
Hopper (H100).

The JAX package `ccphylo_tpu` stays the reference: every ported piece
is held bit-exactly against the JAX function it replaces.  This package
imports `torch` and never `jax`; it reuses the reference's host-only
modules (io/, tree/exact.py, tree/newick_build.py, ops/snp.py,
ops/pack2bit.py and the host CLI modules) by import.

Ported so far, the main path:
- `dist` on 2-bit packed alignments -> all-pairs SNP matrix
  (ops/snp_torch.py; CUDA expansion kernels csrc/snp_expand.cu);
- `tree -m dnj -b` on the exact-int32 packed u8 engine
  (tree/packed_engine.py; CUDA batch-scan kernel csrc/qrow_mins.cu).

Other subcommands are delegated to `ccphylo_tpu.cli`.
"""

__version__ = "0.1.0"
