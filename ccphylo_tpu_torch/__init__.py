"""ccphylo_tpu_torch — the PyTorch/CUDA port of ccphylo_tpu for NVIDIA
Hopper (H100).

The JAX package `ccphylo_tpu` stays the reference: the tests hold every
ported piece bit-exactly against the JAX function it replaces.  This
package stands on its own: it imports `torch` and never `jax`, and
nothing of `ccphylo_tpu`.  The host modules its main path needs (io/,
native/, ops/pack2bit.py, ops/snp.py, ops/veccmp.py, tree/exact.py,
tree/newick_build.py, utils/, cli/) are its own copies, under the same
names and at the same places as in the reference.

The main path:
- `dist` on 2-bit packed alignments -> all-pairs SNP matrix
  (ops/snp_torch.py; CUDA expansion kernels csrc/snp_expand.cu);
- `tree -m dnj -b` on the exact-int32 packed u8 engine
  (tree/packed_engine.py; CUDA segment kernel csrc/dnj_segment.cu: on
  the card each segment of 1024 joins is one launch and no host read;
  beside it the batch-scan kernels csrc/dnj_scan.cu and
  csrc/qrow_mins.cu and the join-body kernel csrc/dnj_join.cu).
By default `tree` sends every complete matrix that a device engine
computes exactly to the card (cli/tree_cmd.py::_route): the packed
engine for `-m dnj -b`, the float64 engines of all seven methods
(tree/torch_engine.py, tree/hclust_engine.py) for integer cells, u16
cells for `-m dnj -s` with a power-of-two ByteScale; everything else
runs on the host exact engine (tree/exact.py).  Beside them: `dist` on
`.mat` count matrices (ops/matdist_torch.py), the row-cache DNJ engine
(tree/streamed_engine.py), the row-block-sharded engines over
torch.distributed (parallel/: DNJ, NJ/UPGMA, and
ops/snp_torch.sharded_snp_matrix), and the compile check and
multi-process dry run through every device engine (dryrun.py,
`python -m ccphylo_tpu_torch.dryrun [N]`).

Both run on the card unless the caller asks for the CPU
(CCPHYLO_TORCH_DEVICE=cpu for the plain PyTorch versions,
CCPHYLO_TORCH_DIST=host and CCPHYLO_TORCH_ENGINE=exact for the host
numpy code).  The reference's other twelve subcommands (dbscan, union,
merge, nwck2phy, tsv2phy, tsv2nwck, rarify, trim, phycmp, fullphy,
makespan, seq2fasta) are host code, as in the JAX package: cli/*_cmd.py
with their host modules io/tsv.py, io/newick_parse.py,
io/hashmapstr.py, io/kmadb.py, ops/distcmp.py and schedule/makespan.py.
"""

__version__ = "0.1.0"
