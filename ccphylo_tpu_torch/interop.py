"""State carried over from the JAX package.

This system has no weights; its state is the 2-bit packed sequences
with their include masks, and the packed u8 `words` buffer with the
packed engine's state, and the float, quantized and hclust engines'
state.  `state_from_jax` turns the JAX package's numpy
forms of each into the port's tensors (u32 data as int32 bit patterns);
`streamed_state_from_jax` does the same for the row-cache engine, and
`sharded_state_from_jax` for one rank of the sharded DNJ engine.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.snp_torch import inc32_to_pairmask, u32_tensor, u64_to_u32
from .tree.packed_engine import state_from_npz
from .tree.streamed_engine import _STATE_KEYS as _STREAMED_KEYS
from .tree.torch_engine import state_from_numpy


def state_from_jax(*, seqs=None, includes=None, words=None, ckpt=None,
                   engine_state=None, float_state=None,
                   device="cpu") -> dict:
    """Convert whichever of these is given; returns a dict with the
    same keys:

    - seqs: (n, W64) u64 packed sequences -> (n, 2*W64) int32 words in
      hi-first base order (`u64_to_u32`);
    - includes: (W32,) or (n, W32) u32 include words -> pair masks of
      the same leading shape, (..., 2*W32) int32 (`inc32_to_pairmask`);
    - words: (npad, npad/4) u32 packed u8 matrix -> int32 tensor;
    - ckpt: path of a packed-engine checkpoint npz (the JAX engine's
      CCPHYLO_TPU_CKPT format) -> (engine state dict, joins done);
    - engine_state: the JAX packed engine's state as a mapping of its
      state keys to numpy arrays -> the port's engine state dict;
    - float_state: the state of the JAX float DNJ engine or of an hclust
      engine as a mapping of its names (D, sD, N, Q, P, seed, I, J, LI,
      LJ; Dq in place of D and no N for the quantized engine; no Q, P,
      seed for nj/mn) to numpy arrays -> the state dict of
      tree/torch_engine.py and tree/hclust_engine.py (u16 cells as
      int16 bit patterns), ready for their `_*_segment` functions.
    """
    out = {}
    if seqs is not None:
        out["seqs"] = u32_tensor(u64_to_u32(seqs), device)
    if includes is not None:
        out["includes"] = u32_tensor(inc32_to_pairmask(includes), device)
    if words is not None:
        out["words"] = u32_tensor(words, device)
    if ckpt is not None:
        with np.load(ckpt) as d:
            out["ckpt"] = (state_from_npz(d, device), int(d["meta"][0]))
    if engine_state is not None:
        out["engine_state"] = state_from_npz(engine_state, device)
    if float_state is not None:
        out["float_state"] = state_from_numpy(float_state, device)
    return out


# the JAX row-cache engine's state tuple (tree/streamed_engine.py)
_JAX_STREAMED_KEYS = ("cache", "slotof", "rowof", "sD2", "Q", "P", "seed",
                      "I", "J", "DIJ2", "SDI2", "SDJ2", "stats", "t", "ok",
                      "miss")


def streamed_state_from_jax(state, device="cpu"):
    """The JAX row-cache engine's 16-tuple state, as numpy arrays in the
    order of its `_STATE_KEYS`, -> (the port's state dict for
    `StreamedDNJ.run(state=...)`, the joins done).  The cache words
    cross as int32 bit patterns; residents of the JAX run stay resident,
    its idle rows (joined away, slot not yet freed) among them.  The
    caller replays the records of the joins done onto its host matrix
    (`_host_replay_shift`) before it goes on."""
    d = dict(zip(_JAX_STREAMED_KEYS, (np.asarray(x) for x in state)))
    # a copy: the engine updates its cache in place
    st = {"cache": u32_tensor(np.array(d["cache"], np.uint32), device)}
    for k in ("slotof", "sD2", "Q", "P", "DIJ2", "SDI2", "SDJ2"):
        st[k] = torch.from_numpy(np.array(d[k], np.int32)).to(device)
    st["rowof"] = torch.from_numpy(np.array(d["rowof"], np.int64)).to(device)
    st["seed"] = torch.tensor([int(d["seed"])], dtype=torch.long,
                              device=device)
    st["I"] = np.array(d["I"], np.int32)
    st["J"] = np.array(d["J"], np.int32)
    stats = np.zeros(4, np.int32)
    stats[0] = d["stats"][0]  # scan passes
    st["stats"] = torch.from_numpy(stats).to(device)
    assert set(st) == set(_STREAMED_KEYS)
    return st, int(d["t"])


# the JAX sharded DNJ engine's state tuple (parallel/sharded_dnj.py)
_JAX_SHARDED_KEYS = ("D", "sD", "N", "Q", "P", "seed", "I", "J", "LI", "LJ")


def sharded_state_from_jax(state, rank: int, world: int, device="cpu"):
    """The JAX sharded DNJ engine's 10-tuple state after some joins
    (its `seg_fn`'s, gathered to numpy arrays: the (npad, npad) matrix,
    the (npad,) vectors sD, N, Q, P, the seed and the join records) ->
    this rank's state of parallel/sharded_dnj.py: its block of rows
    rank*R .. (rank+1)*R of the matrix and of Q, P, R = npad / world,
    and the whole sD and N (which every rank keeps), ready for
    `sharded_dnj.dnj_segment(state, t, n - 2, n)` from the joins done,
    t, on.  Records are copied; the matrix is copied to `device`."""
    d = dict(zip(_JAX_SHARDED_KEYS, (np.asarray(x) for x in state)))
    npad = d["D"].shape[0]
    if npad % world:
        raise ValueError(f"{npad} rows do not split over {world} ranks")
    R = npad // world
    rows = slice(rank * R, (rank + 1) * R)
    st = {"Dl": torch.from_numpy(np.array(d["D"][rows])).to(device),
          "sD": torch.from_numpy(np.array(d["sD"])).to(device),
          "N": torch.from_numpy(np.array(d["N"], np.int32)).to(device),
          "Ql": torch.from_numpy(np.array(d["Q"][rows])).to(device),
          "Pl": torch.from_numpy(np.array(d["P"][rows], np.int32))
          .to(device)}
    st["seed"] = torch.tensor(int(d["seed"]), dtype=torch.long,
                              device=device)
    for k in ("I", "J"):
        st[k] = np.array(d[k], np.int32)
    for k in ("LI", "LJ"):
        st[k] = np.array(d[k])
    return st
