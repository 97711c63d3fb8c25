"""HBM-resident FM-index rank structure.

Device-friendly replacement for the reference's run-length BWT with two-level
occ markers (SuffixTools/RLBWT.h:121-161, SuffixTools/FMMarkers.h).  Instead of a
data-dependent run scan, the BWT is stored as fixed-size symbol blocks plus an
absolute occurrence checkpoint per block, so a rank query is

    occ(b, i) = ckpt[i // B, b]  +  popcount(block[i // B][:i % B] == b)

i.e. one checkpoint gather + one aligned block gather + a masked compare-sum —
branch-free, constant work, batchable over thousands of query lanes.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_BLOCK = 128


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["blocks", "ckpt", "C"],
    meta_fields=["n", "num_strings", "block"],
)
@dataclass(frozen=True)
class FMIndex:
    """One BWT as device tensors.

    blocks : int8  [nb, block]   BWT symbols, padded with PAD_RANK
    ckpt   : int32 [nb, 5]       occ counts of each symbol before block start
    C      : int32 [6]           C[s] = #symbols < s over the whole BWT (getPC)
    """

    blocks: jax.Array
    ckpt: jax.Array
    C: jax.Array
    n: int
    num_strings: int
    block: int

    @staticmethod
    def from_symbols(
        symbols: np.ndarray, num_strings: int, block: int = DEFAULT_BLOCK
    ) -> "FMIndex":
        from .pack import pack_symbols

        n = len(symbols)
        blocks, ckpt, C = pack_symbols(symbols, block)
        return FMIndex.from_pack(blocks, ckpt, C, n, num_strings)

    @staticmethod
    def from_pack(
        blocks: np.ndarray, ckpt: np.ndarray, C: np.ndarray, n: int,
        num_strings: int,
    ) -> "FMIndex":
        """Wrap a persisted packed layout (index/pack.py) as device tensors."""
        return FMIndex(
            blocks=jnp.asarray(blocks),
            ckpt=jnp.asarray(np.asarray(ckpt, np.int32)),
            C=jnp.asarray(np.asarray(C, np.int32)),
            n=int(n),
            num_strings=int(num_strings),
            block=blocks.shape[1],
        )

    def symbol_counts(self) -> jax.Array:
        return self.C[1:] - self.C[:-1]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["bwt", "rbwt"],
    meta_fields=[],
)
@dataclass(frozen=True)
class IndexSet:
    """The {BWT, RBWT} bundle threaded through every algorithm.

    Mirrors BWTIndexSet (SuffixTools/BWTIndexSet.h:23-34); the sampled SA and
    interval cache are separate optional components.
    """

    bwt: FMIndex
    rbwt: FMIndex
