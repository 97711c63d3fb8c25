"""Batched per-position multi-k k-mer frequency scan.

The reference computes, for every position of a read and every k in the pool
(e.g. {5, 9, 19, 21}), the both-strand frequency of the k-mer starting there
(LongReadProbe.cpp:136-158 filling KmerFeature::Log()[k][pos] via incremental
``expand`` — KmerFeature.h:37-64).  Both component searches of a k-mer consume
the word left-to-right, so the (k in pool) family at one position shares one
incremental chain of LF steps.

Here that chain is run simultaneously for *all* positions of *all* reads in a
batch: lane (r, p) holds the bi-interval of reads[r, p : p+j] after step j.
One step is four batched occ gathers over R*L lanes — this is the hot seeding
kernel.  Frequencies are snapshot at each pool size.

A k-mer whose window runs past the end of the read is "fake" and reports
freq = -1 (KmerFeature.h:62,90); positions past the read end also report -1.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import alphabet as ab
from ..index.fmindex import IndexSet
from . import rank

I32 = jnp.int32


@partial(jax.jit, static_argnames=("pool",))
def kmer_freq_scan(ix: IndexSet, reads: jax.Array, lengths: jax.Array, pool: tuple[int, ...]):
    """Bi-strand k-mer frequencies at every position for every k in pool.

    reads   : int8 [R, L] rank symbols, padded with PAD_RANK
    lengths : int32 [R]
    pool    : static ascending k sizes
    returns : freqs int32 [len(pool), R, L]; -1 where the k-mer is fake
              (pos + k > read length)
    """
    assert tuple(sorted(pool)) == tuple(pool)
    R, L = reads.shape
    sym0 = reads.astype(I32)
    state = rank.init_bi(ix, jnp.clip(sym0, 0, 4))
    max_k = pool[-1]
    freqs = []
    pos = jnp.arange(L, dtype=I32)[None, :]
    for j in range(1, max_k + 1):
        if j in pool:
            fake = pos + j > lengths[:, None]
            freqs.append(jnp.where(fake, -1, rank.bi_freq(state)))
        if j == max_k:
            break
        # expand every lane by the character at pos + j; lanes whose window
        # already left the read would produce garbage — freeze them instead
        # (their snapshots are fake at all larger k anyway)
        nxt = jnp.pad(sym0[:, j:], ((0, 0), (0, j)), constant_values=ab.PAD_RANK)
        live = nxt < 5
        new_state = rank.extend_bi(ix, state, jnp.clip(nxt, 0, 4))
        state = tuple(jnp.where(live, n, o) for n, o in zip(new_state, state))
    return jnp.stack(freqs)


@partial(jax.jit, static_argnames=("k",))
def kmer_freq_single(ix: IndexSet, reads: jax.Array, lengths: jax.Array, k: int):
    """Frequencies for one k (convenience wrapper, [R, L])."""
    return kmer_freq_scan(ix, reads, lengths, (k,))[0]


def _fused_rows(fm):
    """Symbols + checkpoint counts in ONE gatherable row: [nb, block+20] i8.

    The scan's extend step needs a block row AND its ckpt row per query —
    gathering them separately doubles the random-row traffic that
    dominates the table build.  The 5 int32 ckpt counts ride as 20 extra
    int8 lanes, bitcast back after the gather."""
    ck8 = jax.lax.bitcast_convert_type(fm.ckpt, jnp.int8)
    return jnp.concatenate([fm.blocks, ck8.reshape(fm.ckpt.shape[0], -1)],
                           axis=1)


def _occ_fusedrow(rows, block, sym, idx):
    """occ(sym, BWT[0..idx]) with one fused-row gather per query."""
    p = (idx + 1).astype(I32)
    q = p // block
    r = p - q * block
    g = rows[q]                                     # [..., block+20]
    row = g[..., :block]
    ck = jax.lax.bitcast_convert_type(
        g[..., block : block + 20].reshape(*g.shape[:-1], 5, 4), jnp.int32)
    lane = jax.lax.broadcasted_iota(I32, row.shape, row.ndim - 1)
    hits = (row == sym[..., None].astype(jnp.int8)) & (lane < r[..., None])
    base = jnp.take_along_axis(ck, sym.astype(I32)[..., None], axis=-1,
                               mode="clip")[..., 0]
    return base + hits.sum(axis=-1, dtype=I32)


def _update_fusedrow(rows, block, C, lo, hi, sym):
    pb = C[sym]
    return (pb + _occ_fusedrow(rows, block, sym, lo - 1),
            pb + _occ_fusedrow(rows, block, sym, hi) - 1)


@partial(jax.jit, static_argnames=("max_k",))
def kmer_table_full(ix: IndexSet, reads: jax.Array, lengths: jax.Array, max_k: int):
    """freq + validity for EVERY k in 1..max_k at every position.

    The device version of HostIndexSet.kmer_freq_table (all intermediate
    sizes recorded, feeding the dynamic-kmer seed scan).
    Returns (freq int32 [max_k+1, R, L], valid bool [max_k+1, R, L]).
    """
    R, L = reads.shape
    sym0 = reads.astype(I32)
    state = rank.init_bi(ix, jnp.clip(sym0, 0, 4))
    rows_f = _fused_rows(ix.rbwt)
    rows_r = _fused_rows(ix.bwt)
    pos = jnp.arange(L, dtype=I32)[None, :]
    freqs = [jnp.full((R, L), -1, I32)]
    valids = [jnp.zeros((R, L), bool)]
    for j in range(1, max_k + 1):
        fake = pos + j > lengths[:, None]
        f_lo, f_hi, r_lo, r_hi = state
        bival = (f_lo <= f_hi) & (r_lo <= r_hi)
        freqs.append(jnp.where(fake, -1, rank.bi_freq(state)))
        valids.append(jnp.where(fake, False, bival))
        if j == max_k:
            break
        nxt = jnp.pad(sym0[:, j:], ((0, 0), (0, j)), constant_values=ab.PAD_RANK)
        live = nxt < 5
        s = jnp.clip(nxt, 0, 4)
        nf = _update_fusedrow(rows_f, ix.rbwt.block, ix.rbwt.C, f_lo, f_hi, s)
        nr = _update_fusedrow(rows_r, ix.bwt.block, ix.bwt.C, r_lo, r_hi,
                              rank.comp(s))
        new_state = (nf[0], nf[1], nr[0], nr[1])
        state = tuple(jnp.where(live, n, o) for n, o in zip(new_state, state))
    return jnp.stack(freqs), jnp.stack(valids)
