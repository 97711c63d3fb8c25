"""Batched rank / LF-mapping / backward-search primitives.

Batched device equivalents of the reference's per-call scalar queries:

* ``occ``          ~ RLBWT::getOcc           (SuffixTools/RLBWT.h:121)
* ``occ_all``      ~ RLBWT::getFullOcc       (SuffixTools/RLBWT.h:143)
* ``update_interval`` ~ BWTAlgorithms::updateInterval (BWTAlgorithms.h:66-72)
* ``init_interval``   ~ BWTAlgorithms::initInterval   (BWTAlgorithms.h:136-140)
* ``find_interval``   ~ BWTAlgorithms::findInterval   (BWTAlgorithms.cpp:14-31)
* ``extend_bi``       ~ BWTAlgorithms::updateBiInterval (BWTAlgorithms.h:73-77)

Every function is vectorised over arbitrary leading batch dimensions; an
interval is the pair of int32 arrays ``(lower, upper)`` and is *invalid* when
``lower > upper`` (invalidity is sticky under the update math, matching the
reference's early-exit semantics without data-dependent control flow).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..index.fmindex import FMIndex, IndexSet

I32 = jnp.int32

# rank-space complement: $->$ , A<->T, C<->G (comp(b) = 5-b for bases)
def comp(sym: jax.Array) -> jax.Array:
    return jnp.where(sym == 0, 0, 5 - sym)


def occ(fm: FMIndex, sym: jax.Array, idx: jax.Array) -> jax.Array:
    """#occurrences of ``sym`` in BWT[0..idx] inclusive; idx == -1 -> 0."""
    p = (idx + 1).astype(I32)
    q = p // fm.block
    r = p - q * fm.block
    rows = fm.blocks[q]                                # [..., block] gather
    lane = jax.lax.broadcasted_iota(I32, rows.shape, rows.ndim - 1)
    hits = (rows == sym[..., None].astype(jnp.int8)) & (lane < r[..., None])
    base = fm.ckpt[q, sym.astype(I32)]
    return base + hits.sum(axis=-1, dtype=I32)


def occ_all(fm: FMIndex, idx: jax.Array) -> jax.Array:
    """AlphaCount over all 5 rank symbols of BWT[0..idx]; shape [..., 5]."""
    p = (idx + 1).astype(I32)
    q = p // fm.block
    r = p - q * fm.block
    rows = fm.blocks[q]                                # [..., block]
    lane = jax.lax.broadcasted_iota(I32, rows.shape, rows.ndim - 1)
    in_prefix = lane < r[..., None]
    syms = jnp.arange(5, dtype=jnp.int8)
    hits = (rows[..., None] == syms) & in_prefix[..., None]
    return fm.ckpt[q] + hits.sum(axis=-2, dtype=I32)


def pc(fm: FMIndex, sym: jax.Array) -> jax.Array:
    """getPC: #symbols lexicographically smaller than sym."""
    return fm.C[sym.astype(I32)]


def init_interval(fm: FMIndex, sym: jax.Array):
    """Interval of all suffixes starting with sym."""
    lower = fm.C[sym.astype(I32)]
    upper = fm.C[sym.astype(I32) + 1] - 1
    return lower, upper


def update_interval(fm: FMIndex, lower: jax.Array, upper: jax.Array, sym: jax.Array):
    """LF step: interval of S -> interval of (sym)S."""
    pb = pc(fm, sym)
    new_lower = pb + occ(fm, sym, lower - 1)
    new_upper = pb + occ(fm, sym, upper) - 1
    return new_lower, new_upper


def interval_size(lower: jax.Array, upper: jax.Array) -> jax.Array:
    """getFreq: interval size, 0 when invalid (BWTInterval.h:27-29)."""
    return jnp.maximum(upper - lower + 1, 0).astype(I32)


def find_interval(fm: FMIndex, word: jax.Array):
    """Backward search of fixed-length words.

    word: int32/int8 [..., k] in rank space.  Processes characters from the
    last to the first, like findInterval (BWTAlgorithms.cpp:14-31).  The
    reference breaks out on an invalid interval; here invalidity is sticky so
    the result is identical without control flow.
    """
    word = word.astype(I32)
    k = word.shape[-1]
    lower, upper = init_interval(fm, word[..., k - 1])

    def body(j, state):
        lo, hi = state
        sym = jax.lax.dynamic_index_in_dim(word, k - 2 - j, axis=-1, keepdims=False)
        return update_interval(fm, lo, hi, sym)

    return jax.lax.fori_loop(0, k - 1, body, (lower, upper))


# ---------------------------------------------------------------------------
# Bidirectional (both-strand) intervals over the {BWT, RBWT} pair.
#
# The reference's BiBWTInterval tracks, for a word W:
#   fwdInterval = interval of reverse(W) in the RBWT  (counts W on + strand)
#   rvcInterval = interval of revcomp(W) in the BWT   (counts W on - strand)
# Appending base b to W updates fwd with b on the RBWT and rvc with comp(b)
# on the BWT (KmerFeature.h:92-99, BWTAlgorithms.h:73-77).
# ---------------------------------------------------------------------------

def init_bi(ix: IndexSet, sym: jax.Array):
    f_lo, f_hi = init_interval(ix.rbwt, sym)
    r_lo, r_hi = init_interval(ix.bwt, comp(sym))
    return f_lo, f_hi, r_lo, r_hi


def extend_bi(ix: IndexSet, state, sym: jax.Array):
    f_lo, f_hi, r_lo, r_hi = state
    f_lo, f_hi = update_interval(ix.rbwt, f_lo, f_hi, sym)
    r_lo, r_hi = update_interval(ix.bwt, r_lo, r_hi, comp(sym))
    return f_lo, f_hi, r_lo, r_hi


def bi_freq(state) -> jax.Array:
    f_lo, f_hi, r_lo, r_hi = state
    return interval_size(f_lo, f_hi) + interval_size(r_lo, r_hi)


def find_bi_interval(ix: IndexSet, word: jax.Array):
    """BiBWTInterval of fixed-length words (findBiInterval semantics).

    Both component searches consume the word left-to-right (see
    BWTAlgorithms.cpp:32-38: fwd searches reverse(w) in the RBWT, rvc searches
    revcomp(w) in the BWT — each reduces to scanning w forward).
    """
    word = word.astype(I32)
    k = word.shape[-1]
    state = init_bi(ix, word[..., 0])

    def body(j, st):
        sym = jax.lax.dynamic_index_in_dim(word, j + 1, axis=-1, keepdims=False)
        return extend_bi(ix, st, sym)

    return jax.lax.fori_loop(0, k - 1, body, state)


def count_occurrences_both_strands(fm: FMIndex, word: jax.Array) -> jax.Array:
    """countSequenceOccurrences: freq of word + its revcomp in one BWT
    (BWTAlgorithms.h:56 / BWTAlgorithms.cpp implementation)."""
    lo1, hi1 = find_interval(fm, word)
    rc = comp(word.astype(I32))[..., ::-1]
    lo2, hi2 = find_interval(fm, rc)
    return interval_size(lo1, hi1) + interval_size(lo2, hi2)
