"""Batched device FM-extension walk — the frontier engine.

The host engine (core/extend.py) walks one seed-gap at a time with Python
control flow.  This module reformulates the walk as fixed-shape tensors over
``G`` gap lanes x ``L`` leaf slots, advanced by ONE jitted superstep per base:
every FM-index probe in a superstep is a batched rank gather over all active
(gap, leaf) lanes, so thousands of independent seed-gaps from many reads
stream through the chip together.  Semantics follow
PacBio/LongReadCorrectByOverlap.cpp; the two documented divergences from the
scalar reference are:

* seed-support ties (equal |pos - currSeedIdx|) break by (smaller pos, fwd
  strand) instead of interval-tree traversal order
  (LongReadCorrectByOverlap.cpp:566-635);
* error-rate accumulation runs in float32 by default (float64 when x64 is
  enabled); the reference uses C doubles.

Both are validated against the host engine in tests (divergence is expected
to be rare); gaps whose on-device result is flagged (result overflow) are
replayed on the host engine by the scheduler.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import alphabet as ab
from ..index.fmindex import IndexSet
from . import rank

I32 = jnp.int32
NEG = jnp.int32(-(1 << 30))


CACHE_K = 8  # base cached kmer length for chain seeding (BWTIntervalCache analog)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["blocks", "ckpt", "frows", "C_bwt", "C_rbwt", "wcache"],
    meta_fields=["block", "rbwt_row_off", "ck"],
)
@dataclass(frozen=True)
class FusedFM:
    """BWT and RBWT concatenated into one rank table so a chain iteration
    touching both strands issues a single stacked gather, plus a precomputed
    interval table for every ck-mer (exact chain seeding — the values
    equal what ck LF steps would produce, cf. BWTIntervalCache /
    findIntervalWithCache BWTAlgorithms.cpp:42-68)."""

    blocks: jax.Array      # i8  [nb_bwt + nb_rbwt, B]
    ckpt: jax.Array        # i32 [nb_bwt + nb_rbwt, 5]
    frows: jax.Array       # i8  [nb, B+20]: blocks ++ bitcast ckpt — one
                           # gather fetches a slab row AND its checkpoint
    C_bwt: jax.Array       # i32 [6]
    C_rbwt: jax.Array      # i32 [6]
    wcache: jax.Array      # i32 [4^ck, 4] walk-convention bi-interval of word
    block: int
    rbwt_row_off: int
    ck: int                # cached word length (chain ring bottom slot)

    @staticmethod
    def from_index_set(ix: IndexSet, host_ix, ck: int = CACHE_K) -> "FusedFM":
        assert ix.bwt.block == ix.rbwt.block
        blocks = jnp.concatenate([ix.bwt.blocks, ix.rbwt.blocks], axis=0)
        ckpt = jnp.concatenate([ix.bwt.ckpt, ix.rbwt.ckpt], axis=0)
        ck8 = jax.lax.bitcast_convert_type(ckpt, jnp.int8)
        fused = FusedFM(
            blocks=blocks,
            ckpt=ckpt,
            frows=jnp.concatenate(
                [blocks, ck8.reshape(ckpt.shape[0], -1)], axis=1),
            C_bwt=ix.bwt.C,
            C_rbwt=ix.rbwt.C,
            wcache=jnp.zeros((1, 4), I32),  # placeholder, replaced below
            block=ix.bwt.block,
            rbwt_row_off=ix.bwt.blocks.shape[0],
            ck=ck,
        )
        wc = _get_wcache(ix, host_ix, ck, fused)
        object.__setattr__(fused, "wcache", jnp.asarray(wc))
        return fused


def _get_wcache(ix: IndexSet, host_ix, ck: int, fused: "FusedFM"):
    """Walk-convention interval table for all ck-mers; host-built for the
    base CACHE_K, extended level-by-level on device for larger ck (each
    level is one batched LF over 4^k lanes), persisted next to the packed
    index when a pack dir is known."""
    caches = getattr(host_ix, "_kmer_caches", None)
    if caches is None:
        caches = host_ix._kmer_caches = {}
    if ck in caches:
        return caches[ck]
    pack_dir = getattr(host_ix, "pack_dir", None)
    if ck > CACHE_K and pack_dir is not None:
        import os
        path = os.path.join(pack_dir, f"wcache{ck}.npy")
        if os.path.exists(path):
            wc = np.load(path, mmap_mode="r")
            caches[ck] = wc
            return wc
    if ck == CACHE_K:
        wc = getattr(host_ix, "_kmer_cache8", None)
        if wc is None:
            wc = _build_kmer_caches(host_ix)[0]
    else:
        base = jnp.asarray(np.asarray(_get_wcache(ix, host_ix, CACHE_K, fused)))
        st = (base[:, 0], base[:, 1], base[:, 2], base[:, 3])
        for _ in range(ck - CACHE_K):
            st = _wcache_level_up(fused, *st)
        wc = np.stack([np.asarray(x) for x in st], axis=1).astype(np.int32)
        if pack_dir is not None:
            import os
            np.save(os.path.join(pack_dir, f"wcache{ck}.npy"), wc)
    caches[ck] = wc
    return wc


@jax.jit
def _wcache_level_up(fused, f_lo, f_hi, r_lo, r_hi):
    """One trie level: children codes = code*4 + (c-1) (append char c)."""
    n = f_lo.shape[0]
    sym = jnp.tile(jnp.arange(1, 5, dtype=I32), (n, 1)).reshape(-1)  # per child
    rep = lambda x: jnp.repeat(x, 4)
    csym = _comp4(sym)
    idx4 = jnp.stack([rep(f_lo) - 1, rep(f_hi), rep(r_lo) - 1, rep(r_hi)])
    sym4 = jnp.stack([sym, sym, csym, csym])
    in_rbwt = jnp.asarray([True, True, False, False])[:, None]
    occ4 = occ_fused(fused, sym4, idx4, in_rbwt)
    return (
        fused.C_rbwt[sym] + occ4[0],
        fused.C_rbwt[sym] + occ4[1] - 1,
        fused.C_bwt[csym] + occ4[2],
        fused.C_bwt[csym] + occ4[3] - 1,
    )


def _build_kmer_caches(host_ix):
    """Host-side interval table for all CACHE_K-mers, built level-by-level
    over the 4-ary trie (each level is one batched LF over 4^k lanes, so the
    whole build costs ~1.3x the last level instead of CACHE_K x)."""
    # walk convention (append-extension): code of w = chars left-to-right
    sym1 = np.arange(1, 5, dtype=np.int64)
    state = list(host_ix.init_bi(sym1))
    for _ in range(CACHE_K - 1):
        # children codes: code*4 + c  <=>  append char c
        n = len(state[0])
        rep = [np.repeat(x, 4) for x in state]
        csym = np.tile(sym1, n)
        state = list(host_ix.extend_bi(tuple(rep), csym))
    wcache = np.stack(state, axis=1).astype(np.int32)
    return (wcache,)


def occ_fused(fm: FusedFM, sym, idx, is_rbwt):
    """occ over the fused table; is_rbwt selects the sub-table per lane."""
    p = (idx + 1).astype(I32)
    q = p // fm.block + jnp.where(is_rbwt, fm.rbwt_row_off, 0)
    r = p - (p // fm.block) * fm.block
    rows = fm.blocks[q]
    lane = jax.lax.broadcasted_iota(I32, rows.shape, rows.ndim - 1)
    hits = (rows == sym[..., None].astype(jnp.int8)) & (lane < r[..., None])
    return fm.ckpt[q, sym.astype(I32)] + hits.sum(axis=-1, dtype=I32)


def _register(cls, data, meta=()):
    return partial(
        jax.tree_util.register_dataclass, data_fields=list(data), meta_fields=list(meta)
    )(cls)


@dataclass(frozen=True)
class WalkConfig:
    G: int = 64            # gap lanes
    L: int = 4             # leaf storage slots (< maxLeaves: gaps that grow
                           # beyond L but <= maxLeaves are re-run at L=32)
    CAND: int = 16         # transient candidates (4 * L)
    MAXLEN: int = 512      # label buffer (covers maxLength)
    QMAX: int = 512        # query buffer
    TMAX: int = 48         # terminal-interval slots (trg_len - minOverlap + 1)
    RMAX: int = 16         # result slots per gap
    RING: int = 100        # localSimilarlykmerSize
    KMAX: int = 24         # upper bound on any backward-search chain length
    WSCAN: int = 288       # query-position scan window (>= 2*max_indel+21)
    seed_size: int = 9     # idmer length
    max_leaves: int = 32
    CK: int = CACHE_K      # chain-ring bottom slot length (= wcache word len)
    SLAB: bool = False     # occ via per-leaf contiguous block slabs
    SB: int = 6            # slab span in blocks (slot-0 interval must fit)
    err_dtype: type = jnp.float32

    @property
    def NCHAIN(self) -> int:
        """Chain-ring slots: one per suffix length in [CK, KMAX]."""
        return self.KMAX - self.CK + 1


@dataclass
class GapTask:
    """Host-side description of one seed-gap walk (inputs of
    LongReadSelfCorrectByOverlap's constructor)."""

    src: str               # source seed suffix (length == init_k)
    path: str              # raw read between the seeds
    trg: str               # target seed
    dis: int               # disBetweenSrcTarget
    init_k: int
    max_overlap: int
    min_overlap: int
    min_sa_threshold: int
    tag: object = None     # scheduler cookie


@dataclass(frozen=True)
class WalkConsts:
    """Per-gap constant tensors (uploaded once per batch)."""

    query: jax.Array        # i8  [G, QMAX]
    q_len: jax.Array        # i32 [G]
    trg: jax.Array          # i8  [G, TMAX + KMAX]  (target seed, padded)
    trg_len: jax.Array      # i32 [G]
    n_term: jax.Array       # i32 [G] number of terminal offsets
    term_f: jax.Array       # i32 [G, TMAX, 2] terminal fwd intervals
    term_r: jax.Array       # i32 [G, TMAX, 2]
    qcode9: jax.Array       # i32 [G, QMAX] packed idmer at each query pos (-1 pad)
    qcode5: jax.Array       # i32 [G, QMAX] packed 5-mer at each query pos
    init_k: jax.Array       # i32 [G]
    max_overlap: jax.Array  # i32 [G]
    min_overlap: jax.Array  # i32 [G]
    min_sa: jax.Array       # i32 [G]
    max_indel: jax.Array    # i32 [G]
    max_length: jax.Array   # i32 [G]
    min_length: jax.Array   # i32 [G] (clamped; no_term handles wrap)
    no_term: jax.Array      # bool [G] min-length wrapped => never terminates
    freqs: jax.Array        # f32 [101] expected freq per k (shared)
    pacbio_e: jax.Array     # f32 scalar
    err_bound: jax.Array    # f32 scalar (0.25)


WalkConsts = _register(
    WalkConsts,
    [
        "query", "q_len", "trg", "trg_len", "n_term", "term_f", "term_r",
        "qcode9", "qcode5", "init_k", "max_overlap",
        "min_overlap", "min_sa", "max_indel", "max_length", "min_length",
        "no_term", "freqs", "pacbio_e", "err_bound",
    ],
)


@dataclass
class WalkState:
    # per (gap, leaf)
    labels: jax.Array        # i8 [G, L, MAXLEN]
    f_lo: jax.Array          # i32 [G, L]
    f_hi: jax.Array
    r_lo: jax.Array
    r_hi: jax.Array
    alive: jax.Array         # bool [G, L]
    kmer_freq: jax.Array     # i32 [G, L] (leafInfo.kmerFrequency)
    total_kmer: jax.Array    # i32
    last_seed_idx: jax.Array
    last_overlap_len: jax.Array
    total_seeds: jax.Array
    curr_overlap_len: jax.Array
    num_errors: jax.Array
    seed_idx_offset: jax.Array
    query_overlap_len: jax.Array
    red_a: jax.Array         # i32: count of (1 - e) redeem increments
    red_b: jax.Array         # i32: count of (seed_size-1)*e redeem increments
                             # (numRedeemSeed tracked as INTEGER counters so
                             # error rates are canonical f32 functions of the
                             # history — an accumulated f32 redeem drifted and
                             # broke the attempToExtend local_err == min_err
                             # retry equality the reference tests in double)
    res_first: jax.Array     # i32 (resultindex.first, -1 none)
    res_second: jax.Array    # i32
    tail_letter: jax.Array   # i8
    tail_count: jax.Array    # i32
    tail9: jax.Array         # i32 packed last-9-chars code per leaf
    tail8: jax.Array         # i32 packed last-CACHE_K-chars 2-bit code (wcache key)
    chain: jax.Array         # i32 [G, L, 4, NCHAIN] chain ring: slot j holds the
                             # walk-convention (f_lo,f_hi,r_lo,r_hi) interval of
                             # the label suffix of length CACHE_K+j — maintained
                             # incrementally so refineSAInterval /
                             # SelectFreqsOfrange never re-walk LF chains
    local_err: jax.Array     # err_dtype [G, L]
    gerr_last: jax.Array     # err_dtype [G, L]
    ring: jax.Array          # err_dtype [G, L, RING]
    # per gap
    active: jax.Array        # bool [G]
    cur_len: jax.Array       # i32 [G]
    cur_k: jax.Array         # i32 [G]
    gerr_n: jax.Array        # i32 [G] global record length
    code: jax.Array          # i32 [G] 0 active; 1/-1/-2/-3 finished
    # results
    res_labels: jax.Array    # i8 [G, RMAX, MAXLEN]
    res_len: jax.Array       # i32 [G, RMAX]
    res_err: jax.Array       # err_dtype [G, RMAX]
    res_i: jax.Array         # i32 [G, RMAX]
    res_count: jax.Array     # i32 [G]
    res_overflow: jax.Array  # bool [G]


WalkState = _register(
    WalkState,
    [
        "labels", "f_lo", "f_hi", "r_lo", "r_hi", "alive", "kmer_freq",
        "total_kmer", "last_seed_idx", "last_overlap_len", "total_seeds",
        "curr_overlap_len", "num_errors", "seed_idx_offset",
        "query_overlap_len", "red_a", "red_b", "res_first", "res_second",
        "tail_letter", "tail_count", "tail9", "tail8", "chain",
        "local_err", "gerr_last", "ring",
        "active", "cur_len", "cur_k", "gerr_n", "code",
        "res_labels", "res_len", "res_err", "res_i", "res_count",
        "res_overflow",
    ],
)


# ---------------------------------------------------------------------------
# host-side batch construction
# ---------------------------------------------------------------------------

def _dev_index_of(host_ix) -> IndexSet:
    """Device IndexSet wrapping a HostIndexSet's packed arrays (cached)."""
    dix = getattr(host_ix, "_dev_ix", None)
    if dix is None:
        from ..index.fmindex import FMIndex

        dix = IndexSet(
            bwt=FMIndex.from_pack(host_ix.bwt.blocks, host_ix.bwt.ckpt,
                                  host_ix.bwt.C32, host_ix.bwt.n,
                                  host_ix.bwt.num_strings),
            rbwt=FMIndex.from_pack(host_ix.rbwt.blocks, host_ix.rbwt.ckpt,
                                   host_ix.rbwt.C32, host_ix.rbwt.n,
                                   host_ix.rbwt.num_strings),
        )
        host_ix._dev_ix = dix
    return dix


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["f_lo", "f_hi", "r_lo", "r_hi", "freq", "chain0",
                 "tail9", "tail8", "tail_letter", "tail_count"],
    meta_fields=[],
)
@dataclass(frozen=True)
class RootPack:
    """Per-task root-leaf seed values (everything _init_state needs beyond
    WalkConsts): the root bi-interval, its chain ring, and tail codes."""

    f_lo: jax.Array         # i32 [G]
    f_hi: jax.Array
    r_lo: jax.Array
    r_hi: jax.Array
    freq: jax.Array         # i32 [G]
    chain0: jax.Array       # i32 [G, 4, NCHAIN]
    tail9: jax.Array        # i32 [G]
    tail8: jax.Array        # i32 [G]
    tail_letter: jax.Array  # i8  [G]
    tail_count: jax.Array   # i32 [G]


def _prep_core(ix: IndexSet, query, q_len, trg, trg_len, n_term, init_k,
               max_overlap, min_overlap, min_sa, max_indel, max_length,
               min_length, no_term, freqs, pacbio_e,
               cfg: WalkConfig, kb_term: int, kb_root: int, fused=None):
    """All FM-derived batch setup in one device dispatch.

    Computes what the reference's LongReadCorrectByOverlap constructor does
    per gap (terminal intervals for every target suffix
    LongReadCorrectByOverlap.cpp:82-88, the two query-seed code tables
    :90-95,127-152, the root leaf interval and its chain ring) as batched
    backward searches over all G lanes at once.  G is taken from the array
    shapes (the queue engine preps task banks larger than cfg.G).
    """
    G = query.shape[0]
    PAD = ab.PAD_RANK
    q32 = query.astype(I32)

    # --- packed idmer / 5-mer code tables over the query -------------------
    qpad = jnp.pad(q32, ((0, 0), (0, cfg.seed_size)), constant_values=PAD)

    def codes(k):
        c = jnp.zeros((G, cfg.QMAX), I32)
        for j in range(k):
            c = (c << 3) | qpad[:, j : j + cfg.QMAX]
        n = q_len - k + 1
        pos = jnp.arange(cfg.QMAX, dtype=I32)[None, :]
        return jnp.where(pos < n[:, None], c, -1)

    qcode9 = codes(cfg.seed_size)
    qcode5 = codes(5)

    # --- terminal intervals: window m of trg, length min_overlap ------------
    t32 = trg.astype(I32)
    m = jnp.arange(cfg.TMAX, dtype=I32)[None, :]

    def tchar(j):
        # window m starts at arange(TMAX), so char m+j is a static slice
        return jnp.clip(t32[:, j : j + cfg.TMAX], 1, 4)

    if fused is not None:
        # seed every window's chain at length CK straight from the walk's
        # ck-mer interval cache instead of CK levels of batched LF — the
        # terminal table is the prep's gather hot spot ([G, TMAX] lanes)
        tcode = jnp.zeros((G, cfg.TMAX), I32)
        for j in range(cfg.CK):
            tcode = ((tcode << 2) | (tchar(j) - 1)) & ((1 << (2 * cfg.CK)) - 1)
        tw = fused.wcache[tcode]
        st = (tw[..., 0], tw[..., 1], tw[..., 2], tw[..., 3])
        t_from = cfg.CK
    else:
        st = rank.init_bi(ix, tchar(0))
        t_from = 1
    for j in range(t_from, kb_term):
        ns = rank.extend_bi(ix, st, tchar(j))
        live = j < min_overlap[:, None]
        st = tuple(jnp.where(live, n_, o_) for n_, o_ in zip(ns, st))
    valid_m = m < n_term[:, None]
    term_f = jnp.stack([jnp.where(valid_m, st[0], 1),
                        jnp.where(valid_m, st[1], 0)], axis=-1)
    term_r = jnp.stack([jnp.where(valid_m, st[2], 1),
                        jnp.where(valid_m, st[3], 0)], axis=-1)

    # --- root leaf interval: query[:init_k] left-to-right -------------------
    if fused is not None:
        rcode = jnp.zeros(G, I32)
        for j in range(cfg.CK):
            rcode = ((rcode << 2) | (jnp.clip(q32[:, j], 1, 4) - 1)) & (
                (1 << (2 * cfg.CK)) - 1)
        rw = fused.wcache[rcode]
        rst = (rw[..., 0], rw[..., 1], rw[..., 2], rw[..., 3])
        r_from = cfg.CK
    else:
        rst = rank.init_bi(ix, jnp.clip(q32[:, 0], 1, 4))
        r_from = 1
    for j in range(r_from, kb_root):
        ns = rank.extend_bi(ix, rst, jnp.clip(q32[:, j], 1, 4))
        live = j < init_k
        rst = tuple(jnp.where(live, n_, o_) for n_, o_ in zip(ns, rst))
    root_freq = rank.interval_size(rst[0], rst[1]) + rank.interval_size(rst[2], rst[3])

    # --- chain ring of the root leaf: suffixes of length CK..KMAX -----------
    NC = cfg.NCHAIN
    ks = cfg.CK + jnp.arange(NC, dtype=I32)[None, :]        # [1, NC]
    start = init_k[:, None] - ks                            # [G, NC]

    def cchar(i):
        pos = jnp.clip(start + i, 0, cfg.QMAX - 1)
        return jnp.clip(jnp.take_along_axis(q32, pos, axis=1), 1, 4)

    if fused is not None:
        ccode = jnp.zeros((G, NC), I32)
        for i in range(cfg.CK):
            ccode = ((ccode << 2) | (cchar(i) - 1)) & ((1 << (2 * cfg.CK)) - 1)
        cw = fused.wcache[ccode]
        cst = (cw[..., 0], cw[..., 1], cw[..., 2], cw[..., 3])
        c_from = cfg.CK
    else:
        cst = rank.init_bi(ix, cchar(0))
        c_from = 1
    for i in range(c_from, max(kb_root, cfg.CK)):
        ns = rank.extend_bi(ix, cst, cchar(i))
        live = i < ks
        cst = tuple(jnp.where(live, n_, o_) for n_, o_ in zip(ns, cst))
    ok = ks <= init_k[:, None]
    chain0 = jnp.stack([
        jnp.where(ok, cst[0], 0), jnp.where(ok, cst[1], -1),
        jnp.where(ok, cst[2], 0), jnp.where(ok, cst[3], -1),
    ], axis=1)                                              # [G, 4, NC]

    # --- root label tail metadata ------------------------------------------
    i9 = jnp.arange(cfg.seed_size, dtype=I32)
    pos9 = init_k[:, None] - cfg.seed_size + i9[None, :]
    ch9 = jnp.take_along_axis(q32, jnp.clip(pos9, 0, cfg.QMAX - 1), axis=1)
    tail9_0 = jnp.zeros(G, I32)
    for i in range(cfg.seed_size):
        tail9_0 = jnp.where(pos9[:, i] >= 0, (tail9_0 << 3) | ch9[:, i], tail9_0)
    i8 = jnp.arange(cfg.CK, dtype=I32)
    pos8 = init_k[:, None] - cfg.CK + i8[None, :]
    ch8 = jnp.take_along_axis(q32, jnp.clip(pos8, 0, cfg.QMAX - 1), axis=1)
    tail8_0 = jnp.zeros(G, I32)
    for i in range(cfg.CK):
        tail8_0 = jnp.where(
            pos8[:, i] >= 0,
            ((tail8_0 << 2) | (ch8[:, i] - 1)) & ((1 << (2 * cfg.CK)) - 1),
            tail8_0,
        )
    last = jnp.clip(init_k - 1, 0, cfg.QMAX - 1)
    tail_letter_0 = jnp.take_along_axis(query, last[:, None], axis=1)[:, 0]
    back = init_k[:, None] - 1 - jnp.arange(cfg.KMAX, dtype=I32)[None, :]
    chb = jnp.take_along_axis(q32, jnp.clip(back, 0, cfg.QMAX - 1), axis=1)
    eq = (chb == chb[:, :1]) & (back >= 0)
    tail_count_0 = jnp.sum(jnp.cumprod(eq.astype(I32), axis=1), axis=1)

    # --- assemble consts + root pack ----------------------------------------
    consts = WalkConsts(
        query=query, q_len=q_len, trg=trg, trg_len=trg_len, n_term=n_term,
        term_f=term_f, term_r=term_r, qcode9=qcode9, qcode5=qcode5,
        init_k=init_k, max_overlap=max_overlap, min_overlap=min_overlap,
        min_sa=min_sa, max_indel=max_indel, max_length=max_length,
        min_length=min_length, no_term=no_term, freqs=freqs,
        pacbio_e=pacbio_e, err_bound=jnp.float32(0.25),
    )
    root = RootPack(
        f_lo=rst[0], f_hi=rst[1], r_lo=rst[2], r_hi=rst[3], freq=root_freq,
        chain0=chain0, tail9=tail9_0, tail8=tail8_0,
        tail_letter=tail_letter_0, tail_count=tail_count_0,
    )
    return consts, root


def _init_state(consts: WalkConsts, root: RootPack, used, cfg: WalkConfig) -> WalkState:
    """Fresh lane state for each task (leaf slot 0 = the root leaf)."""
    G, L = consts.q_len.shape[0], cfg.L
    ed = cfg.err_dtype
    PAD = ab.PAD_RANK
    query, init_k = consts.query, consts.init_k
    leaf0 = (jnp.arange(L, dtype=I32) == 0)[None, :]        # [1, L]
    u_l = used[:, None] & leaf0                             # [G, L]
    iota_m = jnp.arange(cfg.MAXLEN, dtype=I32)[None, :]
    qm = query[:, : cfg.MAXLEN]
    if cfg.MAXLEN > cfg.QMAX:
        qm = jnp.pad(qm, ((0, 0), (0, cfg.MAXLEN - cfg.QMAX)),
                     constant_values=PAD)
    lab0 = jnp.where(iota_m < init_k[:, None], qm, jnp.int8(PAD))
    labels = jnp.where(u_l[..., None], lab0[:, None, :], jnp.int8(PAD))

    def put(val, fill=0):
        return jnp.where(u_l, val[:, None], jnp.asarray(fill, I32))

    GL = (G, L)
    chain = jnp.where(
        u_l[:, :, None, None], root.chain0[:, None],
        jnp.asarray([0, -1, 0, -1], I32)[None, None, :, None],
    )
    state = WalkState(
        labels=labels,
        f_lo=put(root.f_lo), f_hi=put(root.f_hi, -1),
        r_lo=put(root.r_lo), r_hi=put(root.r_hi, -1),
        alive=u_l,
        kmer_freq=put(root.freq),
        total_kmer=jnp.zeros(GL, I32),  # root node never calls addKmerCount
        last_seed_idx=put(init_k - cfg.seed_size),
        last_overlap_len=put(init_k),
        total_seeds=put(init_k - cfg.seed_size + 1),
        curr_overlap_len=put(init_k),
        num_errors=jnp.zeros(GL, I32),
        seed_idx_offset=jnp.zeros(GL, I32),
        query_overlap_len=put(init_k),
        red_a=jnp.zeros(GL, I32),
        red_b=jnp.zeros(GL, I32),
        res_first=jnp.full(GL, -1, I32),
        res_second=jnp.full(GL, -1, I32),
        tail_letter=jnp.where(u_l, root.tail_letter[:, None], jnp.int8(0)),
        tail_count=put(root.tail_count),
        tail9=put(root.tail9),
        tail8=put(root.tail8),
        chain=chain,
        local_err=jnp.zeros(GL, ed),
        gerr_last=jnp.zeros(GL, ed),
        ring=jnp.zeros((G, L, cfg.RING), ed),
        active=used,
        cur_len=jnp.where(used, init_k, 0),
        cur_k=jnp.where(used, init_k, 0),
        gerr_n=jnp.where(used, 1, 0).astype(I32),
        code=jnp.zeros(G, I32),
        res_labels=jnp.full((G, cfg.RMAX, cfg.MAXLEN), ab.PAD_RANK, jnp.int8),
        res_len=jnp.zeros((G, cfg.RMAX), I32),
        res_err=jnp.zeros((G, cfg.RMAX), ed),
        res_i=jnp.zeros((G, cfg.RMAX), I32),
        res_count=jnp.zeros(G, I32),
        res_overflow=jnp.zeros(G, bool),
    )
    return state


@partial(jax.jit, static_argnames=("cfg", "kb_term", "kb_root"))
def _prep_batch(ix: IndexSet, query, q_len, trg, trg_len, n_term, init_k,
                max_overlap, min_overlap, min_sa, max_indel, max_length,
                min_length, no_term, used, freqs, pacbio_e,
                cfg: WalkConfig, kb_term: int, kb_root: int):
    consts, root = _prep_core(
        ix, query, q_len, trg, trg_len, n_term, init_k, max_overlap,
        min_overlap, min_sa, max_indel, max_length, min_length, no_term,
        freqs, pacbio_e, cfg, kb_term, kb_root)
    return consts, _init_state(consts, root, used, cfg)


@partial(jax.jit, static_argnames=("cfg", "kb_term", "kb_root"))
def _prep_bank(ix: IndexSet, fused, query, q_len, trg, trg_len, n_term,
               init_k, max_overlap, min_overlap, min_sa, max_indel,
               max_length, min_length, no_term, freqs, pacbio_e,
               cfg: WalkConfig, kb_term: int, kb_root: int):
    return _prep_core(
        ix, query, q_len, trg, trg_len, n_term, init_k, max_overlap,
        min_overlap, min_sa, max_indel, max_length, min_length, no_term,
        freqs, pacbio_e, cfg, kb_term, kb_root, fused=fused)


def build_batch(host_ix, tasks: list[GapTask], cfg: WalkConfig,
                pacbio_error_rate: float, pb_coverage: int, dev_ix=None):
    """Build WalkConsts/WalkState for a batch of gap tasks.

    Host work is just string encoding + small scalar derivation; every
    FM-index query (terminal intervals, root interval, chain ring) runs in
    one jitted device prep kernel, and the big state buffers are created
    directly on the device.
    """
    G = cfg.G
    assert len(tasks) <= G

    query = np.full((G, cfg.QMAX), ab.PAD_RANK, np.int8)
    q_len = np.zeros(G, np.int32)
    trg = np.full((G, cfg.TMAX + cfg.KMAX), ab.PAD_RANK, np.int8)
    trg_len = np.zeros(G, np.int32)
    n_term = np.zeros(G, np.int32)
    init_k = np.zeros(G, np.int32)
    max_overlap = np.zeros(G, np.int32)
    min_overlap = np.full(G, 13, np.int32)
    min_sa = np.full(G, 3, np.int32)
    max_indel = np.zeros(G, np.int32)
    max_length = np.zeros(G, np.int32)
    min_length = np.zeros(G, np.int32)
    no_term = np.zeros(G, bool)
    used = np.zeros(G, bool)

    for g, t in enumerate(tasks):
        beginning = t.src[len(t.src) - t.init_k:]
        q = beginning + t.path + t.trg
        q_enc = ab.encode(q)
        assert len(q) <= cfg.QMAX, (len(q), cfg.QMAX)
        assert len(t.trg) - t.min_overlap + 1 <= cfg.TMAX
        query[g, : len(q)] = q_enc
        q_len[g] = len(q)
        trg_enc = ab.encode(t.trg)
        trg[g, : len(trg_enc)] = trg_enc
        trg_len[g] = len(t.trg)
        n_term[g] = max(len(t.trg) - t.min_overlap + 1, 0)
        init_k[g] = t.init_k
        max_overlap[g] = t.max_overlap
        min_overlap[g] = t.min_overlap
        min_sa[g] = t.min_sa_threshold
        assert t.max_overlap + 1 <= cfg.KMAX and t.init_k <= cfg.KMAX
        assert t.min_overlap >= cfg.CK + 1, "chain cache requires minOverlap >= CK+1"
        max_indel[g] = int(t.dis * 0.2) if t.dis > 100 else 20
        v = 1.2 * (t.dis + 10) + 2 * t.init_k
        max_length[g] = int(v)
        v = 0.8 * (t.dis - 20) + 2 * t.init_k
        if v >= 0:
            min_length[g] = int(v)
        else:
            no_term[g] = True  # size_t wrap: termination never fires
        assert max_length[g] + 2 <= cfg.MAXLEN, (max_length[g], cfg.MAXLEN)
        assert cfg.WSCAN >= 2 * max_indel[g] + cfg.seed_size * 2 + 3
        used[g] = True

    freqs = np.zeros(101, np.float32)
    mo = min((t.min_overlap for t in tasks), default=13)
    for i in range(mo, 101):
        freqs[i] = ((1 - pacbio_error_rate) ** i) * pb_coverage

    ix = dev_ix if dev_ix is not None else _dev_index_of(host_ix)
    if isinstance(ix, WalkIndex):
        ix = ix.ix
    kb_term = max(int(min_overlap.max()), 2) if tasks else 2
    kb_root = max(int(init_k.max()), 2) if tasks else 2
    return _prep_batch(
        ix, jnp.asarray(query), jnp.asarray(q_len), jnp.asarray(trg),
        jnp.asarray(trg_len), jnp.asarray(n_term), jnp.asarray(init_k),
        jnp.asarray(max_overlap), jnp.asarray(min_overlap),
        jnp.asarray(min_sa), jnp.asarray(max_indel), jnp.asarray(max_length),
        jnp.asarray(min_length), jnp.asarray(no_term), jnp.asarray(used),
        jnp.asarray(freqs), jnp.float32(pacbio_error_rate),
        cfg=cfg, kb_term=kb_term, kb_root=kb_root,
    )


# ---------------------------------------------------------------------------
# jitted superstep
# ---------------------------------------------------------------------------

def _comp4(sym):
    return jnp.where(sym == 0, 0, 5 - sym)


def _take(arr, idx, axis):
    """jnp.take_along_axis with broadcast index dims.  Every caller's
    indices are in range by construction, so "clip" skips the out-of-bounds
    fill masking."""
    return jnp.take_along_axis(arr, idx, axis=axis, mode="clip")


def _select_freqs_of_range(consts, freq3, lower, upper, alive):
    """SelectFreqsOfrange decision ladder (:281-331): per-gap ReduceSize."""
    reduce_size = upper
    decided = jnp.zeros(upper.shape, bool)
    for i in range(3):
        ln = lower + i
        valid = ln <= upper
        maxf = jnp.max(jnp.where(alive, freq3[i], 0), axis=1)
        expected = consts.freqs[jnp.clip(ln, 0, 100)].astype(I32)
        hit = valid & ((maxf - expected) < 5) & ~decided
        reduce_size = jnp.where(hit, ln, reduce_size)
        decided = decided | hit
    return reduce_size


def _chain_slot(chain, k, ck=CACHE_K):
    """Ring read: walk-convention interval of the label suffix of per-gap
    length k.  chain [G, L, 4, NCHAIN], k [G] -> 4x [G, L].

    Replaces refineSAInterval's LF re-walk (LongReadCorrectByOverlap.cpp
    refineSAInterval / :281-331): slot j was built by the exact same update
    sequence a fresh chain would run, so values are bit-identical."""
    j = jnp.clip(k - ck, 0, chain.shape[-1] - 1)
    sel = _take(chain, j[:, None, None, None], axis=3)[..., 0]
    return sel[..., 0], sel[..., 1], sel[..., 2], sel[..., 3]


def _slab_fetch(fx: FusedFM, cfg: WalkConfig, lo0, hi0, rbwt_side: bool):
    """Fetch the contiguous block slab + ckpt rows covering one side of the
    chain slot-0 (length-CK label suffix) interval, per (gap, leaf) lane.

    Every occ query the superstep issues for a lane lies at a position
    p = idx+1 inside [lo0, hi0+1]: chain slots, the leaf interval, and all
    extension candidates are intervals of suffixes of the same label, and
    non-empty suffix-family intervals nest inside the shortest (slot 0).
    So one slab of SB consecutive blocks answers all of them, instead of
    ~70 independent gathered rows per lane (cf. the per-call run scans of
    RLBWT::getOcc, SuffixTools/RLBWT.h:121-161).

    Returns (rows i8 [..., SB, BLK], ckr i32 [..., SB, 5], base_q [...],
    ok [...]).  ok=False <=> the interval is valid but spans more than SB
    blocks (caller escalates the gap to the dense engine); empty intervals
    return ok=True and are never actually read.
    """
    SB, BLK = cfg.SB, fx.block
    nb_total = fx.blocks.shape[0]
    off = fx.rbwt_row_off if rbwt_side else 0
    nb = (nb_total - fx.rbwt_row_off) if rbwt_side else fx.rbwt_row_off
    valid = lo0 <= hi0
    base_q = lo0 // BLK
    span = (hi0 + 1) // BLK - base_q + 1
    ok = ~valid | (span <= SB)
    base_q = jnp.clip(jnp.where(valid, base_q, 0), 0, max(nb - SB, 0))
    rows_idx = base_q[..., None] + jnp.arange(SB, dtype=I32) + off
    g = fx.frows[rows_idx]              # [..., SB, BLK+20] one fused gather
    rows = g[..., :BLK]
    ckr = jax.lax.bitcast_convert_type(
        g[..., BLK : BLK + 20].reshape(*g.shape[:-1], 5, 4), jnp.int32)
    return rows, ckr, base_q, ok


def _slab_B(rows):
    """One-hot slab rows by (block, base): [..., SB, BLK] i8 ->
    [..., BLK, SB*4] bf16, the shared right-hand operand of every occ
    count against one slab (built once per side per superstep)."""
    syms = jnp.arange(1, 5, dtype=jnp.int8)
    oh = (rows[..., :, :, None] == syms).astype(jnp.bfloat16)  # [.., SB, BLK, 4]
    return jnp.moveaxis(oh, -3, -2).reshape(
        *rows.shape[:-2], rows.shape[-1], -1)


def _slab_cnt(B, r):
    """In-block prefix counts for every (block, base).

    B [..., BLK, SB*4] (from _slab_B), r [..., Q] in-block cutoffs ->
    [..., Q, SB, 4] i32: one batched [Q, BLK] x [BLK, SB*4] dot of a 0/1
    prefix mask against the one-hot rows.  Exact: bf16 holds 0 and 1
    exactly, every product is 0 or 1, and the sums (<= BLK = 128) are exact
    in the float32 accumulator that preferred_element_type pins; the dot
    must never accumulate in bf16 or TF32."""
    BLK = B.shape[-2]
    lane = jnp.arange(BLK, dtype=I32)
    A = (lane < r[..., None]).astype(jnp.bfloat16)           # [..., Q, BLK]
    cnt = jax.lax.dot_general(
        A, B, (((A.ndim - 1,), (B.ndim - 2,)),
               (tuple(range(A.ndim - 2)), tuple(range(B.ndim - 2)))),
        preferred_element_type=jnp.float32,
    )
    return cnt.astype(I32).reshape(*r.shape, -1, 4)


def _slab_occ_all(slab, idx, B=None):
    """occ of all four bases at idx: idx [..., Q] -> counts [..., Q, 4]."""
    rows, ckr, base_q, _ = slab[:4]
    SB, BLK = rows.shape[-2], rows.shape[-1]
    if B is None:
        B = _slab_B(rows)
    p = (idx + 1).astype(I32)
    q = p // BLK - base_q[..., None]
    r = p - (p // BLK) * BLK
    cnt_all = _slab_cnt(B, r)                                # [..., Q, SB, 4]
    inside = ((q >= 0) & (q < SB))[..., None]
    cnt = _take(cnt_all, q[..., None, None], axis=-2)[..., 0, :]
    ckv = _take(ckr[..., 1:5], q[..., None], axis=-2)       # [..., Q, 4]
    return jnp.where(inside, ckv + cnt, 0)


def _probe4(ix: IndexSet, f_lo, f_hi, r_lo, r_hi):
    """4-way ACGT probes (getFMIndexExtensions :686-718) via occ_all.
    Inputs [G, L]; outputs [G, L, 4] (+ freq)."""
    f_valid = (f_lo <= f_hi)[..., None]
    occ_lo = rank.occ_all(ix.rbwt, f_lo - 1)[..., 1:5]
    occ_hi = rank.occ_all(ix.rbwt, f_hi)[..., 1:5]
    Cb = ix.rbwt.C[1:5]
    nf_lo = Cb + occ_lo
    nf_hi = Cb + occ_hi - 1
    pf_lo = jnp.where(f_valid, nf_lo, f_lo[..., None])
    pf_hi = jnp.where(f_valid, nf_hi, f_hi[..., None])
    # rvc ext for base b uses complement rank 5-b -> reversed slice [4,3,2,1]
    r_valid = (r_lo <= r_hi)[..., None]
    rocc_lo = rank.occ_all(ix.bwt, r_lo - 1)[..., 1:5][..., ::-1]
    rocc_hi = rank.occ_all(ix.bwt, r_hi)[..., 1:5][..., ::-1]
    Cr = ix.bwt.C[1:5][::-1]
    nr_lo = Cr + rocc_lo
    nr_hi = Cr + rocc_hi - 1
    pr_lo = jnp.where(r_valid, nr_lo, r_lo[..., None])
    pr_hi = jnp.where(r_valid, nr_hi, r_hi[..., None])
    freq = rank.interval_size(pf_lo, pf_hi) + rank.interval_size(pr_lo, pr_hi)
    return pf_lo, pf_hi, pr_lo, pr_hi, freq


def _match5_any(consts, cfg, codes5, valid, cur_len, max_indel):
    """ismatchedbykmer (:787-821): any query 5-mer equal to the candidate's
    5-suffix within the per-gap position window.

    codes5 [G, X]; window [max(cur_len - indel, 0), cur_len + indel].
    Scans the full query code row with a window mask instead of gathering
    a dynamic window."""
    lo = jnp.maximum(cur_len - max_indel, 0)
    hi = cur_len + max_indel
    Q = consts.qcode5.shape[1]
    pos = jnp.arange(Q, dtype=I32)[None, :]
    in_win = (pos >= lo[:, None]) & (pos <= hi[:, None]) & (consts.qcode5 >= 0)
    hit = (consts.qcode5[:, None, :] == codes5[:, :, None]) & in_win[:, None, :]
    return jnp.any(hit, axis=-1) & valid


def _seed_support_match(consts, cfg, codes9, valid, start_idx, large_idx,
                        curr_seed_idx):
    """isSupportedByNewSeed (:566-635) via 9-suffix code equality.

    codes9/start_idx [G, X]; large_idx/curr_seed_idx [G, X] (broadcast).
    Tie-break on equal |pos - currSeedIdx|: smaller pos (documented
    divergence from interval-tree traversal order).  Full-row scan, same
    rationale as _match5_any."""
    Q = consts.qcode9.shape[1]
    pos = jnp.arange(Q, dtype=I32)[None, None, :]
    eq = consts.qcode9[:, None, :] == codes9[:, :, None]
    in_win = (
        (pos >= start_idx[..., None])
        & (pos <= large_idx[..., None])
        & (consts.qcode9 >= 0)[:, None, :]
    )
    m = eq & in_win & valid[..., None]
    found = jnp.any(m, axis=-1)
    diff = jnp.abs(pos - curr_seed_idx[..., None])
    key = jnp.where(m, diff * 2 * Q + pos, jnp.int32(1 << 30))
    best_pos = jnp.argmin(key, axis=-1).astype(I32)
    return found, best_pos


def _cutoff_mask(cfg, consts, freq4, total_cnt, max_freq, match5, tail_count, thresh):
    """Extension acceptance (getFMIndexExtensions :725-781).

    freq4 [G,X,4], total_cnt/max_freq/tail_count [G,X], match5 [G,X,4],
    thresh [G] (current min_SA_threshold).  Returns pass mask [G,X,4]."""
    ed = cfg.err_dtype
    ratio = freq4.astype(ed) / max_freq[..., None].astype(ed)
    t = thresh[:, None, None]
    is_freq_pass = freq4 >= t
    is_low_cov = total_cnt[..., None] >= t + 2
    is_repeat = (max_freq > 100)[..., None]
    is_highly = (max_freq > 150)[..., None]
    is_lowly = (max_freq > 50)[..., None]
    cut = jnp.full(freq4.shape, 2.0, ed)
    cut = jnp.where(is_low_cov, jnp.asarray(0.6, ed), cut)
    cut = jnp.where(is_freq_pass, jnp.asarray(0.25, ed), cut)
    cut = jnp.where(match5 & is_lowly, jnp.asarray(0.2, ed), cut)
    cut = jnp.where(match5 & is_highly, jnp.asarray(0.125, ed), cut)
    homo = (tail_count >= 3)[..., None]
    cut = jnp.where(homo & is_repeat, jnp.maximum(cut, jnp.asarray(0.3, ed)),
                    jnp.where(homo, jnp.maximum(cut, jnp.asarray(0.6, ed)), cut))
    return ratio >= cut


def _leaf_choice(ext_t, ext_t1, alive, retry_ok):
    """attempToExtend per-leaf retry ladder (:406-455): use the threshold-T
    mask; a leaf with no extension retries at T-1 iff it carries the minimum
    local error rate (retry_ok, exact-compared by the caller) and it is not
    the only leaf."""
    any_t = jnp.any(ext_t, axis=-1)
    use = jnp.where(
        any_t[..., None], ext_t, jnp.where(retry_ok[..., None], ext_t1, False)
    )
    return use & alive[..., None]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["ix", "fused"],
    meta_fields=[],
)
@dataclass(frozen=True)
class WalkIndex:
    """Device index bundle for the walk: plain pair + fused table."""

    ix: IndexSet
    fused: FusedFM

    @staticmethod
    def build(ix: IndexSet, host_ix, ck: int = CACHE_K) -> "WalkIndex":
        return WalkIndex(ix=ix, fused=FusedFM.from_index_set(ix, host_ix, ck=ck))


@partial(jax.jit, static_argnames=("cfg",))
def superstep(wx: WalkIndex, consts: WalkConsts, state: WalkState, cfg: WalkConfig):
    """One while-iteration of extendOverlap (:155-193) over all gap lanes."""
    ix = wx.ix
    fx = wx.fused
    G, L, C = cfg.G, cfg.L, cfg.CAND
    ed = cfg.err_dtype
    s = state

    # ---------- while-condition check on the state left by last step -------
    n_alive = jnp.sum(s.alive, axis=1).astype(I32)
    over = s.res_overflow  # reused as >maxLeaves marker? no — separate below
    cond_ok = (
        (n_alive > 0)
        & (n_alive <= cfg.max_leaves)
        & (s.cur_len <= consts.max_length)
    )
    gap_go = s.active & (s.code == 0)
    newly_done = gap_go & ~cond_ok
    code = s.code
    code = jnp.where(newly_done & (s.res_count > 0), 1, code)
    code = jnp.where(newly_done & (s.res_count == 0) & (n_alive == 0), -1, code)
    code = jnp.where(
        newly_done & (s.res_count == 0) & (n_alive > 0)
        & (s.cur_len > consts.max_length), -2, code)
    code = jnp.where(newly_done & (code == 0), -3, code)
    run = gap_go & cond_ok

    # ---------- slab occ: fetch per-(gap,leaf) block spans ------------------
    # (see _slab_fetch; a lane whose slot-0 span exceeds SB blocks escalates
    # its gap to the dense engine with code -300)
    slabF = slabR = BF = BR = None
    if cfg.SLAB:
        c0 = s.chain[:, :, :, 0]
        slabF = _slab_fetch(fx, cfg, c0[:, :, 0], c0[:, :, 1], rbwt_side=True)
        slabR = _slab_fetch(fx, cfg, c0[:, :, 2], c0[:, :, 3], rbwt_side=False)
        BF = _slab_B(slabF[0])
        BR = _slab_B(slabR[0])
        # a leaf side with a live interval but an empty slot 0 breaks the
        # nesting invariant (label shorter than CK) — escalate those too
        inv_f = (s.f_lo <= s.f_hi) & (c0[:, :, 0] > c0[:, :, 1])
        inv_r = (s.r_lo <= s.r_hi) & (c0[:, :, 2] > c0[:, :, 3])
        lane_bad = s.alive & (~(slabF[3] & slabR[3]) | inv_f | inv_r)
        slab_bad = run & jnp.any(lane_bad, axis=1)
        code = jnp.where(slab_bad, jnp.int32(-300), code)
        run = run & ~slab_bad

    # ---------- unified occ sweep (SLAB) ------------------------------------
    # Every rank the superstep needs — level-0 probes, relaxation probes,
    # post-reduce refinement, and the chain advance — is an occ at a chain
    # SLOT BOUND: the live leaf interval is identically the slot at
    # cur_k - CK (both start as the init_k-suffix interval and extend by
    # the same update), and every refine picks a slot.  So one occ_all per
    # side over all 2*NCHAIN slot bounds feeds the whole step.
    NCH = cfg.NCHAIN
    occF_sweep = occR_sweep = None
    if cfg.SLAB:
        qFL = jnp.concatenate(
            [s.chain[:, :, 0, :] - 1, s.chain[:, :, 1, :]], axis=-1)
        qRL = jnp.concatenate(
            [s.chain[:, :, 2, :] - 1, s.chain[:, :, 3, :]], axis=-1)
        occF_sweep = _slab_occ_all(slabF, qFL, BF)      # [G, L, 2*NCH, 4]
        occR_sweep = _slab_occ_all(slabR, qRL, BR)

    def ext_slot(k):
        """4-way ACGT extensions of chain slot (k - CK), from the sweep.

        k [G] suffix length; returns (pf_lo, pf_hi, pr_lo, pr_hi, freq)
        with probe4's kept-on-invalid semantics per side, [G, L, 4]."""
        j = jnp.clip(k - cfg.CK, 0, NCH - 1)[:, None, None, None]
        oc = lambda sw, off: _take(sw, j + off, axis=2)[:, :, 0]
        slv = _chain_slot(s.chain, k, cfg.CK)
        f_valid = (slv[0] <= slv[1])[..., None]
        r_valid = (slv[2] <= slv[3])[..., None]
        Cb = fx.C_rbwt[1:5]
        pf_lo = jnp.where(f_valid, Cb + oc(occF_sweep, 0), slv[0][..., None])
        pf_hi = jnp.where(f_valid, Cb + oc(occF_sweep, NCH) - 1,
                          slv[1][..., None])
        Cr = fx.C_bwt[1:5][::-1]
        pr_lo = jnp.where(r_valid, Cr + oc(occR_sweep, 0)[..., ::-1],
                          slv[2][..., None])
        pr_hi = jnp.where(r_valid, Cr + oc(occR_sweep, NCH)[..., ::-1] - 1,
                          slv[3][..., None])
        freq = rank.interval_size(pf_lo, pf_hi) + rank.interval_size(pr_lo, pr_hi)
        return pf_lo, pf_hi, pr_lo, pr_hi, freq

    # ---------- extendLeaves: optional kmer-size clamp refine --------------
    need_ref0 = run & (s.cur_k > consts.max_overlap)
    rf = _chain_slot(s.chain, consts.max_overlap, cfg.CK)
    sel0 = need_ref0[:, None] & s.alive
    f_lo = jnp.where(sel0, rf[0], s.f_lo)
    f_hi = jnp.where(sel0, rf[1], s.f_hi)
    r_lo = jnp.where(sel0, rf[2], s.r_lo)
    r_hi = jnp.where(sel0, rf[3], s.r_hi)
    cur_k0 = jnp.where(need_ref0, consts.max_overlap, s.cur_k)

    # ---------- attempToExtend: erase relatively-bad leaves ----------------
    big = jnp.asarray(2.0, ed)
    err_vals = jnp.where(s.alive, s.local_err, big)
    min_err = jnp.min(err_vals, axis=1)
    diff = s.local_err - min_err[:, None]
    erase = s.alive & (
        ((diff > 0.05) & (s.cur_len[:, None] > cfg.RING // 2))
        | ((diff > 0.1) & (s.cur_len[:, None] > 15))
    )
    alive1 = s.alive & ~erase
    leaf_cnt = jnp.sum(alive1, axis=1).astype(I32)

    # per-leaf retry eligibility (attempToExtend :406-455): the reference
    # tests local_err == minimum in double.  Error rates here are canonical
    # f32 expressions of integer history counters (see red_a/red_b), so
    # leaves with identical histories compare equal, matching the host.
    is_min = jnp.where(s.alive, s.local_err, big) == min_err[:, None]
    retry_ok = is_min & (leaf_cnt[:, None] > 1)
    # host-float hazard: when DISTINCT leaves tie at the minimum, the
    # reference's outcome depends on accumulated-double noise and its f64
    # error-rate constant, neither reproducible in f32 — if the tie gates
    # a retry this step, flag the gap for host replay (res_overflow reuses
    # the existing "replay on host" routing).  Strict f32 inequalities are
    # safe: rounding preserves order, so a strict f32 order implies the
    # same exact-rational (and hence f64) order.
    tie_leaf = retry_ok & (jnp.sum(is_min & s.alive, axis=1) > 1)[:, None]

    # ---------- attempt at base threshold (level 0) ------------------------
    # candidate suffix codes (shared by every attempt round — label-derived)
    b4 = jnp.arange(1, 5, dtype=I32)
    cand9 = ((s.tail9[..., None] << 3) | b4) & ((1 << 27) - 1)   # [G, L, 4]
    cand5 = cand9 & ((1 << 15) - 1)

    def attempt(p, thresh):
        pf_lo, pf_hi, pr_lo, pr_hi, freq = p
        total_cnt = jnp.sum(freq, axis=-1)
        max_freq = jnp.max(freq, axis=-1)
        pvalid = (pf_lo <= pf_hi) | (pr_lo <= pr_hi)
        m5 = _match5_any(
            consts, cfg, cand5.reshape(G, L * 4), pvalid.reshape(G, L * 4),
            s.cur_len, consts.max_indel,
        ).reshape(G, L, 4)
        mask_t = _cutoff_mask(cfg, consts, freq, total_cnt, max_freq, m5,
                              s.tail_count, thresh)
        mask_t1 = _cutoff_mask(cfg, consts, freq, total_cnt, max_freq, m5,
                               s.tail_count, thresh - 1)
        ext = _leaf_choice(mask_t, mask_t1, alive1, retry_ok)
        # drift hazard is live only when the tie actually gates this retry
        haz = jnp.any(
            tie_leaf & alive1 & ~jnp.any(mask_t, -1) & jnp.any(mask_t1, -1),
            axis=1,
        )
        return p, ext, (mask_t, mask_t1, m5, total_cnt, max_freq), haz

    if cfg.SLAB:
        p0_in = ext_slot(cur_k0)
    else:
        p0_in = _probe4(ix, f_lo, f_hi, r_lo, r_hi)
    p0, extA, aux0, hazA = attempt(p0_in, consts.min_sa)
    gapA = jnp.any(extA, axis=(1, 2))

    # ---------- level 1 (k reduce) + level 2 (threshold relax) -------------
    # freq3 / refined intervals come straight off the chain ring (frequency
    # of a suffix is search-convention independent), so level12 costs one
    # extra probe4 when any gap needs it
    need_l1 = run & ~gapA

    def level12(_):
        lower = jnp.maximum(cur_k0 - 2, consts.min_overlap)
        freq3 = []
        for i in range(3):
            cf_lo, cf_hi, cr_lo, cr_hi = _chain_slot(s.chain, lower + i, cfg.CK)
            freq3.append(
                rank.interval_size(cf_lo, cf_hi) + rank.interval_size(cr_lo, cr_hi)
            )
        freq3 = jnp.stack(freq3)
        reduce_size = _select_freqs_of_range(consts, freq3, lower, cur_k0, alive1)
        rf1 = _chain_slot(s.chain, reduce_size, cfg.CK)
        if cfg.SLAB:
            p1_in = ext_slot(reduce_size)
        else:
            p1_in = _probe4(ix, rf1[0], rf1[1], rf1[2], rf1[3])
        p1, extB, aux1, hazB = attempt(p1_in, consts.min_sa)
        # level 2: threshold-1 attempt on the refined intervals
        mask_t1, m5 = aux1[1], aux1[2]
        total_cnt, max_freq = aux1[3], aux1[4]
        mask_t2 = _cutoff_mask(cfg, consts, p1[4], total_cnt, max_freq, m5,
                               s.tail_count, consts.min_sa - 2)
        extC = _leaf_choice(mask_t1, mask_t2, alive1, retry_ok)
        hazC = jnp.any(
            tie_leaf & alive1 & ~jnp.any(mask_t1, -1) & jnp.any(mask_t2, -1),
            axis=1,
        )
        return reduce_size, rf1, p1, extB, extC, hazB | hazC

    def no_level12(_):
        z = jnp.zeros((G, L), I32)
        zb = jnp.zeros((G, L, 4), bool)
        zp = (jnp.zeros((G, L, 4), I32),) * 4 + (jnp.zeros((G, L, 4), I32),)
        return cur_k0, (z, z - 1, z, z - 1), zp, zb, zb, jnp.zeros(G, bool)

    if cfg.SLAB:
        # with slab occ the relaxation probes are on-chip math — compute
        # them unconditionally instead of gating on an all-gap reduction
        reduce_size, rf1, p1, extB, extC, hazBC = level12(None)
    else:
        reduce_size, rf1, p1, extB, extC, hazBC = jax.lax.cond(
            jnp.any(need_l1), level12, no_level12, operand=None
        )
    gapB = jnp.any(extB, axis=(1, 2)) & need_l1
    gapC = jnp.any(extC, axis=(1, 2)) & need_l1 & ~gapB

    use_l1 = need_l1 & (gapB | gapC)
    ext = jnp.where(
        gapA[:, None, None], extA,
        jnp.where(gapB[:, None, None], extB,
                  jnp.where(gapC[:, None, None], extC, False)),
    )
    sel_l1 = use_l1[:, None, None]
    c_f_lo = jnp.where(sel_l1, p1[0], p0[0]).reshape(G, C)
    c_f_hi = jnp.where(sel_l1, p1[1], p0[1]).reshape(G, C)
    c_r_lo = jnp.where(sel_l1, p1[2], p0[2]).reshape(G, C)
    c_r_hi = jnp.where(sel_l1, p1[3], p0[3]).reshape(G, C)
    c_freq = jnp.where(sel_l1, p1[4], p0[4]).reshape(G, C)
    cand = ext.reshape(G, C) & run[:, None]
    success = jnp.any(cand, axis=1)
    cur_k_base = jnp.where(use_l1, reduce_size, cur_k0)

    # ---------- materialise candidates -------------------------------------
    parent = jnp.arange(C, dtype=I32) // 4
    echar = (jnp.arange(C, dtype=I32) % 4 + 1).astype(jnp.int8)

    def par(x):
        return x[:, parent]

    c_tail9 = ((s.tail9[:, parent] << 3) | echar[None, :].astype(I32)) & ((1 << 27) - 1)
    c_code9 = cand9.reshape(G, C)

    c_total_kmer = par(s.total_kmer) + c_freq
    c_curr_ovl = par(s.curr_overlap_len) + 1
    c_query_ovl = par(s.query_overlap_len) + 1
    same_tail = par(s.tail_letter) == echar[None, :]
    c_tail_cnt = jnp.where(same_tail, par(s.tail_count) + 1, 1)
    c_tail_letter = jnp.broadcast_to(echar[None, :], (G, C))
    c_last_seed = par(s.last_seed_idx)
    c_last_ovl = par(s.last_overlap_len)
    c_total_seeds = par(s.total_seeds)
    c_num_err = par(s.num_errors)
    c_sio = par(s.seed_idx_offset)
    c_red_a = par(s.red_a)
    c_red_b = par(s.red_b)
    c_res_first = par(s.res_first)
    c_res_second = par(s.res_second)
    c_ring = s.ring[:, parent, :]

    cur_len_new = jnp.where(success, s.cur_len + 1, s.cur_len)
    cur_k_new = jnp.where(success, cur_k_base + 1, cur_k_base)

    # ---------- isInsufficientFreqs -> reduce + refine candidates ----------
    hft = jnp.where(consts.freqs[0] < 0, 3, 3)  # placeholder, overwritten below
    # high-frequency threshold: PBcoverage>60 ? (cov/60)*3 : 3 — carried via
    # consts.min_sa which has the same formula (PacBioSelfCorrection.cpp:175)
    hft = consts.min_sa[:, None]
    high_cnt = jnp.sum(cand & (c_freq > hft), axis=1)
    n_new = jnp.sum(cand, axis=1).astype(I32)
    insuff = (
        (high_cnt == 0)
        | ((high_cnt <= 2) & (n_new >= 5))
        | ((high_cnt <= 1) & (n_new >= 3))
    )
    need_post = run & success & insuff

    def post_reduce(_):
        # candidate suffix of length l ending at cur_len_new == parent ring
        # slot (l-1) extended by the candidate char: one stacked occ gather
        # for the <=3 lengths SelectFreqsOfrange can pick from
        lower = jnp.maximum(cur_k_new - 2, consts.min_overlap)
        sym = jnp.broadcast_to(echar[None, :].astype(I32), (G, C))
        csym = _comp4(sym)
        if cfg.SLAB:
            # the candidate refinements are slot extensions — read them off
            # the unified sweep, then a static (parent, base) select per
            # candidate (the 4 children of a leaf share positions, only the
            # extension base differs)
            baseF = np.arange(C) % 4               # F-side base per candidate
            exts = [ext_slot(lower + i - 1) for i in range(3)]
            take = lambda a: a[:, parent, baseF]   # [G, L, 4] -> [G, C]
            e_f_lo = jnp.stack([take(e[0]) for e in exts])   # [3, G, C]
            e_f_hi = jnp.stack([take(e[1]) for e in exts])
            e_r_lo = jnp.stack([take(e[2]) for e in exts])
            e_r_hi = jnp.stack([take(e[3]) for e in exts])
        else:
            sts_L = []
            for i in range(3):
                j = jnp.clip(lower + i - 1 - cfg.CK, 0, cfg.NCHAIN - 1)
                st = _take(s.chain, j[:, None, None, None], axis=3)[..., 0]
                sts_L.append(st)                   # [G, L, 4]
            stsL = jnp.stack(sts_L)                # [3, G, L, 4]
            sts = stsL[:, :, parent]               # [3, G, C, 4]
            idx4 = jnp.stack([sts[..., 0] - 1, sts[..., 1], sts[..., 2] - 1,
                              sts[..., 3]], axis=1)    # [3, 4, G, C]
            sym4 = jnp.broadcast_to(jnp.stack([sym, sym, csym, csym])[None],
                                    (3, 4, G, C))
            in_rbwt = jnp.asarray([True, True, False, False])[None, :, None, None]
            occ4 = occ_fused(fx, sym4, idx4, in_rbwt)
            e_f_lo = fx.C_rbwt[sym][None] + occ4[:, 0]
            e_f_hi = fx.C_rbwt[sym][None] + occ4[:, 1] - 1
            e_r_lo = fx.C_bwt[csym][None] + occ4[:, 2]
            e_r_hi = fx.C_bwt[csym][None] + occ4[:, 3] - 1
        freq3 = rank.interval_size(e_f_lo, e_f_hi) + rank.interval_size(e_r_lo, e_r_hi)
        rsize = _select_freqs_of_range(consts, freq3, lower, cur_k_new, cand)
        pick = (rsize[:, None] - lower[:, None])[None, ...]  # [1, G, 1]
        which = jnp.arange(3)[:, None, None] == pick
        rf2 = (
            jnp.sum(jnp.where(which, e_f_lo, 0), axis=0),
            jnp.sum(jnp.where(which, e_f_hi, 0), axis=0),
            jnp.sum(jnp.where(which, e_r_lo, 0), axis=0),
            jnp.sum(jnp.where(which, e_r_hi, 0), axis=0),
        )
        return rsize, rf2

    def no_post(_):
        z = jnp.zeros((G, C), I32)
        return cur_k_new, (z, z - 1, z, z - 1)

    if cfg.SLAB:
        rsize2, rf2 = post_reduce(None)
    else:
        rsize2, rf2 = jax.lax.cond(jnp.any(need_post), post_reduce, no_post,
                                   operand=None)
    selp = need_post[:, None]
    c_f_lo = jnp.where(selp, rf2[0], c_f_lo)
    c_f_hi = jnp.where(selp, rf2[1], c_f_hi)
    c_r_lo = jnp.where(selp, rf2[2], c_r_lo)
    c_r_hi = jnp.where(selp, rf2[3], c_r_hi)
    cur_k_new = jnp.where(need_post, rsize2, cur_k_new)

    # ---------- PrunedBySeedSupport ----------------------------------------
    curr_seed_idx = cur_len_new - cfg.seed_size
    indel_off = cfg.seed_size + consts.max_indel
    small_idx = jnp.where(curr_seed_idx <= indel_off, 0, curr_seed_idx - indel_off)
    q_top = consts.q_len - cfg.seed_size
    large_idx = jnp.minimum(curr_seed_idx + indel_off, q_top)

    gap_len = cur_len_new[:, None] - c_last_ovl
    do_match = cand & ((gap_len > cfg.seed_size) | (gap_len <= 1))
    sio_q = jnp.where(
        c_last_ovl < cur_len_new[:, None] - cfg.seed_size,
        cfg.seed_size, cur_len_new[:, None] - c_last_ovl,
    )
    start_idx = jnp.maximum(small_idx[:, None], c_last_seed + sio_q)
    c_valid = (c_f_lo <= c_f_hi) | (c_r_lo <= c_r_hi)
    found, best_pos = _seed_support_match(
        consts, cfg, c_code9, c_valid,
        start_idx, jnp.broadcast_to(large_idx[:, None], (G, C)),
        jnp.broadcast_to(curr_seed_idx[:, None], (G, C)),
    )
    found = found & do_match
    miss = do_match & ~found

    v_found = curr_seed_idx[:, None] + c_sio - c_last_seed
    c_red_b = c_red_b + jnp.where(found & (v_found > cfg.seed_size), 1, 0)
    v_miss = curr_seed_idx[:, None] + c_sio - c_last_seed
    c_num_err = c_num_err + jnp.where(miss & (v_miss % cfg.seed_size == 1), 1, 0)
    c_red_a = c_red_a + jnp.where(
        miss & (v_miss % cfg.seed_size != 1) & (v_miss > cfg.seed_size - 1), 1, 0
    )
    c_red_a = c_red_a + jnp.where(cand & ~do_match, 1, 0)
    c_sio = jnp.where(found, best_pos - curr_seed_idx[:, None], c_sio)
    c_last_seed = jnp.where(found, best_pos, c_last_seed)
    c_query_ovl = jnp.where(found, best_pos + cfg.seed_size, c_query_ovl)
    c_last_ovl = jnp.where(found, cur_len_new[:, None], c_last_ovl)
    c_curr_ovl = jnp.where(found, cur_len_new[:, None], c_curr_ovl)
    c_total_seeds = c_total_seeds + found.astype(I32)

    # computeErrorRate (:638-664) — one canonical expression from integer
    # counters (total - matched == U + V*e), so leaves with identical
    # histories produce bitwise-identical f32 error rates and the exact
    # (U, V, P) triple feeds the retry-equality test
    c_U = c_curr_ovl - c_total_seeds - (cfg.seed_size - 1) - c_red_a
    c_V = c_red_a - (cfg.seed_size - 1) * c_red_b
    total = c_curr_ovl.astype(ed)
    gerr = (c_U.astype(ed) + c_V.astype(ed) * consts.pacbio_e.astype(ed)) / total
    n_app = s.gerr_n + 1
    slot_w = (n_app - 1) % cfg.RING
    slot_r = n_app % cfg.RING
    old = _take(
        c_ring, jnp.broadcast_to(slot_r[:, None, None], (G, C, 1)), axis=2
    )[..., 0]
    local = jnp.where(
        n_app[:, None] >= cfg.RING,
        (gerr * total - old * (total - cfg.RING)) / cfg.RING,
        gerr,
    )
    wpos = jax.lax.broadcasted_iota(I32, (G, C, cfg.RING), 2) == slot_w[:, None, None]
    c_ring = jnp.where(wpos & cand[..., None], gerr[..., None], c_ring)
    surv = cand & ~(local > consts.err_bound.astype(ed))

    # ---------- isTerminated (:824-877) ------------------------------------
    may_term = run & success & ~consts.no_term & (cur_len_new >= consts.min_length)
    ti = jnp.arange(cfg.TMAX, dtype=I32)
    startt = jnp.maximum(c_res_second, 0)
    fv = (c_f_lo <= c_f_hi)[..., None]
    rv = (c_r_lo <= c_r_hi)[..., None]
    cont_f = fv & (c_f_lo[..., None] >= consts.term_f[:, None, :, 0]) & (
        c_f_hi[..., None] <= consts.term_f[:, None, :, 1])
    cont_r = rv & (c_r_lo[..., None] >= consts.term_r[:, None, :, 0]) & (
        c_r_hi[..., None] <= consts.term_r[:, None, :, 1])
    tmask = (
        (cont_f | cont_r)
        & (ti[None, None, :] >= startt[..., None])
        & (ti[None, None, :] < consts.n_term[:, None, None])
        & surv[..., None] & may_term[:, None, None]
    )
    t_found = jnp.any(tmask, axis=-1)
    imax = jnp.max(jnp.where(tmask, ti[None, None, :], -1), axis=-1)

    is_new_res = t_found & (c_res_first == -1)
    new_rank = jnp.cumsum(is_new_res.astype(I32), axis=1)
    slot = jnp.where(
        is_new_res, s.res_count[:, None] + new_rank - 1,
        jnp.where(t_found, c_res_first - 1, -1),
    )
    fp_hazard = run & (hazA | (hazBC & need_l1))
    res_overflow = (s.res_overflow | jnp.any(slot >= cfg.RMAX, axis=1)
                    | fp_hazard)
    writer = t_found & (slot >= 0) & (slot < cfg.RMAX)
    c_res_first = jnp.where(is_new_res, slot + 1, c_res_first)
    c_res_second = jnp.where(t_found, imax, c_res_second)
    res_count = s.res_count + jnp.sum(is_new_res, axis=1).astype(I32)

    # last-writer-wins gather into result slots
    ci = jnp.arange(C, dtype=I32)
    src = jnp.max(
        jnp.where(
            writer[:, :, None] & (slot[:, :, None] == jnp.arange(cfg.RMAX)[None, None, :]),
            ci[None, :, None], -1,
        ),
        axis=1,
    )  # [G, RMAX]
    has_src = src >= 0
    srcc = jnp.clip(src, 0, C - 1)
    g_take = lambda arr: _take(arr, srcc, axis=1)
    # rebuild writer labels: parent label + extension char at cur_len-1
    src_parent = parent[srcc]
    src_char = (srcc % 4 + 1).astype(jnp.int8)
    src_lab = _take(s.labels, src_parent[..., None], axis=1)
    wpos_l = jax.lax.broadcasted_iota(I32, src_lab.shape, 2) == (
        cur_len_new[:, None, None] - 1
    )
    src_lab = jnp.where(wpos_l, src_char[..., None], src_lab)
    res_labels = jnp.where(has_src[..., None], src_lab, s.res_labels)
    res_len = jnp.where(has_src, jnp.broadcast_to(cur_len_new[:, None], src.shape), s.res_len)
    res_err = jnp.where(has_src, g_take(gerr), s.res_err)
    res_i = jnp.where(has_src, g_take(imax), s.res_i)

    # ---------- compact survivors into leaf slots --------------------------
    rank_s = jnp.cumsum(surv.astype(I32), axis=1) - 1
    n_surv = jnp.sum(surv, axis=1).astype(I32)
    li = jnp.arange(L, dtype=I32)
    lsrc = jnp.max(
        jnp.where(
            (surv & (rank_s < L))[:, :, None] & (rank_s[:, :, None] == li[None, None, :]),
            ci[None, :, None], -1,
        ),
        axis=1,
    )  # [G, L]
    has_leaf = lsrc >= 0
    lsrcc = jnp.clip(lsrc, 0, C - 1)
    l_take = lambda arr: _take(arr, lsrcc, axis=1)

    def upd(old_arr, cand_arr):
        new = jnp.where(has_leaf, l_take(cand_arr), old_arr)
        return jnp.where(run[:, None], new, old_arr)

    new_alive = jnp.where(run[:, None], has_leaf, s.alive)
    leaf_parent = parent[lsrcc]
    leaf_char = (lsrcc % 4 + 1).astype(jnp.int8)
    leaf_lab = _take(s.labels, leaf_parent[..., None], axis=1)
    wpos_f = jax.lax.broadcasted_iota(I32, leaf_lab.shape, 2) == (
        cur_len_new[:, None, None] - 1
    )
    leaf_lab = jnp.where(wpos_f & cand.any(axis=1)[:, None, None], leaf_char[..., None], leaf_lab)
    new_labels = jnp.where(
        run[:, None, None] & has_leaf[..., None], leaf_lab, s.labels
    )
    new_ring = jnp.where(
        run[:, None, None] & has_leaf[..., None],
        _take(c_ring, lsrcc[..., None], axis=1),
        s.ring,
    )

    # ---------- advance the chain ring (one wide stacked gather) -----------
    # new slot j>=1 = parent slot j-1 extended by the leaf's appended char;
    # slot 0 reseeds from the CK interval cache via the new tail code
    NC = cfg.NCHAIN
    par_chain = _take(
        s.chain, leaf_parent[:, :, None, None], axis=1
    )                                               # [G, L, 4, NC]
    prev = par_chain[..., : NC - 1]                 # slots 0..NC-2
    lch = leaf_char.astype(I32)                     # [G, L]
    lsym = jnp.broadcast_to(lch[..., None], (G, L, NC - 1))
    lcsym = _comp4(lsym)
    if cfg.SLAB:
        # the advance ranks are slot-bound occ values already computed by
        # the unified sweep; select (parent lane, extension char) per new
        # leaf (positions are the parent's own slot bounds, so the parent
        # lane of the L-space sweep is the identical rank value)
        occF_all = jnp.concatenate(
            [occF_sweep[:, :, : NC - 1], occF_sweep[:, :, NCH : NCH + NC - 1]],
            axis=2)                                 # [G, L, 2(NC-1), 4]
        occR_all = jnp.concatenate(
            [occR_sweep[:, :, : NC - 1], occR_sweep[:, :, NCH : NCH + NC - 1]],
            axis=2)
        occFp = _take(occF_all, leaf_parent[:, :, None, None], axis=1)
        occRp = _take(occR_all, leaf_parent[:, :, None, None], axis=1)
        occF = _take(occFp, (lch - 1)[:, :, None, None], axis=3)[..., 0]
        occR = _take(occRp, (4 - lch)[:, :, None, None], axis=3)[..., 0]
        f_empty = prev[:, :, 0] > prev[:, :, 1]
        r_empty = prev[:, :, 2] > prev[:, :, 3]
        nsl = NC - 1
        adv = jnp.stack([
            jnp.where(f_empty, 0, fx.C_rbwt[lsym] + occF[..., :nsl]),
            jnp.where(f_empty, -1, fx.C_rbwt[lsym] + occF[..., nsl:] - 1),
            jnp.where(r_empty, 0, fx.C_bwt[lcsym] + occR[..., :nsl]),
            jnp.where(r_empty, -1, fx.C_bwt[lcsym] + occR[..., nsl:] - 1),
        ], axis=2)                                  # [G, L, 4, NC-1]
    else:
        cidx4 = jnp.stack([
            prev[:, :, 0] - 1, prev[:, :, 1], prev[:, :, 2] - 1, prev[:, :, 3]
        ])                                          # [4, G, L, NC-1]
        csym4 = jnp.stack([lsym, lsym, lcsym, lcsym])
        c_in_rbwt = jnp.asarray([True, True, False, False])[:, None, None, None]
        cocc4 = occ_fused(fx, csym4, cidx4, c_in_rbwt)
        adv = jnp.stack([
            fx.C_rbwt[lsym] + cocc4[0],
            fx.C_rbwt[lsym] + cocc4[1] - 1,
            fx.C_bwt[lcsym] + cocc4[2],
            fx.C_bwt[lcsym] + cocc4[3] - 1,
        ], axis=2)                                  # [G, L, 4, NC-1]
    c_tail8 = (
        (s.tail8[:, parent] << 2) | (echar[None, :].astype(I32) - 1)
    ) & ((1 << (2 * cfg.CK)) - 1)                   # [G, C]
    new_tail8 = upd(s.tail8, c_tail8)
    slot0 = fx.wcache[new_tail8]                    # [G, L, 4]
    new_chain = jnp.concatenate([slot0[..., None], adv], axis=3)
    chain_sel = (run & success)[:, None, None, None] & has_leaf[:, :, None, None]
    new_chain = jnp.where(chain_sel, new_chain, s.chain)

    leaves_over = jnp.where(run, n_surv > cfg.max_leaves, False)
    # >maxLeaves: the reference's while-condition exit (-3, or 1 if results
    # were recorded); the check would fire next iteration with unchanged state
    code = jnp.where(
        run & leaves_over,
        jnp.where(res_count > 0, 1, -3),
        code,
    )
    # storage overflow below maxLeaves: semantics need more slots than this
    # lane config carries — flag for a re-run in the wide config
    code = jnp.where(
        run & ~leaves_over & (n_surv > cfg.L), jnp.int32(-200), code
    )

    return WalkState(
        labels=new_labels,
        f_lo=upd(s.f_lo, c_f_lo), f_hi=upd(s.f_hi, c_f_hi),
        r_lo=upd(s.r_lo, c_r_lo), r_hi=upd(s.r_hi, c_r_hi),
        alive=new_alive,
        kmer_freq=upd(s.kmer_freq, c_freq),
        total_kmer=upd(s.total_kmer, c_total_kmer),
        last_seed_idx=upd(s.last_seed_idx, c_last_seed),
        last_overlap_len=upd(s.last_overlap_len, c_last_ovl),
        total_seeds=upd(s.total_seeds, c_total_seeds),
        curr_overlap_len=upd(s.curr_overlap_len, c_curr_ovl),
        num_errors=upd(s.num_errors, c_num_err),
        seed_idx_offset=upd(s.seed_idx_offset, c_sio),
        query_overlap_len=upd(s.query_overlap_len, c_query_ovl),
        red_a=upd(s.red_a, c_red_a),
        red_b=upd(s.red_b, c_red_b),
        res_first=upd(s.res_first, c_res_first),
        res_second=upd(s.res_second, c_res_second),
        tail_letter=upd(s.tail_letter, c_tail_letter),
        tail_count=upd(s.tail_count, c_tail_cnt),
        tail9=upd(s.tail9, c_tail9),
        tail8=new_tail8,
        chain=new_chain,
        local_err=upd(s.local_err, local),
        gerr_last=upd(s.gerr_last, gerr),
        ring=new_ring,
        active=s.active,
        cur_len=jnp.where(run, cur_len_new, s.cur_len),
        cur_k=jnp.where(run, cur_k_new, s.cur_k),
        gerr_n=jnp.where(run & success, n_app, s.gerr_n),
        code=code,
        res_labels=jnp.where(run[:, None, None], res_labels, s.res_labels),
        res_len=jnp.where(run[:, None], res_len, s.res_len),
        res_err=jnp.where(run[:, None], res_err, s.res_err),
        res_i=jnp.where(run[:, None], res_i, s.res_i),
        res_count=jnp.where(run, res_count, s.res_count),
        res_overflow=jnp.where(run, res_overflow, s.res_overflow),
    )


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def _reduce_results(state: WalkState, cfg: WalkConfig):
    """findTheBestPath's argmin (:214-236) on device: ship ONE label per gap.

    The reduction keeps the readback at [G, MAXLEN] + scalars instead of
    the full [G, RMAX, MAXLEN] result buffers.  argmin picks the first slot with
    the minimum error, matching the host loop's strict-less update; slots
    with err >= 1.0 never win (has=False -> -4, as when the loop keeps
    best=None)."""
    n = jnp.minimum(state.res_count, cfg.RMAX)
    slot_ok = jnp.arange(cfg.RMAX, dtype=I32)[None, :] < n[:, None]
    err = jnp.where(slot_ok & (state.res_err < 1.0), state.res_err, jnp.inf)
    best = jnp.argmin(err, axis=1)
    has = jnp.take_along_axis(err, best[:, None], axis=1)[:, 0] < 1.0
    blab = jnp.take_along_axis(
        state.res_labels, best[:, None, None], axis=1)[:, 0]
    blen = jnp.take_along_axis(state.res_len, best[:, None], axis=1)[:, 0]
    bi = jnp.take_along_axis(state.res_i, best[:, None], axis=1)[:, 0]
    return state.code, state.res_overflow, has, blab, blen, bi


def finalize_gap(tasks, red_np, g, cfg) -> tuple[int, str]:
    """Thread assembly for a finished gap lane (from _reduce_results)."""
    code = int(red_np["code"][g])
    if code != 1:
        return code, ""
    if not red_np["has"][g]:
        return -4, ""
    t = tasks[g]
    ln = int(red_np["len"][g])
    row = red_np.get("lab_row")
    thread = row(g, ln) if row is not None else ab.decode(red_np["lab"][g][:ln])
    i = int(red_np["i"][g])
    if len(t.trg) > t.min_overlap:
        thread += t.trg[i + t.min_overlap:]
    return 1, thread


@partial(jax.jit, static_argnames=("cfg", "n"))
def multistep(wx: WalkIndex, consts: WalkConsts, state: WalkState, cfg: WalkConfig, n: int):
    """n supersteps in one dispatch (keeps the host out of the loop)."""
    return jax.lax.fori_loop(
        0, n, lambda _, st: superstep(wx, consts, st, cfg), state
    )


@partial(jax.jit, static_argnames=("cfg", "max_steps"))
def run_to_completion(wx: WalkIndex, consts: WalkConsts, state: WalkState,
                      cfg: WalkConfig, max_steps: int):
    """Walk every gap lane to completion in ONE device dispatch.

    A single lax.while_loop replaces host-polled chunks of supersteps, so
    the host pays one dispatch and one readback per batch."""

    def cond(carry):
        step, st = carry
        return (step < max_steps) & jnp.any(st.active & (st.code == 0))

    def body(carry):
        step, st = carry
        return step + 1, superstep(wx, consts, st, cfg)

    _, st = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
    return st


def _quant_g(n: int, g_max: int) -> int:
    """Quantize a lane count to {16, 64, 256, g_max}: every distinct G is a
    separate while-loop compile.  256 covers the miss-round retry waves
    (~125-260 gaps each)."""
    for g in (16, 64, 256):
        if n <= g and g <= g_max:
            return g
    return g_max


def submit_gap_batch(host_ix, dev_ix, tasks, cfg: WalkConfig,
                     pacbio_error_rate: float, pb_coverage: int,
                     max_steps: int = 4096):
    """Enqueue one gap batch on the device without blocking.

    Device dispatch is asynchronous, so a caller can submit every batch of
    a round first and only then start collecting — later batches compute
    while earlier ones are read back."""
    wx = dev_ix if isinstance(dev_ix, WalkIndex) else WalkIndex.build(dev_ix, host_ix)
    consts, state = build_batch(host_ix, tasks, cfg, pacbio_error_rate,
                                pb_coverage, dev_ix=wx.ix)
    state = run_to_completion(wx, consts, state, cfg, max_steps)
    return tasks, cfg, _reduce_results(state, cfg)


def run_gap_batch(host_ix, dev_ix, tasks, cfg: WalkConfig,
                  pacbio_error_rate: float, pb_coverage: int,
                  max_steps: int = 4096, check_every: int = 32,
                  _handle=None):
    """Run a batch of GapTasks on the device engine to completion.

    Returns list of (code, merged_seq) aligned with tasks.  Gaps whose result
    buffer overflowed are replayed on the host engine by the caller (flag code
    -100)."""
    import os as _os, sys as _sys, time as _time
    _dbg = _os.environ.get("LRSC_DEBUG_TIMING")
    _t0 = _time.time()
    if _handle is None:
        _handle = submit_gap_batch(host_ix, dev_ix, tasks, cfg,
                                   pacbio_error_rate, pb_coverage, max_steps)
    tasks, cfg, (code_d, over_d, has_d, lab_d, len_d, i_d) = _handle
    red_np = {
        "code": np.asarray(code_d),
        "res_overflow": np.asarray(over_d),
        "has": np.asarray(has_d),
        "lab": np.asarray(lab_d),
        "len": np.asarray(len_d),
        "i": np.asarray(i_d),
    }
    if _dbg:
        print(f"[timing]   gap_batch n={len(tasks)} G={cfg.G}:"
              f" device+collect {_time.time()-_t0:.2f}s",
              file=_sys.stderr, flush=True)
    out = []
    retry = []
    retry_dense = []
    for g, t in enumerate(tasks):
        if red_np["res_overflow"][g]:
            out.append((-100, ""))  # host replay requested
            continue
        c = int(red_np["code"][g])
        if c == 0:
            out.append((-100, ""))  # did not converge in max_steps
            continue
        if c == -200:
            out.append(None)
            retry.append(g)
            continue
        if c == -300:
            out.append(None)
            retry_dense.append(g)
            continue
        out.append(finalize_gap(tasks, red_np, g, cfg))
    return _retry_flagged(host_ix, dev_ix, tasks, out, retry, retry_dense,
                          cfg, pacbio_error_rate, pb_coverage, max_steps)


# ---------------------------------------------------------------------------
# queue-refill engine: one dispatch walks an arbitrary task list
# ---------------------------------------------------------------------------
#
# The batch engine above runs G lanes to the completion of the SLOWEST lane
# and pays one dispatch+readback round trip per G tasks.  The queue engine keeps a bank of T task descriptors
# in HBM and refills each lane ON DEVICE the moment its gap finishes: a
# whole correction round is ONE while_loop dispatch with no straggler waste
# (the tail of the very last tasks aside).  Superstep semantics are shared,
# so results are identical to the batch engine.

_PER_GAP_CONST_FIELDS = (
    "query", "q_len", "trg", "trg_len", "n_term", "term_f", "term_r",
    "qcode9", "qcode5", "init_k", "max_overlap", "min_overlap", "min_sa",
    "max_indel", "max_length", "min_length", "no_term",
)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["consts", "root"],
    meta_fields=[],
)
@dataclass(frozen=True)
class QueueBank:
    """Per-task constants + root seeds for T tasks, resident in HBM."""

    consts: WalkConsts   # leading dim T on per-gap fields
    root: RootPack       # leading dim T


def _gather_consts(c: WalkConsts, idx) -> WalkConsts:
    from dataclasses import replace as _rep

    return _rep(c, **{f: getattr(c, f)[idx] for f in _PER_GAP_CONST_FIELDS})


def _gather_root(r: RootPack, idx) -> RootPack:
    from dataclasses import replace as _rep

    fields = ("f_lo", "f_hi", "r_lo", "r_hi", "freq", "chain0", "tail9",
              "tail8", "tail_letter", "tail_count")
    return _rep(r, **{f: getattr(r, f)[idx] for f in fields})


def _select_state(mask, a: WalkState, b: WalkState) -> WalkState:
    """Per-lane select: mask [G] -> a where True else b, any field rank."""

    def sel(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.ndim - 1))
        return jnp.where(m, x, y)

    return jax.tree_util.tree_map(sel, a, b)


@partial(jax.jit, static_argnames=("cfg", "max_steps", "max_total"))
def queue_run(wx: WalkIndex, bank: QueueBank, n, cfg: WalkConfig,
              max_steps: int, max_total: int):
    """Walk n tasks of the bank to completion in ONE device dispatch.

    Lanes: cfg.G.  Each lane holds one task; when the task finishes, its
    best-path reduction is scattered into the per-task output buffers and
    the lane re-seeds from the next queue entry.  A lane stuck past
    max_steps on one task is flagged (code -900 -> host replay); max_total
    bounds the whole loop (unassigned/unfinished tasks keep code 0, which
    the collector also routes to host replay).
    """
    T = bank.consts.q_len.shape[0]
    G = cfg.G
    task0 = jnp.arange(G, dtype=I32)
    used0 = task0 < n
    g0 = jnp.clip(task0, 0, T - 1)
    st0 = _init_state(_gather_consts(bank.consts, g0),
                      _gather_root(bank.root, g0), used0, cfg)
    outs0 = (
        jnp.zeros(T + 1, I32),                                  # code
        jnp.zeros(T + 1, bool),                                 # overflow
        jnp.zeros(T + 1, bool),                                 # has result
        jnp.full((T + 1, cfg.MAXLEN), ab.PAD_RANK, jnp.int8),   # best label
        jnp.zeros(T + 1, I32),                                  # label len
        jnp.zeros(T + 1, I32),                                  # res_i
    )
    carry = (jnp.int32(0), jnp.int32(G), task0, jnp.zeros(G, I32), st0, outs0)

    def cond(c):
        gstep, _, _, _, st, _ = c
        return (gstep < max_total) & jnp.any(st.active & (st.code == 0))

    def body(c):
        gstep, head, task_id, steps, st, outs = c
        o_code, o_over, o_has, o_lab, o_len, o_i = outs
        cg = _gather_consts(bank.consts, jnp.clip(task_id, 0, T - 1))
        st = superstep(wx, cg, st, cfg)
        steps = steps + 1
        timeout = st.active & (st.code == 0) & (steps >= max_steps)
        from dataclasses import replace as _rep
        st = _rep(st, code=jnp.where(timeout, jnp.int32(-900), st.code))
        done = st.active & (st.code != 0)
        code_r, over_r, has_r, lab_r, len_r, i_r = _reduce_results(st, cfg)
        widx = jnp.where(done, task_id, T)
        o_code = o_code.at[widx].set(code_r)
        o_over = o_over.at[widx].set(over_r)
        o_has = o_has.at[widx].set(has_r)
        o_lab = o_lab.at[widx].set(lab_r)
        o_len = o_len.at[widx].set(len_r)
        o_i = o_i.at[widx].set(i_r)
        # refill finished lanes from the queue head
        new_t = head + jnp.cumsum(done.astype(I32)) - 1
        has_new = done & (new_t < n)
        nid = jnp.where(done, jnp.where(has_new, new_t, T), task_id)
        gidx = jnp.clip(nid, 0, T - 1)
        fresh = _init_state(_gather_consts(bank.consts, gidx),
                            _gather_root(bank.root, gidx), has_new, cfg)
        st = _select_state(done, fresh, st)
        steps = jnp.where(done, 0, steps)
        head = head + jnp.sum(done, dtype=I32)
        return (gstep + 1, head, nid, steps, st,
                (o_code, o_over, o_has, o_lab, o_len, o_i))

    gstep, _, _, _, _, outs = jax.lax.while_loop(cond, body, carry)
    o_code, o_over, o_has, o_lab, o_len, o_i = (o[:T] for o in outs)
    # 2-bit pack the label buffer for the readback (a quarter of the
    # bytes): ranks are 1..4 within each row's length, and the tail is
    # padding the decoder never reads
    l4 = (o_lab.reshape(T, cfg.MAXLEN // 4, 4).astype(I32) - 1) & 3
    sh = jnp.arange(4, dtype=I32) * 2
    lab2 = jnp.sum(l4 << sh, axis=-1).astype(jnp.uint8)
    return gstep, o_code, o_over, o_has, lab2, o_len, o_i


def build_bank(host_ix, tasks: list[GapTask], cfg: WalkConfig,
               pacbio_error_rate: float, pb_coverage: int, dev_ix=None,
               T: int | None = None) -> QueueBank:
    """Host-side bank construction (same numpy prep as build_batch, sized T)."""
    T = T or len(tasks)
    assert len(tasks) <= T

    n = len(tasks)
    # one encode for the whole batch (per-call encode overhead dominated the
    # host prep at thousands of tasks), then scatter rows by offset
    qs = [t.src[len(t.src) - t.init_k:] + t.path + t.trg for t in tasks]
    q_len_l = np.fromiter((len(q) for q in qs), np.int32, n)
    trg_len_l = np.fromiter((len(t.trg) for t in tasks), np.int32, n)
    assert q_len_l.size == 0 or int(q_len_l.max()) <= cfg.QMAX
    flat_q = ab.encode("".join(qs))
    flat_t = ab.encode("".join(t.trg for t in tasks))

    def rows(flat, lens, width):
        # per-row slice assigns: ~2us each, vs the [T, width] fancy-index
        # gather whose int64 index temporaries dominated submit time
        out = np.full((T, width), ab.PAD_RANK, np.int8)
        off = 0
        for i in range(n):
            ln = int(lens[i])
            out[i, :ln] = flat[off : off + ln]
            off += ln
        return out

    query = rows(flat_q, q_len_l, cfg.QMAX)
    trg = rows(flat_t, trg_len_l, cfg.TMAX + cfg.KMAX)
    q_len = np.zeros(T, np.int32); q_len[:n] = q_len_l
    trg_len = np.zeros(T, np.int32); trg_len[:n] = trg_len_l

    dis = np.fromiter((t.dis for t in tasks), np.int64, n)
    init_k_l = np.fromiter((t.init_k for t in tasks), np.int32, n)
    min_ov_l = np.fromiter((t.min_overlap for t in tasks), np.int32, n)
    max_ov_l = np.fromiter((t.max_overlap for t in tasks), np.int32, n)
    min_sa_l = np.fromiter((t.min_sa_threshold for t in tasks), np.int32, n)

    init_k = np.zeros(T, np.int32); init_k[:n] = init_k_l
    max_overlap = np.zeros(T, np.int32); max_overlap[:n] = max_ov_l
    min_overlap = np.full(T, 13, np.int32); min_overlap[:n] = min_ov_l
    min_sa = np.full(T, 3, np.int32); min_sa[:n] = min_sa_l
    n_term = np.zeros(T, np.int32)
    n_term[:n] = np.maximum(trg_len_l - min_ov_l + 1, 0)
    max_indel = np.zeros(T, np.int32)
    max_indel[:n] = np.where(dis > 100, (dis * 0.2).astype(np.int64), 20)
    max_length = np.zeros(T, np.int32)
    max_length[:n] = (1.2 * (dis + 10) + 2 * init_k_l).astype(np.int64)
    min_len_v = 0.8 * (dis - 20) + 2 * init_k_l
    min_length = np.zeros(T, np.int32)
    min_length[:n] = np.where(min_len_v >= 0, min_len_v, 0).astype(np.int64)
    no_term = np.zeros(T, bool)
    no_term[:n] = min_len_v < 0  # size_t wrap: termination never fires

    if n:
        assert int((trg_len_l - min_ov_l + 1).max()) <= cfg.TMAX
        assert int(max_ov_l.max()) + 1 <= cfg.KMAX and int(init_k_l.max()) <= cfg.KMAX
        assert int(min_ov_l.min()) >= cfg.CK + 1, "chain cache requires minOverlap >= CK+1"
        assert int(max_length[:n].max()) + 2 <= cfg.MAXLEN
        assert cfg.WSCAN >= 2 * int(max_indel[:n].max()) + cfg.seed_size * 2 + 3

    freqs = np.zeros(101, np.float32)
    mo = min((t.min_overlap for t in tasks), default=13)
    for i in range(mo, 101):
        freqs[i] = ((1 - pacbio_error_rate) ** i) * pb_coverage

    ix = dev_ix if dev_ix is not None else _dev_index_of(host_ix)
    fused = None
    if isinstance(ix, WalkIndex):
        fused = ix.fused
        ix = ix.ix
    if fused is not None and tasks:
        # wcache seeding in the prep needs every chain to reach length CK
        ok = all(t.init_k >= cfg.CK and t.min_overlap >= cfg.CK
                 for t in tasks)
        if not ok:
            fused = None
    kb_term = max(int(min_overlap[: len(tasks)].max()), 2) if tasks else 2
    kb_root = max(int(init_k[: len(tasks)].max()), 2) if tasks else 2
    # 2-bit pack the big symbol matrices for the host->device copy (a
    # quarter of the [T, QMAX] int8 bytes); _prep_bank_packed unpacks
    # on-device, PAD restored from the lengths
    consts, root = _prep_bank_packed(
        ix, fused, jnp.asarray(_pack2(query)), jnp.asarray(q_len),
        jnp.asarray(_pack2(trg)),
        jnp.asarray(trg_len), jnp.asarray(n_term), jnp.asarray(init_k),
        jnp.asarray(max_overlap), jnp.asarray(min_overlap),
        jnp.asarray(min_sa), jnp.asarray(max_indel), jnp.asarray(max_length),
        jnp.asarray(min_length), jnp.asarray(no_term),
        jnp.asarray(freqs), jnp.float32(pacbio_error_rate),
        cfg=cfg, kb_term=kb_term, kb_root=kb_root,
        qw=query.shape[1], tw=trg.shape[1],
    )
    return QueueBank(consts=consts, root=root)


def _pack2(mat: np.ndarray) -> np.ndarray:
    """np int8 rank rows [N, W] -> uint8 [N, ceil(W/4)] (2 bits/symbol;
    PAD positions carry garbage and are restored from lengths on-device)."""
    n, w = mat.shape
    wp = (w + 3) & ~3
    m = np.zeros((n, wp), np.uint8)
    m[:, :w] = np.clip(mat.astype(np.int16) - 1, 0, 3).astype(np.uint8)
    m4 = m.reshape(n, wp // 4, 4)
    sh = np.arange(4, dtype=np.uint8) * 2
    return (m4 << sh).sum(axis=2, dtype=np.uint16).astype(np.uint8)


@partial(jax.jit, static_argnames=("cfg", "kb_term", "kb_root", "qw", "tw"))
def _prep_bank_packed(ix: IndexSet, fused, q_packed, q_len, t_packed,
                      trg_len, n_term, init_k, max_overlap, min_overlap,
                      min_sa, max_indel, max_length, min_length, no_term,
                      freqs, pacbio_e, cfg: WalkConfig, kb_term: int,
                      kb_root: int, qw: int, tw: int):
    def unpack(packed, w, lens):
        sh = jnp.arange(4, dtype=jnp.uint8) * 2
        vals = ((packed[:, :, None] >> sh) & 3).reshape(packed.shape[0], -1)
        ranks = (vals[:, :w] + 1).astype(jnp.int8)
        pos = jax.lax.broadcasted_iota(jnp.int32, ranks.shape, 1)
        return jnp.where(pos < lens[:, None], ranks,
                         jnp.int8(ab.PAD_RANK))

    query = unpack(q_packed, qw, q_len)
    trg = unpack(t_packed, tw, trg_len)
    return _prep_core(
        ix, query, q_len, trg, trg_len, n_term, init_k, max_overlap,
        min_overlap, min_sa, max_indel, max_length, min_length, no_term,
        freqs, pacbio_e, cfg, kb_term, kb_root, fused=fused)


def _quant_t(n: int) -> int:
    """Bank-size buckets (each distinct T is a separate queue_run compile)."""
    for t in (1024, 8192):
        if n <= t:
            return t
    return ((n + 8191) // 8192) * 8192


def submit_queue_batch(host_ix, dev_ix, tasks, cfg: WalkConfig,
                       pacbio_error_rate: float, pb_coverage: int,
                       max_steps: int = 4096, max_total: int = 1 << 18):
    """Enqueue a queue-engine round without blocking (device is async)."""
    import os as _os, sys as _sys, time as _time
    _t0 = _time.time()
    wx = dev_ix if isinstance(dev_ix, WalkIndex) else WalkIndex.build(dev_ix, host_ix)
    bank = build_bank(host_ix, tasks, cfg, pacbio_error_rate, pb_coverage,
                      dev_ix=wx, T=_quant_t(len(tasks)))
    outs = queue_run(wx, bank, jnp.int32(len(tasks)), cfg, max_steps, max_total)
    if _os.environ.get("LRSC_DEBUG_TIMING"):
        print(f"[timing]   queue submit n={len(tasks)} T={_quant_t(len(tasks))}:"
              f" host+enqueue {_time.time()-_t0:.2f}s",
              file=_sys.stderr, flush=True)
    return ("queue", tasks, cfg, outs)


def _retry_flagged(host_ix, dev_ix, tasks, out, retry, retry_dense,
                   cfg: WalkConfig, pacbio_error_rate, pb_coverage,
                   max_steps=4096):
    """Re-run -200 (leaf-slot overflow) gaps in the wide config and -300
    (slab-span overflow) gaps on the dense-gather engine; fill `out`."""
    from dataclasses import replace as _rep

    if retry_dense:
        dense = _rep(cfg, SLAB=False, G=_quant_g(len(retry_dense), cfg.G))
        sub = [tasks[g] for g in retry_dense]
        for base in range(0, len(sub), dense.G):
            chunk = sub[base : base + dense.G]
            res = run_gap_batch(host_ix, dev_ix, chunk, dense,
                                pacbio_error_rate, pb_coverage, max_steps)
            for j, r in enumerate(res):
                out[retry_dense[base + j]] = r
    if retry:
        if cfg.L >= cfg.max_leaves:
            for g in retry:
                out[g] = (-100, "")
        else:
            wide = _rep(cfg, L=cfg.max_leaves, CAND=4 * cfg.max_leaves,
                        G=_quant_g(len(retry), cfg.G))
            sub = [tasks[g] for g in retry]
            for base in range(0, len(sub), wide.G):
                chunk = sub[base : base + wide.G]
                res = run_gap_batch(host_ix, dev_ix, chunk, wide,
                                    pacbio_error_rate, pb_coverage, max_steps)
                for j, r in enumerate(res):
                    out[retry[base + j]] = r
    return out


def collect_queue_batch(host_ix, dev_ix, handle, pacbio_error_rate,
                        pb_coverage):
    """Block on a submit_queue_batch handle; returns [(code, seq)]."""
    import os as _os, sys as _sys, time as _time
    _t0 = _time.time()
    _, tasks, cfg, outs = handle
    gstep, code, over, has, lab2, lens, i_ = jax.device_get(outs)
    # unpack the 2-bit label rows back to rank symbols
    sh = (np.arange(4, dtype=np.uint8) * 2)[None, None, :]
    lab = (((lab2[:, :, None] >> sh) & 3) + 1).astype(np.int8).reshape(
        lab2.shape[0], -1)
    # one vectorised rank->char pass for ALL rows; finalize then just
    # slices bytes (a per-gap ab.decode was ~30us x thousands of tasks)
    lab_bytes = ab.RANK_TO_CHAR[lab.astype(np.int64)].tobytes()
    W = lab.shape[1]
    red_np = {
        "code": code, "res_overflow": over, "has": has,
        "lab": lab, "len": lens, "i": i_,
        "lab_row": lambda g, ln: lab_bytes[g * W : g * W + ln].decode(),
    }
    gstep_d = gstep
    _t1 = _time.time()
    out = []
    retry, retry_dense = [], []
    for g in range(len(tasks)):
        c = int(red_np["code"][g])
        if red_np["res_overflow"][g] or c == 0 or c == -900:
            out.append((-100, ""))  # host replay (flag / timeout / unrun)
        elif c == -200:
            out.append(None)
            retry.append(g)
        elif c == -300:
            out.append(None)
            retry_dense.append(g)
        else:
            out.append(finalize_gap(tasks, red_np, g, cfg))
    if _os.environ.get("LRSC_DEBUG_TIMING"):
        nbad = sum(1 for r in out if r == (-100, ""))
        print(f"[timing]   queue collect n={len(tasks)} steps={int(np.asarray(gstep_d))}:"
              f" dev+readback {_t1-_t0:.2f}s finalize {_time.time()-_t1:.2f}s"
              f" wide={len(retry)} dense={len(retry_dense)}"
              f" hostflag={nbad}", file=_sys.stderr, flush=True)
    return _retry_flagged(host_ix, dev_ix, tasks, out, retry, retry_dense,
                          cfg, pacbio_error_rate, pb_coverage)
