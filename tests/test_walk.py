"""Device walk engine vs host golden engine."""
import numpy as np
import pytest

import jax.numpy as jnp

from longreadselfcorrect_tpu.core import alphabet as ab
from longreadselfcorrect_tpu.core.extend import FMExtendParams, HostExtendEngine
from longreadselfcorrect_tpu.index import build
from longreadselfcorrect_tpu.index.fmindex import FMIndex, IndexSet
from longreadselfcorrect_tpu.index.host import HostFM, HostIndexSet
from longreadselfcorrect_tpu.ops import walk


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(33)
    genome = "".join(rng.choice(list("ACGT"), size=6000))
    reads = []
    for i in range(180):
        p = rng.integers(0, len(genome) - 1000)
        r = genome[p : p + 1000]
        reads.append(ab.revcomp_str(r) if i % 2 else r)
    enc = [ab.encode(r) for r in reads]
    fwd, rev = build.build_bwt_pair(enc)
    hix = HostIndexSet(HostFM(fwd.symbols, fwd.num_strings), HostFM(rev.symbols, rev.num_strings))
    dix = IndexSet(
        bwt=FMIndex.from_symbols(fwd.symbols, fwd.num_strings),
        rbwt=FMIndex.from_symbols(rev.symbols, rev.num_strings),
    )
    return genome, reads, hix, dix, rng


def make_tasks(reads, rng, n, noisy=False):
    tasks = []
    expects = None
    for t in range(n):
        read = reads[(2 * t) % len(reads)]
        s = 40 + (t * 37) % 200
        gap = 80 + (t * 53) % 250
        src_seed = read[s : s + 19]
        t_start = s + 19 + gap
        trg_seed = read[t_start : t_start + 19]
        path = read[s + 19 : t_start]
        if noisy:
            p = list(path)
            for j in range(3, len(p), 13):
                p[j] = "ACGT"[("ACGT".index(p[j]) + 1) % 4]
            path = "".join(p)
        ek = 15
        tasks.append(
            walk.GapTask(
                src=src_seed[19 - ek:], path=path, trg=trg_seed, dis=gap,
                init_k=ek, max_overlap=ek + 2, min_overlap=13, min_sa_threshold=3,
            )
        )
    return tasks


def host_run(hix, task):
    eng = HostExtendEngine(
        hix, task.src, task.path, task.trg, task.dis, task.init_k,
        task.max_overlap, FMExtendParams(pb_coverage=30, error_rate=0.15),
        task.min_sa_threshold,
    )
    code, res = eng.extend()
    return code, res.merged_seq


class TestDeviceWalk:
    def test_matches_host_clean(self, corpus):
        genome, reads, hix, dix, rng = corpus
        tasks = make_tasks(reads, rng, 12)
        cfg = walk.WalkConfig(G=12, MAXLEN=512, QMAX=512)
        got = walk.run_gap_batch(hix, dix, tasks, cfg, 0.15, 30)
        mismatches = 0
        for task, (dcode, dseq) in zip(tasks, got):
            hcode, hseq = host_run(hix, task)
            if (dcode, dseq) != (hcode, hseq):
                mismatches += 1
                print("MISMATCH", dcode, hcode, len(dseq), len(hseq))
        assert mismatches == 0

    def test_matches_host_noisy(self, corpus):
        genome, reads, hix, dix, rng = corpus
        tasks = make_tasks(reads, rng, 12, noisy=True)
        cfg = walk.WalkConfig(G=12, MAXLEN=512, QMAX=512)
        got = walk.run_gap_batch(hix, dix, tasks, cfg, 0.15, 30)
        mismatches = 0
        for task, (dcode, dseq) in zip(tasks, got):
            hcode, hseq = host_run(hix, task)
            if (dcode, dseq) != (hcode, hseq):
                mismatches += 1
                print("MISMATCH", dcode, hcode, len(dseq), len(hseq))
        assert mismatches == 0


class TestQueueEngine:
    """Queue-refill engine must agree with the batch engine / host oracle."""

    def _run(self, corpus, noisy, slab):
        genome, reads, hix, dix, rng = corpus
        tasks = make_tasks(reads, rng, 24, noisy=noisy)
        cfg = walk.WalkConfig(G=8, MAXLEN=512, QMAX=512, SLAB=slab)
        wx = walk.WalkIndex.build(dix, hix)
        h = walk.submit_queue_batch(hix, wx, tasks, cfg, 0.15, 30)
        got = walk.collect_queue_batch(hix, wx, h, 0.15, 30)
        mismatches = 0
        for task, (dcode, dseq) in zip(tasks, got):
            hcode, hseq = host_run(hix, task)
            if dcode == -100:
                continue  # host-replay flag: scheduler handles it
            if (dcode, dseq) != (hcode, hseq):
                mismatches += 1
                print("MISMATCH", dcode, hcode, len(dseq), len(hseq))
        assert mismatches == 0

    def test_queue_clean(self, corpus):
        self._run(corpus, noisy=False, slab=False)

    def test_queue_noisy_slab(self, corpus):
        self._run(corpus, noisy=True, slab=True)


def _slab_case(rng, n, block, SB, n_lanes):
    """Per-lane slot-0 intervals [lo0, hi0] spanning <= SB blocks, plus
    query positions idx in [lo0 - 1, hi0] that hit both block edges."""
    lo0 = rng.integers(0, n - 1, n_lanes)
    lo0 -= (lo0 % block == block - 1) & (SB == 1)       # a 1-block span must fit
    lo0[::4] = (lo0[::4] // block) * block              # interval on a block start
    # widest span that still fits: (hi0 + 1) // block - lo0 // block < SB
    width = rng.integers(0, SB * block - 1 - lo0 % block)
    hi0 = np.minimum(lo0 + width, n - 1)
    hi0[1::4] = np.minimum(((lo0[1::4] // block) + SB) * block - 2, n - 1)
    qs = [lo0 - 1, hi0]
    for k in range(SB + 1):                             # block edges inside
        edge = (lo0 // block + k) * block
        qs += [np.clip(edge - 1, lo0 - 1, hi0), np.clip(edge, lo0 - 1, hi0)]
    qs.append(lo0 - 1 + (rng.random(n_lanes) * (hi0 - lo0 + 2)).astype(np.int64))
    return lo0, hi0, np.stack(qs, axis=-1)


@pytest.mark.parametrize("SB", [1, 2, 3])
def test_slab_occ_all_matches_cumsum(SB):
    """Slab occ of every base equals a prefix-count oracle on random BWTs,
    on both strands' halves of the fused table."""
    rng = np.random.default_rng(500 + SB)
    n = 128 * 37 + 51
    syms = [rng.integers(0, 5, n).astype(np.int8) for _ in range(2)]
    ix = IndexSet(
        bwt=FMIndex.from_symbols(syms[0], int((syms[0] == 0).sum())),
        rbwt=FMIndex.from_symbols(syms[1], int((syms[1] == 0).sum())),
    )
    hix = HostIndexSet(HostFM(syms[0], int((syms[0] == 0).sum())),
                       HostFM(syms[1], int((syms[1] == 0).sum())))
    fx = walk.FusedFM.from_index_set(ix, hix)
    cfg = walk.WalkConfig(SLAB=True, SB=SB)
    for side, rbwt_side in ((0, False), (1, True)):
        cum = np.zeros((n + 1, 5), np.int64)
        cum[1:] = np.cumsum(syms[side][:, None] == np.arange(5), axis=0)
        lo0, hi0, idx = _slab_case(rng, n, fx.block, SB, 4096)
        slab = walk._slab_fetch(fx, cfg, jnp.asarray(lo0, jnp.int32),
                                jnp.asarray(hi0, jnp.int32), rbwt_side)
        assert bool(np.all(np.asarray(slab[3])))        # every span fits
        got = np.asarray(walk._slab_occ_all(slab, jnp.asarray(idx, jnp.int32)))
        np.testing.assert_array_equal(got, cum[idx + 1, 1:5])
        # an empty interval is accepted (ok) and a too-wide one escalates
        lo_e = jnp.asarray([10, 0], jnp.int32)
        hi_e = jnp.asarray([9, (SB + 1) * fx.block], jnp.int32)
        ok = np.asarray(walk._slab_fetch(fx, cfg, lo_e, hi_e, rbwt_side)[3])
        assert ok.tolist() == [True, False]


def test_chain_slot_selects_each_gaps_slot():
    """The ring read (a take_along_axis with broadcast index dims) returns
    slot clip(k - CK) of every (gap, leaf) lane, as plain indexing does."""
    rng = np.random.default_rng(3)
    G, L, NCH, ck = 6, 4, 9, 8
    chain = rng.integers(-5, 1000, (G, L, 4, NCH)).astype(np.int32)
    k = np.array([0, 8, 9, 12, 16, 40], np.int32)      # below, in and above range
    got = walk._chain_slot(jnp.asarray(chain), jnp.asarray(k), ck)
    j = np.clip(k - ck, 0, NCH - 1)
    for f in range(4):
        want = chain[np.arange(G)[:, None], np.arange(L)[None, :], f, j[:, None]]
        np.testing.assert_array_equal(np.asarray(got[f]), want)
