"""Device-accelerated self-correction.

Runs the FM-extension walks of MANY reads' seed gaps as one batched device
frontier (ops.walk), then replays the per-read correction workflow using the
prefetched walk results.  The replay validates each gap's inputs against the
optimistic prefetch (source tails can drift after an MSA/raw fallback): any
gap whose inputs differ — or whose device lane was flagged — falls back to
the host engine, so outputs are identical to SelfCorrector's.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import alphabet as ab
from . import seeds as seedmod
from .correct import CorrectionParams, CorrectionResult, SelfCorrector
from .extend import HostExtendEngine
from .seeds import Seed
from ..ops import scan, walk


class BatchedSelfCorrector(SelfCorrector):
    """SelfCorrector with device-prefetched FM-extension walks."""

    def __init__(self, ix, dev_ix, params: CorrectionParams, thresh=None,
                 cfg: walk.WalkConfig | None = None):
        super().__init__(ix, params, thresh)
        from dataclasses import replace as _rep

        # chain-ring bottom length: larger indexes use a deeper interval
        # cache so the slot-0 interval is narrow enough to anchor occ slabs
        ck = 12 if ix.bwt.n > (1 << 24) else walk.CACHE_K
        self.wx = (
            dev_ix if isinstance(dev_ix, walk.WalkIndex)
            else walk.WalkIndex.build(dev_ix, ix, ck=ck)
        )
        ck = self.wx.fused.ck
        cfg = cfg or walk.WalkConfig(G=512, MAXLEN=768, QMAX=768, WSCAN=320)
        # SB=2 covers slot-0 interval spans <= 129 symbols (unique ck-mers
        # are ~coverage wide); wider-repeat lanes escalate to the dense
        # engine via code -300.  The slab row gather is linear in SB;
        # genomes with >=4-copy exact repeats at ck length pay a
        # dense-engine retry per affected gap instead.
        self.cfg = _rep(cfg, CK=ck, SLAB=True, SB=2)
        # low-K variant of the primary config: the superstep's unified occ
        # sweep and the chain ring are linear in NCHAIN = KMAX-CK+1, and
        # most gaps extend at k <= start_kmer_len (init_k <= KMAX_LO-3), so
        # routing them through a narrower chain cuts the sweep nearly in
        # half for the bulk of the queue
        self.cfg_lo = _rep(self.cfg, KMAX=max(ck + 7, 19))
        # wide/long buckets for gaps that exceed the primary config's windows
        self.cfg_big = walk.WalkConfig(
            G=128, MAXLEN=1536, QMAX=1536, WSCAN=576, TMAX=self.cfg.TMAX,
            KMAX=self.cfg.KMAX, CK=ck, SLAB=True, SB=3,
        )
        self.cfg_huge = walk.WalkConfig(
            G=64, MAXLEN=2816, QMAX=2816, WSCAN=1120, TMAX=self.cfg.TMAX,
            KMAX=self.cfg.KMAX, CK=ck, SLAB=True,
        )
        # deep-K tier: gaps whose extend-k exceeds the primary KMAX=24
        # (long best-k seeds make ek up to kmer_len_up_bound-2 = 48) would
        # otherwise fall off every config onto the host engine (fb_unfit)
        self.cfg_deep = _rep(self.cfg_big, G=64, KMAX=52)
        self._prefetch: dict = {}
        # DP/MSA fallback runs its LF extraction + banded DP fills on the
        # device (core/msa.py dev= path -> ops/msa_kernels)
        self.msa_dev = self.wx.ix
        self.stats = {"prefetch_hit": 0, "prefetch_miss": 0, "host_fallback": 0}

    # ------------------------------------------------------------------
    def _plan_gap(self, source: Seed, target: Seed, read_seq: str):
        """Replicates _gap_setup + the R->U transform of
        correctByFMExtension (PacBioSelfCorrectionProcess.cpp:159-189)."""
        interval = target.seed_start_pos - source.seed_end_pos - 1
        ek = min(source.end_best_kmer_size, target.start_best_kmer_size) - 2
        if source.is_repeat or target.is_repeat:
            ek = min(source.seed_len, target.seed_len)
            ek = min(ek, self.start_kmer_len + 2)
        src = source.seed_str[source.seed_len - ek:]
        trg = target.seed_str
        if interval >= 0:
            path = read_seq[source.seed_end_pos + 1 : source.seed_end_pos + 1 + interval]
        else:
            path = read_seq[source.seed_end_pos + 1:]
        if source.is_repeat and not target.is_repeat:
            src, trg = trg, src
            src = ab.revcomp_str(src)
            trg = ab.revcomp_str(trg)
            path = ab.revcomp_str(path)
        min_sa = (self.params.pb_coverage // 60) * 3 if self.params.pb_coverage > 60 else 3
        return src, path, trg, interval, ek, min_sa

    def _task_fits(self, src, path, trg, interval, ek, cfg=None) -> bool:
        cfg = cfg or self.cfg
        beginning_len = ek
        qlen = beginning_len + len(path) + len(trg)
        if qlen > cfg.QMAX:
            return False
        max_length = int(1.2 * (interval + 10) + 2 * ek)
        if max_length + 2 > cfg.MAXLEN:
            return False
        max_indel = int(interval * 0.2) if interval > 100 else 20
        if cfg.WSCAN < 2 * max_indel + cfg.seed_size * 2 + 3:
            return False
        if len(trg) - 13 + 1 > cfg.TMAX or len(trg) < 13:
            return False
        # chains only ever run at k >= minOverlap (>= CACHE_K+2); small ek
        # affects only the host-computed root interval, so any sane ek fits
        if ek + 2 + 1 > cfg.KMAX or ek < 5:
            return False
        return True

    # ------------------------------------------------------------------
    def _fits_any(self, src, path, trg, interval, ek) -> bool:
        """Does ANY device config cover this gap's dimensions?"""
        return (self._task_fits(src, path, trg, interval, ek, self.cfg_huge)
                or self._task_fits(src, path, trg, interval, ek, self.cfg_deep))

    # ------------------------------------------------------------------
    def _device_seed_scan(self, items):
        """The ENTIRE seed phase on device (ops.seedscan): tables never
        leave the chip; only per-seed records do.  Yields
        (base, chunk, seeds_per_read)."""
        yield from self._seed_collect(self._seed_submit(items))

    def _seed_submit(self, items):
        """Dispatch the device seed scan for every 64-read chunk without
        collecting (device work proceeds asynchronously)."""
        import jax.numpy as jnp

        from ..ops import seedscan

        pp = self.probe_params
        max_k = pp.kmer_len_up_bound + 1
        thr_dev = jnp.asarray(self.thresh.table[:, : max_k + 1])
        rep_thr = jnp.float32(self.thresh.get(2, pp.scan_kmer_len))
        R = 64
        L = max(len(seq) for _, seq in items)
        L = 256 * ((L + 255) // 256)
        submitted = []
        for base in range(0, len(items), R):
            chunk = items[base : base + R]
            mat = np.full((R, L), ab.PAD_RANK, np.int8)
            lens = np.zeros(R, np.int32)
            for i, (_, seq) in enumerate(chunk):
                e = ab.encode(seq)
                mat[i, : len(e)] = e
                lens[i] = len(e)
            dmat = jnp.asarray(mat)
            dlens = jnp.asarray(lens)
            freq, valid = scan.kmer_table_full(self.wx.ix, dmat, dlens,
                                               max_k)
            onehot = (dmat[:, :, None] == jnp.arange(1, 5, dtype=jnp.int8))
            prefix = jnp.pad(
                jnp.cumsum(onehot, axis=1, dtype=jnp.int32),
                ((0, 0), (1, 0), (0, 0)))
            if pp.manual:
                attr = jnp.full((R, L), pp.mode, jnp.int32)
            else:
                attr = seedscan._attributes(
                    freq[pp.scan_kmer_len], prefix, dlens, rep_thr,
                    pp.scan_kmer_len)
            n, starts, sizes, freqs, reps, statics = seedscan._scan_automaton(
                freq, valid, attr, prefix, dlens, thr_dev,
                pp.start_kmer_len, pp.kmer_len_up_bound, tuple(pp.offset),
                float(pp.hh_ratio))
            sk, ek, oor = seedscan._estimate_best(
                freq, n, starts, sizes, statics, pp.pb_coverage)
            keep = seedscan._remove_hitchhiking(
                n, starts, sizes, freqs, reps, pp.radius, float(pp.hh_ratio))
            submitted.append((base, chunk,
                              (n, starts, sizes, freqs, reps, statics,
                               sk, ek, oor, keep)))
        return submitted

    def _seed_collect(self, submitted):
        """Pull seed-scan results and build Seed records (host side)."""
        pp = self.probe_params
        for base, chunk, devs in submitted:
            (n, starts, sizes, freqs, reps, statics, sk, ek, oor,
             keep) = (np.asarray(x) for x in devs)
            out = []
            for i, (rid, seq) in enumerate(chunk):
                seeds = []
                for j in range(int(n[i])):
                    st, sz = int(starts[i, j]), int(sizes[i, j])
                    s = Seed.make(seq[st : st + sz], st, int(freqs[i, j]),
                                  bool(reps[i, j]), int(statics[i, j]),
                                  pp.pb_coverage)
                    if oor[i, j]:
                        # best-k walked past the device table: host redo
                        s.estimate_best_kmer_size(self.ix)
                    else:
                        s.start_best_kmer_size = int(sk[i, j])
                        s.end_best_kmer_size = int(ek[i, j])
                    s.is_hitchhiked = not bool(keep[i, j])
                    if not s.is_hitchhiked:
                        seeds.append(s)
                out.append(seeds)
            yield base, chunk, out

    def process_batch(self, items: list[tuple[str, str]]) -> list[CorrectionResult]:
        """Correct a batch of (read_id, sequence) reads."""
        import os, sys, time as _time
        _dbg = os.environ.get("LRSC_DEBUG_TIMING")
        self.phase_times = {}
        _t0 = _time.time()
        per_read = []
        for base, chunk, seeds_lists in self._device_seed_scan(items):
            for (rid, seq), seeds in zip(chunk, seeds_lists):
                per_read.append((rid, seq, seeds))
        self.phase_times["seed"] = _time.time() - _t0
        if _dbg: print(f"[timing] seed scan (device): {_time.time()-_t0:.1f}s", file=sys.stderr, flush=True)
        _t0 = _time.time()

        tasks, keys = self._enumerate_walks(per_read)
        self._prefetch = {}
        self._run_tasks(tasks, keys)
        self.phase_times["walks"] = _time.time() - _t0
        self.phase_times["gaps"] = len(tasks)
        if _dbg: print(f"[timing] device walks ({len(tasks)} gaps): {_time.time()-_t0:.1f}s", file=sys.stderr, flush=True)
        _t0 = _time.time()
        out = self._replay(per_read)
        self.phase_times["replay"] = _time.time() - _t0
        if _dbg: print(f"[timing] replay+retries: {_time.time()-_t0:.1f}s", file=sys.stderr, flush=True)
        return out

    def process_stream(self, batches):
        """Streamed multi-batch correction with bounded memory: one batch
        of reads is resident at a time; yields one result list per input
        batch, in order.

        Batch k+1's seed scan is dispatched only after batch k's replay
        finishes: one device runs its queue in order, so work dispatched
        any earlier would stall batch k's replay-retry rounds behind it."""
        import time as _time

        # phase_times here are cumulative HOST-BLOCKING times (the phases
        # overlap on the device, so per-phase wall splits are ill-defined)
        self.phase_times = {"seed": 0.0, "walks": 0.0, "replay": 0.0,
                            "gaps": 0}
        q = []
        batches = iter(batches)

        def admit():
            items = next(batches, None)
            if items is None:
                return False
            q.append({"items": items, "seed_h": self._seed_submit(items)})
            return True

        admit()
        while q:
            st = q.pop(0)
            _t = _time.time()
            per_read = []
            for base, chunk, seeds_lists in self._seed_collect(st["seed_h"]):
                for (rid, seq), seeds in zip(chunk, seeds_lists):
                    per_read.append((rid, seq, seeds))
            self.phase_times["seed"] += _time.time() - _t
            _t = _time.time()
            tasks, keys = self._enumerate_walks(per_read)
            prefetch: dict = {}
            self._prefetch = prefetch
            submitted = self._submit_tasks(tasks, keys)
            self.phase_times["gaps"] += len(tasks)
            self._collect_tasks(submitted)
            self.phase_times["walks"] += _time.time() - _t
            _t = _time.time()
            self._prefetch = prefetch
            out = self._replay(per_read)
            self.phase_times["replay"] += _time.time() - _t
            yield out
            admit()

    def _enum_state(self):
        """Fresh state for incremental walk enumeration (reads can be fed
        as their seed chunks land, overlapping the host enumeration with
        the device seed scan of later chunks)."""
        return {"tasks": [], "keys": [], "seen": set(), "pending_b": []}

    def _enum_push(self, st, src, path, trg, interval, ek, min_sa):
        key = (src, path, trg, interval, ek)
        if key in st["seen"]:
            return
        st["seen"].add(key)
        if not self._fits_any(src, path, trg, interval, ek):
            return
        st["tasks"].append(walk.GapTask(
            src=src, path=path, trg=trg, dis=interval, init_k=ek,
            max_overlap=ek + 2, min_overlap=self.params.min_kmer_len,
            min_sa_threshold=min_sa,
        ))
        st["keys"].append(key)

    def _enumerate_walks(self, per_read):
        """Optimistic prefetch task enumeration for a scanned batch."""
        st = self._enum_state()
        for rid, seq, seeds in per_read:
            self._enum_read(st, rid, seq, seeds)
        return self._enum_finalize(st)

    def _enum_read(self, st, rid, seq, seeds):
        # optimistic prefetch: every consecutive seed pair of every read.
        # For i >= 2 the replay's source is the ACCUMULATED piece, whose
        # seed_len is the merged length — for repeat-flanked gaps that
        # changes ek (min(source.seed_len, target.seed_len) clamp,
        # _plan_gap) and therefore the src tail, so the original-seed key
        # would miss.  Both variants are predictable from the original
        # seeds (the piece tail equals seeds[i-1].seed_str's tail), so
        # enumerate both keys up front instead of paying miss rounds.
        pending_b = st["pending_b"]
        for i in range(1, len(seeds)):
            src, path, trg, interval, ek, min_sa = self._plan_gap(
                seeds[i - 1], seeds[i], seq
            )
            self._enum_push(st, src, path, trg, interval, ek, min_sa)
            prev, curr = seeds[i - 1], seeds[i]
            if i >= 2 and (prev.is_repeat or curr.is_repeat):
                # accumulated-source variant: during replay the source
                # is the merged piece whose seed_len is large, so
                # ek2 = min(target.seed_len, start_kmer_len + 2).  The
                # piece tail is prev.seed_str (the previous walk ends
                # with its target) preceded by CORRECTED bases — and
                # the raw base left of a seed is usually an error
                # (that is why the seed boundary is there), so those
                # bases are predicted as the FM consensus left
                # extension of the seed, batched in _enum_finalize
                ek2 = min(curr.seed_len, self.start_kmer_len + 2)
                if ek2 != ek:
                    need = ek2 - prev.seed_len
                    if need <= 0:
                        src2 = prev.seed_str[prev.seed_len - ek2:]
                        pending_b.append(((seq, prev, curr, interval,
                                           min_sa, ek2, path), src2, 0))
                    elif need <= 2:
                        pending_b.append(((seq, prev, curr, interval,
                                           min_sa, ek2, path),
                                          prev.seed_str, need))

    def _enum_finalize(self, st):
        """Resolve the batch's variant-B keys (one batched FM consensus
        query per left-extension round) and return (tasks, keys)."""
        pending_b = st["pending_b"]
        W = 12  # window: freq of (base + seed[:W]) picks the consensus base
        rounds = max((nb for _, _, nb in pending_b), default=0)
        for _ in range(rounds):
            grow = [j for j, (_, w, nb) in enumerate(pending_b) if nb > 0]
            if not grow:
                break
            words = np.stack([
                np.concatenate([
                    np.zeros(1, np.int8),
                    ab.encode(pending_b[j][1][: W])])
                for j in grow
            ])  # [n, W+1]
            cand = np.repeat(words, 4, axis=0)
            cand[:, 0] = np.tile(np.arange(1, 5, dtype=np.int8), len(grow))
            lo, hi = self.ix.bwt.find_interval(cand)
            fwd = np.maximum(hi - lo + 1, 0)
            lo, hi = self.ix.bwt.find_interval(
                ab.complement(cand)[:, ::-1])
            freq = (fwd + np.maximum(hi - lo + 1, 0)).reshape(len(grow), 4)
            best = np.argmax(freq, axis=1)
            for j, b in zip(grow, best):
                args, w, nb = pending_b[j]
                pending_b[j] = (args, "ACGT"[int(b)] + w, nb - 1)

        for (seq, prev, curr, interval, min_sa, ek2, path), w, _ in pending_b:
            src2 = w[len(w) - ek2:] if len(w) >= ek2 else None
            if src2 is None:
                continue
            trg2 = curr.seed_str
            if prev.is_repeat and not curr.is_repeat:
                # R->U strand flip, as in _plan_gap
                p2 = (seq[prev.seed_end_pos + 1 : prev.seed_end_pos + 1 + interval]
                      if interval >= 0 else seq[prev.seed_end_pos + 1:])
                src2, trg2 = ab.revcomp_str(trg2), ab.revcomp_str(src2)
                path2 = ab.revcomp_str(p2)
            else:
                path2 = path
            self._enum_push(st, src2, path2, trg2, interval, ek2, min_sa)
        return st["tasks"], st["keys"]

    def _replay(self, per_read):
        """Replay the per-read workflow against self._prefetch; drifted
        gaps are collected and solved in further device rounds rather than
        one-by-one on the host."""
        out = [None] * len(per_read)
        pending = list(range(len(per_read)))
        # on a miss the replay continues OPTIMISTICALLY (the pretend output
        # keeps the source tail equal to the target seed tail, which is what
        # a successful walk leaves in the common case), so one round collects
        # a read's entire chain of missing gaps
        for round_i in range(6):
            self._misses = [] if round_i < 5 else None  # final round: host
            still = []
            # miss tasks are SUBMITTED to the device as soon as enough
            # accumulate, so the next round's walks compute while this
            # round's host replay continues over the remaining reads
            seen = set()
            miss_tasks, miss_keys = [], []
            submitted = []

            def drain():
                while self._misses:
                    t, k = self._misses.pop()
                    if k not in seen:
                        seen.add(k)
                        miss_tasks.append(t)
                        miss_keys.append(k)

            def flush(force=False):
                drain()
                while miss_tasks and (force or len(miss_tasks) >= 256):
                    take = miss_tasks[:512]
                    tkeys = miss_keys[:512]
                    del miss_tasks[:512], miss_keys[:512]
                    submitted.extend(self._submit_tasks(take, tkeys))

            for ri in pending:
                rid, seq, seeds = per_read[ri]
                result = CorrectionResult(read_id=rid)
                result.total_seed_num = len(seeds)
                self._read_incomplete = False
                pieces = self._init_correct(seq, seeds, result)
                if self._read_incomplete:
                    still.append(ri)  # retried after the next device round
                    if self._misses is not None:
                        flush()
                    continue
                result.merge = bool(pieces)
                result.total_reads_len = len(seq)
                result.corrected_strs = [p.seed_str for p in pieces]
                out[ri] = result
            if not still:
                break
            flush(force=True)
            self._collect_tasks(submitted)
            pending = still
        self._misses = None
        return out

    def _route(self, tasks):
        """Task indices per config bucket: small_lo, small, big, huge,
        deep, dense (in that order)."""
        # route to the primary or the wide/long config.  Gaps whose initial
        # label is shorter than the chain-cache word can't use slab occ and
        # run on the dense-gather engine instead; deep-k gaps (ek beyond the
        # primary KMAX) get the widened-chain config.
        small, small_lo, big, huge, deep, dense = [], [], [], [], [], []
        for i, t in enumerate(tasks):
            if t.init_k < self.cfg.CK:
                dense.append(i)
            elif self._task_fits(t.src, t.path, t.trg, t.dis, t.init_k):
                # narrow-chain bank for the bulk: all chain lengths the walk
                # can reach (max_overlap + 1) fit the low-K config's ring
                if t.max_overlap + 1 <= self.cfg_lo.KMAX:
                    small_lo.append(i)
                else:
                    small.append(i)
            elif self._task_fits(t.src, t.path, t.trg, t.dis, t.init_k, self.cfg_big):
                big.append(i)
            elif self._task_fits(t.src, t.path, t.trg, t.dis, t.init_k, self.cfg_huge):
                huge.append(i)
            else:
                deep.append(i)
        return small_lo, small, big, huge, deep, dense

    def _submit_tasks(self, tasks, keys):
        """Route tasks to config buckets and enqueue them (non-blocking).
        Returns [(kind, task_keys, handle)] for _collect_tasks; each bucket
        is batched by expected walk depth so a chunk's lanes finish
        together."""
        from dataclasses import replace as _rep

        small_lo, small, big, huge, deep, dense = self._route(tasks)
        cfg_dense = _rep(self.cfg_huge, SLAB=False, G=32)
        submitted = []
        # small buckets (the bulk): queue-refill engine — ONE dispatch walks
        # the whole list with on-device lane refill, so neither stragglers
        # nor per-chunk dispatch round trips are paid
        QMAXT = 8192
        for sel_all, cfg_q in ((small_lo, self.cfg_lo), (small, self.cfg)):
            order = sorted(sel_all, key=lambda i: tasks[i].dis)
            for base in range(0, len(order), QMAXT):
                sel = order[base : base + QMAXT]
                chunk = [tasks[i] for i in sel]
                h = walk.submit_queue_batch(
                    self.ix, self.wx, chunk, cfg_q,
                    self.params.error_rate, self.params.pb_coverage,
                )
                submitted.append(("queue", [keys[i] for i in sel], h))
        for sel_all, cfg in ((big, self.cfg_big), (huge, self.cfg_huge),
                             (deep, self.cfg_deep), (dense, cfg_dense)):
            order = sorted(sel_all, key=lambda i: tasks[i].dis)
            for base in range(0, len(order), cfg.G):
                sel = order[base : base + cfg.G]
                chunk = [tasks[i] for i in sel]
                # partial chunks run in a small-G variant of the config —
                # the superstep is latency-bound below ~64 lanes
                cfg_eff = cfg
                gq = walk._quant_g(len(sel), cfg.G)
                if gq < cfg.G:
                    cfg_eff = _rep(cfg, G=gq)
                h = walk.submit_gap_batch(
                    self.ix, self.wx, chunk, cfg_eff,
                    self.params.error_rate, self.params.pb_coverage,
                )
                submitted.append(("batch", [keys[i] for i in sel],
                                  (chunk, cfg_eff, h)))
        return submitted

    def _collect_tasks(self, submitted) -> None:
        for kind, tkeys, payload in submitted:
            if kind == "queue":
                res = walk.collect_queue_batch(
                    self.ix, self.wx, payload,
                    self.params.error_rate, self.params.pb_coverage,
                )
            else:
                chunk, cfg, h = payload
                res = walk.run_gap_batch(
                    self.ix, self.wx, chunk, cfg,
                    self.params.error_rate, self.params.pb_coverage,
                    _handle=h,
                )
            for k, r in zip(tkeys, res):
                self._prefetch[k] = r

    def _run_tasks(self, tasks, keys):
        """Submit every chunk first (device dispatch is async), then
        collect: batch k+1 computes while batch k's results are read back."""
        self._collect_tasks(self._submit_tasks(tasks, keys))

    # ------------------------------------------------------------------
    def _correct_by_fm_extension(self, source: Seed, target: Seed, read_seq: str,
                                 result: CorrectionResult):
        src, path, trg, interval, ek, min_sa = self._plan_gap(source, target, read_seq)
        key = (src, path, trg, interval, ek)
        hit = self._prefetch.get(key)
        if hit is not None and hit[0] != -100:
            self.stats["prefetch_hit"] += 1
            code, merged = hit
        elif (
            getattr(self, "_misses", None) is not None
            and hit is None
            and self._fits_any(src, path, trg, interval, ek)
        ):
            # collect for the next device round; the read's replay restarts
            self._misses.append((walk.GapTask(
                src=src, path=path, trg=trg, dis=interval, init_k=ek,
                max_overlap=ek + 2, min_overlap=self.params.min_kmer_len,
                min_sa_threshold=min_sa,
            ), key))
            self.stats["prefetch_miss"] += 1
            self._read_incomplete = True
            # pretend success shaped like the raw-subsequence fallback: the
            # read is re-replayed once the real result lands, so only the
            # resulting source TAIL matters for collecting the next keys
            fake = read_seq[source.seed_end_pos + 1 : target.seed_end_pos + 1]
            result.fm_num += 1
            return 1, fake
        else:
            self.stats["host_fallback"] += 1
            if hit is not None:
                self.stats["fb_flagged"] = self.stats.get("fb_flagged", 0) + 1
            elif getattr(self, "_misses", None) is None:
                self.stats["fb_lastround"] = self.stats.get("fb_lastround", 0) + 1
            else:
                self.stats["fb_unfit"] = self.stats.get("fb_unfit", 0) + 1
                self.stats.setdefault("fb_unfit_dims", []).append(
                    (interval, len(path), len(trg), ek))
            engine = HostExtendEngine(
                self.ix, src, path, trg, interval, ek, ek + 2, self.fm_params, min_sa,
            )
            code, wres = engine.extend()
            merged = wres.merged_seq
        if code < 0:
            return code, ""
        if source.is_repeat and not target.is_repeat:
            merged = ab.revcomp_str(merged)
            merged += ab.revcomp_str(src)[ek:]
        out = merged[ek:]
        result.corrected_len += len(out)
        result.seed_dis += interval
        result.fm_num += 1
        return code, out
