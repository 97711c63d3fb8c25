"""Classify prefetch misses in the batched corrector (debug tool).

Runs the bench corpus and, for every prefetch miss, records which key
component drifted from the optimistic enumeration (src tail / path / trg /
interval / ek) so the miss-kill strategy targets the real cause.
"""
import os
import sys
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

from longreadselfcorrect_tpu.core.batch_correct import BatchedSelfCorrector
from longreadselfcorrect_tpu.core.correct import CorrectionParams
from longreadselfcorrect_tpu.io import fasta
from longreadselfcorrect_tpu.ops import walk
from longreadselfcorrect_tpu.index.pack import open_index

CACHE = os.path.join(REPO, ".bench_cache")
N = int(os.environ.get("N_READS", "128"))


class Probe(BatchedSelfCorrector):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.miss_kinds = Counter()
        self._by_pair = {}
        self.examples = 0

    def process_batch(self, items):
        self._by_pair = {}
        return super().process_batch(items)

    def _correct_by_fm_extension(self, source, target, read_seq, result):
        src, path, trg, interval, ek, _ = self._plan_gap(source, target, read_seq)
        key = (src, path, trg, interval, ek)
        if key not in self._prefetch and getattr(self, "_misses", None) is not None:
            # classify: find an enumerated key with the same trg
            match = None
            for k in self._enumerated:
                if k[2] == trg and k[3] == interval:
                    match = k
                    break
            if match is None:
                self.miss_kinds["no_pair_with_same_trg"] += 1
            else:
                diffs = []
                if match[0] != src:
                    diffs.append("src")
                if match[1] != path:
                    diffs.append("path")
                if match[4] != ek:
                    diffs.append("ek")
                self.miss_kinds["+".join(diffs) or "identical?!"] += 1
                if self.examples < 8 and diffs:
                    self.examples += 1
                    p = read_seq[source.seed_end_pos + 1 - ek
                                 : source.seed_end_pos + 1]
                    truth = ""
                    if self.genome:
                        seed = src[-(match[4]):]  # prev seed str tail
                        gp = self.genome.find(seed)
                        if gp > 0:
                            truth = self.genome[gp - (ek - len(seed)) : gp] + seed
                        else:
                            from longreadselfcorrect_tpu.core import alphabet as _ab
                            gp = self.genome.find(_ab.revcomp_str(seed))
                            truth = f"(rc hit at {gp})"
                    print(f"[ex] rep={source.is_repeat}/{target.is_repeat} "
                          f"replay_ek={ek} enum_ek={match[4]}\n"
                          f"     replay_src={src}\n"
                          f"     rawwindow ={p}\n"
                          f"     truth     ={truth}")
        return super()._correct_by_fm_extension(source, target, read_seq, result)


def main():
    from longreadselfcorrect_tpu.jaxcache import configure_compile_cache

    configure_compile_cache()
    import jax
    print("devices:", jax.devices(), file=sys.stderr)
    noisy = os.path.join(CACHE, "noisy.fa")
    genome_path = os.path.join(CACHE, "genome.txt")
    items = [(r.id, r.seq) for r in fasta.read_seqs(noisy)][:N]
    hix, dix = open_index(os.path.join(CACHE, "ours"))
    params = CorrectionParams(pb_coverage=30, genome=10)
    dev = Probe(hix, dix, params,
                cfg=walk.WalkConfig(G=512, MAXLEN=640, QMAX=640, WSCAN=320))
    dev.genome = open(genome_path).read() if os.path.exists(genome_path) else ""

    # capture the enumerated prefetch keys
    orig_run = dev._run_tasks
    def run_tasks(tasks, keys):
        dev._enumerated = list(keys)
        orig_run(tasks, keys)
    dev._run_tasks = run_tasks

    out = dev.process_batch(items)
    ok = sum(1 for r in out if r.merge)
    print("merge", ok, "/", len(items))
    print("stats", {k: v for k, v in dev.stats.items() if k != "fb_unfit_dims"})
    print("miss kinds:", dict(dev.miss_kinds))
    dp = sum(r.dp_num for r in out)
    fm = sum(r.fm_num for r in out)
    he = sum(r.high_error_num for r in out)
    print(f"fm={fm} dp={dp} highErr={he}")


if __name__ == "__main__":
    main()
