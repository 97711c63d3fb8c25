"""Round benchmark: corrected reads/s at E. coli scale.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Workload (north-star config): PacBio-style self-correction of 1.5 kb
8%-error reads against a 30x FM-index of a 4 Mb synthetic genome (~120M
symbols per strand — larger than CPU caches, the regime the reference
actually runs in).  vs_baseline = our reads/s divided by the reference
C++ binary's single-thread reads/s measured on the SAME corpus in the same
run (falls back to the host-python engine when .refbuild/stride is absent).

Heavy artifacts (corpus, indexes) are cached under .bench_cache/ across runs.
"""
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".bench_cache")
VERSION = "v4-4mb-30x"
GENOME_LEN = 4_000_000
READ_LEN = 2000
COVERAGE = 30
N_NOISY = 256
N_BENCH = int(os.environ.get("BENCH_READS", "256"))

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def noisify(rng, s, e):
    out = []
    for ch in s:
        r = rng.random()
        if r < e * 0.6:
            out.append("ACGT"[("ACGT".index(ch) + int(rng.integers(1, 4))) % 4])
        elif r < e * 0.8:
            pass
        elif r < e:
            out.append(ch)
            out.append("ACGT"[int(rng.integers(0, 4))])
        else:
            out.append(ch)
    return "".join(out)


def ensure_corpus():
    os.makedirs(CACHE, exist_ok=True)
    stamp = os.path.join(CACHE, VERSION + ".ok")
    corpus = os.path.join(CACHE, "corpus.fa")
    noisy = os.path.join(CACHE, "noisy.fa")
    if os.path.exists(stamp):
        return corpus, noisy
    from longreadselfcorrect_tpu.core import alphabet as ab

    log("generating corpus ...")
    rng = np.random.default_rng(2026)
    genome = "".join(rng.choice(list("ACGT"), size=GENOME_LEN))
    n_reads = GENOME_LEN * COVERAGE // READ_LEN
    with open(corpus, "w") as f:
        for i in range(n_reads):
            p = int(rng.integers(0, GENOME_LEN - READ_LEN))
            r = genome[p : p + READ_LEN]
            if i % 2:
                r = ab.revcomp_str(r)
            f.write(f">c{i}\n{r}\n")
    with open(noisy, "w") as f:
        for i, p in enumerate(rng.integers(0, GENOME_LEN - 1600, size=N_NOISY)):
            f.write(f">r{i}\n{noisify(rng, genome[p : p + 1500], 0.08)}\n")
    with open(os.path.join(CACHE, "genome.txt"), "w") as f:
        f.write(genome)
    open(stamp, "w").write("ok")
    return corpus, noisy


def ensure_our_index(corpus):
    from longreadselfcorrect_tpu.index import store

    prefix = os.path.join(CACHE, "ours")
    if not os.path.exists(prefix + ".bwtraw"):
        log("building our index (native SA-IS) ...")
        t0 = time.time()
        store.build_with_fmbuild(corpus, prefix)
        log(f"fmbuild: {time.time()-t0:.0f}s")
    return prefix


def ensure_ref_index(corpus, stride):
    prefix = os.path.join(CACHE, "refidx")
    if not os.path.exists(prefix + ".bwt"):
        log("building reference index (ropebwt2) ...")
        t0 = time.time()
        subprocess.run(
            [stride, "index", "-a", "ropebwt2", "-t", "4", "-p", prefix, corpus],
            check=True, capture_output=True,
        )
        log(f"stride index: {time.time()-t0:.0f}s")
    return prefix


def main():
    import jax

    from longreadselfcorrect_tpu.jaxcache import configure_compile_cache

    configure_compile_cache()
    from longreadselfcorrect_tpu.core.batch_correct import BatchedSelfCorrector
    from longreadselfcorrect_tpu.core.correct import CorrectionParams, SelfCorrector
    from longreadselfcorrect_tpu.index import store
    from longreadselfcorrect_tpu.index.fmindex import FMIndex, IndexSet
    from longreadselfcorrect_tpu.index.host import HostFM, HostIndexSet
    from longreadselfcorrect_tpu.io import fasta
    from longreadselfcorrect_tpu.ops import walk

    log(f"devices: {jax.devices()}")
    corpus, noisy = ensure_corpus()
    items = [(rec.id, rec.seq) for rec in fasta.read_seqs(noisy)][:N_BENCH]

    prefix = ensure_our_index(corpus)
    t0 = time.time()
    from longreadselfcorrect_tpu.index.pack import open_index

    hix, dix = open_index(prefix)
    log(f"index load+pack: {time.time()-t0:.0f}s ({hix.bwt.n} symbols)")

    params = CorrectionParams(pb_coverage=COVERAGE, genome=10)

    dev = BatchedSelfCorrector(
        hix, dix, params,
        cfg=walk.WalkConfig(G=512, MAXLEN=640, QMAX=640, WSCAN=320),
    )
    log("warmup ...")
    # warm up on the FULL workload so every lane config the measured run
    # uses (including the G-quantized retry variants) is compiled
    B = int(os.environ.get("BENCH_BATCH", str(len(items))))
    batches = [items[i : i + B] for i in range(0, len(items), B)]
    for _ in dev.process_stream(batches):
        pass
    # best-of-2 measured runs — the same min-of-N protocol the reference
    # baseline below gets, so vs_baseline compares like with like.  The
    # pipelined stream overlaps batch k's host replay with batch k+1's
    # device work.
    dt_dev = None
    for _ in range(2):
        t0 = time.time()
        out = []
        for part in dev.process_stream(batches):
            out.extend(part)
        dt = time.time() - t0
        dt_dev = dt if dt_dev is None else min(dt_dev, dt)
    dev_rps = len(items) / dt_dev
    ok = sum(1 for r in out if r.merge)
    log(f"device: {len(items)} reads in {dt_dev:.1f}s -> {dev_rps:.2f} reads/s "
        f"(merge {ok}/{len(items)}, stats {dev.stats})")
    pt = getattr(dev, "phase_times", {})
    if pt:
        log("phase split (last run): "
            f"seed {pt.get('seed', 0):.2f}s / walks {pt.get('walks', 0):.2f}s "
            f"({pt.get('gaps', 0)} gaps) / replay {pt.get('replay', 0):.2f}s")

    # baseline: the reference binary single-thread on the same data
    stride = os.path.join(REPO, ".refbuild", "stride")
    baseline_rps = None
    if os.path.exists(stride):
        refidx = ensure_ref_index(corpus, stride)
        refout = os.path.join(CACHE, "refout")
        os.makedirs(refout, exist_ok=True)
        bench_reads = os.path.join(CACHE, f"noisy_{N_BENCH}.fa")
        with open(bench_reads, "w") as f:
            for rid, seq in items:
                f.write(f">{rid}\n{seq}\n")
        # run three times; score the reference at its FASTEST (first run
        # warms the page cache; min-of-3 damps run-to-run noise and is the
        # conservative choice for vs_baseline)
        dt_ref = None
        for _ in range(3):
            t0 = time.time()
            subprocess.run(
                [stride, "pbcorrect", "-t", "1", "-p", refidx, "-o", refout,
                 "-c", str(COVERAGE), bench_reads],
                check=True, capture_output=True,
            )
            dt = time.time() - t0
            dt_ref = dt if dt_ref is None else min(dt_ref, dt)
        baseline_rps = len(items) / dt_ref
        log(f"reference binary (1 thread, warm): {len(items)} reads "
            f"in {dt_ref:.1f}s -> {baseline_rps:.2f} reads/s")
    else:
        host = SelfCorrector(hix, params)
        n_host = min(4, len(items))
        t0 = time.time()
        for rid, seq in items[:n_host]:
            host.process(rid, seq)
        baseline_rps = n_host / (time.time() - t0)
        log(f"host-python baseline: {baseline_rps:.2f} reads/s")

    print(json.dumps({
        "metric": "pbcorrect_reads_per_s_per_chip",
        "value": round(dev_rps, 3),
        "unit": f"reads/s (1.5kb 8%-err reads, {COVERAGE}x of {GENOME_LEN//1_000_000}Mb genome)",
        "vs_baseline": round(dev_rps / baseline_rps, 3),
    }))


if __name__ == "__main__":
    main()
