"""Walk-engine timing on the GPU: the queue round and one superstep.

    python tools/prof_superstep.py

Uses bench.py's corpus and the smoke's index (built on first use), runs the
device seed scan + walk enumeration of the 256 noisy reads, then times

* the queue round: walk.queue_run over the low-K and primary banks (the
  queue engine's share of a pbcorrect round), median of 3 after a warm-up;
* one superstep at G lanes (a 96-step minus a 32-step chain, / 64);
* the seed table kernel (scan.kmer_table_full) on one 64-read chunk.

Prints one JSON line per measurement.
"""
import functools
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def timed(fn, reps=3):
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), ts


def main():
    from longreadselfcorrect_tpu.jaxcache import configure_compile_cache

    configure_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from longreadselfcorrect_tpu.core import alphabet as ab
    from longreadselfcorrect_tpu.core.batch_correct import BatchedSelfCorrector
    from longreadselfcorrect_tpu.core.correct import CorrectionParams
    from longreadselfcorrect_tpu.index.pack import open_index
    from longreadselfcorrect_tpu.io import fasta
    from longreadselfcorrect_tpu.ops import scan, walk

    d0 = jax.devices()[0]
    if d0.platform != "gpu":
        sys.exit(f"needs a GPU, JAX runs on {d0.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": d0.device_kind, "card": card}), flush=True)

    corpus, noisy = bench.ensure_corpus()
    prefix = os.path.join(bench.CACHE, "smoke")
    from longreadselfcorrect_tpu.index import store

    if not os.path.exists(prefix + store.NATIVE_SUFFIX):
        from longreadselfcorrect_tpu import cli

        subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                       check=True, stdout=subprocess.DEVNULL)
        cli.main(["index", corpus, "-p", prefix])
    hix, dix = open_index(prefix)
    params = CorrectionParams(pb_coverage=bench.COVERAGE, genome=10)
    bc = BatchedSelfCorrector(hix, dix, params)
    items = [(r.id, r.seq) for r in fasta.read_seqs(noisy)]
    per_read = []
    for _, chunk, seeds_lists in bc._device_seed_scan(items):
        for (rid, seq), seeds in zip(chunk, seeds_lists):
            per_read.append((rid, seq, seeds))
    tasks, _ = bc._enumerate_walks(per_read)
    small_lo, small, big, huge, deep, dense = bc._route(tasks)
    print(json.dumps({"tasks": len(tasks), "small_lo": len(small_lo),
                      "small": len(small), "big": len(big), "huge": len(huge),
                      "deep": len(deep), "dense": len(dense)}), flush=True)
    banks = []
    for sel, cfg in ((small_lo, bc.cfg_lo), (small, bc.cfg)):
        chunk = [tasks[i] for i in sorted(sel, key=lambda i: tasks[i].dis)]
        if chunk:
            banks.append((cfg, chunk))
    # superstep lanes: G tasks from the middle of the busier bank
    step_cfg, step_tasks = max(banks, key=lambda b: len(b[1]))
    step_tasks = step_tasks[len(step_tasks) // 2:][: step_cfg.G]

    # one 64-read seed chunk, as _seed_submit pads it
    R = 64
    L = 256 * ((max(len(s) for _, s in items) + 255) // 256)
    mat = np.full((R, L), ab.PAD_RANK, np.int8)
    lens = np.zeros(R, np.int32)
    for i, (_, seq) in enumerate(items[:R]):
        e = ab.encode(seq)
        mat[i, : len(e)] = e
        lens[i] = len(e)
    dmat, dlens = jnp.asarray(mat), jnp.asarray(lens)
    max_k = bc.probe_params.kmer_len_up_bound + 1

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def steps(wx, consts, st, n, cfg):
        return jax.lax.fori_loop(
            0, n, lambda _, s: walk.superstep(wx, consts, s, cfg), st)

    rec = {}
    t0 = time.perf_counter()
    built = [(cfg, walk.build_bank(hix, chunk, cfg, params.error_rate,
                                   params.pb_coverage, dev_ix=bc.wx,
                                   T=walk._quant_t(len(chunk))), len(chunk))
             for cfg, chunk in banks]

    def round_():
        return [walk.queue_run(bc.wx, bank, jnp.int32(n), cfg, 4096, 1 << 18)
                for cfg, bank, n in built]

    outs = jax.block_until_ready(round_())
    rec["queue_first_s"] = time.perf_counter() - t0
    rec["queue_s"], rec["queue_runs_s"] = timed(round_)
    rec["queue_steps"] = [int(o[0]) for o in outs]

    consts, st = walk.build_batch(hix, step_tasks, step_cfg,
                                  params.error_rate, params.pb_coverage,
                                  dev_ix=bc.wx)
    st = jax.block_until_ready(steps(bc.wx, consts, st, jnp.int32(20), step_cfg))
    t32, _ = timed(lambda: steps(bc.wx, consts, st, jnp.int32(32), step_cfg))
    t96, _ = timed(lambda: steps(bc.wx, consts, st, jnp.int32(96), step_cfg))
    rec["superstep_ms"] = (t96 - t32) / 64 * 1e3
    rec["superstep_G"] = step_cfg.G

    jax.block_until_ready(scan.kmer_table_full(dix, dmat, dlens, max_k))
    rec["seed_table_s"], _ = timed(
        lambda: scan.kmer_table_full(dix, dmat, dlens, max_k))
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
