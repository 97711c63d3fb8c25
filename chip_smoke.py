"""GPU smoke test of the headline path, `pbcorrect --engine device`.

    python chip_smoke.py           # one card, phases 1-7 below
    python chip_smoke.py --multi   # four cards: 1-card run vs 4 ranks

One process holds the card and drives the CLI in-process
(`longreadselfcorrect_tpu.cli.main`) at E. coli scale: a seeded 4 Mb
random genome, 30x of 2 kb reads (120 M BWT symbols per strand) and 256
noisy 1.5 kb reads at 8% error (bench.py's generator, cached under
.bench_cache/).  Phases:

  1. device   JAX must report a GPU; prints the card's name and power limit
  2. build    make -C native (fmbuild, alnscore.so, hashorder.so)
  3. data     seeded corpus
  4. index    `cli index` through native SA-IS, packed for the device
  5. correct  `cli pbcorrect --engine device --batch-reads 256`, cold (compile
              included) then warm; reads/s, phase_times and counters
  6. oracle   the host engine on the first 16 reads: byte-equal records
  7. occ      slab occ on the card == rank.occ on the real index, exact

Any failure raises (non-zero exit, no result line).  The last line of
stdout is {"ok": true, "device": {"platform", "kind", "count"}}.

--multi runs only `pbcorrect --num-processes 4` (one process per card) and
the one-card run of the same command it must byte-equal; this process
never opens a card itself.
"""
from __future__ import annotations

import argparse
import functools
import io
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_ORACLE = 16
COUNTERS = ("prefetch_miss", "host_fallback", "fb_unfit", "fb_flagged",
            "fb_lastround")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def phase(n, name, t0, msg=""):
    print(f"phase {n} {name}: ok ({time.time() - t0:.1f}s){' ' + msg if msg else ''}",
          flush=True)


def build_native():
    subprocess.run(["make", "-C", os.path.join(REPO, "native")], check=True,
                   stdout=subprocess.DEVNULL)


def data_and_index(run_cli):
    """Phases 3-4 shared by both modes; run_cli(argv) drives the CLI."""
    import bench

    t0 = time.time()
    corpus, noisy = bench.ensure_corpus()
    phase(3, "data", t0, f"{corpus} + {noisy}")
    t0 = time.time()
    prefix = os.path.join(bench.CACHE, "smoke")
    from longreadselfcorrect_tpu.index import store

    if store.fmbuild_path() is None:
        raise RuntimeError("native/fmbuild missing after make")
    if not os.path.exists(prefix + store.NATIVE_SUFFIX):
        run_cli(["index", corpus, "-p", prefix])
    phase(4, "index", t0, prefix)
    return noisy, prefix


class _Tee(io.TextIOBase):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def write(self, s):
        self.a.write(s)
        return self.b.write(s)

    def flush(self):
        self.a.flush()


def cli_in_process(argv) -> str:
    """cli.main(argv) in this process; returns what it wrote to stderr."""
    from longreadselfcorrect_tpu import cli

    buf = io.StringIO()
    old = sys.stderr
    sys.stderr = _Tee(old, buf)
    try:
        rc = cli.main(argv)
    finally:
        sys.stderr = old
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} exited {rc}")
    return buf.getvalue()


def device_stats(stderr: str) -> dict:
    lines = [ln for ln in stderr.splitlines() if ln.startswith("device stats: ")]
    if len(lines) != 1:
        raise RuntimeError("pbcorrect printed no device stats line")
    return json.loads(lines[0][len("device stats: "):])


def fasta_records(path):
    """[(id, record text)] in file order."""
    out, rid, buf = [], None, []
    with open(path) as fh:
        for line in fh:
            if line.startswith(">"):
                if rid is not None:
                    out.append((rid, "".join(buf)))
                rid, buf = line[1:].split()[0], [line]
            else:
                buf.append(line)
    if rid is not None:
        out.append((rid, "".join(buf)))
    return out


def records_by_id(outdir):
    got = {}
    for name in ("correct.fa", "discard.fa"):
        for rid, text in fasta_records(os.path.join(outdir, name)):
            got.setdefault(rid, []).append((name, text))
    return got


def occ_parity(prefix):
    """Slab occ (every SB a walk config uses) vs rank.occ on the real index:
    random slot-0 intervals, queries at both interval ends, at every block
    edge inside and at random positions; exact integer equality."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from longreadselfcorrect_tpu.index.pack import open_index
    from longreadselfcorrect_tpu.ops import rank, walk

    hix, dix = open_index(prefix)
    fx = walk.FusedFM.from_index_set(dix, hix)
    rng = np.random.default_rng(7)
    B = fx.block
    checked = 0

    @functools.partial(jax.jit, static_argnames=("cfg", "rbwt_side"))
    def both(fx, fm, lo0, hi0, idx, cfg, rbwt_side):
        slab = walk._slab_fetch(fx, cfg, lo0, hi0, rbwt_side)
        got = walk._slab_occ_all(slab, idx)
        want = jnp.stack([rank.occ(fm, jnp.full(idx.shape, s, jnp.int32), idx)
                          for s in range(1, 5)], axis=-1)
        return slab[3], got, want

    for SB in (2, 3, 6):
        cfg = walk.WalkConfig(SLAB=True, SB=SB)
        for fm, rbwt_side in ((dix.bwt, False), (dix.rbwt, True)):
            n = fm.n
            lanes = 8192
            lo0 = rng.integers(0, n - 1, lanes)
            lo0[::4] = (lo0[::4] // B) * B
            # widest span that still fits: (hi0 + 1) // B - lo0 // B < SB
            width = rng.integers(0, SB * B - 1 - lo0 % B)
            hi0 = np.minimum(lo0 + width, n - 1)
            qs = [lo0 - 1, hi0]
            for k in range(SB + 1):
                edge = (lo0 // B + k) * B
                qs += [np.clip(edge - 1, lo0 - 1, hi0), np.clip(edge, lo0 - 1, hi0)]
            qs.append(lo0 - 1 + (rng.random(lanes) * (hi0 - lo0 + 2)).astype(np.int64))
            idx = np.stack(qs, axis=-1)
            ok, got, want = both(fx, fm, jnp.asarray(lo0, jnp.int32),
                                 jnp.asarray(hi0, jnp.int32),
                                 jnp.asarray(idx, jnp.int32), cfg, rbwt_side)
            if not bool(np.all(np.asarray(ok))):
                raise RuntimeError(f"SB={SB}: an in-span interval was refused")
            got, want = np.asarray(got), np.asarray(want)
            if not np.array_equal(got, want):
                bad = int(np.sum(np.any(got != want, axis=-1)))
                raise RuntimeError(f"SB={SB} rbwt={rbwt_side}: {bad} occ mismatches")
            checked += got.size
    return checked


def run_one_card():
    t0 = time.time()
    from longreadselfcorrect_tpu.jaxcache import configure_compile_cache

    cache = configure_compile_cache()
    import jax

    devs = jax.devices()
    print(f"devices: {devs}", flush=True)
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {d0.platform}")
    print(f"card: {card_line()}", flush=True)
    phase(1, "device", t0, f"compile cache {cache}")
    t0 = time.time()
    build_native()
    phase(2, "build", t0)
    noisy, prefix = data_and_index(cli_in_process)
    from longreadselfcorrect_tpu.index.pack import open_index

    open_index(prefix, device=False)  # pack + persist outside the timed runs

    import bench

    t0 = time.time()
    outs, stats, walls = [], [], []
    for tag in ("cold", "warm"):
        out = os.path.join(bench.CACHE, f"smoke_out_{tag}")
        ts = time.time()
        err = cli_in_process(["pbcorrect", noisy, "-p", prefix, "-o", out,
                              "-c", "30", "--engine", "device",
                              "--batch-reads", "256"])
        walls.append(time.time() - ts)
        outs.append(out)
        stats.append(device_stats(err))
    cold, warm = stats
    for name in ("correct.fa", "discard.fa"):
        with open(os.path.join(outs[0], name)) as a, open(os.path.join(outs[1], name)) as b:
            if a.read() != b.read():
                raise RuntimeError(f"{name}: cold and warm runs differ")
    ids = [rid for rid, _ in fasta_records(noisy)]
    got = records_by_id(outs[1])
    if sorted(got) != sorted(ids) or warm["reads"] != len(ids):
        raise RuntimeError("device output does not cover every input read")
    n_corr = sum(1 for v in got.values() if v[0][0] == "correct.fa")
    print(f"reads/s (warm, correction loop): {warm['reads'] / warm['seconds']:.3f} "
          f"({warm['reads']} reads in {warm['seconds']:.2f}s; {n_corr} corrected)")
    print(f"cold first run: {walls[0]:.1f}s wall, correction loop "
          f"{cold['seconds']:.1f}s (compiles included); warm run {walls[1]:.1f}s wall")
    print(f"phase_times (warm): {json.dumps(warm['phase_times'])}")
    print("counters (warm): " + json.dumps(
        {k: warm["counters"].get(k, 0) for k in COUNTERS}))
    phase(5, "correct", t0)

    t0 = time.time()
    sample = os.path.join(bench.CACHE, "smoke_oracle.fa")
    recs = fasta_records(noisy)[:N_ORACLE]
    with open(sample, "w") as out:
        out.write("".join(text for _, text in recs))
    host_out = os.path.join(bench.CACHE, "smoke_out_host")
    cli_in_process(["pbcorrect", sample, "-p", prefix, "-o", host_out,
                    "-c", "30", "--engine", "host"])
    want = records_by_id(host_out)
    diff = [rid for rid, _ in recs if want.get(rid) != got.get(rid)]
    for rid in diff:
        print(f"oracle mismatch {rid}: host {want.get(rid)} device {got.get(rid)}")
    if diff:
        raise RuntimeError(f"{len(diff)} of {N_ORACLE} reads differ from the host engine")
    phase(6, "oracle", t0, f"{N_ORACLE} reads byte-equal to the host engine")

    t0 = time.time()
    n = occ_parity(prefix)
    phase(7, "occ", t0, f"{n} slab occ values == rank.occ")
    return {"platform": d0.platform, "kind": d0.device_kind, "count": len(devs)}


def run_multi():
    """4 ranks (one process per card) vs a one-card run of the same command."""
    t0 = time.time()
    cards = card_line().splitlines()
    for c in cards:
        print(f"card: {c}", flush=True)
    if len(cards) < 4:
        raise SystemExit(f"--multi needs 4 cards, found {len(cards)}")
    phase(1, "device", t0)
    t0 = time.time()
    build_native()
    phase(2, "build", t0)

    def cli_cmd(argv):
        return [sys.executable, "-m", "longreadselfcorrect_tpu.cli"] + argv

    def run_cli(argv):
        subprocess.run(cli_cmd(argv), cwd=REPO, check=True, timeout=1800,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))

    noisy, prefix = data_and_index(run_cli)
    import bench

    base = ["pbcorrect", noisy, "-p", prefix, "-c", "30", "--engine", "device",
            "--batch-reads", "256"]
    t0 = time.time()
    single = os.path.join(bench.CACHE, "smoke_multi_1")
    subprocess.run(cli_cmd(base + ["-o", single]), cwd=REPO, check=True,
                   timeout=1800, env=dict(os.environ, CUDA_VISIBLE_DEVICES="0"))
    phase(5, "one-card run", t0)

    t0 = time.time()
    multi = os.path.join(bench.CACHE, "smoke_multi_4")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        cli_cmd(base + ["-o", multi, "--num-processes", "4", "--process-id",
                        str(r), "--coordinator", f"localhost:{port}"]),
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=1800)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    kinds = []
    for r, (p, e) in enumerate(zip(procs, errs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{e[-3000:]}")
        line = [ln for ln in e.splitlines() if ln.startswith("device engine on ")]
        print(f"rank {r}: {line[0] if line else 'no device line'}")
        kinds.append(line[0] if line else "")
    # "device engine on gpu (<kind>), 1 local device(s)"
    if not all(k.startswith("device engine on gpu (") and k.endswith(", 1 local device(s)")
               for k in kinds):
        raise RuntimeError("a rank did not run on exactly one GPU")
    for name in ("correct.fa", "discard.fa"):
        with open(os.path.join(single, name)) as a, open(os.path.join(multi, name)) as b:
            if a.read() != b.read():
                raise RuntimeError(f"{name}: 4-rank output differs from the one-card run")
    phase(6, "4 ranks", t0, "merged correct.fa/discard.fa byte-equal to one card")
    kind = kinds[0][len("device engine on gpu ("):-len("), 1 local device(s)")]
    return {"platform": "gpu", "kind": kind, "count": len(procs)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="4 cards: pbcorrect --num-processes 4 vs one card")
    args = ap.parse_args()
    device = run_multi() if args.multi else run_one_card()
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
