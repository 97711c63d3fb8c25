#!/bin/bash
# Golden diff of `overlap -e RATE` (inexact LSSF FM-walk) vs the reference.
# usage: tools/golden_overlap_e.sh workdir [err] [minov] [maxindel]
set -e
DIR=$1; ERR=${2:-0.05}; MINOV=${3:-40}; MAXINDEL=${4:-2}
REPO=$(cd "$(dirname "$0")/.."; pwd)
STRIDE=$REPO/.refbuild/stride
mkdir -p "$DIR"; cd "$DIR"
export PYTHONPATH=$REPO

python - <<PYEOF
import numpy as np
rng = np.random.default_rng(77)
g = "".join(rng.choice(list("ACGT"), size=20000))
reads = []
for i, p in enumerate(range(0, len(g) - 100, 60)):
    r = list(g[p : p + 100])
    # plant a SNP in every third read, inside the overlap region
    if i % 3 == 1:
        j = 20 + (i * 7) % 60
        r[j] = "ACGT"["ACGT".index(r[j]) < 3 and "ACGT".index(r[j]) + 1 or 0]
    # plant a 1bp deletion / insertion in some reads (exercises -l)
    if i % 5 == 2:
        del r[30 + (i * 11) % 40]
    if i % 7 == 3:
        r.insert(35 + (i * 13) % 30, "ACGT"[i % 4])
    reads.append("".join(r))
# a few reads fully contained in others (substring/containment paths)
for i in (4, 40, 80):
    reads.append(reads[i][10:90])
with open("reads.fa", "w") as f:
    for i, r in enumerate(reads):
        f.write(f">r{i:05d}\n{r}\n")
print(len(reads), "reads")
PYEOF

echo "== reference"
$STRIDE index -a ropebwt2 -t 4 -p reads reads.fa > /dev/null 2>&1
$STRIDE overlap -m $MINOV -e $ERR -l $MAXINDEL reads.fa > ref.log 2>&1 || true
ls *.asqg.gz

echo "== ours"
python -m longreadselfcorrect_tpu.cli index reads.fa -p ours > /dev/null 2>&1
python -m longreadselfcorrect_tpu.cli overlap reads.fa -p ours \
    -m $MINOV -e $ERR -l $MAXINDEL -o ours.asqg.gz 2> ours.log

echo "== diff (reference ED records must all appear in ours)"
zcat reads-thread0.edges.gz | grep '^ED' | sort > ref.ed
zcat ours.asqg.gz | grep '^ED' | sort > ours.ed
wc -l ref.ed ours.ed
if cmp ref.ed ours.ed; then echo "OVERLAP -e GOLDEN OK (edge sets byte-identical)"; else
  echo "missing from ours:"; comm -23 ref.ed ours.ed | head -5
  echo "extra in ours:"; comm -13 ref.ed ours.ed | head -5
fi
