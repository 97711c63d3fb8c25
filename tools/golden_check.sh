#!/bin/bash
# Golden parity check: our pipeline vs the reference stride binary.
# usage: tools/golden_check.sh reads.fa workdir [coverage]
set -e
READS=$1; DIR=$2; COV=${3:-30}
REPO=$(cd "$(dirname "$0")/.."; pwd)
STRIDE=$REPO/.refbuild/stride
mkdir -p "$DIR"; cd "$DIR"
export PYTHONPATH=$REPO

echo "== reference index + correction"
$STRIDE index -a ropebwt2 -t 4 -p refidx "$READS"
mkdir -p refout && $STRIDE pbcorrect -t 1 -p refidx -o refout -c "$COV" "$READS"

echo "== our index + correction"
python -m longreadselfcorrect_tpu.cli index "$READS" -p ours
python - <<PYEOF
import numpy as np, sys
sys.path.insert(0, "$REPO")
from longreadselfcorrect_tpu.index import store
a = store.load_reference_bwt("refidx.bwt"); b, _ = store.load_any("ours")
print("fwd BWT identical:", np.array_equal(a.symbols, b.symbols))
a = store.load_reference_bwt("refidx.rbwt"); _, b = store.load_any("ours")
print("rev BWT identical:", np.array_equal(a.symbols, b.symbols))
PYEOF
mkdir -p ourout
python -m longreadselfcorrect_tpu.cli pbcorrect "$READS" -p ours -o ourout \
    -c "$COV" --engine device

echo "== diff"
cmp refout/correct.fa ourout/correct.fa && echo "correct.fa BYTE-IDENTICAL" \
    || echo "correct.fa DIFFERS"
cmp refout/discard.fa ourout/discard.fa && echo "discard.fa BYTE-IDENTICAL" \
    || echo "discard.fa DIFFERS"
