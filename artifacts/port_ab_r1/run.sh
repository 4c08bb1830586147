#!/usr/bin/env bash
# Parent against change on one card: PARENT_TREE and CHANGE_TREE are
# unpacked checkouts of the two commits (git archive), each run by SCRIPT
# (default artifacts/port_ab_r1/ab_one.py: chip_smoke phases 6a, 6b, 8 and 12)
# in ROUNDS rounds (default 1) of parent, change, change, parent; each
# side's log goes to OUT_DIR/ab_<i>_<side>.txt and the AB lines are printed.
#
# Usage: artifacts/port_ab_r1/run.sh PARENT_TREE CHANGE_TREE OUT_DIR [SCRIPT [ROUNDS]]
set -uo pipefail
here="$(cd "$(dirname "$0")" && pwd)"
parent="$(cd "$1" && pwd)" change="$(cd "$2" && pwd)"
mkdir -p "$3"
out="$(cd "$3" && pwd)"
script="$(cd "$(dirname "${4:-$here/ab_one.py}")" && pwd)/$(basename "${4:-$here/ab_one.py}")"
rounds="${5:-1}"
i=0
for _ in $(seq "$rounds"); do
  for side in parent change change parent; do
    i=$((i + 1))
    tree=$parent
    [ "$side" = change ] && tree=$change
    (cd "$tree" && python3 "$script") > "$out/ab_${i}_${side}.txt" 2>&1 || echo "side $i $side failed"
  done
done
grep -h "^AB " "$out"/ab_*.txt
