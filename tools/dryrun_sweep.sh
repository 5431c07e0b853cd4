#!/bin/bash
# The production-mesh dry-run sweep (`python -m repro_torch.launch.dryrun
# --all --include-grnnd --mesh both`), one process a cell, JOBS at a time
# (the prefill cells, the longest, first), each with one intra-op thread;
# then the `--all` run over the records they wrote, which prints the DONE
# line (a cell recorded `ok` or `skipped` is not traced again).
#
#     bash tools/dryrun_sweep.sh [JOBS] [OUT]     # from the repository root
#
# The LM cells trace on meta and need no card; the GRNND cells run on the
# card. Per-cell logs go to OUT/<arch>__<shape>__<mesh>.log.
JOBS=${1:-6}
OUT=${2:-chiprun_out/dryrun}
mkdir -p "$OUT"
export PYTHONPATH=src OMP_NUM_THREADS=1
t0=$(date +%s)
python3 - > "$OUT/cells.txt" <<'PY'
from repro_torch.configs import list_archs
from repro_torch.configs.base import SHAPES
from repro_torch.launch.specs import GRNND_SHAPES
order = {"prefill_32k": 0, "train_4k": 1, "decode_32k": 2, "long_500k": 3}
cells = [(a, s) for a in list_archs() for s in SHAPES] + [("grnnd-ann", s) for s in GRNND_SHAPES]
cells.sort(key=lambda c: order.get(c[1], 4))
for a, s in cells:
    for m in ("single", "multi"):
        print(a, s, m)
PY
export OUT
xargs -P "$JOBS" -L 1 sh -c 'log="$OUT/$0__$1__$2.log"; s=$(date +%s); timeout 2400 python3 -m repro_torch.launch.dryrun --arch $0 --shape $1 --mesh $2 --out "$OUT" > "$log" 2>&1; echo "$0 $1 $2 rc=$? $(( $(date +%s) - s ))s $(grep -a "^\[" "$log" | tail -1 | cut -c1-200)"' < "$OUT/cells.txt"
echo "[sweep] cells done in $(( $(date +%s) - t0 ))s"
timeout 900 python3 -m repro_torch.launch.dryrun --all --include-grnnd --mesh both --out "$OUT" | tail -2
echo "[sweep] wall $(( $(date +%s) - t0 ))s"
