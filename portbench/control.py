"""Readings that the limits of `limits/<cell>.json` are set from.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 1

On the card, at the cell's own size, in one process (the kernels and the
card start once): for each seed, the cell's set-up, a short window, then
the numbers the check compares, once for what the program produced and
once for the control, the plain reference in bfloat16 put in the program's
place. One JSON line a seed, then one with the largest reading of the
program and the smallest of the control for each number. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, seconds: float, device) -> dict:
    """{"program": numbers, "control": numbers} of one seed."""
    import torch

    from portbench import harness

    driver = harness.load_module(cell.driver_path)
    run = harness.Run(cell, seed, seconds, False, device)
    st = driver.prepare(run)
    run.measure(lambda: driver.unit(run, st))
    ans = driver.answers(run, st)
    program = driver.judge(run, st, ans)
    del ans
    ctl = driver.control(run, st)
    control = driver.judge(run, st, ctl)
    del ctl, st
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return {"program": program, "control": control, "units": run.counts}


def summary(rows: list[dict], limits: dict) -> dict:
    """Per number: the program's worst reading and the control's best (by the
    number's own sense of better), beside the limit."""
    out = {}
    for name, lim in limits.items():
        prog = [r["program"][name] for r in rows]
        ctl = [r["control"][name] for r in rows]
        worst, best = (max, min) if lim["better"] == "lower" else (min, max)
        out[name] = {"program_worst": worst(prog), "control_best": best(ctl),
                     "limit": lim["limit"], "better": lim["better"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch

    from portbench import harness
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(spec, args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = {"cell": args.workload, "seed": seed, **readings(cell, seed, args.seconds, "cuda")}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"cell": args.workload, "summary": summary(rows, cell.limits)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
