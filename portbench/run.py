"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA card. Set-up
(counted in `setup_s` from the start of this process), then the measured
window of `--seconds`, then the check against the plain reference. The last
line of standard output is the result as one JSON object; the compared
numbers beside their limits are the last lines of standard error. With
`--trace 1` the window runs under `torch.profiler` and the result carries
the per-layer metrics, the device's busy seconds and a breakdown.

Exits non-zero, printing no result, without a card, when the JAX package or
JAX was loaded, and where the program's sources are not in the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of a run stays at a fixed place inside the checkout
    cache = ROOT / "build" / "portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    import torch

    from portbench import harness

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.find(spec["workloads"], args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    run = harness.Run(harness.Cell(spec, args.workload), args.seed, args.seconds,
                      bool(args.trace), "cuda", T0)
    out = harness.execute(run)
    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    sys.stderr.write("\n".join([harness.window_line(run), *harness.check_lines(out)]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
