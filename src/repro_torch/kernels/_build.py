"""Build, load and launch the hand-written CUDA kernels.

Each source in `csrc/` is compiled at first use, one `nvcc` process per
source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch_kernels/<name>-<hash>.so

into `build/repro_torch_kernels/` at the repository root, and loaded with
`ctypes`. Each library exports plain C launch functions that take device
pointers and a stream and return the launch's `cudaError_t`. The file name
carries a hash of the sources and flags, so an edited source is rebuilt and
a finished build is reused. `nvcc` is taken from `$CUDA_HOME/bin` (default
`/usr/local/cuda`) or the PATH.

`launch` is the one place a kernel is started: it raises on a non-zero
error code and counts the launch in `LAUNCHES` under the variant's name:
the kernel's name, then `/bf16` or `/int8` for a quantized storage rung,
`+valid` for the tombstone mask and `+filter` for the label predicate
(`search_expand/int8+valid+filter`); the beam merge that carries the
expanded flags counts as `topr_merge/flags`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("gather_l2", "pairwise_l2", "rng_round", "search_expand", "topr_merge", "visited_insert")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

# kernel variant name -> launches since the last reset (module-wide, like
# the backend selection in ops.py); a variant enters at its first launch
LAUNCHES: dict[str, int] = {}

# element type codes of the C launch functions' `dtype` argument
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
STORED = tuple(DTYPE_CODES)  # the stored element types every row kernel takes
_RUNG = {torch.float32: "", torch.bfloat16: "bf16", torch.int8: "int8"}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on the PATH")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, float]:
    """Compile every missing library in parallel; returns seconds per source
    (0.0 for one already built). The ptxas report lands beside each library
    as `<name>-<hash>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {name: _target(name) for name in SOURCES if not _target(name).exists()}
    if not todo:
        return dict.fromkeys(SOURCES, 0.0)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    secs = dict.fromkeys(SOURCES, 0.0)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def ptxas_report(name: str) -> str:
    """The compiler's register/shared-memory report for one source."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        path = _target(name)
        if not path.exists():
            build_all()
        _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]


def function(source: str, symbol: str, argtypes: tuple):
    """A launch function of one library, with its argument types declared
    (pointers and the stream as c_void_p, so ctypes does not cut them to 32
    bits)."""
    key = f"{source}:{symbol}"
    if key not in _fns:
        fn = getattr(_lib(source), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def variant(kernel: str, *dtypes: torch.dtype, valid: bool = False, filter: bool = False) -> str:
    """The launch-count name of a kernel variant: `kernel`, then the
    quantized rungs among `dtypes` (`/int8`, `/bf16+int8`), then `+valid`,
    then `+filter`."""
    rungs = sorted({_RUNG[t] for t in dtypes} - {""})
    name = kernel + ("/" + "+".join(rungs) if rungs else "")
    return name + ("+valid" if valid else "") + ("+filter" if filter else "")


def launch(kernel: str, fn, *args) -> None:
    """Call a C launch function; raise on a CUDA error, else count it."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError_t {err}")
    LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1


def check(kernel: str, device: torch.device, **tensors):
    """Raise unless every tensor is a contiguous tensor on `device` (a CUDA
    device) whose dtype is the given one (or one of a given tuple). A
    (None, ...) entry is an absent optional operand and passes."""
    if device.type != "cuda":
        raise ValueError(f"{kernel}: the CUDA kernel needs CUDA tensors, got {device}")
    for name, (t, dtype) in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
        if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
            raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def check_dequant(kernel: str, data: torch.Tensor, scale, offset) -> None:
    """scale/offset are both given (fp32, (D,)) or both None; a quantized
    rung without them only widens, as the plain version does."""
    if (scale is None) != (offset is None):
        raise ValueError(f"{kernel}: give both scale and offset, or neither")
    if scale is not None:
        check(kernel, data.device, scale=(scale, torch.float32), offset=(offset, torch.float32))
        if scale.shape != (data.shape[1],) or offset.shape != (data.shape[1],):
            raise ValueError(f"{kernel}: scale/offset must be ({data.shape[1]},)")


def ptr(t) -> int | None:
    """Device pointer of an optional operand (None -> a null pointer)."""
    return None if t is None else t.data_ptr()
