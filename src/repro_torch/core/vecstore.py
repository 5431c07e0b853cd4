"""VectorStore: the precision ladder for dataset vectors.

A port of the JAX package's `core/vecstore.py` up to `precision_of`. Every
distance of the build, the search and the dynamic index reads rows of the
(N, D) dataset, and on the card those reads are what bounds the kernels, so
the storage precision caps build size and query rate. A `VectorStore` holds
the vectors at one of three rungs:

  * ``fp32`` — the exact baseline (a plain tensor wrapped unchanged);
  * ``bf16`` — 2 bytes a dimension; the kernels widen to fp32 on load;
  * ``int8`` — 1 byte a dimension, per-dimension affine quantization with
    (scale, offset) taken from the corpus at encode time:

        q = clip(round((x - offset) / scale), -127, 127)     stored int8
        x̂ = q · scale + offset                               dequant

    The dequant is fused into the kernels (`kernels/ref.py::dequant_rows`
    is the one formula, computed bitwise alike by kernel and plain
    version); the (N, D) fp32 matrix never exists on the hot path.

Exact results come back through the fp32 rescore of `core/search.py`
(`rescore=`): the final ef candidates are re-ranked against fp32 rows.

Every helper below takes a store or a plain (N, D) tensor, so the build and
search layers accept either.

`HostTier` places the fp32 rescore tier in host memory (pinned when the
card is in use), leaving the card only the traversal tier: the search
gathers the final ef candidates' rows on the host and ships only those.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.kernels.ops import parts  # noqa: F401  (one duck-typer for both layers)
from repro_torch.kernels.ref import dequant_rows

PRECISIONS = ("fp32", "bf16", "int8")

# int8 quantization range: symmetric ±127 around the per-dimension midpoint
_QLEVELS = 254.0

_STORED = (torch.float32, torch.bfloat16, torch.int8)


class VectorStore(NamedTuple):
    """Dataset vectors at one rung of the precision ladder.

    data   (N, D) float32 | bfloat16 | int8
    scale  (D,)   float32 — per-dimension dequant scale; None on float rungs
    offset (D,)   float32 — per-dimension dequant offset; None on float rungs
    """

    data: torch.Tensor
    scale: torch.Tensor | None = None
    offset: torch.Tensor | None = None

    @property
    def precision(self) -> str:
        if self.data.dtype == torch.int8:
            return "int8"
        if self.data.dtype == torch.bfloat16:
            return "bf16"
        return "fp32"

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        return self.data.shape[1]

    @property
    def shape(self) -> tuple[int, ...]:
        """Logical (N, D), so store-aware callers keep tensor idiom."""
        return tuple(self.data.shape)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def bytes_per_vector(self, include_overhead: bool = False) -> float:
        """Storage bytes per row; the overhead is the shared (D,) scale and
        offset amortized over N."""
        per_row = self.dim * self.data.element_size()
        if include_overhead and self.scale is not None:
            per_row += 8.0 * self.dim / max(self.n, 1)
        return float(per_row)

    def dequant(self) -> torch.Tensor:
        """Full (N, D) fp32 view (entry-point selection, one-shot uses)."""
        return dequant_rows(self.data, self.scale, self.offset)

    def take(self, idx: torch.Tensor) -> torch.Tensor:
        """Gather rows by index (any index shape) -> fp32, dequantized."""
        return dequant_rows(self.data[idx.long()], self.scale, self.offset)

    def quantize_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Encode fp32 rows with this store's frozen parameters; values
        outside the encode-time range clip to its edge."""
        if self.scale is None:
            return x.to(self.data.dtype)
        q = torch.round((x.float() - self.offset) / self.scale)
        return q.clamp(-127.0, 127.0).to(torch.int8)

    def requant(self, x: torch.Tensor) -> torch.Tensor:
        """Round-trip fp32 rows through this store: the values the kernels
        would see if the rows were stored."""
        return dequant_rows(self.quantize_rows(x), self.scale, self.offset)

    def with_rows(self, idx: torch.Tensor, x: torch.Tensor) -> VectorStore:
        """Set rows `idx` to the encoded fp32 rows `x`. Unlike the JAX
        package's functional update this writes `data` in place (a 2^20-row
        store is not copied per insert) and returns the store."""
        self.data[idx.long()] = self.quantize_rows(x)
        return self


def quantize_int8(x: torch.Tensor) -> VectorStore:
    """Per-dimension affine int8 quantization of an (N, D) fp32 corpus.

    scale/offset come from the per-dimension [min, max], so the corpus is in
    range and |x - x̂| <= scale / 2. A constant dimension gets scale 1 (q = 0,
    x̂ = offset, no error). An empty (0, D) corpus gets scale 1 and offset 0.
    """
    x = x.float()
    n, d = x.shape
    if n == 0:
        return VectorStore(
            torch.zeros((0, d), dtype=torch.int8, device=x.device),
            torch.ones((d,), dtype=torch.float32, device=x.device),
            torch.zeros((d,), dtype=torch.float32, device=x.device),
        )
    lo = x.min(0).values
    hi = x.max(0).values
    offset = lo + (hi - lo) * 0.5
    scale = torch.where(hi > lo, (hi - lo) / _QLEVELS, 1.0)
    q = torch.round((x - offset) / scale).clamp(-127.0, 127.0)
    return VectorStore(q.to(torch.int8), scale, offset)


def encode(x: torch.Tensor, precision: str) -> VectorStore:
    """Encode an (N, D) corpus at the given precision rung."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision == "int8":
        return quantize_int8(x)
    if precision == "bf16":
        return VectorStore(x.to(torch.bfloat16))
    return VectorStore(x.float())


# -- store-or-tensor helpers (the build and search layers accept either) ----


def as_store(x) -> VectorStore:
    return x if isinstance(x, VectorStore) else VectorStore(x)


def nrows(x) -> int:
    return x.shape[0]


def dim(x) -> int:
    return x.shape[1]


def take(x, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows -> fp32 (dequantized for stores, widened for tensors)."""
    if isinstance(x, VectorStore):
        return x.take(idx)
    return x[idx.long()].float()


def dequant(x) -> torch.Tensor:
    """(N, D) fp32 view of a store or tensor."""
    if isinstance(x, VectorStore):
        return x.dequant()
    return x.float()


def precision_of(x) -> str:
    return as_store(x).precision


def to_device(x, dev: torch.device):
    """The dataset operand on `dev`, contiguous: a store keeps its rung (and
    fp32 scale/offset); a bf16 or int8 tensor keeps its dtype; anything
    else (arrays, other dtypes) becomes an fp32 tensor."""
    if isinstance(x, VectorStore):
        return VectorStore(
            x.data.to(dev).contiguous(),
            None if x.scale is None else _device.put(x.scale, torch.float32, dev),
            None if x.offset is None else _device.put(x.offset, torch.float32, dev),
        )
    if isinstance(x, torch.Tensor) and x.dtype in _STORED:
        return x.to(dev).contiguous()
    return _device.put(x, torch.float32, dev)


# -- tier placement: traversal tier on the card, rescore tier on the host ---

PLACEMENTS = ("device", "host")


class HostTier:
    """The fp32 rescore tier in host memory.

    Holds the pre-dequantized (N, D) fp32 rows on the CPU, pinned when the
    given rows lie on a CUDA device or are pinned already, so a gather's
    rows reach the card by a non-blocking copy. A CPU fp32 tensor is
    wrapped without a copy, so writes to it show through. The rows are those `VectorStore.take` gives on the card
    (the one `dequant_rows` formula), so the re-rank over them is bitwise
    that of the device tier.

    A plain class, not a tuple: the search tells it from a device operand
    with `is_host`. `gather` ships only the rows of real ids (id >= 0);
    `fetched_rows` counts them and `gather_seconds` sums the host clock of
    the gathers (the row gather on the host and the copy to the card).
    """

    def __init__(self, x):
        src = dequant(x) if isinstance(x, VectorStore) else x
        if not isinstance(src, torch.Tensor):
            src = _device.put(src, torch.float32, torch.device("cpu"))
        pin = src.device.type == "cuda" or (src.device.type == "cpu" and src.is_pinned())
        data = src.float().to("cpu").contiguous()
        if pin and not data.is_pinned():
            data = data.pin_memory()
        self.data = data
        self.fetched_rows = 0
        self.gather_seconds = 0.0

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        return self.data.shape[1]

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape)

    def device_bytes(self) -> int:
        """Card-resident bytes of this tier: none."""
        return 0

    def host_bytes(self) -> int:
        return self.data.numel() * self.data.element_size()

    def gather(self, ids: torch.Tensor) -> torch.Tensor:
        """fp32 rows (ids.shape + (D,)) for candidate ids, on ids' device.

        Only rows with id >= 0 are gathered on the host (`index_select`,
        into a pinned buffer when the tier is pinned) and copied over; pad
        slots come back as zero rows (the re-rank masks them by id)."""
        t0 = time.perf_counter()
        dev = ids.device
        flat = ids.reshape(-1)
        real = torch.nonzero(flat >= 0).squeeze(1)  # positions of real ids
        rows_idx = flat[real].to("cpu", torch.int64)
        pinned = self.data.is_pinned()
        rows = torch.empty((rows_idx.shape[0], self.dim), pin_memory=pinned)
        torch.index_select(self.data, 0, rows_idx, out=rows)
        out = torch.zeros((flat.shape[0], self.dim), dtype=torch.float32, device=dev)
        out[real] = rows.to(dev, non_blocking=pinned)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()  # `rows` may be reused after this
        self.fetched_rows += int(rows_idx.shape[0])
        self.gather_seconds += time.perf_counter() - t0
        return out.reshape(*ids.shape, self.dim)


def is_host(x) -> bool:
    """Placement probe: is this rescore operand the host tier?"""
    return isinstance(x, HostTier)
