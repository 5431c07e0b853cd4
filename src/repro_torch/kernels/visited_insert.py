"""The hashed visited set's insert on the card: one launch a beam step.

No Pallas counterpart: the JAX package inserts with a `fori_loop` over the
R columns (`src/repro/core/search.py::_table_insert`). CUDA tensors run the
hand-written kernel of `csrc/visited_insert.cu`; CPU tensors run
`ref.visited_insert_ref`, the column loop, and the table the kernel leaves
is bitwise the loop's.

Design: a query's columns depend on each other only through the table,
and the writes of earlier columns are known to the query's lanes as they
are made. So one 8-lane group a query loads its probe windows for 16
columns at once (lane l: slot l), then takes the columns in order in
registers: two ballots give found / empty, the first empty slot in probe
order takes the id, and each lane updates its loaded values of the later
columns whose slot was written. The 4 groups of a warp step through the
columns together. The next 16 columns' loads follow a warp barrier and go
through L2, so they see the writes: at R = 48 a query waits on 3 rounds of
loads, not 48.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P, _L, _I, _P, _I, _P)


def visited_insert(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Insert (Q, R) int32 ids into the (Q, H) int32 tables in place, column
    by column, as `ref.visited_insert_ref` does; returns `table`."""
    if table.device.type == "cpu":
        return ref.visited_insert_ref(table, ids)
    _build.check(
        "visited_insert", table.device, table=(table, torch.int32), ids=(ids, torch.int32)
    )
    if table.dim() != 2 or ids.dim() != 2 or ids.shape[0] != table.shape[0]:
        raise ValueError("visited_insert: table must be (Q, H) and ids (Q, R)")
    (q, h), r = table.shape, ids.shape[1]
    if h < 1:
        raise ValueError("visited_insert: the table needs at least one slot")
    fn = _build.function("visited_insert", "visited_insert_launch", _ARGS)
    _build.launch(
        "visited_insert",
        fn,
        table.data_ptr(),
        q,
        h,
        ids.data_ptr(),
        r,
        _build.stream_ptr(table.device),
    )
    return table
