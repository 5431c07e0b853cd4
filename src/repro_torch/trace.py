"""Named spans and counters inside the build rounds and the beam loop.

`span(name)` marks a region of the program. While a `torch.profiler`
session records, it is a record function, so the span lands on the
profiler's timeline beside the device operations launched inside it, and a
trace can put each kernel down to the innermost span open at its launch
(the kernel's correlation id names its launch call on the host). It is the
fast record function of operator scope, a host event only: a user-scope
`torch.profiler.record_function` also mirrors its range onto the device's
timeline, where a reader that takes every device event for work would
count it. Otherwise the span is one shared null context: nothing is
allocated or recorded, and whether the profiler records is the only switch.

The names are the closed tuple `SPANS` (nested spans indented):

    grnnd.init        the random init (`pools.init_random`)
    grnnd.round       one (t1, t2) round of `grnnd.update_round`
      grnnd.propagate   the slot-pair draws and B1, or the sorted round
      pools.stage       staging the round's requests (`pools._stage`)
        pools.slice       one slice of destinations (`pools._stage`), only
                          in a staging of more than `pools.STAGE_BUDGET`
                          active requests
      pools.merge       the round's merge (`pools.merge_into`, B2)
    grnnd.reverse     one reverse-edge round (`pools.stage` ⊃ `pools.slice`,
                      `pools.merge` inside)
    search.step       one iteration of the beam loop, the last (breaking) one included
      search.frontier   the frontier mask, its test queued, and the host's wait
                        for the test one iteration back
      search.beam       the selection before the expand; the merge (which
                        carries the expanded flags) and the result heap after it
      search.expand     the neighbour gather and B3
      search.visited    the visited-set update

`count(site)` counts one pass of a site where the host waits for the card,
named in `SYNCS`:

    search.frontier   the wait for the event behind the frontier test one
                      iteration back (`search._LateTest`), once a loop
                      iteration (the first has none to wait for): it waits
                      for that test alone, and the step queued behind it
                      stays queued on the card
    search.entry      the entry row's gather by a 0-dim index, once a search:
                      the search's one wait that drains the stream
    grnnd.reverse     ρ made a device tensor, once a reverse-edge round
    pools.stage       the active requests counted (`torch.nonzero`), once a
                      staging; the slices' ranges read, once more a staging
                      of more than `pools.STAGE_BUDGET` active requests

`tally(name, k)` counts k events of the program (one by default), named in
`TALLIES`:

    pools/slices      one slice staged (`pools._stage`), only in a staging
                      of more than `pools.STAGE_BUDGET` active requests
    pools/requests    the requests of a staging (`pools._stage`), active or not
    pools/active      those of them staged: active and not self-inserts where
                      self-inserts are dropped. Over `pools/requests`, the
                      share of a batch that the staging sorts
    search/spare_steps  a beam step launched after the frontier emptied
                      (`search._traverse`): one a search, none where
                      `max_steps` cut it

`counts()` is one snapshot of the kernel launches (`kernels/_build.LAUNCHES`,
as `launch/<variant>`), of the sync counts (as `host_sync/<site>`) and of
the tallies (under their own names).
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import _build

SPANS = (
    "grnnd.init",
    "grnnd.round",
    "grnnd.propagate",
    "grnnd.reverse",
    "pools.stage",
    "pools.slice",
    "pools.merge",
    "search.step",
    "search.frontier",
    "search.beam",
    "search.expand",
    "search.visited",
)
SYNCS = ("search.frontier", "search.entry", "grnnd.reverse", "pools.stage")
TALLIES = ("pools/slices", "pools/requests", "pools/active", "search/spare_steps")

_NAMES = frozenset(SPANS)
_OFF = contextlib.nullcontext()

# site -> passes of its host sync since the process started (module-wide,
# like `_build.LAUNCHES`)
HOST_SYNCS: dict[str, int] = dict.fromkeys(SYNCS, 0)
# name -> events since the process started
EVENTS: dict[str, int] = dict.fromkeys(TALLIES, 0)


def span(name: str):
    """A context manager that marks `name` on the profiler's timeline while
    a profiler records, else the shared null context. Raises on a name not
    in `SPANS`."""
    if name not in _NAMES:
        raise ValueError(f"unknown span {name!r}: the names are {SPANS}")
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def count(site: str) -> None:
    """Count one pass of the host sync at `site` (one of `SYNCS`)."""
    HOST_SYNCS[site] += 1


def tally(name: str, k: int = 1) -> None:
    """Count `k` events `name` (one of `TALLIES`)."""
    EVENTS[name] += k


def counts() -> dict[str, int]:
    """The kernel launches, host syncs and tallies so far, in one snapshot."""
    out = {f"launch/{k}": v for k, v in _build.LAUNCHES.items()}
    out.update({f"host_sync/{k}": v for k, v in HOST_SYNCS.items()})
    out.update(EVENTS)
    return out
