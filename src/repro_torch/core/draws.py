"""The build's random draws, through one seam.

The JAX package draws with `jax.random` (threefry), which `torch.Generator`
cannot reproduce. So every random number of a build comes from a `Draws`:

  * `init_ids(n, s)`: the (N, S) raw ids of the random S-NN init, uniform
    in [0, N-1) (`repro/core/pools.py::init_random`);
  * `slot_pairs(t1, t2, chunk, c, r, p)`: the (C, P) sampled slot indices
    si, sj in [0, R) of one chunk of one propagation round
    (`repro/core/grnnd.py::_sample_slot_pairs`); `chunk` is None when the
    round runs in one piece;
  * `localized_pairs(round_no, f, r, p)`: the (F, P) slot pairs of the
    dynamic index's localized round number `round_no` (counted over the
    index's life) over an F-row frontier. The JAX index draws them from its
    key, split once per round (`repro/core/dynamic.py::_fold_key`);
  * `partition(s)`: the `Draws` of partition s's own build in the
    divide-and-conquer build (`repro/core/corpus_shard.py::sharded_build`,
    `fold_in(key, s)`);
  * `cross_raw(t, n, c)`: merge round t's (N, c) raw int32 draws, uniform
    in [0, 2^31 - 1), which `corpus_shard._cross_candidates` wraps into
    other shards' ids;
  * `merge_pairs(t, f, r, p)`: the (F, P) slot pairs of merge round t's
    localized round (`fold_in(kt, 1)`);
  * `shard_slot_pairs(t1, t2, rank, c, r, p)`: the (C, P) slot pairs of one
    rank's vertex slice in round (t1, t2) of the vertex-sharded build
    (`repro/core/distributed.py::make_sharded_builder`, `fold_in(key, rank)`).

`Draws` derives a fresh generator from (seed, tag) for every call, so it is
stateless: two builds with the same `Draws` see the same numbers. Tests
hand the reference's own draws to `RecordedDraws`.
"""

from __future__ import annotations

import numpy as np
import torch


class Draws:
    """Seeded draws from `torch.Generator`s on `device`."""

    def __init__(self, seed: int = 0, device: str | torch.device = "cuda"):
        self.seed = int(seed)
        self.device = torch.device(device)

    def _gen(self, *tag: int) -> torch.Generator:
        state = np.random.SeedSequence([self.seed, *tag]).generate_state(2, np.uint64)
        return torch.Generator(self.device).manual_seed(int(state[0] >> np.uint64(1)))

    def _randint(self, hi: int, shape: tuple[int, ...], *tag: int) -> torch.Tensor:
        return torch.randint(
            0, hi, shape, generator=self._gen(*tag), device=self.device, dtype=torch.int32
        )

    def init_ids(self, n: int, s: int) -> torch.Tensor:
        return self._randint(n - 1, (n, s), 0)

    def slot_pairs(self, t1: int, t2: int, chunk: int | None, c: int, r: int, p: int):
        tag = (1, t1, t2, 0 if chunk is None else chunk + 1)
        return (
            self._randint(r, (c, p), *tag, 0),
            self._randint(r, (c, p), *tag, 1),
        )

    def localized_pairs(self, round_no: int, f: int, r: int, p: int):
        return (
            self._randint(r, (f, p), 2, round_no, 0),
            self._randint(r, (f, p), 2, round_no, 1),
        )

    def partition(self, s: int) -> Draws:
        state = np.random.SeedSequence([self.seed, 3, s]).generate_state(1, np.uint32)
        return Draws(int(state[0]), self.device)

    def cross_raw(self, t: int, n: int, c: int) -> torch.Tensor:
        return self._randint(2**31 - 1, (n, c), 4, t)

    def merge_pairs(self, t: int, f: int, r: int, p: int):
        return self._randint(r, (f, p), 5, t, 0), self._randint(r, (f, p), 5, t, 1)

    def shard_slot_pairs(self, t1: int, t2: int, rank: int, c: int, r: int, p: int):
        tag = (6, t1, t2, rank)
        return self._randint(r, (c, p), *tag, 0), self._randint(r, (c, p), *tag, 1)


def _int32(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.int32))


def _recorded(table: dict, key, shape: tuple[int, int]):
    si, sj = table[key]
    if si.shape != shape:
        raise ValueError(f"recorded slot pairs {key} are {tuple(si.shape)}, wanted {shape}")
    return si, sj


class RecordedDraws(Draws):
    """Draws given up front: `init` (N, S), `pairs[(t1, t2, chunk)] = (si, sj)`,
    `localized[round_no] = (si, sj)`, `partitions[s]` (a `Draws`),
    `cross[t]` (N, c), `merge[t] = (si, sj)` and
    `shard_pairs[(t1, t2, rank)] = (si, sj)`; a draw that was not given
    raises."""

    def __init__(
        self,
        init=None,
        pairs: dict | None = None,
        localized: dict | None = None,
        partitions: dict | None = None,
        cross: dict | None = None,
        merge: dict | None = None,
        shard_pairs: dict | None = None,
    ):
        self.init = None if init is None else _int32(init)
        self.pairs = {k: tuple(map(_int32, v)) for k, v in (pairs or {}).items()}
        self.localized = {k: tuple(map(_int32, v)) for k, v in (localized or {}).items()}
        self.partitions = dict(partitions or {})
        self.cross = {k: _int32(v) for k, v in (cross or {}).items()}
        self.merge = {k: tuple(map(_int32, v)) for k, v in (merge or {}).items()}
        self.shard_pairs = {k: tuple(map(_int32, v)) for k, v in (shard_pairs or {}).items()}

    def init_ids(self, n: int, s: int) -> torch.Tensor:
        if self.init is None or self.init.shape != (n, s):
            got = None if self.init is None else tuple(self.init.shape)
            raise ValueError(f"recorded init ids are {got}, wanted {(n, s)}")
        return self.init

    def slot_pairs(self, t1: int, t2: int, chunk: int | None, c: int, r: int, p: int):
        return _recorded(self.pairs, (t1, t2, chunk), (c, p))

    def localized_pairs(self, round_no: int, f: int, r: int, p: int):
        return _recorded(self.localized, round_no, (f, p))

    def partition(self, s: int) -> Draws:
        return self.partitions[s]

    def cross_raw(self, t: int, n: int, c: int) -> torch.Tensor:
        raw = self.cross[t]
        if raw.shape != (n, c):
            raise ValueError(f"recorded cross draws {t} are {tuple(raw.shape)}, wanted {(n, c)}")
        return raw

    def merge_pairs(self, t: int, f: int, r: int, p: int):
        return _recorded(self.merge, t, (f, p))

    def shard_slot_pairs(self, t1: int, t2: int, rank: int, c: int, r: int, p: int):
        return _recorded(self.shard_pairs, (t1, t2, rank), (c, p))
