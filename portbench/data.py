"""Traffic generation: the vectors, queries and seeds of a run.

No dataset file is in the repository, so a configuration's vectors are
drawn on the device as its `data` block says: a clustered Gaussian mixture
(`n_clusters` unit-normal centres, `cluster_std` around them) from the
data's own `seed`, so that every run holds the same set of vectors, as a
deployment holds one dataset; `--seed` orders them (`corpus`) and draws the
queries, near corpus points (`query_noise`). This is a frozen copy of the
program's `repro_torch.data.synthetic.vector_dataset` / `queries_from`
recipe.
"""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *tag: int) -> int:
    """A 63-bit seed for the part of a run named by `tag` (any size of
    `seed`)."""
    state = np.random.SeedSequence([int(seed) % (1 << 128), *tag]).generate_state(2, np.uint64)
    return int(state[0] >> np.uint64(1))


def generator(seed: int, device, *tag: int) -> torch.Generator:
    return torch.Generator(torch.device(device)).manual_seed(sub_seed(seed, *tag))


def corpus(seed: int, data: dict, d: int, n: int, device) -> torch.Tensor:
    """The configuration's n vectors (the same set for every run), in an order
    drawn from the run's `seed`."""
    g = generator(data["seed"], device, 0)
    x = points(g, data, centres(g, data, d), n)
    return x[torch.randperm(n, generator=generator(seed, device, 6), device=g.device)]


def centres(gen: torch.Generator, data: dict, d: int) -> torch.Tensor:
    return torch.randn((data["n_clusters"], d), generator=gen, device=gen.device)


def points(gen: torch.Generator, data: dict, c: torch.Tensor, n: int) -> torch.Tensor:
    """n rows of the mixture around the centres `c`, fp32."""
    assign = torch.randint(0, c.shape[0], (n,), generator=gen, device=gen.device)
    noise = torch.randn((n, c.shape[1]), generator=gen, device=gen.device)
    return c[assign] + data["cluster_std"] * noise


def queries_near(gen: torch.Generator, data: dict, x: torch.Tensor, q: int) -> torch.Tensor:
    """q queries, each a corpus row plus Gaussian noise."""
    idx = torch.randint(0, x.shape[0], (q,), generator=gen, device=gen.device)
    noise = torch.randn((q, x.shape[1]), generator=gen, device=gen.device)
    return x[idx] + data["query_noise"] * noise
