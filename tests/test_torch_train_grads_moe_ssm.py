"""The port's training loss and gradients against the JAX package's, on the
CPU: the MoE configs (with and without drops) and the SSM configs. The
check and its tolerances are `_torch_lm.check_loss_and_grads`'s, as in
`test_torch_train_grads.py`.

The MoE configs run without drops (capacity 16: 193 slots an expert for
the 96 assignments of 48 tokens) and with them (capacity 0.5: 8 slots an
expert, 64 in all for the 96 assignments). Autograd runs through the dispatch (the
stable argsort and `cummax` segment starts carry no gradient; the
`buf[slot] = xt[toks]` scatter, whose spare row takes the dropped tokens
and is cut off; the per-slot combine `out_e[slot_of[:, j]]`, where the
reference scatter-adds) and through `_ssd_chunked`'s chunk loop with its
masked `exp(where(causal, li, -1e30))`: every gradient leaf must be finite.
"""

import pytest
import torch

from _torch_lm import check_loss_and_grads

torch.set_num_threads(1)

NO_DROPS, DROPS = 16.0, 0.5
CASES = [("deepseek-moe-16b", NO_DROPS), ("deepseek-moe-16b", DROPS),
         ("qwen3-moe-235b-a22b", NO_DROPS), ("qwen3-moe-235b-a22b", DROPS),
         ("mamba2-130m", None), ("zamba2-7b", None)]


@pytest.mark.parametrize("name,capacity", CASES,
                         ids=[f"{n}-drops" if c == DROPS else n for n, c in CASES])
def test_loss_and_grads_match_reference(name, capacity):
    check_loss_and_grads(name, capacity)
