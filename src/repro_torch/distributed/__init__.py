"""Multi-rank training on `torch.distributed`: int8 gradient compression,
the fault-tolerance control plane, mesh hints and the sharding rules."""
