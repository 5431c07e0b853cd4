"""The benchmark of the PyTorch and CUDA port (`repro_torch`): one command
runs one cell once (`run.py`); `BENCHMARK.json` at the repository's root
names the cells, configurations and metrics."""
