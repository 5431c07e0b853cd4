"""The hand-written CUDA kernels of the build, search and dynamic-index
paths, their plain PyTorch versions (`ref.py`) and the dispatch surface
(`ops.py`)."""
