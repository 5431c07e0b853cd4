"""The five hand-written CUDA kernels of the build-and-search path, their
plain PyTorch versions (`ref.py`) and the dispatch surface (`ops.py`)."""
