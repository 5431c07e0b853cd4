"""Decoder-only language models: the dense text families of `configs`."""
