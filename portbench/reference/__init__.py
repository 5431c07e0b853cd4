"""The plain reference of the benchmark: exact neighbours and distances
(`knn`) and the comparisons that decide `correct` (`judge`). Plain PyTorch;
it imports nothing of the program."""
