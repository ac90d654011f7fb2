"""The general part of the benchmark: finding a cell's files by name, the
inputs made from the seed, the device trace, the comparisons and the
result line."""
