"""One PyTorch intra-op thread per test process; every port test module
imports this.

The suite runs in several pytest-xdist worker processes at once. Left
alone, each process starts one intra-op thread per core, and on a machine
with about as many cores as workers the threads of one process spin on
their barriers while the other processes hold the cores, at every small
op. Six of the port's test files took 519 s under 6 workers on 8 cores,
and 92 s with one thread per process. No comparison depends on it: every
one runs inside one process, at one thread count.
"""
import torch

torch.set_num_threads(1)
