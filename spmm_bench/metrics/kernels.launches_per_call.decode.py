"""Kernels, in the decode cells (it moves ``gflops.decode``): read as
``kernels.launches_per_call``."""

from spmm_bench import spec

read = spec.reader("kernels.launches_per_call")
