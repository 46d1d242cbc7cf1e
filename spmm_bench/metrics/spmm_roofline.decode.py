"""Kernels, in the decode cells (it moves ``gflops.decode``): read as
``spmm_roofline``."""

from spmm_bench import spec

read = spec.reader("spmm_roofline")
