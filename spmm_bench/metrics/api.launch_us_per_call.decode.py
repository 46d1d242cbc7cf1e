"""API and served handle, in the decode cells (it moves ``gflops.decode``):
read as ``api.launch_us_per_call``."""

from spmm_bench import spec

read = spec.reader("api.launch_us_per_call")
