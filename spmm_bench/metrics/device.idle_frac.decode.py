"""Device, in the decode cells (it moves ``gflops.decode``): read as
``device.idle_frac``."""

from spmm_bench import spec

read = spec.reader("device.idle_frac")
