"""Hand-written kernels (CUDA C++ in csrc/) with their plain versions,
plan builders and dispatch."""
