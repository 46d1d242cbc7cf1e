"""Examples of the port, each runnable as a module."""
