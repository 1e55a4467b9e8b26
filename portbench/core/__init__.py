"""The frozen core of the benchmark: the cell's files, the traffic
generator, the window, the profiler window, the end-to-end arithmetic and
the comparison that decides ``correct``."""
