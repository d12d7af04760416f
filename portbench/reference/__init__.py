"""Plain references of the benchmark's configurations, in NumPy float64.

They import nothing of the port nor of the JAX package, and take nothing
the port made: the harness hands them the same inputs it hands the port.
"""
