"""Benchmark metrics (numpy, on the host): copies of the JAX package's."""
