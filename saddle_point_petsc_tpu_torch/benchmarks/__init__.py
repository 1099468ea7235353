"""The port's twins of the JAX repository's benchmarks/ scripts."""
