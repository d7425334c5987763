"""Port of the JAX package's `analysis` modules (the analytic ones)."""
