"""The port's versions of the JAX package's examples (examples/*.py)."""
