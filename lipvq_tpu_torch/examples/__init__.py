"""End-to-end examples of the port (twins of the JAX package's ``examples/``)."""
