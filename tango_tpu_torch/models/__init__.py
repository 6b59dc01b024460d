"""Models of the port (NCHW inside, JAX layouts at the public forward)."""
