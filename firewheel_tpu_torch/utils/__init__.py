"""Host-side helpers copied from the JAX package (numpy only)."""
