"""Host-side readers and writers (numpy; no jax)."""
