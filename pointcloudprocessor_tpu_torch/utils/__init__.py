"""Config tree, profiling, numeric helpers and numpy interop."""
