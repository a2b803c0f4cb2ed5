"""Compute ops: z-buffer culling, NID joint-histogram kernels, fusion."""
