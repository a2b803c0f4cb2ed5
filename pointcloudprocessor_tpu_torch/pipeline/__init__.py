"""Ingest, keyframes, colorization and the pipeline runner."""
