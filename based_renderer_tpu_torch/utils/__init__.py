"""Utilities: error taxonomy, image IO, profiling and the build caches."""
