"""Utilities: error taxonomy, logging, image IO."""
