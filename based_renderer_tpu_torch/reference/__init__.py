"""CPU golden-oracle rasterizer (numpy) for bit-identity testing."""

from .oracle import rasterize, rasterize_msaa4

__all__ = ["rasterize", "rasterize_msaa4"]
