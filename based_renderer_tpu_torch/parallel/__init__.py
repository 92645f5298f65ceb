"""Multi-device rendering over torch.distributed device meshes."""

from .tiled import TiledRenderer, merge_vis_over_axis

__all__ = ["TiledRenderer", "merge_vis_over_axis"]
