"""Demo scenes: geometry generators and the reference demo set."""

from .geometry import cube_mesh_data, instanced_grid_transforms, procedural_mesh_data, triangle_mesh_data

__all__ = ["cube_mesh_data", "instanced_grid_transforms", "procedural_mesh_data", "triangle_mesh_data"]
