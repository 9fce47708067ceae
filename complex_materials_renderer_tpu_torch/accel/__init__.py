"""Acceleration structures: the spatially clustered triangle grid and the
threaded BVH."""

from .bvh import FlatBVH, build_bvh
from .clusters import SUB_SIZE, SUPER_FACTOR, ClusterGrid, build_clusters

__all__ = ["ClusterGrid", "FlatBVH", "SUB_SIZE", "SUPER_FACTOR", "build_bvh", "build_clusters"]
