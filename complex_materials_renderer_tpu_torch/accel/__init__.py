"""Acceleration structure: the spatially clustered triangle grid."""

from .clusters import SUB_SIZE, SUPER_FACTOR, ClusterGrid, build_clusters

__all__ = ["ClusterGrid", "SUB_SIZE", "SUPER_FACTOR", "build_clusters"]
