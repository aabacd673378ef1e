"""Distributed HOOI: partitions, the rank mesh, the executor and
``dist_hooi``."""

from .mesh import RankMesh, make_ranks_mesh

__all__ = ["RankMesh", "make_ranks_mesh"]
