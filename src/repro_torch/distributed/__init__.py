"""Distributed HOOI: partitions, the executor and ``dist_hooi``."""
