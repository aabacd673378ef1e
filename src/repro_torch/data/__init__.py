"""Synthetic tensor generators (numpy, bitwise equal to the reference's)."""
