"""The HOOI engine: Z-build and oracle stages, mode steps, the sweep loop."""
