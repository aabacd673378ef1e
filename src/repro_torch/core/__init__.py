"""Host-side containers and the HOOI algorithm: COO tensors, TTM, Lanczos, HOOI."""
