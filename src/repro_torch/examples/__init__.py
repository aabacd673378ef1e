"""Runnable examples of the port, each run as
``python -m repro_torch.examples.<name>`` (on the card by default,
``--device cpu`` for the plain PyTorch path): ``quickstart``,
``tucker_compress``, ``complete_masked``, ``serve_pool``."""
