"""Launchers of the port (PyTorch port of ``repro.launch``): the serving
and training CLIs; the JAX package's HLO dry-run tooling waits for its
slice."""
