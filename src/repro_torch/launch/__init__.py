"""Launchers of the port (PyTorch port of ``repro.launch``): the serving
and training CLIs; the production meshes (``mesh``) and multi-host set-up
(``multihost``); the dry run over a fake process group (``dryrun``,
``dryrun_solver``), its counter (``flops``), tables (``report``) and
collective histogram (``collective_histogram``)."""
