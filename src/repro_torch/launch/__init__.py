"""Entry points of the port run as programs (the simulation, serving and
training CLIs, ``python -m repro_torch.launch.<name>``), the meshes of
ranks, and the cost tools that count a step before it runs (``hlo``,
``build``, ``dryrun``, ``roofline``, ``flywire_dryrun``)."""
