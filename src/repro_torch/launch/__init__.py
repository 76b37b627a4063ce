"""Entry points of the port run as programs: the simulation CLI
(``python -m repro_torch.launch.simulate``)."""
