"""Entry points: ``python -m repro_torch.launch.train`` (the port of
``repro.launch.train``)."""
