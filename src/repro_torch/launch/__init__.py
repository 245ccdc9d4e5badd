"""Launchers: the training launcher (``python -m repro_torch.launch.train``)."""
