"""Launchers: the training launcher (``python -m repro_torch.launch.train``),
the device meshes (``launch/mesh.py``) and the CPU ranks that stand in for
devices (``launch/hostdev.py``)."""
