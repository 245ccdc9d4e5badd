"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
and the dispatch shim (:mod:`repro_torch.kernels.ops`)."""
