"""The port's hand-written CUDA kernels for Hopper, their plain PyTorch
versions (:mod:`~repro_torch.kernels.ref`) and the safe wrappers the rest
of the port calls (:mod:`~repro_torch.kernels.ops`)."""
