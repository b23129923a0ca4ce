"""Hand-written Hopper kernels of the port (sources in `repro_torch/csrc/`)
and their plain PyTorch versions."""
