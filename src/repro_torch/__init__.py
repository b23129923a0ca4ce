"""PyTorch/CUDA port of the GOLDYLOC reproduction.

Mirrors `repro/` (the JAX reference, which it never imports): the cost
model, tuner, GO library and concurrency controller in `core/`, the
hand-written Hopper kernels and their plain PyTorch versions in
`kernels/` (CUDA sources in `csrc/`), the serving runtime in `runtime/`.
CPU tensors run the plain versions; CUDA tensors run the kernels.
"""
