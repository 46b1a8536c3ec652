"""PyTorch/CUDA port of the FMI reproduction (the JAX package ``repro`` is
the reference it is held against).

The port runs on one NVIDIA GPU: the FMI collective stack on the
instrumented lockstep channel, the elastic runtime, and the
tensor-parallel continuous-batching decode engine over a rank-sharded
paged KV cache, whose decode attention is a hand-written CUDA kernel
(:mod:`repro_torch.kernels.paged_attention`).  Importing the package builds
nothing and imports no kernel toolchain; kernels are compiled on first use.
"""
