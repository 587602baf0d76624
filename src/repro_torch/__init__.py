"""PyTorch / CUDA port of the multiscale-gossip simulator.

`repro_torch.core` mirrors the reference package's simulation core
(plan on the host, execute on the card); `repro_torch.kernels` holds
the hand-written Hopper kernels with their plain PyTorch versions, and
``repro_torch/csrc`` their CUDA sources.
"""
