"""PyTorch/CUDA port of the gossip-learning simulator.

The JAX package ``repro`` is the reference; this package keeps its module
names (``repro_torch.core.simulation`` is the counterpart of
``repro.core.simulation``, and so on) and imports neither JAX nor ``repro``.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device and without that argument they
raise.
"""
