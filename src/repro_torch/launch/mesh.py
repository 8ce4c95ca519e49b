"""The card's roofline constants.

Counterpart of ``repro/launch/mesh.py``'s constants, which are the TPU
v5e's; these are the NVIDIA H100 80GB HBM3 (SXM5) card's, from NVIDIA's
H100 Tensor Core GPU datasheet: dense bf16 tensor-core peak (without
sparsity), HBM3 bandwidth, and NVLink 4's 900 GB/s a GPU counted one
direction. The mesh builders wait for ROADMAP queue 1 item 11.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12                  # B/s
NVLINK_BW = 450e9                 # B/s a direction, all 18 NVLink 4 links
