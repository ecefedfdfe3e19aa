"""PyTorch/CUDA port of skypilot_tpu's serving compute path.

A package of its own beside `skypilot_tpu/`, which stays the reference:
it imports `torch` and numpy, never JAX, Flax or anything of
`skypilot_tpu`. Module paths mirror the reference's so each module's
counterpart is easy to find (`ops/paged_attention.py` here ports
`skypilot_tpu/ops/paged_attention.py`). Paged attention runs on a CUDA
kernel written for Hopper (`csrc/paged_attention.cu`); tensors on the
CPU take its plain PyTorch version (`ops/paged_kernel.py`).
"""
