"""PyTorch/CUDA port of skypilot_tpu's compute layer: serving and
single-card training of the Llama family.

A package of its own beside `skypilot_tpu/`, which stays the reference:
it imports `torch` and numpy, never JAX, Flax or anything of
`skypilot_tpu`. Module paths mirror the reference's so each module's
counterpart is easy to find (`ops/paged_attention.py` here ports
`skypilot_tpu/ops/paged_attention.py`). The TPU kernels run as CUDA
kernels written for Hopper (`csrc/*.cu`: paged attention, the QKV LoRA
delta, flash attention forward and backward); tensors on the CPU take
their plain PyTorch versions (`ops/*_kernel.py`).
"""
