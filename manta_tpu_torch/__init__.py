"""PyTorch/CUDA port of manta_tpu: the same limb layout and results, with
kernels written by hand for NVIDIA Hopper (see ROADMAP.md)."""
