"""PyTorch / CUDA port of COMBO-AVS for NVIDIA Hopper (H100).

The JAX package `combo_avs_tpu` is the reference this package is held
against; this package imports torch, numpy and the standard library only.
"""
