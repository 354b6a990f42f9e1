"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- ``epilogue.bias_gelu``              — Triton (``epilogue.py``)
- ``paged_attention.paged_attention`` — CUDA (``csrc/paged_attention.cu``)
- ``fused_cell.decode_layer_group``   — CUDA (``csrc/fused_decode.cu``)

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches its kernel (built on first use by ``_build``) or raises.
Each wrapper counts its launches in a ``launches`` attribute.
"""
