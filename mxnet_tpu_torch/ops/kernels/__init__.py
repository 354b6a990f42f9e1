"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- ``epilogue.bias_gelu``              — Triton (``epilogue.py``), forward
- ``epilogue.bias_gelu_backward``     — Triton (``epilogue.py``)
- ``epilogue.bias_dropout_residual``  — CUDA (``csrc/epilogue.cu``),
  forward and backward, over the hash mask of ``dropout_hash``
- ``paged_attention.paged_attention`` — CUDA (``csrc/paged_attention.cu``)
- ``fused_cell.decode_layer_group``   — CUDA (``csrc/fused_decode.cu``)
- ``fused_cell.decode_attn_phase`` and ``fused_cell.decode_ffn_phase`` —
  CUDA (``csrc/decode_phase.cu``), one tensor-parallel shard of a decode
  layer's attention and FFN halves
- ``fused_cell.lstm_sequence``        — CUDA (``csrc/lstm.cu``), the LSTM
  time loop forward and backward
- ``quant_matmul.quant_matmul``       — CUDA (``csrc/quant_matmul.cu``),
  int8 and int4 weights
- ``flash_attention.flash_attention`` — CUDA (``csrc/flash_attention.cu``),
  forward, backward dq and backward dk/dv, over the hash mask of
  ``dropout_hash``

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches its kernel (built on first use by ``_build``) or raises.
Each wrapper counts its launches in a ``launches`` attribute
(``launches_fwd``/``launches_bwd`` for ``bias_dropout_residual``,
``launches_fwd``/``launches_dq``/``launches_dkv`` for
``flash_attention``, ``launches_fwd``/``launches_bwd`` for
``lstm_sequence``).  The epilogue and flash-attention ops are
``torch.autograd.Function``s whose backward is a kernel too: the
training slice (``models.bert``) runs them forward and back; so is
``lstm_sequence``, which the RNN layers (``ops.rnn``, ``gluon.rnn``) run.
"""
