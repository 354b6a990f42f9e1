"""AMP op lists (the port's copy of ``mxnet_tpu/amp/lists.py``; parity:
``python/mxnet/amp/lists/symbol_fp16.py`` / ``symbol_bf16.py``).  They
drive ``convert_hybrid_block``'s per-op casting.  Of the target ops, the
port has ``fully_connected``, ``batch_dot``, ``flash_attention``,
``bias_gelu`` and ``bias_dropout_residual``; the others are listed for
parity with the JAX package."""

# ops that are safe and profitable in low precision (the matmul family,
# FP16_FUNCS of lists/symbol_fp16.py:25), and the fused matmul epilogues,
# which ride in the matmul's dtype
TARGET_DTYPE_OPS = [
    "fully_connected", "convolution", "deconvolution", "batch_dot",
    "einsum", "interleaved_matmul_selfatt_qk",
    "interleaved_matmul_selfatt_valatt", "interleaved_matmul_encdec_qk",
    "interleaved_matmul_encdec_valatt", "flash_attention", "rnn",
    "bias_gelu", "bias_dropout_residual",
]

# ops that run in either precision (FP16_FP32_FUNCS :40)
WIDEST_TYPE_CASTS = [
    "add", "subtract", "multiply", "maximum", "minimum", "where",
    "concatenate", "stack",
]

# ops kept in fp32 (FP32_FUNCS :464): reductions and normalisations
FP32_OPS = [
    "softmax", "log_softmax", "batch_norm", "layer_norm", "group_norm",
    "instance_norm", "lrn", "l2_normalization", "sum", "mean", "prod",
    "exp", "log", "power", "norm", "var", "std", "erf", "erfinv",
    "ctc_loss",
]

CONDITIONAL_FP32_OPS = [
    ("activation", "act_type", ["softrelu"]),
]
