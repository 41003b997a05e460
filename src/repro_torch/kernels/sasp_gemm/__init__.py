"""The SASP tile-skip GEMM and fused gated FFN: numpy packers
(``pack``), kernel wrappers with plain PyTorch versions (``gemm``,
``fused_ffn``)."""
