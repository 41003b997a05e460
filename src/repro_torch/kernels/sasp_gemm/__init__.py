"""The SASP tile-skip GEMM, fused gated FFN and masked-grid GEMM: numpy
packers (``pack``), kernel wrappers with plain PyTorch versions
(``gemm``, ``fused_ffn``, ``masked``)."""
