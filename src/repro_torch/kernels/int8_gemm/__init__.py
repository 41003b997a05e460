"""Dense weight-only int8 GEMM: kernel wrapper with its plain PyTorch
version and the dequantize-then-matmul oracle (``gemm``), and the
kernel's variant / column tile / k-group schedule (``schedule``)."""
