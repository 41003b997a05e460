"""PyTorch/CUDA port of the SASP serving stack for NVIDIA Hopper.

Mirrors ``repro`` module for module (``configs/``, ``core/``,
``kernels/sasp_gemm/``, ``models/``, ``serve/``, ``launch/``). The port
imports torch and numpy only; it keeps its own copies of whatever it
needs from the reference package. Entry points run on ``"cuda"`` unless
the caller passes ``device="cpu"``; on the CPU each kernel wrapper runs
its plain PyTorch version, on a CUDA tensor it launches the hand-written
kernel or raises.
"""
