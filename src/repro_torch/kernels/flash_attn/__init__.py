"""Flash attention: the kernel wrapper with its plain online-softmax
version (``kernel``), the dense oracle (``ref``) and the GQA wrapper
(``ops.mha``)."""
