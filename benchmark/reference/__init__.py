"""The plain reference that decides ``correct``: fqtk's barcode assignment
in plain PyTorch.  It imports nothing of the program (``fqtk_tpu_torch``),
of the JAX package or of JAX, and works out everything from the inputs the
benchmark made."""
