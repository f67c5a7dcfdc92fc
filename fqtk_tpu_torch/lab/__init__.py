"""The port's kernel lab (``python -m fqtk_tpu_torch.lab.kernel_lab``)."""
