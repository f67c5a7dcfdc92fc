"""Host-side parallel modules of the port (counterparts of fqtk_tpu/parallel/)."""
