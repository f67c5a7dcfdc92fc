"""Host-side core modules of the port (counterparts of fqtk_tpu/core/)."""
