"""Host-side io modules of the port (counterparts of fqtk_tpu/io/)."""
