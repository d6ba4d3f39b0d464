"""Model components of the port (counterpart of ``vjf_tpu/models``)."""
