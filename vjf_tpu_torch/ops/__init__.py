"""Math, sampler and kernels of the port (counterpart of ``vjf_tpu/ops``)."""
