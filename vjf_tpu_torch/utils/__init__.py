"""Evaluation helpers of the port (counterpart of ``vjf_tpu/utils``)."""
