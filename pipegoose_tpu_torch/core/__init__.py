"""Gradient accumulation (counterpart of ``pipegoose_tpu.core``)."""
