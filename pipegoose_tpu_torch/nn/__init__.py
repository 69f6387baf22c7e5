"""Layer functions (counterparts of ``pipegoose_tpu.nn``)."""
