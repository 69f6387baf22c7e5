"""BLOOM pieces of the serving path (counterparts of ``pipegoose_tpu.models``)."""
