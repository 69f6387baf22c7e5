"""Host utilities of the port (counterpart of ``pipegoose_tpu.utils``): the
rank filter, crash-atomic resharding checkpoints over
``torch.distributed.checkpoint``, and the profiler trace."""
