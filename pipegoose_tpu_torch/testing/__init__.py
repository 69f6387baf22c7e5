"""Test helpers of the port: ``dist.run_ranks`` runs a function on several
gloo ranks, one spawned process each (the multi-process counterpart of
``pipegoose_tpu.testing.fake_cluster``)."""
