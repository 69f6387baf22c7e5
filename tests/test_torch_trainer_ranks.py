"""The per-rank bodies of the port's Trainer tests.

``run_ranks`` pickles a rank body into spawned processes, which import this
module by name: it imports torch, numpy and the port only, never JAX. The
JAX side of each comparison lives in ``test_torch_trainer.py``. Inputs
arrive as numpy arrays; every rank gets the same global batches.
"""
import torch

from pipegoose_tpu_torch.distributed import ParallelContext

POISON = 0   # a batch whose first token id is 0 has a NaN loss (the recovery runs)


def make_loss(cfg, poison=False):
    """The BLOOM loss with ``tp_axis="tensor"`` on a batch of ids (labels =
    ids); with ``poison`` NaN on a batch whose first id is ``POISON``, as
    ``tests/trainer/test_recovery.py`` does it."""
    from pipegoose_tpu_torch.models.bloom import loss_fn

    def lf(p, ids):
        base = loss_fn(p, ids, None, ids, cfg, tp_axis="tensor")
        if not poison:
            return base
        return torch.where(ids[0, 0] == POISON, torch.full_like(base, float("nan")), base)

    return lf


def make_trainer(np_tree, cfg, lr, poison=False, **kw):
    """A Trainer over the whole tree, sharded by ``tp_specs``, ZeRO-1 Adam
    over "data", on the current context."""
    from pipegoose_tpu_torch.models.bloom import tp_specs
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.trainer import Trainer

    whole = params_from_jax(np_tree, cfg, device="cpu")
    return Trainer(make_loss(cfg, poison), whole, tp_specs(whole),
                   DistributedOptimizer(adam(lr), axis_name="data"), **kw)


def whole_params(trainer):
    """The trainer's params gathered whole, in the JAX layout."""
    from pipegoose_tpu_torch.models.weights import params_to_jax
    from pipegoose_tpu_torch.nn.parallel import unshard_tree

    return params_to_jax(unshard_tree(trainer.params, trainer.param_specs))


def whole_state(trainer):
    """Per parameter leaf (in tree order) its Adam moments gathered whole
    (over "data", the padding cut, then over its tensor spec) and its step
    count."""
    from pipegoose_tpu_torch.nn.parallel import tree_leaves, unshard_leaf
    from pipegoose_tpu_torch.optim.zero import _unshard

    st = trainer.opt_state
    specs = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            specs.append(t)
    walk(trainer.param_specs)
    out = []
    for p, sh, spec in zip(tree_leaves(trainer.params), st.shards, specs):
        s = st.inner.state[sh]
        leaf = {}
        for name in ("exp_avg", "exp_avg_sq"):
            local = _unshard(s[name], p.shape, "data").reshape(p.shape)
            leaf[name] = unshard_leaf(local, spec).float().numpy()
        leaf["step"] = float(s["step"])
        out.append(leaf)
    return out


def trainer_rank(rank, world, np_tree, runs, batches, lr, ckpt_dir, resume_dir,
                 recovery_dir):
    """One spawn of 4 ranks for the Trainer's file.

    At TP2 x DP2: each run ``(name, cfg)`` through ``Trainer.fit`` on the
    first 5 batches (the losses and the params gathered whole), the first
    run's trainer also checkpointing at step 5 into ``ckpt_dir`` (the
    state gathered whole at save time); an uninterrupted run of batches
    0-3 (params after step 4) and 4-5 (losses); a run of batches 0-3
    checkpointing every 2 steps into ``resume_dir`` and a new Trainer
    resuming from it on batches 4-5; AutoRecovery over batches 0, 1, a
    poisoned batch, 2, 3 checkpointing every 2 steps into
    ``recovery_dir``. Then at tp 1 x dp 4: the first trainer rebuilt on the
    new context and restored from ``ckpt_dir``, its state gathered whole,
    and one more step."""
    from pipegoose_tpu_torch.trainer import AutoRecovery, CheckpointCallback

    ctx = ParallelContext(tensor_parallel_size=2, data_parallel_size=2, device="cpu")
    out = {}
    try:
        first = None
        for name, cfg in runs:
            cbs = [CheckpointCallback(ckpt_dir, every=5)] if first is None else []
            t = make_trainer(np_tree, cfg, lr, callbacks=cbs)
            st = t.fit(batches[:5])
            out[name] = dict(losses=[float(x) for x in st.losses], params=whole_params(t))
            if first is None:
                first, cfg0 = t, cfg
                out["saved"] = dict(params=out[name]["params"], state=whole_state(t))
        # uninterrupted, then resumed
        t = make_trainer(np_tree, cfg0, lr, poison=True)
        t.fit(batches[:4])
        out["uninterrupted_params4"] = whole_params(t)
        out["uninterrupted_losses"] = [float(x) for x in t.fit(batches[4:6]).losses]  # all 6
        t = make_trainer(np_tree, cfg0, lr, poison=True,
                         callbacks=[CheckpointCallback(resume_dir, every=2)])
        t.fit(batches[:4])
        t = make_trainer(np_tree, cfg0, lr, poison=True, resume_dir=resume_dir)
        out["resumed_step"] = t.state.step
        out["resumed_losses"] = [float(x) for x in t.fit(batches[4:6]).losses]
        # AutoRecovery over a poisoned batch
        poisoned = batches[2].copy()
        poisoned[0, 0] = POISON
        rec = AutoRecovery(recovery_dir, max_restores=2)
        t = make_trainer(np_tree, cfg0, lr, poison=True,
                         callbacks=[CheckpointCallback(recovery_dir, every=2), rec])
        st = t.fit([batches[0], batches[1], poisoned, batches[2], batches[3]])
        out["recovered"] = dict(restores=rec.restores, step=st.step,
                                losses=[float(x) for x in st.losses],
                                params=whole_params(t))
    finally:
        ctx.destroy()
    ctx = ParallelContext(tensor_parallel_size=1, data_parallel_size=4, device="cpu")
    try:
        first.rebuild(ctx)
        out["restored_step"] = first.restore_from(ckpt_dir)
        out["restored"] = dict(params=whole_params(first), state=whole_state(first),
                               shard_rows=[tuple(sh.shape) for sh in first.opt_state.shards])
        out["after_restore_loss"] = float(first.fit(batches[5:6]).losses[-1])
    finally:
        ctx.destroy()
    return out
