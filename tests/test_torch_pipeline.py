"""The port's pipeline host code held against the JAX package: microbatch
``split``/``merge``, both schedulers' timetables and bubble fractions,
``one_f_one_b_tables``, the partitioner (``partition_costs``,
``layer_param_counts``, ``repartition_blocks``' stages, ``UniformPartitioner``)
and the spec helpers (``pipe_stage_specs``, ``bloom.pp_specs``), each equal
to the JAX function's output on the same input. The multi-rank pipeline
runs are in ``test_torch_pp_ranks.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.nn.pipeline_parallel import microbatch as jmb
from pipegoose_tpu.nn.pipeline_parallel import partitioner as jpart
from pipegoose_tpu.nn.pipeline_parallel import pipeline as jpipe
from pipegoose_tpu.nn.pipeline_parallel import scheduler as jsched
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import params_from_jax
from pipegoose_tpu_torch.nn.pipeline_parallel import microbatch as tmb
from pipegoose_tpu_torch.nn.pipeline_parallel import partitioner as tpart
from pipegoose_tpu_torch.nn.pipeline_parallel import pipeline as tpipe
from pipegoose_tpu_torch.nn.pipeline_parallel import scheduler as tsched

SHAPES = [(1, 1), (4, 1), (1, 4), (2, 2), (4, 2), (2, 4), (8, 4), (3, 5), (6, 3)]


@pytest.mark.parametrize("n", [1, 2, 3, 6])
def test_split_and_merge_equal_jax(n):
    batch = {"ids": np.arange(72).reshape(12, 6), "mask": np.ones((12, 6), np.int32)}
    want = jmb.split(jax.tree_util.tree_map(jnp.asarray, batch), n)
    for conv in (lambda x: x, torch.from_numpy):
        got = tmb.split({k: conv(v) for k, v in batch.items()}, n)
        for k in batch:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
            np.testing.assert_array_equal(np.asarray(tmb.merge(got)[k]), batch[k])
    with pytest.raises(ValueError, match="not divisible"):
        tmb.split(batch, 5)
    with pytest.raises(ValueError, match=">= 1"):
        tmb.split(batch, 0)


@pytest.mark.parametrize("m,p", SHAPES)
def test_schedulers_equal_jax(m, p):
    for cls in ("GPipeScheduler", "OneFOneBScheduler"):
        got, want = getattr(tsched, cls)(m, p), getattr(jsched, cls)(m, p)
        assert got.total_forward_clocks == want.total_forward_clocks
        assert got.total_backward_clocks == want.total_backward_clocks
        assert got.bubble_fraction == want.bubble_fraction

        def plain(schedules):
            return [[(t.job_type.value, t.microbatch_idx, t.partition_idx) for t in ts]
                    for ts in schedules]

        assert plain(got.get_forward_schedules()) == plain(want.get_forward_schedules())
        assert plain(got.get_backward_schedules()) == plain(want.get_backward_schedules())
    got, want = tsched.OneFOneBScheduler(m, p), jsched.OneFOneBScheduler(m, p)
    assert got.n_clock == want.n_clock
    for stage in range(p):
        assert [(t.job_type.value, t.microbatch_idx) for t in got.timeline(stage)] == \
            [(t.job_type.value, t.microbatch_idx) for t in want.timeline(stage)]


@pytest.mark.parametrize("m,p", SHAPES)
def test_one_f_one_b_tables_equal_jax(m, p):
    fwd, bwd, slots, clocks = tsched.one_f_one_b_tables(m, p)
    jf, jb, js, jc = jsched.one_f_one_b_tables(m, p)
    np.testing.assert_array_equal(fwd, jf)
    np.testing.assert_array_equal(bwd, jb)
    assert (slots, clocks) == (js, jc)
    assert fwd.dtype == jf.dtype


COSTS = [[1.0] * 6, [5, 1, 1, 1, 1, 5], [1, 2, 3, 4, 5, 6, 7, 8], [9, 1, 1, 1],
         [3, 3, 3, 1, 1, 1, 1, 1, 1]]


@pytest.mark.parametrize("costs", COSTS, ids=str)
@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_partition_costs_equal_jax(costs, parts):
    if parts > len(costs):
        with pytest.raises(ValueError, match="n_partitions"):
            tpart.partition_costs(costs, parts)
        return
    assert tpart.partition_costs(costs, parts) == jpart.partition_costs(costs, parts)
    assert tpart.UniformPartitioner(parts).split(costs) == \
        jpart.UniformPartitioner(parts).split(costs)
    assert tpart.UniformPartitioner(parts).split_even(len(costs)) == \
        jpart.UniformPartitioner(parts).split_even(len(costs))


def _np_tree(n_layer=4):
    cfg = tbloom.BloomConfig(vocab_size=128, hidden_size=64, n_layer=n_layer, n_head=4)
    return cfg, tbloom.init_params_numpy(cfg, seed=0)


def test_layer_param_counts_equal_jax():
    cfg, tree = _np_tree()
    want = jpart.layer_param_counts(jax.tree_util.tree_map(jnp.asarray, tree["blocks"]))
    np.testing.assert_array_equal(tpart.layer_param_counts(tree["blocks"]), want)
    blocks = params_from_jax(tree, cfg, device="cpu")["blocks"]
    np.testing.assert_array_equal(tpart.layer_param_counts(blocks), want)


@pytest.mark.parametrize("ranges", [[range(0, 3), range(3, 4)], [range(0, 1), range(1, 4)],
                                    [range(0, 2), range(2, 3), range(3, 4)]], ids=str)
def test_repartition_blocks_keeps_jax_stages_without_padding(ranges):
    """Each port stage holds exactly the JAX padded layout's live slots of
    that stage, in order, with the same counts."""
    cfg, tree = _np_tree()
    padded, counts = jpart.repartition_blocks(
        jax.tree_util.tree_map(jnp.asarray, tree["blocks"]), ranges)
    blocks = params_from_jax(tree, cfg, device="cpu")["blocks"]
    stages, got_counts = tpart.repartition_blocks(blocks, ranges)
    np.testing.assert_array_equal(got_counts, counts)
    lmax = max(counts)
    for p, stage in enumerate(stages):
        assert len(stage) == counts[p]
        for j, blk in enumerate(stage):
            np.testing.assert_array_equal(
                blk["attn"]["qkv"]["kernel"].numpy(),
                np.asarray(padded["attn"]["qkv"]["kernel"][p * lmax + j]))


def test_masked_stage_scan_runs_the_first_n_valid():
    seen = []
    h = tpart.masked_stage_scan(lambda b, x: (seen.append(b), x + b)[1], [1, 2, 3, 0], 10, 2)
    assert h == 13 and seen == [1, 2]


SPECS = {"a": P(None, "tensor"), "b": P("tensor", None), "c": P(None), "d": P(("tensor", "x"))}


def test_pipe_stage_specs_and_pp_specs_equal_jax():
    from pipegoose_tpu_torch.nn.parallel import tree_map_with_path

    got = tpipe.pipe_stage_specs({k: tuple(v) for k, v in SPECS.items()})
    want = jpipe.pipe_stage_specs(SPECS)
    assert got == {k: tuple(v) for k, v in want.items()}
    _, tree = _np_tree()
    want = jbloom.pp_specs(jax.tree_util.tree_map(jnp.asarray, tree))
    # JAX's tree_map sorts dict keys, the port keeps their order: by path
    want = {jax.tree_util.keystr(p): tuple(s) for p, s in jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, P))[0]}
    got = {}
    tree_map_with_path(lambda p, s: got.setdefault("".join(f"[{k!r}]" for k in p), tuple(s)),
                       tbloom.pp_specs(tree))
    assert got == want


def test_pp_specs_mark_every_block_leaf_of_the_port_tree():
    """On the port's per-layer tree every block leaf's spec mentions the
    pipe axis, so ``sync_replicated_grads`` over "pipe" leaves the blocks
    alone and sums the replicated leaves."""
    from pipegoose_tpu_torch.nn.parallel import tree_map
    from pipegoose_tpu_torch.parallel.hybrid import spec_mentions

    cfg, tree = _np_tree()
    params = params_from_jax(tree, cfg, device="cpu")
    specs = tbloom.pp_specs(params)
    marks = []
    tree_map(lambda s: marks.append(spec_mentions(s, "pipe")), specs["blocks"])
    assert marks and all(marks)
    for key in ("embed", "embed_ln", "ln_f"):
        tree_map(lambda s: marks.append(not spec_mentions(s, "pipe")), specs[key])
    assert all(marks)


# -- one_f_one_b with and without aux, at pp 2 against JAX's ------------------------------


def _one_f_one_b_case():
    rng = np.random.default_rng(4)
    L, M, mb, d = 4, 4, 2, 8
    return dict(w=(rng.standard_normal((L, d, d)) * 0.3).astype(np.float32),
                b=(rng.standard_normal((L, d)) * 0.1).astype(np.float32),
                x=rng.standard_normal((M, mb, d)).astype(np.float32),
                side=(rng.standard_normal((M, d)) * 0.1).astype(np.float32),
                scale=(1.0 + rng.standard_normal(d) * 0.1).astype(np.float32))


def _jax_one_f_one_b(case, with_aux, devices):
    """JAX's ``one_f_one_b`` on the same tanh stack under a 2-stage pipe mesh:
    each rank's loss sum, d_inputs, dW/db (stacked) and d_head."""
    from jax.sharding import Mesh

    from pipegoose_tpu.distributed.compat import shard_map

    def stage_fn(blocks, h, side):
        for i in range(blocks["w"].shape[0]):
            h = jnp.tanh(h @ blocks["w"][i] + blocks["b"][i]) + side["s"]
        return (h, 0.1 * (h ** 2).mean()) if with_aux else h

    def head_fn(hp, h, side):
        return ((h * hp["scale"]) ** 2).mean()

    def run(blocks, hp, x, side):
        loss, dx, dp, dh = jpipe.one_f_one_b(stage_fn, blocks, head_fn, hp, x, side,
                                             "pipe", with_aux=with_aux)
        return loss[None], dx[None], dp, jax.tree_util.tree_map(lambda a: a[None], dh)

    mesh = Mesh(np.asarray(devices[:2]).reshape(2, 1), ("pipe", "tensor"))
    spec = {"w": P("pipe"), "b": P("pipe")}
    f = shard_map(run, mesh=mesh, in_specs=(spec, P(), P(), P()),
                  out_specs=(P("pipe"), P("pipe"), spec, P("pipe")), check_vma=False)
    loss, dx, dp, dh = f({"w": jnp.asarray(case["w"]), "b": jnp.asarray(case["b"])},
                         {"scale": jnp.asarray(case["scale"])}, jnp.asarray(case["x"]),
                         {"s": jnp.asarray(case["side"])})
    return (np.asarray(loss), np.asarray(dx), np.asarray(dp["w"]), np.asarray(dp["b"]),
            np.asarray(dh["scale"]))


def _check_one_f_one_b(with_aux, devices):
    from pipegoose_tpu_torch.testing.dist import run_ranks
    from test_torch_family_rank_bodies import one_f_one_b_rank

    case = _one_f_one_b_case()
    loss, dx, dw, db, dscale = _jax_one_f_one_b(case, with_aux, devices)
    ranks = run_ranks(one_f_one_b_rank, 2, case, with_aux, timeout=300)
    for r, want in zip(ranks, loss):   # the last rank's head loss (+ aux); aux alone before
        np.testing.assert_allclose(r["loss"], want, rtol=1e-5, atol=1e-7)
    if not with_aux:
        assert ranks[0]["loss"] == 0.0
    np.testing.assert_allclose(ranks[0]["x"], dx[0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([np.stack(r["w"]) for r in ranks]), dw,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([np.stack(r["b"]) for r in ranks]), db,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ranks[1]["scale"], dscale[1], rtol=1e-4, atol=1e-6)


def test_one_f_one_b_with_aux_matches_jax(devices):
    """``with_aux=True``: each stage's aux scalar seeds its own backward and
    adds into every rank's loss sum (rtol 1e-5), the gradients of every
    stage's layers, of the inputs and of the head against JAX's
    (``tests/nn/pipeline_parallel/test_pipeline.py``'s rtol 1e-4, atol
    1e-6), at pp 2 and M = 4."""
    _check_one_f_one_b(True, devices)


def test_one_f_one_b_without_aux_is_unchanged(devices):
    """The ``with_aux=False`` path against JAX's on the same stack: the loss
    on the last rank only, the same gradients."""
    _check_one_f_one_b(False, devices)
