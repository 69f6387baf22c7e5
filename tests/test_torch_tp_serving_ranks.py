"""The per-rank bodies of the port's tensor-parallel serving tests.

``run_ranks`` pickles a rank body into spawned processes, which import this
module by name: it imports torch, numpy and the port only, never JAX. The
JAX side of each comparison lives in ``test_torch_tp_generate.py`` and
``test_torch_tp_serving.py``. Every rank gets the WHOLE numpy tree and the
same requests, as every JAX shard_map program takes global arrays; what a
rank returns is what that rank saw (its tokens, its pool's history, its
memory report), so the tests can hold every rank to the JAX run.
"""
import numpy as np
import torch

from pipegoose_tpu_torch.distributed import ParallelContext

SERVING = dict(num_slots=2, num_pages=32, page_size=4, max_context=64)


def _config(cfg_kw):
    from pipegoose_tpu_torch.models.bloom import BloomConfig

    return BloomConfig(**cfg_kw)


def _context(world, tp):
    return ParallelContext(tensor_parallel_size=tp, data_parallel_size=world // tp,
                           device="cpu")


def _raises(fn):
    """The message of the ValueError ``fn`` raises, or None."""
    try:
        fn()
    except ValueError as err:
        return str(err)
    return None


# -- generate_tp and global_greedy_pick ---------------------------------------------


def generate_rank(rank, world, tp, gen_cases, pick_cases, probe):
    """Under a context of ``tp`` x ``world / tp`` (tensor x data):

    - ``gen_cases``: ``(cfg_kw, np_tree, ids, max_new, kw)`` each through
      ``generate_tp`` with the whole tree (this rank keeps its shard);
    - ``pick_cases``: ``(logits (B, V), valid_size)`` each cut to this
      rank's vocab shard and picked with ``global_greedy_pick``;
    - ``probe``: ``(cfg_kw, np_tree, group)``, a config whose heads do not
      divide tp: the messages ``generate_tp``, ``init_cache(tp=)``,
      ``init_pages(tp=)`` and the engine raise with; and the message of an
      int4 engine over the first case's tree whose ``group`` does not
      divide a row-parallel shard."""
    from pipegoose_tpu_torch.distributed.functional import axis_index
    from pipegoose_tpu_torch.models import bloom
    from pipegoose_tpu_torch.models._decode import global_greedy_pick
    from pipegoose_tpu_torch.models.generate import generate_tp, init_cache
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.serving import ServingEngine
    from pipegoose_tpu_torch.serving.kv_pool import init_pages

    ctx = _context(world, tp)
    try:
        gens = []
        for cfg_kw, np_tree, ids, max_new, kw in gen_cases:
            cfg = _config(cfg_kw)
            params = params_from_jax(np_tree, cfg, device="cpu")
            gens.append(generate_tp(params, ids, cfg, max_new, bloom.tp_specs(params),
                                    device="cpu", **kw))
        picks = []
        r = axis_index("tensor")
        for logits, valid in pick_cases:
            vloc = logits.shape[1] // tp
            local = torch.from_numpy(np.ascontiguousarray(logits[:, r * vloc:(r + 1) * vloc]))
            picks.append(global_greedy_pick(local, "tensor", valid))
        errors = {}
        if probe is not None:
            cfg_kw, np_tree, group = probe
            cfg = _config(cfg_kw)
            params = params_from_jax(np_tree, cfg, device="cpu")
            specs = bloom.tp_specs(params)
            ids = np.ones((1, 3), np.int64)
            errors["generate_tp"] = _raises(lambda: generate_tp(
                params, ids, cfg, 2, specs, device="cpu"))
            errors["init_cache"] = _raises(lambda: init_cache(cfg, 1, 4, tp, device="cpu"))
            errors["init_pages"] = _raises(lambda: init_pages(cfg, 4, 4, tp=tp, device="cpu"))
            errors["engine"] = _raises(lambda: ServingEngine(
                params, cfg, param_specs=specs, device="cpu", **SERVING))
            cfg_kw, np_tree = gen_cases[0][:2]
            cfg = _config(cfg_kw)
            params = params_from_jax(np_tree, cfg, device="cpu")
            errors["engine_int4"] = _raises(lambda: ServingEngine(
                params, cfg, param_specs=bloom.tp_specs(params), weight_dtype="int4",
                weight_group_size=group, device="cpu", **SERVING))
        return gens, picks, errors
    finally:
        ctx.destroy()


def generate_tp4_then_tp2dp2_rank(rank, world, gen_cases, pick_cases, probe):
    """:func:`generate_rank` at tp 4 (with the probe), then the first
    generate case on a tp 2 x dp 2 context."""
    return (generate_rank(rank, world, 4, gen_cases, pick_cases, probe),
            generate_rank(rank, world, 2, gen_cases[:1], [], None))


# -- the engine ---------------------------------------------------------------------


def _serve(eng, reqs, **run_kw):
    from pipegoose_tpu_torch.serving import Request

    outs, metrics = eng.run([Request(prompt=p, max_new_tokens=n, **kw)
                             for p, n, kw in reqs], **run_kw)
    return {"tokens": [o.generated for o in outs],
            "finish": [o.finish_reason for o in outs],
            "ttft": [o.ttft_s for o in outs],
            "history": [list(e) for e in eng.pool.history],
            "metrics": {k: v for k, v in metrics.items() if not k.endswith("_s")
                        and k not in ("decode_tokens_per_s",)},
            "memory": eng.memory_report(),
            "drained": eng.sched.all_done() and eng.pool.used_count == (
                eng.prefix_cache.cached_pages if eng.prefix_cache else 0)}


def _skewed_clock(rank, step):
    """Rank r's clock reads ``k x step x (1 + r)`` at its k-th call: every
    rank's clock runs at its own rate."""
    calls = [0]

    def now():
        calls[0] += 1
        return calls[0] * step * (1 + rank)

    return now


def _leaf_arrays(leaf):
    return {k: v.clone() for k, v in leaf.items()}


def engine_rank(rank, world, tp, cfg_kw, np_tree, cases, clock_case=None,
                order_case=None, replay_kw=None):
    """Under a "tensor" axis of ``tp`` (``world / tp`` data replicas, each
    serving the same requests): every ``(name, engine kw, requests)`` of
    ``cases`` through ``ServingEngine(param_specs=tp_specs, tp_axis=
    "tensor")``, each request ``(prompt, max_new, Request kw)``.

    ``clock_case`` ``(requests, step, engine kw)``: one run with this
    rank's skewed clock (:func:`_skewed_clock`). ``order_case`` ``(quant
    kw)``: this rank's quantized row-parallel leaves as the engine holds
    them, and as quantizing this rank's fp shard would make them.
    ``replay_kw``: ``prefix_replay_benchmark`` with ``param_specs`` passed
    through, its rows without the wall-clock fields."""
    from pipegoose_tpu_torch.models import bloom
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.nn.parallel import shard_tree
    from pipegoose_tpu_torch.quant import QuantSpec, quantize_params
    from pipegoose_tpu_torch.serving import ServingEngine
    from pipegoose_tpu_torch.serving.engine import prefix_replay_benchmark

    ctx = _context(world, tp)
    try:
        cfg = _config(cfg_kw)
        params = params_from_jax(np_tree, cfg, device="cpu")
        specs = bloom.tp_specs(params)
        out = {}
        if replay_kw is not None:
            rows = prefix_replay_benchmark(params, cfg, param_specs=specs, device="cpu",
                                           **replay_kw)
            out["replay"] = {arm: {k: v for k, v in row.items() if not k.endswith("_s")}
                             for arm, row in rows.items()}
        for name, kw, reqs in cases:
            eng = ServingEngine(params, cfg, param_specs=specs, tp_axis="tensor",
                                device="cpu", **{**SERVING, **kw})
            out[name] = _serve(eng, reqs)
        if clock_case is not None:
            reqs, step, kw = clock_case
            eng = ServingEngine(params, cfg, param_specs=specs, device="cpu",
                                **{**SERVING, **kw})
            out["clock"] = _serve(eng, reqs, now=_skewed_clock(rank, step))
        if order_case is not None:
            eng = ServingEngine(params, cfg, param_specs=specs, device="cpu",
                                **{**SERVING, **order_case})
            spec = QuantSpec(order_case["weight_dtype"],
                             order_case.get("weight_group_size", 32))
            per_shard = quantize_params(shard_tree(params, specs), spec)
            out["order"] = {
                name: (_leaf_arrays(eng.params["blocks"][0][grp][name]),
                       _leaf_arrays(per_shard["blocks"][0][grp][name]))
                for grp, name in (("attn", "qkv"), ("attn", "out"), ("mlp", "down"))}
        return out
    finally:
        ctx.destroy()


def tp4_then_tp2dp2_rank(rank, world, cfg_kw, np_tree, cases):
    """``cases`` at tp 4, then the first of them on a tp 2 x dp 2 context."""
    return (engine_rank(rank, world, 4, cfg_kw, np_tree, cases),
            engine_rank(rank, world, 2, cfg_kw, np_tree, cases[:1]))
