"""The JAX parameter tree, as numpy arrays, to the port's params and back.

The JAX tree stacks every per-layer leaf on a leading ``n_layer`` axis
(``bloom.init_params``) and lays dense kernels out ``(in, out)``. The
port keeps that kernel layout, so no transpose is needed, and splits the
stack into a list of per-layer dicts so that the layer loop indexes a
Python list instead of slicing every leaf on every step. Each layer's
leaf is a tensor of its own (not a view into a stacked tensor), so every
leaf can be handed to an optimizer that updates it in place, and the
serving path reads the updated values with no copy.

A tree that the JAX package's ``quantize_params`` made carries quantized
block leaves ``{"q": int8, "scale": float32, "bias"}``: their ``q`` stays
int8 and their ``scale`` float32, whatever ``config.dtype`` is.

Under tensor parallelism each rank converts only its shard:
``params_from_jax(..., specs=bloom.tp_specs(np_tree))`` slices every numpy
leaf by its spec and the current context's coordinates first
(``nn.parallel.shard_tree``); ``nn.parallel.unshard_tree`` of the result,
through :func:`params_to_jax`, gives the whole tree back.

ALBERT's tree (``embed``, ``map_in``, ``layer``, ``mlm``) has no stacked
leaf: its one shared ``layer`` converts leaf for leaf, as do its specs.

A BLOOM-MoE tree (``blocks/moe/{up,down}`` stacked (L, E, ...), and
``blocks/router/gate/kernel``, no ``mlp``) converts the same way; with
``specs=bloom_moe.moe_specs(np_tree)`` each rank converts only its experts
(over "expert") and its FFN shard of them (over "tensor").

Under pipeline parallelism ``specs=bloom.pp_specs(np_tree)`` shards the
stacked layer dim over "pipe", so each rank converts its stage's layers
only; with ``stage_layer_counts`` the tree carries the JAX package's padded
uneven layout (``repartition_blocks``) and each stage keeps its live
layers, dropping the padded slots.
"""
from __future__ import annotations

from typing import Any, Iterator, Optional

import numpy as np
import torch

from pipegoose_tpu_torch._device import resolve_device


def _to_tensor(arr, dtype, device) -> torch.Tensor:
    """A tensor with storage of its own: never an alias of the caller's
    array, which an optimizer's in-place update would otherwise rewrite."""
    host = np.int8 if dtype == torch.int8 else np.float32
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(arr, host)))
    return t.to(device=device, dtype=dtype, copy=True)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


# the exact dtypes of a quantized leaf's planes (quant.weights)
_QUANT_DTYPES = {"q": torch.int8, "scale": torch.float32}


def _convert(tree, fn):
    """``fn(leaf, dtype)`` over a tree: ``None`` (the config's dtype)
    everywhere but the ``q``/``scale`` planes of a quantized leaf."""
    if isinstance(tree, dict):
        if "q" in tree and not isinstance(tree["q"], dict):   # not an attn/q subtree
            return {k: fn(v, _QUANT_DTYPES.get(k)) for k, v in tree.items()}
        return {k: _convert(v, fn) for k, v in tree.items()}
    return fn(tree, None)


def params_from_jax(np_tree: dict, config, device="cuda", specs: Optional[Any] = None,
                    ctx=None, stage_layer_counts=None, pipe_axis: str = "pipe") -> dict:
    """The tree's own top-level keys (BLOOM's ``{"embed", "embed_ln",
    "blocks", "ln_f"}``, Llama's and Mixtral's ``{"embed", "blocks",
    "ln_f"[, "lm_head"]}``, ALBERT's ``{"embed", "map_in", "layer",
    "mlm"}``) with every leaf a tensor of ``config.dtype`` on ``device``;
    ``"blocks"``, where the tree has it, becomes a list of
    ``config.n_layer`` per-layer dicts (ALBERT's shared ``"layer"`` has no
    stacked dim and stays one dict) with the same keys as the JAX
    ``blocks`` subtree (a quantized leaf keeps its int8 ``q`` and float32
    ``scale``). No leaf requires grad; ``trainer.step.make_optimizer``
    turns them into trainable leaves. With ``specs`` (the JAX-layout spec
    tree, stacked block leaves with a leading None as ``bloom.tp_specs`` of
    the numpy tree gives them), each leaf is first cut to this rank's shard
    by the coordinates of ``ctx`` (the current context by default).

    With specs that shard the stacked layer dim (``bloom.pp_specs``) the
    list holds this stage's ``n_layer / P`` layers; with
    ``stage_layer_counts`` (the JAX padded layout of uneven stages, its
    ``L_max = max(counts)`` slots a stage) the first
    ``stage_layer_counts[stage]`` of them, the stage being this rank's
    coordinate on ``pipe_axis``."""
    dev = resolve_device(device)
    if "blocks" not in np_tree:   # ALBERT: one shared layer, nothing stacked
        if specs is not None:
            from pipegoose_tpu_torch.nn.parallel import shard_tree

            np_tree = shard_tree(np_tree, specs, ctx)
        return {key: _map(np_tree[key], lambda a: _to_tensor(a, config.dtype, dev))
                for key in _top_keys(np_tree)}
    n_layer = config.n_layer
    if specs is not None:
        from pipegoose_tpu_torch.nn.parallel import shard_tree

        n_stacked = np.shape(next(_leaves(np_tree["blocks"])))[0]
        np_tree = shard_tree(np_tree, specs, ctx)
        n_local = np.shape(next(_leaves(np_tree["blocks"])))[0]
        n_layer = n_layer * n_local // n_stacked
    if stage_layer_counts is not None:
        from pipegoose_tpu_torch.distributed.functional import axis_index

        counts = [int(c) for c in stage_layer_counts]
        if sum(counts) != config.n_layer:
            raise ValueError(f"stage_layer_counts {tuple(counts)} do not sum to "
                             f"n_layer={config.n_layer}")
        n_layer = max(counts)   # the padded slots a stage holds

    def conv(a, dtype=None):
        return _to_tensor(a, dtype or config.dtype, dev)

    for leaf in _leaves(np_tree["blocks"]):
        if np.shape(leaf)[0] != n_layer:
            raise ValueError(
                f"per-layer leaf of shape {tuple(np.shape(leaf))} does not "
                f"stack n_layer={n_layer} layers")
    if stage_layer_counts is not None:
        n_layer = counts[axis_index(pipe_axis)]
    return {key: ([_convert(np_tree["blocks"], lambda a, d, i=i: conv(a[i], d))
                   for i in range(n_layer)] if key == "blocks"
                  else _map(np_tree[key], conv))
            for key in _top_keys(np_tree)}


def params_to_jax(params: dict) -> dict:
    """The reverse of :func:`params_from_jax`: a float32 numpy tree in the
    stacked JAX layout (per-layer leaves stacked on a leading axis). Works
    on parameters and on a tree of their gradients alike. The arrays are
    copies: a later in-place update of the params does not reach them."""
    def host(t):
        return t.detach().to("cpu", torch.float32, copy=True).numpy()

    def stack(*per_layer):
        if isinstance(per_layer[0], dict):
            return {k: stack(*(p[k] for p in per_layer)) for k in per_layer[0]}
        return np.stack([host(t) for t in per_layer])

    return {key: (stack(*params["blocks"]) if key == "blocks"
                  else _map(params[key], host))
            for key in _top_keys(params)}


def param_leaves(params: dict) -> Iterator[torch.Tensor]:
    """Every leaf tensor of the port's params, in a fixed order: the top-level
    keys in :func:`_top_keys`' order (BLOOM's ``embed``, ``embed_ln``,
    ``blocks``, ``ln_f``, as before any other family came), each block's
    leaves layer by layer."""
    for key in _top_keys(params):
        if key == "blocks":
            for blk in params["blocks"]:
                yield from _leaves(blk)
        else:
            yield from _leaves(params[key])


def grads_of(params: dict) -> dict:
    """The tree of ``.grad`` of every leaf (zeros where a leaf got none),
    in the params' own layout; feed it to :func:`params_to_jax`."""
    def grad(t):
        return t.grad if t.grad is not None else torch.zeros_like(t)

    return {k: ([_map(b, grad) for b in v] if k == "blocks" else _map(v, grad))
            for k, v in params.items()}


# the order of the top-level keys the families share; any other key follows
# in the tree's own order
_TOP_ORDER = ("embed", "embed_ln", "blocks", "ln_f", "lm_head")


def _top_keys(tree: dict) -> list:
    """The tree's own top-level keys, those of ``_TOP_ORDER`` first in that
    order: BLOOM's tree (``embed``, ``embed_ln``, ``blocks``, ``ln_f``) and
    the RoPE families' (``embed``, ``blocks``, ``ln_f`` and an untied
    ``lm_head``) alike, whatever order a JAX-derived numpy tree's dict
    carries its keys in."""
    known = [k for k in _TOP_ORDER if k in tree]
    return known + [k for k in tree if k not in _TOP_ORDER]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
