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
"""
from __future__ import annotations

from typing import Iterator

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
        if "q" in tree:
            return {k: fn(v, _QUANT_DTYPES.get(k)) for k, v in tree.items()}
        return {k: _convert(v, fn) for k, v in tree.items()}
    return fn(tree, None)


def params_from_jax(np_tree: dict, config, device="cuda") -> dict:
    """``{"embed", "embed_ln", "blocks", "ln_f"}`` with every leaf a tensor
    of ``config.dtype`` on ``device``; ``"blocks"`` becomes a list of
    ``config.n_layer`` per-layer dicts with the same keys as the JAX
    ``blocks`` subtree (a quantized leaf keeps its int8 ``q`` and float32
    ``scale``). No leaf requires grad; ``trainer.step.make_optimizer``
    turns them into trainable leaves."""
    dev = resolve_device(device)

    def conv(a, dtype=None):
        return _to_tensor(a, dtype or config.dtype, dev)

    n_layer = config.n_layer
    for leaf in _leaves(np_tree["blocks"]):
        if np.shape(leaf)[0] != n_layer:
            raise ValueError(
                f"per-layer leaf of shape {tuple(np.shape(leaf))} does not "
                f"stack n_layer={n_layer} layers")
    return {
        "embed": _map(np_tree["embed"], conv),
        "embed_ln": _map(np_tree["embed_ln"], conv),
        "blocks": [_convert(np_tree["blocks"], lambda a, d, i=i: conv(a[i], d))
                   for i in range(n_layer)],
        "ln_f": _map(np_tree["ln_f"], conv),
    }


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

    return {
        "embed": _map(params["embed"], host),
        "embed_ln": _map(params["embed_ln"], host),
        "blocks": stack(*params["blocks"]),
        "ln_f": _map(params["ln_f"], host),
    }


def param_leaves(params: dict) -> Iterator[torch.Tensor]:
    """Every leaf tensor of the port's params, in a fixed order."""
    for key in ("embed", "embed_ln"):
        yield from _leaves(params[key])
    for blk in params["blocks"]:
        yield from _leaves(blk)
    yield from _leaves(params["ln_f"])


def grads_of(params: dict) -> dict:
    """The tree of ``.grad`` of every leaf (zeros where a leaf got none),
    in the params' own layout; feed it to :func:`params_to_jax`."""
    def grad(t):
        return t.grad if t.grad is not None else torch.zeros_like(t)

    return {k: ([_map(b, grad) for b in v] if k == "blocks" else _map(v, grad))
            for k, v in params.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
