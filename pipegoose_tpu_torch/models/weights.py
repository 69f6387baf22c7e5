"""The JAX parameter tree, as numpy arrays, turned into the port's params.

The JAX tree stacks every per-layer leaf on a leading ``n_layer`` axis
(``bloom.init_params``) and lays dense kernels out ``(in, out)``. The
port keeps that kernel layout, so no transpose is needed, and splits the
stack into a list of per-layer dicts (views into one tensor per leaf) so
that the layer loop indexes a Python list instead of slicing every leaf
on every step.
"""
from __future__ import annotations

import numpy as np
import torch

from pipegoose_tpu_torch._device import resolve_device


def _to_tensor(arr, dtype, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(arr, np.float32)))
    return t.to(device=device, dtype=dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_tree: dict, config, device="cuda") -> dict:
    """``{"embed", "embed_ln", "blocks", "ln_f"}`` with every leaf a tensor
    of ``config.dtype`` on ``device``; ``"blocks"`` becomes a list of
    ``config.n_layer`` per-layer dicts with the same keys as the JAX
    ``blocks`` subtree."""
    dev = resolve_device(device)
    conv = lambda a: _to_tensor(a, config.dtype, dev)  # noqa: E731
    stacked = _map(np_tree["blocks"], conv)
    n_layer = config.n_layer
    for leaf in _leaves(stacked):
        if leaf.shape[0] != n_layer:
            raise ValueError(
                f"per-layer leaf of shape {tuple(leaf.shape)} does not stack "
                f"n_layer={n_layer} layers")
    return {
        "embed": _map(np_tree["embed"], conv),
        "embed_ln": _map(np_tree["embed_ln"], conv),
        "blocks": [_map(stacked, lambda t, i=i: t[i]) for i in range(n_layer)],
        "ln_f": _map(np_tree["ln_f"], conv),
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
