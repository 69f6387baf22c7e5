"""Policy-table-driven HF checkpoint ingestion.

The counterpart of ``pipegoose_tpu/models/convert.py``, with its own copy
of the plain-numpy helpers. Each model family ships a RULES table mapping
HF state-dict names to paths of the stacked JAX-layout tree, and this module
executes it: one generic converter instead of a function per family.
:func:`params_from_state_dict` builds the stacked numpy tree (the tree the
JAX converter builds), which ``models.weights.params_from_jax`` turns into
the port's per-layer params on a device.

Rule format (one dict per target leaf):
  path:      tree path, "/"-separated ("blocks/attn/q/kernel")
  hf:        HF state-dict name; "{l}" = layer index, "{e}" = expert
             index (the placeholders decide the stacking)
  transpose: torch Linear stores (out, in); the kernels are (in, out)
  optional:  skip silently if the HF tensor is absent (an untied lm_head on
             a tied checkpoint)

``register_family`` + ``from_hf`` hand over any supported HF model and give
back (config, params, module). ``transformers`` is never imported here: the
HF model arrives built.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def _t(x) -> np.ndarray:
    """A torch tensor (any dtype, any device) as a float32 numpy array."""
    return x.detach().to("cpu", torch.float32).numpy()


def _set_in(tree: dict, path: list, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def params_from_state_dict(sd: dict, rules: list, n_layer: int, n_experts: int = 0,
                           prefix: str = "") -> dict:
    """Execute a RULES table against an HF state dict -> the stacked float32
    numpy tree (per-layer leaves on a leading n_layer axis, experts on the
    next)."""
    out: dict = {}
    for rule in rules:
        hf = prefix + rule["hf"]
        tr = rule.get("transpose", False)

        def get(name):
            m = _t(sd[name])
            return m.T if tr else m

        try:
            if "{e}" in hf:
                arr = np.stack([np.stack([get(hf.format(l=l, e=e)) for e in range(n_experts)])
                                for l in range(n_layer)])
            elif "{l}" in hf:
                arr = np.stack([get(hf.format(l=l)) for l in range(n_layer)])
            else:
                arr = get(hf)
        except KeyError:
            if rule.get("optional"):
                continue
            raise
        _set_in(out, rule["path"].split("/"), np.ascontiguousarray(arr, np.float32))
    return out


def state_dict_from_params(params: dict, rules: list, prefix: str = "") -> dict:
    """The inverse: the stacked tree (numpy, or the port's params through
    ``weights.params_to_jax``) -> an HF-named numpy state dict."""
    def get_in(tree, path):
        for k in path:
            if k not in tree:
                return None
            tree = tree[k]
        return tree

    out = {}
    for rule in rules:
        leaf = get_in(params, rule["path"].split("/"))
        if leaf is None:
            if rule.get("optional"):
                continue
            raise KeyError(rule["path"])
        arr = np.asarray(leaf)
        tr = rule.get("transpose", False)
        hf = prefix + rule["hf"]
        if "{e}" in hf:
            for l in range(arr.shape[0]):
                for e in range(arr.shape[1]):
                    m = arr[l, e]
                    out[hf.format(l=l, e=e)] = m.T if tr else m
        elif "{l}" in hf:
            for l in range(arr.shape[0]):
                m = arr[l]
                out[hf.format(l=l)] = m.T if tr else m
        else:
            out[hf] = arr.T if tr else arr
    return out


# -- family registry -------------------------------------------------------------

_FAMILIES: dict = {}


def register_family(model_type: str, loader: Callable) -> None:
    """``loader(hf_model, dtype, device) -> (config, params, module)``."""
    _FAMILIES[model_type] = loader


def from_hf(model: Any, dtype=torch.float32, device="cuda"):
    """Convert any registered HF model: returns (config, params, module),
    the params the port's per-layer tree of ``dtype`` on ``device`` (the
    card unless the caller asks for the CPU) and ``module`` the port's model
    module (``forward``, ``loss_fn``, ``specs``, ``generate`` live there)."""
    from pipegoose_tpu_torch.models import hf as _hf  # noqa: F401  (registers)

    mt = getattr(model.config, "model_type", None)
    if mt not in _FAMILIES:
        raise NotImplementedError(f"model_type={mt!r} has no registered family "
                                  f"(supported: {sorted(_FAMILIES)})")
    return _FAMILIES[mt](model, dtype, device)
