"""Expert computation with all_to_all dispatch.

The counterpart of ``pipegoose_tpu/nn/expert_parallel/experts.py``: the
GShard dataflow with static shapes,

    local tokens --product with dispatch--> (E, C, H)
    all_to_all over the expert axis        -> (E_local, ep*C, H)
    per-expert MLP (one batched product per projection)
    all_to_all back                        -> (E, C, H)
    --product with combine--> local tokens

so only capacity-bounded expert inputs cross the wire, and expert
gradients stay on the rank that owns the expert. The JAX package runs the
dispatch, the combine and the experts' products as plain XLA products
(no Pallas kernel): here they are ``torch.einsum`` / ``torch.bmm``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from pipegoose_tpu_torch._device import resolve_device
from pipegoose_tpu_torch.distributed.functional import (
    all_to_all,
    axis_size,
    copy_to_tensor_group,
    reduce_from_tensor_group,
)
from pipegoose_tpu_torch.nn.expert_parallel.routers import RouterOutput
from pipegoose_tpu_torch.nn.parallel import tree_leaves


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (PyTorch's default
    GELU is the erf form)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def init_experts(seed: int, num_local_experts: int, hidden: int, ffn: int,
                 dtype=torch.float32, std: float = 0.02, device="cuda") -> dict:
    """Expert-stacked MLP params, leading dim the local experts: kernels
    normal(0, ``std``) from ``numpy.random.default_rng(seed)`` (up, then
    down), zero biases, as tensors of ``dtype`` on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def normal(shape):
        w = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
        return torch.from_numpy(w).to(device=dev, dtype=dtype)

    up = normal((num_local_experts, hidden, ffn))
    down = normal((num_local_experts, ffn, hidden))
    return {
        "up": {"kernel": up,
               "bias": torch.zeros((num_local_experts, ffn), dtype=dtype, device=dev)},
        "down": {"kernel": down,
                 "bias": torch.zeros((num_local_experts, hidden), dtype=dtype, device=dev)},
    }


def expert_mlp_specs(expert_axis: str = "expert", tensor_axis: Optional[str] = "tensor"):
    """Specs of stacked expert MLP params (L, E, in, out): experts over the
    expert axis, the FFN dim Megatron-sharded over tensor. The JAX layout's
    (leading None for the layer dim); ``bloom_moe.moe_specs`` drops it on the
    port's per-layer tree."""
    t, e = tensor_axis, expert_axis
    return {
        "up": {"kernel": (None, e, None, t), "bias": (None, e, t)},
        "down": {"kernel": (None, e, t, None), "bias": (None, e, None)},
    }


def expert_mlp(params: dict, x: torch.Tensor, act: Callable = gelu,
               tp_axis: Optional[str] = None) -> torch.Tensor:
    """(E_local, S, H) -> (E_local, S, H), one batched product per
    projection, each accumulated in float32 and rounded to ``x``'s dtype,
    the bias added after the rounding. With ``tp_axis`` each expert's FFN
    dim is Megatron-sharded over the tensor axis (up column, down row and a
    reduce)."""
    if tp_axis is not None:
        # f-operator: identity forward, all-reduce backward; without it each
        # tensor rank's input cotangent is only its FFN shard's part
        x = copy_to_tensor_group(x, tp_axis)
    h = torch.bmm(x, params["up"]["kernel"])
    h = act(h + params["up"]["bias"][:, None, :])
    out = torch.bmm(h, params["down"]["kernel"])
    if tp_axis is not None:
        out = reduce_from_tensor_group(out, tp_axis)
    return out + params["down"]["bias"][:, None, :]


def moe_layer(expert_params: dict, x: torch.Tensor, routing: RouterOutput,
              axis_name: Optional[str], act: Optional[Callable] = gelu,
              tp_axis: Optional[str] = None,
              mlp_fn: Optional[Callable] = None) -> torch.Tensor:
    """Dispatch -> expert MLP -> combine. ``x``: (..., H) local tokens;
    ``expert_params`` hold this rank's E_local experts (stacked leading dim);
    ``routing`` covers the E = E_local x ep global experts. ``mlp_fn(params,
    buckets, tp_axis)`` replaces the default GELU MLP (e.g. a SwiGLU)."""
    orig_shape = x.shape
    h = x.reshape(-1, orig_shape[-1])   # (T, H)
    dispatch, combine = routing.dispatch, routing.combine
    E = dispatch.shape[1]
    e_local = tree_leaves(expert_params)[0].shape[0]
    ep = axis_size(axis_name)
    if e_local * ep != E:
        raise ValueError(f"router has {E} experts but params hold {e_local} x ep={ep}")

    # (T, H) -> (E, C, H): capacity-bucketed expert inputs
    buckets = torch.einsum("tec,th->ech", dispatch.to(h.dtype), h)
    if ep > 1:
        # each rank keeps its E_local experts, gains every rank's C slots
        buckets = all_to_all(buckets, axis_name, split_dim=0, concat_dim=1)
    if mlp_fn is not None:
        out = mlp_fn(expert_params, buckets, tp_axis)
    else:
        out = expert_mlp(expert_params, buckets, act, tp_axis=tp_axis)
    if ep > 1:
        out = all_to_all(out, axis_name, split_dim=1, concat_dim=0)
    # (E, C, H) -> (T, H), gate-weighted
    y = torch.einsum("tec,ech->th", combine.to(out.dtype), out)
    return y.reshape(orig_shape)
