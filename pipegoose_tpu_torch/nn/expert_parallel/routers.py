"""MoE token routers.

The counterpart of ``pipegoose_tpu/nn/expert_parallel/routers.py``: the
gate projection in float32, Switch-style multiplicative training noise
(:class:`SwitchNoisePolicy`), softmax, top-k selection, the Switch
load-balancing aux loss, the ST-MoE router z-loss, and expert-capacity
truncation. The router emits dense one-hot ``dispatch`` and gate-weighted
``combine`` tensors of static shape (tokens, experts, capacity), so the
MoE layer is two products around an ``all_to_all``.

Where this parts from the JAX router:

- the noise key is an integer seed (or a ``torch.Generator``), not a JAX
  PRNG key. A seed is turned into a generator on the logits' device inside
  the call, so a block rerun under ``torch.utils.checkpoint`` draws the same
  noise (the checkpoint restores the global RNG state, never an explicit
  generator's). The draws cannot match ``jax.random.uniform``'s.
- ``jax.lax.top_k`` orders equal values lower index first; ``torch.topk``
  promises no order for ties on CUDA, so the pick is a stable descending
  sort, which keeps JAX's rule on every device.
- a token that lost its slot has a slot index >= C, whose ``one_hot`` row
  is zero in JAX; ``torch.nn.functional.one_hot`` would raise, so the slot
  rows come from a comparison with ``arange(C)``, zero for such an index.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Union

import torch

Seed = Union[int, torch.Generator]


class RouterOutput(NamedTuple):
    dispatch: torch.Tensor   # (T, E, C) one-hot: token t -> slot c of expert e
    combine: torch.Tensor    # (T, E, C) gate-weighted dispatch
    aux_loss: torch.Tensor   # scalar, Switch load-balancing loss
    z_loss: torch.Tensor     # scalar, ST-MoE router z-loss


def generator_for(key: Seed, device) -> torch.Generator:
    """``key`` itself if it is a generator, else a new generator on
    ``device`` seeded with the integer ``key``."""
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key) % (2 ** 63))
    return gen


@dataclasses.dataclass(frozen=True)
class SwitchNoisePolicy:
    """Multiplicative jitter on router logits during training:
    ``logits *= U[1 - eps, 1 + eps]``."""

    eps: float = 0.1

    def apply(self, key: Seed, logits: torch.Tensor) -> torch.Tensor:
        gen = generator_for(key, logits.device)
        u = torch.rand(logits.shape, generator=gen, dtype=logits.dtype,
                       device=logits.device)
        lo, hi = 1.0 - self.eps, 1.0 + self.eps
        return logits * (lo + (hi - lo) * u)


def slot_one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    """float32 ``one_hot(index, n)`` with a zero row where ``index >= n``
    (``jax.nn.one_hot``'s rule for an index out of range)."""
    return (index[:, None] == torch.arange(n, device=index.device)[None, :]).float()


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of each row,
    descending, the lower index first among equal values (``lax.top_k``)."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


@dataclasses.dataclass(frozen=True)
class TopKRouter:
    """k-choice router with capacity. Call with the gate params
    ``{"gate": {"kernel": (H, E)[, "bias": (E,)]}}`` and flat tokens."""

    num_experts: int
    top_k: int = 1
    capacity_factor: float = 1.25
    noise: Optional[SwitchNoisePolicy] = SwitchNoisePolicy()
    normalize_gates: bool = True   # for k > 1, renormalize the kept gates

    def capacity(self, n_tokens: int) -> int:
        # ceil, per the GShard/Switch convention: floor would drop tokens
        # under perfectly balanced routing despite the headroom factor
        return max(1, math.ceil(n_tokens * self.top_k * self.capacity_factor
                                / self.num_experts))

    def __call__(self, params: dict, x: torch.Tensor, key: Optional[Seed] = None,
                 train: bool = False, capacity: Optional[int] = None) -> RouterOutput:
        """``x``: (T, H) flat tokens, of this rank (capacity counts its T).
        ``key``: the noise's integer seed or generator, needed when
        ``train`` and the router has noise (ValueError without)."""
        T = x.shape[0]
        E, k = self.num_experts, self.top_k
        C = capacity if capacity is not None else self.capacity(T)

        # bf16 x bf16 products are exact in float32: the float32 product is
        # JAX's dot with a float32 accumulator
        logits = torch.matmul(x.float(), params["gate"]["kernel"].float())
        if "bias" in params["gate"]:
            logits = logits + params["gate"]["bias"].float()
        if train and self.noise is not None:
            if key is None:
                raise ValueError("train-time routing needs a seed for the noise")
            logits = self.noise.apply(key, logits)

        probs = torch.softmax(logits, dim=-1)   # (T, E)

        # z-loss on the pre-softmax logits
        z = torch.logsumexp(logits, dim=-1)
        z_loss = torch.mean(z ** 2)

        # top-k expert choices per token, by decreasing priority
        gates, idx = top_k(probs, k)   # (T, k)
        masks = torch.nn.functional.one_hot(idx, E).float()   # (T, k, E)

        # Switch aux loss: E * sum_e f_e * P_e, f_e the fraction of tokens
        # whose (any-priority) choice is e, P_e the mean router probability
        f = masks.sum(dim=1).mean(dim=0) / k   # (E,)
        p = probs.mean(dim=0)                  # (E,)
        aux_loss = E * torch.sum(f * p)

        # capacity assignment: priority j's slots come after every j' < j's
        dispatch = torch.zeros((T, E, C), dtype=torch.float32, device=x.device)
        combine = torch.zeros((T, E, C), dtype=torch.float32, device=x.device)
        offset = torch.zeros((E,), dtype=torch.float32, device=x.device)
        kept_gates, kept_slots = [], []
        for j in range(k):
            m = masks[:, j]   # (T, E)
            pos = torch.cumsum(m, dim=0) - m + offset[None, :]   # (T, E)
            keep = (pos < C).float() * m   # (T, E)
            # the slot index of this token's choice; >= C where it was dropped
            slot = slot_one_hot(torch.sum(pos * m, dim=-1).long(), C)   # (T, C)
            d_j = keep[:, :, None] * slot[:, None, :]   # (T, E, C)
            dispatch = dispatch + d_j
            kept_gates.append(gates[:, j] * keep.sum(dim=-1))
            kept_slots.append(d_j)
            offset = offset + m.sum(dim=0)

        g = torch.stack(kept_gates, dim=1)   # (T, k), zeros where dropped
        if self.normalize_gates and k > 1:
            g = g / torch.clamp_min(g.sum(dim=1, keepdim=True), 1e-9)
        for j in range(k):
            combine = combine + g[:, j][:, None, None] * kept_slots[j]

        return RouterOutput(dispatch, combine, aux_loss, z_loss)


def Top1Router(num_experts: int, **kw) -> TopKRouter:
    """Switch-Transformer router."""
    return TopKRouter(num_experts=num_experts, top_k=1, **kw)


def Top2Router(num_experts: int, **kw) -> TopKRouter:
    """GShard-style 2-choice router."""
    return TopKRouter(num_experts=num_experts, top_k=2, **kw)
