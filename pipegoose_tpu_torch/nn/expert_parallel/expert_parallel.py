"""ExpertParallel: turn a dense model's MLPs into expert-parallel MoE.

The counterpart of ``pipegoose_tpu/nn/expert_parallel/expert_parallel.py``.
The transform is on the params tree: each dense MLP leaf is tiled into
``num_experts`` expert copies (optionally perturbed, so that the experts
diverge), and a router gate is added. It takes the port's per-layer tree
(``blocks`` a list of per-layer dicts, as ``models.weights.params_from_jax``
builds it), of tensors on any device: the random draws run where the
leaves are, from an integer seed or a ``torch.Generator`` (they cannot
match ``jax.random``'s).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from pipegoose_tpu_torch._device import resolve_device
from pipegoose_tpu_torch.distributed.parallel_context import ParallelContext
from pipegoose_tpu_torch.nn.expert_parallel.routers import Seed, generator_for
from pipegoose_tpu_torch.nn.parallel import Parallel, shard_tree, tree_leaves, tree_map


class ExpertParallel(Parallel):
    """Expand BLOOM-style dense MLP params into MoE params (the dense MLP
    is every expert's template; ``jitter`` adds per-expert noise, ``x * (1
    + jitter * normal)``, so that tiled experts do not stay identical)."""

    def __init__(self, num_experts: int, expert_axis: str = "expert",
                 tensor_axis: Optional[str] = "tensor", jitter: float = 0.0,
                 parallel_context: Optional[ParallelContext] = None):
        super().__init__(parallel_context)
        self.num_experts = num_experts
        self.expert_axis = expert_axis
        self.tensor_axis = tensor_axis
        self.jitter = jitter
        ep_size = self.parallel_context.axis_size(expert_axis)
        if num_experts % ep_size != 0:
            raise ValueError(
                f"num_experts={num_experts} must divide over expert axis "
                f"size {ep_size}")

    def expand_mlp(self, mlp_params: dict, key: Optional[Seed] = None) -> dict:
        """One layer's dense MLP leaves -> expert leaves, ``num_experts``
        copies stacked on a new leading dim ((H, F) -> (E, H, F); the JAX
        method takes the stacked (L, H, F) leaves). Every result owns its
        storage. With ``jitter`` and a ``key`` each leaf is then scaled by
        ``1 + jitter * normal``, one draw per leaf in tree order."""
        E = self.num_experts

        def tile(x):
            return x.unsqueeze(0).expand((E, *x.shape)).clone()

        experts = tree_map(tile, mlp_params)
        if self.jitter and key is not None:
            first = tree_leaves(experts)[0]
            gen = generator_for(key, first.device)

            def perturb(x):
                noise = torch.randn(x.shape, generator=gen, dtype=x.dtype,
                                    device=x.device)
                return x * (1 + self.jitter * noise)

            experts = tree_map(perturb, experts)
        return experts

    def init_router(self, key: Seed, n_layer: int, hidden: int, dtype=torch.float32,
                    device="cuda") -> dict:
        """``{"gate": {"kernel": (n_layer, hidden, E)}}`` on ``device``,
        normal(0, 0.02) drawn in float32 and cast. An integer ``key`` draws
        on ``device``; a generator draws on its own device."""
        dev = resolve_device(device)
        gen = generator_for(key, dev)
        w = torch.randn((n_layer, hidden, self.num_experts), generator=gen,
                        dtype=torch.float32, device=gen.device) * 0.02
        return {"gate": {"kernel": w.to(device=dev, dtype=dtype)}}

    def expert_specs(self) -> dict:
        from pipegoose_tpu_torch.nn.expert_parallel.experts import expert_mlp_specs

        return expert_mlp_specs(self.expert_axis, self.tensor_axis)

    def from_dense(self, params: dict, key: Seed, hidden: Optional[int] = None) -> dict:
        """Upcycle the port's per-layer dense BLOOM tree into a BLOOM-MoE
        tree: each layer's ``mlp`` becomes ``moe`` (the dense MLP tiled over
        the experts, jittered by draws from ``key``) and gets a fresh router
        gate (drawn after the jitter, from the same generator). The trunk's
        leaves are the input's own tensors."""
        if not isinstance(params["blocks"], list):
            raise TypeError("from_dense takes the port's per-layer tree (blocks a "
                            "list, as models.weights.params_from_jax builds it)")
        mlps = [blk["mlp"] for blk in params["blocks"]]
        first = tree_leaves(mlps)[0]
        gen = generator_for(key, first.device)
        if hidden is None:
            hidden = params["embed"]["weight"].shape[-1]
        moes = [self.expand_mlp(m, gen if self.jitter else None) for m in mlps]
        gate = self.init_router(gen, len(mlps), hidden, first.dtype,
                                device=first.device)["gate"]["kernel"]
        blocks = []
        for i, blk in enumerate(params["blocks"]):
            blk = {k: v for k, v in blk.items() if k != "mlp"}
            blk["moe"] = moes[i]
            blk["router"] = {"gate": {"kernel": gate[i].clone()}}
            blocks.append(blk)
        return {**params, "blocks": blocks}

    def parallelize(self, params: Any):
        """(this rank's shard of a BLOOM-MoE tree, its specs)."""
        from pipegoose_tpu_torch.models.bloom_moe import moe_specs

        specs = moe_specs(params, tp_axis=self.tensor_axis or "tensor",
                          ep_axis=self.expert_axis)
        return shard_tree(params, specs, self.parallel_context), specs
