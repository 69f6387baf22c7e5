"""BLOOM pieces the serving path needs, in PyTorch.

The counterpart of ``pipegoose_tpu/models/bloom.py``: the config, the
ALiBi slopes, the tanh GeLU, the tied-embedding LM head, and the random
init scheme drawn from numpy so that full-width weights can be made on
the card from a seed. The training forward and loss wait for the
training slice of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e9   # finite, as in the JAX package: masked scores stay finite


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    vocab_size: int = 250880
    hidden_size: int = 64
    n_layer: int = 2
    n_head: int = 8
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    # dtype of activations/params at run time: float32 for parity,
    # bfloat16 for throughput
    dtype: torch.dtype = torch.float32
    # set when the embedding was padded for TP divisibility: the true
    # vocab size; padded logit slots never win a greedy pick
    valid_vocab_size: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_head

    @classmethod
    def bloom_560m(cls, **kw) -> "BloomConfig":
        return cls(vocab_size=250880, hidden_size=1024, n_layer=24, n_head=16, **kw)


def init_params_numpy(config: BloomConfig, seed: int) -> dict:
    """Random weights in the JAX parameter layout, as float32 numpy arrays:
    HF's scheme as ``bloom.init_params`` draws it (normal(0,
    initializer_range) for dense and embedding kernels, zero biases,
    ones/zeros LayerNorms, per-layer leaves stacked on a leading
    ``n_layer`` axis), from ``numpy.random.default_rng(seed)``. Feed the
    tree to ``weights.params_from_jax``."""
    h, v, L = config.hidden_size, config.vocab_size, config.n_layer
    std = np.float32(config.initializer_range)
    rng = np.random.default_rng(seed)

    def dense(shape):
        w = rng.standard_normal(shape, dtype=np.float32)
        w *= std
        return w

    def ln(*lead):
        return {"scale": np.ones((*lead, h), np.float32),
                "bias": np.zeros((*lead, h), np.float32)}

    return {
        "embed": {"weight": dense((v, h))},
        "embed_ln": ln(),
        "blocks": {
            "ln_1": ln(L),
            "attn": {
                "qkv": {"kernel": dense((L, h, 3 * h)),
                        "bias": np.zeros((L, 3 * h), np.float32)},
                "out": {"kernel": dense((L, h, h)),
                        "bias": np.zeros((L, h), np.float32)},
            },
            "ln_2": ln(L),
            "mlp": {
                "up": {"kernel": dense((L, h, 4 * h)),
                       "bias": np.zeros((L, 4 * h), np.float32)},
                "down": {"kernel": dense((L, 4 * h, h)),
                         "bias": np.zeros((L, h), np.float32)},
            },
        },
        "ln_f": ln(),
    }


def alibi_slopes(n_head: int) -> np.ndarray:
    """Per-head slopes from the ALiBi paper's geometric recipe (matches
    HF build_alibi_tensor's closest-power-of-2 construction)."""
    closest = 2 ** math.floor(math.log2(n_head))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** i for i in range(1, closest + 1)]
    if closest != n_head:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        n_extra = min(closest, n_head - closest)
        slopes += [extra_base ** i for i in range(1, 2 * n_extra, 2)]
    return np.asarray(slopes, dtype=np.float32)


def bloom_gelu(x: torch.Tensor) -> torch.Tensor:
    """Megatron-style tanh gelu with HF's truncated constant 0.79788456
    (not the full-precision sqrt(2/pi)), as the JAX package keeps it."""
    return x * 0.5 * (1.0 + torch.tanh(0.79788456 * x * (1.0 + 0.044715 * x * x)))


def logits_fn(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """LM head tied to the embedding: float32 logits ``hidden @ Wᵀ``.

    The (V, H) embedding is used where it lies, never copied to float32:
    in a bf16 run cuBLAS accumulates in float32, the product is rounded
    to bf16 once, and the result is cast up."""
    w = params["embed"]["weight"]
    return torch.matmul(hidden, w.t()).float()
