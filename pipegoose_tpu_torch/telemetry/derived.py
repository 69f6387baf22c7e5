"""Derived gauges: MFU, tokens/s, device-memory occupancy, and the card
spec tables they divide by.

The counterpart of the host half of ``pipegoose_tpu/telemetry/derived.py``
(its lines 1-231). The half that reads XLA's compiled HLO
(``iter_collectives``, ``collective_bytes``, ``compiled_step_stats``,
``step_flops``) waits for ROADMAP.md queue A, item A13b.

The tables hold the cards the port runs on, and no TPU row. Every H100
figure is NVIDIA's datasheet number (H100 Tensor Core GPU datasheet:
bf16 dense tensor-core peak, HBM bandwidth and capacity, NVLink
bandwidth; the DGX H100 datasheet for the one 400 Gb/s ConnectX-7 port
per GPU). The lookup takes the FIRST key that is a substring of the
lower-cased device name, so the PCIe row comes before the SXM row, whose
key ("h100") the PCIe name also contains; an SXM card reads "NVIDIA H100
80GB HBM3". "cpu" rows are placeholders: finite, clearly not hardware.
The interconnect table keeps the JAX name "ICI" for the intra-node
fabric, here NVLink 4's aggregate per-GPU bandwidth.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional

import torch

from pipegoose_tpu_torch.utils.profiler import device_memory_stats

# per-card peak bf16 FLOP/s, dense (the MFU denominator)
PEAK_FLOPS: Dict[str, float] = {
    "h100 pcie": 756e12,
    "h100": 989e12,
    "cpu": 1e12,
}

# per-card intra-node interconnect bandwidth (NVLink), B/s
PEAK_ICI_BYTES: Dict[str, float] = {
    "h100 pcie": 600e9,    # NVLink bridge
    "h100": 900e9,         # NVLink 4, 18 links
    "cpu": 10e9,
}

# per-card network bandwidth across nodes, B/s
PEAK_DCI_BYTES: Dict[str, float] = {
    "h100 pcie": 50e9,     # one 400 Gb/s port
    "h100": 50e9,          # DGX H100: one 400 Gb/s ConnectX-7 per GPU
    "cpu": 1e9,
}

# per-card device-memory capacity, bytes
HBM_BYTES: Dict[str, float] = {
    "h100 pcie": 80 * 1024**3,
    "h100": 80 * 1024**3,
    "cpu": 16 * 1024**3,
}

# per-card device-memory bandwidth, B/s
HBM_BW_BYTES: Dict[str, float] = {
    "h100 pcie": 2.0e12,   # HBM2e
    "h100": 3.35e12,       # HBM3
    "cpu": 50e9,
}

# mesh axes that cross the network between nodes instead of the
# intra-node fabric ("diloco", the outer loop of optim/diloco.py)
DCI_AXES: tuple = ("diloco",)

# documented fallbacks for device names absent from the tables: finite,
# clearly not hardware, and the lookup WARNS when it takes one
DEFAULT_PEAK_FLOPS = 1e12
DEFAULT_ICI_BYTES = 10e9
DEFAULT_DCI_BYTES = 1e9
DEFAULT_HBM_BYTES = 16 * 1024**3
DEFAULT_HBM_BW_BYTES = 100e9


def current_device_name() -> str:
    """The name of the current CUDA device. Raises without CUDA: a run
    with no card must name its device kind (``"cpu"``), never fall back."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device_kind= (e.g. 'cpu') to read the spec "
            "tables without a card")
    return torch.cuda.get_device_name(torch.cuda.current_device())


def _kind_lookup(table: Dict[str, float], device_kind: Optional[str],
                 default: float, table_name: str = "") -> float:
    if device_kind is None:
        device_kind = current_device_name()
    kind = device_kind.lower()
    for k, v in table.items():
        if k in kind:
            return v
    warnings.warn(
        f"unknown device kind {device_kind!r}: no {table_name or 'spec-table'}"
        f" entry matches — falling back to the documented default "
        f"{default:g} (plans/meters against this kind are placeholders, "
        f"not hardware numbers)",
        stacklevel=3)
    return default


def peak_flops_for(device_kind: Optional[str] = None) -> float:
    """Peak bf16 FLOP/s for a device-name string (substring match); the
    current CUDA device by default. Unknown kinds fall back LOUDLY
    (UserWarning) to ``DEFAULT_PEAK_FLOPS``."""
    return _kind_lookup(PEAK_FLOPS, device_kind, DEFAULT_PEAK_FLOPS, "PEAK_FLOPS")


def ici_bytes_per_s_for(device_kind: Optional[str] = None) -> float:
    """Per-card intra-node interconnect bandwidth (B/s)."""
    return _kind_lookup(PEAK_ICI_BYTES, device_kind, DEFAULT_ICI_BYTES, "PEAK_ICI_BYTES")


def dci_bytes_per_s_for(device_kind: Optional[str] = None) -> float:
    """Per-card network bandwidth across nodes (B/s)."""
    return _kind_lookup(PEAK_DCI_BYTES, device_kind, DEFAULT_DCI_BYTES, "PEAK_DCI_BYTES")


def hbm_bytes_for(device_kind: Optional[str] = None) -> float:
    """Per-card device-memory capacity (bytes) from the table."""
    return _kind_lookup(HBM_BYTES, device_kind, DEFAULT_HBM_BYTES, "HBM_BYTES")


def hbm_bw_bytes_per_s_for(device_kind: Optional[str] = None) -> float:
    """Per-card device-memory bandwidth (B/s)."""
    return _kind_lookup(HBM_BW_BYTES, device_kind, DEFAULT_HBM_BW_BYTES, "HBM_BW_BYTES")


def mfu(flops_per_step: float, step_seconds: float,
        device_kind: Optional[str] = None, peak: Optional[float] = None,
        n_devices: int = 1) -> float:
    """Achieved / peak FLOP/s. ``flops_per_step`` is the WHOLE step's model
    FLOPs; ``n_devices`` multiplies the peak it ran against."""
    if step_seconds <= 0:
        return 0.0
    peak = peak if peak is not None else peak_flops_for(device_kind)
    return flops_per_step / step_seconds / (peak * max(n_devices, 1))


def tokens_per_second(tokens: float, seconds: float) -> float:
    return tokens / seconds if seconds > 0 else 0.0


def hbm_utilization(device: Optional[Any] = None) -> dict:
    """{"bytes_in_use", "bytes_limit", "utilization"} from the device's
    live memory statistics (the caching allocator's in-use bytes over the
    card's total memory); {} on the CPU, which reports none. ``device``
    None is the current CUDA device, and raises without one."""
    stats = device_memory_stats(device)
    used = stats.get("bytes_in_use")
    limit = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
    if used is None:
        return {}
    out = {"bytes_in_use": int(used)}
    if limit:
        out["bytes_limit"] = int(limit)
        out["utilization"] = used / limit
    return out
