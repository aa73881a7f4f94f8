"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, dense rates without sparsity, at the full power limit)."""

from __future__ import annotations


def hbm_bytes_per_s(name: str) -> float:
    """Device-memory rate of the card ``torch.cuda.get_device_name`` names."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM (HBM3)


def bf16_flops_per_s(name: str) -> float:
    """Dense bfloat16 tensor-core rate of the card."""
    if "H100" in name and "PCIe" in name:
        return 756e12
    if "H100" in name and "NVL" in name:
        return 835e12
    return 989e12  # H100 SXM, H200
