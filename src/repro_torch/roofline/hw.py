"""The H100 SXM (the port's target): the one source of the card's figures,
the counterpart of ``repro/roofline/hw.py``'s TPU table. The roofline
(``roofline.analysis``), the planner (``core.planner``) and chip_smoke's
bounds all read :data:`H100`.

Sources: NVIDIA's H100 data sheet (SXM5 part; dense rates, without
sparsity, at the 700 W limit), NVIDIA's NVLink 4 and ConnectX-7 product
figures, and the planner's own constraints (``core.planner``). Everything
here is a parameter, as the reference's table is.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HopperTarget:
    name: str = "h100-sxm"

    # Compute (H100 SXM data sheet, dense).
    peak_bf16_flops: float = 989e12      # bf16 / f16 tensor cores
    peak_f32_flops: float = 67e12        # f32 FMA on the CUDA cores
    peak_int8_ops: float = 1979e12       # int8 tensor cores

    # Memory (data sheet): 80 GB of HBM3 at 3.35 TB/s.
    hbm_bytes: int = 80 * 10**9
    hbm_bw: float = 3.35e12              # bytes/s

    # Interconnect. NVLink 4: 900 GB/s bidirectional a GPU within a node of
    # 8 (NVSwitch), so 450e9 bytes/s each way. Between nodes one 400 Gb/s
    # NDR InfiniBand port a GPU (ConnectX-7): 50e9 bytes/s.
    nvlink_bw: float = 450e9
    gpus_per_node: int = 8
    nic_bw: float = 50e9

    # The planner's view of one SM (``core.planner``'s constraints).
    sms: int = 132
    smem_per_block: int = 232_448        # bytes, with the opt-in attribute
    max_bm: int = 64                     # widest m-block of the fused-A kernel
    max_bn: int = 64                     # widest column chunk of the kernel
    max_bk: int = 128
    kc: int = 32                         # staged k-slice depth


H100 = HopperTarget()


def peak_flops(dtype: str, target: HopperTarget = H100) -> float:
    return {
        "bfloat16": target.peak_bf16_flops,
        "float16": target.peak_bf16_flops,
        "float32": target.peak_f32_flops,
        "int8": target.peak_int8_ops,
    }.get(str(dtype), target.peak_bf16_flops)
