"""Roofline terms of a counted program, the counterpart of
``repro/roofline/analysis.py``, against the H100 (``roofline.hw``).

Three terms per (arch x shape x mesh):

  compute    = flops_per_device / peak_FLOP/s (the compute dtype's)
  memory     = bytes_per_device / HBM_bw
  collective = sum over collectives of traffic / the bandwidth of the
               link the collective's group spans

The reference reads its counts from a compiled executable: XLA's
``cost_analysis`` and a parser of the compiled HLO text (``parse_collectives``,
``HloCostModel``, which multiplies scanned layer bodies by their trip
counts, and ``cpu_bf16_emulation_bytes``, which removes buffers only
XLA:CPU's bf16 emulation makes). torch has no HLO, so those have no
counterpart here: the dry run (``launch/dryrun.py``) counts each device's
local ops as they run, under a dispatch mode over fake tensors, and
:func:`analyze` takes those counts. The port's models run a Python loop
over layers, so every layer's ops are counted as run: there are no scan
trip counts to multiply.

Collective traffic per op follows the reference's ring model
(:func:`_collective_traffic`), with g the group size:

  all-gather           result_bytes                  (each device receives it)
  all-reduce           2 * result_bytes * (g-1)/g    (reduce-scatter + gather)
  reduce-scatter       result_bytes * (g-1)          (input streams in)
  all-to-all           result_bytes * (g-1)/g
  collective-permute   result_bytes

A group whose ranks all sit in one node of ``gpus_per_node`` moves its
traffic over NVLink (``nvlink_bw`` each way); any other group over the
node's NIC (``nic_bw`` a GPU).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from repro_torch.roofline.hw import H100, HopperTarget, peak_flops


def _collective_traffic(op: str, nbytes: int, g: int) -> float:
    if op == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if op == "all-gather":
        return float(nbytes)
    if op == "reduce-scatter":
        return float(nbytes) * (g - 1)
    if op == "all-to-all":
        return float(nbytes) * (g - 1) / g
    return float(nbytes)  # collective-permute


def link_of(ranks: Sequence[int], target: HopperTarget = H100) -> str:
    """"nvlink" when every rank of the group sits in one node, else "nic"."""
    nodes = {r // target.gpus_per_node for r in ranks}
    return "nvlink" if len(nodes) <= 1 else "nic"


@dataclasses.dataclass
class CollectiveStats:
    """Modeled per-device collective traffic, by op and by link."""
    per_device_bytes: float = 0.0
    nvlink_bytes: float = 0.0
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    op_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    # "<op> g<group size> <link>" -> [count, result bytes]
    by_group: Dict[str, list] = dataclasses.field(default_factory=dict)

    def add(self, op: str, result_bytes: int, ranks: Sequence[int],
            target: HopperTarget = H100) -> float:
        traffic = _collective_traffic(op, result_bytes, len(ranks))
        link = link_of(ranks, target)
        self.op_counts[op] = self.op_counts.get(op, 0) + 1
        self.op_bytes[op] = self.op_bytes.get(op, 0.0) + traffic
        entry = self.by_group.setdefault(f"{op} g{len(ranks)} {link}", [0, 0])
        entry[0] += 1
        entry[1] += result_bytes
        self.per_device_bytes += traffic
        if link == "nvlink":
            self.nvlink_bytes += traffic
        return traffic


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    # The reference's f32-halved collective bytes (its XLA:CPU artifact);
    # the port counts the dtypes that move, so it stays equal to the total
    # unless given.
    collective_bytes_bf16adj: float = 0.0
    compute_dtype: str = "bfloat16"
    model_flops: float = 0.0            # 6*N*D analytic
    argument_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    output_bytes: Optional[int] = None
    collective_ops: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Of the collective bytes, those on NVLink (a group within one node);
    # the rest cross the NIC.
    collective_bytes_nvlink: float = 0.0
    target: HopperTarget = H100

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / peak_flops(self.compute_dtype,
                                                  self.target)

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / self.target.hbm_bw

    def _link_s(self, total: float) -> float:
        nv = min(self.collective_bytes_nvlink, total)
        return nv / self.target.nvlink_bw + (total - nv) / self.target.nic_bw

    @property
    def collective_s(self) -> float:
        return self._link_s(self.collective_bytes_per_device)

    @property
    def collective_s_bf16adj(self) -> float:
        """The collective term over the adjusted bytes (the reference's
        ``collective_s_tpu``)."""
        return self._link_s(self.collective_bytes_bf16adj
                            or self.collective_bytes_per_device)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs over every device (remat / redundancy
        waste detector)."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable fraction of peak on the dominant-term model."""
        if self.step_time_s == 0:
            return 0.0
        return self.compute_s / self.step_time_s

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_bytes_nvlink": self.collective_bytes_nvlink,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "collective_s_bf16adj": self.collective_s_bf16adj,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "argument_bytes": self.argument_bytes,
            "temp_bytes": self.temp_bytes,
            "output_bytes": self.output_bytes,
            "collective_ops": self.collective_ops,
            "compute_dtype": self.compute_dtype,
            "target": self.target.name,
        }


def analyze(*, arch: str, shape: str, mesh_name: str, chips: int,
            flops_per_device: float, bytes_per_device: float,
            collectives: CollectiveStats, model_flops: float,
            compute_dtype: str = "bfloat16",
            argument_bytes: Optional[int] = None,
            temp_bytes: Optional[int] = None,
            output_bytes: Optional[int] = None,
            target: HopperTarget = H100) -> Roofline:
    """Roofline terms from one device's counted FLOPs, bytes and
    collectives (the dry run's :class:`CollectiveStats`)."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=float(flops_per_device),
        bytes_per_device=float(bytes_per_device),
        collective_bytes_per_device=collectives.per_device_bytes,
        collective_bytes_nvlink=collectives.nvlink_bytes,
        compute_dtype=compute_dtype, model_flops=model_flops,
        argument_bytes=argument_bytes, temp_bytes=temp_bytes,
        output_bytes=output_bytes,
        collective_ops=dict(collectives.op_bytes), target=target)
