"""Roofline terms of a dry-run cell on the H100: the port of
``repro/launch/roofline.py``.

Three terms per (arch x shape x mesh), in seconds:

  compute    = step_FLOPs_total / (chips x peak_FLOPs_chip)
  memory     = HBM_bytes_per_device / HBM_bw_chip
  collective = collective_bytes_per_device / NVLink_bw

FLOPs and HBM bytes come from the analytic perfmodel
(``launch/perfmodel.py``), as in the reference. Collective bytes are
counted where the port's own collectives send them
(``distributed/collectives.py::count_traffic``) while one rank runs the
step (``launch/dryrun.py``), each op's result bytes times the
reference's per-op traffic factor. There is no HLO to parse: the step
runs op by op, so a collective inside a loop counts once a trip by
construction.

Hardware model (NVIDIA H100 SXM5 80GB at 700 W, per GPU): 989 TFLOP/s
dense bf16, 3.35 TB/s HBM3, 450 GB/s a direction over NVLink 4. These
are analytic figures, not measurements. A 16-wide mesh axis spans two
8-GPU boards, so part of its traffic would cross the slower network
between boards: the collective term over NVLink is a lower bound.
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM column: BF16 Tensor
# Core 1,979 TFLOP/s with sparsity, so 989 TFLOP/s dense.
PEAK_FLOPS = 989e12  # bf16 dense / GPU
# The same datasheet: GPU memory bandwidth 3.35 TB/s (HBM3, 80 GB).
HBM_BW = 3.35e12  # bytes/s / GPU
# The same datasheet: NVLink 900 GB/s per GPU, both directions together.
NVLINK_BW = 450e9  # bytes/s / GPU, one direction

# per-device wire-traffic multiplier for ring implementations (the
# reference's, roofline.py:54)
_TRAFFIC_FACTOR = {
    "all-reduce": 2.0,  # reduce-scatter + all-gather phases
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


@dataclass
class CollectiveStats:
    bytes_by_op: dict
    count_by_op: dict

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_op.values())


def collective_stats(traffic) -> CollectiveStats:
    """The per-device wire bytes of a ``collectives.Traffic``: each op's
    result bytes times its traffic factor."""
    return CollectiveStats(
        bytes_by_op={op: n * _TRAFFIC_FACTOR[op]
                     for op, n in traffic.bytes_by_op.items()},
        count_by_op={op: float(c) for op, c in traffic.count_by_op.items()},
    )


@dataclass
class Roofline:
    flops_total: float  # analytic, whole step, all chips
    hbm_bytes_per_device: float  # analytic
    collective_bytes_per_device: float  # counted at the port's collectives
    collective_bytes_bf16_wire: float  # the same count (see analyze)
    compute_s: float
    memory_s: float
    collective_s: float
    collective_s_bf16_wire: float
    bottleneck: str
    model_flops_total: float  # 6*N*D / 2*N*D "useful" flops
    useful_flops_fraction: float
    roofline_fraction: float  # step-time lower bound / dominant term
    collectives: dict
    memory_per_device: dict
    raw_cost_analysis: dict

    def as_dict(self) -> dict:
        return self.__dict__.copy()


def analyze(
    spec,
    num_chips: int,
    traffic,
    *,
    memory_per_device: dict | None = None,
) -> Roofline:
    """The roofline of a ``DryRunSpec`` on ``num_chips`` GPUs, from the
    collectives one rank sent running it (``traffic``, a
    ``collectives.Traffic``) and its per-rank memory
    (``argument_size_in_bytes`` and ``output_size_in_bytes``).

    ``collective_bytes_bf16_wire`` equals the plain count: the reference
    halves float32 payloads there because XLA's CPU backend widens bf16
    to float32, and the port sends each tensor in its own dtype, float32
    as float32. ``raw_cost_analysis`` is empty: it holds XLA's
    ``cost_analysis``, which only XLA's compiler gives."""
    model_flops_total = spec.model_flops_total
    flops_total = spec.flops_total if spec.flops_total is not None else model_flops_total
    hbm_bytes_per_device = spec.hbm_bytes_per_device
    if hbm_bytes_per_device is None:
        raise ValueError("the spec has no analytic hbm_bytes_per_device")
    coll = collective_stats(traffic)

    compute_s = flops_total / (num_chips * PEAK_FLOPS)
    memory_s = hbm_bytes_per_device / HBM_BW
    collective_s = coll.total_bytes / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops_total / flops_total if flops_total else 0.0
    # fraction of the dominant-term bound that is useful compute time
    ideal_s = model_flops_total / (num_chips * PEAK_FLOPS)
    roofline_fraction = ideal_s / max(terms[bottleneck], 1e-30)
    return Roofline(
        flops_total=flops_total,
        hbm_bytes_per_device=hbm_bytes_per_device,
        collective_bytes_per_device=coll.total_bytes,
        collective_bytes_bf16_wire=coll.total_bytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        collective_s_bf16_wire=collective_s,
        bottleneck=bottleneck,
        model_flops_total=model_flops_total,
        useful_flops_fraction=useful,
        roofline_fraction=roofline_fraction,
        collectives={
            "bytes_by_op": coll.bytes_by_op,
            "count_by_op": coll.count_by_op,
        },
        memory_per_device=dict(memory_per_device or {}),
        raw_cost_analysis={},
    )
