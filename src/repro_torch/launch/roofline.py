"""Roofline terms of one traced step on an NVIDIA H100 (counterpart of
`repro/launch/roofline.py`).

Three terms per (arch × shape × mesh), all in seconds:

    compute    = Σ_dtype FLOPs_per_rank(dtype) / peak(dtype)
    memory     = bytes_accessed_per_rank / HBM_BW
    collective = Σ_group wire_bytes(group) / link(group)

The trace (`launch/dryrun.py`) runs one rank's step, so its FLOPs and
bytes are already per card.  Each counted product is charged at the rate
of its dtype: bf16 (and f16) at the dense tensor-core rate, f32 at the
rate outside the tensor cores (the port runs its f32 GEMMs with TF32
off), and the f32 `flash_attention` kernel's products at a third of the
TF32 rate (split TF32: three TF32 products each).

`parse_collectives` has no HLO to read: its place is taken by a tally of
the `c10d` ops the trace dispatches (`note_collective`), by kind, with
count, result bytes, operand bytes and group sizes.  A `c10d` op the
tally does not know raises; nothing is dropped.  Wire bytes keep the
reference's per-op factors (ring algorithms, (n−1)/n ≈ 1):

    all-reduce          2 × result bytes   (reduce-scatter + all-gather)
    all-gather          1 × result bytes
    reduce-scatter      1 × operand bytes
    all-to-all          1 × result bytes
    collective-permute  1 × result bytes

The collective term charges a group by the slowest link it crosses.
Ranks are row-major over (pod, data, model), as `launch/mesh.py` lays
them out, and a node holds GPUS_PER_NODE consecutive ranks: a group
whose ranks all lie in one node runs on NVLink, any other group on
InfiniBand.  On the production meshes (16 × 16, 2 × 16 × 16) a model
line is 16 consecutive ranks, two nodes, and a data line strides by 16,
so both lines cross nodes and every collective of the step is charged at
the InfiniBand rate.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM5 column:
HBM_BW = 3.35e12             # bytes/s: GPU memory bandwidth, 3.35 TB/s
PEAK_BF16 = 989.4e12         # FLOP/s: BF16 Tensor Core, dense (1979 with sparsity)
PEAK_F32 = 66.9e12           # FLOP/s: FP32, outside the tensor cores
PEAK_TF32 = 494.7e12         # FLOP/s: TF32 Tensor Core, dense (989 with sparsity)
NVLINK_BW = 450e9            # bytes/s a direction: NVLink 900 GB/s, both ways
CARD_BYTES = 80e9            # bytes: GPU memory, 80 GB
# NVIDIA DGX H100 user guide: 8 H100 GPUs a node, joined by NVLink through
# NVSwitch; 8 single-port ConnectX-7 cards at 400 Gb/s InfiniBand each
GPUS_PER_NODE = 8
IB_BW = 400e9 / 8            # bytes/s a GPU: one 400 Gb/s port each

# rate of each class of counted product (`compute_class`)
PEAKS = {"bfloat16": PEAK_BF16, "float16": PEAK_BF16, "float32": PEAK_F32,
         "split_tf32": PEAK_TF32 / 3}

LINKS = {"nvlink": NVLINK_BW, "infiniband": IB_BW}

_COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# c10d op -> (kind, argument index of the results, of the operands); a
# list argument counts every tensor in it (in-place ops: the same tensors)
_C10D = {
    "allreduce_": ("all-reduce", 0, 0),
    "allreduce_coalesced_": ("all-reduce", 0, 0),
    "_allgather_base_": ("all-gather", 0, 1),
    "allgather_": ("all-gather", 0, 1),
    "allgather_coalesced_": ("all-gather", 0, 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 0, 1),
    "_reduce_scatter_base_": ("reduce-scatter", 0, 1),
    "reduce_scatter_": ("reduce-scatter", 0, 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0, 1),
    "alltoall_base_": ("all-to-all", 0, 1),
    "alltoall_": ("all-to-all", 0, 1),
}

# the namespaces of collective ops: any op of theirs the tally does not
# know raises
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def empty_collectives() -> dict:
    """The tally of no collective: per kind, count, result and operand
    bytes, the group sizes seen, and the same bytes by link."""
    return {op: {"count": 0, "result_bytes": 0, "operand_bytes": 0,
                 "group_sizes": [],
                 "by_link": {link: {"result_bytes": 0, "operand_bytes": 0}
                             for link in LINKS}}
            for op in _COLLECTIVE_OPS}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(y) for y in x)
    return 0


def link_of(ranks) -> str:
    """The slowest link a group of global ranks crosses."""
    nodes = {r // GPUS_PER_NODE for r in ranks}
    return "nvlink" if len(nodes) <= 1 else "infiniband"


def note_collective(collectives: dict, func, args) -> None:
    """Add one dispatched collective op (`func` an `OpOverload` of a
    collective namespace, `args` its arguments) to the tally; raises on an
    op it does not know."""
    name = func._schema.name.split("::")[-1]
    if func.namespace != "c10d" or name not in _C10D:
        raise NotImplementedError(
            f"the collective tally does not know {func}; add its kind and "
            f"byte counts to launch/roofline.py before tracing it")
    kind, res_i, op_i = _C10D[name]
    pg = next(dist.ProcessGroup.unbox(a) for a in args
              if isinstance(a, torch.ScriptObject)
              and "ProcessGroup" in str(a._type()))
    ranks = dist.get_process_group_ranks(pg)
    entry = collectives[kind]
    result, operand = _tensor_bytes(args[res_i]), _tensor_bytes(args[op_i])
    entry["count"] += 1
    entry["result_bytes"] += result
    entry["operand_bytes"] += operand
    if len(ranks) not in entry["group_sizes"]:
        entry["group_sizes"] = sorted(entry["group_sizes"] + [len(ranks)])
    by = entry["by_link"][link_of(ranks)]
    by["result_bytes"] += result
    by["operand_bytes"] += operand


# each kind's wire bytes: (the byte count it is charged on, its factor)
_WIRE = {"all-reduce": ("result_bytes", 2.0),
         "all-gather": ("result_bytes", 1.0),
         "reduce-scatter": ("operand_bytes", 1.0),
         "all-to-all": ("result_bytes", 1.0),
         "collective-permute": ("result_bytes", 1.0)}


def wire_bytes_by_kind(collectives: dict) -> dict:
    return {op: factor * collectives[op][key] for op, (key, factor) in _WIRE.items()}


def wire_bytes(collectives: dict) -> float:
    return sum(wire_bytes_by_kind(collectives).values(), 0.0)


def wire_bytes_by_link(collectives: dict) -> dict:
    """`wire_bytes` of the part of the tally on each link."""
    return {link: wire_bytes({op: e["by_link"][link]
                              for op, e in collectives.items()})
            for link in LINKS}


def compute_seconds(flops_by_class: dict) -> float:
    """Σ FLOPs / the rate of their class; an unknown class raises."""
    unknown = set(flops_by_class) - set(PEAKS)
    if unknown:
        raise KeyError(f"no peak rate for FLOPs of {sorted(unknown)}")
    return sum(f / PEAKS[c] for c, f in flops_by_class.items())


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    wire_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0

    def as_dict(self):
        return self.__dict__.copy()


def roofline_terms(cost: dict, collectives: dict | None = None,
                   model_flops_per_device: float = 0.0) -> Roofline:
    """The three terms from a trace's cost ({"flops", "bytes accessed"},
    and "flops_by_class" where the trace split them; without it every
    FLOP is charged at the bf16 rate) and its collective tally."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    coll = collectives or empty_collectives()
    c = (compute_seconds(cost["flops_by_class"]) if "flops_by_class" in cost
         else flops / PEAK_BF16)
    m = hbm / HBM_BW
    k = sum(b / LINKS[link] for link, b in wire_bytes_by_link(coll).items())
    terms = {"compute": c, "memory": m, "collective": k}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops_per_device / flops if flops > 0 else 0.0
    return Roofline(flops=flops, hbm_bytes=hbm, wire_bytes=wire_bytes(coll),
                    compute_s=c, memory_s=m, collective_s=k,
                    bottleneck=bottleneck,
                    model_flops=model_flops_per_device, useful_ratio=useful)


def model_flops_per_step(cfg, shape, n_devices: int) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) per device.

    For train: D = global_batch × seq tokens, factor 6 (fwd 2 + bwd 4).
    For prefill: factor 2. For decode: one token per sequence, factor 2."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        factor = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        factor = 2.0
    else:
        tokens = shape.global_batch
        factor = 2.0
    return factor * n_active * tokens / n_devices
