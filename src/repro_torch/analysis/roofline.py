"""Roofline terms from the dry run's per-device counts, on H100 meshes.

Counterpart of the reference's ``analysis/roofline.py``, whose table is a
TPU v5e's.  The port's table is one NVIDIA H100 SXM 80 GB at its 700 W
power limit, from NVIDIA's data sheet (dense rates, no sparsity): 989
TFLOP/s bf16 on the tensor cores (495 TF32, 67 FP64; 67 FP32 on the CUDA
cores), 3.35 TB/s of HBM3, 80 GB, and NVLink 4 at 900 GB/s per card (450
GB/s each way); ``chip_smoke.py`` takes its bounds from this table too.
These are datasheet numbers, and every term computed from them is a model
prediction, not a measurement.

Which link rate the collective term uses: the production meshes put 16
consecutive ranks on the ``model`` axis and the ``data`` (and ``pod``)
axes across them.  An HGX H100 node holds 8 cards on one NVLink switch,
so a 16-wide model axis spans two nodes, and every data-axis group spans
16 nodes.  A ring over any axis of these meshes therefore crosses a node
boundary, where each card has its own 400 Gb/s NDR InfiniBand port: 50
GB/s each way.  The collective term uses that rate (``link_bw``), which
bounds every ring on these meshes; ``nvlink_bw`` is kept beside it for a
group that stays inside one node.

All counts are PER DEVICE, so

    compute term    = flops_per_device / peak_flops
    memory term     = bytes_per_device / hbm_bw
    collective term = wire_bytes_per_device / link_bw

as the reference computes them.  Collective wire bytes use the standard
ring-algorithm traffic model on the per-device result bytes ``R`` with
group size ``n`` (the reference's model, keyed here by op kind, result
bytes and group size instead of HLO text):

    all-gather        R·(n-1)/n        (result is the gathered tensor)
    reduce-scatter    R·(n-1)          (operand = n·R enters the wire once)
    all-reduce        2·R·(n-1)/n      (reduce-scatter + all-gather)
    all-to-all        R·(n-1)/n
    collective-permute R
"""
from __future__ import annotations

__all__ = ["HW", "KINDS", "wire_bytes", "collective_wire_bytes",
           "roofline_terms"]

HW = {
    "peak_flops": 989e12,       # bf16 FLOP/s per card, dense
    "hbm_bw": 3.35e12,          # B/s per card (HBM3)
    "hbm_bytes": 80e9,          # 80 GB per card
    "link_bw": 50e9,            # B/s each way per card across nodes (NDR)
    "nvlink_bw": 450e9,         # B/s each way per card inside a node
    "peak_flops_tf32": 495e12,  # TF32 on the tensor cores
    "peak_flops_fp32": 67e12,   # FP32 on the CUDA cores
    "peak_flops_fp64": 67e12,   # FP64 on the tensor cores
}

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Ring-model bytes one device puts on the wire for one collective of
    ``kind`` whose per-device result is ``result_bytes``, over a group of
    ``n`` (0 for a group of one, except a permute)."""
    R = float(result_bytes)
    if n <= 1 and kind != "collective-permute":
        return 0.0
    if kind == "all-gather":
        return R * (n - 1) / n
    if kind == "reduce-scatter":
        return R * (n - 1)
    if kind == "all-reduce":
        return 2 * R * (n - 1) / n
    if kind == "all-to-all":
        return R * (n - 1) / n
    if kind == "collective-permute":
        return R
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_wire_bytes(ops) -> dict:
    """Per-device wire bytes by collective kind for ``ops``, an iterable of
    ``(kind, result_bytes, group_size)``: the reference's record layout
    (each kind, ``ops``, ``total_wire_bytes``)."""
    out = {k: 0.0 for k in KINDS}
    out["ops"] = 0
    for kind, R, n in ops:
        if n <= 1 and kind != "collective-permute":
            continue
        out[kind] += wire_bytes(kind, R, n)
        out["ops"] += 1
    out["total_wire_bytes"] = sum(out[k] for k in KINDS)
    return out


def roofline_terms(rec: dict, hw: dict | None = None) -> dict:
    """The three terms (seconds) + dominance + useful-flops ratio, the
    reference's formula.  ``hw`` defaults to :data:`HW`; a table with the
    reference's ``ici_bw`` in place of ``link_bw`` is read the same way."""
    hw = HW if hw is None else hw
    link = hw["link_bw"] if "link_bw" in hw else hw["ici_bw"]
    flops = rec["cost"]["flops_per_device"]
    mem_bytes = rec["cost"]["bytes_accessed_per_device"]
    wire = rec["collectives"]["total_wire_bytes"]
    t_compute = flops / hw["peak_flops"]
    t_memory = mem_bytes / hw["hbm_bw"]
    t_collective = wire / link
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dominant = max(terms, key=terms.get)
    # useful model flops: 6·N_active·D for train, 2·N_active·D for fwd-only,
    # distributed over the chips
    mult = {"train": 6, "prefill": 2, "decode": 2}[rec["kind"]]
    useful_global = mult / 6 * rec["model_flops_per_token"] * rec["tokens"]
    useful_per_dev = useful_global / rec["chips"]
    terms.update({
        "dominant": dominant,
        "bound_s": terms[dominant],
        "useful_flops_per_device": useful_per_dev,
        "useful_over_hlo_flops": (useful_per_dev / flops) if flops else 0.0,
        "roofline_fraction": (useful_per_dev / hw["peak_flops"])
        / terms[dominant] if terms[dominant] > 0 else 0.0,
    })
    return terms
