"""Dry run on H100 meshes: plan every (arch × shape × mesh) cell without
allocating.

Counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each cell's step for 256 or 512 TPU chips and reads XLA's memory
and cost analyses.  Here each cell runs the port's own step — the train,
prefill or decode step of :mod:`repro_torch.runtime.steps`, on DTensor
parameters, optimizer state, batch and decode state placed by
:mod:`repro_torch.runtime.sharding` over :func:`~repro_torch.launch.mesh.
make_production_mesh` — in ONE CPU process, on fake tensors
(``FakeTensorMode``: shapes only, no storage) over a fake process group of
256 or 512 ranks.  What rank 0 would do is recorded:

* ``cost`` and ``collectives`` — the per-device matmul FLOPs, bytes and
  ring-model wire bytes of :class:`~repro_torch.analysis.op_walk.OpWalk`
  (the counterpart of ``hlo_walk.py``);
* ``memory`` — the per-device peak: parameters and optimizer state
  exactly, from their placements (what each rank holds), the decode state
  likewise, and the step's own allocations (gradients, saved activations,
  gathered weights, temporaries) from ``MemTracker``'s peak;
* ``roofline`` — :func:`~repro_torch.analysis.roofline.roofline_terms` on
  the H100 datasheet table: model predictions, not measurements.

Trip counts: the step is traced at depth 2 and at depth 3 (two and three
layers, the config's widths), and every per-device count of the full
depth L is the depth-2 count plus (L − 2) times the difference — the
layers of a config are alike in everything counted here (a window does
not change the flash kernel's FLOP formula or any shape), so this is the
reference's trip-count-aware walk without running L layers.  Gradients,
saved layer inputs, the KV cache and the optimizer's per-layer copies
grow with depth and one layer's temporaries do not, so the step's peak
allocation is extrapolated the same way; from depth 2 on (not 1) it
grows by the same amount a layer, since a layer runs while the layer
before's k and v are still held.  A first pass at each depth fills
DTensor's sharding caches and is not counted: its shape inference runs
each new op at global shapes (the walk leaves those ops out; a counted
trace in which inference still ran is repeated, and the record keeps the
count).  The chunked cross entropy runs all its chunks.

Every step runs the kernels' paths, as on the card: the flash and scan
launches are custom ops whose fake registrations give their outputs'
shapes (``repro_torch::flash_attention``, ``repro_torch::ssm_scan``), and
a train step's backward runs their backward ops
(``repro_torch::flash_attention_bwd``, ``repro_torch::ssm_scan_bwd``), so
no trace holds an L×L score matrix or a loop over the sequence.

``cost_mode`` cells (the reference's prefill proxy: forward and
last-token logits with materialized attention) and the ``long_500k`` skip
of full-attention archs are kept.  Records go to
``results/dryrun_torch/<arch>__<shape>__<mesh>[__coded].json`` (never the
reference's ``results/dryrun/``); a failed cell is recorded and makes the
exit code 1.

Usage::

    python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b --shape train_4k --mesh both
    python -m repro_torch.launch.dryrun --all --mesh single
    python -m repro_torch.launch.dryrun --all --mesh multi --skip-existing
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..analysis.op_walk import OpCosts, OpWalk
from ..analysis.roofline import collective_wire_bytes, roofline_terms
from ..compat import axis_sizes
from ..configs import ShapeSpec, cells, get_arch, get_shape
from ..data.pipeline import make_batch_specs
from .mesh import make_local_mesh, make_production_mesh

__all__ = ["RESULTS_DIR", "run_cell", "plan", "cell_path", "main"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def _fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (any
    earlier fake group is destroyed; a real one raises)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a process of its own: a "
                               f"{dist.get_backend()} group is initialised")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _mesh(kind: str):
    """``single`` / ``multi`` production meshes, or ``DxM`` local ones."""
    if kind in ("single", "multi"):
        _fake_group(512 if kind == "multi" else 256)
        return make_production_mesh(multi_pod=(kind == "multi"),
                                    device_type="cpu")
    d, m = (int(v) for v in kind.split("x"))
    _fake_group(d * m)
    return make_local_mesh(d, m, device_type="cpu")


def _local_bytes(shape, plc, mesh, dtype) -> int:
    """Bytes one rank holds of a tensor of ``shape`` placed by ``plc``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    local, _ = compute_local_shape_and_global_offset(tuple(shape), mesh, plc)
    n = 1
    for s in local:
        n *= s
    return n * torch.empty((), dtype=dtype).element_size()


def _held_bytes(cfg, shape, mesh) -> dict:
    """Exact per-device bytes of the parameters, the optimizer state and
    (decode) the decode state, from their placements."""
    from ..models import LM
    from ..models.lm import init_decode_state
    from ..runtime.sharding import decode_state_shardings, param_shardings
    meta = LM(cfg, dtype=getattr(torch, cfg.dtype), device="meta")
    plc = param_shardings(cfg, mesh, meta)
    named = dict(meta.named_parameters())
    params = sum(_local_bytes(p.shape, plc[k], mesh, p.dtype)
                 for k, p in named.items())
    out = {"param_bytes": params, "opt_bytes": 0, "state_bytes": 0}
    if shape.kind == "train":
        mdt = getattr(torch, cfg.opt_dtype)
        out["opt_bytes"] = 2 * sum(_local_bytes(p.shape, plc[k], mesh, mdt)
                                   for k, p in named.items()) + 4
    if shape.kind == "decode":
        st = init_decode_state(cfg, shape.global_batch, shape.seq_len,
                               device="meta")
        sh = decode_state_shardings(cfg, mesh, st)
        out["state_bytes"] = sum(_local_bytes(t.shape, pl, mesh, t.dtype)
                                 for t, pl in zip(st[:4], sh[:4])
                                 if pl is not None)
    return out


def _locals(*trees) -> list:
    """The local tensors of the DTensors (and tensors) in ``trees``."""
    out = []
    for t in trees:
        if isinstance(t, torch.Tensor):
            out.append(t.to_local() if hasattr(t, "to_local") else t)
        elif isinstance(t, dict):
            out += _locals(*t.values())
        elif isinstance(t, (list, tuple)):
            out += _locals(*t)
        elif isinstance(t, torch.nn.Module):
            out += _locals(*t.parameters())
    return out


def _inputs(cfg, shape, mesh, coded: bool):
    """The step and its DTensor inputs at ``cfg``'s depth, on fake tensors:
    ``(run, the local tensors that exist before the step)``."""
    from ..models import LM
    from ..models.lm import init_decode_state
    from ..optim.adamw import AdamWState
    from ..runtime import sharding as shd
    from ..runtime.steps import (make_decode_step, make_prefill_step,
                                 make_train_step)
    from torch.distributed.tensor import zeros as dzeros
    model = LM(cfg, dtype=getattr(torch, cfg.dtype), device="cpu")
    shd.distribute_lm(model, mesh, cfg)
    batch = make_batch_specs(cfg, shape)
    if shape.kind == "train":
        if coded and not cfg.has_moe and cfg.d_ff:
            batch["coded_weights"] = torch.empty((16,), dtype=torch.float32)
        batch = shd.distribute_batch(cfg, mesh, batch)
        plc = shd.param_shardings(cfg, mesh, model)
        mdt = getattr(torch, cfg.opt_dtype)
        mom = {k: dzeros(p.shape, dtype=mdt, device_mesh=mesh,
                         placements=plc[k])
               for k, p in model.named_parameters()}
        opt = AdamWState(
            step=dzeros((), dtype=torch.int32, device_mesh=mesh,
                        placements=[torch.distributed.tensor.Replicate()] *
                        mesh.ndim),
            m=mom, v={k: torch.zeros_like(t) for k, t in mom.items()})
        step = make_train_step(cfg, device="cpu")
        return (lambda: step(model, opt, batch, 0)), _locals(model, opt,
                                                             batch)
    if shape.kind == "prefill":
        batch = shd.distribute_batch(cfg, mesh, {"tokens": batch["tokens"]})
        held = _locals(model, batch)
        if cfg.cost_mode:
            return (lambda: _prefill_cost_proxy(model, batch["tokens"], cfg)
                    ), held
        step = make_prefill_step(cfg, max_seq=shape.seq_len, device="cpu")
        return (lambda: step(model, batch)), held
    B = shape.global_batch
    tok = torch.empty((B, 1, cfg.n_codebooks) if cfg.n_codebooks else (B, 1),
                      dtype=torch.long)
    tok = shd.distribute_batch(cfg, mesh, {"t": tok})["t"]
    state = init_decode_state(cfg, B, shape.seq_len, mesh=mesh)
    step = make_decode_step(cfg, device="cpu")
    return (lambda: step(model, tok, state)), _locals(model, tok,
                                                      list(state[:4]))


@torch.no_grad()
def _prefill_cost_proxy(model, tokens, cfg):
    """Forward + last-token logits — the prefill's FLOP content without the
    cache plumbing (the reference's ``_prefill_cost_proxy``)."""
    from ..models import lm
    x = lm.embed_tokens(model, tokens, cfg)
    B, L = x.shape[0], x.shape[1]
    pos = torch.arange(L)[None].expand(B, L)
    h, _ = lm.forward_hidden(model, x, cfg, pos)
    return lm._all_logits(model, h[:, -1:], cfg)


def _trace(cfg, shape, mesh, coded: bool, walk: bool):
    """Run the step once at ``cfg``'s depth; with ``walk`` return its
    ``(OpCosts, peak bytes it allocated, collective counts, shape
    inferences)``: the peak of everything ``MemTracker`` sees live, less
    what existed before the step (parameters, optimizer state, batch,
    decode state).  A counted run in which DTensor still inferred a shape
    (whose global-shape tensors ``MemTracker`` may count) is run again, as
    its caches are then filled; some torch releases do not cache every
    op's inference, and the third run's count is then returned with it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode
    for _ in range(3):
        with FakeTensorMode():
            run, held = _inputs(cfg, shape, mesh, coded)
            if not walk:
                run()
                return None
            mt, comm = MemTracker(), CommDebugMode()
            mt.track_external(*held)
            held_bytes = sum({t.untyped_storage()._cdata:
                              t.untyped_storage().nbytes() for t in held
                              }.values())
            with OpWalk() as w, mt, comm:
                run()
            peak = sum(v["Total"] for dev, v in
                       mt.get_tracker_snapshot("peak").items()
                       if str(dev) != "meta") - held_bytes   # shapes only
            counts = {str(k): int(v)
                      for k, v in comm.get_comm_counts().items()}
        if not w.propagations:
            break
    return w.costs, peak, counts, w.propagations


def _minus(a: OpCosts, b: OpCosts) -> OpCosts:
    return OpCosts(a.flops - b.flops, a.bytes - b.bytes,
                   {k: a.wire[k] - b.wire[k] for k in a.wire},
                   a.n_collectives - b.n_collectives,
                   {k: a.by_kind.get(k, 0) - b.by_kind.get(k, 0)
                    for k in set(a.by_kind) | set(b.by_kind)})


def plan(cfg, shape, mesh, *, coded: bool = False) -> dict:
    """The per-device plan of one cell on ``mesh`` (the fake group of its
    size initialised, the mesh registered): ``memory``, ``cost`` and
    ``collectives`` as the reference's records hold them."""
    L = cfg.n_layers
    two, three = cfg.replace(n_layers=2), cfg.replace(n_layers=3)
    for warm in (three, two):    # fill DTensor's caches
        _trace(warm, shape, mesh, coded, walk=False)
    c2, p2, n2, s2 = _trace(two, shape, mesh, coded, walk=True)
    c3, p3, _, s3 = _trace(three, shape, mesh, coded, walk=True)
    costs = c2 + _minus(c3, c2).scaled(L - 2)
    step_peak = p2 + (L - 2) * (p3 - p2)
    held = _held_bytes(cfg, shape, mesh)
    argument = held["param_bytes"] + held["opt_bytes"] + held["state_bytes"]
    coll = collective_wire_bytes(())
    coll.update({k: v for k, v in costs.wire.items()})
    coll["ops"] = costs.n_collectives
    coll["total_wire_bytes"] = costs.total_wire
    coll["ops_by_kind"] = costs.by_kind
    coll["comm_counts_depth2"] = n2
    return {
        "memory": {
            **held,
            "argument_bytes": argument,
            "output_bytes": 0,
            "temp_bytes": step_peak,
            "alias_bytes": 0,
            "step_peak_bytes_depth2": p2,
            "step_peak_bytes_per_layer": p3 - p2,
            "shape_inferences_in_trace": max(s2, s3),
            "peak_bytes_per_device": argument + step_peak,
        },
        "cost": {
            "flops_per_device": costs.flops,
            "bytes_accessed_per_device": costs.bytes,
            "flops_depth2": c2.flops,
            "flops_per_layer": c3.flops - c2.flops,
            "analysis": "op_walk(fake tensors, depth 2 and 3 extrapolated "
                        "to the full depth; matmul flops)",
        },
        "collectives": coll,
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             coded: bool = False, shape: ShapeSpec | None = None,
             cfg=None) -> dict:
    """Plan one cell; ``mesh_kind`` is ``single``, ``multi`` or ``DxM``.
    ``shape`` and ``cfg`` override the named shape and the arch's config
    (a served shape, a cut depth)."""
    from ..models.hints import set_mesh
    cfg = cfg or get_arch(arch)
    if coded:
        cfg = cfg.replace(coded=True)
    shape = shape or get_shape(shape_name)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skip:full-attention"}
    mesh = _mesh(mesh_kind)
    set_mesh(mesh)
    t0 = time.time()
    try:
        rec = plan(cfg, shape, mesh, coded=coded)
    finally:
        set_mesh(None)
    chips = 1
    for v in axis_sizes(mesh).values():
        chips *= v
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "status": "ok", "coded": coded, "chips": chips,
           "compile_s": round(time.time() - t0, 1), **rec,
           "model_flops_per_token": 6 * cfg.active_param_count(),
           "tokens": shape.global_batch * (shape.seq_len
                                           if shape.kind != "decode" else 1),
           "kind": shape.kind}
    rec["roofline"] = roofline_terms(rec)
    return rec


def cell_path(arch, shape_name, mesh_kind, coded=False, out_dir=None):
    tag = "__coded" if coded else ""
    return os.path.join(out_dir or RESULTS_DIR,
                        f"{arch}__{shape_name}__{mesh_kind}{tag}.json")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--coded", action="store_true",
                    help="enable the SAC-coded MLP contraction variant")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out-dir", default=RESULTS_DIR,
                    help="where the cell records go (default "
                         "results/dryrun_torch/)")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(a, s) for a, s, status in cells(include_skips=True)]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        todo = [(args.arch, args.shape)]

    failures = 0
    for arch, shape_name in todo:
        for mk in meshes:
            path = cell_path(arch, shape_name, mk, args.coded, args.out_dir)
            if args.skip_existing and os.path.exists(path):
                print(f"[skip-existing] {arch} {shape_name} {mk}")
                continue
            print(f"=== {arch} × {shape_name} × {mk} ===", flush=True)
            try:
                rec = run_cell(arch, shape_name, mk, coded=args.coded)
            except Exception as e:  # noqa: BLE001 — record and continue
                rec = {"arch": arch, "shape": shape_name, "mesh": mk,
                       "status": f"error: {type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                failures += 1
                print(f"  FAILED: {e}", flush=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if rec.get("status") == "ok":
                m = rec["memory"]["peak_bytes_per_device"] / 2 ** 30
                fl = rec["cost"]["flops_per_device"]
                print(f"  ok: peak {m:.2f} GiB/dev, {fl:.3g} flops/dev, "
                      f"{rec['compile_s']}s trace", flush=True)
            elif rec.get("status", "").startswith("skip"):
                print(f"  {rec['status']}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
