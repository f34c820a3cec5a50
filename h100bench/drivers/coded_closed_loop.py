"""Closed-loop clients of the SAC master on the device backend.

Each round every client submits one request, ``C = A·B`` with float64
operands cycled from a pool drawn on the device from the seed, and waits
for its answers; the master (``MasterScheduler.run`` over
``TorchDeviceBackend``) encodes, computes the worker products in the
mix's precision and decodes at each deadline of the configuration.  The
workers' latencies are drawn by the backend on its synthetic clock; what
the card pays, and what the client waits for, is the wall time of its
batch, taken when the device has finished it.

The harness subclasses the scheduler and the backend only to observe:
the backend keeps each batch's latency draw (which workers had finished
by each deadline), and the scheduler keeps the estimate it emits at each
deadline for a sample of requests drawn from the seed, and stamps each
batch's wall time once the device is done with it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import roofline

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _classes():
    from repro_torch.serving.backends import TorchDeviceBackend
    from repro_torch.serving.master import MasterScheduler

    class Backend(TorchDeviceBackend):
        """Keeps the latency row of each dispatch."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.draws = []

        def draw_latencies(self, rng, N):
            t = super().draw_latencies(rng, N)
            self.draws.append(np.array(t, dtype=np.float64))
            return t

    class Scheduler(MasterScheduler):
        """Stamps each batch's wall time once the device has finished it,
        pairs its requests with their latency draw, and keeps the
        estimates of the sampled requests at each deadline."""

        def __init__(self, *a, sample=(), sync=None, **kw):
            super().__init__(*a, **kw)
            self.sample = set(sample)
            self.kept = {}              # req_id -> [(t, m, estimate)]
            self.done_at = {}           # req_id -> perf_counter
            self.draw_of = {}           # req_id -> latency row
            self._sync = sync

        def _serve_batch(self, batch, cls=None, open_ctx=None):
            out = super()._serve_batch(batch, cls, open_ctx)
            self._sync()
            now = time.perf_counter()
            row = self.backend.draws[-1]
            for r in batch:
                self.done_at[r.req_id] = now
                self.draw_of[r.req_id] = row
            return out

        def _emit(self, batch, decoders, refs, results, t, m, R, kind,
                  bid=0):
            super()._emit(batch, decoders, refs, results, t, m, R, kind,
                          bid)
            for r, dec in zip(batch, decoders):
                if r.req_id in self.sample:
                    est = dec.estimate()
                    self.kept.setdefault(r.req_id, []).append(
                        (float(t), int(m),
                         None if est is None else est.clone()))

    return Backend, Scheduler


class Cell:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.cfg, self.traffic = cell["config"], cell["traffic"]
        self.seed, self.device = int(seed), device
        self.code_cfg = self.cfg["code"]

    # --------------------------------------------------------------- set-up
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        from repro_torch.core.registry import make_code
        from repro_torch.serving.master import ServeConfig
        cfg, tr = self.cfg, self.traffic
        if self.device.type == "cuda":
            from repro_torch.kernels._build import build_all
            build_all()
        c = self.code_cfg
        self.code = make_code(c["family"], c["K"], c["N"], eps=c["eps"])
        Backend, Scheduler = _classes()
        st = cfg["stragglers"]
        backend = Backend(device=self.device,
                          dtype=DTYPES[tr["product_dtype"]],
                          shift=st["shift"], rate=st["rate"],
                          straggler_frac=st["straggler_frac"],
                          straggler_slowdown=st["straggler_slowdown"])
        self.clients = int(tr["clients"])
        warm = int(tr["warmup_rounds"]) * self.clients
        rng = np.random.default_rng(self.seed)
        # the sample is drawn from the seed among the window's first
        # requests, which every run reaches
        picks = rng.choice(int(tr["sample_from"]),
                           size=int(tr["sample_requests"]), replace=False)
        self.sample = sorted(warm + int(p) for p in picks)
        self.sched = Scheduler(
            self.code, backend,
            ServeConfig(deadlines=tuple(cfg["deadlines"]),
                        batch_size=int(tr["batch_size"]),
                        beta_mode=cfg["beta_mode"], decoder=cfg["decoder"],
                        track_errors=False, seed=self.seed),
            sample=self.sample, sync=self._sync)
        self.A, self.B = self.operands()
        self.t_sub, self.pool_of, self.exact = {}, {}, {}
        self.window_ids = []
        self.n_sub = 0
        for _ in range(int(tr["warmup_rounds"])):
            self._round(record=False)

    def operands(self):
        """The pool of float64 operand pairs, drawn on the device from the
        seed in one call each."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        n = int(self.traffic["pool"])
        A = torch.randn((n, cfg["rows"], cfg["inner"]), generator=gen,
                        dtype=torch.float64, device=self.device)
        B = torch.randn((n, cfg["inner"], cfg["cols"]), generator=gen,
                        dtype=torch.float64, device=self.device)
        return A, B

    # --------------------------------------------------------------- window
    def _round(self, record: bool = True) -> None:
        pool = self.A.shape[0]
        for _ in range(self.clients):
            j = self.n_sub % pool
            rid = self.sched.submit(self.A[j], self.B[j])
            self.t_sub[rid], self.pool_of[rid] = time.perf_counter(), j
            if record:
                self.window_ids.append(rid)
            self.n_sub += 1
        for res in self.sched.run():
            self.exact[res.req_id] = bool(res.answers) and \
                res.answers[-1].exact

    def unit(self, span) -> None:
        with span("serve_round"):
            self._round()

    def counts(self) -> tuple:
        failed = sum(1 for r in self.window_ids if not self.exact[r])
        return len(self.window_ids), failed

    def end_to_end(self, window_s: float) -> dict:
        ids = self.window_ids
        lat = [(self.sched.done_at[r] - self.t_sub[r]) * 1e3 for r in ids]
        exact = sum(1 for r in ids if self.exact[r])
        return {"coded_requests_per_s": exact / window_s,
                "coded_latency_p95_ms": float(np.percentile(lat, 95))}

    def window_info(self, units: int) -> dict:
        """What the readers need beside the trace: one batch's bounds."""
        cfg, c = self.cfg, self.code_cfg
        bz = cfg["inner"] // c["K"]
        req = int(self.traffic["batch_size"])
        dt = self.traffic["product_dtype"]
        return {
            "batches": units * self.clients // req,
            "products_bound_s": roofline.coded_products_s(
                req * c["N"], cfg["rows"], bz, cfg["cols"], dt),
            "encode_bound_s": roofline.encode_s(
                req, c["N"], c["K"], cfg["rows"], bz)
            + roofline.encode_s(req, c["N"], c["K"], cfg["cols"], bz)}

    # ---------------------------------------------------------- correctness
    def release(self) -> None:
        """Frees the program's state; keeps the sampled answers, their
        latency draws and the operands, which the benchmark made."""
        s = self.sched
        self.kept = {r: s.kept.get(r, []) for r in self.sample}
        self.draws = {r: s.draw_of.get(r) for r in self.sample}
        del self.sched
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: str | None = None) -> dict:
        """The compared numbers of the sampled requests against the plain
        reference decoding the same finished workers' float64 products:
        every answer's gap from the reference's estimate over ``Σ_i |w_i|
        ‖P_i‖`` of the decode's weights (what rounding the products can
        move it by: the exact decode's weights reach thousands on
        clustered points), each anytime answer's relative gap (a gap that is
        not finite reads infinite), answers at
        a wrong count of finished workers, and sampled requests never
        answered exactly.  With ``control`` the reference's own products
        in that lower precision stand in the program's place."""
        from h100bench import core
        ref = core.reference(self.cfg["name"])
        answer, anytime = [], []
        wrong_m = missing = 0
        for r in self.sample:
            kept, row = self.kept.get(r), self.draws.get(r)
            if not kept or row is None or not self.exact.get(r):
                missing += 1
                continue
            j = self.pool_of[r]
            job = ref.Job(self.cfg, self.A[j], self.B[j])
            low = job.products(control) if control else None
            for t, m, est in kept:
                want = job.estimate(row, t)
                if want is None or est is None:
                    wrong_m += (want is None) != (est is None)
                    continue
                m_ref, e_ref, scale = want
                if m_ref != m:
                    wrong_m += 1
                    continue
                got = est if low is None else job.estimate(row, t, low)[1]
                diff = float(torch.linalg.vector_norm(got.double() - e_ref))
                answer.append(diff / scale)
                if m_ref < job.R:
                    anytime.append(diff / float(
                        torch.linalg.vector_norm(e_ref)))
            del job, low
        return {"answer_gap": core.worst(answer),
                "anytime_gap": core.worst(anytime),
                "wrong_worker_count": float(wrong_m),
                "unanswered": float(missing)}
