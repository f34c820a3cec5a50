"""Back-to-back training steps through the program's ``make_train_step``
(the loss's gradient through every kernel, global-norm clipping, AdamW),
each on a new batch of ``rows`` × ``length`` tokens drawn from the seed.

Set-up builds the one training state the window uses and drives it
through its first ``checked_steps`` steps, the call the window makes on
batches of its own; what the check compares is kept on the way: each
step's loss, each leaf's first gradient as AdamW holds it after the first
step (its first moment over 1 − β1), and each leaf's change after the
last of them."""
from __future__ import annotations

import math

import numpy as np
import torch

from h100bench import core, lm, roofline


class Cell:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.cfg, self.traffic = cell["config"], cell["traffic"]
        self.seed, self.device = int(seed), device
        self.rows, self.length = int(self.traffic["rows"]), \
            int(self.traffic["length"])

    def setup(self) -> None:
        from repro_torch.optim import adamw_init
        from repro_torch.runtime.steps import make_schedule, make_train_step
        tr = self.traffic
        if self.device.type == "cuda":
            from repro_torch.kernels._build import build_all
            build_all()
        self.arch, self.model = lm.model(self.cfg, self.seed, self.device)
        sch = tr["schedule"]
        self.step_fn = make_train_step(
            self.arch, make_schedule(self.arch, peak_lr=sch["peak_lr"],
                                     warmup=sch["warmup"],
                                     total=sch["total"]),
            max_grad_norm=tr["optimizer"]["max_grad_norm"],
            device=self.device)
        self.opt = adamw_init(dict(self.model.named_parameters()))
        self.n, self.window_units, self.failed = 0, 0, 0
        self.losses, self.g1, self.change, self._ref = [], {}, {}, {}
        b1 = tr["optimizer"]["b1"]
        for s in range(int(tr["checked_steps"])):
            self.losses.append(self._step())
            if s == 0:
                self.g1 = {k: float(torch.linalg.vector_norm(m)) / (1 - b1)
                           for k, m in self.opt.m.items()}
        W0 = lm.make_weights(self.cfg, self.seed, self.device)
        self.change = {k: float(torch.linalg.vector_norm(
            p.detach().float() - W0[k].float()))
            for k, p in self.model.named_parameters()}
        del W0
        self.failed = 0

    def batch(self, i: int) -> dict:
        return {"tokens": lm.tokens(self.seed, i, self.rows, self.length,
                                    self.cfg["vocab_size"], self.device)}

    def _step(self) -> float:
        self.model, self.opt, m = self.step_fn(self.model, self.opt,
                                               self.batch(self.n), self.n)
        loss = float(m["loss"])                   # waits for the step
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if not math.isfinite(loss):
            self.failed += 1
        self.n += 1
        return loss

    def unit(self, span) -> None:
        with span("train_step"):
            self._step()
        self.window_units += 1

    def counts(self) -> tuple:
        return self.window_units, self.failed

    def end_to_end(self, window_s: float) -> dict:
        return {"train_tokens_per_s":
                self.window_units * self.rows * self.length / window_s}

    def window_info(self, units: int) -> dict:
        cfg, B, L = self.cfg, self.rows, self.length
        return {
            "flops_per_unit": 3 * roofline.lm_forward_flops(
                cfg, B, L, B * (L - 1)),
            "flash_bwd_flops_per_unit": roofline.flash_flops(cfg, B, L, 10),
            "scan_bwd_bound_s_per_unit": cfg["n_layers"] * roofline.scan_bwd_s(
                B, L, cfg["d_inner"], cfg["ssm_state"])}

    def release(self) -> None:
        del self.model, self.opt, self.step_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, control: str | None = None) -> dict:
        """The reference's readings, training the same weights on the same
        batches (``control``: in that lower precision), kept once made."""
        key = control or "plain"
        if key not in self._ref:
            ref = core.reference(self.cfg["name"])
            tr = self.traffic
            W = lm.make_weights(self.cfg, self.seed, self.device)
            batches = [self.batch(i)["tokens"]
                       for i in range(int(tr["checked_steps"]))]
            self._ref[key] = ref.train(
                W, batches, self.cfg, opt=tr["optimizer"],
                sch=tr["schedule"], rows=int(tr["reference_rows"]),
                mm=getattr(ref, f"{control or 'plain'}_mm"))
        return self._ref[key]

    def check(self, control: str | None = None) -> dict:
        """Each checked step's loss gap (relative), and by the worst leaf
        the gap between the program's and the reference's norms of the
        first gradient and of the change, against the reference's norm of
        that leaf or of the median leaf, whichever is larger.  Leaves whose
        reference gradient is under a thousandth of the median leaf's move
        by round-off alone and are left out of the change.  The ``leaf_``
        numbers take the same gaps against each leaf's own norm, over the
        leaves the change counts, so that a small leaf (a norm's weight,
        ``D``, ``dt_bias``) left unmoved or moved double cannot hide under
        the median leaf's norm; the change's leaves the reference leaves
        where they were (an update under half a bf16 ulp of a weight near 1)
        have no norm of their own to be judged by.  With
        ``control`` the reference in that lower precision stands in the
        program's place."""
        want = self.reference()
        got = self.reference(control) if control else {
            "losses": self.losses, "g1": self.g1, "change": self.change}
        loss_gap = core.worst(abs(a - b) / abs(b)
                              for a, b in zip(got["losses"], want["losses"]))
        g_med = float(np.median(list(want["g1"].values())))
        c_med = float(np.median(list(want["change"].values())))
        grad_gap = core.worst(abs(got["g1"][k] - v) / max(v, g_med)
                              for k, v in want["g1"].items())
        moved = [k for k, v in want["g1"].items() if v >= 1e-3 * g_med]
        change_gap = core.worst(abs(got["change"][k] - want["change"][k])
                                / max(want["change"][k], c_med)
                                for k in moved)
        return {"loss_gap": loss_gap, "grad_gap": grad_gap,
                "change_gap": change_gap,
                "leaf_grad_gap": core.worst(
                    abs(got["g1"][k] - want["g1"][k]) / want["g1"][k]
                    for k in moved),
                "leaf_change_gap": core.worst(
                    abs(got["change"][k] - want["change"][k])
                    / want["change"][k] for k in moved
                    if want["change"][k] > 0)}
