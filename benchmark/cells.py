"""The two kinds of cell a driver builds on: requests of inference (a batch
of shapes through an entry of the test protocol) and optimizer steps of a
trainer. A driver (benchmark/drivers/<name>.py) names the program's entry
and its reference; everything else is here.

A driver's life in a run: Driver(cell, device) loads the program and its
weights; start(seeds) makes the shape pool and every seeded state; warm()
runs the first requests or steps (set-up); the window calls enqueue(i),
fetch(handle) and units_of(handle); program_outputs() is what the window
produced for the check; release() frees the program; reference_outputs(
low) computes the reference's answers to the same inputs (low: the
lower-precision control); compare(program, reference) gives the numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from .harness import ROOT, say
from .loops import NoClock
from .reference import compare, precision
from .traffic import ShapePool

WARM_REQUESTS = 2   # inference requests run in set-up
# training steps run in set-up and followed by the reference
CHECKED_STEPS = 3


def _free(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


class InferenceDriver:
    """Requests of `mix["batch"]` shapes; every draw of request i comes from
    a generator on the device seeded seeds["torch"] + i. The check samples
    mix["check_requests"] of the first mix["check_span"] window requests,
    drawn from the seed: their per-shape results (all the window's are
    fetched) and their network outputs (kept by a Recorder around the
    program's network) are compared with the reference's
    (reference/compare.py): the network's outputs, the IoUs and, in the
    test protocol, the residual of the shapes clustered alike (the
    driver's extras carry each shape's cluster count as "k")."""

    kind = "infer"

    def __init__(self, cell, dev):
        self.cell, self.dev = cell, dev
        self.cfg, self.mix = cell.config, cell.mix
        self.batch = int(self.mix["batch"])
        self.timer = NoClock()
        self.weights = {k: str(ROOT / v)
                        for k, v in self.cfg["weights"].items()}
        self.load_program()

    def load_program(self) -> None:
        raise NotImplementedError

    def call(self, i: int, batch):
        """Queue request i on the program -> (device results [B, M],
        extras kept for the check)."""
        raise NotImplementedError

    def start(self, seeds: dict) -> None:
        self.seeds = seeds
        self.pool = ShapePool(self.mix, seeds["pool"])
        rng = np.random.RandomState(seeds["sample"])
        span = int(self.mix["check_span"])
        self.sample = set(WARM_REQUESTS + rng.choice(
            span, int(self.mix["check_requests"]), replace=False))
        self.kept = {}
        self.failed = 0
        self.next_index = 0

    def generator(self, i: int) -> torch.Generator:
        gen = torch.Generator(device=self.dev)
        gen.manual_seed((self.seeds["torch"] + i) % (1 << 63))
        return gen

    def enqueue(self, i: int):
        idx = self.pool.take(self.batch)
        keep = i in self.sample
        self.net.keep = keep
        vals, extras = self.call(i, self.pool.batch(idx))
        self.net.keep = False
        if keep:
            extras["net"] = self.net.outputs.pop()
        return i, idx, vals, extras

    def fetch(self, handle) -> None:
        i, idx, vals, extras = handle
        host = vals.cpu().numpy()
        self.failed += int((~np.isfinite(host)).any(axis=1).sum())
        if i in self.sample:
            self.kept[i] = (idx, host, extras)

    def units_of(self, handle) -> int:
        return len(handle[1])

    def warm(self) -> None:
        for i in range(WARM_REQUESTS):
            self.fetch(self.enqueue(i))
        self.failed = 0
        self.next_index = WARM_REQUESTS

    def program_outputs(self) -> dict:
        return dict(sorted(self.kept.items()))

    def release(self) -> None:
        self.net = self.program = None
        self.kept = {}
        _free(self.dev)

    def compare(self, prog: dict, ref: dict) -> dict:
        if not prog or set(prog) != set(ref):
            return {k: float("inf") for k in self.cell.limits}
        keys = sorted(prog)
        p = np.concatenate([prog[k][1] for k in keys])
        r = np.concatenate([ref[k][1] for k in keys])
        kp, kr = ([c for k in keys for c in side[k][2].get("k", ())]
                  for side in (prog, ref))
        if len(p) != len(r) or len(kp) != len(kr):
            return {k: float("inf") for k in self.cell.limits}
        for i, (a, b) in enumerate(zip(p, r)):
            clusters = f" clusters {kp[i]} / {kr[i]}" if kp else ""
            say(f"sampled shape {i}: {self.columns} program {a.tolist()} "
                f"reference {b.tolist()}{clusters}")
        out = {"net_gap": compare.net_gap(
            [prog[k][2]["net"] for k in keys],
            [ref[k][2]["net"] for k in keys])}
        iou = [self.columns.index(c) for c in ("seg_iou", "prim_iou")]
        fits = {}
        if "residual" in self.columns:
            j = self.columns.index("residual")
            fits = dict(prog_k=kp, ref_k=kr, prog_res=p[:, j],
                        ref_res=r[:, j])
        out.update(compare.inference_gaps(p[:, iou], r[:, iou], **fits))
        return out

    def reference_outputs(self, prog: dict, low: bool = False) -> dict:
        """The reference's answers to the requests in `prog`, in blocks of
        one request."""
        with precision(low):
            self.load_reference()
            out = {i: self.reference_call(i, self.pool.batch(idx))
                   for i, (idx, _, _) in prog.items()}
        self.free_reference()
        return out

    def load_reference(self) -> None:
        raise NotImplementedError

    def reference_call(self, i: int, batch):
        raise NotImplementedError

    def free_reference(self) -> None:
        self.ref = None
        _free(self.dev)


class TrainingDriver:
    """Optimizer steps of mix["batch"] x mix["accum"] shapes, each subsampled
    to mix["keep_points"] points, fed from a generator over the pool behind
    the program's data.prefetch.lookahead as its trainers feed theirs. The
    point subsample draws from RandomState(seeds["subsample"]) and every
    other draw from one generator on the device seeded seeds["torch"]. The
    first CHECKED_STEPS steps run in set-up through the window's own call
    and feed; the reference follows them from the same start."""

    kind = "train"

    def __init__(self, cell, dev):
        self.cell, self.dev = cell, dev
        self.cfg, self.mix = cell.config, cell.mix
        self.accum, self.batch = int(self.mix["accum"]), int(self.mix["batch"])
        self.shapes = self.accum * self.batch
        self.keep = int(self.mix["keep_points"])
        self.timer = NoClock()
        self.weights = {k: str(ROOT / v)
                        for k, v in self.cfg.get("weights", {}).items()}
        self.load_program()

    def load_program(self) -> None:
        raise NotImplementedError

    def build(self, seeds: dict) -> None:
        """The program's model, optimizer and step -> self.model,
        self.optimizer, self.step_fn(x, labels, prim) -> metrics dict."""
        raise NotImplementedError

    def loss_of(self, metrics: dict) -> torch.Tensor:
        raise NotImplementedError

    def start(self, seeds: dict) -> None:
        self.seeds = seeds
        self.pool = ShapePool(self.mix, seeds["pool"])
        self.host_rng = np.random.RandomState(seeds["subsample"])
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(seeds["torch"])
        self.build(seeds)
        self.feed = self.lookahead(self._batches())
        self.failed = 0
        self.next_index = 0

    def _batches(self):
        while True:
            yield self.pool.batch(self.pool.take(self.shapes))

    def enqueue(self, i: int):
        pts, labels, normals, prim = next(self.feed)
        x, lab, pr = self.pack_batch(pts, labels, normals, prim,
                                     self.host_rng, self.keep, True,
                                     self.dev)
        m = self.step_fn(x, lab, pr)
        return i, torch.stack([self.loss_of(m), m["grad_ok"]])

    def fetch(self, handle):
        """The step's loss and gradient verdict on the host; a step whose
        loss is not finite or whose gradient was zeroed has failed."""
        loss, ok = handle[1].cpu().numpy()
        self.failed += int(not (np.isfinite(loss) and ok > 0))
        return loss

    def units_of(self, handle) -> int:
        return self.shapes

    def warm(self) -> None:
        """The first CHECKED_STEPS steps, with what the check reads: each
        step's loss, the first gradient (Adam's first moment after one
        step, over 1 - beta1) and the parameters' change over the steps."""
        named = list(self.model.named_parameters())
        p0 = {k: p.detach().clone() for k, p in named}
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        losses, grad = [], {}
        for i in range(CHECKED_STEPS):
            losses.append(float(self.fetch(self.enqueue(i))))
            if i == 0:
                grad = {k: self._first_moment(p) / (1.0 - beta1)
                        for k, p in named}
        change = {k: float(torch.linalg.norm((p.detach() - p0[k]).double()))
                  for k, p in named}
        self.recorded = {"losses": losses, "grad": grad, "change": change}
        self.failed = 0
        self.next_index = CHECKED_STEPS

    def _first_moment(self, p) -> float:
        """The norm of Adam's first moment of `p` (0 where the optimizer
        holds none: it has not stepped `p`)."""
        m = self.optimizer.state.get(p, {}).get("exp_avg")
        return 0.0 if m is None else float(torch.linalg.norm(m.double()))

    def program_outputs(self) -> dict:
        return self.recorded

    def release(self) -> None:
        self.model = self.optimizer = self.step_fn = None
        _free(self.dev)

    def step_inputs(self):
        """The first CHECKED_STEPS steps' inputs made again from the seeds:
        [(points [S, K, 3], labels, normals, prim)] subsampled as
        train.state.pack_batch does, and a generator in the state the first
        step's draws start from."""
        rng = np.random.RandomState(self.seeds["subsample"])
        out = []
        for s in range(CHECKED_STEPS):
            idx = self.pool.order[(s * self.shapes + np.arange(self.shapes))
                                  % self.pool.size]
            pts, labels, normals, prim = self.pool.batch(idx)
            sel = rng.choice(pts.shape[1], min(self.keep, pts.shape[1]),
                             replace=False)
            out.append((pts[:, sel], labels[:, sel], normals[:, sel],
                        prim[:, sel]))
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.seeds["torch"])
        return out, gen

    def reference_outputs(self, prog=None, low: bool = False,
                          half: bool = False) -> dict:
        """The reference's steps (low: the control; half: the planted
        fault that leaves out half of each step's batch)."""
        with precision(low):
            out = self.reference_steps(half)
        _free(self.dev)
        return out

    def reference_steps(self, half: bool = False) -> dict:
        raise NotImplementedError

    def compare(self, prog: dict, ref: dict) -> dict:
        """The numbers that the cell's limits name."""
        for t, (a, b) in enumerate(zip(prog["losses"], ref["losses"]), 1):
            say(f"step {t} loss {a!r}, reference {b!r}")
        gaps = compare.training_gaps(prog, ref)
        return {k: gaps[k] for k in self.cell.limits if k in gaps}
