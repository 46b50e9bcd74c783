"""Vivim serving: ``cli/infer.py::run_inference``, the CLI's request loop
(each batch's clip and masks copied from host numpy to the card, the
captured ``serving_forward`` replayed, the counts copied back to the
host), over an in-memory loader of seeded clips in a closed loop.

The loader hands out request 0, whose batch the program captures (set-up),
then requests until ``--seconds`` have passed since request 0 completed,
and with ``--trace`` a few more under the profiler.  A request runs from
its hand-off until the loop asks for the next one, by which time the
program has read its counts back to the host.

The replay's outputs of a sample of the window's requests, drawn from the
seed, are kept (copies of the graph's output buffers, which the next
replay overwrites).  The check runs the plain reference on those clips:
each pixel's class from the program must be the reference's best or lie
below it by no more than the limit (argmax ties are where rounding may
flip a class), and the program's counts must equal the counts of its own
classes against the masks.
"""

from __future__ import annotations

import types
from unittest import mock

import numpy as np
import torch

from perfbench import harness, programs, traffic, weights, work
from perfbench.reference import vivim as ref_lib


class Loader:
    """Seeded host requests, timed at each hand-off."""

    def __init__(self, cell, seconds, clock):
        self.cell, self.seconds, self.clock = cell, seconds, clock
        self.batch_size = cell.t["batch"]
        self.index = None
        self.window = None
        self.profile = None

    def __iter__(self):
        cell, clock = self.cell, self.clock
        self.index = 0
        yield cell.request(0)                   # the capture: set-up
        self.window = harness.Window(clock(), 0.0)
        i = 1
        while True:
            start = clock()
            self.index = i
            yield cell.request(i)
            end = clock()
            self.window.latencies.append(end - start)
            i += 1
            if end - self.window.start >= self.seconds:
                break
        self.window.end = end
        if cell.spec.trace:
            from torch.profiler import record_function

            from perfbench import trace
            n = cell.t["profiled_units"]
            with trace.profiled(cell.cuda) as out:
                with record_function(trace.WINDOW):
                    for k in range(n):
                        self.index = i + k
                        yield cell.request(i + k)
                    if cell.cuda:
                        torch.cuda.synchronize()
            self.profile = out[0]
            self.profile.units = n
        self.index = None


class Cell:
    def __init__(self, spec):
        self.spec = spec
        self.cfg, self.t = spec.config, spec.traffic
        self.dev = spec.device
        self.cuda = self.dev.startswith("cuda")
        self.kept = {}

    def request(self, i):
        """Request ``i`` as the CLI's loader gives it: host numpy, from the
        pool made in set-up."""
        return self.pool[i % len(self.pool)]

    def setup(self):
        cfg = self.cfg
        shapes = weights.shapes_of(ref_lib.build(cfg, self.dev))
        w = weights.make(shapes, traffic.sub_seed(self.spec.seed, "weights"),
                         self.dev)
        self.model = programs.vivim(cfg, w, self.dev).eval()
        self.prepare()

    def prepare(self):
        """The request pool (host numpy) and the sampled requests."""
        cfg = self.cfg
        self.pool = []
        for i in range(self.t["pool"]):
            clip, masks = traffic.clip_batch(
                self.spec.seed, i, self.t["batch"], cfg["clip_length"],
                cfg["image_size"], cfg["num_classes"])
            self.pool.append({"clip": clip.numpy(), "masks": masks.numpy()})
        # window requests: 1 on (request 0 is the capture)
        self.sample = {i + 1 for i in traffic.sample(
            self.spec.seed, self.t["sample_within"], self.t["checked"])}

    def measure(self, seconds, clock):
        from vivim_tpu_torch.cli import infer
        from vivim_tpu_torch.utils import cuda_graphs

        loader = Loader(self, seconds, clock)
        kept, sample = self.kept, self.sample

        class Keeping(cuda_graphs.GraphedCall):
            """The program's ``GraphedCall``, keeping copies of the outputs
            of the sampled requests (the next replay overwrites them)."""

            def __call__(self, *inputs):
                out = super().__call__(*inputs)
                if loader.index in sample:
                    kept[loader.index] = tuple(o.clone() for o in out)
                return out

        args = types.SimpleNamespace(
            num_classes=self.cfg["num_classes"], clip_length=self.cfg[
                "clip_length"], output_dir=self.spec.scratch,
            save_vis=False)
        with mock.patch.object(cuda_graphs, "GraphedCall", Keeping):
            infer.run_inference(args, self.model, loader, self.dev)
        w = loader.window
        w.amount = w.units * self.t["batch"] * self.cfg["clip_length"]
        return w, loader.profile

    def end_to_end(self, window):
        return {"serve_fps": window.rate(),
                "serve_p95_ms": harness.percentile(window.latencies, 95) * 1e3}

    def layer_info(self):
        cfg, b = self.cfg, self.t["batch"]
        model = ref_lib.build(cfg, "meta").eval()
        model.set_scan(ref_lib.no_scan)
        clip = torch.empty((b, cfg["clip_length"], cfg["image_size"],
                            cfg["image_size"], 3), device="meta")
        from torch.utils.flop_counter import FlopCounterMode
        with FlopCounterMode(display=False) as fc:
            model(clip)
        k1 = work.total([work.scan_work(*s, cfg["d_state"], 4)
                         for s in work.vivim_scan_shapes(cfg, b)])
        return {"flops_per_unit": fc.get_total_flops() + k1[1],
                "k1_work": k1}

    def release(self):
        self.model = None

    def reference(self):
        model = ref_lib.build(self.cfg, self.dev)
        model.load_state_dict(weights.make(
            weights.shapes_of(model),
            traffic.sub_seed(self.spec.seed, "weights"), self.dev))
        return model.eval()

    def compare(self, kept, model):
        """class_gap: the widest gap by which a pixel's class lies below the
        reference's best logit there; count_mismatch: the entries by which
        the counts differ from those of the classes against the masks."""
        nc, lim = self.cfg["num_classes"], self.spec.limits
        if not kept:
            return [harness.Check("checked_requests", 0.0, -1.0)]
        gap, mismatch = 0.0, 0
        with torch.no_grad():
            for i, (preds, conf, cm) in sorted(kept.items()):
                req = self.request(i)
                logits = model(torch.from_numpy(req["clip"]).to(self.dev))
                chosen = logits.gather(-1, preds.long()[..., None])[..., 0]
                gap = max(gap, float((logits.max(-1).values - chosen).max()))
                targets = torch.from_numpy(req["masks"]).to(self.dev).argmax(
                    -1).reshape(-1, *preds.shape[2:])
                p = preds.reshape(targets.shape).long()
                mismatch += count_mismatch(p, targets, conf, cm, nc)
        return [harness.Check("class_gap", gap, lim["class_gap"]),
                harness.Check("count_mismatch", float(mismatch),
                              lim["count_mismatch"])]

    def check(self):
        return self.compare(self.kept, self.reference())

    def control(self):
        """The reference with TF32 answers the sampled requests in the
        program's place: its classes and their counts."""
        model = self.reference()
        nc = self.cfg["num_classes"]
        kept = {}
        with torch.no_grad(), harness.tf32(True):
            for i in self.sample:
                req = self.request(i)
                preds = model(torch.from_numpy(req["clip"]).to(
                    self.dev)).argmax(-1)
                targets = torch.from_numpy(req["masks"]).to(
                    self.dev).argmax(-1)
                p, g = preds.flatten(0, 1), targets.flatten(0, 1)
                conf, cm = counts(p, g, nc)
                kept[i] = (preds.to(torch.uint8), conf, cm)
        return self.compare(kept, model)


def counts(p, g, nc):
    """Per-frame [tp, fp, tn, fn] and the confusion matrix in torch."""
    size = p[0].numel()
    conf = []
    for c in range(nc):
        pc, gc = p == c, g == c
        tp = (pc & gc).sum((1, 2))
        fp = (pc & ~gc).sum((1, 2))
        fn = (~pc & gc).sum((1, 2))
        conf.append(torch.stack([tp, fp, size - tp - fp - fn, fn], -1))
    cm = torch.zeros(nc * nc, dtype=torch.long, device=p.device).index_add_(
        0, (g * nc + p).reshape(-1), torch.ones(p.numel(), dtype=torch.long,
                                                device=p.device))
    return torch.stack(conf, 1), cm.view(nc, nc)


def count_mismatch(preds, targets, conf, cm, nc):
    """Entries by which the program's per-frame [tp, fp, tn, fn] counts and
    confusion matrix differ from those of its classes against the
    targets, counted in numpy."""
    p = preds.cpu().numpy()
    g = targets.cpu().numpy()
    size = p[0].size
    want = np.zeros((p.shape[0], nc, 4), np.int64)
    for c in range(nc):
        pc, gc = p == c, g == c
        tp = (pc & gc).sum((1, 2))
        fp = (pc & ~gc).sum((1, 2))
        fn = (~pc & gc).sum((1, 2))
        want[:, c] = np.stack([tp, fp, size - tp - fp - fn, fn], -1)
    want_cm = np.zeros((nc, nc), np.int64)
    np.add.at(want_cm, (g.ravel(), p.ravel()), 1)
    return int(np.abs(conf.cpu().numpy() - want).sum()
               + np.abs(cm.cpu().numpy() - want_cm).sum())
