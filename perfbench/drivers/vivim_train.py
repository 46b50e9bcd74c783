"""Vivim training: the program's train step, ``train/loop.py``'s
``make_train_step`` on a ``create_train_state`` state, driven in a closed
loop over a pool of seeded device batches, cycled, as ``Trainer.fit``
drives it (the loss read back every ``log_every`` steps).

Set-up makes the state and runs its first ``checked_steps`` steps through
the window's own call on distinct batches; their losses, the first
gradient as AdamW took it (its first moment after one step over 1 - b1)
and the parameters' change after the last are kept for the check.  The
window then continues the same state.  Once it closes, the state
(parameters, buffers, both moments, the step count, the dropout
generator's state) is copied to the host and ``checked_steps`` more steps
of the same call run on batches the pool never held; their losses, first
gradient (from the moments before and after it) and change are kept too.
The check replays the first steps with the plain reference from the same
weights, batches and dropout seed, and the late steps from the copied
state: the steps the window ran, replays of a captured step included.
"""

from __future__ import annotations

import statistics

import torch

from perfbench import harness, programs, traffic, weights, work
from perfbench.reference import vivim as ref_lib


def leaf_gap(prog, ref, names):
    """(largest |prog norm - ref norm| over the leaves ``names``, each
    against its reference norm or the median leaf's, the larger; that
    leaf)."""
    med = statistics.median(ref[n] for n in names)
    return max((abs(prog[n] - ref[n]) / max(ref[n], med), n) for n in names)


class Cell:
    def __init__(self, spec):
        self.spec = spec
        self.cfg, self.t = spec.config, spec.traffic
        self.dev = spec.device

    def batch(self, i):
        """Batch ``i`` of the inputs: the pool holds the first ``pool``;
        the late steps take those after it."""
        cfg, t = self.cfg, self.t
        return traffic.clip_batch(self.spec.seed, i, t["batch"],
                                  cfg["clip_length"], cfg["image_size"],
                                  cfg["num_classes"], self.dev)

    def setup(self):
        from vivim_tpu_torch.train import loop

        cfg, t, seed = self.cfg, self.t, self.spec.seed
        shapes = weights.shapes_of(ref_lib.build(cfg, self.dev))
        w0 = weights.make(shapes, traffic.sub_seed(seed, "weights"), self.dev)
        model = programs.vivim(cfg, w0, self.dev)
        self.state = loop.create_train_state(
            model, t["lr"], t["weight_decay"], t["total_steps"],
            seed=traffic.sub_seed(seed, "dropout"))
        self.step = loop.make_train_step(model, t["loss"], cfg["num_classes"])
        self.pool = [self.batch(i) for i in range(t["pool"])]
        opt = self.state.opt
        self.losses = []
        for i in range(t["checked_steps"]):
            self.state, m = self.step(self.state, self.as_batch(i))
            self.losses.append(float(m["loss"]))
            if i == 0:
                norms = torch._foreach_norm(opt.mu)
                self.grads = {n: float(v) / (1 - opt.b1)
                              for n, v in zip(opt.names, norms)}
        moved = torch._foreach_sub([p.detach() for p in opt.params],
                                   [w0[n] for n in opt.names])
        self.changes = {n: float(v) for n, v in
                        zip(opt.names, torch._foreach_norm(moved))}

    def as_batch(self, i):
        clip, masks = self.pool[i % len(self.pool)]
        return {"clip": clip, "masks": masks}

    def step_once(self, i):
        """Window step ``i`` (after the checked ones), reading the loss back
        every ``log_every`` steps as ``Trainer.fit`` does."""
        n = self.t["checked_steps"] + i
        self.state, m = self.step(self.state, self.as_batch(n))
        if (n + 1) % self.t["log_every"] == 0:
            float(m["loss"])

    def measure(self, seconds, clock):
        window, profile = harness.closed_loop(
            self.step_once, seconds, clock, harness.synchronizer(self.dev),
            self.t["profiled_units"] if self.spec.trace else 0,
            self.dev.startswith("cuda"))
        window.amount = window.units * self.t["batch"]
        self.late = self.late_steps()
        return window, profile

    def late_steps(self):
        """The state copied to the host, then ``checked_steps`` more steps
        of the window's own call on batches the pool never held: (copy,
        losses, the first gradient's leaf norms, the change's)."""
        state, opt, t = self.state, self.state.opt, self.t
        host = lambda xs: [x.detach().to("cpu", copy=True) for x in xs]
        sd = state.model.state_dict()
        snap = {"model": dict(zip(sd, host(sd.values()))),
                "mu": dict(zip(opt.names, host(opt.mu))),
                "nu": dict(zip(opt.names, host(opt.nu))), "count": opt.count,
                "generator": state.generator.get_state()}
        losses = []
        for j in range(t["checked_steps"]):
            clip, masks = self.batch(t["pool"] + j)
            self.state, m = self.step(self.state, {"clip": clip,
                                                   "masks": masks})
            losses.append(float(m["loss"]))
            if j == 0:
                mu0 = snap["mu"]
                grads = {n: float((a.double() - opt.b1 * mu0[n].double())
                                  .norm()) / (1 - opt.b1)
                         for n, a in zip(opt.names, host(opt.mu))}
        changes = {n: float((p.double() - snap["model"][n].double()).norm())
                   for n, p in zip(opt.names, host(opt.params))}
        return snap, losses, grads, changes

    def end_to_end(self, window):
        return {"train_clips_per_s": window.rate()}

    def layer_info(self):
        cfg, b = self.cfg, self.t["batch"]
        model = ref_lib.build(cfg, "meta").train()
        model.set_scan(ref_lib.no_scan)
        clip = torch.empty((b, cfg["clip_length"], cfg["image_size"],
                            cfg["image_size"], 3), device="meta")
        masks = torch.empty(clip.shape[:-1] + (cfg["num_classes"],),
                            device="meta")
        from torch.utils.flop_counter import FlopCounterMode
        with FlopCounterMode(display=False) as fc:
            ref_lib.clip_loss(model, clip, masks, cfg["num_classes"])
        shapes = work.vivim_scan_shapes(cfg, b)
        n = cfg["d_state"]
        k1 = work.total([work.train_fwd_work(*s, n, 4) for s in shapes])
        k2 = work.total([work.bwd_work(*s, n, 4) for s in shapes])
        # the backward as twice the forward (the input's and the weight's
        # gradients): FlopCounterMode counts a grouped convolution's
        # backward as if it were dense (the 3-D depthwise conv C times over)
        return {"flops_per_unit": 3 * fc.get_total_flops() + k1[1] + k2[1],
                "k1_work": k1, "k2_work": k2}

    def release(self):
        self.state = self.step = self.pool = None

    def reference_steps(self, precise=True):
        """The first ``checked_steps`` steps of the plain reference from the
        set-up's weights, batches and dropout seed: (losses, the first
        gradient's leaf norms as AdamW took it, the leaves' change norms);
        ``precise=False`` computes it with TF32 (the control)."""
        cfg, t, seed = self.cfg, self.t, self.spec.seed
        model = ref_lib.build(cfg, self.dev)
        w0 = weights.make(weights.shapes_of(model),
                          traffic.sub_seed(seed, "weights"), self.dev)
        model.load_state_dict(w0)
        gen = torch.Generator(device=self.dev).manual_seed(
            traffic.sub_seed(seed, "dropout"))
        opt = ref_lib.AdamW(model, t["lr"], t["weight_decay"],
                            t["total_steps"])
        return self.reference_run(model, gen, opt, 0, precise)

    def reference_late(self, precise=True):
        """The late steps of the plain reference from the state the window
        left (its copy), on the late steps' batches: as ``reference_steps``."""
        t, snap = self.t, self.late[0]
        model = ref_lib.build(self.cfg, self.dev)
        model.load_state_dict(snap["model"])
        gen = torch.Generator(device=self.dev)
        gen.set_state(snap["generator"])
        opt = ref_lib.AdamW(model, t["lr"], t["weight_decay"],
                            t["total_steps"])
        opt.count = snap["count"]
        for n, mu in snap["mu"].items():
            opt.mu[n].copy_(mu)
            opt.nu[n].copy_(snap["nu"][n])
        return self.reference_run(model, gen, opt, t["pool"], precise)

    def reference_run(self, model, gen, opt, first, precise):
        """``checked_steps`` reference steps of ``model`` and ``opt`` on
        batches ``first`` on, dropout drawn from ``gen``."""
        cfg = self.cfg
        model.train()
        model.set_generator(gen)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        losses = []
        with harness.tf32(not precise):
            for i in range(self.t["checked_steps"]):
                clip, masks = self.batch(first + i)
                model.zero_grad(set_to_none=True)
                loss = ref_lib.clip_loss(model, clip, masks,
                                         cfg["num_classes"])
                loss.backward()
                opt.step()
                losses.append(float(loss.detach()))
                if i == 0:
                    grads = {n: float(g.norm())
                             for n, g in opt.last_grads.items()}
        changes = {n: float((p.detach() - start[n]).norm())
                   for n, p in model.named_parameters() if n in grads}
        return losses, grads, changes

    def compare(self, got, want, stage=""):
        """The checks of (losses, grads, changes) ``got`` against the
        reference's ``want``: the worst step's relative loss gap, and the
        worst leaf's gap of the gradient and of the change (leaves whose
        reference gradient is under a thousandth of the median leaf's move
        by rounding alone and are left out of the change).  ``stage``
        prefixes the names (``late_``)."""
        losses, grads, changes = want
        med = statistics.median(grads.values())
        moving = [n for n in grads if grads[n] >= 1e-3 * med]
        lim = self.spec.limits
        grad = leaf_gap(got[1], grads, list(grads))
        change = leaf_gap(got[2], changes, moving)
        check = lambda name, value, note="": harness.Check(
            stage + name, value, lim[stage + name], note)
        return [
            check("loss_rel", max(abs(a - b) / abs(b)
                                  for a, b in zip(got[0], losses))),
            check("grad_leaf_gap", grad[0], f"leaf {grad[1]}"),
            check("change_leaf_gap", change[0], f"leaf {change[1]}"),
        ]

    def check(self):
        return (self.compare((self.losses, self.grads, self.changes),
                             self.reference_steps())
                + self.compare(self.late[1:], self.reference_late(), "late_"))

    def control(self):
        """The control: the reference with TF32 in the program's place, in
        the first steps and in the late ones from a state the program left
        after ``control_steps`` window steps (the program released first)."""
        self.setup()
        for i in range(self.t["control_steps"]):
            self.step_once(i)
        self.late = self.late_steps()
        self.release()
        if self.dev.startswith("cuda"):
            torch.cuda.empty_cache()
        return (self.compare(self.reference_steps(precise=False),
                             self.reference_steps())
                + self.compare(self.reference_late(precise=False),
                               self.reference_late(), "late_"))
