"""Process groups for the port's parallel tests (``tests/test_torch_
seq_scan.py``, ``test_torch_data_parallel.py``, ``test_torch_parallel_
cli.py``, the LM's tensor-parallel, pipeline and expert-parallel files):
``run_ranks`` spawns the ranks of one gloo group on the CPU and the rank
bodies below run in them.  The ranks import torch and the port only; they
hand numpy arrays back through ``.npz`` files in the test's directory, and
the JAX oracle runs in the test process.

The ranks meet through a ``file://`` store in the test's directory, not a
TCP port: a port chosen free can be taken by another process before the
store binds it, and many groups start at once under the test workers.  A
rank whose body succeeded leaves through ``os._exit(0)`` once its group is
destroyed: in the interpreter's own teardown after that, torch (2.13 on
the CPU) now and then aborts the process ("terminate called without an
active exception", SIGABRT), every result already written, which would
fail the test."""

from __future__ import annotations

import datetime
import itertools
import os
import sys
import time
import traceback

import numpy as np
import torch

# a group that does not finish by then fails its test
WALL_S = 120
# the gloo timeout of the ranks: a rank left alone in a collective fails
# after this long
GROUP_TIMEOUT_S = 30


# the store files of this process's groups, one per run_ranks call
_STORES = itertools.count()


def _rank_main(body, rank, world, store, out_dir, args):
    try:
        import torch.distributed as dist

        torch.set_num_threads(1)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank))
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        from vivim_tpu_torch.parallel import mesh

        mesh.init_distributed("gloo", GROUP_TIMEOUT_S)  # finds the group
        body(rank, world, out_dir, *args)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_ranks(body, world, out_dir, *args, wall_s=WALL_S):
    """Run ``body(rank, world, out_dir, *args)`` in ``world`` spawned
    processes joined in one gloo group.  Fails as soon as a rank fails
    (the others are killed), with its traceback; kills every rank at
    ``wall_s``.  Returns the wall seconds."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    out_dir = str(out_dir)
    store = os.path.join(os.path.abspath(out_dir),
                         f"store_{os.getpid()}_{next(_STORES)}")
    procs = [ctx.Process(target=_rank_main,
                         args=(body, r, world, store, out_dir, args))
             for r in range(world)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad or time.monotonic() - t0 > wall_s:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
    errs = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errs.append(f"rank {r}:\n{f.read()}")
    if errs:
        raise RuntimeError("\n".join(errs))
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"ranks ended with exit codes {codes} after "
                           f"{time.monotonic() - t0:.1f} s")
    return time.monotonic() - t0


def save(out_dir, name, **arrays):
    np.savez(os.path.join(out_dir, f"{name}.npz"),
             **{k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in arrays.items()})


def load(out_dir, name):
    with np.load(os.path.join(str(out_dir), f"{name}.npz")) as f:
        return dict(f)


# --------------------------------------------------------------- bodies


def scan_inputs(seed, b, L, d, n, per_batch):
    """The seq-scan tests' inputs, numpy fp32 from a seed."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    pshape = (b, d) if per_batch else (d,)
    return dict(
        u=f(b, L, d), delta=(0.3 * f(b, L, d)),
        A=(-0.5 - rng.random(((b, d, n) if per_batch else (d, n))))
        .astype(np.float32),
        B=f(b, L, n), C=f(b, L, n), D=f(*pshape), z=f(b, L, d),
        bias=(0.1 * f(*pshape)), w=f(b, L, d))


SCAN_NAMES = ("u", "delta", "A", "B", "C", "D", "z", "bias")
# the inputs with an L axis, which the body takes as shards
SEQ_SHARDED = ("u", "delta", "B", "C", "z", "w")


def seq_scan_body(rank, world, out_dir, cases):
    """Each case: the sharded scan's output, last state and the grads of
    sum(y * w) + sum(last ** 2) w.r.t. the eight inputs; then a forward
    without autograd; then (L divisible) the same through the body on
    this rank's shards.  Launch-free on the CPU: the plain versions
    run."""
    import logging

    from vivim_tpu_torch.kernels.selective_scan import selective_scan
    from vivim_tpu_torch.parallel.mesh import make_mesh
    from vivim_tpu_torch.parallel.seq_scan import (
        seq_sharded_selective_scan_local,
    )

    mesh = make_mesh(world, axis="seq")
    for name, kw in cases.items():
        x = scan_inputs(**kw)
        ts = {k: torch.tensor(x[k], requires_grad=True) for k in SCAN_NAMES}
        records = []
        handler = logging.Handler()
        handler.emit = records.append
        log = logging.getLogger("vivim_tpu_torch.kernels.selective_scan")
        log.addHandler(handler)
        log.setLevel(logging.INFO)
        try:
            y, last = selective_scan(
                ts["u"], ts["delta"], ts["A"], ts["B"], ts["C"], ts["D"],
                ts["z"], ts["bias"], delta_softplus=True,
                return_last_state=True, seq_axis="seq", mesh=mesh)
        finally:
            log.removeHandler(handler)
        loss = (y * torch.from_numpy(x["w"])).sum() + (last ** 2).sum()
        loss.backward()
        with torch.no_grad():
            y_ng, last_ng = selective_scan(
                *(ts[k] for k in SCAN_NAMES[:5]), D=ts["D"], z=ts["z"],
                delta_bias=ts["bias"], delta_softplus=True,
                return_last_state=True, seq_axis="seq", mesh=mesh)
        save(out_dir, f"{name}_rank{rank}", y=y, last=last, y_ng=y_ng,
             last_ng=last_ng, log=np.array([r.getMessage() for r in records]),
             **{f"d{k}": ts[k].grad for k in SCAN_NAMES})
        if name == "indivisible":
            continue
        # the body on this rank's shards
        ls = kw["L"] // world
        mine = lambda k: (x[k][:, rank * ls:(rank + 1) * ls]
                          if k in SEQ_SHARDED else x[k])
        loc = {k: torch.tensor(mine(k), requires_grad=True)
               for k in SCAN_NAMES}
        y, last = seq_sharded_selective_scan_local(
            *(loc[k] for k in SCAN_NAMES[:5]), D=loc["D"], z=loc["z"],
            delta_bias=loc["bias"], group=mesh.group("seq"))
        ((y * torch.from_numpy(mine("w"))).sum()
         + (last ** 2).sum()).backward()
        save(out_dir, f"{name}_local_rank{rank}", y=y, last=last,
             **{f"d{k}": loc[k].grad for k in SCAN_NAMES})


def no_dropout(cfg):
    import dataclasses

    return dataclasses.replace(
        cfg, drop_path_rate=0.0, dropout_rate=0.0,
        segformer=dataclasses.replace(cfg.segformer, drop_path_rate=0.0,
                                      classifier_dropout=0.0))


def port_model(seed=0, mesh=None, with_edge=False, dropout=False,
               remat="none"):
    """The micro Vivim of the step tests (``test_torch_train_step.py``):
    seeded weights, random BatchNorm statistics, no dropout unless
    ``dropout`` (the config's rates), ``remat`` as the CLIs' flag; a
    ``mesh`` with a ``seq`` axis shards its Mamba layers."""
    import dataclasses

    from vivim_tpu_torch.nn.layers import init_weights
    from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig

    cfg = VivimConfig.micro_test(scan_implementation=None,
                                 with_edge=with_edge,
                                 remat_pre_scan=remat == "pre_scan",
                                 remat_blocks=remat == "blocks")
    if not dropout:
        cfg = no_dropout(cfg)
    if mesh is not None and mesh.size("seq") > 1:
        cfg = dataclasses.replace(cfg, seq_axis="seq", mesh=mesh)
    model = init_weights(Vivim(cfg), torch.Generator().manual_seed(seed))
    bn = model.decoder.batch_norm
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        bn.running_mean.copy_(0.1 * torch.randn(16, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(16, generator=g))
    return model


def batch(seed, B=4, T=2, S=32, C=3, edges=False):
    """A numpy batch of clips and one-hot masks [and 0 / 1 edge maps]."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, (B, T, S, S))
    out = {"clip": rng.standard_normal((B, T, S, S, 3)).astype(np.float32),
           "masks": np.eye(C, dtype=np.float32)[labels]}
    if edges:
        out["edges"] = (rng.random((B, T, S, S, 1)) < 0.2).astype(
            np.float32)
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _state_arrays(model):
    return {k: v for k, v in model.state_dict().items()}


# leaves of at least this many elements shard under ZeRO here: the micro
# model's leaves are all below the production threshold (the JAX
# package's tests/test_fsdp.py uses the same)
MIN_ELEMS = 64


def train_run(mesh, n_steps, grad_accum=1, zero=False, lr=1e-3, wd=5.0,
              B=4, seed=0, loss="recall_focused", with_edge=False,
              dropout=False, remat="none", clip=True):
    """``n_steps`` of ``make_train_step`` on this rank's blocks of
    ``batch(i, B)`` (``mesh`` None: one device, the whole batch); with
    ``with_edge`` the micro Vivim's edge head and the multiclass edge
    criterion; ``dropout`` and ``remat`` as ``port_model``; without
    ``clip`` the gradients stay as the reduction left them.  Returns
    (metrics per step, the state)."""
    from vivim_tpu_torch.parallel.fsdp import shard_state_fsdp
    from vivim_tpu_torch.parallel.mesh import shard_batch
    from vivim_tpu_torch.train import loop
    from vivim_tpu_torch.train.edge_loss import make_multiclass_edge_criterion

    model = port_model(seed, mesh, with_edge, dropout, remat)
    state = loop.create_train_state(
        model, lr, wd, n_steps, seed=0 if mesh is None else mesh.fold_seed(0))
    if not clip:
        state.opt.clip_norm = None
    if zero:
        shard_state_fsdp(state, mesh, min_shard_elems=MIN_ELEMS)
    step = loop.make_train_step(
        model, loss, 3, grad_accum=grad_accum, mesh=mesh,
        edge_loss_fn=make_multiclass_edge_criterion() if with_edge else None)
    out = []
    for i in range(n_steps):
        b = shard_batch(_torch_batch(batch(i, B, edges=with_edge)), mesh,
                        micro_batches=grad_accum)
        state, m = step(state, b)
        out.append({k: float(v) for k, v in m.items() if v is not None})
    return out, state


def dp_body(rank, world, out_dir):
    """Data parallel over 2 ranks: one step; three steps with grad_accum
    2; two DP and two ZeRO steps with their state bytes; one step with a
    loss weighted by the batch's class counts, and one with the edge head
    and loss; the eval step on a batch that divides and one that does
    not."""
    from vivim_tpu_torch.parallel.fsdp import state_bytes_per_device
    from vivim_tpu_torch.parallel.mesh import make_mesh
    from vivim_tpu_torch.train import loop

    mesh = make_mesh(world)
    ms, state = train_run(mesh, 1)
    save(out_dir, f"dp1_rank{rank}", **ms[0], **_state_arrays(state.model))
    ms, state = train_run(mesh, 3, grad_accum=2)
    save(out_dir, f"dp_accum_rank{rank}",
         loss=[m["loss"] for m in ms], grad_norm=[m["grad_norm"] for m in ms],
         **_state_arrays(state.model))
    ms, state = train_run(mesh, 2, lr=1e-3, wd=0.01)
    dp_bytes = state_bytes_per_device(state)
    save(out_dir, f"dp2_rank{rank}", grad_norm=[m["grad_norm"] for m in ms],
         **_state_arrays(state.model))
    ms, state = train_run(mesh, 2, zero=True, lr=1e-3, wd=0.01)
    zero_bytes = state_bytes_per_device(state)
    at_rest = sum(p.numel() for p in state.model.parameters())
    n_sharded = len(state.zero.leaves)
    with state.zero.full():
        save(out_dir, f"zero2_rank{rank}",
             grad_norm=[m["grad_norm"] for m in ms], dp_bytes=dp_bytes,
             zero_bytes=zero_bytes, at_rest=at_rest, n_sharded=n_sharded,
             **_state_arrays(state.model))
    for name, kw in (("dp_focal", dict(loss="combined_focal_dice")),
                     ("dp_edge", dict(with_edge=True))):
        ms, state = train_run(mesh, 1, **kw)
        save(out_dir, f"{name}_rank{rank}", **ms[0],
             **_state_arrays(state.model))
    model = port_model(3)
    state = loop.create_train_state(model, 1e-3, 0.0, 1, seed=0)
    step = loop.make_eval_step(model, "recall_focused", 3,
                               return_preds=True, mesh=mesh)
    for B in (4, 3):
        loss, conf, cm, preds = step(state, _torch_batch(batch(7, B)))
        save(out_dir, f"eval{B}_rank{rank}", loss=loss, conf=conf, cm=cm,
             preds=preds)


def hybrid_body(rank, world, out_dir):
    """One step on a 2 x 2 ("data", "seq") mesh: the batch's blocks over
    data, the Mamba layers sharded over seq."""
    from vivim_tpu_torch.parallel.mesh import make_hybrid_mesh

    mesh = make_hybrid_mesh(2, 2)
    ms, state = train_run(mesh, 1)
    save(out_dir, f"hybrid_rank{rank}", **ms[0], coords=[
        mesh.index("data"), mesh.index("seq")], **_state_arrays(state.model))


# the sequence-parallel layouts of the tests: (data ranks, seq ranks);
# the global batch of a step is 2 clips per data rank
SEQ_LAYOUTS = {"seq2": (1, 2), "seq4": (1, 4), "hybrid": (2, 2)}


def layout_batch(layout):
    return 2 * SEQ_LAYOUTS[layout][0]


def layout_mesh(layout):
    from vivim_tpu_torch.parallel.mesh import make_hybrid_mesh, make_mesh

    dp, n = SEQ_LAYOUTS[layout]
    return make_mesh(n, axis="seq") if dp == 1 else make_hybrid_mesh(dp, n)


def grads_of(model):
    return {f"g:{k}": p.grad for k, p in model.named_parameters()
            if p.grad is not None}


def _logged_forward(model, clip):
    """An eval forward of ``clip``: (logits, the port's log lines, the
    token count of every MambaLayer's in_proj output, each stage's calls
    of each sequence exchange)."""
    import logging

    from vivim_tpu_torch.nn.mamba import MambaLayer
    from vivim_tpu_torch.parallel import comm

    records, tokens = [], []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("vivim_tpu_torch")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    hooks = [m.mamba.in_proj.register_forward_hook(
        lambda mod, inp, out: tokens.append(out.shape[1]))
        for m in model.modules() if isinstance(m, MambaLayer)]
    comm.reset_counters()
    try:
        with torch.no_grad():
            logits = model(torch.from_numpy(clip))
    finally:
        log.removeHandler(handler)
        for h in hooks:
            h.remove()
    return logits, dict(
        log=np.array([r.getMessage() for r in records]),
        in_proj_tokens=np.array(tokens),
        exchanges=np.array([comm.SEQ[k][0] for k in sorted(comm.SEQ)]),
        hops=comm.HOPPED[0])


def seq_model_body(rank, world, out_dir, layout="seq2", extras=False):
    """One sequence-parallel ``layout`` (``SEQ_LAYOUTS``) of the micro
    Vivim: an eval forward of the seeded weights with its Mamba layers
    sharded (its log lines, in_proj's token counts and the exchanges'
    calls); one train step on this rank's data block of the global batch
    (``layout_batch``); one without clipping, for the reduced gradients.
    With ``extras``, for ``seq2`` also the step under each remat level and
    one with every dropout on, for ``seq4`` the forward of a clip whose
    second stage's tokens do not divide over 4, for ``hybrid`` the step
    with ZeRO over data."""
    mesh = layout_mesh(layout)
    B = layout_batch(layout)
    model = port_model(0, mesh).eval()
    logits, fwd = _logged_forward(model, batch(5, B=2)["clip"])
    ms, state = train_run(mesh, 1, B=B)
    step_state = state
    save(out_dir, f"{layout}_rank{rank}", logits=logits, **fwd, **ms[0],
         coords=[mesh.index("data"), mesh.index("seq")],
         **_state_arrays(state.model))
    ms, state = train_run(mesh, 1, B=B, clip=False)
    save(out_dir, f"{layout}_grads_rank{rank}", **ms[0],
         **grads_of(state.model))
    if not extras:
        return
    if layout == "seq2":
        for remat in ("pre_scan", "blocks"):
            ms, state = train_run(mesh, 1, B=B, remat=remat)
            save(out_dir, f"{layout}_{remat}_rank{rank}", **ms[0],
                 **_state_arrays(state.model))
        ms, state = train_run(mesh, 1, B=B, dropout=True)
        save(out_dir, f"{layout}_dropout_rank{rank}", **ms[0],
             generator=state.generator.get_state(),
             seed=mesh.fold_seed(0), **_state_arrays(state.model))
    if layout == "seq4":
        logits, fwd = _logged_forward(port_model(0, mesh).eval(),
                                      batch(5, B=2, S=24)["clip"])
        save(out_dir, f"{layout}_odd_rank{rank}", logits=logits, **fwd)
    if layout == "hybrid":
        # the first moments after one step: 0.1 x the clipped gradients
        mus = lambda st: {f"mu:{k}": m for k, m in zip(st.opt.names,
                                                      st.opt.mu)}
        save(out_dir, f"{layout}_mu_rank{rank}", **mus(step_state))
        ms, state = train_run(mesh, 1, B=B, zero=True)
        with state.zero.full():
            save(out_dir, f"{layout}_zero_rank{rank}", **ms[0],
                 **_state_arrays(state.model), **mus(state))


def seq_exchange_body(rank, world, out_dir):
    """Each sequence exchange of ``comm`` on this rank's shards of
    ``exchange_inputs``: its output and the gradient of this rank's loss
    ``exchange_loss`` w.r.t. its input."""
    from vivim_tpu_torch.parallel import comm
    from vivim_tpu_torch.parallel.mesh import make_mesh

    group = make_mesh(world, axis="seq").group("seq")
    x = exchange_inputs(world)
    for name in EXCHANGES:
        leaves = {k: torch.from_numpy(v).requires_grad_(True)
                  for k, v in x[name].items()}
        mine = {k: (v if name == "shard" else
                    v.narrow(-2, rank * (v.shape[-2] // world),
                             v.shape[-2] // world).detach()
                    .requires_grad_(True))
                for k, v in leaves.items()}
        out = exchange_apply(comm, name, mine, group, rank, world)
        exchange_loss(name, out, x["w"], rank).backward()
        save(out_dir, f"x_{name}_rank{rank}",
             **{f"out{i}": o for i, o in enumerate(out)},
             **{f"g:{k}": v.grad for k, v in mine.items()})


EXCHANGES = ("halo", "permute", "permute_each", "gather_partial",
             "gather_replicated", "shard")
# (N, Ls, C) of a shard in the exchange tests, the halo's k, frames
X_SHAPE, X_HALO, X_FRAMES = (2, 6, 3), 3, 3


def exchange_inputs(world, seed=0):
    """The whole inputs of each exchange's test, numpy fp32 from a seed,
    and a bank of loss weights."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    n, ls, c = X_SHAPE
    L = world * ls
    return {"halo": {"x": f(n, L, c)}, "permute": {"x": f(1, n, L, c)},
            "permute_each": {"x": f(2, n, L, c)},
            "gather_partial": {"x": f(n, L, c)},
            "gather_replicated": {"x": f(n, L, c)},
            "shard": {"a": f(n, L, c), "b": f(n, L, 2 * c)},
            "w": f(8, 2, n, L, 2 * c)}


def exchange_apply(comm, name, x, group, rank, world):
    """The exchange ``name`` on this rank's tensors ``x``: a tuple of
    outputs (with ``group`` None and world 1, its one-device meaning)."""
    from vivim_tpu_torch.nn.mamba import direction_index

    L = world * X_SHAPE[1]
    into, back = direction_index(L, X_FRAMES, torch.device("cpu"))
    if name == "halo":
        return (comm.seq_halo(x["x"], X_HALO, group),)
    if name in ("permute", "permute_each"):
        return (comm.seq_permute(x["x"], into if name == "permute" else back,
                                 group),)
    if name == "gather_partial":
        # an op every rank computes whole, of which it keeps its slice
        whole = torch.cumsum(comm.seq_gather_partial(x["x"], group), 1) ** 2
        ls = whole.shape[1] // world
        return (whole[:, rank * ls:(rank + 1) * ls],)
    if name == "gather_replicated":
        # replicated layers after it: every rank computes the same
        return (torch.tanh(comm.seq_gather_replicated(x["x"], group)),)
    return comm.seq_shard(group, x["a"], x["b"])


def exchange_loss(name, outs, w, rank):
    """This rank's loss: its outputs weighted by its own weights (the
    replicated output of ``gather_replicated`` by weights every rank
    shares: every rank holds the same copy of that loss)."""
    w = torch.from_numpy(w)[0 if name == "gather_replicated" else rank]
    return sum((o * w[i].reshape(-1)[:o.numel()].reshape(o.shape)).sum()
               for i, o in enumerate(outs))


def failing_body(rank, world, out_dir):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))


def cli_body(rank, world, out_dir, cli, argv, min_shard_elems=None):
    """``cli.main(argv)`` on this rank (torchrun's environment is set);
    its return value goes to ``cli_rank{rank}.json``.  ``min_shard_elems``
    lowers ZeRO's threshold, for the tiny model's leaves to shard."""
    import importlib
    import json
    import logging

    from vivim_tpu_torch.parallel import fsdp

    if min_shard_elems is not None:
        fsdp.MIN_SHARD_ELEMS = min_shard_elems
    mod = importlib.import_module(f"vivim_tpu_torch.cli.{cli}")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("vivim_tpu_torch")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        res = mod.main(argv)
    finally:
        log.removeHandler(handler)
    with open(os.path.join(out_dir, f"cli_rank{rank}.json"), "w") as f:
        json.dump(res, f, default=float)
    seq = sorted({r.getMessage() for r in records if "seq-s" in r.getMessage()})
    with open(os.path.join(out_dir, f"cli_log_rank{rank}.json"), "w") as f:
        json.dump(seq, f)


# ------------------------------------------------- LM model-parallel bodies


class CharTok:
    """The JAX TP / PP tests' tokenizer: ids of characters mod 50, eos 0."""

    eos_token_id = 0

    def encode(self, s):
        return [ord(c) % 50 for c in s]

    def decode(self, ids):
        return "".join(chr(65 + (i % 26)) for i in ids)


# the JAX TP test's decode cases: greedy up to eos 1, and a draw at
# temperature 0.8 from the top 5
GEN_CASES = ({"temperature": 0.0, "eos_token_id": 1},
             {"temperature": 0.8, "top_k": 5})
GEN_SEED = 3
SCORE_PAIR = ("hello wor", "ld")


def _tensors(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def load_lm(out_dir, name, lm_cfg):
    """(port MambaLM, its parameter dict, tokens) from ``name``.npz (a port
    state_dict beside ``tokens``)."""
    from vivim_tpu_torch.nn import lm as tlm

    d = load(out_dir, name)
    toks = torch.from_numpy(d.pop("tokens")).long()
    model = tlm.MambaLM(tlm.MambaLMConfig(**lm_cfg))
    model.load_state_dict(_tensors(d), strict=True)
    return model.eval(), tlm.lm_params(model), toks


def _grad_run(forward, params):
    """(logits, {name: grad}) of sum(logits ** 2) through ``forward`` from
    leaves cloned off ``params``."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    logits = forward(leaves)
    (logits ** 2).sum().backward()
    return logits, {k: p.grad for k, p in leaves.items()
                    if p.grad is not None}


def _prefixed(prefix, d):
    return {f"{prefix}{k}": v for k, v in d.items()}


def tp_body(rank, world, out_dir, lm_cfg):
    """Tensor parallel over a "model" axis of every rank: the plain and the
    biased mixer; the LM's logits and the gradients of sum(logits ** 2)
    from this rank's split; ``tp_generate`` in both decode cases and with
    biased mixers; the eval core's score, greedy continuation and the
    bytes its split holds."""
    from vivim_tpu_torch.cli.lm_eval_harness import MambaEvalCore
    from vivim_tpu_torch.parallel import tensor_parallel as tp
    from vivim_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(world, axis="model")
    res = {}
    for name in ("mixer", "mixer_bias"):
        d = _tensors(load(out_dir, name))
        res[f"{name}_y"] = tp.tp_mamba_mixer(d, d.pop("x"), mesh)
    model, params, toks = load_lm(out_dir, "lm", lm_cfg)
    cfg = model.cfg
    local = tp.split_tp_params(params, mesh)
    logits, grads = _grad_run(
        lambda p: tp.lm_tp_forward(cfg, p, toks, mesh), local)
    res.update(logits=logits, **_prefixed("g:", grads))
    _, _, gen_toks = load_lm(out_dir, "gen", lm_cfg)
    for i, kw in enumerate(GEN_CASES):
        res[f"gen{i}"] = tp.tp_generate(
            model, local, gen_toks, 6, mesh,
            generator=torch.Generator().manual_seed(GEN_SEED), **kw)
    d = _tensors(load(out_dir, "lm_bias"))
    bias_toks = d.pop("tokens").long()
    res["gen_bias"] = tp.tp_generate(model, tp.split_tp_params(d, mesh),
                                     bias_toks, 5, mesh, temperature=0.0)
    core = MambaEvalCore(model, params, CharTok(), max_gen_toks=5,
                         tp_shards=world)
    res["ll"], res["greedy"] = core.loglikelihood_pair(*SCORE_PAIR)
    res["until"] = core.generate_until_str("ab")
    res["core_bytes"] = sum(v.untyped_storage().nbytes()
                            for v in core.params.values())
    res["split_bytes"] = sum(v.numel() * v.element_size()
                             for v in local.values())
    save(out_dir, f"tp_rank{rank}", **res)


def tp_hybrid_body(rank, world, out_dir, lm_cfg):
    """A 2 x 2 ("data", "model") mesh: the global batch's logits, each
    rank its data block's, its mixers split over model."""
    from vivim_tpu_torch.data.loader import block_rows
    from vivim_tpu_torch.parallel import tensor_parallel as tp
    from vivim_tpu_torch.parallel.mesh import make_hybrid_mesh

    mesh = make_hybrid_mesh(2, 2, ("data", "model"))
    model, params, toks = load_lm(out_dir, "lm4", lm_cfg)
    with torch.no_grad():
        logits = tp.lm_tp_forward(model.cfg,
                                  tp.split_tp_params(params, mesh), toks,
                                  mesh, batch_axis="data")
    save(out_dir, f"tp_hybrid_rank{rank}", logits=logits,
         rows=block_rows(toks.shape[0], mesh.index("data"), 2),
         coords=[mesh.index("data"), mesh.index("model")])


def pp_body(rank, world, out_dir, cases, hybrid_cfg=None):
    """Pipeline over a "pipe" axis of every rank, one result per case:
    ``(npz name, config, n_micro, with gradients)``; then with 2 ranks the
    eval core's score and both hop routes of ``comm.ppermute`` on the same
    tensors, with 4 and a ``hybrid_cfg`` the 2 x 2 ("data", "pipe")
    case."""
    from vivim_tpu_torch.cli.lm_eval_harness import MambaEvalCore
    from vivim_tpu_torch.parallel import comm
    from vivim_tpu_torch.parallel import pipeline as pp
    from vivim_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(world, axis="pipe")
    for name, lm_cfg, n_micro, grads in cases:
        model, params, toks = load_lm(out_dir, name, lm_cfg)
        fwd = lambda p: pp.lm_pp_forward(model.cfg, p, toks, mesh,
                                         n_micro=n_micro)
        comm.reset_counters()
        if grads:
            logits, g = _grad_run(fwd, params)
        else:
            with torch.no_grad():
                logits, g = fwd(params), {}
        save(out_dir, f"pp_{name}_w{world}_rank{rank}", logits=logits,
             hops=comm.HOPPED, **_prefixed("g:", g))
    if world == 2:
        model, params, _ = load_lm(out_dir, cases[0][0], cases[0][1])
        core = MambaEvalCore(model, params, CharTok(), pp_stages=world)
        ll, greedy = core.loglikelihood_pair(*SCORE_PAIR)
        x = torch.arange(6.0).reshape(2, 3) + 10 * rank
        hop = [(i, (i + 1) % world) for i in range(world)]
        routes = {}
        for route in (comm._hop_p2p, comm._hop_gather):
            routes[route.__name__] = route(x.clone(), hop, comm.world())
        xr = x.clone().requires_grad_(True)
        y = comm.ppermute(xr, hop, comm.world())
        (y * (rank + 1)).sum().backward()
        save(out_dir, f"pp_core_rank{rank}", ll=ll, greedy=greedy,
             ppermute=y, ppermute_grad=xr.grad, **routes)
    if hybrid_cfg is not None:
        from vivim_tpu_torch.data.loader import block_rows
        from vivim_tpu_torch.parallel.mesh import make_hybrid_mesh

        mesh = make_hybrid_mesh(2, 2, ("data", "pipe"))
        model, params, toks = load_lm(out_dir, "hybrid", hybrid_cfg)
        with torch.no_grad():
            logits = pp.lm_pp_forward(model.cfg, params, toks, mesh,
                                      n_micro=2, batch_axis="data")
        save(out_dir, f"pp_hybrid_rank{rank}", logits=logits,
             rows=block_rows(toks.shape[0], mesh.index("data"), 2, 2))


def lm_cli_body(rank, world, out_dir, bench_argv, eval_argv):
    """``bench_generation.main(bench_argv)``, then ``lm_eval_harness.main(
    eval_argv)`` with ``lm_eval`` and the tokenizer stood in for (neither
    is installed here): the stand-in harness asks the wrapper for the
    log-likelihood of ``SCORE_PAIR``."""
    import contextlib
    import io
    import json
    import sys
    import types

    import transformers

    from vivim_tpu_torch.cli import bench_generation, lm_eval_harness

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_generation.main(bench_argv)
    lines = buf.getvalue().strip().splitlines()

    class Request:
        def __init__(self, *args):
            self.args = args

    def simple_evaluate(model, tasks, limit):
        return {"results": {"pair": model.loglikelihood(
            [Request(*SCORE_PAIR)])[0]}}

    harness = types.ModuleType("lm_eval")
    harness.simple_evaluate = simple_evaluate
    api = types.ModuleType("lm_eval.api")
    api.model = types.ModuleType("lm_eval.api.model")
    api.model.LM = object
    sys.modules.update({"lm_eval": harness, "lm_eval.api": api,
                        "lm_eval.api.model": api.model})
    transformers.AutoTokenizer.from_pretrained = lambda name: CharTok()
    with contextlib.redirect_stdout(io.StringIO()):
        results = lm_eval_harness.main(eval_argv)
    with open(os.path.join(out_dir, f"lm_cli_rank{rank}.json"), "w") as f:
        json.dump({"bench": lines, "eval": results["results"]["pair"]}, f)


# ------------------------------------------------ MoE expert-parallel bodies


def _ep_ffn_run(params, x, mesh, batch_axis=None, capacity_factor=1.0):
    """``ep_moe_ffn`` of this rank's rows of ``x`` (all of them without
    ``batch_axis``) and the gradients of sum(y^2) + 1e-2 aux w.r.t. the
    whole params and those rows; the comm counters of the forward and of
    the backward."""
    from vivim_tpu_torch.parallel import comm
    from vivim_tpu_torch.parallel.expert import ep_moe_ffn
    from vivim_tpu_torch.parallel.mesh import local_rows

    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xr = local_rows(x, mesh, batch_axis).clone().requires_grad_(True)
    comm.reset_counters()
    y, aux = ep_moe_ffn(leaves, xr, mesh, capacity_factor=capacity_factor,
                        batch_axis=batch_axis)
    fwd = dict(gathered=list(comm.GATHERED), reduced=list(comm.REDUCED))
    comm.reset_counters()
    ((y ** 2).sum() + 1e-2 * aux).backward()
    return dict(y=y, aux=aux, gx=xr.grad, fwd_gathered=fwd["gathered"],
                fwd_reduced=fwd["reduced"], bwd_gathered=comm.GATHERED,
                bwd_reduced=comm.REDUCED,
                **{f"g:{k}": p.grad for k, p in leaves.items()})


def _ep_lm_run(cfg, params, toks, mesh, batch_axis=None):
    """``lm_ep_forward`` from this rank's ``split_ep_params`` and the
    gradients of its rows' summed next-token CE + aux_loss_weight x aux;
    the split's shapes and the comm counters as ``_ep_ffn_run``."""
    from vivim_tpu_torch.parallel import comm
    from vivim_tpu_torch.parallel.expert import lm_ep_forward, split_ep_params
    from vivim_tpu_torch.parallel.mesh import local_rows

    local = split_ep_params(params, mesh)
    leaves = {k: v.clone().requires_grad_(True) for k, v in local.items()}
    comm.reset_counters()
    logits, aux = lm_ep_forward(cfg, leaves, toks, mesh,
                                batch_axis=batch_axis)
    fwd = dict(gathered=list(comm.GATHERED), reduced=list(comm.REDUCED))
    comm.reset_counters()
    mine = local_rows(toks, mesh, batch_axis)
    logp = torch.log_softmax(logits[:, :-1].float(), -1)
    ce = -logp.gather(-1, mine[:, 1:, None]).sum()
    (ce + cfg.aux_loss_weight * aux).backward()
    return dict(logits=logits, aux=aux, fwd_gathered=fwd["gathered"],
                fwd_reduced=fwd["reduced"], bwd_gathered=comm.GATHERED,
                bwd_reduced=comm.REDUCED,
                wi_shape=local["moe_0.wi"].shape,
                **{f"g:{k}": p.grad for k, p in leaves.items()})


def ep_body(rank, world, out_dir, lm_cfg, hybrid):
    """Expert parallel over an "expert" axis of every rank: ``ep_moe_ffn``
    and ``lm_ep_forward`` with their gradients; with ``hybrid`` (4 ranks)
    also both on a 2 x 2 ("data", "expert") mesh, each rank its data
    block's rows."""
    from vivim_tpu_torch.nn import moe
    from vivim_tpu_torch.parallel.mesh import make_hybrid_mesh, make_mesh

    cfg = moe.MoEMambaLMConfig(**lm_cfg)
    ffn = _tensors(load(out_dir, "ffn"))
    x = ffn.pop("x")
    lm = _tensors(load(out_dir, "lm"))
    toks = lm.pop("tokens").long()
    meshes = [("ep", make_mesh(world, axis="expert"), None)]
    if hybrid:
        meshes.append(("dp_ep", make_hybrid_mesh(2, world // 2,
                                                  ("data", "expert")),
                       "data"))
    for name, mesh, batch_axis in meshes:
        save(out_dir, f"{name}_ffn_w{world}_rank{rank}",
             **_ep_ffn_run(ffn, x, mesh, batch_axis))
        save(out_dir, f"{name}_lm_w{world}_rank{rank}",
             coords=[mesh.index("data"), mesh.index("expert")],
             **_ep_lm_run(cfg, lm, toks, mesh, batch_axis))
