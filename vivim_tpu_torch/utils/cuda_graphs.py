"""Compile once, replay many: CUDA graphs over the port's serving calls
and its train step.

The JAX package runs its serving forward (``cli/infer.py``'s jitted
``forward``), its decode loop (``nn/lm.py``'s jitted scan) and its train
step (``train/loop.py``'s jitted step) as compiled executables:
``jax.jit`` traces a function once per input signature and replays the
compiled program with no per-op dispatch from the host.  On the card the
port's counterpart is a CUDA graph, and ``GraphedCall`` is the
counterpart of ``jax.jit``:

- key: the inputs' shapes, dtypes and device, and the address, shape,
  strides and dtype of every weight tensor the graph reads.  The weights
  are given as a tree (a module: its current parameters and buffers; a
  dict, list or tuple of tensors, QTensor dicts included) and read again
  at each key, so a model moved by ``.to()`` gets a new capture and the
  graphs of its earlier placement are dropped, while ``load_state_dict``
  (a copy in place) keeps them.  The object holds the tree, so a replay
  reads only live tensors: never freed weights.
- first call of a key: ``capture`` (below) into static input and output
  buffers.  The entries of one object share one memory pool, since
  replays run one at a time.
- every call: the inputs copied into the static buffers, then one replay.
  The outputs are the static buffers: the next replay overwrites them, so
  a caller that keeps an output clones it.
- CPU inputs: ``fn`` is called directly.

There is no fallback: a capture or replay that fails raises.

The train step (``train/loop.py::make_train_step``) keys and warms up its
own captures, since a call advances the training state: its warm-ups are
real eager steps, and it captures through ``capture`` with no warm-up
call and the state's generator registered.

``CAPTURES`` and ``REPLAYS`` count captures and replays in this process.
The kernel wrappers count their launches in Python (``count_launches``
registers those counters here), and a count must equal what runs on the
card: a capture launches nothing, so ``capture`` takes back what the
captured call counted and keeps it in its ``Graph``, and every replay adds
it again.  The warm-up calls run, and count.

``CAPTURE_S`` sums the host seconds spent in ``capture`` (the warm-ups and
the capture: set-up, paid once per key).  The spans ``graph.key`` (the
key's walk over every weight tensor) and ``graph.replay`` (the copies into
the static inputs and the replay's submission) name the host's part of a
call in a profile (``utils/profiling.py::span``).
"""

from __future__ import annotations

import time
from collections.abc import Mapping

import torch
from torch import nn

from vivim_tpu_torch.utils.profiling import span

WARMUP_CALLS = 2
CAPTURES = 0
CAPTURE_S = 0.0
REPLAYS = 0
# (module, attribute) of every registered kernel launch counter
_COUNTERS = []


def count_launches(module, *names):
    """Register the launch counters ``module.<name>`` of a kernel wrapper
    module, so that graphs count their kernels per replay."""
    _COUNTERS.extend((module, name) for name in names)


def _counts():
    return [getattr(m, n) for m, n in _COUNTERS]


def _add_counts(counted):
    for (m, n), d in counted:
        setattr(m, n, getattr(m, n) + d)


def tensors_of(tree):
    """The tensors of a weight tree, in a fixed order: a module's
    parameters then buffers, a mapping's values, a sequence's items."""
    if isinstance(tree, nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, Mapping):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for node in tree for t in tensors_of(node)]


def tensors_key(tree):
    """Where the graph finds each tensor of ``tree``: (address, shape,
    strides, dtype) per tensor."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in tensors_of(tree))


def signature(x):
    return tuple(x.shape), x.dtype, x.device


class Graph:
    """One captured call: static inputs, the graph, static outputs, and
    the launches its kernels count per replay (((module, counter),
    launches) pairs)."""

    def __init__(self, graph, inputs, outputs, counted):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.counted = counted

    def __call__(self, *inputs):
        global REPLAYS
        with span("graph.replay"):
            for buf, x in zip(self.inputs, inputs):
                buf.copy_(x)
            self.graph.replay()
        _add_counts(self.counted)
        REPLAYS += 1
        return self.outputs


def capture(fn, static, pool=None, warmup=WARMUP_CALLS, generators=()):
    """``fn(*static)`` (CUDA tensors) as a ``Graph`` over ``static``:
    ``warmup`` calls on a side stream (kernel builds, cuBLAS and cuDNN
    workspaces, lazy init), then the capture into ``pool`` (a private
    pool when None).  ``generators``: the explicit ``torch.Generator``s
    ``fn`` draws from, registered with the graph, so that each replay
    draws what a call would draw and advances them as a call would (the
    default CUDA generator always is)."""
    global CAPTURES, CAPTURE_S
    t0 = time.perf_counter()
    with torch.cuda.device(static[0].device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn(*static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        before = _counts()
        # thread_local: the data loader's threads may run meanwhile
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            outputs = fn(*static)
    counted = [(c, a - b) for c, a, b in zip(_COUNTERS, _counts(), before)
               if a != b]
    _add_counts([(c, -d) for c, d in counted])   # nothing ran yet
    CAPTURES += 1
    CAPTURE_S += time.perf_counter() - t0
    return Graph(graph, static, outputs, counted)


class GraphedCall:
    """``fn(*inputs)`` (tensors in, a tensor or a tuple of tensors out)
    captured once per key and replayed (see the module docstring)."""

    def __init__(self, fn, weights=()):
        self.fn = fn
        self.weights = weights
        self.graphs = {}
        self.placement = None
        self.pool = None

    def key(self, *inputs):
        with span("graph.key"):
            return (tuple(signature(x) for x in inputs),
                    tensors_key(self.weights))

    def __call__(self, *inputs):
        if not inputs[0].is_cuda:
            return self.fn(*inputs)
        sig, placement = self.key(*inputs)
        if placement != self.placement:
            self.graphs.clear()
            self.placement = placement
        if sig not in self.graphs:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            self.graphs[sig] = capture(
                self.fn, tuple(x.clone() for x in inputs), self.pool)
        return self.graphs[sig](*inputs)
