"""Branches and loops taken on the device: `cond` and `while_loop`, the
counterparts of jax.lax.cond and jax.lax.while_loop, `branches`, the
independent work of several sequences side by side, and `CapturedStep`, a
step function captured once into a CUDA graph and replayed — the port's
form of the reference's one device program per chunk (lax.scan over
frames with lax.cond and lax.while_loop inside,
flvis_tpu/pipeline/runner.py:104-170; vmapped over sequences in
flvis_tpu/parallel/multiseq.py:164-345).

cond(pred, true_fn, false_fn, operands) runs in one of three ways:
  - eager (the default): `bool(pred)` picks the branch — one host read;
  - under `both_branches()` (the capture's warm-up): both branches run and
    must return the same tree; the one `pred` picks is returned;
  - under a CapturedStep's capture: two CUDA-graph IF nodes, one on pred
    and one on !pred (csrc/cond.cu), each body captured from a stream of
    its own nesting depth.  The true body's outputs are the cond's outputs;
    the false body copies its outputs into them, so what follows reads
    fixed buffers whichever side ran.  The true body copies each of its
    outputs into a buffer of the cond's own first, so the false body never
    writes into an operand, a tensor a branch closes over, or another leaf.
Both branches must return the same tree — the same records, the same
non-tensor leaves, tensors of the same shapes, dtypes and devices — as
lax.cond requires; cond refuses anything else wherever both branches run
(the warm-up and the capture).  Branches must not write into their
operands.

while_loop(pred_fn, body_fn, carry) runs body_fn while pred_fn(carry) (a
0-d bool tensor) holds, in the same three ways: eagerly one host read of
the predicate an iteration; under `both_branches()` the body at least once
(so every handle and pool it needs exists), refusing a body that changes
the carry's tree; under a capture one WHILE node: the loop's state lives
in buffers of its own (a copy of `carry`), the body reads them, and its new
carry is copied back into them (through temporaries where a new leaf
aliases a state buffer), then the body's last kernel reads the new
predicate on the card.  So a loop is one site of a capture whatever its
iteration count.

branches(fn, items) is [fn(x) for x in items]; under a capture each call
runs on a stream of its own, forked from the current stream and joined
back after the last, so the graph holds len(items) independent branches
that the card runs side by side.  Each branch takes its own set of body
streams: a body's memory, freed on its stream, is only ever reused on that
stream, so two branches' bodies — which run at the same time — never share
it.

CapturedStep(fn, carry, xs) runs the step fn(carry, xs) → (carry', ys)
twice eagerly with both branches of every cond (so every kernel library,
cuBLAS handle and allocator pool the capture meets exists), refusing any
host read or host↔device copy there with an error naming the operation
(the predicates' own reads apart), then captures
it, with the copy of carry' into the static `carry`, into a
torch.cuda.CUDAGraph.  The caller copies each step's inputs into the
static `xs` before replay().
Memory the conditional bodies allocate comes from a MemPool of the step
(the bodies are separate captures, outside the graph's own pool).  A
failure during the capture raises, naming the last operation dispatched;
nothing falls back to eager execution.

The graph's node census (`top_nodes`, each body's in `sites`) and the
sites' taken counts on the card (`taken`: an IF site's (true, false)
sides, a WHILE site's (iterations, entries), one row a site in a block of
MAX_SITES rows for the step's own sites and one for each branch's; fetched
by the caller with its other outputs and handed to `settle`) give the
kernel nodes a replay ran.  A replay runs no Python, so the kernel wrappers' launch counters
(`fn.launches`) count the warm-up's launches and the capture's calls,
never a replay's: a replay's launches are read from the device (a
profile of the replays, as chip_smoke.py does).

Profiling a replay: see the package note (flvis_tpu_torch/__init__.py).
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import time
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import profiling
from .tree import tree_leaves, tree_map, tree_spec

MAX_SITES = 128         # conds and loops of a captured step, and of each branch (taken rows)
NODE_KINDS = ("kernel", "memcpy", "memset", "conditional", "other")


def _check_trees(specs):
    if specs[0] != specs[1]:
        raise ValueError("cond: the branches return different trees (records, non-tensor "
                         f"leaves, or tensor shapes/dtypes/devices):\n  true:  {specs[0]}\n"
                         f"  false: {specs[1]}")


def _check_pred(pred):
    if not (isinstance(pred, torch.Tensor) and pred.dtype == torch.bool and pred.dim() == 0):
        raise ValueError("cond: pred must be a 0-d bool tensor, got "
                         f"{type(pred).__name__} {getattr(pred, 'dtype', '')} "
                         f"{tuple(getattr(pred, 'shape', ()))}")


# ------------------------------------------------------------------- cond
class _Mode:
    both = False            # both_branches(): run and check both sides
    capture = None          # the _Capture under way
    reading_pred = False    # a cond or loop reads its predicate (allowed under _NoHostRead)


_MODE = _Mode()


@contextlib.contextmanager
def both_branches():
    """Within: every cond runs both branches, checks that they return the
    same tree and returns the side `pred` picks (one host read each)."""
    prev, _MODE.both = _MODE.both, True
    try:
        yield
    finally:
        _MODE.both = prev


def cond(pred, true_fn, false_fn, operands=(), name: str = "cond"):
    """true_fn(*operands) if pred else false_fn(*operands), pred a 0-d bool
    tensor (see the module note for the three ways it runs); `name` labels
    the cond's IF nodes in a capture's report."""
    _check_pred(pred)
    if _MODE.capture is not None:
        return _MODE.capture.cond(pred, true_fn, false_fn, tuple(operands), name)
    if _MODE.both:
        outs = [true_fn(*operands), false_fn(*operands)]
        _check_trees([tree_spec(o) for o in outs])
        return outs[0] if _read_pred(pred) else outs[1]
    return (true_fn if bool(pred) else false_fn)(*operands)


def _read_pred(pred) -> bool:
    """bool(pred), a read _NoHostRead lets through."""
    _check_pred(pred)
    prev, _MODE.reading_pred = _MODE.reading_pred, True
    try:
        return bool(pred)
    finally:
        _MODE.reading_pred = prev


def while_loop(pred_fn, body_fn, carry, name: str = "while"):
    """carry = body_fn(carry) while pred_fn(carry) (a 0-d bool tensor) —
    jax.lax.while_loop; see the module note for the three ways it runs.
    body_fn must return a tree of carry's structure and must not write into
    its operand; `name` labels the loop's WHILE node in a capture's
    report."""
    if _MODE.capture is not None:
        return _MODE.capture.while_loop(pred_fn, body_fn, carry, name)
    if _MODE.both:
        first = body_fn(carry)
        if tree_spec(first) != tree_spec(carry):
            raise ValueError(f"while_loop {name}: the body returns another tree than its carry "
                             f"(records, non-tensor leaves, or tensor shapes/dtypes/devices):\n"
                             f"  carry: {tree_spec(carry)}\n  body:  {tree_spec(first)}")
        if not _read_pred(pred_fn(carry)):
            return carry
        carry = first
        while _read_pred(pred_fn(carry)):
            carry = body_fn(carry)
        return carry
    while bool(pred_fn(carry)):
        carry = body_fn(carry)
    return carry


def branches(fn, items, name: str = "branch"):
    """[fn(x) for x in items] — under a capture, each call an independent
    branch of the graph on a stream of its own (see the module note)."""
    if _MODE.capture is not None:
        return _MODE.capture.branches(fn, list(items), name)
    return [fn(x) for x in items]


class _NoHostRead(TorchDispatchMode):
    """Raises on an operation a CUDA graph cannot hold: a device value read
    on the host, an output whose shape depends on the data, a tensor made
    from host data or copied between host and device.  The capture's
    warm-up runs under it, so such a step fails there, before its capture,
    naming the operation (a failure inside a capture can leave the
    allocator's capture state behind)."""

    DATA_DEPENDENT = {"aten._local_scalar_dense.default", "aten.nonzero.default",
                      "aten.masked_select.default", "aten._unique2.default",
                      "aten.unique_consecutive.default", "aten.unique_dim.default",
                      "aten.lift_fresh.default"}
    INDEXING = {"aten.index.Tensor", "aten.index_put.default", "aten.index_put_.default"}

    def __init__(self, name):
        super().__init__()
        self.name = name

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        op, kwargs = str(func), kwargs or {}
        if not _MODE.reading_pred and (op in self.DATA_DEPENDENT or _host_copy(op, args, kwargs)
                                       or _mask_index(op in self.INDEXING, args)):
            raise RuntimeError(f"{self.name} cannot be captured into a CUDA graph: it reads "
                               f"the host at {op}")
        return func(*args, **kwargs)


def _mask_index(indexing: bool, args) -> bool:
    """An index by a bool mask (its result's shape is the mask's count)."""
    return indexing and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                            for i in args[1] if i is not None)


def _host_copy(op, args, kwargs) -> bool:
    if op == "aten.copy_.default":
        dev = {args[0].device.type, args[1].device.type}
    elif op == "aten._to_copy.default" and "device" in kwargs:
        dev = {args[0].device.type, torch.device(kwargs["device"]).type}
    else:
        return False
    return dev == {"cpu", "cuda"}


# ---------------------------------------------------------------- capture
class _LastOp(TorchDispatchMode):
    """Keeps the name of the last operation dispatched under it (for a
    capture failure's message)."""

    last_op = "nothing"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last_op = str(func)
        return func(*args, **(kwargs or {}))


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


class _Capture:
    """One capture under way: emits the conditional nodes of each cond and
    while_loop, forks and joins branches, and keeps each body's node
    census.  stream_sets[0] is the capture's own set (its stream, then one
    body stream per nesting depth), stream_sets[1 + b] branch b's."""

    def __init__(self, lib, taken, stream_sets):
        self.lib, self.taken, self.stream_sets = lib, taken, stream_sets
        self.streams = stream_sets[0]       # the set of the code captured now
        self.sites = []         # per site: name, kind, depth, branch, per side its nodes
        self.depth = 0
        self.branch = None

    @staticmethod
    def _check(what, err):
        if err != 0:
            raise RuntimeError(f"cond capture: {what} failed with cudaError_t {err}")

    def _site(self, name, kind):
        """A new site of the code captured now: (its row of `taken`, its
        record) — rows [0, MAX_SITES) the step's own, then MAX_SITES a
        branch."""
        block = 0 if self.branch is None else 1 + self.branch
        n = sum(s["branch"] == self.branch for s in self.sites)
        if n >= MAX_SITES:
            where = "one step" if self.branch is None else f"branch {self.branch}"
            raise RuntimeError(f"cond capture: more than {MAX_SITES} conds and loops in {where}")
        if self.depth + 1 >= len(self.streams):
            raise RuntimeError(f"cond capture: conds nested deeper than {len(self.streams) - 1}")
        site = {"name": name, "kind": kind, "depth": self.depth, "branch": self.branch,
                "row": block * MAX_SITES + n, "nodes": [None, None]}
        self.sites.append(site)
        return site["row"], site

    def _body(self, parent, handle, is_while, fn):
        """Add a conditional node on `handle` after what `parent` captured
        and capture fn() into its body from the next depth's stream; returns
        the body's node census."""
        body = self.streams[self.depth + 1]
        self._check("a conditional node", self.lib.flvis_cond_body_begin(
            parent.cuda_stream, handle, int(is_while), body.cuda_stream))
        self.depth += 1
        counts = (ctypes.c_int * len(NODE_KINDS))()
        try:
            with torch.cuda.stream(body):
                fn()
        finally:
            self.depth -= 1
            end = self.lib.flvis_cond_body_end(body.cuda_stream, counts)
        self._check("ending a conditional body", end)
        return dict(zip(NODE_KINDS, counts))

    def cond(self, pred, true_fn, false_fn, operands, name):
        row, site = self._site(name, "if")
        parent = torch.cuda.current_stream()
        handles = (ctypes.c_ulonglong * 2)()
        self._check("opening a cond", self.lib.flvis_cond_open(
            parent.cuda_stream, pred.data_ptr(), self.taken[row].data_ptr(), handles))
        result = []

        def true_side():
            # Buffers of the cond's own, which the false side overwrites
            # without touching anything else.
            result.append(tree_map(torch.clone, true_fn(*operands)))

        def false_side():
            out = false_fn(*operands)
            _check_trees([tree_spec(result[0]), tree_spec(out)])
            for dst, src in zip(tree_leaves(result[0]), tree_leaves(out)):
                dst.copy_(src)

        for side, fn in enumerate((true_side, false_side)):
            site["nodes"][side] = self._body(parent, handles[side], False, fn)
        return result[0]

    def while_loop(self, pred_fn, body_fn, carry, name):
        row, site = self._site(name, "while")
        parent = torch.cuda.current_stream()
        state = tree_map(torch.clone, carry)    # the loop's buffers
        first = pred_fn(state)
        _check_pred(first)
        handle = ctypes.c_ulonglong()
        self._check("opening a while loop", self.lib.flvis_while_open(
            parent.cuda_stream, first.data_ptr(), self.taken[row].data_ptr(),
            ctypes.byref(handle)))

        def body():
            new = body_fn(state)
            if tree_spec(new) != tree_spec(state):
                raise ValueError(f"while_loop {name}: the body returns another tree than its "
                                 f"carry:\n  carry: {tree_spec(state)}\n  body:  {tree_spec(new)}")
            _assign(state, new)
            pred = pred_fn(state)
            _check_pred(pred)
            self._check("closing a while body", self.lib.flvis_while_next(
                torch.cuda.current_stream().cuda_stream, handle.value, pred.data_ptr(),
                self.taken[row].data_ptr()))

        site["nodes"] = [self._body(parent, handle.value, True, body),
                         dict.fromkeys(NODE_KINDS, 0)]
        return state

    def branches(self, fn, items, name):
        if self.branch is not None:
            raise RuntimeError(f"cond capture: {name}: branches inside a branch")
        if len(items) > len(self.stream_sets) - 1:
            raise RuntimeError(f"cond capture: {name}: {len(items)} branches in a step captured "
                               f"for {len(self.stream_sets) - 1}")
        parent = torch.cuda.current_stream()
        fork = torch.cuda.Event()
        fork.record(parent)
        outs, ends = [], []
        try:
            for b, x in enumerate(items):
                self.branch, self.streams = b, self.stream_sets[1 + b]
                top = self.streams[0]
                top.wait_event(fork)
                with torch.cuda.stream(top):
                    outs.append(fn(x))
                ends.append(torch.cuda.Event())
                ends[-1].record(top)
        finally:
            self.branch, self.streams = None, self.stream_sets[0]
        for end in ends:
            parent.wait_event(end)
        return outs


_FREE_STREAMS: dict = {}    # device → streams of captures that no longer exist


def _streams(device, lib, n: int) -> list:
    """n CUDA streams of `device` that no live capture holds: the
    per-stream state a capture bakes into its graph (cuBLAS's workspace is
    kept per handle and stream) is then no other live graph's, so two
    graphs may replay at the same time.  PyTorch's pool hands out 32
    streams round robin, fewer than S branches need.  Streams of a released
    CapturedStep (_release) are reused before new ones are made."""
    free = _FREE_STREAMS.setdefault(device, [])
    out = [free.pop() for _ in range(min(n, len(free)))]
    while len(out) < n:
        raw = ctypes.c_ulonglong()
        with torch.cuda.device(device):
            _Capture._check("making a stream", lib.flvis_stream_create(ctypes.byref(raw)))
        out.append(torch.cuda.ExternalStream(raw.value, device=device))
    return out


def _release(graph, device, streams) -> None:
    """A CapturedStep's end: its graph freed, its streams free for later
    captures."""
    graph.reset()
    _FREE_STREAMS.setdefault(device, []).extend(streams)


class CapturedStep:
    """The step fn(carry, xs) → (carry', ys) captured once into a CUDA
    graph.  `carry` and `xs` are trees of CUDA tensors: the caller refills
    `xs` before each replay(); each replay moves the step's carry' into
    `carry` and rewrites `ys`.  `branches`: the most `control.branches`
    items the step runs."""

    STREAMS = 4             # the capture's stream and one per nesting depth, per branch
    WARMUP = 2              # eager steps, both branches of every cond, before the capture

    def __init__(self, fn, carry, xs, *, name: str = "step", branches: int = 0):
        leaves = tree_leaves((carry, xs))
        if not leaves or not all(t.is_cuda for t in leaves):
            raise ValueError(f"CapturedStep({name}): the step's inputs must be CUDA tensors")
        from ..ops.kernels import _build

        # fn is kept: the tensors it closes over (a null record, tickets, a
        # camera) are read by the graph and must live as long as it does.
        self.name, self.carry, self.fn = name, carry, fn
        self.device = leaves[0].device
        self.taken = torch.zeros((MAX_SITES * (1 + branches), 2), dtype=torch.int32,
                                 device=self.device)
        lib, _ = _build.load_library()
        with profiling.span("capture", step=name) as sp:
            self._capture(lib, fn, carry, xs, name, branches)
            sp.set(warmup_s=self.seconds["warmup"], capture_s=self.seconds["capture"])
        self.replays = self.settled = 0
        self.body_kernels = self.bodies_run = self.iterations_run = 0
        self.taken_total = np.zeros((len(self.sites), 2), np.int64)     # settled

    def _capture(self, lib, fn, carry, xs, name, branches):
        """The two eager warm-up steps, then the capture (class note)."""
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), both_branches(), _NoHostRead(name):
            for _ in range(self.WARMUP):
                fn(carry, xs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()

        # A dead captured step held by a reference cycle (its fn closes over
        # its system) releases its graph and memory pool when the collector
        # frees it; in the middle of a capture that aborts the process.  So
        # the cycles are collected now, and the collector is off until the
        # capture ends.
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.body_pool = torch.cuda.MemPool()
        streams = _streams(self.device, lib, self.STREAMS * (1 + branches))
        sets = [streams[i:i + self.STREAMS] for i in range(0, len(streams), self.STREAMS)]
        last = _LastOp()
        cap = _Capture(lib, self.taken, sets)
        prev, _MODE.capture = _MODE.capture, cap
        try:
            with torch.cuda.graph(self.graph, stream=sets[0][0]), \
                    torch.cuda.use_mem_pool(self.body_pool, self.device), last:
                new_carry, ys = fn(carry, xs)
                self.ys = _move_carry(carry, new_carry, ys)
        except Exception as e:
            raise RuntimeError(f"capturing {name} into a CUDA graph failed at "
                               f"{last.last_op}: {e}") from e
        finally:
            _MODE.capture = prev
            if gc_on:
                gc.enable()
        census = (ctypes.c_int * len(NODE_KINDS))()
        _Capture._check("the graph census",
                        lib.flvis_graph_census(self.graph.raw_cuda_graph(), census))
        self.graph.instantiate()
        torch.cuda.synchronize(self.device)
        weakref.finalize(self, _release, self.graph, self.device, streams).atexit = False
        self.seconds = {"warmup": t1 - t0, "capture": time.perf_counter() - t1}
        self.sites = cap.sites
        self.top_nodes = dict(zip(NODE_KINDS, census))

    def replay(self):
        self.graph.replay()
        self.replays += 1

    def settle(self, taken) -> dict:
        """Add `taken` (a host copy of the taken counts since the last
        settle, of `self.taken`'s shape) to the node statistics, and zero
        the counts on the card.  An IF site's sides count bodies run; a
        WHILE site's first column its iterations (each one run of its body),
        its second the loop's entries (no body).  Returns what this settle
        added: {bodies_run, iterations_run, body_kernels}."""
        before = (self.bodies_run, self.iterations_run, self.body_kernels)
        for k, site in enumerate(self.sites):
            for side, n in enumerate(taken[site["row"]]):
                n = int(n)
                self.taken_total[k, side] += n
                self.body_kernels += n * site["nodes"][side]["kernel"]
                if site["kind"] == "if":
                    self.bodies_run += n
                elif side == 0:
                    self.iterations_run += n
        self.settled = self.replays
        self.taken.zero_()
        return {"bodies_run": self.bodies_run - before[0],
                "iterations_run": self.iterations_run - before[1],
                "body_kernels": self.body_kernels - before[2]}

    def taken_by_name(self) -> dict:
        """{site name: settled taken counts, summed over the sites of that
        name}: an IF site's (true, false), a WHILE site's (iterations,
        entries)."""
        out = {}
        for site, row in zip(self.sites, self.taken_total.tolist()):
            acc = out.setdefault(site["name"], [0, 0])
            acc[0] += row[0]
            acc[1] += row[1]
        return out

    def node_stats(self):
        """(kernel nodes run, IF bodies run, WHILE iterations run), each per
        replay, over the settled replays."""
        n = max(self.settled, 1)
        return (self.top_nodes["kernel"] + self.body_kernels / n, self.bodies_run / n,
                self.iterations_run / n)


def _assign(dst_tree, src_tree):
    """Copy src_tree's leaves into dst_tree's (one structure), through a
    temporary where a source leaf shares storage with a destination (it
    would change under the copies)."""
    dst = tree_leaves(dst_tree)
    held = {_storage(t) for t in dst}
    src = [s if s is d or _storage(s) not in held else s.clone()
           for d, s in zip(dst, tree_leaves(src_tree))]
    for d, s in zip(dst, src):
        if s is not d:
            d.copy_(s)


def _move_carry(carry, new_carry, ys):
    """Capture the copy of new_carry into the static carry, and return ys
    with no leaf on a carry buffer (such a leaf would change with the copy)."""
    if tree_spec(carry) != tree_spec(new_carry):
        raise ValueError("the step's carry' differs from its carry in structure, shape or "
                         "dtype")
    inputs = {_storage(t) for t in tree_leaves(carry)}
    ys = tree_map(lambda y: y.clone() if _storage(y) in inputs else y, ys)
    _assign(carry, new_carry)
    return ys
