"""Branches taken on the device: `cond`, the counterpart of jax.lax.cond,
and `CapturedStep`, a step function captured once into a CUDA graph and
replayed — the port's form of the reference's one device program per
chunk (lax.scan over frames with lax.cond inside,
flvis_tpu/pipeline/runner.py:104-170).

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

CapturedStep(fn, carry, xs) runs the step fn(carry, xs) → (carry', ys)
twice eagerly with both branches of every cond (so every kernel library,
cuBLAS handle and allocator pool the capture meets exists), refusing any
host read or host↔device copy there with an error naming the operation
(the predicates' own reads apart), then captures
it, with the copy of carry' into the static `carry`, into a
torch.cuda.CUDAGraph.  The caller copies each step's inputs into the
static `xs` before replay().
Memory the IF bodies allocate comes from a MemPool of the step (the bodies
are separate captures, outside the graph's own pool).  A failure during the
capture raises, naming the last operation dispatched; nothing falls back to
eager execution.

The graph's node census (`top_nodes`, each IF body's in `sites`) and the
conds' taken counts on the card (`taken`, fetched by the caller with its
other outputs and handed to `settle`) give the kernel nodes a replay ran.
A replay runs no Python, so the kernel wrappers' launch counters
(`fn.launches`) count the warm-up's launches and the capture's calls,
never a replay's: a replay's launches are read from the device (a
profile of the replays, as chip_smoke.py does).
"""

from __future__ import annotations

import contextlib
import ctypes
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .tree import tree_leaves, tree_map, tree_spec

MAX_SITES = 128         # conds a captured step may hold (taken counts are preallocated)
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
    reading_pred = False    # a cond reads its predicate (allowed under _NoHostRead)


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
        _MODE.reading_pred = True
        try:
            return outs[0] if bool(pred) else outs[1]
        finally:
            _MODE.reading_pred = False
    return (true_fn if bool(pred) else false_fn)(*operands)


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
    """One capture under way: emits the IF nodes of each cond and keeps
    each body's node census."""

    def __init__(self, lib, taken, streams):
        self.lib, self.taken, self.streams = lib, taken, streams
        self.sites = []         # per cond: name, depth, per side (true, false) its nodes
        self.depth = 0

    @staticmethod
    def _check(what, err):
        if err != 0:
            raise RuntimeError(f"cond capture: {what} failed with cudaError_t {err}")

    def cond(self, pred, true_fn, false_fn, operands, name):
        k = len(self.sites)
        if k >= MAX_SITES:
            raise RuntimeError(f"cond capture: more than {MAX_SITES} conds in one step")
        if self.depth + 1 >= len(self.streams):
            raise RuntimeError(f"cond capture: conds nested deeper than {len(self.streams) - 1}")
        site = {"name": name, "depth": self.depth, "nodes": [None, None]}
        self.sites.append(site)
        parent = torch.cuda.current_stream()
        handles = (ctypes.c_ulonglong * 2)()
        self._check("opening a cond", self.lib.flvis_cond_open(
            parent.cuda_stream, pred.data_ptr(), self.taken[k].data_ptr(), handles))
        body = self.streams[self.depth + 1]
        result = None
        for side, fn in enumerate((true_fn, false_fn)):
            self._check("an IF node", self.lib.flvis_cond_body_begin(
                parent.cuda_stream, handles[side], body.cuda_stream))
            self.depth += 1
            counts = (ctypes.c_int * len(NODE_KINDS))()
            try:
                with torch.cuda.stream(body):
                    out = fn(*operands)
                    if side == 0:
                        # Buffers of the cond's own, which the false side
                        # overwrites without touching anything else.
                        result = tree_map(torch.clone, out)
                    else:
                        _check_trees([tree_spec(result), tree_spec(out)])
                        for dst, src in zip(tree_leaves(result), tree_leaves(out)):
                            dst.copy_(src)
            finally:
                self.depth -= 1
                end = self.lib.flvis_cond_body_end(body.cuda_stream, counts)
            self._check("ending an IF body", end)
            site["nodes"][side] = dict(zip(NODE_KINDS, counts))
        return result


class CapturedStep:
    """The step fn(carry, xs) → (carry', ys) captured once into a CUDA
    graph.  `carry` and `xs` are trees of CUDA tensors: the caller refills
    `xs` before each replay(); each replay moves the step's carry' into
    `carry` and rewrites `ys`."""

    STREAMS = 4             # the capture's stream and one per IF nesting depth
    WARMUP = 2              # eager steps, both branches of every cond, before the capture

    def __init__(self, fn, carry, xs, *, name: str = "step"):
        leaves = tree_leaves((carry, xs))
        if not leaves or not all(t.is_cuda for t in leaves):
            raise ValueError(f"CapturedStep({name}): the step's inputs must be CUDA tensors")
        from ..ops.kernels import _build

        self.name, self.carry = name, carry
        self.device = leaves[0].device
        self.taken = torch.zeros((MAX_SITES, 2), dtype=torch.int32, device=self.device)
        lib, _ = _build.load_library()
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), both_branches(), _NoHostRead(name):
            for _ in range(self.WARMUP):
                fn(carry, xs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()

        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.body_pool = torch.cuda.MemPool()
        streams = [torch.cuda.Stream(self.device) for _ in range(self.STREAMS)]
        last = _LastOp()
        cap = _Capture(lib, self.taken, streams)
        prev, _MODE.capture = _MODE.capture, cap
        try:
            with torch.cuda.graph(self.graph, stream=streams[0]), \
                    torch.cuda.use_mem_pool(self.body_pool, self.device), last:
                new_carry, ys = fn(carry, xs)
                self.ys = _move_carry(carry, new_carry, ys)
        except Exception as e:
            raise RuntimeError(f"capturing {name} into a CUDA graph failed at "
                               f"{last.last_op}: {e}") from e
        finally:
            _MODE.capture = prev
        census = (ctypes.c_int * len(NODE_KINDS))()
        _Capture._check("the graph census",
                        lib.flvis_graph_census(self.graph.raw_cuda_graph(), census))
        self.graph.instantiate()
        torch.cuda.synchronize(self.device)
        self.seconds = {"warmup": t1 - t0, "capture": time.perf_counter() - t1}
        self.sites = cap.sites
        self.top_nodes = dict(zip(NODE_KINDS, census))
        self.replays = self.settled = 0
        self.body_kernels = self.bodies_run = 0
        self.taken_total = np.zeros((len(self.sites), 2), np.int64)     # settled

    def replay(self):
        self.graph.replay()
        self.replays += 1

    def settle(self, taken):
        """Add `taken` (a host copy of the taken counts since the last
        settle: (MAX_SITES, 2)) to the node statistics, and zero the counts
        on the card."""
        for k, (site, row) in enumerate(zip(self.sites, taken)):
            for side, n in enumerate(row):
                n = int(n)
                self.taken_total[k, side] += n
                self.body_kernels += n * site["nodes"][side]["kernel"]
                self.bodies_run += n
        self.settled = self.replays
        self.taken.zero_()

    def taken_by_name(self) -> dict:
        """{cond name: settled (true, false) taken counts, summed over the
        conds of that name}."""
        out = {}
        for site, row in zip(self.sites, self.taken_total.tolist()):
            acc = out.setdefault(site["name"], [0, 0])
            acc[0] += row[0]
            acc[1] += row[1]
        return out

    def node_stats(self):
        """(kernel nodes run, IF bodies run), each per replay, over the
        settled replays."""
        n = max(self.settled, 1)
        return (self.top_nodes["kernel"] + self.body_kernels / n, self.bodies_run / n)


def _move_carry(carry, new_carry, ys):
    """Capture the copy of new_carry into the static carry, and return ys
    with no leaf on a carry buffer (such a leaf would change with the copy)."""
    if tree_spec(carry) != tree_spec(new_carry):
        raise ValueError("the step's carry' differs from its carry in structure, shape or "
                         "dtype")
    dst = tree_leaves(carry)
    inputs = {_storage(t) for t in dst}
    src = [s if s is d or _storage(s) not in inputs else s.clone()
           for d, s in zip(dst, tree_leaves(new_carry))]
    for d, s in zip(dst, src):
        if s is not d:
            d.copy_(s)
    return tree_map(lambda y: y.clone() if _storage(y) in inputs else y, ys)
