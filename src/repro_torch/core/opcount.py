"""Counting one step of the port as the card would run it: the dry run's
counter (the counterpart of the reference's XLA parsers,
``repro/core/roofline.py::analyze_hlo`` and ``collective_wire_bytes``).

The reference compiles a step and reads XLA's text.  The port has no
compiler to read, so :class:`OpCounter` watches the step run: a
``TorchDispatchMode`` that sees every aten op, collective and kernel launch
of the port's own step, run on ``meta`` tensors (nothing is allocated, no
number is computed) and, for a mesh, as one rank of a fake world
(``launch/mesh.py::init_fake_world``).  Per op it records:

* FLOPs of the matmul class (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``mv``, ``dot``, ``convolution`` and its backward; ``einsum`` and
  ``linear`` reach it as these): 2 x the result's elements x the
  contracted elements, the reference's rule for ``dot``;
* HBM bytes: the operands' and the result's bytes of every op that
  launches work on the device (eager PyTorch runs each op as its own
  kernel, the analogue of the reference's non-fused bytes).  Views,
  metadata and allocation ops count 0; ``copy_`` reads its source and
  writes its destination; fills write their result; an indexed write in
  place (``index_put_``, the caches' writes) reads and writes its values
  and reads its indices, as the reference's ``dynamic-update-slice``;
  collectives count too, as in the reference.  A tensor's bytes are its
  elements' or its storage's, the fewer (an expanded operand is read
  once);
* collective wire bytes by kind (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``) with the
  reference's ring factors (:func:`roofline.wire_bytes`) and the group
  size of the op's process group, and ``count``, the collectives issued,
  of which ``in_loop_count`` were issued inside a layer of the stack
  (while a function marked by :func:`marks_layer` runs, which
  ``nn/blocks.py::block_apply`` is: the forward and the remat recompute;
  and in the backward of a collective issued there, which
  ``parallel/collectives.py``'s autograd pairs run under
  :func:`layer_scope`, as the reference's count of its while body holds
  the scan's backward);
* kernel launches by kernel: a hand-written kernel's wrapper, given meta
  tensors, allocates what its CUDA path allocates and calls
  :func:`record_kernel` with its module's work function where the CUDA
  path launches;
* the live bytes of the meta tensors' storages (each counted from the op
  that made it until it is freed), whose peak gives the record's
  ``memory``.

Ops with no meta tensor among their inputs and outputs run on the host
(the step counter, the learning rate) and are not counted.  A custom op
whose body is plain PyTorch (the flash attention op) is opened: the
counter counts the ops of its body, which is what the card runs.
"""
from __future__ import annotations

import contextlib
import functools
import math
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .roofline import COLL_KINDS, wire_bytes

aten = torch.ops.aten

_ACTIVE: list = []          # the counters in force, innermost last
_OPEN: dict = {}            # custom op -> the Python body the card runs
_LAYER = [0]                # depth of the layers running (marks_layer)


def record_kernel(name: str, flops: float, nbytes: float):
    """One launch of kernel ``name`` doing ``flops`` operations over
    ``nbytes`` bytes, on every counter in force: the meta branch of a
    kernel's wrapper calls it where its CUDA path launches."""
    for c in _ACTIVE:
        c.launches[name] += 1
        c.flops += flops
        c.hbm_bytes += nbytes
        c.kernel_flops[name] += flops
        c.kernel_bytes[name] += nbytes


def counting() -> bool:
    """Whether a counter is in force."""
    return bool(_ACTIVE)


def open_op(op, body):
    """Have the counter count the ops of ``body`` (called with the op's
    arguments) in place of custom op ``op``."""
    _OPEN[op] = body


# ops that launch nothing: views, metadata, allocation, waits
_FREE = {
    aten.detach.default, aten.alias.default, aten.lift_fresh.default,
    aten._unsafe_view.default, aten.empty.memory_format,
    aten.empty_strided.default, aten.empty_like.default,
    aten.new_empty.default, aten.new_empty_strided.default,
    aten.set_.source_Storage_storage_offset, aten.resize_.default,
    aten._local_scalar_dense.default, aten.sym_size.int,
    aten.sym_stride.int, aten.sym_numel.default,
    aten.sym_storage_offset.default, aten.is_same_size.default,
}
_FILLS = {aten.fill_.Scalar, aten.fill_.Tensor, aten.zero_.default,
          aten.zeros.default, aten.ones.default, aten.full.default,
          aten.zeros_like.default, aten.ones_like.default,
          aten.full_like.default, aten.scalar_tensor.default,
          aten.arange.default, aten.arange.start,
          aten.arange.start_step}
# indexed writes in place: (index of the values argument)
_SCATTERS = {aten.index_put_.default: 2, aten._index_put_impl_.default: 2,
             aten.index_copy_.default: 3, aten.scatter_.src: 3,
             aten.scatter_add_.default: 3, aten.index_add_.default: 3}

# collectives by schema name: c10d's eager process-group ops (the group a
# ScriptObject argument) and the functional ones DTensor issues (the
# group's name their last argument)
_COLLECTIVES = {
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::send": "collective-permute",
    "c10d::recv_": "collective-permute",
    "c10d::broadcast_": "collective-permute",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_c10d_functional::broadcast": "collective-permute",
}


def _tensors(tree, out=None) -> list:
    """The tensors of an op's arguments or results (nested tuples, lists
    and dicts), in order."""
    if out is None:
        out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _tensors(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    return out


_COMPOSITE: dict = {}
# (op, its arguments' shapes, strides, dtypes and values) -> its outputs'
# (shape, stride, dtype): a meta op's result depends on nothing else, and
# PyTorch's meta kernels are mostly Python, the bulk of a count's time
_META_CACHE: dict = {}
_UNCACHED: set = set()
_HASHABLE = (int, float, bool, str, type(None), torch.dtype, torch.device,
             torch.layout, torch.memory_format)


def _arg_key(a):
    if isinstance(a, torch.Tensor):
        if a.device.type != "meta":
            raise TypeError
        return (tuple(a.shape), a.stride(), a.dtype, a.storage_offset())
    if isinstance(a, (list, tuple)):
        return tuple(_arg_key(v) for v in a)
    if isinstance(a, _HASHABLE):
        return (type(a), a)
    raise TypeError


def _cacheable(func) -> bool:
    """A functional op whose outputs are new tensors (no view, no
    mutation, no alias, no collective)."""
    if func in _UNCACHED:
        return False
    s = func._schema
    ok = (not func.is_view and not s.is_mutable
          and func.namespace == "aten"
          and all(r.alias_info is None for r in s.returns)
          and all(str(r.type) == "Tensor" for r in s.returns)
          and len(s.returns) > 0)
    if not ok:
        _UNCACHED.add(func)
    return ok


def _run_meta(func, args, kwargs):
    """``func`` on meta arguments, its outputs rebuilt from the cache when
    it has run on arguments of the same metadata before."""
    if not _cacheable(func):
        return func(*args, **kwargs)
    try:
        key = (func, _arg_key(args), _arg_key(tuple(sorted(kwargs.items()))))
    except TypeError:
        return func(*args, **kwargs)
    meta = _META_CACHE.get(key)
    if meta is None:
        out = func(*args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        if all(isinstance(t, torch.Tensor) and t.device.type == "meta"
               for t in outs):
            _META_CACHE[key] = (isinstance(out, tuple), [
                (tuple(t.shape), t.stride(), t.dtype) for t in outs])
        return out
    many, descr = meta
    outs = tuple(torch.empty_strided(shape, stride, dtype=dtype,
                                     device="meta")
                 for shape, stride, dtype in descr)
    return outs if many else outs[0]


def _composite(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd kernel (cached)."""
    c = _COMPOSITE.get(func)
    if c is None:
        c = _COMPOSITE[func] = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), "CompositeImplicitAutograd")
    return c


def _blocks(tree) -> list:
    """The tensors of ``tree``, a DTensor as this rank's block."""
    return [getattr(t, "_local_tensor", t) for t in _tensors(tree)]


def nbytes(t: torch.Tensor) -> int:
    """The bytes an op moves for ``t``: its elements', or its storage's
    where fewer (an expanded tensor)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def _matmul_flops(func, args, out) -> float:
    """2 x result elements x contracted elements of a matmul-class op;
    0 for any other op."""
    p = func.overloadpacket
    if p in (aten.mm, aten.bmm, aten.mv):
        return 2.0 * out.numel() * args[0].shape[-1]
    if p in (aten.addmm, aten.baddbmm, aten.addmv):
        return 2.0 * out.numel() * args[1].shape[-1]
    if p in (aten.dot, aten.vdot):
        return 2.0 * args[0].numel()
    if p is aten.convolution:
        x, w, transposed = args[0], args[1], args[6]
        return 2.0 * (x if transposed else out).numel() * math.prod(
            w.shape[1:])
    if p is aten.convolution_backward:
        gy, x, w, transposed, mask = args[0], args[1], args[2], args[7], \
            args[10]
        fwd = 2.0 * (x if transposed else gy).numel() * math.prod(
            w.shape[1:])
        return fwd * (int(mask[0]) + int(mask[1]))
    return 0.0


def _group_size(func, args, kwargs) -> int:
    """The size of the process group a collective runs over."""
    if func.namespace == "_c10d_functional":
        from torch.distributed.distributed_c10d import \
            _resolve_process_group
        return _resolve_process_group(kwargs.get("group_name",
                                                 args[-1])).size()
    import torch.distributed as dist
    group = next(a for a in args if isinstance(a, torch.ScriptObject))
    return dist.ProcessGroup.unbox(group).size()


def marks_layer(fn):
    """Marks ``fn`` as a layer of the stack (``nn/blocks.py::block_apply``):
    the collectives a counter sees while it runs count in
    ``in_loop_count``.  A plain call when no counter is in force."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        if not _ACTIVE:
            return fn(*args, **kwargs)
        _LAYER[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _LAYER[0] -= 1
    return run


def in_layer() -> bool:
    """Whether a layer marked by :func:`marks_layer` is running under a
    counter."""
    return bool(_LAYER[0])


@contextlib.contextmanager
def layer_scope(inside: bool):
    """Count the collectives issued within as a layer's where ``inside``
    (the backward of a collective whose forward :func:`in_layer` saw)."""
    if not (inside and _ACTIVE):
        yield
        return
    _LAYER[0] += 1
    try:
        yield
    finally:
        _LAYER[0] -= 1


class OpCounter(TorchDispatchMode):
    """Counts what runs on the device while it is in force (``with
    OpCounter() as c:``): ``flops``, ``hbm_bytes``, ``coll`` (wire bytes
    by kind, ``count``, ``in_loop_count``), ``launches`` by kernel,
    ``ops`` counted, and the live bytes of meta storages (``peak``).
    :meth:`arguments` registers the step's inputs before it runs;
    :meth:`memory` gives the reference's memory keys after.  With
    ``keep_ops`` it keeps a table by op: calls, FLOPs and bytes."""

    def __init__(self, *, keep_ops: bool = False):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll = {k: 0.0 for k in COLL_KINDS}
        self.coll.update(count=0, in_loop_count=0)
        self.launches: Counter = Counter()
        self.kernel_flops: Counter = Counter()
        self.kernel_bytes: Counter = Counter()
        self.ops = 0
        self.by_op = {} if keep_ops else None
        self.live = 0
        self.peak = 0
        self._storages: dict = {}       # id -> bytes, while alive
        self._arguments: set = set()
        self._memo: dict = {}           # opened op calls already counted

    # -- live bytes ----------------------------------------------------------
    def _track(self, t: torch.Tensor) -> int | None:
        """Start counting ``t``'s storage if it is new; its id."""
        if t.device.type != "meta":
            return None
        st = t.untyped_storage()
        key = id(st)
        if key not in self._storages:
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return key

    def _free(self, key):
        self.live -= self._storages.pop(key, 0)
        self._arguments.discard(key)

    def arguments(self, *trees):
        """Register the step's inputs (state, params, batch, caches): their
        storages are live from the start and make ``argument_size``."""
        for t in _blocks(trees):
            key = self._track(t)
            if key is not None:
                self._arguments.add(key)
        self.argument_size = sum(self._storages[k] for k in self._arguments)

    def memory(self, *outputs) -> dict:
        """The reference's ``memory`` keys for the step run so far:
        ``argument_size`` (the inputs registered), ``output_size`` (the
        storages of ``outputs``), ``alias_size`` (those of them that are
        inputs, updated in place), ``temp_size`` (the peak over the
        inputs) and ``generated_code_size`` (0: nothing is compiled)."""
        seen, out, alias = set(), 0, 0
        for t in _blocks(outputs):
            if t.device.type != "meta":
                continue
            st = t.untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            out += st.nbytes()
            if id(st) in self._arguments:
                alias += st.nbytes()
        args = getattr(self, "argument_size", 0)
        return {"argument_size": args, "output_size": out,
                "temp_size": max(self.peak - args, 0), "alias_size": alias,
                "generated_code_size": 0}

    # -- opened ops -----------------------------------------------------------
    def _totals(self):
        return (self.flops, self.hbm_bytes, self.ops, dict(self.coll),
                Counter(self.launches), Counter(self.kernel_flops),
                Counter(self.kernel_bytes),
                None if self.by_op is None else
                {k: list(v) for k, v in self.by_op.items()})

    def _opened(self, func, body, args, kwargs):
        """Count the ops of ``body`` in place of ``func``.  A call whose
        arguments have the metadata of one counted before (the same op in
        every layer) adds that call's counts and transient peak again
        without running it: on meta tensors nothing else can differ."""
        try:
            key = (func, _arg_key(args), _arg_key(tuple(sorted(
                kwargs.items()))))
        except TypeError:
            key = None
        memo = self._memo.get(key) if key is not None else None
        if memo is None:
            before, live0, peak0 = self._totals(), self.live, self.peak
            self.peak = live0
            with self:
                out = body(*args, **kwargs)
            transient, self.peak = self.peak - live0, max(peak0, self.peak)
            after = self._totals()
            outs = out if isinstance(out, tuple) else (out,)
            if key is not None and all(isinstance(t, torch.Tensor)
                                       for t in outs):
                self._memo[key] = (before, after, transient,
                                   isinstance(out, tuple),
                                   [(tuple(t.shape), t.stride(), t.dtype)
                                    for t in outs])
            return out
        before, after, transient, many, descr = memo
        self.peak = max(self.peak, self.live + transient)
        self.flops += after[0] - before[0]
        self.hbm_bytes += after[1] - before[1]
        self.ops += after[2] - before[2]
        for k in self.coll:
            self.coll[k] += after[3][k] - before[3][k]
        for mine, a, b in zip((self.launches, self.kernel_flops,
                               self.kernel_bytes), after[4:7], before[4:7]):
            mine.update(a - b)
        if self.by_op is not None:
            for k, row in after[7].items():
                old = before[7].get(k, [0, 0.0, 0.0])
                mrow = self.by_op.setdefault(k, [0, 0.0, 0.0])
                for i in range(3):
                    mrow[i] += row[i] - old[i]
        outs = tuple(torch.empty_strided(shape, stride, dtype=dtype,
                                         device="meta")
                     for shape, stride, dtype in descr)
        for t in outs:
            self._track(t)
        return outs if many else outs[0]

    # -- the mode ------------------------------------------------------------
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor for t in types):
            return NotImplemented      # a subclass (DTensor) unwraps first
        body = _OPEN.get(func)
        if body is not None:
            return self._opened(func, body, args, kwargs)
        if _composite(func):
            # an opened body runs below autograd, where composite ops
            # (einsum, matmul, linear) reach the mode whole: count the
            # ops they are made of
            with self:
                return func.decompose(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if ins and all(t.device.type == "meta" for t in ins):
            out = _run_meta(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        if not any(t.device.type == "meta" for t in ins + outs):
            return out
        for t in outs:
            self._track(t)
        if func in _FREE or func.is_view or \
                func.namespace == "_c10d_functional" and \
                func._schema.name.endswith(("wait_tensor",
                                            "_wrap_tensor_autograd")):
            return out
        self.ops += 1
        flops = _matmul_flops(func, args, out) if outs else 0.0
        if func in _FILLS:
            moved = sum(nbytes(t) for t in outs)
        elif func.overloadpacket is aten.copy_:
            moved = nbytes(args[0]) + nbytes(args[1])
        elif func in _SCATTERS:
            vals = args[_SCATTERS[func]]
            idx = _tensors(args[1:_SCATTERS[func]])
            moved = 2 * nbytes(vals) + sum(nbytes(t) for t in idx)
        else:
            moved = sum(nbytes(t) for t in ins) + sum(nbytes(t)
                                                      for t in outs)
        kind = _COLLECTIVES.get(func._schema.name)
        if kind is not None:
            g = _group_size(func, args, kwargs)
            # R: the result's bytes (an all-reduce's or a send's: its
            # tensors')
            result = sum(nbytes(t) for t in (
                ins if kind in ("all-reduce", "collective-permute")
                else outs))
            self.coll[kind] += wire_bytes(kind, result, g)
            self.coll["count"] += 1
            if _LAYER[0]:
                self.coll["in_loop_count"] += 1
        self.flops += flops
        self.hbm_bytes += moved
        if self.by_op is not None:
            row = self.by_op.setdefault(str(func), [0, 0.0, 0.0])
            row[0] += 1
            row[1] += flops
            row[2] += moved
        return out
