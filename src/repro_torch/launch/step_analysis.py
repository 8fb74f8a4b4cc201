"""Step analysis for the roofline report, the counterpart of the reference's
``launch/hlo_analysis.py``.

The reference reads the per-device HLO of a compiled step. The port has no
compiler to ask, and it runs eagerly, so this module watches the step run:
``StepAnalysis`` is a ``TorchDispatchMode`` under which the cell's step
runs once on meta tensors (``launch/input_specs.py``), every op dispatched
for its shapes alone, nothing allocated on a device. It fills the fields of
the reference's ``HloReport`` that it can fill honestly:

- **matmul FLOPs** (``dot_flops``, ``dot_count``): 2·|result|·|contract| of
  every ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` (``matmul``, ``einsum``
  and ``linear`` decompose into them before they reach the mode), forward
  and backward alike. Causal attention counts its whole score matrix, as
  the plain versions compute it;
- **memory traffic** (``bytes_written``): the result bytes of every op that
  writes memory. Views write nothing; an in-place op writes its target, an
  indexed write (``index_put_``, ``scatter_`` ...) the values it writes; an
  ``empty`` writes nothing. The port runs eagerly, so every other op
  writes its result to memory. ``bytes_accessed`` is twice that, the
  reference's write-once / read-once convention;
- **kernel regions**: a kernel wrapper given meta tensors runs its plain
  version inside ``kernels._meta.kernel_region`` (the counterpart of the
  reference's ``flash_tile`` / ``ssd_tile`` / ``mlstm_tile`` scopes). The
  FLOPs of its matmuls are ``kernel_region_flops`` (and count in
  ``dot_flops`` too); the bytes its intermediates write are
  ``kernel_region_bytes``, which the kernel keeps on chip, so
  ``bytes_accessed_fused`` leaves them out. What a region returns is what
  the kernel writes, and counts as ordinary traffic;
- **collectives** (``collective_wire_bytes``, ``collective_by_op``,
  ``collective_count``): every ``c10d`` operation the step dispatches (the
  data-parallel gradient all-reduce, ring attention's hops and gathers,
  the sharded step's weight all-gathers over "data" and their gradients'
  reduce-scatters, its tensor-parallel all-reduces over "model", the MoE
  router's all-gather over "model" (``gather_repeated``: no collective in
  its backward), the aux losses' token sums all-reduced over "data" in
  both directions (``all_reduce``), the int8 moments' gradient gathers,
  and the Zamba2 and xLSTM blocks' over "model": Mamba2's fused
  projection and conv weights gathered whole (their gradients
  reduce-scattered), its gated activation all-gathered for the norm over
  whole rows (``take_block``'s backward all-gathers the gradient), the
  norms' weights gathered, the mLSTM's and the output projections'
  partial sums all-reduced, the sLSTM's output all-gathered once a use),
  under the reference's ring conventions for a group of g ranks:
  all-gather and all-to-all |result|·(g-1)/g, all-reduce
  2·|result|·(g-1)/g, reduce-scatter |result|·(g-1), a point-to-point send
  (the reference's collective-permute) |result|. Under a fake process group
  (``launch/dryrun.py``) they move no data;
- **peak live bytes** (``peak_live_bytes``, the counterpart of XLA's
  ``temp_size_in_bytes``): every storage the step allocates is tracked
  until it is freed (a weak reference on it). A kernel region's
  intermediates are left out, as the kernel holds them on chip; its
  outputs count from the region's end.

The reference's ``while_trips`` has no counterpart: it recovers the trip
counts of XLA's loops over the stacked layers, while the port runs its
layers (and the sLSTM's time steps) as a Python loop, so the trace sees
every layer and every step. All numbers are per device: the traced
program is one rank's.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import _meta

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

aten = torch.ops.aten

#: matmul ops -> the position of their left operand, whose last dim is the
#: contracted one
_DOTS = {aten.mm.default: 0, aten.bmm.default: 0, aten.addmm.default: 1,
         aten.baddbmm.default: 1, aten.mv.default: 0, aten.dot.default: 0}

#: ops that allocate without writing
_ALLOC_ONLY = {aten.empty.memory_format, aten.empty_like.default,
               aten.empty_strided.default, aten.new_empty.default,
               aten.new_empty_strided.default}

#: indexed writes: the argument whose bytes the op writes
_INDEXED = {"index_put_": 2, "_index_put_impl_": 2, "index_copy_": 3,
            "scatter_": 3, "scatter_add_": 3, "index_add_": 3,
            "masked_scatter_": 2}

#: c10d op -> the reference's name of the collective
_C10D = {"allreduce_": "all-reduce", "allgather_": "all-gather",
         "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "send": "collective-permute"}


@dataclass
class StepReport:
    dot_flops: float = 0.0
    dot_count: int = 0
    kernel_region_flops: float = 0.0
    bytes_written: float = 0.0
    kernel_region_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_by_op: dict = field(
        default_factory=lambda: {op: 0.0 for op in COLLECTIVE_OPS})
    collective_count: int = 0
    peak_live_bytes: int = 0
    #: kernel regions entered, by kernel name
    kernel_regions: dict = field(default_factory=dict)
    #: device types of every tensor an op took or returned
    devices: set = field(default_factory=set)
    ops: int = 0

    @property
    def bytes_accessed(self) -> float:
        return 2.0 * self.bytes_written  # write-once / read-once convention

    @property
    def bytes_accessed_fused(self) -> float:
        """Traffic when the kernel regions' intermediates stay on chip."""
        return 2.0 * (self.bytes_written - self.kernel_region_bytes)


def _flat_tensors(x, out):
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat_tensors(y, out)
    return out


def tree_tensors(tree) -> list:
    """Every tensor of a nested dict / list / tuple / NamedTuple, the
    optimizer's ``QTensor`` moments (``q``, ``scale``) included."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_tensors(v)]
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return [tree.q, tree.scale]
    return []


def _group_size(pg) -> int:
    """The ranks of a process group as a c10d op receives it (boxed)."""
    from torch._C._distributed_c10d import ProcessGroup
    if not isinstance(pg, ProcessGroup):
        pg = ProcessGroup.unbox(pg)
    return pg.size()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _arg(args, kwargs, i: int, name: str):
    return args[i] if i < len(args) else kwargs.get(name)


class _OpInfo:
    """What the mode needs of an op's schema, computed once an op."""
    __slots__ = ("is_view", "writes", "fresh", "indexed", "dot", "c10d",
                 "group")

    def __init__(self, func):
        schema = func._schema
        self.is_view = func.is_view
        # (position, name) of every argument the op writes in place
        self.writes = [(i, a.name) for i, a in enumerate(schema.arguments)
                       if a.alias_info is not None and a.alias_info.is_write]
        # returns that alias no argument are fresh storages
        self.fresh = [r.alias_info is None for r in schema.returns]
        name = func.__name__.split(".")[0]
        self.indexed = _INDEXED.get(name)
        if self.indexed is not None:
            self.indexed = (self.indexed, schema.arguments[self.indexed].name)
        self.dot = _DOTS.get(func)
        self.c10d = (_C10D.get(name) if func.namespace == "c10d"
                     else None)
        names = [a.name for a in schema.arguments]
        self.group = (names.index("process_group")
                      if "process_group" in names else None)
        if func.namespace == "c10d":
            self.writes, self.fresh = [], []


class StepAnalysis(TorchDispatchMode):
    """Counts one step's ops (module docstring). ``held``: the tensors the
    step's caller holds (its arguments); their storages are not the step's
    allocations. After the ``with`` block, ``report`` holds the counts and
    ``finish(outputs)`` the memory split."""

    def __init__(self, held=()):
        super().__init__()
        self.report = StepReport()
        self._held = {id(t.untyped_storage()) for t in held}
        self._held_refs = [t.untyped_storage() for t in held]
        self._live = {}          # id(storage) -> (weakref, bytes)
        self._region_allocs = {}  # allocations inside the open region
        self._live_bytes = 0
        self._depth = 0
        self._info = {}

    # -- kernel regions (kernels._meta's listener) ---------------------------
    def __enter__(self):
        _meta.listeners.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _meta.listeners.remove(self)
        return super().__exit__(*exc)

    def region_enter(self, name):
        self._depth += 1
        if self._depth == 1:
            r = self.report.kernel_regions
            r[name] = r.get(name, 0) + 1

    def region_exit(self, name):
        self._depth -= 1
        if self._depth:
            return
        # what is still alive is what the region returns: the kernel writes
        # it, and it is live from here on
        for key, (ref, nbytes) in list(self._region_allocs.items()):
            if ref() is None:
                continue
            self.report.kernel_region_bytes -= nbytes
            self._track(ref(), key, nbytes)
        self._region_allocs.clear()

    # -- memory -------------------------------------------------------------
    def _freed(self, key, nbytes, _ref):
        if self._live.pop(key, None) is not None:
            self._live_bytes -= nbytes
        else:
            self._region_allocs.pop(key, None)

    def _track(self, st, key, nbytes):
        ref = weakref.ref(st, lambda r, k=key, n=nbytes: self._freed(k, n, r))
        self._live[key] = (ref, nbytes)
        self._live_bytes += nbytes
        if self._live_bytes > self.report.peak_live_bytes:
            self.report.peak_live_bytes = self._live_bytes

    def _allocated(self, t):
        st = t.untyped_storage()
        key = id(st)
        if key in self._held or key in self._live \
                or key in self._region_allocs:
            return
        nbytes = st.nbytes()
        if self._depth:
            ref = weakref.ref(st, lambda r, k=key, n=nbytes:
                              self._freed(k, n, r))
            self._region_allocs[key] = (ref, nbytes)
        else:
            self._track(st, key, nbytes)

    def _written(self, nbytes):
        self.report.bytes_written += nbytes
        if self._depth:
            self.report.kernel_region_bytes += nbytes

    # -- dispatch -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = _OpInfo(func)
        rep = self.report
        rep.ops += 1
        for t in _flat_tensors(args, _flat_tensors(out, [])):
            rep.devices.add(t.device.type)
        if info.c10d:
            self._collective(info.c10d, args[info.group], args[0])
            return out
        if info.dot is not None:
            a = args[info.dot]
            flops = 2.0 * _flat_tensors(out, [])[0].numel() * a.shape[-1]
            rep.dot_flops += flops
            rep.dot_count += 1
            if self._depth:
                rep.kernel_region_flops += flops
        if info.is_view:
            return out
        if info.indexed is not None:
            for t in _flat_tensors(_arg(args, kwargs, *info.indexed), []):
                self._written(_nbytes(t))
        else:
            for i, name in info.writes:
                for t in _flat_tensors(_arg(args, kwargs, i, name), []):
                    self._written(_nbytes(t))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for fresh, o in zip(info.fresh, outs):
            if not fresh:
                continue
            for t in _flat_tensors(o, []):
                self._allocated(t)
                if func not in _ALLOC_ONLY:
                    self._written(_nbytes(t))
        return out

    def _collective(self, op, group, result):
        """One c10d op of ``group``; ``result``: its first argument, the
        gathered output of an all-gather, the output of the others."""
        rep = self.report
        g = max(_group_size(group), 1)
        res = sum(_nbytes(t) for t in _flat_tensors(result, []))
        if op == "all-reduce":
            wire = 2.0 * res * (g - 1) / g
        elif op in ("all-gather", "all-to-all"):
            wire = res * (g - 1) / g
        elif op == "reduce-scatter":
            wire = float(res * (g - 1))
        else:
            wire = float(res)
        rep.collective_wire_bytes += wire
        rep.collective_by_op[op] += wire
        rep.collective_count += 1

    # -- the memory split ---------------------------------------------------
    def finish(self, outputs) -> dict:
        """The reference's memory fields for a step that returned
        ``outputs``: ``argument_bytes`` (``held``), ``output_bytes`` (the
        outputs' storages), ``alias_bytes`` (those of them that are
        arguments, updated in place), ``temp_bytes`` (the peak of live
        allocations less the new outputs) and ``per_device_total`` =
        temp + argument + output - alias, as the reference sums them."""
        out_st = {}
        for t in tree_tensors(outputs):
            st = t.untyped_storage()
            out_st[id(st)] = st.nbytes()
        output = sum(out_st.values())
        alias = sum(n for k, n in out_st.items() if k in self._held)
        argument = sum({id(s): s.nbytes() for s in self._held_refs}.values())
        temp = max(self.report.peak_live_bytes - (output - alias), 0)
        return {"argument_bytes": argument, "output_bytes": output,
                "temp_bytes": temp, "alias_bytes": alias,
                "per_device_total": temp + argument + output - alias}


def analyze_step(step, args):
    """Run ``step(*args)`` once under ``StepAnalysis`` -> (its outputs, the
    report, the memory split of ``StepAnalysis.finish``)."""
    held = tree_tensors(args)
    with StepAnalysis(held) as mode:
        out = step(*args)
    return out, mode.report, mode.finish(out)


__all__ = ["COLLECTIVE_OPS", "StepAnalysis", "StepReport", "analyze_step",
           "tree_tensors"]
