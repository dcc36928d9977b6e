"""Count what a traced step does, op by op: the port's `hlo_stats`.

The JAX package counts a compiled HLO module (`repro.launch.hlo_stats`),
multiplying loop bodies by their trip counts. The port runs eagerly, so
every loop runs and is seen op by op: `OpCounter` is a
`TorchDispatchMode` that counts, for each aten op it sees,

  flops  from `torch.utils.flop_counter`'s registry (mm, bmm, addmm,
         baddbmm, convolution, SDPA), decomposing what it does not know
         exactly as `FlopCounterMode` does, so the two agree on any run;
  bytes  one HBM read of each distinct element of the op's non-scalar
         inputs (a broadcast dim once) and one write of its outputs: the
         eager program's traffic, with zero-traffic ops left out (views
         and aliases, `detach`, `_unsafe_view`, allocations that write
         nothing: `empty*`). A gather (`index`, `gather`, ...) reads the
         rows it returns, not its whole source; an in-place scatter
         (`index_put_`, `index_copy_`, ...) reads its values and indices
         and writes the values' rows; another in-place op writes its
         target, and reads it too unless it overwrites (`copy_`,
         `fill_`, `zero_`);
  calls  per op name;

plus one entry per hand-kernel call (`kernel_calls`), with that
kernel's own flops and bytes (`kernels/cost.py`), and the peak of live
bytes over the trace (`peak_bytes`: storages the traced ops allocate,
each counted from the op that makes it until its last tensor dies).

`fake_cuda()` is the trace's setting: a `FakeTensorMode` whose tensors
say `cuda` and hold no storage, so the port's code takes the card's
route (the kernel wrappers' shape-only route) and nothing touches a
device. A few Python bindings of `Tensor` (indexing, `copy_`,
`contiguous`) set a CUDA device guard before they dispatch, which a
PyTorch built without CUDA cannot give; inside `fake_cuda()` they are
expressed as the aten ops they dispatch to, for fake tensors only.
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from collections import Counter
from typing import Any, Dict, Iterator

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost

aten = torch.ops.aten

# ops that move no bytes of their own, beyond views (schema aliases)
_ZERO_TRAFFIC = {aten.detach, aten._unsafe_view, aten.alias, aten.lift_fresh,
                 aten.empty, aten.empty_like, aten.empty_strided,
                 aten.new_empty, aten.new_empty_strided}
# queries that FlopCounterMode also passes by
_METADATA = {aten.is_contiguous, aten.sym_is_contiguous,
             aten.is_strides_like_format, aten.is_non_overlapping_and_dense,
             aten.size, aten.sym_size, aten.stride, aten.sym_stride,
             aten.storage_offset, aten.sym_storage_offset, aten.numel,
             aten.sym_numel, aten.dim, torch.ops.prim.layout,
             torch.ops.prim.device}


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


# ops that read only the rows they return (plus their indices)
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}
# in-place scatters: read and write only the rows they are given
_SCATTERS = {aten.index_put_, aten._index_put_impl_, aten.index_copy_,
             aten.scatter_, aten.scatter_add_, aten.index_add_}
# in-place ops that overwrite their target without reading it
_OVERWRITES = {aten.copy_, aten.fill_, aten.zero_}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _read_bytes(t: torch.Tensor) -> int:
    """The distinct elements a view reads: a broadcast (stride 0) dim is
    read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _written(func, args) -> list:
    """The arguments an in-place op writes (schema alias is_write)."""
    return [a for arg, a in zip(func._schema.arguments, args)
            if arg.alias_info is not None and arg.alias_info.is_write
            and isinstance(a, torch.Tensor)]


def _traffic(func, packet, args, kwargs, out) -> int:
    """One HBM read of each distinct input element and one write of each
    output element (see the module docstring for gathers, scatters and
    in-place ops)."""
    ins = [t for t in _tensors((args, kwargs)) if t.dim() > 0]
    if packet in _GATHERS:              # the source's rows = the output
        outs = sum(_nbytes(t) for t in _tensors(out))
        return 2 * outs + sum(_read_bytes(t) for t in ins[1:])
    written = _written(func, args)
    if not written:
        return sum(_read_bytes(t) for t in ins) + sum(
            _nbytes(t) for t in _tensors(out))
    others = [t for t in ins if not any(t is w for w in written)]
    if packet in _SCATTERS:             # the given rows, read and written
        values = [a for arg, a in zip(func._schema.arguments, args)
                  if arg.name in ("values", "source", "src")
                  and isinstance(a, torch.Tensor)]
        return sum(_read_bytes(t) for t in others) + sum(
            _nbytes(t) for t in values)
    w = sum(_nbytes(t) for t in written)
    return sum(_read_bytes(t) for t in others) + w + (
        0 if packet in _OVERWRITES else w)


@functools.lru_cache(maxsize=None)
def _composite(func) -> bool:
    """The op has a CompositeImplicitAutograd kernel (`decompose` can
    split it)."""
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), "CompositeImplicitAutograd")


@functools.lru_cache(maxsize=None)
def _aliases_input(func) -> bool:
    """The op returns a view or an input (not a new buffer)."""
    return any(r.alias_info is not None for r in func._schema.returns)


class OpCounter(TorchDispatchMode):
    """Counts flops, bytes and calls per aten op, the hand kernels'
    calls, and the peak of live bytes the traced ops allocate. Inside
    `scaled(n)` every count is multiplied by n (n identical passes traced
    once)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.calls: Counter = Counter()
        self.kernel_calls: Dict[str, Dict[str, float]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: Dict[int, list] = {}   # key -> [nbytes, refs]
        self._seen = set()      # ids of the tensors tracked, while alive
        self._scale = 1
        self._depth = 0         # the mode re-enters itself to decompose
        self._sink = None

    def __enter__(self):
        if self._depth == 0:
            self._sink = cost.counting(self._kernel_call)
            self._sink.__enter__()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._depth -= 1
        if self._depth == 0:
            self._sink.__exit__(*exc)
        return out

    @contextlib.contextmanager
    def scaled(self, n: int):
        prev, self._scale = self._scale, self._scale * int(n)
        try:
            yield
        finally:
            self._scale = prev

    @property
    def aten_flops(self) -> float:
        return self.flops - sum(k["flops"] for k in self.kernel_calls.values())

    def _kernel_call(self, name, flops, nbytes):
        k = self.kernel_calls.setdefault(name, {"calls": 0, "flops": 0,
                                                "bytes": 0})
        k["calls"] += self._scale
        k["flops"] += flops * self._scale
        k["bytes"] += nbytes * self._scale
        self.flops += flops * self._scale
        self.bytes += nbytes * self._scale

    def _track(self, t: torch.Tensor, new: bool) -> None:
        if id(t) in self._seen:
            return
        st = t.untyped_storage()
        key = st._cdata
        entry = self._storages.get(key)
        if entry is None:
            if not new:
                return          # a view of a buffer made before the trace
            entry = self._storages[key] = [st.nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        self._seen.add(id(t))
        weakref.finalize(t, self._release, key, id(t))

    def _release(self, key: int, tid: int) -> None:
        self._seen.discard(tid)
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet in _METADATA:
            return func(*args, **kwargs)
        if _composite(func):                    # as FlopCounterMode does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        n = self._scale
        name = str(packet)
        self.calls[name] += n
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out) * n
        view = _aliases_input(func)
        if packet not in _ZERO_TRAFFIC and (
                not view or _written(func, args)):
            self.bytes += _traffic(func, packet, args, kwargs, out) * n
        for t in _tensors(out):
            self._track(t, new=not view)
        return out

    def record(self) -> Dict[str, Any]:
        return {"flops": self.flops, "aten_flops": self.aten_flops,
                "bytes": self.bytes, "peak_bytes": self.peak_bytes,
                "op_counts": dict(sorted(self.calls.items())),
                "kernel_calls": self.kernel_calls}


# ---------------------------------------------------------------------------
# fake CUDA tensors on any build
# ---------------------------------------------------------------------------

def _is_fake_cuda(x) -> bool:
    return isinstance(x, FakeTensor) and x.device.type == "cuda"


_INT64_MAX = (1 << 63) - 1


def _slice(out, dim, i: slice):
    return aten.slice.Tensor(out, dim, 0 if i.start is None else i.start,
                             _INT64_MAX if i.stop is None else i.stop,
                             1 if i.step is None else i.step)


def _split_index(x: torch.Tensor, idx):
    """Python indexing of x as PyTorch's `applySlicing` applies it: ints,
    slices, None and Ellipsis as views, in order (a whole-dim slice inside
    a tuple makes no op); tensor indices kept per dim of the view (for
    `aten.index` / `index_put_`). Returns (view or None when no view op
    applies, tensor indices)."""
    if isinstance(idx, slice):                 # the bare-slice fast path
        return _slice(x, 0, idx), []
    if not isinstance(idx, tuple):
        idx = (idx,)
    idx = tuple(x.new_tensor(i, dtype=torch.long) if isinstance(i, list)
                else i for i in idx)
    used = sum((i.dim() if i.dtype == torch.bool else 1)
               if isinstance(i, torch.Tensor) else
               0 if i is None or i is Ellipsis else 1 for i in idx)
    out, dim, adv, viewed = x, 0, {}, False
    for i in idx:
        if i is None:
            out, viewed = aten.unsqueeze.default(out, dim), True
            dim += 1
        elif i is Ellipsis:
            dim += x.dim() - used
        elif isinstance(i, slice):
            if not (i.start in (None, 0) and i.step in (None, 1)
                    and i.stop in (None, out.shape[dim])):
                out, viewed = _slice(out, dim, i), True
            dim += 1
        elif isinstance(i, torch.Tensor):
            adv[dim] = i
            dim += i.dim() if i.dtype == torch.bool else 1
        elif isinstance(i, (int, torch.SymInt)) and not isinstance(i, bool):
            out, viewed = aten.select.int(out, dim, i), True
        else:
            raise TypeError(f"unsupported index {i!r} on a fake tensor")
    tensors = [adv.get(d) for d in range(max(adv) + 1)] if adv else []
    return (out if viewed else None), tensors


def _getitem(x, idx):
    view, tensors = _split_index(x, idx)
    base = x if view is None else view
    if tensors:
        return aten.index.Tensor(base, tensors)
    return aten.alias.default(x) if view is None else view


def _setitem(x, idx, value):
    view, tensors = _split_index(x, idx)
    base = x if view is None else view
    if not isinstance(value, torch.Tensor):     # a CPU scalar, as PyTorch
        value = torch.tensor(value, dtype=x.dtype, device="cpu")
    if tensors:
        aten.index_put_.default(base, tensors, value)
    elif value.dim() == 0 and value.device.type == "cpu":
        aten.fill_.Tensor(base, value)
    else:
        lead = value.dim() - base.dim()
        if lead > 0:
            # leading size-1 dims beyond the target's rank go, as
            # PyTorch's `copy_to` strips them
            value = aten.view.default(value, list(value.shape[lead:]))
        aten.copy_.default(base, value)


def _contiguous(x, memory_format=torch.contiguous_format):
    if x.is_contiguous(memory_format=memory_format):
        return x
    return aten.clone.default(x, memory_format=memory_format)


_REROUTE = {
    torch.Tensor.__getitem__: _getitem,
    torch.Tensor.__setitem__: _setitem,
    torch.Tensor.copy_: lambda x, src, non_blocking=False:
        aten.copy_.default(x, src, non_blocking),
    torch.Tensor.contiguous: _contiguous,
}


class _FakeCudaBindings(TorchFunctionMode):
    """Indexing, `copy_` and `contiguous` of fake CUDA tensors expressed
    as the aten ops they dispatch to (the bindings' CUDA device guard
    needs a CUDA build)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        fn = _REROUTE.get(func)
        if fn is not None and args and _is_fake_cuda(args[0]):
            return fn(*args, **kwargs)
        return func(*args, **kwargs)


@contextlib.contextmanager
def fake_cuda():
    """A FakeTensorMode in which `device="cuda"` tensors hold no storage
    and no device is touched. Yields the mode."""
    mode = FakeTensorMode(allow_non_fake_inputs=False)
    with mode, _FakeCudaBindings():
        yield mode


def fake_like(t: torch.Tensor, device="cuda") -> torch.Tensor:
    """A fake tensor of t's shape, strides and dtype on `device` (call
    inside `fake_cuda()`)."""
    return torch.empty_strided(tuple(t.shape), tuple(t.stride()),
                               dtype=t.dtype, device=device)
