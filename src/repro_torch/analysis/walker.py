"""Recorded-trace walk — the traversal layer under every quantlint rule.

Counterpart of ``repro/analysis/walker.py``.  The reference walks the
closed jaxpr of a traced step; the port has no graph (eager PyTorch,
Python loops, ``autograd.Function``s, ``ctypes`` launches), so a
``Recorder`` records one call ``fn(*args)`` as it runs, forward, backward
and recompute, into a straight-line ``Trace`` of events:

* ``Op`` — one aten op as the dispatcher runs it (a ``TorchDispatchMode``,
  which the autograd engine carries to its device threads): its operands
  (tensors by value id, Python numbers as literals), its outputs, and
  ``inside_kernel`` when a kernel wrapper's body ran it — the counterpart
  of an equation inside a ``pallas_call``'s body;
* ``Kernel`` — one call of a kernel wrapper (``kernels/_lib.py``
  ``kernel_call``, on every device): its name, operands and static
  arguments (bits, limb counts, contraction extents), and the values its
  body produced that later events read (its outputs);
* ``Collective`` — one collective (``sharding._count``): kind, tag, the
  rank's operand and the result;
* ``Draw`` — one draw of noise from a ``torch.Generator``
  (``core/dfx.py`` ``uniform``): the generator's identity and a digest of
  its state before the draw, or the forward draw a remat recompute
  replays (``models/lm.py`` ``_replay_key`` reports its generators).

A value id names one version of one tensor: every op output gets a fresh
id, and an op that writes a tensor in place gives it a new one.  Tensors
are told apart through a weak-id map, so a tensor a step frees does not
lend its id to the next.  ``where`` is ``file:line (function)`` of the
innermost frame in the package outside ``analysis/`` and ``kernels/``, as
``source_info_util.summarize`` gives the reference.

Two views, as in the reference:

* ``iter_ops`` / ``count_ops`` / ``count_kernels`` — the syntactic walk.
  The port's loops are Python loops, so every event already is one
  execution: the counts are the reference's ``effective`` counts, and
  there is no ``traced`` program text to count.
* ``interpret`` — the forward abstract interpreter: a rule supplies a
  ``Semantics`` (a transfer function over its abstract domain) and the
  walker threads the environment through every event.  A kernel is a
  boundary: ``Semantics.kernel`` gives its outputs' values and its body's
  ops are not interpreted.  ``Ctx.trips`` is always 1, and a straight
  line has no merge point (the reference's ``join``).

The module imports nothing of the rest of the package at import time.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import os
import sys
import threading
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["TensorInfo", "Literal", "Op", "Kernel", "Collective", "Draw",
           "Trace", "Recorder", "record", "Site", "iter_ops", "count_ops",
           "count_kernels", "kernel_counts", "Semantics", "Ctx",
           "interpret"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP = (os.path.join(_PKG, "analysis") + os.sep,
         os.path.join(_PKG, "kernels") + os.sep)


# =========================================================================
# Events
# =========================================================================

@dataclasses.dataclass(frozen=True)
class TensorInfo:
    """One tensor value: its id, dtype and shape."""

    vid: int
    dtype: torch.dtype
    shape: Tuple[int, ...]

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class Literal:
    """A Python number an op took as an operand (``x * 2.0``)."""

    val: Any


@dataclasses.dataclass
class Op:
    """One aten op.  ``prim`` is the op's name without namespace and
    overload (``"mm"``, ``"_to_copy"``, ``"add_"``); ``ins`` its operands
    (tensors, and the Python numbers of its positional arguments);
    ``args`` / ``kwargs`` the call's arguments with tensors as
    ``TensorInfo``; ``kernel`` the index of the kernel whose body ran it."""

    index: int
    prim: str
    ins: Tuple[Any, ...]
    outs: Tuple[TensorInfo, ...]
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    where: str
    kernel: Optional[int] = None

    @property
    def inside_kernel(self) -> bool:
        return self.kernel is not None


@dataclasses.dataclass
class Kernel:
    """One kernel wrapper call.  ``operands``: the wrapper's tensors
    (``None`` where absent), ``static`` its bits / limbs / contraction
    extents, ``outs`` the values its body made that later events read;
    the body's events are ``index + 1 .. end - 1``."""

    index: int
    name: str
    operands: Tuple[Optional[TensorInfo], ...]
    static: Dict[str, Any]
    where: str
    end: int = -1
    outs: Tuple[TensorInfo, ...] = ()


@dataclasses.dataclass
class Collective:
    """One collective of ``kind`` (``all-gather``, ``all-reduce``,
    ``reduce-scatter``) under ``tag``: ``src`` the rank's tensor, ``out``
    the counted result."""

    index: int
    kind: str
    tag: str
    src: TensorInfo
    out: TensorInfo
    where: str


@dataclasses.dataclass
class Draw:
    """One draw of noise ``out`` from generator ``gen`` (a per-trace id),
    whose state before the draw hashes to ``digest`` (None for a draw on
    ``meta``, which takes nothing from the stream).  ``replay_of``: the
    index of the forward draw a remat recompute's generator replays."""

    index: int
    gen: int
    digest: Optional[str]
    out: TensorInfo
    where: str
    replay_of: Optional[int] = None


@dataclasses.dataclass
class Trace:
    """The events of one recorded call, in the order they ran."""

    events: List[Any]

    def ops(self) -> Iterator[Op]:
        return (e for e in self.events if isinstance(e, Op))

    def kernels(self) -> Iterator[Kernel]:
        return (e for e in self.events if isinstance(e, Kernel))

    def collectives(self) -> Iterator[Collective]:
        return (e for e in self.events if isinstance(e, Collective))

    def draws(self) -> Iterator[Draw]:
        return (e for e in self.events if isinstance(e, Draw))


# =========================================================================
# The recorder
# =========================================================================

def _walk(tree, fn):
    """``fn`` over every leaf of an op argument's nested lists, rebuilt."""
    if isinstance(tree, (list, tuple)):
        return [_walk(x, fn) for x in tree]
    return fn(tree)


class Recorder(TorchDispatchMode):
    """Records every op, kernel call, collective and draw of the calls
    made while it is active (``with Recorder() as rec: ...``, then
    ``rec.trace``).  It sets itself as the observer of ``kernels/_lib``,
    ``sharding`` and ``core/dfx`` for the duration."""

    def __init__(self):
        super().__init__()
        self.events: List[Any] = []
        self._ids: Dict[int, Tuple[Any, int]] = {}
        self._next = itertools.count(1)
        # generators are kept alive while recording (a generator takes no
        # weak reference in every torch release), so their ids stay theirs
        self._gens: Dict[int, Tuple[torch.Generator, int]] = {}
        self._replays: Dict[int, torch.Generator] = {}
        self._digests: Dict[str, int] = {}
        self._lock = threading.RLock()
        self._tls = threading.local()
        self._where_cache: Dict[Any, bool] = {}
        self._schemas: Dict[Any, tuple] = {}
        self._prev: tuple = ()
        self.trace: Optional[Trace] = None

    # -- activation ----------------------------------------------------
    def __enter__(self):
        from repro_torch import sharding
        from repro_torch.core import dfx
        from repro_torch.kernels import _lib
        self._prev = (_lib.observer, sharding.observer, dfx.observer)
        _lib.observer = sharding.observer = dfx.observer = self
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch import sharding
        from repro_torch.core import dfx
        from repro_torch.kernels import _lib
        try:
            return super().__exit__(*exc)
        finally:
            _lib.observer, sharding.observer, dfx.observer = self._prev
            self.trace = self._finish()

    # -- value ids -------------------------------------------------------
    def _info(self, t: torch.Tensor, fresh: bool = False) -> TensorInfo:
        key = id(t)
        hit = self._ids.get(key)
        if fresh or hit is None or hit[0]() is not t:
            vid = next(self._next)
            self._ids[key] = (weakref.ref(t), vid)
        else:
            vid = hit[1]
        return TensorInfo(vid, t.dtype, tuple(t.shape))

    def _where(self, skip: str = "") -> str:
        """``file:line (function)`` of the innermost frame in the package
        outside ``analysis/`` and ``kernels/`` (and outside the file
        ``skip``, the hook's own module), or "" (an op the autograd
        engine runs with no Python frame of the package)."""
        f = sys._getframe(2)
        cache = self._where_cache
        while f is not None:
            code = f.f_code
            ok = cache.get(code)
            if ok is None:
                fn = os.path.abspath(code.co_filename)
                ok = fn.startswith(_PKG + os.sep) and not fn.startswith(_SKIP)
                cache[code] = ok
            if ok and not (skip and code.co_filename.endswith(skip)):
                return (f"{os.path.basename(code.co_filename)}:"
                        f"{f.f_lineno} ({code.co_name})")
            f = f.f_back
        return ""

    def _kstack(self) -> list:
        st = getattr(self._tls, "kernels", None)
        if st is None:
            st = self._tls.kernels = []
        return st

    # -- ops -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        with self._lock:
            ins: List[Any] = []

            def operand(x, top):
                if isinstance(x, torch.Tensor):
                    info = self._info(x)
                    ins.append(info)
                    return info
                if top and isinstance(x, (int, float)) \
                        and not isinstance(x, bool):
                    ins.append(Literal(x))
                return x

            a = tuple(operand(x, True) if not isinstance(x, (list, tuple))
                      else _walk(x, lambda y: operand(y, False))
                      for x in args)
            k = {n: _walk(v, lambda y: operand(y, False))
                 for n, v in kwargs.items()}
        out = func(*args, **kwargs)
        with self._lock:
            name, writes = self._schema(func)
            written = []
            for i, arg in writes:
                v = args[i] if i < len(args) else kwargs.get(arg)
                if isinstance(v, torch.Tensor):
                    written.append(v)
            outs = []
            seen = set()
            for t in itertools.chain(written, _leaves(out)):
                if id(t) in seen:
                    continue
                seen.add(id(t))
                outs.append(self._info(t, fresh=True))
            stack = self._kstack()
            self.events.append(Op(
                index=len(self.events), prim=name, ins=tuple(ins),
                outs=tuple(outs), args=a, kwargs=k, where=self._where(),
                kernel=stack[-1] if stack else None))
        return out

    def _schema(self, func) -> tuple:
        """``(name, [(position, argument name)] of the arguments it
        writes)`` of an op overload, cached."""
        hit = self._schemas.get(func)
        if hit is None:
            schema = func._schema
            hit = self._schemas[func] = (
                schema.name.split("::")[-1],
                [(i, a.name) for i, a in enumerate(schema.arguments)
                 if a.alias_info is not None and a.alias_info.is_write])
        return hit

    # -- observer hooks ----------------------------------------------------
    def kernel(self, name: str, operands, static):
        """Context manager around one kernel wrapper's body."""
        rec = self

        class _Bracket:
            def __enter__(self_):
                with rec._lock:
                    ev = Kernel(index=len(rec.events), name=name,
                                operands=tuple(
                                    rec._info(t) if isinstance(
                                        t, torch.Tensor) else None
                                    for t in operands),
                                static=dict(static), where=rec._where())
                    rec.events.append(ev)
                    rec._kstack().append(ev.index)
                    self_.ev = ev

            def __exit__(self_, *exc):
                with rec._lock:
                    rec._kstack().pop()
                    self_.ev.end = len(rec.events)
                return False
        return _Bracket()

    def collective(self, kind: str, tag: str, src: torch.Tensor,
                   out: torch.Tensor) -> None:
        with self._lock:
            where = self._where(skip=os.sep + "sharding.py")
            self.events.append(Collective(
                index=len(self.events), kind=kind, tag=tag,
                src=self._info(src), out=self._info(out),
                where=f"{tag}: {where}" if where else tag))

    def replay(self, gen: torch.Generator) -> None:
        """``gen`` replays the draws of an earlier stream from its start."""
        with self._lock:
            self._replays[id(gen)] = gen

    def draw(self, gen: torch.Generator, thunk: Callable[[], torch.Tensor]
             ) -> torch.Tensor:
        digest = hashlib.sha1(
            gen.get_state().numpy().tobytes()).hexdigest()
        replay = id(gen) in self._replays
        u = thunk()
        if u.device.type == "meta":
            # the shape-only path takes nothing from the stream
            digest = None
        with self._lock:
            hit = self._gens.get(id(gen))
            if hit is None:
                hit = self._gens[id(gen)] = (gen, len(self._gens) + 1)
            index = len(self.events)
            replay_of = self._digests.get(digest) if replay else None
            if not replay and digest is not None:
                self._digests.setdefault(digest, index)
            self.events.append(Draw(
                index=index, gen=hit[1], digest=digest, out=self._info(u),
                where=self._where(skip=os.sep + "dfx.py"),
                replay_of=replay_of))
        return u

    # -- the kernels' outputs ---------------------------------------------
    def _finish(self) -> Trace:
        events = self.events
        last_read: Dict[int, int] = {}

        def read(info, i):
            if isinstance(info, TensorInfo):
                last_read[info.vid] = i
        for i, e in enumerate(events):
            if isinstance(e, Op):
                for x in e.ins:
                    read(x, i)
            elif isinstance(e, Kernel):
                for x in e.operands:
                    read(x, i)
            elif isinstance(e, Collective):
                read(e.src, i)
        for e in events:
            if isinstance(e, Kernel):
                outs = []
                for b in events[e.index + 1:e.end]:
                    if isinstance(b, Op):
                        outs.extend(t for t in b.outs
                                    if last_read.get(t.vid, -1) >= e.end)
                e.outs = tuple(outs)
        return Trace(events)


def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)


def record(fn: Callable, *args, **kwargs) -> Tuple[Any, Trace]:
    """``fn(*args, **kwargs)`` under a ``Recorder`` -> (its result, the
    trace)."""
    rec = Recorder()
    with rec:
        result = fn(*args, **kwargs)
    return result, rec.trace


# =========================================================================
# Syntactic walk
# =========================================================================

@dataclasses.dataclass(frozen=True)
class Site:
    """One op plus its traversal context."""

    op: Op
    #: the op's name (``op.prim``), for convenience
    prim: str
    #: True when a kernel wrapper's body ran the op
    inside_kernel: bool
    #: executions per step relative to the top level: always 1, the
    #: port's loops being Python loops
    trips: int
    #: names of the enclosing kernels, outermost first
    path: Tuple[str, ...]


def iter_ops(trace: Trace, *, recurse_kernels: bool = True
             ) -> Iterator[Site]:
    """Every op of a trace, with the kernel bodies' ops unless
    ``recurse_kernels`` is False."""
    names: Dict[int, str] = {}
    for e in trace.events:
        if isinstance(e, Kernel):
            names[e.index] = e.name
        elif isinstance(e, Op):
            if e.kernel is not None and not recurse_kernels:
                continue
            yield Site(op=e, prim=e.prim, inside_kernel=e.inside_kernel,
                       trips=1, path=(names[e.kernel],)
                       if e.kernel is not None else ())


def count_ops(trace: Trace, name: str, *,
              recurse_kernels: bool = True) -> int:
    """Count ``name`` ops; ``recurse_kernels=False`` skips the kernel
    bodies (an op that must happen only inside fused kernels)."""
    return sum(1 for s in iter_ops(trace, recurse_kernels=recurse_kernels)
               if s.prim == name)


def count_kernels(trace: Trace) -> int:
    """Kernel wrapper calls: the reference's ``effective`` count."""
    return sum(1 for _ in trace.kernels())


def kernel_counts(trace: Trace) -> Dict[str, int]:
    """Kernel wrapper calls by wrapper name."""
    return dict(collections.Counter(k.name for k in trace.kernels()))


# =========================================================================
# Forward abstract interpretation
# =========================================================================

@dataclasses.dataclass
class Ctx:
    """Traversal context handed to every ``Semantics`` callback."""

    trips: int = 1
    inside_kernel: bool = False
    path: Tuple[str, ...] = ()

    def enter(self, name: str, *, kernel: bool = False) -> "Ctx":
        return Ctx(trips=self.trips,
                   inside_kernel=self.inside_kernel or kernel,
                   path=self.path + (name,))


class Semantics:
    """Abstract-value transfer functions; override what the rule needs.

    The abstract domain is whatever the subclass chooses; ``None`` is the
    universal "don't know / don't care" element and is what every default
    produces.  ``op`` sees one abstract value per operand of ``op.ins``
    and returns one per ``op.outs`` (or ``None`` for ``default_out``).
    """

    def input(self, info: TensorInfo, index: int):
        """Abstract value of a tensor no recorded op produced (the step's
        arguments, the parameters)."""
        return None

    def literal(self, lit: Literal):
        """Abstract value of a Python-number operand."""
        return None

    def op(self, op: Op, in_vals: List[Any], ctx: Ctx) -> Optional[List[Any]]:
        """Transfer one op; ``None`` to use ``default_out``."""
        return None

    def default_out(self, op: Op, in_vals: List[Any], ctx: Ctx) -> List[Any]:
        return [None] * len(op.outs)

    def kernel(self, k: Kernel, in_vals: List[Any], ctx: Ctx) -> List[Any]:
        """Kernel boundary: the values of ``k.outs`` from the values of
        ``k.operands``; the body's ops are not interpreted."""
        return [None] * len(k.outs)

    def collective(self, c: Collective, in_val, ctx: Ctx):
        """The value of the result from the rank's operand's: by default
        the same content."""
        return in_val

    def draw(self, d: Draw, ctx: Ctx):
        """The value of the noise a draw returned."""
        return None


def interpret(trace: Trace, sem: Semantics) -> Dict[int, Any]:
    """Run ``sem`` forward over a trace; returns the environment (value
    id -> abstract value)."""
    env: Dict[int, Any] = {}
    n_inputs = itertools.count()

    def read(x):
        if isinstance(x, Literal):
            return sem.literal(x)
        if x is None:
            return None
        if x.vid not in env:
            env[x.vid] = sem.input(x, next(n_inputs))
        return env[x.vid]

    ctx = Ctx()
    events = trace.events
    i = 0
    while i < len(events):
        e = events[i]
        if isinstance(e, Kernel):
            vals = [read(x) for x in e.operands]
            out = sem.kernel(e, vals, ctx.enter(e.name, kernel=True))
            for t, v in zip(e.outs, out):
                env[t.vid] = v
            i = max(e.end, i + 1)
            continue
        if isinstance(e, Op):
            vals = [read(x) for x in e.ins]
            out = sem.op(e, vals, ctx)
            if out is None:
                out = sem.default_out(e, vals, ctx)
            for t, v in zip(e.outs, out):
                env[t.vid] = v
        elif isinstance(e, Collective):
            env[e.out.vid] = sem.collective(e, read(e.src), ctx)
        elif isinstance(e, Draw):
            env[e.out.vid] = sem.draw(e, ctx)
        i += 1
    return env
