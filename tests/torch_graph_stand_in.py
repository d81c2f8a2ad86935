"""Stand-ins for torch.cuda's graph API on the CPU, for the tests of the
port's compiled steps (models/compiled.py).  It imports torch only, so
the spawned ranks of tests/torch_sharding_ranks.py can use it as well as
tests/test_torch_compiled.py.

* StandInGraph stands for torch.cuda.CUDAGraph: the capture records the
  aten ops the step runs (under a TorchDispatchMode) and a replay runs
  them again, writing each result into the tensor the capture made, as a
  graph replays its kernels on the addresses it captured.  A collective
  (gloo's all_reduce appears as the op c10d.allreduce_) is issued again
  at each replay, and the replay waits on the Work it returns (a
  ScriptObject the dispatcher boxes), as the eager dist.all_reduce does.
* The capture leaves out the profiler's ops (the step's stage ranges,
  torch.profiler.record_function): a replay opens no range, as a CUDA
  graph's replay opens none.
* The capture refuses a host-syncing op as a CUDA capture does, outside
  the kernels' plain versions (which K1-K3 replace on the card).
* The capture also stands for the capturing stream that
  parallel.exchange_tails asks about (sharding._capturing).
* install(setattr) puts the stand-ins in torch.cuda's place through the
  given setattr (pytest's monkeypatch.setattr in a test); installed() is
  a context manager that does so and restores torch.cuda after.

Nothing here is part of the package.
"""
import contextlib

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from dabmod_tpu_torch.models import compiled
from dabmod_tpu_torch.parallel import sharding

# aten ops that wait for the device or copy host data in: a capture
# refuses them, and outside one they stall the issuing thread
HOST_SYNC = frozenset({
    "_local_scalar_dense", "item", "nonzero", "nonzero_numpy", "argwhere",
    "masked_select", "_unique", "_unique2", "unique_dim",
    "unique_consecutive", "equal", "is_nonzero", "allclose", "bincount",
    "histc", "repeat_interleave", "lift_fresh", "lift_fresh_copy",
    "_to_copy_cpu"})


def host_sync(func, args) -> bool:
    """func is a host-syncing op, or an index op with a boolean mask (the
    mask's nonzero runs inside the op)."""
    name = func.overloadpacket.__name__
    if name in HOST_SYNC:
        return True
    if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
        return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in tree_leaves(args[1]))
    return False


# how deep the step is inside a kernel wrapper's plain version (which
# K1-K3 replace on the card): the capture's check does not look there
IN_KERNEL = [0]


def hide_kernels(setattr_):
    """Patch the kernel wrappers (compiled.COUNTED) to run their plain
    versions with IN_KERNEL raised."""
    def hide(fn):
        def wrapped(*a, **k):
            IN_KERNEL[0] += 1
            try:
                return fn(*a, **k)
            finally:
                IN_KERNEL[0] -= 1
        wrapped.launches = fn.launches
        return wrapped
    for mod, name in compiled.COUNTED:
        setattr_(mod, name, hide(getattr(mod, name)))


class Recorder(TorchDispatchMode):
    """Records (func, args, kwargs, out) of every aten op run under it into
    `ops`; a host-syncing op outside a kernel's plain version raises as a
    CUDA capture does."""

    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if host_sync(func, args) and not IN_KERNEL[0]:
            raise RuntimeError(f"{func}: operation not permitted when "
                               f"stream is capturing")
        out = func(*args, **kwargs)
        # a stage range (torch.profiler.record_function enters and exits
        # through ops of the profiler namespace) is host bookkeeping that a
        # graph does not hold: a replay opens no range
        if func.namespace != "profiler":
            self.ops.append((func, args, kwargs, out))
        return out


def _is_work(x) -> bool:
    """x is a collective's Work as the dispatcher returns it (boxed in a
    ScriptObject of class c10d.Work)."""
    return (isinstance(x, torch.ScriptObject)
            and str(x._type()).endswith("c10d.Work"))


class StandInGraph:
    """torch.cuda.CUDAGraph on the CPU: capture records the aten ops, replay
    runs them again into the tensors the capture made; a collective is
    issued again and waited for."""
    made = 0

    def __init__(self):
        StandInGraph.made += 1
        self.ops = []

    def replay(self):
        for func, args, kwargs, out in self.ops:
            res = func(*args, **kwargs)
            for r in tree_leaves(res):
                if _is_work(r):
                    dist.Work.unbox(r).wait()
            for o, r in zip(tree_leaves(out), tree_leaves(res)):
                if (isinstance(o, torch.Tensor) and o.numel()
                        and o.untyped_storage().data_ptr()
                        != r.untyped_storage().data_ptr()):
                    o.copy_(r)


class Stream:
    def wait_stream(self, other):
        pass


def install(setattr_):
    """torch.cuda's graph API and streams on the CPU, and the kernel
    wrappers hidden from the capture's check (hide_kernels)."""
    @contextlib.contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode="global"):
        assert pool is not None and capture_error_mode == "thread_local"
        capturing = sharding._capturing
        sharding._capturing = lambda t: True
        try:
            with Recorder(g.ops):
                yield
        finally:
            sharding._capturing = capturing

    hide_kernels(setattr_)
    StandInGraph.made = 0
    cuda = torch.cuda
    setattr_(cuda, "CUDAGraph", StandInGraph)
    setattr_(cuda, "graph", graph)
    setattr_(cuda, "graph_pool_handle", lambda: ("pool",))
    setattr_(cuda, "Stream", lambda device=None: Stream())
    setattr_(cuda, "current_stream", lambda device=None: Stream())
    setattr_(cuda, "stream", lambda s: contextlib.nullcontext())
    return StandInGraph


@contextlib.contextmanager
def installed():
    """install() for the duration of a with block."""
    saved = []

    def setattr_(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)
    try:
        yield install(setattr_)
    finally:
        for obj, name, old in reversed(saved):
            setattr(obj, name, old)
