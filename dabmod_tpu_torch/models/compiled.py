"""The compiled step: Modulator.modulate on the card as CUDA graphs, the
port's counterpart of dabmod_tpu's jax.jit(Modulator._modulate_impl,
donate_argnums=(2,)) (its models/modulator.py:297, 741-754), and the
sharded step of parallel.ShardedModulator over NCCL, the counterpart of
dabmod_tpu/parallel/sharding.py:232-243.

A GraphStep captures the step function it is given: the modulator's
_modulate_impl, or ShardedModulator._sharded_impl, whose graph also holds
the rank's all_reduces.  One graph per batch size B, as a new shape makes
JAX retrace:

* the first step of a B runs the step function once eagerly on a
  side stream (the warm-up: it builds the kernels, fills the lazy caches
  of device tables, makes the cuFFT plans and the cuBLAS workspace of
  that stream; for the sharded step, the collectives once more on the
  NCCL communicator), then captures it on the same stream
  (torch.cuda.graph, capture_error_mode="thread_local": the runtime's
  other threads wait on events meanwhile);
* every step of that B copies its inputs (ETI bytes, state) into the
  graph's static input tensors and replays the graph on the current
  stream;
* the gain scalars (constant gain, var_k) are 0-d float32 tensors the
  graph reads, filled from the live settings before a replay when they
  changed, so an RC `gain digital` or `gain var` write reaches the next
  step as a traced argument reaches JAX's;
* the FIR taps and DPD coefficients are the modulator's parameter
  tensors, which a hot swap overwrites in place (Modulator._apply_swaps),
  so a swap reaches the next replay with no re-capture;
* the outputs (the output, the new state, the stats) are cloned after
  each replay: nothing a step returns is overwritten by a later one, as
  JAX returns fresh arrays;
* the kernel wrappers count their launches where they launch, so the
  warm-up and the capture count and a replay, which runs no Python, does
  not: a graph records how many of each kernel it holds (Captured.launches),
  the kernels each replay runs on the card.

All graphs of a modulator share one memory pool
(torch.cuda.graph_pool_handle); the graphs, their static tensors and the
pool go with the GraphStep, which the modulator holds.  A failed capture
or replay raises: nothing falls back to the eager step or to the CPU.
One thread issues a modulator's steps.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ..ops import frontend_kernel, kiss_kernel, ofdm_kernel, resampler_kernel

# the kernel wrappers that count their launches in a `launches` attribute
# (looked up at each use, so a wrapper replaced at run time is the one read)
COUNTED = ((ofdm_kernel, "ofdm_backend"), (ofdm_kernel, "ofdm_cfr_backend"),
           (resampler_kernel, "resample"), (kiss_kernel, "kiss_ifft"),
           (frontend_kernel, "frontend"))


def launch_counts() -> dict:
    return {name: getattr(mod, name).launches for mod, name in COUNTED}


@dataclasses.dataclass
class Captured:
    """One batch size's graph, its static tensors, the launches of each
    counted kernel it holds (those a replay runs) and its replays."""
    graph: object
    spec: object
    inputs: list
    outputs: object
    launches: dict
    replays: int = 0


class GraphStep:
    """The captured steps of one step function, keyed by batch size (TFs).

    `impl` is a bound method, impl(fic, subch, state, constant_gain, var_k,
    rp), that returns (output, new state, stats): Modulator._modulate_impl
    or ShardedModulator._sharded_impl.  It is held weakly, since its owner
    holds this GraphStep and a cycle would keep the graphs' memory until a
    garbage collection."""

    def __init__(self, impl):
        self._impl = weakref.WeakMethod(impl)
        self.graphs: dict[int, Captured] = {}
        self._pool = None
        self._stream = None
        self._gains = None          # the 0-d tensors the graphs read
        self._gain_values = None    # the values they hold

    def step(self, m, fic, subch, state):
        """One step of the step function with the gains and parameters of
        modulator m (Modulator.modulate's contract) on its card: fic, subch
        and state are tensors there (for the sharded step, this rank's
        TFs)."""
        rp = m._apply_swaps()
        gains = m._gain_values()
        leaves, spec = tree_flatten((fic, subch, state))
        B = fic.shape[0] // m.p.cif_count
        cap = self.graphs.get(B)
        if cap is None:
            cap = self.graphs[B] = self._capture(m, leaves, spec, rp, gains)
        else:
            if spec != cap.spec:
                raise ValueError("the step's inputs are not those its graph "
                                 "was captured with")
            for dst, src in zip(cap.inputs, leaves):
                if src.shape != dst.shape or src.dtype != dst.dtype:
                    raise ValueError(
                        f"an input of {tuple(src.shape)} {src.dtype} where "
                        f"the graph takes {tuple(dst.shape)} {dst.dtype}")
                dst.copy_(src)
        if gains != self._gain_values:
            for t, v in zip(self._gains, gains):
                t.fill_(v)
            self._gain_values = gains
        cap.graph.replay()
        cap.replays += 1
        return tree_map(torch.clone, cap.outputs)

    def _capture(self, m, leaves, spec, rp, gains) -> Captured:
        dev = m.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._gains = m._gain_args()
            self._gain_values = gains
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        inputs = [x.clone() for x in leaves]
        fic, subch, state = tree_unflatten(inputs, spec)
        args = (fic, subch, state, *self._gains, rp)
        impl = self._impl()
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            impl(*args)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                  capture_error_mode="thread_local"):
                outputs = impl(*args)
        except BaseException:
            self._stream = None     # the next capture takes a fresh stream
            raise
        launches = {k: n - before[k] for k, n in launch_counts().items()}
        return Captured(graph=graph, spec=spec, inputs=inputs,
                        outputs=outputs, launches=launches)
