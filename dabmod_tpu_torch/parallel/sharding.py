"""Data-parallel modulation over the transmission-frame (TF) axis across
torch.distributed ranks (port of dabmod_tpu/parallel/sharding.py).

One process a rank.  Every rank is handed the same global ETI batch of B
TFs and modulates B/world of them: rank r the r-th run, in TF order.  The
sequential state is replicated.  JAX gets the global semantics of every op
from GSPMD; here each rank runs the eager step on its own TFs, so every
coupling along the TF axis is handled by hand.  Read off
Modulator._modulate_impl, they are:

* the time interleaver's 15-CIF history per sub-channel
  (make_sharded_time_interleave);
* the resampler's carries: the 2*half input samples of K3 and of the plain
  polyphase form, the input half-frame and the overlap-add tail of the
  frequency-domain form (shard_resampler_backend);
* tf_index (TII in the NULL symbol of even TFs) and mer_index (the CFR MER
  symbol each TF inspects): offset by the TFs of the ranks before;
* num_clipped, one count a batch: summed over the ranks.

Everything else is per TF: the FIR truncates at each TF's end, the
windowed guard interval and the gain work within a TF, DQPSK restarts at
each TF's phase reference symbol.  The OFDM kernels (K1, K2) and K3 need no
wrapping: each rank launches them on its own TFs, which is what JAX's
shard_ofdm_backend does through shard_map, so that function has no
counterpart here.

Every exchange is one collective, exchange_tails.  A step makes one for
the TI rows of every sub-channel, one for the resampler and one for
num_clipped; EXCHANGES counts them, with their bytes and, on request,
their time, in total and per coupling ("time_interleave", "resampler",
"num_clipped"; "gather" outside the step).

On the card over NCCL (or alone, world 1 with no group) each rank's step
is a CUDA graph per local batch size (models/compiled.py's GraphStep of
ShardedModulator._sharded_impl), the counterpart of JAX's jit of the
sharded step (dabmod_tpu/parallel/sharding.py:232-243): the graph holds
the rank's kernels and its all_reduces, and every rank captures and
replays the same graphs in the same order, as they run the same batches.
gloo's all_reduce of CUDA tensors stages through the host, which a capture
cannot hold, so gloo ranks (and CPU ranks) run the step eagerly.
"""
from __future__ import annotations

import dataclasses
import datetime
import time

import torch
import torch.distributed as dist

from ..models import compiled
from ..models.modulator import Modulator, resolve_device
from ..ops import fec
from ..ops.filters import resample


@dataclasses.dataclass(frozen=True)
class TfMesh:
    """The ranks that share the TF axis.  Rank r modulates the r-th
    1/world_size of each batch's TFs (over ('host', 'chip') host-major, as
    JAX's P(('host', 'chip')) flattens its mesh).  `group` is the process
    group of the exchanges, None without torch.distributed (world size 1,
    or a record for tf_slice alone)."""
    group: object
    world_size: int
    rank: int
    axis_names: tuple
    device: torch.device

    def tf_slice(self, n_tf: int) -> slice:
        """This rank's TFs of a batch of n_tf."""
        if n_tf % self.world_size:
            raise ValueError(f"a batch of {n_tf} TFs does not split over "
                             f"{self.world_size} ranks")
        n = n_tf // self.world_size
        return slice(self.rank * n, (self.rank + 1) * n)


def make_mesh(world_size: int | None = None, rank: int | None = None,
              group=None, device=None) -> TfMesh:
    """The TF mesh of this process.  Under torch.distributed the world size
    and rank are the group's (the default group unless `group` is given);
    explicit values must agree.  Without it, world_size and rank describe a
    mesh that makes no exchange (default: world 1, rank 0).  device=None is
    the CUDA card (its current device) and raises without one."""
    return _mesh(world_size, rank, group, device, ("tf",))


def make_host_chip_mesh(n_hosts: int, chips_per_host: int,
                        rank: int | None = None, group=None,
                        device=None) -> TfMesh:
    """Mesh ('host', 'chip'): rank = host * chips_per_host + chip, so TFs
    scatter host-major, as under JAX's make_host_chip_mesh.  Start one
    process a card, numbered so on every host."""
    return _mesh(n_hosts * chips_per_host, rank, group, device,
                 ("host", "chip"))


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device without an index as the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _mesh(world_size, rank, group, device, axes) -> TfMesh:
    dev = _indexed(resolve_device(device))
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD if group is None else group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        if world_size not in (None, n) or rank not in (None, r):
            raise ValueError(f"world size {world_size} and rank {rank} "
                             f"disagree with the process group's {n} and {r}")
        world_size, rank = n, r
    elif group is not None:
        raise ValueError("a process group without torch.distributed")
    world_size = 1 if world_size is None else world_size
    rank = 0 if rank is None else rank
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    return TfMesh(group, world_size, rank, axes, dev)


def rank_device(device, rank: int) -> torch.device:
    """The device of a rank: `device` as given, or with no index given for
    a CUDA device, card rank % the cards present (every rank on card 0 of a
    one-card machine, one rank a card where there are enough)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     backend: str | None = None, device=None,
                     timeout_s: float = 300.0) -> TfMesh:
    """Join the process group at tcp://<coordinator> (host:port of rank
    0; any free port) as rank `process_id` of `num_processes`, and return
    this process's TF mesh.  backend=None is nccl for a CUDA device and
    gloo for the CPU; gloo also takes CUDA tensors (ranks sharing one
    card).  A collective that waits longer than timeout_s raises, so a rank
    that dies makes the others fail, not hang."""
    dev = rank_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None)
    return make_mesh(device=dev)


def captures(mesh: TfMesh) -> bool:
    """Whether a ShardedModulator on this mesh replays CUDA graphs: on a
    CUDA device over an NCCL group, or with no group at world 1.  NCCL's
    collectives can be captured; gloo's all_reduce of CUDA tensors copies
    through the host and cannot, so gloo ranks run the step eagerly."""
    if mesh.device.type != "cuda":
        return False
    if mesh.group is None:
        return mesh.world_size == 1
    return dist.get_backend(mesh.group) == "nccl"


def _span_ms(spans) -> float:
    """The summed time of (start, end) spans: perf_counter readings, or
    CUDA events (each end waited for)."""
    total = 0.0
    for t0, t1 in spans or ():
        if isinstance(t0, float):
            total += (t1 - t0) * 1e3
        else:
            t1.synchronize()
            total += t0.elapsed_time(t1)
    return total


@dataclasses.dataclass
class Coupling:
    """What exchange_tails did for one coupling since EXCHANGES.reset():
    its collectives, their all_reduce buffer bytes, the shape and dtype of
    the tail this rank gave the last of them (every rank gives the same)
    and, with timing, each one's span."""
    collectives: int = 0
    buffer_bytes: int = 0
    tail_shape: tuple = ()
    dtype: str = ""
    spans: list | None = None

    def ms(self) -> float:
        return _span_ms(self.spans)


@dataclasses.dataclass
class ExchangeCounts:
    """What exchange_tails has done in this process since reset(): its
    collectives and the bytes of their all_reduce buffers and, after
    reset(timing=True), each one's span from its buffer's allocation to
    the reduced buffer (a pair of CUDA events recorded on the current
    stream on the card, perf_counter readings on the CPU); in total, and
    per coupling in `couplings` (name -> Coupling).  A world of one makes
    no collective and counts none.

    It counts where a collective is issued: in an eager step, and in a
    graph's warm-up and capture.  A replay runs no Python and counts
    nothing; the collectives a replay runs on the card are read from a
    profiler trace.  Timing inside a capture raises: its events would
    time the capture, not a replay."""
    collectives: int = 0
    buffer_bytes: int = 0
    spans: list | None = None
    couplings: dict = dataclasses.field(default_factory=dict)

    def reset(self, timing: bool = False):
        self.collectives, self.buffer_bytes = 0, 0
        self.spans = [] if timing else None
        self.couplings = {}

    def ms(self) -> float:
        """The summed time of the timed exchanges (waits for the card)."""
        return _span_ms(self.spans)

    def _count(self, coupling: str, tail: torch.Tensor, nbytes: int, span):
        c = self.couplings.setdefault(coupling, Coupling(
            spans=None if self.spans is None else []))
        self.collectives += 1
        self.buffer_bytes += nbytes
        c.collectives += 1
        c.buffer_bytes += nbytes
        c.tail_shape, c.dtype = tuple(tail.shape), str(tail.dtype)
        if span is not None:
            self.spans.append(span)
            c.spans.append(span)


EXCHANGES = ExchangeCounts()


def _mark(dev: torch.device):
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _capturing(t: torch.Tensor) -> bool:
    """Whether the current stream of t's card is capturing a CUDA graph."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def exchange_tails(tail: torch.Tensor, mesh: TfMesh,
                   coupling: str = "other") -> torch.Tensor:
    """Every rank's `tail` (same shape and dtype on each rank) on every
    rank: [world, *tail.shape], slot r from rank r.  EXCHANGES counts it
    under `coupling`.

    One all_reduce (sum) of a zeroed [world, nbytes] uint8 buffer in which
    each rank fills its own slot with the bytes of its tail: every byte has
    one contributor, so each slot arrives bit for bit, whatever the dtype.
    It serves both the halo (the slots of the ranks before) and the
    replicated new carry (the last rank's slot), and replaces JAX's H
    collective permutes plus one psum.  It needs only all_reduce, so it
    runs on gloo with CPU tensors, on gloo with CUDA tensors (which has no
    send or recv) and on NCCL.  The buffer is world * tail bytes; a ring
    all_reduce moves about twice that through each rank."""
    if mesh.group is None:
        if mesh.world_size != 1:
            raise RuntimeError("an exchange between ranks needs "
                               "torch.distributed")
        return tail.unsqueeze(0).clone()
    timing = EXCHANGES.spans is not None
    if timing and _capturing(tail):
        raise RuntimeError("EXCHANGES times collectives with events, which "
                           "a graph capture cannot hold: reset(timing="
                           "False) before a sharded step's first call")
    t0 = _mark(tail.device) if timing else None
    raw = tail.contiguous().reshape(-1).view(torch.uint8)
    buf = torch.zeros((mesh.world_size, raw.numel()), dtype=torch.uint8,
                      device=tail.device)
    buf[mesh.rank] = raw
    dist.all_reduce(buf, group=mesh.group)
    EXCHANGES._count(coupling, tail, buf.numel(),
                     (t0, _mark(tail.device)) if timing else None)
    return buf.view(tail.dtype).reshape(mesh.world_size, *tail.shape)


def make_sharded_time_interleave(mesh: TfMesh):
    """A drop-in replacement for fec.time_interleave_all on this rank's
    [tl, n_i] CIF rows of each sub-channel: bit for bit the unsharded
    interleaver's output rows, and the batch's new [15, n_i] histories, the
    same on every rank.

    The history of rank i is the 15 CIF rows before its first: the last
    min(tl, 15) rows of each rank before it (all of them when tl < 15,
    where they come from ceil(15/tl) ranks) and, where those do not reach
    back 15 rows, the carried history's rows i*tl.. (JAX :129-137).  Every
    rank contributes its last min(tl, 15) rows of every sub-channel, side
    by side, to one exchange_tails; a sub-channel's new history is the
    last 15 rows of its carried history followed by all the
    contributions.  JAX makes H collective permutes and one psum a
    sub-channel; this is one collective for all of them.  At world size 1
    it is fec.time_interleave_all."""
    if mesh.world_size == 1:
        return fec.time_interleave_all

    def sharded_ti(bits: list[torch.Tensor], histories):
        if not bits:
            return [], ()
        rows = min(bits[0].shape[0], 15)
        tails = exchange_tails(torch.cat([b[-rows:] for b in bits], dim=1),
                               mesh, "time_interleave")  # [world, rows, sum n]
        # the carried history and the tails of ranks 0 .. i-1 end on the
        # row before rank i's first
        before = 15 + mesh.rank * rows
        outs, new_hist, start = [], [], 0
        for b, h in zip(bits, histories):
            n = b.shape[1]
            seq = torch.cat([h, tails[..., start:start + n].reshape(-1, n)])
            outs.append(fec.time_interleave(b, seq[before - 15:before])[0])
            new_hist.append(seq[-15:].clone())
            start += n
        return outs, tuple(new_hist)

    return sharded_ti


def shard_resampler_backend(modulator: Modulator, mesh: TfMesh):
    """A drop-in replacement for modulator._resample(iq, state, new_state)
    on this rank's TFs, for each of the three routes; the carries it leaves
    in new_state are the last rank's, the same on every rank.  One
    exchange_tails of each rank's last input samples a step:

    * K3 and the plain polyphase form: rank i takes rank i-1's last 2*half
      input samples as its carry, rank 0 the carried state (JAX :156-192);
    * the frequency-domain form: rank i's input tail is rank i-1's last
      fft_in/2 samples, and its overlap-add tail is what filters.resample
      returns as the new out-tail on rank i-1's last fft_in/2 samples with
      the fft_in/2 before them as the in-tail: the predecessor's last frame,
      computed again from a 2*(fft_in/2)-sample halo.  The new out-tail is
      computed so from the last rank's halo, on every rank, within float
      rounding of the last rank's own.  JAX leaves this route to GSPMD."""
    route, plan = modulator._res_route, modulator._res_plan
    resample_local = modulator._resample
    prev = mesh.rank - 1
    if route is None:
        return resample_local           # never called: no resampler

    if route == "fft":
        hi = plan.fft_in // 2

        def out_tail(halo):
            # the second half of the inverse transform of the frame `halo`
            return resample(halo[hi:], plan, halo[:hi],
                            halo.new_zeros((plan.fft_out // 2, 2)))[2]

        def sharded_fft(iq, state, new_state):
            flat = tuple(x.reshape(-1) for x in iq)
            if flat[0].shape[0] < 2 * hi:
                raise ValueError(f"{flat[0].shape[0]} samples a rank: the "
                                 f"halo needs {2 * hi}")
            tails = exchange_tails(
                torch.stack([x[-2 * hi:] for x in flat], dim=-1), mesh,
                "resampler")
            local = state if prev < 0 else {
                "res_in_tail": tails[prev, hi:],
                "res_out_tail": out_tail(tails[prev])}
            y = resample_local(iq, local, new_state)
            new_state["res_in_tail"] = tails[-1, hi:].clone()
            new_state["res_out_tail"] = out_tail(tails[-1])
            return y
        return sharded_fft

    h2 = 2 * plan.half

    def sharded_poly(iq, state, new_state):
        flat = tuple(x.reshape(-1) for x in iq)
        if flat[0].shape[0] < h2:
            raise ValueError(f"{flat[0].shape[0]} samples a rank: the carry "
                             f"needs {h2}")
        tails = exchange_tails(torch.stack([x[-h2:] for x in flat]), mesh,
                               "resampler")
        local = state if prev < 0 else {"res_carry": tuple(tails[prev])}
        y = resample_local(iq, local, new_state)
        new_state["res_carry"] = tuple(c.clone() for c in tails[-1])
        return y
    return sharded_poly


class ShardedModulator:
    """Runs a Modulator data-parallel over the TF axis of a TfMesh, one
    process a rank.

    Every rank passes the same global batch (T ETI frames, B = T/cif_count
    TFs) and copies only its own T/world frames to its device; the state
    is replicated.  Each call takes the modulator's parameters through its
    _apply_swaps and its gains from its live settings, so update_fir_taps,
    update_dpd and a gain change on the wrapped modulator reach the next
    sharded step (JAX's sharded step bakes them in at its first trace).
    The modulator is not copied or changed: the step passes the sharded
    time interleaver and resampler to its _modulate_impl.

    `compiled` is this rank's GraphStep of _sharded_impl where captures(mesh)
    holds (NCCL on the card), else None and the step runs eagerly.  It is
    the sharded step's own: the modulator's `compiled` holds its unsharded
    graphs, and both key their graphs by batch size.  A failed capture
    raises."""

    def __init__(self, modulator: Modulator, mesh: TfMesh):
        if _indexed(modulator.device) != mesh.device:
            raise ValueError(f"the modulator lies on {modulator.device}, "
                             f"the mesh's rank on {mesh.device}")
        self.m = modulator
        self.mesh = mesh
        self._ti = make_sharded_time_interleave(mesh)
        self._resample = shard_resampler_backend(modulator, mesh)
        self.compiled = (compiled.GraphStep(self._sharded_impl)
                         if captures(mesh) else None)

    def init_state(self):
        return self.m.init_state()

    def _split(self, n_frames: int) -> tuple[int, slice]:
        """(B, this rank's ETI frames) of a batch of n_frames."""
        C = self.m.p.cif_count
        B = n_frames // C
        if n_frames % C or B % self.mesh.world_size:
            raise ValueError(
                f"{n_frames} ETI frames ({n_frames / C:g} TFs of {C} CIFs) "
                f"do not split into whole TFs over {self.mesh.world_size} "
                f"ranks")
        tfs = self.mesh.tf_slice(B)
        return B, slice(tfs.start * C, tfs.stop * C)

    def modulate(self, fic_bytes, subch_bytes, state):
        """One global batch; fic_bytes [T, fic_len] and subch_bytes as
        Modulator.modulate takes them (numpy arrays or tensors), the same
        on every rank.  Returns this rank's TFs of Modulator.modulate's
        output ([B/world, ...], or [2, B/world, S, C] for dexter), the
        replicated new state and this rank's per-TF stats, with
        num_clipped summed over the ranks."""
        m = self.m
        _, frames = self._split(fic_bytes.shape[0])
        fic = m._bytes(fic_bytes[frames])
        subs = tuple(m._bytes(x[frames]) for x in subch_bytes)
        with torch.no_grad():
            if self.compiled is not None:
                return self.compiled.step(m, fic, subs, state)
            return self._sharded_impl(fic, subs, state, *m._gain_args(),
                                      m._apply_swaps())

    def _sharded_impl(self, fic, subs, state, constant_gain: torch.Tensor,
                      var_k: torch.Tensor, rp: dict):
        """This rank's step on its ETI frames (tensors on its device), the
        step a graph captures: the rank's tf_index and mer_index offsets,
        _modulate_impl with the sharded couplings, the replicated new
        state and num_clipped summed over the ranks.  The gains are 0-d
        float32 tensors and rp the FIR taps and DPD coefficients, as
        Modulator._modulate_impl takes them."""
        m, mesh = self.m, self.mesh
        n = fic.shape[0] // m.p.cif_count       # this rank's TFs
        B = n * mesh.world_size
        offset = mesh.rank * n
        S = m.p.nb_symbols + 1
        local = dict(state, tf_index=state["tf_index"] + offset)
        if "mer_index" in state:
            local["mer_index"] = (state["mer_index"] + offset) % S
        out, new, stats = m._modulate_impl(
            fic, subs, local, constant_gain, var_k, rp,
            time_interleave=self._ti, resample=self._resample)
        new["tf_index"] = state["tf_index"] + B
        if "mer_index" in new:
            new["mer_index"] = ((state["mer_index"] + B) % S).to(torch.int32)
        if "num_clipped" in stats:
            stats["num_clipped"] = exchange_tails(
                stats["num_clipped"], mesh, "num_clipped").sum(
                    dtype=torch.int32)
        return out, new, stats

    def gather(self, x, axis: int = 0):
        """The global array of a per-rank output (a tensor or a tuple of
        them, this rank's TFs along `axis`) in TF order, on every rank: one
        exchange_tails of the whole of x, for tests and checks, not for
        the step."""
        if isinstance(x, tuple):
            return tuple(self.gather(p, axis) for p in x)
        return torch.cat(tuple(exchange_tails(x, self.mesh, "gather")),
                         dim=axis)
