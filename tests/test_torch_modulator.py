"""The port's modulator (dabmod_tpu_torch.models.Modulator, on the CPU)
against the reference goldens and against dabmod_tpu.models.Modulator.

Tolerances: the front end is exact (phase-domain integers; atol 4e-6 and
equal phases against the goldens, as tests/test_pipeline.py); f32 output
within 3e-5*max|ref| (tests/test_ofdm_kernel.py:88-89: fp32 transforms and
gain reductions summed in different orders); s16 words within 1 LSB (a
float difference at a truncation edge) with equal clip counts.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dabmod_tpu.config import ModSettings as JSettings
from dabmod_tpu.models import Modulator as JModulator
from dabmod_tpu.models import make_default_layout as j_layout
from dabmod_tpu.ops import fft as jfft
from dabmod_tpu_torch import tables
from dabmod_tpu_torch.config import ModSettings
from dabmod_tpu_torch.eti import (REALISTIC_MUX_SPECS, parse_eti_frames,
                                  synth_eti_batch)
from dabmod_tpu_torch.models import (Modulator, clear_modulator_cache,
                                     get_modulator, make_default_layout,
                                     state_from_numpy)
from dabmod_tpu_torch.ops import cplx, filters
from golden import load
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_SPECS = ((0, 24, 0x22), (48, 48, 0x02))     # bench.py's ensemble
FORMATS = {
    "planes": dict(device_interleave=False),
    "pairs": dict(device_interleave=True),
    "s16": dict(output="file", file_output_format="s16"),
}


@pytest.fixture(autouse=True)
def _restore_jax_precision():
    """JAX modulators built here set dabmod_tpu's module-level FFT
    precision; put its import-time default back for later tests."""
    yield
    jfft.set_precision("high")


def _settings(cls, fmt, **kw):
    return cls(dab_mode=kw.pop("dab_mode", 1), **FORMATS[fmt],
               **kw).normalise_for_output()


def _port(specs=BENCH_SPECS, fmt="planes", mode=1, **kw):
    return Modulator(make_default_layout(mode, specs),
                     _settings(ModSettings, fmt, dab_mode=mode, **kw),
                     device="cpu")


def _jax(specs=BENCH_SPECS, fmt="planes", mode=1, **kw):
    return JModulator(j_layout(mode, specs),
                      _settings(JSettings, fmt, dab_mode=mode, **kw))


def _np(out):
    if isinstance(out, tuple):
        return tuple(np.asarray(x) for x in out)
    return np.asarray(out)


def write_poly_coefs(directory, am=(1.0, 0.1, -0.05, 0.02, -0.01),
                     pm=(0.02, -0.01, 0.005, 0.0, 0.0), name="poly.coef"):
    """A format-1 DPD file (src/MemlessPoly.cpp:110-232), by default with
    the coefficients of tests/test_filters.py:133-134."""
    path = os.path.join(str(directory), name)
    with open(path, "w") as f:
        f.write("1\n5\n" + "".join(f"{v!r}\n" for v in (*am, *pm)))
    return path


def _assert_same_output(got, ref, fmt, got_stats=None, ref_stats=None):
    if fmt == "s16":
        assert got.dtype == np.int32 and got.shape == ref.shape
        d = np.abs(got.view(np.int16).astype(np.int32)
                   - ref.view(np.int16).astype(np.int32)).max()
        assert d <= 1, d
        assert int(got_stats["num_clipped"]) == int(ref_stats["num_clipped"])
        return
    if fmt == "planes":
        got, ref = np.stack(got, -1), np.stack(ref, -1)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=3e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# front end against the goldens
# ---------------------------------------------------------------------------

def _golden_subs(name, n_frames, specs):
    if name == "e2e":
        return (load("e2e_sub0_in").reshape(n_frames, -1),
                load("e2e_sub1_in").reshape(n_frames, -1))
    frames = load("e2e_real_sub_in").reshape(n_frames, -1)
    offs = np.cumsum([0] + [stl * 8 for _, stl, _ in specs])
    return tuple(frames[:, offs[i]:offs[i + 1]] for i in range(len(specs)))


@pytest.mark.parametrize("name,specs,n_frames,n_tf", [
    ("e2e", BENCH_SPECS, 8, 2),
    ("e2e_real", REALISTIC_MUX_SPECS, 16, 4)])
def test_frontend_matches_reference_goldens(name, specs, n_frames, n_tf):
    m = _port(specs)
    fic = load(f"{name}_fic_in").reshape(n_frames, 96)
    expect = load(f"{name}_symbols").reshape(n_tf, 76, 1536)
    syms, hist = m.frontend(fic, _golden_subs(name, n_frames, specs),
                            m.init_state()["ti_history"])
    got = cplx.planes_to_complex(syms)
    assert got.shape == expect.shape and len(hist) == len(specs)
    np.testing.assert_allclose(got, expect, atol=4e-6)
    np.testing.assert_array_equal(np.angle(got).round(3),
                                  np.angle(expect).round(3))


@pytest.mark.parametrize("mode", [2, 3, 4])
def test_frontend_matches_reference_other_modes(mode):
    m = _port(((0, 24, 0x22),), mode=mode)
    p = tables.mode_params(mode)
    n = 2 * p.cif_count
    syms, _ = m.frontend(load(f"e2e_m{mode}_fic_in").reshape(n, p.fic_size_in),
                         (load(f"e2e_m{mode}_sub_in").reshape(n, -1),),
                         m.init_state()["ti_history"])
    expect = load(f"e2e_m{mode}_symbols").reshape(2, p.nb_symbols,
                                                  p.nb_carriers)
    np.testing.assert_allclose(cplx.planes_to_complex(syms), expect,
                               atol=4e-6)


# ---------------------------------------------------------------------------
# the whole modulate against dabmod_tpu
# ---------------------------------------------------------------------------

def test_tables_match_reference_modulator():
    m = _port(REALISTIC_MUX_SPECS)
    mj = _jax(REALISTIC_MUX_SPECS)
    for name in ("_inv_perm", "_ref_q_pre", "_bin_src_pre", "_bin_valid"):
        np.testing.assert_array_equal(getattr(m, name),
                                      np.asarray(getattr(mj, name)))
    assert m._subch_ti_bits == [int(x.shape[1]) for x in mj._subch_masks]
    assert m._subch_offsets == mj._subch_offsets


@pytest.mark.parametrize("backend,fmt", [
    ("xla", "planes"), ("xla", "pairs"), ("xla", "s16"),
    ("pallas-interpret", "planes")])
def test_modulate_matches_reference(backend, fmt):
    """bench.py's layout at batch_tf=2 (8 ETI frames), every output format
    of the main path.  The wire format does not depend on which OFDM
    backend ran, so the Pallas kernel (interpreted) is held against the
    planes only."""
    b = parse_eti_frames(synth_eti_batch(8, mode=1, subch_specs=BENCH_SPECS,
                                         seed=5))
    mj = _jax(fmt=fmt, ofdm_backend=backend, fft_precision="highest")
    ref, ref_state, ref_stats = mj.modulate(b.fic, tuple(b.subchannels),
                                            mj.init_state())
    m = _port(fmt=fmt, fft_precision="highest")
    got, state, stats = m.modulate_eti(b, m.init_state())
    assert set(stats) == set(ref_stats)
    _assert_same_output(_np(got), _np(ref), fmt, stats, ref_stats)
    assert int(state["tf_index"]) == int(ref_state["tf_index"]) == 2
    for h, hj in zip(state["ti_history"], ref_state["ti_history"]):
        np.testing.assert_array_equal(h.numpy(), np.asarray(hj))


@pytest.mark.parametrize("mode", [2, 3, 4])
def test_modulate_other_modes_match_reference(mode):
    p = tables.mode_params(mode)
    specs = ((0, 24, 0x22),)
    b = parse_eti_frames(synth_eti_batch(2 * p.cif_count, mode=mode,
                                         subch_specs=specs, seed=mode))
    mj = _jax(specs, mode=mode, ofdm_backend="xla", fft_precision="highest")
    ref, _, _ = mj.modulate(b.fic, tuple(b.subchannels), mj.init_state())
    m = _port(specs, mode=mode)
    got, _, _ = m.modulate_eti(b, m.init_state())
    assert got[0].shape == (2, p.tf_samples)
    _assert_same_output(_np(got), _np(ref), "planes")


def test_state_carried_over_from_reference():
    """JAX modulates the first batch; its state, through state_from_numpy,
    lets the port modulate the second batch exactly as JAX does."""
    raw = synth_eti_batch(16, mode=1, subch_specs=BENCH_SPECS, seed=9)
    b1, b2 = parse_eti_frames(raw[:8]), parse_eti_frames(raw[8:])
    mj = _jax(ofdm_backend="xla", fft_precision="highest")
    _, sj, _ = mj.modulate(b1.fic, tuple(b1.subchannels), mj.init_state())
    sj_np = {"ti_history": tuple(np.asarray(h) for h in sj["ti_history"]),
             "tf_index": np.asarray(sj["tf_index"])}
    ref2, sj2, _ = mj.modulate(b2.fic, tuple(b2.subchannels), sj)

    m = _port()
    state = state_from_numpy(sj_np, "cpu")
    assert state["ti_history"][0].dtype == torch.uint8
    got2, state2, _ = m.modulate_eti(b2, state)
    _assert_same_output(_np(got2), _np(ref2), "planes")
    assert int(state2["tf_index"]) == int(sj2["tf_index"]) == 4
    for h, hj in zip(state2["ti_history"], sj2["ti_history"]):
        np.testing.assert_array_equal(h.numpy(), np.asarray(hj))


def test_one_batch_equals_two_batches():
    """4 TFs in one batch == 2 + 2 TFs with the state carried."""
    raw = synth_eti_batch(16, mode=1, subch_specs=BENCH_SPECS, seed=2)
    m = _port()
    full, _, _ = m.modulate_eti(parse_eti_frames(raw), m.init_state())
    st = m.init_state()
    a, st, _ = m.modulate_eti(parse_eti_frames(raw[:8]), st)
    b, st, _ = m.modulate_eti(parse_eti_frames(raw[8:]), st)
    for k in range(2):
        got = torch.cat([a[k], b[k]]).numpy()
        np.testing.assert_allclose(got, full[k].numpy(),
                                   atol=3e-5 * float(full[k].abs().max()))
    assert int(st["tf_index"]) == 4


def test_output_contracts():
    b = parse_eti_frames(synth_eti_batch(4, mode=1, seed=1))
    n = tables.mode_params(1).tf_samples
    specs = ((0, 24, 0x22),)
    out, _, stats = _port(specs, "planes").modulate_eti(
        b, _port(specs).init_state())
    assert isinstance(out, tuple) and out[0].shape == (1, n) and stats == {}
    out, _, _ = _port(specs, "pairs").modulate_eti(b, _port(specs).init_state())
    assert out.shape == (1, n, 2) and out.dtype == torch.float32
    out, _, stats = _port(specs, "s16").modulate_eti(
        b, _port(specs).init_state())
    assert out.shape == (1, n) and out.dtype == torch.int32
    assert stats["num_clipped"].dtype == torch.int32
    with pytest.raises(ValueError, match="multiple"):
        _port(specs).modulate(b.fic[:3], (b.subchannels[0][:3],),
                              _port(specs).init_state())


# ---------------------------------------------------------------------------
# CFR and the polyphase resampler against dabmod_tpu
# ---------------------------------------------------------------------------

# the repo's documented CFR settings (doc/example.ini:56-59)
CFR = dict(enable_cfr=True, cfr_clip=40.0, cfr_error_clip=3.0)
# where the error clip acts (tests/test_quality.py:151-154); the error clip
# of 3.0 above never does
CFR_ERR = dict(enable_cfr=True, cfr_clip=30.0, cfr_error_clip=0.1)
PATHS = {"cfr": CFR, "8m192": dict(output_rate=8_192_000),
         "cfr_8m192": dict(CFR, output_rate=8_192_000),
         # L/M = 3/2 and 1/2: the kernel's M > 1 indexing
         "cfr30_3m072": dict(CFR_ERR, output_rate=3_072_000),
         "1m024_poly": dict(output_rate=1_024_000, resampler_mode="poly")}
# dabmod_tpu's XLA resampler frames 32 samples, too few for the 64-sample
# carry of L/M = 1/2: only its kernels (here interpreted) decimate by poly
JAX_BACKEND = {"1m024_poly": "pallas-interpret"}
# at this seed the plain transforms and dabmod_tpu's decide every sample
# near the clip threshold alike, so the clip counts are equal
CFR_SEED = 2


def _assert_same_stats(got, ref):
    assert set(got) == set(ref)
    for k in ("cfr_clip", "cfr_errclip", "mer_valid", "num_clipped"):
        if k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    for k, atol in (("papr_before_cfr", 1e-3), ("papr_after_cfr", 1e-3),
                    ("mer_db", 0.1)):
        if k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       atol=atol)


def _flat(out, fmt, n_tf=2):
    """dabmod_tpu's resampled output keeps its kernel's [rows, 128*L/M]
    shape on some backends; the flat stream per TF is what both packages
    define."""
    if fmt == "planes":
        return tuple(np.asarray(x).reshape(n_tf, -1) for x in out)
    return np.asarray(out)


@pytest.mark.parametrize("fmt", ["planes", "s16"])
@pytest.mark.parametrize("path", list(PATHS))
def test_cfr_and_resampler_match_reference(path, fmt):
    """bench.py's layout, 2 TFs a batch, two batches with the state
    (mer_index, res_carry) carried, against dabmod_tpu's XLA path."""
    raw = synth_eti_batch(16, mode=1, subch_specs=BENCH_SPECS, seed=CFR_SEED)
    batches = [parse_eti_frames(raw[:8]), parse_eti_frames(raw[8:])]
    mj = _jax(fmt=fmt, ofdm_backend=JAX_BACKEND.get(path, "xla"),
              fft_precision="highest", **PATHS[path])
    m = _port(fmt=fmt, fft_precision="highest", **PATHS[path])
    sj, st = mj.init_state(), m.init_state()
    assert set(st) == set(sj)
    for b in batches:
        ref, sj, ref_stats = mj.modulate(b.fic, tuple(b.subchannels), sj)
        got, st, stats = m.modulate_eti(b, st)
        _assert_same_output(_np(got), _flat(ref, fmt), fmt, stats,
                            ref_stats)
        _assert_same_stats(stats, ref_stats)
        if PATHS[path].get("cfr_error_clip") == CFR_ERR["cfr_error_clip"]:
            # the error clip acts and MER leaves its 90 dB clamp
            assert stats["cfr_errclip"].min() > 0
            assert stats["mer_db"][stats["mer_valid"]].max() < 90.0
    assert int(st["tf_index"]) == int(sj["tf_index"]) == 4
    if "mer_index" in sj:
        assert int(st["mer_index"]) == int(sj["mer_index"]) == 4
    if "res_carry" in sj:
        for g, r in zip(st["res_carry"], sj["res_carry"]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       atol=3e-5 * float(np.abs(r).max()))


def test_cfr_resampler_state_carried_over_from_reference():
    """JAX modulates the first batch with CFR and the resampler; its state
    (mer_index, res_carry included) lets the port modulate the second."""
    raw = synth_eti_batch(16, mode=1, subch_specs=BENCH_SPECS, seed=CFR_SEED)
    b1, b2 = parse_eti_frames(raw[:8]), parse_eti_frames(raw[8:])
    kw = PATHS["cfr_8m192"]
    mj = _jax(ofdm_backend="xla", fft_precision="highest", **kw)
    _, sj, _ = mj.modulate(b1.fic, tuple(b1.subchannels), mj.init_state())
    sj_np = {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                 else np.asarray(v)) for k, v in sj.items()}
    ref2, sj2, ref_stats = mj.modulate(b2.fic, tuple(b2.subchannels), sj)

    m = _port(fft_precision="highest", **kw)
    state = state_from_numpy(sj_np, "cpu")
    assert int(state["mer_index"]) == 2
    assert state["res_carry"][0].dtype == torch.float32
    got2, state2, stats = m.modulate_eti(b2, state)
    _assert_same_output(_np(got2), _flat(ref2, "planes"), "planes")
    _assert_same_stats(stats, ref_stats)
    assert int(state2["mer_index"]) == int(sj2["mer_index"])


def test_resampled_output_contracts():
    b = parse_eti_frames(synth_eti_batch(4, mode=1, seed=1))
    specs = ((0, 24, 0x22),)
    for rate, L in ((4_096_000, 2), (8_192_000, 4)):
        m = _port(specs, "pairs", output_rate=rate, **CFR)
        n = tables.mode_params(1).tf_samples * L
        assert m.tf_samples_out == n
        state = m.init_state()
        assert state["mer_index"].dtype == torch.int32
        assert state["res_carry"][0].shape == (32,)
        out, state, stats = m.modulate_eti(b, state)
        assert out.shape == (1, n, 2) and out.dtype == torch.float32
        assert stats["cfr_clip"].dtype == torch.int32
        assert stats["mer_valid"].dtype == torch.bool
        assert stats["mer_db"].shape == (1,)
        assert int(state["mer_index"]) == 1
    assert _port(specs).tf_samples_out == tables.mode_params(1).tf_samples


# ---------------------------------------------------------------------------
# device rule, unsupported settings, isolation from JAX
# ---------------------------------------------------------------------------

def test_default_device_is_cuda():
    layout = make_default_layout(1)
    if torch.cuda.is_available():
        assert Modulator(layout).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Modulator(layout)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Modulator(layout, device="cuda")
    assert Modulator(layout, device="cpu").device.type == "cpu"


# the inputs and outputs of ROADMAP A10(b), which raised NotImplementedError
# until they were ported: each now runs, and matches dabmod_tpu
A10B_SETTINGS = [
    {"input_transport": "tcp", "input_name": "{tcp}"},
    {"input_transport": "zmq", "input_name": "{eti}"},     # read as a file
    {"input_transport": "edi", "input_name": "udp://127.0.0.1:0"},
    {"input_name": "tcp://{tcp}"},
    *({"output": out} for out in ("zmq", "uhd", "soapy", "lime", "bladerf",
                                  "dexter", "loopback")),
]
A10B_IDS = ["tcp", "zmq_input", "edi_udp", "tcp_uri", "zmq", "uhd", "soapy",
            "lime", "bladerf", "dexter", "loopback"]


def _a10b_packages():
    from dabmod_tpu import runtime as j_runtime
    from dabmod_tpu.io import (bladerf_driver, dexter_driver, lime_driver,
                               sdr, soapy_driver, uhd_driver)
    from dabmod_tpu.rc import rcs as j_rcs
    from dabmod_tpu_torch import runtime as t_runtime
    from dabmod_tpu_torch.io import bladerf_driver as t_bladerf
    from dabmod_tpu_torch.io import dexter_driver as t_dexter
    from dabmod_tpu_torch.io import lime_driver as t_lime
    from dabmod_tpu_torch.io import sdr as t_sdr
    from dabmod_tpu_torch.io import soapy_driver as t_soapy
    from dabmod_tpu_torch.io import uhd_driver as t_uhd
    from dabmod_tpu_torch.rc import rcs as t_rcs
    j = dict(Settings=JSettings, runtime=lambda s: j_runtime.ModRuntime(s),
             rcs=j_rcs, sdr=sdr, uhd=uhd_driver, soapy=soapy_driver,
             lime=lime_driver, bladerf=bladerf_driver, dexter=dexter_driver)
    t = dict(Settings=ModSettings,
             runtime=lambda s: t_runtime.ModRuntime(s, device="cpu"),
             rcs=t_rcs, sdr=t_sdr, uhd=t_uhd, soapy=t_soapy, lime=t_lime,
             bladerf=t_bladerf, dexter=t_dexter)
    return {"jax": j, "torch": t}


def _fake_vendor(pkg, output, monkeypatch):
    """The vendor module of an SDR output faked (the drivers' own tests'
    fakes), and the package's driver class loaded over it."""
    from test_soapy_driver import make_mock
    from test_uhd_driver import FakeClock, make_fake_uhd
    from test_vendor_drivers import FakeClock as IioClock
    from test_vendor_drivers import (MockBladeRFModule, MockIioModule,
                                     MockLms)
    fakes = {"uhd": ("uhd", lambda: make_fake_uhd(FakeClock())[0]),
             "soapy": ("SoapySDR", make_mock),
             "bladerf": ("bladerf", MockBladeRFModule),
             "dexter": ("iio", lambda: MockIioModule(IioClock()))}
    if output == "lime":
        monkeypatch.setattr(pkg["lime"], "_load_lms_api", MockLms)
    else:
        name, make = fakes[output]
        monkeypatch.setitem(sys.modules, name, make())
    cls = {"uhd": "UhdDevice", "soapy": "SoapyDevice", "lime": "LimeDevice",
           "bladerf": "BladeRFDevice", "dexter": "DexterDevice"}[output]
    monkeypatch.setattr(pkg["sdr"], cls, getattr(pkg[output], cls))


def _a10b_run(pkg, kw, frames, tmp_path, monkeypatch):
    """One package's runtime on the setting: (the TFs the sink or the SDR
    device got, as (fct, timestamp fields, array), the SDR counters and
    `sdr` RC values, or None)."""
    import threading
    from live_stream import (TcpServer, drive, edi_stream, record_sink,
                             record_transmit, send_udp)
    eti = tmp_path / "in.eti"
    eti.write_bytes(frames.tobytes())
    srv = TcpServer(frames.tobytes())
    kw = {k: (v.format(tcp=f"127.0.0.1:{srv.port}", eti=eti)
              if isinstance(v, str) else v) for k, v in kw.items()}
    out = kw.get("output", "file")
    s = pkg["Settings"](**{"input_name": str(eti), "output": "file",
                           "output_name": str(tmp_path / "out.iq"),
                           "file_output_format": "s16", "batch_tf": 2,
                           "tcp_timeout": 0.3, **kw})
    if out == "zmq":
        # the sink binds a port the system picks (read back below): a port
        # picked here and bound later could be taken in between by another
        # test process
        s.output_name = "tcp://127.0.0.1:*"
        s.zmq_output_socket_type = "rep"
    if out not in ("file", "zmq", "loopback"):
        _fake_vendor(pkg, out, monkeypatch)
    rt = pkg["runtime"](s.normalise_for_output())
    received = []
    if out in ("file", "zmq"):
        calls, tfs = record_sink(rt.output), []
    else:
        tfs = record_transmit(rt.output.device)
    before = None
    if s.input_name.startswith("udp://"):
        udp = rt.reader.transport.sock.getsockname()[1]
        before = threading.Thread(target=send_udp, daemon=True, args=(
            udp, edi_stream(frames, 1_800_000_000.0))).start
    if out == "zmq":
        import zmq
        endpoint = rt.output.sock.getsockopt_string(zmq.LAST_ENDPOINT)

        def consumer():
            sock = zmq.Context.instance().socket(zmq.REQ)
            sock.connect(endpoint)
            sock.setsockopt(zmq.RCVTIMEO, 10000)
            sock.setsockopt(zmq.LINGER, 0)
            try:
                for _ in range(2):
                    sock.send(b"")
                    received.append(sock.recv())
            finally:
                sock.close()
        reader = threading.Thread(target=consumer, daemon=True)
        before = reader.start
    try:
        if getattr(rt.reader, "never_eof", False):
            assert drive(rt, 16, deadline_s=30, before=before) == 0
        else:
            if before is not None:
                before()
            assert rt.run() == 0
    finally:
        rt.close()
        srv.close()
    assert rt.framecount == 16
    sdr_state = None
    if out in ("file", "zmq"):
        for arr, meta in calls:
            tfs += [(f, ts, arr[i]) for i, (f, ts) in enumerate(meta)]
        if out == "zmq":
            # the consumer takes the last reply after the sink has sent it,
            # and may not have it yet when the runtime has stopped
            reader.join(timeout=10)
            assert not reader.is_alive()
            assert len(b"".join(received)) == sum(
                a.nbytes for _, _, a in tfs)
    else:
        counters = {k: getattr(rt.output, k) for k in (
            "frames", "queue_overflows", "dropped", "muted", "underruns")}
        # the device's own clock, and the port's queue wait (a time, which
        # dabmod_tpu does not report)
        rc = dict((n, v) for n, v in pkg["rcs"].show("sdr")
                  if n not in ("device_time", "queue_wait_s"))
        sdr_state = (counters, rc)
    return tfs, sdr_state


@pytest.mark.parametrize("kw", A10B_SETTINGS, ids=A10B_IDS)
def test_a10b_settings_match_reference(kw, tmp_path, monkeypatch):
    """The runtime on each A10(b) input and output, 16 ETI frames (4 TFs,
    batch_tf=2), the port on the CPU against dabmod_tpu: the same TFs
    handed to the sink or transmitted by the SDR device, with the same
    FCTs and timestamps (s16 within 1 LSB, f32 within 3e-5*max|ref|), the
    same SDR counters and `sdr` RC values.  The SDR drivers run over the
    fakes of their own tests."""
    frames = synth_eti_batch(16, mode=1, subch_specs=BENCH_SPECS, seed=23)
    res = {}
    try:
        for which, pkg in _a10b_packages().items():
            res[which] = _a10b_run(pkg, kw, frames, tmp_path, monkeypatch)
    finally:
        for pkg in _a10b_packages().values():
            pkg["rcs"].shutdown()
    got, ref = res["torch"][0], res["jax"][0]
    assert [(f, ts) for f, ts, _ in got] == [(f, ts) for f, ts, _ in ref]
    assert [f for f, _, _ in got] == [0, 4, 8, 12]
    for (_, _, g), (_, _, r) in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        if np.issubdtype(g.dtype, np.integer):
            d = np.abs(g.view(np.int16).astype(np.int32) - r.view(np.int16))
            assert d.max() <= 1
        else:
            np.testing.assert_allclose(g, r, atol=3e-5 * np.abs(r).max())
    assert res["torch"][1] == res["jax"][1]


# fft_engine=kiss|dexter, which raised NotImplementedError until ROADMAP A9
# was ported: each now runs, and matches dabmod_tpu bit for bit
A9_SETTINGS = [{"fft_engine": "kiss"}, {"fft_engine": "dexter"}]


@pytest.mark.usefixtures("one_intra_op_thread")
@pytest.mark.parametrize("kw", A9_SETTINGS)
def test_a9_settings_match_reference(kw):
    b = parse_eti_frames(synth_eti_batch(8, mode=1, subch_specs=BENCH_SPECS,
                                         seed=22))
    mj = _jax(**kw)
    ref, ref_state, ref_stats = mj.modulate(b.fic, tuple(b.subchannels),
                                            mj.init_state())
    m = _port(**kw)
    got, state, stats = m.modulate_eti(b, m.init_state())
    assert set(state) == set(ref_state) and set(stats) == set(ref_stats)
    assert m.emits_planes == mj.emits_planes is False
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# the settings that raised NotImplementedError until ROADMAP A7 and A8
# were ported: each now runs, and matches dabmod_tpu
A7_A8_SETTINGS = [
    {"output_rate": 1_024_000},                       # auto: fft below 2.048
    {"tii_enable": True},
    {"output_rate": 4_096_000, "resampler_mode": "fft"},
    {"output_rate": 2_500_000},                       # poly, not K3's plan
    {"cic_eq_clock_rate": 32_768_000},
    {"filter_taps_file": "default"},
    {"poly_coef_file": "poly.coef", "output": "uhd"},
    {"ofdm_window_overlap": 10},
    {"output": "file", "file_output_format": "u8"},
    {"output": "zmq", "zmq_output_format": "s8"},
]


def _assert_same_narrow(got, ref, fmt, got_stats, ref_stats):
    """u8/s8 int32 words [B, N/2]: each byte within 1 LSB (a float
    difference at a truncation edge), equal clip counts."""
    got, ref = _np(got), _np(ref)
    assert got.dtype == np.int32 and got.shape == ref.shape
    byte = {"u8": np.uint8, "s8": np.int8}[fmt]
    d = np.abs(got.view(byte).astype(np.int32)
               - ref.view(byte).astype(np.int32)).max()
    assert d <= 1, d
    assert int(got_stats["num_clipped"]) == int(ref_stats["num_clipped"])


@pytest.mark.parametrize("kw", A7_A8_SETTINGS)
def test_a7_a8_settings_match_reference(kw, tmp_path):
    """bench.py's layout, 2 TFs, against dabmod_tpu's XLA path: f32 within
    3e-5*max|ref| (1e-4*max|ref| after the poly DPD), the integer wire
    within 1 LSB with equal clip counts, and the same state keys."""
    kw = dict(kw)
    if "poly_coef_file" in kw:
        kw["poly_coef_file"] = write_poly_coefs(tmp_path)
    b = parse_eti_frames(synth_eti_batch(8, mode=1, subch_specs=BENCH_SPECS,
                                         seed=21))
    mj = _jax(**kw, ofdm_backend="xla", fft_precision="highest")
    ref, ref_state, ref_stats = mj.modulate(b.fic, tuple(b.subchannels),
                                            mj.init_state())
    m = _port(**kw, fft_precision="highest")
    got, state, stats = m.modulate_eti(b, m.init_state())
    assert set(state) == set(ref_state) and set(stats) == set(ref_stats)
    if m._wire_fmt is not None:
        _assert_same_narrow(got, ref, m._wire_fmt, stats, ref_stats)
        return
    tol = 1e-4 if "poly_coef_file" in kw else 3e-5
    got, ref = np.stack(_np(got), -1), np.stack(_flat(ref, "planes"), -1)
    assert got.shape == (2, m.tf_samples_out, 2) == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max())


def test_inactive_cic_rate_is_accepted():
    """dabmod_tpu builds no CIC taps when the ratio rule turns them off
    (400 MHz master clock, even ratio), so neither does the port."""
    m = Modulator(make_default_layout(1),
                  ModSettings(dab_mode=1, cic_eq_clock_rate=400_000_000),
                  device="cpu")
    assert m.device.type == "cpu"


# the modules the runtime, the fixed-point engines, the DPD control plane
# and the sharded step brought in
PORT_MODULES = ["dabmod_tpu_torch." + m for m in (
    "runtime", "cli", "config", "io.readers", "io.outputs",
    "io.fic_decoder", "io.dexter_fft", "rc", "events", "timestamps",
    "utils", "ops.kiss_fixed", "io.rs", "io.edi", "io.sdr",
    "io.uhd_driver", "io.soapy_driver", "io.lime_driver",
    "io.bladerf_driver", "io.dexter_driver", "utils.racecheck",
    "rc.client", "rc.yamlrpc", "dpd", "dpd.adapt", "dpd.agc", "dpd.align",
    "dpd.dpdce", "dpd.extract_statistic", "dpd.globalconfig",
    "dpd.heuristics", "dpd.measure", "dpd.mer", "dpd.model_lut",
    "dpd.model_poly", "dpd.server", "dpd.shoulders", "gui", "parallel",
    "parallel.sharding", "parallel.launch", "native")]


def test_port_imports_no_jax():
    """Importing every module of dabmod_tpu_torch loads neither jax nor
    any module of dabmod_tpu, nor zmq or yaml (the card's machine has
    neither: the ZeroMQ sink, the RC's ZeroMQ server and its client
    import zmq when they start, and yamlrpc imports yaml where it
    encodes and parses)."""
    code = (
        "import pkgutil, sys, importlib, dabmod_tpu_torch\n"
        "mods = [importlib.import_module(m.name) for m in pkgutil."
        "walk_packages(dabmod_tpu_torch.__path__, 'dabmod_tpu_torch.')]\n"
        "assert len(mods) >= 56, mods\n"
        f"missing = set({PORT_MODULES!r}) - set(m.__name__ for m in mods)\n"
        "assert not missing, missing\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'zmq', "
        "'yaml', 'dabmod_tpu') or m.startswith(('jax.', 'zmq.', 'yaml.', "
        "'dabmod_tpu.')))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# TII, the windowed guard interval in TM II-IV, the narrow wire formats
# ---------------------------------------------------------------------------

TII = dict(tii_enable=True, tii_comb=5, tii_pattern=31)    # the goldens'


def test_tii_in_the_null_symbol_of_even_tfs():
    """The NULL symbol of TF k carries the TII symbol when the state's
    tf_index + k is even, and is silent otherwise."""
    b = parse_eti_frames(synth_eti_batch(12, mode=1, seed=3))
    m = _port(((0, 24, 0x22),), **TII)
    expect = tables.tii_symbol(1, 5, 31)
    assert np.abs(expect).sum() > 0
    for start in (0, 1, 6):
        syms, _ = m.ofdm_symbols(b.fic, b.subchannels,
                                 m.init_state()["ti_history"],
                                 torch.tensor(start, dtype=torch.int32))
        null = cplx.planes_to_complex(tuple(x[:, 0] for x in syms))
        null = null[:, m._inv_perm]                  # carrier order
        for k in range(3):
            want = expect if (start + k) % 2 == 0 else 0 * expect
            np.testing.assert_array_equal(null[k], want)


def test_tii_one_batch_equals_two_half_batches():
    """4 TFs in one batch == 1 + 3 TFs with the state carried: the second
    batch starts at an odd TF index."""
    raw = synth_eti_batch(16, mode=1, subch_specs=BENCH_SPECS, seed=11)
    m = _port(**TII)
    full, _, _ = m.modulate_eti(parse_eti_frames(raw), m.init_state())
    st = m.init_state()
    a, st, _ = m.modulate_eti(parse_eti_frames(raw[:4]), st)
    b, st, _ = m.modulate_eti(parse_eti_frames(raw[4:]), st)
    assert int(st["tf_index"]) == 4
    for k in range(2):
        np.testing.assert_array_equal(torch.cat([a[k], b[k]]).numpy(),
                                      full[k].numpy())


@pytest.mark.parametrize("mode", [3, 4])
def test_tii_outside_modes_1_and_2_raises(mode):
    with pytest.raises(ValueError, match="mode"):
        _port(((0, 24, 0x22),), mode=mode, **TII)
    with pytest.raises(ValueError, match="mode"):
        _jax(((0, 24, 0x22),), mode=mode, **TII)


@pytest.mark.parametrize("mode,kw", [
    (2, dict(TII, tii_old_variant=True)),
    (2, dict(ofdm_window_overlap=90)), (3, dict(ofdm_window_overlap=10)),
    (3, dict(ofdm_window_overlap=63)), (4, dict(ofdm_window_overlap=90))])
def test_other_modes_match_reference(mode, kw):
    """TII's old variant in TM II, and the windowed guard interval in TM
    II-IV up to the whole guard interval (63 samples in TM III)."""
    p = tables.mode_params(mode)
    specs = ((0, 24, 0x22),)
    b = parse_eti_frames(synth_eti_batch(2 * p.cif_count, mode=mode,
                                         subch_specs=specs, seed=mode))
    mj = _jax(specs, mode=mode, ofdm_backend="xla", fft_precision="highest",
              **kw)
    ref, _, _ = mj.modulate(b.fic, tuple(b.subchannels), mj.init_state())
    m = _port(specs, mode=mode, **kw)
    got, _, _ = m.modulate_eti(b, m.init_state())
    _assert_same_output(_np(got), _np(ref), "planes")


def test_window_overlap_beyond_the_guard_interval_raises():
    """TM III's guard interval is 63 samples: a longer overlap is refused
    when the modulator is built (dabmod_tpu fails in its first modulate)."""
    with pytest.raises(ValueError, match="guard interval"):
        _port(((0, 24, 0x22),), mode=3, ofdm_window_overlap=90)


@pytest.mark.parametrize("sink", ["file", "zmq"])
@pytest.mark.parametrize("fmt", ["u8", "s8"])
def test_narrow_wire_formats_clip_like_reference(fmt, sink):
    """A digital gain of 3 drives the u8/s8 wire into saturation: the
    bytes within 1 LSB and the clip counts equal to dabmod_tpu's."""
    kw = {"output": sink, f"{sink}_output_format": fmt, "digital_gain": 3.0}
    b = parse_eti_frames(synth_eti_batch(8, mode=1, subch_specs=BENCH_SPECS,
                                         seed=12))
    mj = _jax(ofdm_backend="xla", fft_precision="highest", **kw)
    ref, _, ref_stats = mj.modulate(b.fic, tuple(b.subchannels),
                                    mj.init_state())
    m = _port(fft_precision="highest", **kw)
    got, _, stats = m.modulate_eti(b, m.init_state())
    assert got.shape == (2, tables.mode_params(1).tf_samples // 2)
    _assert_same_narrow(got, ref, fmt, stats, ref_stats)
    assert int(stats["num_clipped"]) > 0


@pytest.mark.parametrize("sink", ["bladerf", "dexter"])
def test_sc16_sinks_always_take_s16(sink):
    m = _port(((0, 24, 0x22),), output=sink, file_output_format="u8")
    assert m._wire_fmt == "s16"


# ---------------------------------------------------------------------------
# DPD, the whole chain that feeds it
# ---------------------------------------------------------------------------

LUT = (np.linspace(1.0, 0.9, 32) + 1j * np.linspace(0, 0.05, 32)
       ).astype(np.complex64)          # tests/test_filters.py:151-153


def write_lut(directory, lut=LUT, scale=2.0 ** 31, name="lut.coef"):
    """A format-2 DPD file: the scale factor, then 32 (re, im) entries."""
    path = os.path.join(str(directory), name)
    with open(path, "w") as f:
        f.write(f"2\n{scale!r}\n" + "".join(
            f"{float(v.real)!r}\n{float(v.imag)!r}\n" for v in lut))
    return path


def test_dpd_lut_matches_reference(tmp_path):
    """The LUT DPD at the UHD scale: each sample as dabmod_tpu computes it
    (f32 tolerance), except samples within 1e-6 (relative) of a LUT bin
    edge, which may take the neighbouring entry (one sample at this
    seed)."""
    b = parse_eti_frames(synth_eti_batch(8, mode=1, subch_specs=BENCH_SPECS,
                                         seed=3))
    kw = dict(output="uhd", poly_coef_file=write_lut(tmp_path))
    mj = _jax(ofdm_backend="xla", fft_precision="highest", **kw)
    ref, _, _ = mj.modulate(b.fic, tuple(b.subchannels), mj.init_state())
    m = _port(fft_precision="highest", **kw)
    got, _, _ = m.modulate_eti(b, m.init_state())
    plain = _port(fft_precision="highest", output="uhd")
    x, _, _ = plain.modulate_eti(b, plain.init_state())
    scale = m._runtime_params["lut_scale"]
    edge = filters.lut_edge_samples(x, scale).numpy()
    bins = filters.lut_index(x, scale).numpy()
    got, ref = np.stack(_np(got), -1), np.stack(_np(ref), -1)
    far = np.abs(got - ref).max(axis=-1) > 3e-5 * np.abs(ref).max()
    print(f"{int(edge.sum())} samples within 1e-6 of a LUT bin edge, "
          f"{int(far.sum())} differ beyond the f32 tolerance")
    assert not (far & ~edge).any()
    assert len(np.unique(bins)) > 8


def test_dpd_chain_matches_reference(tmp_path):
    """The chain that feeds DPD (the benchmark's r17_dpd8m192 at 2 TFs a
    batch, bench.py's layout): TII, CFR 40/3, the windowed guard
    interval (overlap 90), the default FIR, 8.192 MS/s through K3's plan
    and the poly DPD at the UHD scale; two batches with the state carried,
    the statistics and the state as dabmod_tpu's."""
    kw = dict(CFR, **TII, ofdm_window_overlap=90, filter_taps_file="default",
              output_rate=8_192_000, output="uhd",
              poly_coef_file=write_poly_coefs(tmp_path))
    raw = synth_eti_batch(16, mode=1, subch_specs=BENCH_SPECS, seed=CFR_SEED)
    mj = _jax(ofdm_backend="xla", fft_precision="highest", **kw)
    m = _port(fft_precision="highest", **kw)
    sj, st = mj.init_state(), m.init_state()
    for b in (parse_eti_frames(raw[:8]), parse_eti_frames(raw[8:])):
        ref, sj, ref_stats = mj.modulate(b.fic, tuple(b.subchannels), sj)
        got, st, stats = m.modulate_eti(b, st)
        got, ref = np.stack(_np(got), -1), np.stack(_flat(ref, "planes"), -1)
        assert got.shape == (2, 4 * tables.mode_params(1).tf_samples, 2)
        np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())
        _assert_same_stats(stats, ref_stats)
    for g, r in zip(st["res_carry"], sj["res_carry"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=3e-5 * float(np.abs(r).max()))


# ---------------------------------------------------------------------------
# hot swap and the modulator cache
# ---------------------------------------------------------------------------

def _write_taps(directory, taps, name="taps.txt"):
    path = os.path.join(str(directory), name)
    with open(path, "w") as f:
        f.write(f"{len(taps)}\n" + "\n".join(f"{t!r}" for t in taps))
    return path


TAPS1 = [0.1, 0.5, 0.8, 0.5, 0.1]
TAPS2 = [0.2, 0.4, 0.9, 0.4, 0.2]
AM2, PM2 = (0.9, 0.01, 0.0, 0.0, 0.0), (0.05, 0.0, 0.0, 0.0, 0.0)


def test_hot_swap_equals_a_fresh_modulator(tmp_path):
    """New FIR taps and poly coefficients swapped in between two batches
    give what a modulator built with them gives; a change of tap count or
    DPD kind is refused (False) and changes nothing."""
    raw = synth_eti_batch(16, mode=1, subch_specs=BENCH_SPECS, seed=14)
    b1, b2 = parse_eti_frames(raw[:8]), parse_eti_frames(raw[8:])
    kw = dict(output="uhd", filter_taps_file=_write_taps(tmp_path, TAPS1),
              poly_coef_file=write_poly_coefs(tmp_path))
    m = _port(**kw)
    out1, st, _ = m.modulate_eti(b1, m.init_state())
    assert m.update_fir_taps(np.asarray(TAPS2, np.float32))
    assert m.update_dpd("poly", (np.asarray(AM2), np.asarray(PM2)))
    assert not m.update_fir_taps(np.ones(7, np.float32))
    assert not m.update_dpd("lut", (1.0, np.zeros((32, 2), np.float32)))
    assert not m.update_dpd("poly", (np.ones(4), np.ones(5)))
    out2, _, _ = m.modulate_eti(b2, st)

    fresh = _port(output="uhd",
                  filter_taps_file=_write_taps(tmp_path, TAPS2, "t2.txt"),
                  poly_coef_file=write_poly_coefs(tmp_path, AM2, PM2,
                                                  "p2.coef"))
    _, st_f, _ = fresh.modulate_eti(b1, fresh.init_state())
    want, _, _ = fresh.modulate_eti(b2, st_f)
    for g, w in zip(out2, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert not np.array_equal(out1[0].numpy(), want[0].numpy())
    assert not _port().update_fir_taps(np.asarray(TAPS1, np.float32))


def test_lut_hot_swap_equals_a_fresh_modulator(tmp_path):
    b = parse_eti_frames(synth_eti_batch(8, mode=1, subch_specs=BENCH_SPECS,
                                         seed=15))
    m = _port(output="uhd", poly_coef_file=write_lut(tmp_path))
    lut2 = LUT[::-1].copy()
    pairs2 = np.stack([lut2.real, lut2.imag], -1)
    assert m.update_dpd("lut", (2.0 ** 30, pairs2))
    assert not m.update_dpd("lut", (2.0 ** 30, pairs2[:16]))
    assert not m.update_dpd("poly", (np.ones(5), np.ones(5)))
    got, _, _ = m.modulate_eti(b, m.init_state())
    fresh = _port(output="uhd", poly_coef_file=write_lut(
        tmp_path, lut2, 2.0 ** 30, "lut2.coef"))
    want, _, _ = fresh.modulate_eti(b, fresh.init_state())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_reference_runtime_params_copied_into_the_port(tmp_path):
    """dabmod_tpu's hot-swapped arrays (np.asarray of its _runtime_params)
    taken by update_fir_taps/update_dpd give its output."""
    b = parse_eti_frames(synth_eti_batch(8, mode=1, subch_specs=BENCH_SPECS,
                                         seed=16))
    kw = dict(output="uhd", filter_taps_file=_write_taps(tmp_path, TAPS1),
              poly_coef_file=write_poly_coefs(tmp_path))
    mj = _jax(ofdm_backend="xla", fft_precision="highest", **kw)
    assert mj.update_fir_taps(np.asarray(TAPS2, np.float32))
    assert mj.update_dpd("poly", (np.asarray(AM2, np.float32),
                                  np.asarray(PM2, np.float32)))
    ref, _, _ = mj.modulate(b.fic, tuple(b.subchannels), mj.init_state())
    m = _port(fft_precision="highest", **kw)
    rp = {k: np.asarray(v) for k, v in mj._runtime_params.items()}
    assert m.update_fir_taps(rp["fir_taps"])
    assert m.update_dpd("poly", (rp["poly_am"], rp["poly_pm"]))
    got, _, _ = m.modulate_eti(b, m.init_state())
    got, ref = np.stack(_np(got), -1), np.stack(_np(ref), -1)
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_modulator_cache_flip_returns_same_instance():
    """As tests/test_recompile_cache.py:96-117: a flip back takes the
    parked instance; values passed to each step do not split the cache;
    another device is another entry."""
    clear_modulator_cache()
    layout = make_default_layout(1, BENCH_SPECS)
    s = ModSettings(dab_mode=1)
    m_off = get_modulator(layout, s, "cpu")
    assert not m_off.cache_hit
    s.tii_enable = True
    m_on = get_modulator(layout, s, "cpu")
    assert m_on is not m_off and not m_on.cache_hit
    assert m_on._tii_vec is not None
    s.tii_enable = False
    assert get_modulator(layout, s, "cpu") is m_off
    s.tii_enable = True
    m_on2 = get_modulator(layout, s, "cpu")
    assert m_on2 is m_on and m_on2.cache_hit and m_on2.settings is s
    s.digital_gain = 0.5
    s.gain_mode_variance = 2.0
    assert get_modulator(layout, s, "cpu") is m_on
    assert get_modulator(layout, s, "meta") is not m_on
    clear_modulator_cache()


def test_modulator_cache_keeps_eight():
    clear_modulator_cache()
    layout = make_default_layout(1, ((0, 24, 0x22),))
    first = get_modulator(layout, ModSettings(dab_mode=1, tii_pattern=0),
                          "cpu")
    for k in range(1, 9):
        get_modulator(layout, ModSettings(dab_mode=1, tii_pattern=k), "cpu")
    again = get_modulator(layout, ModSettings(dab_mode=1, tii_pattern=0),
                          "cpu")
    assert again is not first and not again.cache_hit
    clear_modulator_cache()


def test_cached_modulator_refreshes_file_contents(tmp_path):
    """As tests/test_recompile_cache.py:120-139: park a modulator, change
    its taps file on disk, take it back: the new taps are in effect."""
    clear_modulator_cache()
    f = _write_taps(tmp_path, TAPS1)
    layout = make_default_layout(1, BENCH_SPECS)
    s = ModSettings(dab_mode=1, filter_taps_file=f, device_interleave=False)
    m1 = get_modulator(layout, s, "cpu")
    b = parse_eti_frames(synth_eti_batch(4, mode=1, subch_specs=BENCH_SPECS))
    iq1 = m1.modulate_eti(b, m1.init_state())[0][0].numpy()
    get_modulator(layout, dataclasses.replace(s, filter_taps_file=""), "cpu")
    _write_taps(tmp_path, [0.3] * 5)
    m2 = get_modulator(layout, s, "cpu")
    assert m2 is m1 and m2.cache_hit
    np.testing.assert_array_equal(m2._runtime_params["fir_taps"].numpy(),
                                  np.float32([0.3] * 5))
    iq2 = m2.modulate_eti(b, m2.init_state())[0][0].numpy()
    assert not np.array_equal(iq1, iq2)
    clear_modulator_cache()


# ---------------------------------------------------------------------------
# stage dumps and the frequency-domain resampler's state
# ---------------------------------------------------------------------------

INTEGER_STAGES = ("fec", "qpsk_map", "diff_mod")


def test_modulate_traced_dumps_match_reference(tmp_path):
    """The same stage files as dabmod_tpu's modulate_traced, in the same
    byte layout: the integer stages byte-equal, the float stages within
    the f32 tolerance, the s16 wire within 1 LSB.  A second traced batch
    appends to each file."""
    # a constant AM gain and PM rotation (tests/test_filters.py:259-262):
    # the polynomial terms in |x|^2 diverge in f32 at the s16 scale
    kw = dict(TII, filter_taps_file="default", output_rate=4_096_000,
              poly_coef_file=write_poly_coefs(tmp_path, (1.02, 0, 0, 0, 0),
                                              (0.05, 0, 0, 0, 0)))
    b = parse_eti_frames(synth_eti_batch(8, mode=1, subch_specs=BENCH_SPECS,
                                         seed=17))
    mj = _jax(fmt="s16", ofdm_backend="xla", fft_precision="highest", **kw)
    ref_out, _, _ = mj.modulate_traced(b.fic, tuple(b.subchannels),
                                       mj.init_state(), str(tmp_path / "j"))
    m = _port(fmt="s16", fft_precision="highest", **kw)
    out, _, _ = m.modulate_traced(b.fic, tuple(b.subchannels),
                                  m.init_state(), str(tmp_path / "t"))
    assert m._tap is None
    _assert_same_output(_np(out), np.asarray(ref_out).reshape(2, -1), "s16",
                        {"num_clipped": 0}, {"num_clipped": 0})
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    assert [n[3:-4] for n in names] == [
        "fec", "qpsk_map", "diff_mod", "carriers", "tii_null", "ofdm_ifft",
        "gain", "guard_interval", "fir", "resampler", "dpd",
        "format_convert"]
    for name in names:
        stage = name[3:-4]
        got = (tmp_path / "t" / name).read_bytes()
        ref = (tmp_path / "j" / name).read_bytes()
        assert len(got) == len(ref), name
        if stage in INTEGER_STAGES:
            assert got == ref, name
        elif stage == "format_convert":
            d = np.abs(np.frombuffer(got, np.int16).astype(np.int32)
                       - np.frombuffer(ref, np.int16).astype(np.int32))
            assert d.max() <= 1, name
        else:
            g, r = np.frombuffer(got, np.float32), np.frombuffer(ref,
                                                                 np.float32)
            np.testing.assert_allclose(g, r, atol=3e-5 * np.abs(r).max(),
                                       err_msg=name)
    size = (tmp_path / "t" / names[0]).stat().st_size
    m.modulate_traced(b.fic, tuple(b.subchannels), m.init_state(),
                      str(tmp_path / "t"))
    assert (tmp_path / "t" / names[0]).stat().st_size == 2 * size
    m.modulate_eti(b, m.init_state())          # untraced: writes nothing
    assert (tmp_path / "t" / names[0]).stat().st_size == 2 * size


def test_freq_resampler_state_carried_over_from_reference():
    """JAX modulates the first batch at 1.536 MS/s (frequency domain); its
    res_in_tail and res_out_tail, through state_from_numpy, let the port
    modulate the second batch as JAX does."""
    raw = synth_eti_batch(16, mode=1, subch_specs=BENCH_SPECS, seed=18)
    b1, b2 = parse_eti_frames(raw[:8]), parse_eti_frames(raw[8:])
    kw = dict(output_rate=1_536_000)
    mj = _jax(ofdm_backend="xla", fft_precision="highest", **kw)
    _, sj, _ = mj.modulate(b1.fic, tuple(b1.subchannels), mj.init_state())
    sj_np = {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                 else np.asarray(v)) for k, v in sj.items()}
    ref2, sj2, _ = mj.modulate(b2.fic, tuple(b2.subchannels), sj)
    m = _port(fft_precision="highest", **kw)
    state = state_from_numpy(sj_np, "cpu")
    assert state["res_in_tail"].shape == (2048, 2)
    assert state["res_out_tail"].shape == (1536, 2)
    got2, st2, _ = m.modulate_eti(b2, state)
    _assert_same_output(_np(got2), _np(ref2), "planes")
    for key in ("res_in_tail", "res_out_tail"):
        np.testing.assert_allclose(st2[key].numpy(), np.asarray(sj2[key]),
                                   atol=3e-5 * np.abs(np.asarray(sj2[key]))
                                   .max())
