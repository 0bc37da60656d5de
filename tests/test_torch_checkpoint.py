"""Checkpoint / resume of the port's receiver, and across the two packages.

The ``.npz`` format is the JAX package's (version 1, key for key), so a
checkpoint written by either package loads in the other: it is how a run's
state crosses from one to the other.

(a) Scan runtime, tests/test_receiver_extras.py's receiver (4 Msps, PRNs 5
    and 12 at 46 dB-Hz, 20 ms blocks): run 1000 ms, save, continue 400 ms.
    A fresh port receiver that loads the port's checkpoint continues
    **bit-identically** to the uninterrupted port run: on the CPU the
    port's ops are deterministic, so no tolerance is needed (this holds for
    (b) too, whose pass B runs the plain K1 and its ``scatter_add_``: the
    CPU adds in one fixed order; on a CUDA device the plain version's adds
    are atomic and unordered, but there the kernel runs, not the plain
    version, and ``chip_smoke.py`` states its own bound). JAX save -> port load and port
    save -> JAX load continue within the side-by-side bound of
    tests/test_torch_receiver.py (integer outputs equal, carrier within
    1 Hz), each against the uninterrupted run of the package that saved.
(b) Batch runtime with promotion (tests/test_torch_session.py's stream:
    8 Msps decimated to 2 Msps, kaplan pull-in, narrow-only cruise): the
    port saves at a block boundary after promotion; the loader is promoted
    on load, without running pull-in again, and continues bit-identically.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sydr_tpu.channels.runtime import TrackingConfig as JaxTrackingConfig
from sydr_tpu.receiver import checkpoint as jckpt
from sydr_tpu.receiver.receiver import Receiver as JaxReceiver
from sydr_tpu.receiver.receiver import ReceiverConfig as JaxReceiverConfig
from sydr_tpu_torch.channels.runtime import TrackingConfig
from sydr_tpu_torch.channels.state import FIELDS, MODE_TRACKING
from sydr_tpu_torch.receiver import checkpoint as tckpt
from sydr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from sydr_tpu_torch.signal.synthetic import IQGenerator

torch.set_num_threads(2)

CPU = torch.device("cpu")
FS = 4e6
SAVE_MS, TAIL_MS = 1000, 400
OUT_KEYS = ("i_prompt", "q_prompt", "flags", "carrier_freq", "active",
            "unread", "required", "bit_ready", "cn0")


def _gen(fs=FS, seed=11):
    bits = np.random.default_rng(seed).integers(0, 2, 200)
    gen = IQGenerator(fs, noise=True, seed=seed)
    gen.add_satellite(5, doppler_hz=1200.0, code_phase_chips=321.4,
                      cn0_dbhz=46.0, nav_bits=bits)
    gen.add_satellite(12, doppler_hz=-2600.0, code_phase_chips=811.9,
                      cn0_dbhz=46.0, nav_bits=bits)
    return gen


def _scan_receiver(package):
    kw = dict(sampling_frequency=FS, block_ms=20, tail_ms=4,
              window_size=4224)
    if package == "jax":
        return JaxReceiver(JaxReceiverConfig(
            prns=(5, 12), tracking=JaxTrackingConfig(**kw),
            tropo_enabled=False))
    return Receiver(ReceiverConfig(
        prns=(5, 12), tracking=TrackingConfig(**kw), tropo_enabled=False),
        device=CPU)


def _continue(rx, iq_blocks):
    outs = []
    for iq in iq_blocks:
        rx.process_ms(iq)
        outs.append({k: np.array(rx.last_outputs[k]) for k in OUT_KEYS})
    return {k: np.concatenate([o[k] for o in outs]) for k in OUT_KEYS}


def _bookkeeping(rx):
    return [(ch.prn, ch.n_codes, ch.bits_pushed, ch.tow_ref,
             ch.boundary_ref, list(ch.decoder._bits), ch.decoder._stream_pos)
            for ch in rx.channels]


@pytest.fixture(scope="module")
def scan_runs(tmp_path_factory):
    """Both packages' uninterrupted runs with a checkpoint at SAVE_MS, and
    the four resumed continuations, keyed ``(saver, loader)``."""
    tmp = tmp_path_factory.mktemp("ckpt")
    gen = _gen()
    head = [gen.generate_ms(20) for _ in range(SAVE_MS // 20)]
    tail = [gen.generate_ms(20) for _ in range(TAIL_MS // 20)]
    save = {"jax": jckpt.save_checkpoint, "port": tckpt.save_checkpoint}
    load = {"jax": jckpt.load_checkpoint, "port": tckpt.load_checkpoint}
    runs = {}
    for saver in ("jax", "port"):
        rx = _scan_receiver(saver)
        for iq in head:
            rx.process_ms(iq)
        path = str(tmp / f"{saver}.npz")
        save[saver](rx, path)
        runs[saver] = dict(path=path, out=_continue(rx, tail), rx=rx)
    for saver, loader in (("port", "port"), ("jax", "port"),
                          ("port", "jax")):
        rx = _scan_receiver(loader)
        load[loader](rx, runs[saver]["path"])
        at_load = dict(total=rx.session.total_samples,
                       modes=np.array(rx.session.mode_host),
                       ring=np.array(rx.session._ring_re))
        runs[saver, loader] = dict(out=_continue(rx, tail), rx=rx,
                                   at_load=at_load)
    return runs


def test_checkpoint_files_have_the_same_keys(scan_runs):
    """Version 1, key for key: the two packages' files hold the same
    arrays, dtypes and shapes and the same manifest entries."""
    import json

    a = np.load(scan_runs["jax"]["path"], allow_pickle=False)
    b = np.load(scan_runs["port"]["path"], allow_pickle=False)
    assert set(a.files) == set(b.files)
    assert {f"state_{n}" for n in FIELDS} <= set(b.files)
    for key in a.files:
        if key != "manifest":
            assert a[key].dtype == b[key].dtype, key
            assert a[key].shape == b[key].shape, key
    ma = json.loads(bytes(a["manifest"]).decode())
    mb = json.loads(bytes(b["manifest"]).decode())
    assert ma.keys() == mb.keys()
    assert ma["version"] == mb["version"] == 1
    assert ma["total_samples"] == mb["total_samples"] == SAVE_MS * 4000
    assert [c.keys() for c in ma["channels"]] == \
        [c.keys() for c in mb["channels"]]
    np.testing.assert_array_equal(a["hist_re"], b["hist_re"])
    np.testing.assert_array_equal(a["tail_re"], b["tail_re"])
    np.testing.assert_array_equal(a["mode_host"], b["mode_host"])


def test_port_resume_is_bit_identical(scan_runs):
    ref, got = scan_runs["port"], scan_runs["port", "port"]
    assert (got["at_load"]["modes"] == MODE_TRACKING).all()
    for k in OUT_KEYS:
        np.testing.assert_array_equal(got["out"][k], ref["out"][k],
                                      err_msg=k)
    assert _bookkeeping(got["rx"]) == _bookkeeping(ref["rx"])
    assert sum(ch.bits_pushed for ch in got["rx"].channels) > 0
    for name in FIELDS:
        assert torch.equal(getattr(got["rx"].session.state, name),
                           getattr(ref["rx"].session.state, name)), name


@pytest.mark.parametrize("saver, loader", [("jax", "port"), ("port", "jax")])
def test_resume_across_packages(scan_runs, saver, loader):
    """The loader continues the saver's run: integer outputs equal, the
    carrier within 1 Hz and the prompt amplitude within 1%, against the
    saver's own uninterrupted continuation."""
    ref, got = scan_runs[saver], scan_runs[saver, loader]
    assert got["at_load"]["total"] == SAVE_MS * 4000
    # the ring is re-seeded from the saved history, not left silent
    saved = np.load(ref["path"], allow_pickle=False)
    np.testing.assert_array_equal(got["at_load"]["ring"], saved["hist_re"])
    for k in ("active", "flags", "required", "unread", "bit_ready"):
        np.testing.assert_array_equal(got["out"][k], ref["out"][k],
                                      err_msg=k)
    np.testing.assert_allclose(got["out"]["carrier_freq"],
                               ref["out"]["carrier_freq"], atol=1.0)
    a = np.abs(got["out"]["i_prompt"]).mean(axis=0)
    b = np.abs(ref["out"]["i_prompt"]).mean(axis=0)
    assert (np.abs(a - b) < 0.01 * b).all()
    assert _bookkeeping(got["rx"]) == _bookkeeping(ref["rx"])
    assert got["rx"].session.acq_results.keys() == \
        ref["rx"].session.acq_results.keys()
    for i, r in ref["rx"].session.acq_results.items():
        g = got["rx"].session.acq_results[i]
        assert g["doppler"] == r["doppler"]
        assert g["code_index"] == r["code_index"]
        np.testing.assert_array_equal(g["corr_map"], r["corr_map"])


def test_save_copies_the_state(tmp_path):
    """``.numpy()`` of a CPU tensor aliases it: the saved arrays must not
    follow the live state, and loading must not alias the file's arrays
    into two receivers."""
    rx = _scan_receiver("port")
    gen = _gen()
    for _ in range(3):
        rx.process_ms(gen.generate_ms(20))
    path = str(tmp_path / "state")             # no suffix: .npz is added
    assert tckpt.save_checkpoint(rx, path) == path
    before = np.load(path + ".npz", allow_pickle=False)
    carrier = before["state_carrier_freq"].copy()
    rx.session.state.carrier_freq += 1000.0
    rx.process_ms(gen.generate_ms(20))
    rx2 = _scan_receiver("port")
    tckpt.load_checkpoint(rx2, path)
    np.testing.assert_array_equal(
        rx2.session.state.carrier_freq.numpy(), carrier)
    assert rx2.session.state.carrier_freq.dtype == torch.float32
    assert rx2.session.state.unread.dtype == torch.int32
    assert rx2.session.state.carrier_freq.device == CPU


def test_load_refuses_another_version(tmp_path):
    rx = _scan_receiver("port")
    path = str(tmp_path / "v.npz")
    tckpt.save_checkpoint(rx, path)
    data = dict(np.load(path, allow_pickle=False))
    data["manifest"] = np.frombuffer(
        bytes(data["manifest"]).replace(b'"version": 1', b'"version": 2'),
        dtype=np.uint8)
    np.savez(path, **data)
    with pytest.raises(ValueError, match="version 2"):
        tckpt.load_checkpoint(_scan_receiver("port"), path)


FS_IN, DEC = 8e6, 4


def _batch_receiver():
    fs = FS_IN / DEC
    pull_in = TrackingConfig(
        sampling_frequency=fs, input_decimate=DEC,
        window_size=round(fs * 1e-3) + 256, runtime="batch",
        profile="kaplan", block_ms=5, quantize_spacing=True)
    cruise = dataclasses.replace(
        pull_in, kaplan_narrow_only=True, block_ms=20, superblock=5)
    return Receiver(ReceiverConfig(
        prns=(5, 12, 20), tracking=pull_in, cruise_tracking=cruise,
        tropo_enabled=False), device=CPU)


def test_batch_resume_after_promotion(tmp_path):
    """(b): one block per ``process_ms`` call, so the receiver holds no
    pending samples at the save."""
    gen = _gen(FS_IN)
    per_ms = round(FS_IN * 1e-3)
    rx = _batch_receiver()

    def step(r, source):
        r.process_ms(source.generate_ms(
            r.session.block_input_samples // per_ms))

    fed_blocks = 0
    while not rx.session.promoted:
        step(rx, gen)
        fed_blocks += 1
        assert rx.session.total_samples < 2.0 * FS_IN / DEC, "no promotion"
    step(rx, gen)                               # one cruise superblock
    assert len(rx._pend_re) == 0
    path = str(tmp_path / "promoted.npz")
    tckpt.save_checkpoint(rx, path)
    fed_ms = rx.session.total_samples * DEC // per_ms

    rx2 = _batch_receiver()
    assert not rx2.session.promoted
    tckpt.load_checkpoint(rx2, path)
    assert rx2.session.promoted and rx2.session.cfg is rx2.session.cruise_cfg
    assert rx2.session.block_input_samples == rx.session.block_input_samples
    gen2 = _gen(FS_IN)
    gen2.generate_ms(fed_ms)
    for _ in range(3):
        step(rx, gen)
        step(rx2, gen2)
        for k in OUT_KEYS:
            np.testing.assert_array_equal(rx2.last_outputs[k],
                                          rx.last_outputs[k], err_msg=k)
    assert rx2.last_outputs["active"].shape[0] == 100     # cruise shape
    assert rx2.session.promoted
    assert _bookkeeping(rx2) == _bookkeeping(rx)
