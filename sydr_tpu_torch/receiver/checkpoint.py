"""Checkpoint / resume: block-boundary receiver state persistence.

Port of ``sydr_tpu.receiver.checkpoint``, in the same file format (version
1, key for key), so a checkpoint written by either package loads in the
other. The complete mid-run state — the channel state, the session's
window and history buffers, and all host bookkeeping (bit decoders, TOW
anchors, ephemerides, receiver clock) — serialises to one ``.npz`` (arrays
+ a JSON manifest; no pickle, nothing executable) and restores at any
block boundary onto the receiver's device.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from sydr_tpu_torch.channels.state import state_from_numpy, state_to_numpy
from sydr_tpu_torch.nav.ephemeris import Ephemeris

_FORMAT_VERSION = 1


def _eph_to_dict(eph) -> dict:
    out = {}
    for f in dataclasses.fields(eph):
        v = getattr(eph, f.name)
        if isinstance(v, (int, float, bool, np.integer, np.floating)):
            out[f.name] = float(v) if isinstance(v, (float, np.floating)) \
                else int(v)
    return out


def _eph_from_dict(d: dict):
    field_names = {f.name for f in dataclasses.fields(Ephemeris)}
    kwargs = {}
    for k, v in d.items():
        if k not in field_names:
            continue
        ftype = Ephemeris.__dataclass_fields__[k].type
        kwargs[k] = bool(v) if "bool" in str(ftype) else (
            int(v) if "int" in str(ftype) else v)
    return Ephemeris(**kwargs)


def save_checkpoint(receiver, path: str) -> str:
    sess = receiver.session
    # state_to_numpy copies every leaf to the host (a CPU tensor's
    # .numpy() would alias the live state).
    arrays: dict[str, np.ndarray] = {
        f"state_{name}": leaf
        for name, leaf in state_to_numpy(sess.state).items()}
    arrays["tail_re"] = sess._tail_re
    arrays["tail_im"] = sess._tail_im
    arrays["hist_re"] = sess._hist_re
    arrays["hist_im"] = sess._hist_im
    arrays["mode_host"] = sess.mode_host
    arrays["low_cn0"] = receiver._low_cn0_ms
    arrays["dead_cn0"] = receiver._dead_cn0_ms

    chans = []
    for ch in receiver.channels:
        dec = ch.decoder
        chans.append({
            "prn": ch.prn,
            "n_codes": ch.n_codes,
            "bits_pushed": ch.bits_pushed,
            "tow_ref": ch.tow_ref,
            "boundary_ref": ch.boundary_ref,
            "subframes_seen": sorted(ch.subframes_seen),
            "eph": _eph_to_dict(ch.eph) if ch.eph is not None else None,
            "partial": (_eph_to_dict(ch._partial)
                        if ch._partial is not None else None),
            "decoder": {
                "bits": list(map(int, dec._bits)),
                "stream_pos": dec._stream_pos,
                "subframe_sync": dec.subframe_sync,
                "sync_offset": dec._sync_offset,
            },
        })
    # Array-valued acquisition diagnostics (correlation maps) go into the
    # npz; the manifest keeps the scalars.
    acq_scalar = {}
    for k, v in sess.acq_results.items():
        entry = {}
        for name, val in v.items():
            if isinstance(val, np.ndarray):
                arrays[f"acq_{k}_{name}"] = val
            else:
                entry[name] = val
        acq_scalar[str(k)] = entry
    manifest = {
        "version": _FORMAT_VERSION,
        "total_samples": sess.total_samples,
        "acq_results": acq_scalar,
        "clock_tow": receiver.clock_tow,
        "clock_sample": receiver.clock_sample,
        "next_meas_sample": receiver._next_meas_sample,
        "block_index": receiver._block_index,
        "epochs_done": receiver._epochs_done,
        "promoted": sess.promoted,
        "channels": chans,
    }
    arrays["manifest"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)
    return path


def load_checkpoint(receiver, path: str) -> None:
    """Restore a receiver (constructed with the same config) in place."""
    from sydr_tpu_torch.receiver.receiver import _ChannelBookkeeping

    data = np.load(path if path.endswith(".npz") else path + ".npz",
                   allow_pickle=False)
    manifest = json.loads(bytes(data["manifest"]).decode())
    if manifest["version"] != _FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format version {manifest['version']}, expected "
            f"{_FORMAT_VERSION}")

    sess = receiver.session
    sess.state = state_from_numpy(
        {key[len("state_"):]: data[key] for key in data.files
         if key.startswith("state_")}, sess.device)
    sess._tail_re = data["tail_re"]
    sess._tail_im = data["tail_im"]
    sess._hist_re = data["hist_re"]
    sess._hist_im = data["hist_im"]
    # Re-seed the device acquisition ring from the host history (the ring
    # mirrors it; resuming with zeros would let a pending channel search a
    # silent window once).
    sess._ring_re = torch.tensor(data["hist_re"], dtype=torch.float32,
                                 device=sess.device)
    sess._ring_im = torch.tensor(data["hist_im"], dtype=torch.float32,
                                 device=sess.device)
    sess.mode_host = np.array(data["mode_host"])
    sess.total_samples = int(manifest["total_samples"])
    sess.acq_results = {
        int(k): dict(v) for k, v in manifest["acq_results"].items()}
    for key in data.files:
        if key.startswith("acq_"):
            _, idx, name = key.split("_", 2)
            sess.acq_results.setdefault(int(idx), {})[name] = data[key]
    receiver._low_cn0_ms = np.array(data["low_cn0"])
    if "dead_cn0" in data.files:
        receiver._dead_cn0_ms = np.array(data["dead_cn0"])
    receiver.clock_tow = manifest["clock_tow"]
    receiver.clock_sample = int(manifest["clock_sample"])
    receiver._next_meas_sample = manifest["next_meas_sample"]
    receiver._block_index = int(manifest["block_index"])
    receiver._epochs_done = int(manifest.get("epochs_done",
                                             manifest["block_index"]))
    if manifest.get("promoted") and sess.cruise_cfg is not None:
        # Re-apply the pull-in -> cruise promotion (config swap only; the
        # restored state already carries the post-promotion values).
        sess.cfg = sess.cruise_cfg
        sess.promoted = True

    receiver.channels = []
    for cd in manifest["channels"]:
        ch = _ChannelBookkeeping(cd["prn"])
        ch.n_codes = int(cd["n_codes"])
        ch.bits_pushed = int(cd["bits_pushed"])
        ch.tow_ref = cd["tow_ref"]
        ch.boundary_ref = int(cd["boundary_ref"])
        ch.subframes_seen = set(cd["subframes_seen"])
        ch.eph = _eph_from_dict(cd["eph"]) if cd["eph"] else None
        ch._partial = (_eph_from_dict(cd["partial"])
                       if cd["partial"] else None)
        dec = ch.decoder
        dec._bits = list(cd["decoder"]["bits"])
        dec._stream_pos = int(cd["decoder"]["stream_pos"])
        dec.subframe_sync = bool(cd["decoder"]["subframe_sync"])
        dec._sync_offset = cd["decoder"]["sync_offset"]
        receiver.channels.append(ch)
