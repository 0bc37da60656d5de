"""Structure of the ``sydr_tpu_torch`` port: copied modules, imports, config
fields and the state conversion the parity tests rely on."""

import dataclasses
import os
import pkgutil
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

import sydr_tpu_torch
from sydr_tpu.channels import runtime as jrt
from sydr_tpu.channels import state as jstate
from sydr_tpu_torch.channels import runtime as trt
from sydr_tpu_torch.channels import state as tstate

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Docstrings of the JAX package cite the upstream reference checkout by an
# absolute path; the copies cite it relative to that checkout.
_UPSTREAM_PREFIX = re.compile(r"``/[a-z]+/reference/")


def test_copied_modules_equal_their_sources():
    """The jax-free modules are verbatim copies up to the package name."""
    for rel in ("constants.py", "signal/cacode.py", "signal/synthetic.py"):
        with open(os.path.join(ROOT, "sydr_tpu", rel)) as f:
            src = f.read()
        with open(os.path.join(ROOT, "sydr_tpu_torch", rel)) as f:
            copy = f.read()
        expect = _UPSTREAM_PREFIX.sub(
            "``", src.replace("sydr_tpu", "sydr_tpu_torch"))
        assert copy == expect, rel


def test_package_imports_no_jax():
    """Importing every port module leaves JAX and the JAX package out."""
    mods = [m.name for m in pkgutil.walk_packages(
        sydr_tpu_torch.__path__, "sydr_tpu_torch.")]
    assert "sydr_tpu_torch.receiver.session" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sydr_tpu' or m.startswith('sydr_tpu.')"
        " or m == 'tools' or m.startswith('tools.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_tracking_config_fields_and_defaults_equal():
    jf = {f.name: f.default for f in dataclasses.fields(jrt.TrackingConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(trt.TrackingConfig)}
    assert jf == tf
    cfg = trt.TrackingConfig(sampling_frequency=2.5e6, block_ms=20)
    assert cfg.samples_per_ms == 2500
    assert cfg.window_samples == 24 * 2500


def test_state_fields_match_jax():
    assert tstate.FIELDS == tuple(
        f.name for f in dataclasses.fields(jstate.ChannelState))


def test_state_numpy_round_trip_exact():
    rng = np.random.default_rng(0)
    jst = jstate.init_state(5)
    leaves = {}
    for f in dataclasses.fields(jst):
        ref = np.asarray(getattr(jst, f.name))
        if ref.dtype == np.int32:
            leaves[f.name] = rng.integers(-9, 9, ref.shape).astype(np.int32)
        else:
            leaves[f.name] = rng.normal(0, 1e3, ref.shape).astype(np.float32)
    st = tstate.state_from_numpy(leaves, torch.device("cpu"))
    back = tstate.state_to_numpy(st)
    assert set(back) == set(leaves)
    for name, v in leaves.items():
        assert back[name].dtype == v.dtype, name
        np.testing.assert_array_equal(back[name], v, err_msg=name)
        assert getattr(st, name).dtype == (
            torch.int32 if v.dtype == np.int32 else torch.float32)
    # and the JAX state, leaf for leaf
    jleaves = {f.name: np.asarray(jnp.asarray(leaves[f.name]))
               for f in dataclasses.fields(jst)}
    back2 = tstate.state_to_numpy(tstate.state_from_numpy(
        jleaves, torch.device("cpu")))
    for name in jleaves:
        np.testing.assert_array_equal(back2[name], jleaves[name])


def test_init_state_and_code_table_match_jax():
    st = tstate.init_state(4, torch.device("cpu"))
    jst = jstate.init_state(4)
    for f in dataclasses.fields(jst):
        a = np.asarray(getattr(jst, f.name))
        b = getattr(st, f.name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(tstate.code_table([0, 3, 17]),
                                  jstate.code_table([0, 3, 17]))
