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
from sydr_tpu import config as jconfig
from sydr_tpu.channels import runtime as jrt
from sydr_tpu.channels import state as jstate
from sydr_tpu.receiver import receiver as jreceiver
from sydr_tpu_torch import config as tconfig
from sydr_tpu_torch.channels import runtime as trt
from sydr_tpu_torch.channels import state as tstate
from sydr_tpu_torch.receiver import receiver as treceiver

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Docstrings of the JAX package cite the upstream reference checkout by an
# absolute path; the copies cite it relative to that checkout.
_UPSTREAM_PREFIX = re.compile(r"``/[a-z]+/reference/")

# Modules with no JAX in them: verbatim copies up to the package name.
COPIED = (
    "constants.py", "signal/cacode.py", "signal/synthetic.py",
    "nav/__init__.py", "nav/geodesy.py", "nav/gpstime.py", "nav/kepler.py",
    "nav/ephemeris.py", "nav/atmosphere.py", "nav/lse.py",
    "decoding/__init__.py", "decoding/lnav.py", "decoding/lnav_encode.py",
    "signal/scenario.py", "signal/rf.py",
    "io/__init__.py", "io/database.py", "io/rinex.py", "io/rinex_obs.py",
    "io/report.py", "utils/__init__.py", "utils/logconfig.py",
    "receiver/dashboard.py", "config.py", "__main__.py",
)

# Modules that touched JAX: copies except for these (source, port) blocks.
CHANGED = {
    "receiver/receiver.py": [
        ('''    def __init__(self, cfg: ReceiverConfig):
        self.cfg = cfg
        self.session = TrackingSession(
            cfg.tracking, list(cfg.prns), cfg.acquisition,
            cruise=cfg.cruise_tracking,
        )''', '''    def __init__(self, cfg: ReceiverConfig, *, device):
        self.cfg = cfg
        self.session = TrackingSession(
            cfg.tracking, list(cfg.prns), cfg.acquisition,
            cruise=cfg.cruise_tracking, device=device,
        )'''),
        ('''        import jax.numpy as jnp

        packed = np.asarray(jnp.stack(
            [st.unread.astype(jnp.float32), st.rem_code,
             st.carrier_freq, st.code_freq_offset], axis=0))''',
         '''        import torch

        packed = torch.stack(
            [st.unread.to(torch.float32), st.rem_code,
             st.carrier_freq, st.code_freq_offset], dim=0).cpu().numpy()'''),
    ],
    # The port's recorder of spans and counters (test_torch_spans.py):
    # the JAX module's stage report, rewritten, around its ``store`` and the
    # head of ``device_trace``. A ``(start, end)`` pair is the stretch from
    # ``start`` up to ``end`` (None: the end of the module).
    "utils/metrics.py": [
        (('"""Per-stage timing', "\nfrom __future__"),
         ('"""The program\'s recorder', "\nfrom __future__")),
        (("import contextlib\n", "    def store(self, db)"),
         ("import collections\n", "    def store(self, db)")),
        (("    def report(self)", "@contextlib.contextmanager\n"),
         ("    def report(self)", "@contextlib.contextmanager\n")),
        (('    """Capture a jax.profiler trace', None),
         ('    """Capture a torch.profiler trace', None)),
    ],
    "main.py": [
        ('''                        help="force the CPU backend (development machines)")
''', '''                        help="force the CPU backend (development machines)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the tracking state and kernels "
                             "(--cpu means --device cpu)")
'''),
        ('''    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
''', '''    device = "cpu" if args.cpu else args.device
    if device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print(f"--device {device}: CUDA is not available (use --cpu "
                  f"to run on the CPU)", file=sys.stderr)
            return 2
'''),
        ("    receiver = Receiver(run_cfg.receiver)\n",
         "    receiver = Receiver(run_cfg.receiver, device=device)\n"),
        # The scan runtime's superblock: --superblock in either runtime, and
        # a scan cruise (the pull-in's loops) when --cruise-superblock
        # names one.
        ('''        superblock=args.superblock if args.runtime == "batch" else 1,
''', '''        superblock=args.superblock,
'''),
        ('''    cruise = None
    if args.runtime == "batch" and not args.no_cruise:
        import dataclasses as _dc

        cruise = _dc.replace(
            pull_in, profile="kaplan", kaplan_narrow_only=True, block_ms=20,
            superblock=max(1, int(args.cruise_superblock)))
''', '''    # The scan runtime's loops already run at the reference's per-ms
    # cadence: its cruise, when --cruise-superblock asks for one, keeps
    # them and only dispatches more blocks a call.
    import dataclasses as _dc

    cruise = None
    if args.runtime == "batch" and not args.no_cruise:
        cruise = _dc.replace(
            pull_in, profile="kaplan", kaplan_narrow_only=True, block_ms=20,
            superblock=max(1, 50 if args.cruise_superblock is None
                             else int(args.cruise_superblock)))
    elif args.cruise_superblock is not None and not args.no_cruise:
        cruise = _dc.replace(pull_in,
                             superblock=max(1, int(args.cruise_superblock)))
'''),
        ('''                        help="blocks per device dispatch (batch runtime)")
''', '''                        help="blocks per device dispatch")
'''),
        ('''    parser.add_argument("--cruise-superblock", type=int, default=50,
                        help="superblock of the cruise configuration "
                             "(borre/20ms blocks after promotion)")
''', '''    parser.add_argument("--cruise-superblock", type=int, default=None,
                        help="superblock of the cruise configuration after "
                             "promotion (batch: kaplan/20ms blocks, 50 "
                             "unless given; scan: the pull-in loops, no "
                             "cruise unless given)")
'''),
    ],
}


def _copy_of(rel):
    """The JAX module ``rel`` as the port's copy of it must read."""
    with open(os.path.join(ROOT, "sydr_tpu", rel)) as f:
        src = f.read()
    return _UPSTREAM_PREFIX.sub(
        "``", src.replace("sydr_tpu", "sydr_tpu_torch"))


def _port(rel):
    with open(os.path.join(ROOT, "sydr_tpu_torch", rel)) as f:
        return f.read()


def test_copied_modules_equal_their_sources():
    """The jax-free modules are verbatim copies up to the package name."""
    for rel in COPIED:
        assert _port(rel) == _copy_of(rel), rel


def _stretch(text, start, end):
    """The one stretch of ``text`` from ``start`` up to ``end``."""
    assert text.count(start) == 1, start
    i = text.index(start)
    return text[i:] if end is None else text[i:text.index(end, i)]


def test_changed_modules_differ_only_in_listed_lines():
    """receiver.py, main.py and utils/metrics.py are their JAX sources with
    only the listed blocks replaced: the device argument, the bulk state
    fetch, the recorder and its profiler, and the CLI's device handling
    and scan superblocks."""
    for rel, blocks in CHANGED.items():
        expect = _copy_of(rel)
        for old, new in blocks:
            if isinstance(old, tuple):
                old, new = _stretch(expect, *old), _stretch(_port(rel), *new)
            assert expect.count(old) == 1, (rel, old)
            expect = expect.replace(old, new)
        assert _port(rel) == expect, rel


def test_package_imports_no_jax():
    """Importing every port module leaves JAX and the JAX package out."""
    mods = [m.name for m in pkgutil.walk_packages(
        sydr_tpu_torch.__path__, "sydr_tpu_torch.")
        if m.name != "sydr_tpu_torch.__main__"]   # importing it runs the CLI
    for rel in COPIED + tuple(CHANGED) + (
            "receiver/session.py", "receiver/checkpoint.py",
            "channels/runtime.py", "channels/batch_runtime.py",
            "ops/tracking.py", "ops/acquisition.py",
            "parallel/distributed.py", "parallel/mesh.py",
            "parallel/timeshard.py", "parallel/dryrun.py",
            "tools/soak.py", "tools/soak_debug.py",
            "tools/false_lock_probe.py", "tools/acq_benchmark.py",
            "tools/track_benchmark.py", "tools/trace_profile.py",
            "tools/scaling_bench.py", "tools/acq_profile.py"):
        if rel.endswith("__init__.py") or rel == "__main__.py":
            continue
        assert "sydr_tpu_torch." + rel[:-3].replace("/", ".") in mods, rel
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


def _defaults(cls):
    """Field name -> default of a config dataclass (a factory's product,
    as a dict where it is a dataclass)."""
    out = {}
    for f in dataclasses.fields(cls):
        if f.default_factory is not dataclasses.MISSING:
            v = f.default_factory()
            out[f.name] = (dataclasses.asdict(v)
                           if dataclasses.is_dataclass(v) else v)
        else:
            out[f.name] = f.default
    return out


def test_receiver_and_run_config_fields_and_defaults_equal():
    """Equal up to the package rename of the copies: the default run name
    is ``sydr_tpu_torch_run`` where the JAX package's is ``sydr_tpu_run``."""
    assert _defaults(treceiver.ReceiverConfig) == \
        _defaults(jreceiver.ReceiverConfig)
    jrun = {k: v.replace("sydr_tpu", "sydr_tpu_torch")
            if isinstance(v, str) else v
            for k, v in _defaults(jconfig.RunConfig).items()}
    assert _defaults(tconfig.RunConfig) == jrun


def test_acquisition_config_fields_defaults_and_required_ms_equal():
    from sydr_tpu.receiver import session as jsession
    from sydr_tpu_torch.receiver import session as tsession

    assert _defaults(tsession.AcquisitionConfig) == \
        _defaults(jsession.AcquisitionConfig)
    assert _defaults(tsession.CruisePolicy) == _defaults(jsession.CruisePolicy)
    for kw in (dict(), dict(method="serial"),
               dict(coherent=3, non_coherent=4),
               dict(method="serial", coherent=3, non_coherent=4)):
        assert tsession.AcquisitionConfig(**kw).required_ms == \
            jsession.AcquisitionConfig(**kw).required_ms
    assert tsession.AcquisitionConfig(method="serial").required_ms == 1
    assert tsession.AcquisitionConfig().required_ms == 50


def test_checkpoint_module_is_the_jax_one_up_to_the_state_io():
    """The manifest and the ephemeris (de)serialisation are the JAX
    module's, line for line: the format cannot drift apart."""
    src, port = _copy_of("receiver/checkpoint.py"), \
        _port("receiver/checkpoint.py")
    for start, end in (("def _eph_to_dict", "def save_checkpoint"),
                       ("    chans = []", "def load_checkpoint"),
                       ("    receiver.channels = []", None)):
        a = src[src.index(start):src.index(end) if end else None]
        b = port[port.index(start):port.index(end) if end else None]
        assert a == b, start
    assert "_FORMAT_VERSION = 1\n" in src and "_FORMAT_VERSION = 1\n" in port


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
