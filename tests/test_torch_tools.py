"""The port's measuring tools (``sydr_tpu_torch.tools``) through their
command lines, on the CPU at tiny sizes.

(a) ``main`` of trace_profile, scaling_bench (the gloo rank section at 1
    and 2 ranks), acq_profile, soak_debug and false_lock_probe with
    ``--cpu``: each prints its JSON line(s); the rank section's collective
    census matches the JAX design (none in the channel-sharded step; one
    all-gather and one all-reduce per time-sharded block in the prefix
    form, one all-reduce in the row-sum form); device-only numbers read
    null on the CPU.
(b) Without CUDA and without ``--cpu`` every tool exits 2 before any work.
"""

import importlib
import json

import pytest
import torch

torch.set_num_threads(2)

TOOLS = ("soak", "soak_debug", "false_lock_probe", "acq_benchmark",
         "track_benchmark", "trace_profile", "scaling_bench", "acq_profile")


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def _main(name, argv, capsys):
    mod = importlib.import_module(f"sydr_tpu_torch.tools.{name}")
    rc = mod.main(argv)
    return rc, _json_lines(capsys.readouterr().out)


@pytest.mark.parametrize("name", TOOLS)
def test_tool_exits_2_without_cuda(name, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"sydr_tpu_torch.tools.{name}")
    assert mod.main([]) == 2
    captured = capsys.readouterr()
    assert "CUDA is not available" in captured.err
    assert captured.out == ""


def test_trace_profile_ties_ctypes_kernels_to_their_pass():
    """On a synthetic list of profiler events: each pass's range keeps
    the device time the profiler tied to it; the package's ``ctypes``
    kernels (the geometry kernel, K1, K3's two, pass C's, which carries
    the anchor slew) of a name it tied to no op count for their pass by
    name; a kernel of a name tied to an op is not counted again; any other
    kernel tied to no op is unattributed."""
    from types import SimpleNamespace as Evt

    from sydr_tpu_torch.tools import trace_profile as tp

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def host(key, device_us, tied=()):
        return Evt(key=key, device_type=cpu, device_time_total=device_us,
                   self_device_time_total=0.0, is_user_annotation=False,
                   kernels=[Evt(name=n) for n in tied])

    def kernel(key, us):
        return Evt(key=key, device_type=cuda, self_device_time_total=us,
                   is_user_annotation=False, kernels=[])

    ns = "(anonymous namespace)::"
    tied_c = f"{ns}pass_c_kernel<1>(sydr::LoopConsts, int)"
    events = [
        host("pass A", 100.0),
        host("aten::add", 100.0, ["void at::native::add_kernel(...)"]),
        host("pass B", 60.0, ["void at::native::cat_kernel(...)"]),
        host("pass C", 5.0, [tied_c]),
        host("cudaLaunchKernel", 0.0),
        kernel("void at::native::add_kernel(...)", 100.0),
        kernel(f"{ns}block_geometry_kernel(sydr::GeoConsts, int)", 4.0),
        kernel("void at::native::cat_kernel(...)", 60.0),
        kernel(f"{ns}epoch_correlate_kernel(float const*, int)", 14.0),
        kernel(f"{ns}totals_kernel(float const*)", 3.0),
        kernel(f"{ns}prefix_kernel(float const*)", 2.0),
        kernel(f"{ns}pass_c_kernel<2>(sydr::LoopConsts, int)", 8.0),
        kernel(tied_c, 5.0),
        kernel("void some_unlinked_kernel()", 1.5),
    ]
    split = tp.split_device_ms(events)
    assert split["pass A"] == pytest.approx((100.0 + 4.0) / 1e3)
    assert split["pass B"] == pytest.approx((60.0 + 14.0 + 3.0 + 2.0) / 1e3)
    assert split["pass C"] == pytest.approx((5.0 + 8.0) / 1e3)
    assert split["unattributed"] == pytest.approx(1.5 / 1e3)
    assert tp.ctypes_pass(f"void {ns}pass_c_kernel<0>(int)") == "pass C"
    assert tp.ctypes_pass(
        f"{ns}block_geometry_kernel(sydr::GeoConsts, int)") == "pass A"
    assert tp.ctypes_pass("void at::native::prefix_kernel(int)") is None


def test_trace_profile_prints_pass_split_for_both_forms(capsys):
    rc, lines = _main("trace_profile", [
        "--cpu", "--channels", "4", "--fs", "4.096e6", "--decimate", "4",
        "--block-ms", "4", "--superblock", "2", "--top", "3"], capsys)
    assert rc == 0
    assert [r["boundary_mode"] for r in lines] == ["prefix", "rowsum"]
    for r in lines:
        assert r["device"] == "cpu" and r["signal_s"] == pytest.approx(0.008)
        assert set(r["pass_split"]) == {"pass A", "pass B", "pass C"}
        for split in r["pass_split"].values():
            assert split["wall_ms"] > 0 and split["device_ms"] is None
        assert r["busy_share"] is None and r["launches_per_superblock"] is None


def test_scaling_bench_rank_section_census(capsys):
    rc, lines = _main("scaling_bench", [
        "--cpu", "--channels", "8", "--superblock", "2", "--block-ms", "4",
        "--reps", "1", "--worlds", "1", "2", "--fs", "1.023e6"], capsys)
    assert rc == 0
    res = lines[-1]["ranks"]
    assert res["ch_collectives_per_step"] == {"1": {}, "2": {}}
    assert res["ch_collectives_total"] == 0
    assert res["sp_world"] == 2
    assert res["sp_collectives_per_block"] == {
        "rowsum": {"all_reduce": 1},
        "prefix": res["jax_design"]["sp_per_block"]}
    assert res["sp_collectives_per_block"]["prefix"] == {
        "all_gather": 1, "all_reduce": 1}
    assert res["sharding_overhead_1shard"] > 0
    assert set(res["strong_scaling_wall"]) == {"1", "2"}


def test_scaling_bench_card_section_on_the_cpu(capsys):
    rc, lines = _main("scaling_bench", [
        "--chip", "--cpu", "--channels", "8", "--superblock", "1",
        "--block-ms", "4", "--blocks", "1", "--fs", "4e6"], capsys)
    assert rc == 0
    res = lines[-1]["chip"]
    assert set(res["points"]) == {"8", "4", "2", "1"}
    assert set(res["ch_mesh_strong_8ch"]) == {"1", "2", "4", "8"}
    assert res["ch_mesh_strong_8ch"]["1"]["efficiency"] == pytest.approx(1.0)


def test_acq_profile_prints_both_rates(capsys):
    rc, lines = _main("acq_profile", [
        "--cpu", "--fs", "1e6", "--channels", "2", "--reps", "1"], capsys)
    assert rc == 0
    (res,) = lines
    assert res["n"] == 1000 and res["n_bins"] == 101
    assert res["shift_pts_per_s"] > 0 and res["direct_pts_per_s"] > 0
    assert res["max_rel_diff"] < 1e-4


def test_soak_debug_prints_summary(capsys):
    rc, lines = _main("soak_debug", [
        "--cpu", "--seconds", "1", "--fs", "2e6", "--decimate", "2"], capsys)
    assert rc == 0
    assert lines[-1] == {"n_fixes": 0, "mean": None, "max": None}


def test_false_lock_probe_prints_every_channel(capsys):
    rc, lines = _main("false_lock_probe", [
        "--cpu", "--seconds", "1", "--fs", "2e6", "--decimate", "2"], capsys)
    assert rc == 0
    assert [r["prn"] for r in lines] == [1, 2, 3, 4, 5, 6]
    for r in lines:
        assert set(r) == {"prn", "cn0", "tracked_doppler", "truth_doppler",
                          "code_offset_chips", "nearest_other_doppler"}
