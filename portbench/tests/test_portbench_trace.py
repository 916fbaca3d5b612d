"""Idle share, rooflines, MFU and the breakdown, worked out on a synthetic trace."""
from types import SimpleNamespace

import pytest

from portbench import layers
from portbench import trace as tr
from portbench.manifest import reader
from portbench.roofline import kernels, sites
from portbench.roofline.peaks import BF16_FLOPS_PER_S


def synthetic(rows=16, visits=30, k3_us=1000.0, k12_us=20.0):
    """One group's call: every K1-K3 launch of the site tables, back to back
    with a 10 µs gap before each, inside a 1 s unit."""
    dev, t = [], 100.0
    for _ in range(visits):
        for kernel, *_, n in sites.visit_sites("sd15", 64, 64):
            for _ in range(n):
                d = k3_us if kernel == "K3" else k12_us
                name = {"K1": "void pww_reduce_kernel<C>(...)",
                        "K2": "void pww_xattn_kernel<C>(...)",
                        "K3": "void flash_kernel<C>(...)"}[kernel]
                dev.append((name, t + 10.0, t + 10.0 + d))
                t += 10.0 + d
    host = [("generate_batch", 0.0, t + 50.0), ("aten::conv2d", 50.0, 60.0)]
    return {"unit": (0.0, t + 50.0), "device": dev, "host": host}


def run_of(trace, rows=16, visits=30):
    want = {k: visits * n for k, n in sites.launches_per_visit("sd15", 64, 64).items()}
    return SimpleNamespace(trace=trace, trace_units=[(64, 64, rows, visits)], launches=want,
                           config_name="sd15")


def test_idle_share_is_the_union_of_device_intervals():
    t = {"unit": (0.0, 100.0), "device": [("a", 10, 30), ("b", 20, 40), ("c", 90, 120),
                                           ("d", -5, 5)], "host": []}
    assert tr.busy_us(tr.within(t)) == 5 + 30 + 10
    assert layers.idle_share(SimpleNamespace(trace=t)) == pytest.approx(55.0)


def test_rooflines_from_the_site_tables():
    t = synthetic()
    run = run_of(t)
    b = sum(30 * n * kernels.bound_s(k, 16, h, lq, lk, dh)
            for k, h, lq, lk, dh, n in sites.visit_sites("sd15", 64, 64) if k == "K3")
    assert reader("per_layer", "kernels.k3_roofline.serve")(run) == pytest.approx(
        100 * b / (300 * 1000e-6))
    b12 = sum(30 * n * kernels.bound_s(k, 16, h, lq, lk, dh)
              for k, h, lq, lk, dh, n in sites.visit_sites("sd15", 64, 64) if k != "K3")
    assert reader("per_layer", "kernels.pww_roofline.serve")(run) == pytest.approx(
        100 * b12 / (900 * 20e-6))


def test_roofline_is_not_read_when_counts_disagree():
    t = synthetic()
    run = run_of(t)
    run.launches["K3"] -= 1
    assert layers.roofline(run, ("K3",)) is None
    t["device"] = [d for d in t["device"] if "flash" not in d[0]]
    assert layers.roofline(run_of(t), ("K3",)) is None
    # one K3 event dropped by the profiler: no estimate stands in
    t = synthetic()
    k3 = [i for i, d in enumerate(t["device"]) if "flash" in d[0]]
    del t["device"][k3[5]]
    assert layers.roofline(run_of(synthetic()), ("K3",)) is not None
    assert layers.roofline(run_of(t), ("K3",)) is None


def test_kernel_bounds_match_the_published_formulas():
    # SD-1.5 K3 at L 4096, dh 40, B·H 16: bound 0.0434 ms by operations
    assert kernels.bound_s("K3", 2, 8, 4096, 4096, 40) * 1e3 == pytest.approx(0.0434, abs=1e-4)
    # K2 at Lq 4096, dh 40: 0.0039 ms by bytes; K1 0.0016
    assert kernels.bound_s("K2", 2, 8, 4096, 77, 40) * 1e3 == pytest.approx(0.0039, abs=1e-4)
    assert kernels.bound_s("K1", 2, 8, 4096, 77, 40) * 1e3 == pytest.approx(0.0016, abs=1e-4)
    assert sites.launches_per_visit("sd15", 64, 64) == {"K1": 15, "K2": 15, "K3": 10}
    assert sites.launches_per_visit("sd15", 128, 128) == {"K1": 16, "K2": 16, "K3": 15}
    assert sites.launches_per_visit("sdxl_base", 128, 128) == {"K1": 70, "K2": 70, "K3": 70}


def test_mfu_counts_the_reference_flops_of_the_profiled_call():
    import json

    cfg = json.load(open("portbench/configs/sd15.json"))
    run = SimpleNamespace(config=cfg, trace={"unit": (0.0, 2.5e6), "device": [], "host": []},
                          trace_units=[(64, 64, 16, 30)])
    per = 30 * 1.60654688256e12 + 2.514518933504e12 + 0.02659700736e12
    assert reader("per_layer", "step.mfu.serve")(run) == pytest.approx(
        100 * 8 * per / 2.5 / BF16_FLOPS_PER_S, rel=1e-6)
    # SDXL at 1024², one sample: both towers, 30 visits and the decode
    run.config = json.load(open("portbench/configs/sdxl_base.json"))
    run.trace_units = [(128, 128, 2, 30)]
    xl = 0.2201068032e12 + 30 * 13.52247279616e12 + 10.470392594432e12
    assert layers.step_mfu(run) == pytest.approx(
        100 * xl / 2.5 / BF16_FLOPS_PER_S, rel=1e-6)


def test_breakdown_names_ops_and_the_longest_gaps():
    t = {"unit": (0.0, 100.0), "device": [("k1", 10, 30), ("k2", 40, 45), ("k1", 50, 60)],
         "host": [("outer", 0, 100), ("aten::to", 30, 40), ("tokenize", 60, 99)]}
    b = tr.breakdown(t)
    assert b["device_ops"][0] == ["k1", 30e-6]
    assert b["idle_gaps"][0] == ["tokenize", 40e-6]
    assert ["aten::to", 10e-6] in b["idle_gaps"]


def test_the_unit_lies_between_the_marker_kernels():
    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, s, e, dev=cuda):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=s, end=e))

    before = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<unsigned char>>"
    after = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<short>>"
    events = [ev("ProfilerStep#1", 0, 500), ev(before, 5, 7), ev(before, 10, 12),
              ev("aten::conv2d", 20, 30, cpu), ev("conv", 30, 60), ev("gemm", 70, 80),
              ev(after, 100, 101), ev(after, 102, 103)]
    t = tr.reduce_events(events)
    assert t["unit"] == (12, 100)
    assert [d[0] for d in tr.within(t)] == ["conv", "gemm"]
    assert t["host"] == [("aten::conv2d", 20, 30)]
    # the markers of either side all dropped: the trace is not read
    for cut in (events[:6], events[3:]):
        with pytest.raises(RuntimeError, match="markers"):
            tr.reduce_events(cut)


def test_profiled_calls_are_kept_out_of_the_phase_times():
    from portbench.harness import Taps

    taps = Taps.__new__(Taps)
    taps.units = ["u0", "u1", "u2", "u3"]
    # calls 1 and 2 ran under the profiler
    taps.profiled = [({"denoise": 1}, {"denoise": 2}, 1, 2),
                     ({"denoise": 2}, {"denoise": 3}, 2, 3)]
    timers, units = taps.unprofiled({"denoise": [1.0, 5.0, 9.0, 1.1]})
    assert timers == {"denoise": [1.0, 1.1]} and units == ["u0", "u3"]
