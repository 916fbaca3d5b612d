"""Shared arithmetic of the per-layer readers in ``portbench/metrics/``.

``run`` carries what the traced run saw: ``timers`` (the pipeline's
PhaseTimer seconds of every call in the window), ``units`` (one entry a
program call in the window: latent height and width, CFG rows, UNet
visits), ``trace`` (the profiled call, reduced by :mod:`portbench.trace`),
``trace_units`` and ``launches`` (the calls and the K1-K3 launches inside
it), ``records``, ``seconds`` and the configuration. Each function returns
None where it finds nothing to read.
"""
from __future__ import annotations

import sys

from portbench import trace as tr
from portbench.roofline import flops as fl
from portbench.roofline import kernels, sites
from portbench.roofline.peaks import BF16_FLOPS_PER_S

# device-kernel names of the program's kernels (csrc/*.cu)
KERNEL_NAMES = {"K1": ("pww_reduce_kernel",), "K2": ("pww_xattn_kernel",),
                "K3": ("flash_kernel",)}


def denoise_ms_per_visit(run):
    t = run.timers.get("denoise")
    visits = sum(u[3] for u in run.units)
    return 1e3 * sum(t) / visits if t and visits else None


def phase_ms(run, name):
    t = run.timers.get(name)
    return 1e3 * sum(t) / len(t) if t else None


def idle_share(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - tr.busy_us(tr.within(run.trace)) / tr.window_us(run.trace))


def roofline(run, names):
    """Σ bound over the profiled call's launches of ``names`` ÷ their device
    time, %. The launches counted by the kernels' wrappers, the site
    tables' count and the trace's events must all agree."""
    if run.trace is None:
        return None
    bound, want = 0.0, {k: 0 for k in names}
    for lat_h, lat_w, rows, visits in run.trace_units:
        for kernel, heads, lq, lk, dh, n in sites.visit_sites(run.config_name, lat_h, lat_w):
            if kernel in names:
                bound += visits * n * kernels.bound_s(kernel, rows, heads, lq, lk, dh)
                want[kernel] += visits * n
    us, events = 0.0, 0
    for k in names:
        t, c = tr.kernel_us(run.trace, KERNEL_NAMES[k])
        us, events = us + t, events + c
    got = {k: run.launches.get(k, 0) for k in names}
    expected = sum(want.values())
    if got != want or events != expected or not us:
        print(f"[portbench] roofline of {names}: launches {got}, site tables {want}, "
              f"trace events {events}: not read", file=sys.stderr)
        return None
    return 100.0 * bound / (us / 1e6)


def call_flops(run, units):
    """FLOPs of the program calls ``units`` (latent h, latent w, CFG rows,
    visits): each sample's text encode and UNet visits (a CFG pair each),
    and the decode of the last call's samples."""
    total = 0.0
    for lat_h, lat_w, rows, visits in units:
        c = fl.counts(run.config, lat_h, lat_w)
        total += rows // 2 * (c["encode"] + visits * c["unet_visit"])
    lat_h, lat_w, rows, _ = units[-1]
    return total + rows // 2 * fl.counts(run.config, lat_h, lat_w)["decode"]


def step_mfu(run):
    """The profiled call's work over its span on the card's clock (the
    card's activity alone is recorded there), over the bf16 peak."""
    if run.trace is None or not run.trace_units:
        return None
    return 100.0 * call_flops(run, run.trace_units) / (tr.window_us(run.trace) / 1e6) \
        / BF16_FLOPS_PER_S
