#!/usr/bin/env python3
"""Drive the PyTorch port (pww_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py [--steps N] [--kernels-only | --e2e-reps R]

Phases, each printing its own lines; any failure ends the run non-zero:

1. device: the card's name and power limit, TF32 switched off for the f32
   reference products;
2. build: nvcc compiles every kernel from pww_tpu_torch/csrc (K1-K5);
3. kernels: K1 pww_reduce, K2 pww_cross_attention and K3
   flash_self_attention against their plain PyTorch versions at every shape
   of SD-1.5's 512² main path, bf16 inputs from a seeded generator, with
   CUDA-event timings of the kernel, the plain version, a one-call library
   yardstick where one exists, and the least time the card could take (K1
   in every mode, std also at |mean| ≫ std, each case called twice and
   required bit-identical, with its launch plan printed); then K3 at dh 64
   and 160 and ragged L, K1 in every mode and K2 at ragged Lq and at two and
   four prompt chunks (Lk 154, 308); then K4 group_norm and K5 layer_norm at
   every site signature of the inpaint path (the tables K4_SITES and
   K5_SITES), with ``F.group_norm`` and ``F.layer_norm`` as the library
   yardstick where no pre-add or SiLU, K4 off the path at a streamed span
   (1, 128, 1024, 1024) and a scalar one (1, 64, 33, 33), K4's plan per
   case, and each kernel's loss_ms_per_run (Σ calls per 30-step run ×
   (ms − bound)); ``--kernels-only`` stops after this phase, and
   ``--e2e-reps R`` runs phase 5's call R times in its place, with the host
   time of each K2 and K3 wrapper call;
4. reference: a reduced-depth SD-1.5-width txt2img (256 px, 3 steps) on the
   card in bf16 against the same pipeline on the CPU in f32;
5. main path: SD-1.5 at full width (synthetic N(0, 0.02) weights) through
   ``paint_with_words``, 512², cat/dog color map, CFG 7.5, LMS; the kernel
   launch counters are zeroed before the run and must read K1 = K2 = 15·N,
   K3 = 10·N and K4 = K5 = 0 (the norm knobs are off) after it;
6. profile: device time by kernel group over a 5-step call (torch.profiler),
   the device's idle share, and each kernel's device time and device
   kernels per wrapper call, which must be 1 for K1;
7. img2img: one full-width ``paint_with_words`` call with an init image at
   strength 0.5 on the same pipeline (N/2 steps, counts checked);
8. norm sites: a 1-step warm-up of phase 10's pipeline records every K4
   and K5 call's signature, which must be the tables of phase 3;
9. inpaint reference: a reduced-depth 9-channel inpaint with the norm
   knobs on, card bf16 against CPU f32;
10. inpaint path: SD-1.5-inpainting at full width (9-channel ``conv_in``,
    synthetic weights, ``fused_group_norm`` and ``fused_layer_norm`` on in
    the UNet and the VAE) through ``paint_with_words_inpaint``, 512², N
    steps at strength 1.0; the counters must read K4 = 61·N + 2·22 + 30,
    K5 = 48·N, K1 = K2 = 15·N, K3 = 10·N; then its own 5-step profile, in
    which K1 and K4 must be one device kernel per call.

Then a JSON line with every kernel, the card's name and power limit, and
last {"ok": true, "device": {...}}.
Imports nothing of JAX. Needs one card.
"""
import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores (the norms)
# SD-1.5 at 512²: the (Lq, head dim) of the attention sites, five of each per
# UNet call (self-attention takes K3 at the first two, cross-attention K1+K2
# at all three)
SHAPES = ((4096, 40), (1024, 80), (256, 160))
STEPS_PER_RUN = 30  # the operating point's LMS steps, for calls per run
# The inpaint path's GroupNorm sites at 512² (SD-1.5-inpainting, CFG batch 2
# in the UNet): (shape, groups, eps, SiLU, pre-add) → calls per UNet step,
# per VAE encode, per VAE decode. An inpaint call at strength 1.0 runs N
# UNet steps, two encodes (image, masked image) and a decode: K4 = 61·N +
# 2·22 + 30.
K4_SITES = {
    ((2, 320, 64, 64), 32, 1e-06, False, False): (5, 0, 0),
    ((2, 320, 64, 64), 32, 1e-05, True, False): (3, 0, 0),
    ((2, 320, 64, 64), 32, 1e-05, True, True): (5, 0, 0),
    ((2, 320, 32, 32), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 640, 64, 64), 32, 1e-05, True, False): (2, 0, 0),
    ((2, 640, 32, 32), 32, 1e-06, False, False): (5, 0, 0),
    ((2, 640, 32, 32), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 640, 32, 32), 32, 1e-05, True, True): (5, 0, 0),
    ((2, 640, 16, 16), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 960, 64, 64), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 960, 32, 32), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 1280, 32, 32), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 1280, 16, 16), 32, 1e-06, False, False): (5, 0, 0),
    ((2, 1280, 16, 16), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 1280, 16, 16), 32, 1e-05, True, True): (5, 0, 0),
    ((2, 1280, 8, 8), 32, 1e-06, False, False): (1, 0, 0),
    ((2, 1280, 8, 8), 32, 1e-05, True, False): (4, 0, 0),
    ((2, 1280, 8, 8), 32, 1e-05, True, True): (7, 0, 0),
    ((2, 1920, 32, 32), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 1920, 16, 16), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 2560, 16, 16), 32, 1e-05, True, False): (2, 0, 0),
    ((2, 2560, 8, 8), 32, 1e-05, True, False): (3, 0, 0),
    ((1, 256, 512, 512), 32, 1e-06, True, False): (0, 0, 1),
    ((1, 128, 512, 512), 32, 1e-06, True, False): (0, 4, 6),
    ((1, 512, 256, 256), 32, 1e-06, True, False): (0, 0, 1),
    ((1, 256, 256, 256), 32, 1e-06, True, False): (0, 3, 5),
    ((1, 128, 256, 256), 32, 1e-06, True, False): (0, 1, 0),
    ((1, 512, 128, 128), 32, 1e-06, True, False): (0, 3, 6),
    ((1, 256, 128, 128), 32, 1e-06, True, False): (0, 1, 0),
    ((1, 512, 64, 64), 32, 1e-06, True, False): (0, 9, 10),
    ((1, 512, 64, 64), 32, 1e-06, False, False): (0, 1, 1),
}
# The transformer LayerNorms: (shape, eps) → calls per UNet step (48·N).
K5_SITES = {((2, 4096, 320), 1e-05): 15, ((2, 1024, 640), 1e-05): 15,
            ((2, 256, 1280), 1e-05): 15, ((2, 64, 1280), 1e-05): 3}
# K4 off the path: a span larger than 16 CTAs' shared memory, and channels
# that are not a multiple of 8 elements (the scalar path)
K4_OFF_PATH = (((1, 128, 1024, 1024), 32, 1e-06, True, False),
               ((1, 64, 33, 33), 32, 1e-06, False, False))


def k4_calls(site, unet_steps, encodes=2, decodes=1):
    u, e, d = K4_SITES[site]
    return u * unet_steps + e * encodes + d * decodes


def k4_label(site, mean=0.0):
    (shape, groups, eps, silu, has_add) = site
    where = "off" if site not in K4_SITES else "unet" if shape[0] == 2 else "vae"
    return (f"{where} {shape}{' add' if has_add else ''}{' silu' if silu else ''} "
            f"eps{eps:g}{f' mean{mean:g}' if mean else ''}")


def k5_label(site, mean=0.0):
    shape, eps = site
    return f"{shape} eps{eps:g}{f' mean{mean:g}' if mean else ''}"

# name → (source, TPU kernel it replaces, launch counter, profile group,
#         the case whose numbers head the kernel's JSON entry)
KERNELS = {
    "pww_reduce": ("pww_tpu_torch/csrc/pww_reduce.cu",
                   "pww_tpu/ops/cross_attention_kernel.py:133", "fused_pww_reduce",
                   "K1 pww_reduce", "Lq4096 dh40 max"),
    "pww_cross_attention": ("pww_tpu_torch/csrc/pww_cross_attention.cu",
                            "pww_tpu/ops/cross_attention_kernel.py:210",
                            "fused_pww_cross_attention", "K2 pww_cross_attention",
                            "Lq4096 dh40"),
    "flash_self_attention": ("pww_tpu_torch/csrc/flash_attention.cu",
                             "pww_tpu/ops/flash_attention.py:64", "flash_self_attention",
                             "K3 flash_self_attention", "L4096 dh40"),
    "group_norm": ("pww_tpu_torch/csrc/group_norm.cu", "pww_tpu/ops/group_norm.py:288",
                   "group_norm", "K4 group_norm",
                   k4_label(((1, 256, 512, 512), 32, 1e-06, True, False))),
    "layer_norm": ("pww_tpu_torch/csrc/layer_norm.cu", "pww_tpu/ops/layer_norm.py:60",
                   "layer_norm", "K5 layer_norm", k5_label(((2, 4096, 320), 1e-05))),
}


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=20, trials=5, warmup=3):
    """Device time of one call: the median over ``trials`` of the mean of
    ``reps`` back-to-back calls between two CUDA events. A spin kernel
    queued first holds the card while the host enqueues the calls, so the
    host's per-call overhead stays out of the reading. The inputs stay in
    the 50 MB L2 between calls, as the main path's freshly written
    activations often are."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms of device cycles
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def bound(nbytes, flops, flops_per_s=BF16_FLOPS_PER_S):
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


class Cases:
    """Kernel-versus-plain comparisons, by kernel; failures are collected."""

    def __init__(self):
        self.by_kernel = {}
        self.failed = []

    def record(self, kernel, label, got, want, tol, rel_tol, ms, plain_ms, bnd, library_ms,
               flops=None, calls=None):
        """``calls``: the case's calls per 30-step run of its path (None: off
        the path), for the kernel's loss_ms_per_run."""
        import torch

        diff = got.float() - want.float()
        err = diff.abs().max().item()
        rel = (diff.norm() / want.float().norm()).item()
        ok = (bool(torch.isfinite(got.float()).all()) and err <= tol
              and (rel_tol is None or rel <= rel_tol))
        self.by_kernel.setdefault(kernel, []).append(dict(
            case=label, numel=want.numel(), max_abs_err=err, tol=tol, rel_l2_err=rel,
            rel_tol=rel_tol, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
            library_ms=library_ms, tflops=flops / ms * 1e-9 if flops else None,
            calls_per_run=calls))
        lib = "null" if library_ms is None else f"{library_ms:.4f}"
        rate = f", {flops / ms * 1e-9:.1f} TFLOP/s" if flops else ""
        log(f"[kernels] {kernel} {label}: max_abs_err {err:.3e} (tol {tol:.3e}), "
            f"rel_l2 {rel:.3e} (tol {rel_tol}) {'ok' if ok else 'FAIL'} | kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib} ms, "
            f"bound {bnd[0]:.4f} ms ({bnd[1]}){rate}")
        if not ok:
            self.failed.append(f"{kernel} {label}")

    def check(self):
        if self.failed:
            raise SystemExit(f"[kernels] outside tolerance: {self.failed}")


def loss_ms_per_run(cases):
    """Σ over a kernel's path cases of calls per 30-step run × (ms − bound):
    the ranking quantity of the kernel redesigns."""
    return sum(c["calls_per_run"] * (c["ms"] - c["bound_ms"]) for c in cases
               if c.get("calls_per_run"))


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | count {torch.cuda.device_count()} "
        f"| torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from pww_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    reports = cuda_build.build()
    log(f"[build] {len(reports)} of {len(cuda_build.SOURCES)} sources compiled and "
        f"linked in {time.perf_counter() - t0:.1f} s into {cuda_build.library_path()}")
    for name, rep in reports.items():
        entry = None
        for line in rep.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = demangle(m.group(1))
            elif "registers" in line or "spill" in line and " 0 bytes spill" not in line:
                log(f"[build] {name} {entry}: {line.split(':', 1)[-1].strip()}")


def demangle(symbol):
    """A kernel's C++ name where c++filt is there, else the symbol."""
    import shutil

    if not shutil.which("c++filt"):
        return symbol
    out = subprocess.run(["c++filt", symbol], capture_output=True, text=True).stdout.strip()
    return re.sub(r"^void |\(.*", "", out.replace("(anonymous namespace)::", "")) or symbol


def phase_kernels():
    """Every K1-K3 case; returns {kernel: [case dicts]}."""
    import torch
    import torch.nn.functional as F

    from pww_tpu_torch.ops import cross_attention_kernel as xk
    from pww_tpu_torch.ops import flash_attention as fa
    from pww_tpu_torch.ops.weight_functions import WeightFunction

    g = torch.Generator(device="cuda").manual_seed(0)
    bf16, B, H, LK = torch.bfloat16, 2, 8, 77

    def randn(*shape, mean=0.0):
        x = torch.randn(shape, generator=g, device="cuda", dtype=torch.float32)
        return (x + mean).to(bf16)

    cases = Cases()
    record = cases.record

    def xattn_case(q, k, v, label, calls=None):
        """K2 on w with a zero uncond row, coef from the default weight function."""
        lq, lk, dh = q.shape[2], k.shape[2], q.shape[3]
        w = torch.rand((B, lq, lk), generator=g, device="cuda")
        w[0] = 0.0
        wf = WeightFunction(0.1, "log1p_sigma", "max")
        coef = (wf.sigma_coef(torch.tensor(14.6, device="cuda"))
                * xk.pww_cross_attention_reduce(q, k, wf)).contiguous()
        got = xk.fused_pww_cross_attention(q, k, v, w, coef)
        want = xk.pww_cross_attention_plain(q, k, v, w, coef)
        mask = (coef[:, None, None, None] * w[:, None] * dh ** -0.5).to(bf16)
        # The kernel rounds P to bf16 for the P·V product, as the TPU kernel
        # does (cross_attention_kernel.py:92), and the plain version keeps P
        # in f32: about 2^-9 of each term, a few 1e-3 of the output in
        # relative L2, so 1e-2 there, K3's limit for K3's reason; the max-abs
        # limit is 2-4 bf16 ulps of the largest output. A dropped key chunk
        # or a bias added after the scale moves the relative error by about
        # 1e-1 (estimated, not run).
        record("pww_cross_attention", label, got, want,
               2**-6 * want.float().abs().max().item(), 1e-2,
               time_ms(lambda: xk.fused_pww_cross_attention(q, k, v, w, coef)),
               time_ms(lambda: xk.pww_cross_attention_plain(q, k, v, w, coef)),
               bound((q.numel() * 2 + k.numel() + v.numel()) * 2 + w.numel() * 4 + B * 4,
                     4 * B * H * lq * lk * dh),
               time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
               flops=4 * B * H * lq * lk * dh, calls=calls)

    def flash_case(l, dh, label, calls=None):
        q, k, v = randn(B, H, l, dh), randn(B, H, l, dh), randn(B, H, l, dh)
        got = fa.flash_self_attention(q, k, v)
        want = fa.self_attention_plain(q, k, v)
        # As K2: P rounded to bf16 for the P·V product, about 2^-9 of each
        # term, 2-3e-3 of the output in relative L2, so 1e-2 there; a wrong
        # scale (dh 48 for 40) or a dropped key tile would move it by about
        # 1e-1 (estimated, not run).
        record("flash_self_attention", label, got, want,
               2**-6 * want.float().abs().max().item(), 1e-2,
               time_ms(lambda: fa.flash_self_attention(q, k, v)),
               time_ms(lambda: fa.self_attention_plain(q, k, v), reps=3),
               bound(4 * q.numel() * 2, 4 * B * H * l * l * dh),
               time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
               flops=4 * B * H * l * l * dh, calls=calls)
        del q, k, v, got, want
        torch.cuda.empty_cache()

    plan_of = getattr(xk, "pww_reduce_plan", None)  # absent in a parent tree

    def reduce_case(qq, kk, mode, label, calls=None):
        """K1 in one mode against its plain version; two calls on the same
        inputs must give bit-identical r."""
        lq, lk, dh = qq.shape[2], kk.shape[2], qq.shape[3]
        if plan_of is not None and mode == "max":
            p = plan_of(B, H, lq, lk, dh)
            log(f"[kernels]   K1 plan at Lq{lq} Lk{lk} dh{dh}: {p.warps} warps x {p.tiles} "
                f"Q tiles, {p.key_chunks} key chunks, {p.ctas} CTAs ({p.row_splits} x "
                f"{p.key_splits} per head), {p.smem_bytes} B shared memory per CTA")
        wf = WeightFunction(0.1, "log1p_sigma", mode)
        got = xk.fused_pww_reduce(qq, kk, wf)
        again = xk.fused_pww_reduce(qq, kk, wf)
        want = xk.pww_cross_attention_reduce(qq, kk, wf)
        # f32 sums of exact bf16 products, in another order; a mean near
        # 0 makes a relative measure meaningless, so no L2 limit
        tol = 1e-4 * max(1.0, want.abs().max().item())
        record("pww_reduce", label, got, want, tol, None,
               time_ms(lambda: xk.fused_pww_reduce(qq, kk, wf)),
               time_ms(lambda: xk.pww_cross_attention_reduce(qq, kk, wf)),
               bound((qq.numel() + kk.numel()) * 2 + B * 4, 2 * B * H * lq * lk * dh),
               None, flops=2 * B * H * lq * lk * dh, calls=calls)
        if not torch.equal(got, again):  # the last-CTA fold must not depend on timing
            log(f"[kernels] pww_reduce {label}: two calls differ, {got.tolist()} vs "
                f"{again.tolist()} FAIL")
            cases.failed.append(f"pww_reduce {label} not bit-identical across calls")

    for (lq, dh) in SHAPES:
        q, k, v = randn(B, H, lq, dh), randn(B, H, LK, dh), randn(B, H, LK, dh)
        # K1: every reduce mode, plus |mean| >> std for std
        for mode in ("max", "mean", "std"):
            reduce_case(q, k, mode, f"Lq{lq} dh{dh} {mode}",
                        calls=5 * STEPS_PER_RUN if mode == "max" else None)
        reduce_case(randn(B, H, lq, dh, mean=4.0), randn(B, H, LK, dh, mean=4.0), "std",
                    f"Lq{lq} dh{dh} std large-mean")
        xattn_case(q, k, v, f"Lq{lq} dh{dh}", calls=5 * STEPS_PER_RUN)
        if lq >= 1024:  # K3: self-attention at the flash sites
            flash_case(lq, dh, f"L{lq} dh{dh}", calls=5 * STEPS_PER_RUN)
    # shapes off the 512² path: K3's other head dims, ragged L and Lq, and
    # K2 with two and four prompt chunks (the last past the w rows' room in
    # shared memory at dh 160, where the kernel reads w from device memory)
    flash_case(1024, 64, "L1024 dh64")
    flash_case(1024, 160, "L1024 dh160")
    flash_case(4000, 40, "L4000 dh40")
    xattn_case(randn(B, H, 4000, 40), randn(B, H, LK, 40), randn(B, H, LK, 40), "Lq4000 dh40")
    xattn_case(randn(B, H, 4096, 40), randn(B, H, 2 * LK, 40), randn(B, H, 2 * LK, 40),
               "Lq4096 dh40 Lk154")
    xattn_case(randn(B, H, 256, 160), randn(B, H, 4 * LK, 160), randn(B, H, 4 * LK, 160),
               "Lq256 dh160 Lk308")
    # K1 at ragged Lq and with two and four prompt chunks, every mode
    for lq, lk, dh in ((4000, LK, 40), (4096, 2 * LK, 40), (256, 4 * LK, 160)):
        q, k = randn(B, H, lq, dh), randn(B, H, lk, dh)
        for mode in ("max", "mean", "std"):
            reduce_case(q, k, mode, f"Lq{lq} dh{dh}{f' Lk{lk}' if lk != LK else ''} {mode}")
    cases.check()
    return cases.by_kernel


def phase_reference():
    """Reduced-depth SD-1.5-width txt2img: card bf16 vs CPU f32."""
    import numpy as np
    import torch

    from pww_tpu_torch.config import CLIPTextConfig, SDModelConfig, UNetConfig, VAEConfig
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.weights.bridge import synthetic_params

    clip = CLIPTextConfig.tiny()
    cfg = SDModelConfig(
        clip=clip,
        unet=UNetConfig(block_out_channels=(320, 640), layers_per_block=1,
                        down_block_has_attn=(True, False), cross_attention_dim=clip.hidden_size),
        vae=VAEConfig.tiny(),
    )
    # std 0.1 rather than 0.02, so that three steps move the latents well
    # away from the initial noise and the comparison sees the UNet's output
    params = synthetic_params(cfg, seed=1, device="cuda", dtype=torch.float32)
    params = {p: {k: v * 5.0 for k, v in sd.items()} for p, sd in params.items()}
    cpu = {p: {k: v.cpu() for k, v in sd.items()} for p, sd in params.items()}
    cm = np.zeros((256, 256, 3), np.uint8)
    cm[:, :128] = (255, 0, 0)
    cm[:, 128:] = (0, 0, 255)
    kw = dict(prompt="a cat sitting next to a dog", color_map_image=cm,
              color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              num_inference_steps=3, seed=0, return_latents=True)
    gpu = PwwPipeline(cfg, params=params, device="cuda", dtype=torch.bfloat16).generate(**kw)
    ref = PwwPipeline(cfg, params=cpu, device="cpu", dtype=torch.float32).generate(**kw)
    rel = float(np.linalg.norm(gpu - ref) / np.linalg.norm(ref))
    ok = np.isfinite(gpu).all() and rel < 5e-2
    log(f"[reference] 256 px, 3 steps, (320, 640)-channel UNet: card bf16 vs CPU f32 "
        f"relative L2 error {rel:.3e} (tol 5e-2) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[reference] card run disagrees with the CPU reference")


def phase_main_path(steps):
    import numpy as np
    import torch

    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.pipeline.facade import paint_with_words
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.tokenizer.clip_bpe import synthetic_tokenizer
    from pww_tpu_torch.weights.bridge import synthetic_params

    cfg = SDModelConfig.sd15()
    t0 = time.perf_counter()
    params = synthetic_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    n_params = sum(v.numel() for sd in params.values() for v in sd.values())
    pipe = PwwPipeline(cfg, params=params, tokenizer=synthetic_tokenizer(49408),
                       device="cuda", dtype=torch.bfloat16, profile=True)
    del params
    torch.cuda.synchronize()
    log(f"[main] SD-1.5, {n_params:.4e} parameters in bf16 on the card, "
        f"set up in {time.perf_counter() - t0:.1f} s")
    cm = np.zeros((512, 512, 3), np.uint8)
    cm[:, :256] = (255, 0, 0)
    cm[:, 256:] = (0, 0, 255)
    kw = dict(color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              color_map_image=cm, input_prompt="a cat sitting next to a dog, realistic photo",
              guidance_scale=7.5, seed=0, preloaded_utils=pipe, device="cuda",
              output_type="np")
    paint_with_words(num_inference_steps=2, **kw)  # warm-up: cuDNN plans, allocator

    counters = launch_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img = paint_with_words(num_inference_steps=steps, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated() / 2**30
    tm = pipe.timings
    log(f"[main] paint_with_words 512², {steps} LMS steps, CFG 7.5: encode "
        f"{tm['encode']:.3f} s, denoise {tm['denoise']:.3f} s "
        f"({tm['denoise'] / steps * 1e3:.1f} ms/step), decode {tm['decode']:.3f} s, "
        f"{total:.3f} s/image, peak {peak:.2f} GiB")
    log(f"[main] launches: {launches}")
    lat = pipe.generate(prompt=kw["input_prompt"], color_map_image=cm,
                        color_context=kw["color_context"], num_inference_steps=steps,
                        seed=0, return_latents=True)
    problems = []
    if img.shape != (1, 512, 512, 3) or img.dtype != np.uint8:
        problems.append(f"image {img.shape} {img.dtype}")
    if not np.isfinite(lat).all() or lat.shape != (1, 64, 64, 4):
        problems.append(f"latents {lat.shape}, finite={np.isfinite(lat).all()}")
    if img.std() == 0:
        problems.append("constant image")
    want = {"fused_pww_reduce": 15 * steps, "fused_pww_cross_attention": 15 * steps,
            "flash_self_attention": 10 * steps, "group_norm": 0, "layer_norm": 0}
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    log(f"[main] image {img.shape} {img.dtype} mean {img.mean():.2f} std {img.std():.2f}; "
        f"latents finite, |max| {np.abs(lat).max():.3f}")
    if problems:
        raise SystemExit(f"[main] {problems}")
    return launches, pipe, kw


def phase_e2e(reps, steps):
    """The main path's s/image ``reps`` times on one pipeline, and the host
    time each K2/K3 wrapper call takes to enqueue (the card held busy by a
    spin kernel meanwhile), for A/B runs of two trees."""
    import numpy as np
    import torch

    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.ops import cross_attention_kernel as xk
    from pww_tpu_torch.ops import flash_attention as fa
    from pww_tpu_torch.pipeline.facade import paint_with_words
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.tokenizer.clip_bpe import synthetic_tokenizer
    from pww_tpu_torch.weights.bridge import synthetic_params

    cfg = SDModelConfig.sd15()
    pipe = PwwPipeline(cfg, params=synthetic_params(cfg, seed=0, device="cuda",
                                                    dtype=torch.bfloat16),
                       tokenizer=synthetic_tokenizer(49408), device="cuda",
                       dtype=torch.bfloat16, profile=True)
    cm = np.zeros((512, 512, 3), np.uint8)
    cm[:, :256] = (255, 0, 0)
    cm[:, 256:] = (0, 0, 255)
    kw = dict(color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              color_map_image=cm, input_prompt="a cat sitting next to a dog, realistic photo",
              guidance_scale=7.5, seed=0, preloaded_utils=pipe, device="cuda",
              output_type="np")
    paint_with_words(num_inference_steps=2, **kw)
    for rep in range(reps):
        t0 = time.perf_counter()
        paint_with_words(num_inference_steps=steps, **kw)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        log(f"[e2e] rep {rep}: {total:.3f} s/image, denoise "
            f"{pipe.timings['denoise'] / steps * 1e3:.1f} ms/step")
    import pww_tpu_torch.models.unet as unet_mod

    names = ("fused_pww_reduce", "fused_pww_cross_attention", "flash_self_attention")
    spent = dict.fromkeys(names, 0.0)

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[name] += time.perf_counter() - t0
            return out
        return call

    wrapped = {n: getattr(unet_mod, n) for n in names}
    for n, fn in wrapped.items():
        setattr(unet_mod, n, timed(n, fn))
    try:
        paint_with_words(num_inference_steps=steps, **kw)
        torch.cuda.synchronize()
    finally:
        for n, fn in wrapped.items():
            setattr(unet_mod, n, fn)
    log(f"[e2e] host ms per step inside the UNet's kernel wrappers: " + ", ".join(
        f"{n} {t / steps * 1e3:.2f}" for n, t in spent.items()) + f"; denoise "
        f"{pipe.timings['denoise'] / steps * 1e3:.1f} ms/step in that call")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((2, 8, 4096, 40), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    kx, vx = k[:, :, :77].contiguous(), v[:, :, :77].contiguous()
    w = torch.rand((2, 4096, 77), generator=g, device="cuda")
    coef = torch.ones(2, device="cuda")
    for name, fn in (("K2", lambda: xk.fused_pww_cross_attention(q, kx, vx, w, coef)),
                     ("K3", lambda: fa.flash_self_attention(q, k, v))):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000_000)  # about a second of device time
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        host_us = (time.perf_counter() - t0) * 1e4
        torch.cuda.synchronize()
        log(f"[e2e] {name} wrapper at the L 4096 shape: {host_us:.1f} us of host time per call")


def launch_counters():
    """Every kernel wrapper, K1-K5; each counts its own launches."""
    from pww_tpu_torch.ops import cross_attention_kernel as xk
    from pww_tpu_torch.ops import flash_attention as fa
    from pww_tpu_torch.ops import group_norm as gn
    from pww_tpu_torch.ops import layer_norm as ln

    return (xk.fused_pww_reduce, xk.fused_pww_cross_attention, fa.flash_self_attention,
            gn.group_norm, ln.layer_norm)


GROUPS = (  # device-kernel name fragments → group, first match wins
    ("K1 pww_reduce", ("pww_reduce_kernel",)),
    ("K2 pww_cross_attention", ("pww_xattn_kernel",)),
    ("K3 flash_self_attention", ("flash_kernel",)),
    ("K4 group_norm", ("gn_cluster",)),
    ("K5 layer_norm", ("ln_rows",)),
    ("conv", ("conv", "xmma", "implicit", "winograd", "fprop")),
    ("gemm", ("gemm", "nvjet", "cutlass", "cublas")),
    ("norm", ("norm",)),
    ("softmax", ("softmax",)),
)


def phase_profile(run, tag, steps=5):
    """Device time by kernel group over one ``run(steps)`` call (torch.profiler);
    returns {group: (device ms, device kernels) per wrapper call}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    counters = dict(zip((g for g, _ in GROUPS), launch_counters()))
    for c in counters.values():
        c.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, counts, kernels = {}, {}, []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us <= 0:
            continue
        name = ev.key
        group = next((g for g, frags in GROUPS
                      if any(f in name.lower() for f in frags)), "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3
        counts[group] = counts.get(group, 0) + ev.count
        kernels.append((us / 1e3, ev.count, name))
    busy = sum(groups.values())
    if busy == 0:
        raise SystemExit(f"[profile {tag}] the trace holds no device time")
    log(f"[profile {tag}] {steps}-step call: {wall * 1e3:.1f} ms wall, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / (wall * 1e3):.3f}")
    log(f"[profile {tag}] by group (ms): " + ", ".join(
        f"{g} {t:.2f}" for g, t in sorted(groups.items(), key=lambda x: -x[1])))
    for ms, count, name in sorted(kernels, reverse=True)[:8]:
        log(f"[profile {tag}]   {ms:8.2f} ms {count:6d}x {name[:90]}")
    per_launch = {g: (groups.get(g, 0.0) / c.launches, counts.get(g, 0) / c.launches)
                  for g, c in counters.items() if c.launches}
    log(f"[profile {tag}] device ms per wrapper call: " + ", ".join(
        f"{g} {t:.4f}" for g, (t, _) in per_launch.items()))
    log(f"[profile {tag}] device kernels per wrapper call: " + ", ".join(
        f"{g} {k:g}" for g, (_, k) in per_launch.items()))
    return per_launch


def synthetic_init_image(size=512, seed=0):
    """A smooth RGB image with texture, from a numpy seed (uint8, HWC)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.stack([xx, yy, 0.5 + 0.5 * np.sin(xx * 20.0)], -1) * 220.0
    return np.clip(img + rng.normal(0, 15, img.shape), 0, 255).astype(np.uint8)


def box_mask(size=512):
    import numpy as np

    m = np.zeros((size, size), np.float32)
    m[size // 4: 3 * size // 4, size // 3: 5 * size // 6] = 1.0
    return m


def phase_img2img(pipe, kw, steps):
    """One full-width img2img call (strength 0.5) on the main pipeline."""
    import torch

    from pww_tpu_torch.pipeline.facade import paint_with_words
    from pww_tpu_torch.schedulers.schedules import t_start_from_strength

    run = steps - t_start_from_strength(steps, 0.5)
    init = synthetic_init_image()
    paint_with_words(num_inference_steps=2, init_image=init, strength=0.5, **kw)  # warm-up
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    img = paint_with_words(num_inference_steps=steps, init_image=init, strength=0.5, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    tm = pipe.timings
    log(f"[img2img] 512², strength 0.5, {run} of {steps} LMS steps: encode "
        f"{tm['encode']:.3f} s (VAE encode included), denoise {tm['denoise']:.3f} s, decode "
        f"{tm['decode']:.3f} s, {total:.3f} s/image; launches {launches}")
    want = {"fused_pww_reduce": 15 * run, "fused_pww_cross_attention": 15 * run,
            "flash_self_attention": 10 * run, "group_norm": 0, "layer_norm": 0}
    if launches != want or img.shape != (1, 512, 512, 3) or img.std() == 0:
        raise SystemExit(f"[img2img] launches {launches} != {want}, or image "
                         f"{img.shape} std {img.std():.2f}")


def inpaint_pipeline():
    """SD-1.5-inpainting at full width, the norm kernels on, synthetic weights."""
    import dataclasses

    import numpy as np
    import torch

    from pww_tpu_torch.config import SDModelConfig, UNetConfig, VAEConfig
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.tokenizer.clip_bpe import synthetic_tokenizer
    from pww_tpu_torch.weights.bridge import synthetic_params

    cfg = SDModelConfig(
        unet=dataclasses.replace(UNetConfig.sd15_inpaint(), fused_group_norm=True,
                                 fused_layer_norm=True),
        vae=dataclasses.replace(VAEConfig.sd15(), fused_group_norm=True))
    t0 = time.perf_counter()
    params = synthetic_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    pipe = PwwPipeline(cfg, params=params, tokenizer=synthetic_tokenizer(49408),
                       device="cuda", dtype=torch.bfloat16, profile=True)
    del params
    torch.cuda.synchronize()
    log(f"[inpaint] SD-1.5-inpainting (conv_in {pipe.unet.conv_in.in_channels} channels), "
        f"fused_group_norm and fused_layer_norm on, set up in {time.perf_counter() - t0:.1f} s")
    cm = np.zeros((512, 512, 3), np.uint8)
    cm[:, :256] = (255, 0, 0)
    cm[:, 256:] = (0, 0, 255)
    kw = dict(color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              color_map_image=cm, init_image=synthetic_init_image(), mask_image=box_mask(),
              input_prompt="a cat sitting next to a dog, realistic photo",
              guidance_scale=7.5, seed=0, strength=1.0, preloaded_utils=pipe,
              device="cuda", output_type="np")
    return pipe, kw


def record_norm_sites(kw):
    """Run one inpaint step, record every K4 and K5 call's signature, and
    check them against K4_SITES and K5_SITES."""
    from pww_tpu_torch.ops import group_norm as gn
    from pww_tpu_torch.ops import layer_norm as ln
    from pww_tpu_torch.pipeline.facade import paint_with_words_inpaint

    gn_sites, ln_sites = {}, {}
    k4, k5 = gn.group_norm, ln.layer_norm

    def gn_rec(x, weight, bias, *, groups, eps, silu=False, add=None, out_dtype=None):
        key = (tuple(x.shape), groups, eps, silu, add is not None)
        gn_sites[key] = gn_sites.get(key, 0) + 1
        return k4(x, weight, bias, groups=groups, eps=eps, silu=silu, add=add,
                  out_dtype=out_dtype)

    def ln_rec(x, weight, bias, *, eps, out_dtype=None):
        key = (tuple(x.shape), eps)
        ln_sites[key] = ln_sites.get(key, 0) + 1
        return k5(x, weight, bias, eps=eps, out_dtype=out_dtype)

    # the wrappers count into whatever their module's name points at
    gn_rec.launches = ln_rec.launches = 0
    gn.group_norm, ln.layer_norm = gn_rec, ln_rec
    try:
        paint_with_words_inpaint(num_inference_steps=1, **kw)  # also the warm-up
    finally:
        gn.group_norm, ln.layer_norm = k4, k5
    log(f"[norms] one inpaint step: {sum(gn_sites.values())} K4 calls at {len(gn_sites)} "
        f"signatures, {sum(ln_sites.values())} K5 calls at {len(ln_sites)}")
    want_gn = {site: k4_calls(site, 1) for site in K4_SITES}
    if gn_sites != want_gn or ln_sites != K5_SITES:
        raise SystemExit(f"[norms] recorded sites differ from the table: K4 {gn_sites} != "
                         f"{want_gn} or K5 {ln_sites} != {K5_SITES}")


def phase_norm_kernels():
    """K4 and K5 against their plain versions at every site signature of the
    inpaint path (K4_SITES, K5_SITES) and K4's two cases off it."""
    import torch
    import torch.nn.functional as F

    from pww_tpu_torch.ops import group_norm as gn
    from pww_tpu_torch.ops import layer_norm as ln

    g = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16

    def randn(*shape, mean=0.0, std=1.0):
        x = torch.randn(shape, generator=g, device="cuda", dtype=torch.float32)
        return (x * std + mean).to(bf16)

    cases = Cases()
    # Both sides take f32 statistics of the same bf16 values in another order
    # and round y to bf16, so an element may round the other way: one bf16
    # ulp, 2^-8 to 2^-7 of it. The limits are 2-4 ulps of the largest output
    # and 1e-3 in relative L2, which one-ulp flips reach only on a few % of
    # the elements; a wrong group, channel or pre-add moves it by about 1e-1.
    gn_cases = [(k, 0.0) for k in K4_SITES]
    big_unet = max((k for k in K4_SITES if k[0][0] == 2), key=lambda k: (math.prod(k[0]), k[4]))
    gn_cases.append((big_unet, 8.0))  # |mean| ≫ std: the fast variance cancels
    gn_cases += [(k, 0.0) for k in K4_OFF_PATH]
    plan_of = getattr(gn, "group_norm_plan", None)  # absent in a parent tree
    for site, mean in gn_cases:
        shape, groups, eps, silu, has_add = site
        n, c = shape[:2]
        x = randn(*shape, mean=mean)
        w, b = randn(c, mean=1.0, std=0.1), randn(c, std=0.1)
        add = randn(n, c) if has_add else None
        kw = dict(groups=groups, eps=eps, silu=silu, add=add)
        got = gn.group_norm(x, w, b, **kw)
        want = gn.group_norm_plain(x, w, b, **kw)
        lib = None
        if not silu and add is None:
            lib = time_ms(lambda: F.group_norm(x, groups, w, b, eps))
        nbytes = 2 * x.numel() * 2 + (n * c * 2 if has_add else 0) + 2 * c * 2
        bnd = bound(nbytes, (12 if silu else 8) * x.numel(), F32_FLOPS_PER_S)
        label = k4_label(site, mean)
        cases.record("group_norm", label, got, want, 2**-6 * want.float().abs().max().item(),
                     1e-3, time_ms(lambda: gn.group_norm(x, w, b, **kw)),
                     time_ms(lambda: gn.group_norm_plain(x, w, b, **kw), reps=5), bnd, lib,
                     calls=k4_calls(site, STEPS_PER_RUN) if site in K4_SITES and not mean
                     else None)
        if plan_of is not None:
            cpg = c // groups
            plan = plan_of(cpg * math.prod(shape[2:]), cpg, n * groups,
                           gn._max_cluster(torch.cuda.current_device()))
            log(f"[norms]   plan: cluster {plan.cluster}, piece {plan.piece}, resident "
                f"{plan.resident}{' (streamed)' if plan.streamed else ''}, "
                f"{plan.smem_bytes} B shared memory and {plan.threads} threads per CTA")
            if plan.streamed and site in K4_SITES:
                # the alternative: as much of each piece resident as fits
                # (one CTA per SM), the rest read twice
                res = (gn.SMEM_PER_CTA - gn._smem_bytes(0, cpg)) // 16 * 8
                held = plan._replace(resident=res, smem_bytes=gn._smem_bytes(res, cpg),
                                     threads=512)
                run = lambda: gn._launch(x, w, b, add, groups=groups, eps=eps, silu=silu,
                                         out_dtype=bf16, plan=held)
                cases.record("group_norm", label + " most-resident", run(), want,
                             2**-6 * want.float().abs().max().item(), 1e-3, time_ms(run),
                             cases.by_kernel["group_norm"][-1]["plain_ms"], bnd, lib)
                # what one read and one write of x take on this card
                copy = torch.empty_like(x)
                log(f"[norms]   a copy of x (one read, one write): "
                    f"{time_ms(lambda: copy.copy_(x)):.4f} ms")
        del x, got, want
        torch.cuda.empty_cache()
    for site, mean in [(k, 0.0) for k in K5_SITES] + [(max(K5_SITES), 8.0)]:
        shape, eps = site
        c = shape[-1]
        x = randn(*shape, mean=mean)
        w, b = randn(c, mean=1.0, std=0.1), randn(c, std=0.1)
        got = ln.layer_norm(x, w, b, eps=eps)
        want = ln.layer_norm_plain(x, w, b, eps=eps)
        cases.record("layer_norm", k5_label(site, mean),
                     got, want, 2**-6 * want.float().abs().max().item(), 1e-3,
                     time_ms(lambda: ln.layer_norm(x, w, b, eps=eps)),
                     time_ms(lambda: ln.layer_norm_plain(x, w, b, eps=eps)),
                     bound(2 * x.numel() * 2 + 2 * c * 2, 8 * x.numel(), F32_FLOPS_PER_S),
                     time_ms(lambda: F.layer_norm(x, (c,), w, b, eps)),
                     calls=K5_SITES[site] * STEPS_PER_RUN if not mean else None)
    torch.cuda.empty_cache()
    for name, cs in cases.by_kernel.items():
        log(f"[norms] {name}: loss_ms_per_run {loss_ms_per_run(cs):.3f}")
    cases.check()
    return cases.by_kernel


def phase_inpaint_reference():
    """Reduced-depth SD-1.5-width 9-channel inpaint with the norm kernels on:
    card bf16 vs CPU f32 (where K4 and K5 take their plain versions)."""
    import dataclasses

    import numpy as np
    import torch

    from pww_tpu_torch.config import CLIPTextConfig, SDModelConfig, UNetConfig, VAEConfig
    from pww_tpu_torch.ops import group_norm as gn
    from pww_tpu_torch.ops import layer_norm as ln
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.weights.bridge import synthetic_params

    clip = CLIPTextConfig.tiny()
    cfg = SDModelConfig(
        clip=clip,
        unet=UNetConfig(in_channels=9, block_out_channels=(320, 640), layers_per_block=1,
                        down_block_has_attn=(True, False),
                        cross_attention_dim=clip.hidden_size, fused_group_norm=True,
                        fused_layer_norm=True),
        vae=dataclasses.replace(VAEConfig.tiny(), fused_group_norm=True),
    )
    params = synthetic_params(cfg, seed=2, device="cuda", dtype=torch.float32)
    params = {p: {k: v * 5.0 for k, v in sd.items()} for p, sd in params.items()}
    cpu = {p: {k: v.cpu() for k, v in sd.items()} for p, sd in params.items()}
    cm = np.zeros((256, 256, 3), np.uint8)
    cm[:, :128] = (255, 0, 0)
    cm[:, 128:] = (0, 0, 255)
    kw = dict(prompt="a cat sitting next to a dog", color_map_image=cm,
              color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              init_image=synthetic_init_image(256), mask_image=box_mask(256), strength=1.0,
              num_inference_steps=3, seed=0, vae_sample_mode="mean", return_latents=True)
    gn.group_norm.launches = ln.layer_norm.launches = 0
    gpu = PwwPipeline(cfg, params=params, device="cuda", dtype=torch.bfloat16).generate(**kw)
    launched = (gn.group_norm.launches, ln.layer_norm.launches)
    ref = PwwPipeline(cfg, params=cpu, device="cpu", dtype=torch.float32).generate(**kw)
    rel = float(np.linalg.norm(gpu - ref) / np.linalg.norm(ref))
    ok = np.isfinite(gpu).all() and rel < 5e-2 and min(launched) > 0
    log(f"[inpaint reference] 256 px, 3 steps, 9-channel (320, 640)-channel UNet, norm "
        f"kernels on (K4 {launched[0]}, K5 {launched[1]} launches): card bf16 vs CPU f32 "
        f"relative L2 error {rel:.3e} (tol 5e-2) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[inpaint reference] card run disagrees with the CPU reference")


def phase_inpaint(pipe, kw, steps):
    """The inpaint path at full width, launch counts checked."""
    import numpy as np
    import torch

    from pww_tpu_torch.pipeline.facade import paint_with_words_inpaint

    counters = launch_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img = paint_with_words_inpaint(num_inference_steps=steps, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated() / 2**30
    tm = pipe.timings
    log(f"[inpaint] paint_with_words_inpaint 512², {steps} LMS steps, strength 1.0, CFG 7.5: "
        f"encode {tm['encode']:.3f} s (two VAE encodes included), denoise "
        f"{tm['denoise']:.3f} s ({tm['denoise'] / steps * 1e3:.1f} ms/step), decode "
        f"{tm['decode']:.3f} s, {total:.3f} s/image, peak {peak:.2f} GiB")
    log(f"[inpaint] launches: {launches}")
    lat = pipe.generate(prompt=kw["input_prompt"], color_map_image=kw["color_map_image"],
                        color_context=kw["color_context"], init_image=kw["init_image"],
                        mask_image=kw["mask_image"], strength=1.0,
                        num_inference_steps=steps, seed=0, return_latents=True)
    want = {"fused_pww_reduce": 15 * steps, "fused_pww_cross_attention": 15 * steps,
            "flash_self_attention": 10 * steps,
            "group_norm": 61 * steps + 2 * 22 + 30, "layer_norm": 48 * steps}
    problems = []
    if img.shape != (1, 512, 512, 3) or img.dtype != np.uint8 or img.std() == 0:
        problems.append(f"image {img.shape} {img.dtype} std {img.std():.2f}")
    if not np.isfinite(lat).all() or lat.shape != (1, 64, 64, 4):
        problems.append(f"latents {lat.shape}, finite={np.isfinite(lat).all()}")
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    log(f"[inpaint] image {img.shape} {img.dtype} mean {img.mean():.2f} std {img.std():.2f}; "
        f"latents finite, |max| {np.abs(lat).max():.3f}")
    if problems:
        raise SystemExit(f"[inpaint] {problems}")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30, help="LMS steps of the main path")
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-3 only (K1-K5), then their cases as one JSON line and "
                         "each kernel's loss_ms_per_run (A/B of two trees)")
    ap.add_argument("--e2e-reps", type=int, default=0,
                    help="phases 1-2, then the main path's s/image this many times and the "
                         "K2/K3 wrappers' host time per call (A/B of two trees)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    smi = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_build()
    if args.e2e_reps:
        phase_e2e(args.e2e_reps, args.steps)
        print(f"card: {smi}")
        return 0
    cases = phase_kernels()
    cases.update(phase_norm_kernels())
    if args.kernels_only:
        print(json.dumps(cases))
        print(json.dumps({name: loss_ms_per_run(cs) for name, cs in cases.items()}))
        print(f"card: {smi}")
        return 0
    phase_reference()
    launches, pipe, kw = phase_main_path(args.steps)
    from pww_tpu_torch.pipeline.facade import paint_with_words, paint_with_words_inpaint

    profiled = phase_profile(lambda n: paint_with_words(num_inference_steps=n, **kw), "main")
    if profiled["K1 pww_reduce"][1] != 1:
        raise SystemExit("[profile main] K1 is not one device kernel per call")
    phase_img2img(pipe, kw, args.steps)
    del pipe, kw
    import torch

    torch.cuda.empty_cache()
    ipipe, ikw = inpaint_pipeline()
    record_norm_sites(ikw)
    phase_inpaint_reference()
    ilaunches = phase_inpaint(ipipe, ikw, args.steps)
    iprofiled = phase_profile(
        lambda n: paint_with_words_inpaint(num_inference_steps=n, **ikw), "inpaint")
    for group in ("K1 pww_reduce", "K4 group_norm"):
        if iprofiled[group][1] != 1:
            raise SystemExit(f"[profile inpaint] {group} is not one device kernel per call")

    kernels = []
    for name, (source, replaces, counter, group, head) in KERNELS.items():
        cs = cases[name]
        top = next(c for c in cs if c["case"] == head)
        norm = name in ("group_norm", "layer_norm")  # their path is the inpaint path
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=(ilaunches if norm else launches)[counter],
            max_abs_err=max(c["max_abs_err"] for c in cs),
            rel_l2_err=max(c["rel_l2_err"] for c in cs),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top["library_ms"], shape=top["case"],
            loss_ms_per_run=loss_ms_per_run(cs),
            main_path_device_ms_per_call=(iprofiled if norm else profiled).get(group, (None,))[0],
            inpaint_path_launches=ilaunches[counter], cases=cs,
        ))
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
