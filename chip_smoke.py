#!/usr/bin/env python3
"""Drive the PyTorch port (pww_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py [--steps N]

Phases, each printing its own lines; any failure ends the run non-zero:

1. device: the card's name and power limit, TF32 switched off for the f32
   reference products;
2. build: nvcc compiles every kernel from pww_tpu_torch/csrc;
3. kernels: K1 pww_reduce, K2 pww_cross_attention and K3
   flash_self_attention against their plain PyTorch versions at every shape
   of SD-1.5's 512² main path, bf16 inputs from a seeded generator, with
   CUDA-event timings of the kernel, the plain version, a one-call library
   yardstick where one exists, and the least time the card could take;
4. reference: a reduced-depth SD-1.5-width txt2img (256 px, 3 steps) on the
   card in bf16 against the same pipeline on the CPU in f32;
5. main path: SD-1.5 at full width (synthetic N(0, 0.02) weights) through
   ``paint_with_words``, 512², cat/dog color map, CFG 7.5, LMS; the kernel
   launch counters are zeroed before the run and must read K1 = K2 = 15·N
   and K3 = 10·N after it;
6. profile: device time by kernel group over a 5-step call (torch.profiler),
   the device's idle share, and each kernel's device time per call.

Then a JSON line with every kernel, the card's name and power limit, and
last {"ok": true, "device": {...}}.
Imports nothing of JAX. Needs one card.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores
# SD-1.5 at 512²: the (Lq, head dim) of the attention sites, five of each per
# UNet call (self-attention takes K3 at the first two, cross-attention K1+K2
# at all three)
SHAPES = ((4096, 40), (1024, 80), (256, 160))
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


def bound(nbytes, flops):
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


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
        for line in rep.splitlines():
            if "registers" in line or "spill" in line and " 0 bytes spill" not in line:
                log(f"[build] {name}: {line.strip()}")


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

    cases = {"pww_reduce": [], "pww_cross_attention": [], "flash_self_attention": []}
    failed = []

    def record(kernel, label, got, want, tol, rel_tol, ms, plain_ms, bnd, library_ms):
        diff = got.float() - want.float()
        err = diff.abs().max().item()
        rel = (diff.norm() / want.float().norm()).item()
        ok = (bool(torch.isfinite(got.float()).all()) and err <= tol
              and (rel_tol is None or rel <= rel_tol))
        cases[kernel].append(dict(case=label, max_abs_err=err, tol=tol, rel_l2_err=rel,
                                  rel_tol=rel_tol, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
                                  bound_by=bnd[1], library_ms=library_ms))
        lib = "null" if library_ms is None else f"{library_ms:.4f}"
        log(f"[kernels] {kernel} {label}: max_abs_err {err:.3e} (tol {tol:.3e}), "
            f"rel_l2 {rel:.3e} (tol {rel_tol}) {'ok' if ok else 'FAIL'} | kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib} ms, "
            f"bound {bnd[0]:.4f} ms ({bnd[1]})")
        if not ok:
            failed.append(f"{kernel} {label}")

    for (lq, dh) in SHAPES:
        q, k, v = randn(B, H, lq, dh), randn(B, H, LK, dh), randn(B, H, LK, dh)
        # K1: every reduce mode, plus |mean| >> std for std
        for mode, qq, kk, tag in [("max", q, k, ""), ("mean", q, k, ""), ("std", q, k, ""),
                                  ("std", randn(B, H, lq, dh, mean=4.0),
                                   randn(B, H, LK, dh, mean=4.0), " large-mean")]:
            wf = WeightFunction(0.1, "log1p_sigma", mode)
            got = xk.fused_pww_reduce(qq, kk, wf)
            want = xk.pww_cross_attention_reduce(qq, kk, wf)
            # f32 sums of exact bf16 products, in another order; a mean near
            # 0 makes a relative measure meaningless, so no L2 limit
            tol = 1e-4 * max(1.0, want.abs().max().item())
            record("pww_reduce", f"Lq{lq} dh{dh} {mode}{tag}", got, want, tol, None,
                   time_ms(lambda: xk.fused_pww_reduce(qq, kk, wf)),
                   time_ms(lambda: xk.pww_cross_attention_reduce(qq, kk, wf)),
                   bound((qq.numel() + kk.numel()) * 2 + B * 4, 2 * B * H * lq * LK * dh),
                   None)
        # K2: w with a zero uncond row, coef from the default weight function
        w = torch.rand((B, lq, LK), generator=g, device="cuda")
        w[0] = 0.0
        wf = WeightFunction(0.1, "log1p_sigma", "max")
        coef = (wf.sigma_coef(torch.tensor(14.6, device="cuda"))
                * xk.pww_cross_attention_reduce(q, k, wf)).contiguous()
        got = xk.fused_pww_cross_attention(q, k, v, w, coef)
        want = xk.pww_cross_attention_plain(q, k, v, w, coef)
        mask = (coef[:, None, None, None] * w[:, None] * dh ** -0.5).to(bf16)
        # Both sides compute in f32 and round the output to bf16, so an
        # element that rounds the other way is one bf16 ulp (2^-8 to 2^-7 of
        # it) apart: the limits are 2-4 ulps of the largest output, and in
        # relative L2 1e-3, which one-ulp flips reach only on a few % of the
        # elements.
        record("pww_cross_attention", f"Lq{lq} dh{dh}", got, want,
               2**-6 * want.float().abs().max().item(), 1e-3,
               time_ms(lambda: xk.fused_pww_cross_attention(q, k, v, w, coef)),
               time_ms(lambda: xk.pww_cross_attention_plain(q, k, v, w, coef)),
               bound((q.numel() * 2 + k.numel() + v.numel()) * 2 + w.numel() * 4 + B * 4,
                     4 * B * H * lq * LK * dh),
               time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)))
        if lq < 1024:
            continue
        # K3: self-attention at the flash sites
        q, k, v = randn(B, H, lq, dh), randn(B, H, lq, dh), randn(B, H, lq, dh)
        got = fa.flash_self_attention(q, k, v)
        want = fa.self_attention_plain(q, k, v)
        # As K2, plus P rounded to bf16 for the P·V product: about 2^-9 of
        # each term, 2-3e-3 of the output in relative L2, so 1e-2 there; a
        # wrong scale (dh 48 for 40) or a dropped key tile would move it by
        # about 1e-1 (estimated, not run).
        record("flash_self_attention", f"L{lq} dh{dh}", got, want,
               2**-6 * want.float().abs().max().item(), 1e-2,
               time_ms(lambda: fa.flash_self_attention(q, k, v)),
               time_ms(lambda: fa.self_attention_plain(q, k, v), reps=3),
               bound(4 * q.numel() * 2, 4 * B * H * lq * lq * dh),
               time_ms(lambda: F.scaled_dot_product_attention(q, k, v)))
        del got, want
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"[kernels] outside tolerance: {failed}")
    return cases


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
    from pww_tpu_torch.ops import cross_attention_kernel as xk
    from pww_tpu_torch.ops import flash_attention as fa
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

    counters = (xk.fused_pww_reduce, xk.fused_pww_cross_attention, fa.flash_self_attention)
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
            "flash_self_attention": 10 * steps}
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    log(f"[main] image {img.shape} {img.dtype} mean {img.mean():.2f} std {img.std():.2f}; "
        f"latents finite, |max| {np.abs(lat).max():.3f}")
    if problems:
        raise SystemExit(f"[main] {problems}")
    return launches, pipe, kw


GROUPS = (  # device-kernel name fragments → group, first match wins
    ("K1 pww_reduce", ("reduce_partials", "reduce_combine")),
    ("K2 pww_cross_attention", ("pww_xattn_kernel",)),
    ("K3 flash_self_attention", ("flash_kernel",)),
    ("conv", ("conv", "xmma", "implicit", "winograd", "fprop")),
    ("gemm", ("gemm", "nvjet", "cutlass", "cublas")),
    ("norm", ("norm",)),
    ("softmax", ("softmax",)),
)


def phase_profile(pipe, kw, steps=5):
    """Device time by kernel group over one ``steps``-step call (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pww_tpu_torch.pipeline.facade import paint_with_words

    from pww_tpu_torch.ops import cross_attention_kernel as xk
    from pww_tpu_torch.ops import flash_attention as fa

    counters = {"K1 pww_reduce": xk.fused_pww_reduce,
                "K2 pww_cross_attention": xk.fused_pww_cross_attention,
                "K3 flash_self_attention": fa.flash_self_attention}
    for c in counters.values():
        c.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        paint_with_words(num_inference_steps=steps, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, kernels = {}, []
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
        kernels.append((us / 1e3, ev.count, name))
    busy = sum(groups.values())
    if busy == 0:
        raise SystemExit("[profile] the trace holds no device time")
    log(f"[profile] {steps}-step paint_with_words: {wall * 1e3:.1f} ms wall, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / (wall * 1e3):.3f}")
    log("[profile] by group (ms): " + ", ".join(
        f"{g} {t:.2f}" for g, t in sorted(groups.items(), key=lambda x: -x[1])))
    for ms, count, name in sorted(kernels, reverse=True)[:8]:
        log(f"[profile]   {ms:8.2f} ms {count:6d}x {name[:90]}")
    per_launch = {g: groups.get(g, 0.0) / c.launches for g, c in counters.items()}
    log("[profile] device ms per wrapper call on the main path: " + ", ".join(
        f"{g} {t:.4f}" for g, t in per_launch.items()))
    return per_launch


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30, help="LMS steps of the main path")
    args = ap.parse_args()
    t_start = time.perf_counter()
    smi = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_build()
    cases = phase_kernels()
    phase_reference()
    launches, pipe, kw = phase_main_path(args.steps)
    profiled = phase_profile(pipe, kw)

    kernels = []
    for name, (source, replaces, counter, group, head) in KERNELS.items():
        cs = cases[name]
        top = next(c for c in cs if c["case"] == head)  # the largest main-path shape
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[counter],
            max_abs_err=max(c["max_abs_err"] for c in cs),
            rel_l2_err=max(c["rel_l2_err"] for c in cs),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top["library_ms"], shape=head,
            main_path_device_ms_per_call=profiled[group], cases=cs,
        ))
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
