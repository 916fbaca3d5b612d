"""A dry run of the port's multi-GPU paths on the tiny configs.

    python -m pww_tpu_torch.parallel.dryrun --world-size 4 --device cpu

Spawns ``--world-size`` ranks (gloo on the CPU; on the card NCCL, one card a
rank, or ``--backend gloo`` for ranks sharing one card), lays them out as a
(dp, tp) mesh, tp 2 where the world size is even, and runs every case of
the JAX package's ``dryrun_multichip`` (``__graft_entry__.py:90-280``) but
the spatial one (ROADMAP A.20b), printing one line per case from rank 0:

  1. a hand-rolled denoise step: the UNet cut over tp, the CFG batch over
     dp, one LMS step, gathered and held against the UNet whole;
  2. ``PwwPipeline(mesh=...).generate`` (dp samples);
  3. the tiny SDXL config;
  4. a custom weight-function callable (split CFG, the heads gathered);
  5. a 9-channel inpaint;
  6. ``generate_batch`` of img2img requests (one seed each);
  7. a textual-inversion gradient step: the token table's gradient of each
     rank's rows, summed over dp, held against the whole batch's.
"""
from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np
import torch


def _scaled(state, factor: float = 5.0):
    """Synthetic N(0, 0.02) weights times ``factor``: layers that move their
    inputs, so that a wrong cut shows."""
    return {k: v * factor for k, v in state.items()}


def _rank_cases(rank: int, device: str) -> List[str]:
    import torch.distributed as dist

    from ..config import SDModelConfig
    from ..ops.weight_functions import WeightFunction
    from ..pipeline.pipeline import PwwPipeline
    from ..schedulers.schedules import make_scheduler
    from ..types import PwwState
    from ..weights.bridge import build_models, synthetic_state
    from .mesh import gather_batch, make_mesh, shard_batch, shard_params

    if device == "cpu":
        torch.set_num_threads(1)
    world = dist.get_world_size()
    tp = 2 if world % 2 == 0 and world >= 2 else 1
    dp = world // tp
    mesh = make_mesh(dp, tp, device_type=device)
    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" else "cpu"
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    lines = [f"mesh: dp={dp} tp={tp} over {world} ranks ({device})"]

    # 1. a hand-rolled denoise step
    cfg = SDModelConfig.tiny()
    g = torch.Generator(device=dev).manual_seed(0)
    unet_whole = build_models(cfg, parts=("unet",))["unet"]
    state = _scaled(synthetic_state(unet_whole, g, dtype))
    unet_whole.load_state_dict(state, assign=True)
    unet = build_models(cfg, parts=("unet",))["unet"]
    unet.load_state_dict({k: v.clone() for k, v in state.items()}, assign=True)
    shard_params(unet.eval(), mesh)
    h = w = 8
    n = 2 * dp
    gen = torch.Generator(device="cpu").manual_seed(1)
    lat = torch.randn(n, 4, h, w, generator=gen).to(dev)
    text = torch.randn(2 * n, 77, cfg.unet.cross_attention_dim, generator=gen).to(dev, dtype)
    weights = {h * w: torch.rand(1, h * w, 77, generator=gen).expand(2 * n, -1, -1),
               h * w // 4: torch.rand(1, h * w // 4, 77, generator=gen).expand(2 * n, -1, -1)}
    weights = {k: v.to(dev) for k, v in weights.items()}
    schedule = make_scheduler("lms").set_timesteps(4, dev)

    def step(model, lat, text, weights):
        pww = PwwState(weights=weights, weight_orig=None, sigma=schedule.sigma(0),
                       weight_fn=WeightFunction())
        lat_in = schedule.scale_model_input(lat, 0).to(dtype)
        with torch.no_grad():
            eps = model(torch.cat([lat_in, lat_in]), schedule.timesteps[0], text, pww).float()
        k = lat.shape[0]
        eps = eps[:k] + 7.5 * (eps[k:] - eps[:k])
        return schedule.step(eps, 0, lat, schedule.init_state(lat.shape, dev))[0]

    def cfg_rows(x):
        return torch.cat([shard_batch(x[:n], mesh), shard_batch(x[n:], mesh)])

    got = gather_batch(step(unet, shard_batch(lat, mesh), cfg_rows(text),
                            {k: cfg_rows(v) for k, v in weights.items()}), mesh, n)
    want = step(unet_whole.eval(), lat, text, weights)
    lines.append(f"denoise step ok: {tuple(got.shape)} mean {got.mean().item():.6f}, "
                 f"max |sharded - whole| {(got - want).abs().max().item():.3e}")

    # 2-6. the pipeline through the mesh
    cm = np.zeros((64, 64, 3), np.uint8)
    cm[:, :32] = (255, 0, 0)
    kw = dict(prompt="a cat", color_map_image=cm, color_context={(255, 0, 0): "cat,1.0"},
              num_inference_steps=2, seed=0, num_samples=dp, output_type="np")
    pipe = PwwPipeline(cfg, device=dev, dtype=dtype, mesh=mesh)
    imgs = pipe.generate(**kw)
    lines.append(f"mesh generate ok: {imgs.shape} mean {imgs.mean():.4f}")
    pipe_xl = PwwPipeline(SDModelConfig.tiny_xl(), device=dev, dtype=dtype, mesh=mesh)
    imgs = pipe_xl.generate(**kw)
    lines.append(f"mesh SDXL generate ok: {imgs.shape} mean {imgs.mean():.4f}")
    del pipe_xl
    imgs = pipe.generate(weight_function=lambda wgt, s, qk: 0.3 * wgt * torch.log1p(s) * qk.std(),
                         **kw)
    lines.append(f"mesh custom-weight-fn generate ok: {imgs.shape} mean {imgs.mean():.4f}")
    from PIL import Image

    pipe9 = PwwPipeline(SDModelConfig.tiny(in_channels=9), device=dev, dtype=dtype, mesh=mesh)
    mask = np.zeros((64, 64), np.uint8)
    mask[16:48, 16:48] = 255
    imgs = pipe9.generate(init_image=Image.fromarray(cm).convert("RGB"),
                          mask_image=Image.fromarray(mask, "L"), strength=1.0, **kw)
    lines.append(f"mesh inpaint generate ok: {imgs.shape} mean {imgs.mean():.4f}")
    del pipe9
    init = (np.random.default_rng(0).random((64, 64, 3)) * 255).astype(np.uint8)
    reqs = [dict(prompt=f"a cat {i}", color_map_image=cm, color_context={(255, 0, 0): "cat,1.0"},
                 seed=i, init_image=init) for i in range(dp)]
    imgs = np.asarray(pipe.generate_batch(reqs, num_inference_steps=2, strength=0.6,
                                          output_type="np"))
    lines.append(f"mesh generate_batch img2img ok: {imgs.shape} mean {imgs.mean():.4f}")

    # 7. a textual-inversion gradient step, rows over dp, the gradient summed
    clip = build_models(cfg, parts=("clip",))["clip"]
    clip.load_state_dict(synthetic_state(clip, torch.Generator(device=dev).manual_seed(5),
                                         torch.float32), assign=True)
    ids = torch.arange(77, device=dev)[None].repeat(2 * dp, 1)
    target = torch.randn(2 * dp, 77, cfg.clip.hidden_size, generator=gen).to(dev)
    table = clip.get_submodule("text_model.embeddings.token_embedding").weight

    def grad(ids, tgt):  # of the whole batch's mean squared error
        table.grad = None
        ((clip(ids) - tgt) ** 2).sum().div(target.numel()).backward()
        return table.grad.clone()

    g_rank = grad(shard_batch(ids, mesh), shard_batch(target, mesh))
    dist.all_reduce(g_rank, group=mesh.get_group("dp"))
    g_whole = grad(ids, target)
    lines.append(f"textual-inversion grad step ok: |grad| {g_whole.norm().item():.6e}, "
                 f"max |dp-summed - whole| {(g_rank - g_whole).abs().max().item():.3e}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world-size", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None,
                    help="process-group backend (default: nccl on cuda, gloo on cpu)")
    args = ap.parse_args(argv)
    from . import dryrun
    from .mesh import spawn

    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    lines = spawn(dryrun._rank_cases, args.world_size, backend, args.device)
    for line in lines[0]:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
