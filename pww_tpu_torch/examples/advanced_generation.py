"""The generation options in one walkthrough (the JAX package's
``examples/advanced_generation.py``): CLIP skip and FreeU, DPM++ 2M SDE with
Karras sigmas, the hires fix, a T2I-Adapter and two stacked ControlNets.

    python -m pww_tpu_torch.examples.advanced_generation [--model /path/sd15] \\
        [--out-dir out] [--device cuda]

Without ``--model`` everything runs on the tiny random-weight config at
``--tiny-side`` pixels for 2 steps; the adapter and ControlNets are random
where no checkpoint is given.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..apps.runner import load_pipeline
from ..config import SchedulerConfig, SDModelConfig
from ..schedulers.schedules import make_scheduler


def demo_color_map(side: int) -> np.ndarray:
    cm = np.zeros((side, side, 3), np.uint8)
    cm[:, : side // 2] = (255, 0, 0)
    cm[: side // 3, side // 2:] = (0, 0, 255)
    return cm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--tiny-side", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    pipe = load_pipeline(args.model, args.device, SDModelConfig.tiny())
    side, steps = (512, 30) if args.model else (args.tiny_side, 2)
    cm = demo_color_map(side)
    kw = dict(prompt="a cat under the moon", color_map_image=cm,
              color_context={(255, 0, 0): "cat,1.0", (0, 0, 255): "moon,0.8"},
              num_inference_steps=steps, seed=0)

    def save(img, name):
        path = os.path.join(args.out_dir, name)
        (img[0] if isinstance(img, list) else img).save(path)
        print("wrote", path)

    # 1. CLIP skip and FreeU on the plain txt2img path
    save(pipe.generate(clip_skip=1, freeu=True, **kw), "adv_clipskip_freeu.png")
    # 2. a stochastic second-order sampler with Karras sigmas
    pipe.scheduler = make_scheduler("dpmpp_2m_sde", SchedulerConfig(use_karras_sigmas=True))
    save(pipe.generate(**kw), "adv_sde_karras.png")
    pipe.scheduler = make_scheduler("lms")
    # 3. the hires fix: native pass, latent 2× upscale, refine
    save(pipe.generate_hires(hires_scale=2.0, hires_strength=0.6, hires_steps=steps, **kw),
         "adv_hires.png")
    # 4. a T2I-Adapter's structural hint
    pipe.load_t2i_adapter()
    hint = np.zeros((side, side, 3), np.uint8)
    hint[side // 4: 3 * side // 4, side // 3: 2 * side // 3] = 255
    save(pipe.generate(adapter_image=hint, adapter_conditioning_scale=0.8, **kw),
         "adv_t2i_adapter.png")
    # 5. two stacked ControlNets, a scale each
    pipe.load_controlnet().add_controlnet()
    save(pipe.generate(control_image=[hint, 255 - hint],
                       controlnet_conditioning_scale=[1.0, 0.5], **kw),
         "adv_multi_controlnet.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
