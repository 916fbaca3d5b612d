"""The reference's inpainting examples through the port (reference
``runner_inpaint.py:10-92``; the JAX package's ``apps/runner_inpaint.py``).

    python -m pww_tpu_torch.apps.runner_inpaint [--model DIR_OR_FILE] \\
        [--image PATH] [--mask PATH] [--out DIR] [--steps 150] [--device cuda]

``--model``: a 9-channel inpainting checkpoint (a 4-channel one inpaints by
the legacy masked blend), anything ``PwwPipeline.from_pretrained`` reads;
512² then. Without it a tiny random-weight 9-channel config runs at 128²
for 4 steps. The mask is white where to paint; without ``--image`` and
``--mask`` a gray image and a centred square. On the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import SDModelConfig
from ..ops.weight_functions import WeightFunction
from ..pipeline.facade import paint_with_words_inpaint
from .runner import default_color_map, load_pipeline

EXAMPLES = [
    {
        # reference runner_inpaint.py:10-24; its runner passes 0.15·w·log(1+σ)·
        # max(QKᵀ) explicitly (runner_inpaint.py:72, 87)
        "color_context": {(255, 0, 0): "aurora,0.7", (0, 0, 255): "moon,1.5"},
        "input_prompt": "aurora over the lake with a full moon",
        "seed": 81,
        "strength": 1.0,
        "weight_function": WeightFunction(scale=0.15, sigma_mode="log1p_sigma",
                                          reduce_mode="max"),
        "name": "inpaint_moon",
    },
    {
        "color_context": {(255, 0, 0): "a red fox,1.2", (0, 0, 255): "snow,0.4"},
        "input_prompt": "a red fox standing in snow",
        "seed": 0,
        "strength": 0.9,
        "weight_function": WeightFunction(scale=0.3, sigma_mode="log1p_sigma2",
                                          reduce_mode="std"),
        "name": "inpaint_fox",
    },
]


def main(argv=None) -> int:
    from PIL import Image

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None, help="inpainting checkpoint (dir or file)")
    ap.add_argument("--image", default=None, help="init image path")
    ap.add_argument("--mask", default=None, help="mask image path (white=fill)")
    ap.add_argument("--out", default="contents_out")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    pipe = load_pipeline(args.model, args.device, SDModelConfig.tiny(in_channels=9))
    size, steps = (512, args.steps) if args.model else (128, 4)
    if args.image:
        init = Image.open(args.image).convert("RGB").resize((size, size))
    else:
        init = Image.fromarray(np.full((size, size, 3), 110, np.uint8))
    if args.mask:
        mask = Image.open(args.mask).convert("L").resize((size, size))
    else:
        m = np.zeros((size, size), np.uint8)
        m[size // 4: 3 * size // 4, size // 4: 3 * size // 4] = 255
        mask = Image.fromarray(m)

    os.makedirs(args.out, exist_ok=True)
    for ex in EXAMPLES:
        img = paint_with_words_inpaint(
            color_context=dict(ex["color_context"]),
            color_map_image=Image.fromarray(default_color_map(size)),
            init_image=init,
            mask_image=mask,
            input_prompt=ex["input_prompt"],
            num_inference_steps=steps,
            seed=ex["seed"],
            strength=ex["strength"],
            weight_function=ex.get("weight_function"),
            preloaded_utils=pipe,
            device=args.device,
        )
        out_path = os.path.join(args.out, f"output_{ex['name']}.png")
        img.save(out_path)
        print("wrote", out_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
