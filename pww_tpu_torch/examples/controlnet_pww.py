"""ControlNet with paint-with-words (the JAX package's
``examples/controlnet_pww.py``): the ControlNet's residuals steer the
structure, the paint-with-words bias the regions' tokens.

    python -m pww_tpu_torch.examples.controlnet_pww --model /path/sd15 \\
        --controlnet /path/cn [--hint hint.png] [--scale 1.0] [--device cuda]

Without ``--model`` the tiny random-weight config runs at 128²; without
``--controlnet`` a random ControlNet whose zero convs are zero is attached.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..apps.runner import default_color_map, load_pipeline
from ..config import SDModelConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None)
    ap.add_argument("--controlnet", default=None, help="diffusers ControlNetModel dir or file")
    ap.add_argument("--hint", default=None, help="conditioning image path")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", default="cn_pww_output.png")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    pipe = load_pipeline(args.model, args.device, SDModelConfig.tiny())
    size, steps = (512, 30) if args.model else (128, 3)
    pipe.load_controlnet(args.controlnet)
    if args.hint:
        from PIL import Image

        hint = np.asarray(Image.open(args.hint).convert("RGB").resize((size, size)))
    else:
        hint = np.zeros((size, size, 3), np.uint8)
        hint[size // 4: 3 * size // 4, size // 4: 3 * size // 4] = 255
    img = pipe.generate(
        prompt="a castle and a forest, canny structure",
        color_map_image=default_color_map(size),
        color_context={(255, 0, 0): "castle,1.0", (0, 0, 255): "forest,0.8"},
        control_image=hint,
        controlnet_conditioning_scale=args.scale,
        num_inference_steps=steps,
        seed=0,
    )
    img.save(args.out)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
