"""The reference's txt2img examples through the port (reference
``runner.py:9-107``; the JAX package's ``apps/runner.py``).

    python -m pww_tpu_torch.apps.runner [--model DIR_OR_FILE] [--out DIR] \\
        [--steps 30] [--only NAME] [--device cuda]

``--model`` takes anything ``PwwPipeline.from_pretrained`` reads: a
diffusers-layout directory, an A1111/LDM ``.ckpt``/``.safetensors`` file or
a JAX-written ``params.msgpack`` directory; the maps are 512² then. Without
it the tiny random-weight config runs at 128², a structural smoke run. Each
example writes ``output_<name>.png`` and ``fig_<name>.png`` (the figure
utility's montage). On the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import SDModelConfig
from ..ops.weight_functions import WeightFunction
from ..pipeline.facade import paint_with_words
from ..pipeline.pipeline import PwwPipeline
from ..utils.fig import fig_from_settings

EXAMPLES = [
    {
        # reference runner.py:9-19
        "color_context": {
            (7, 9, 182): "aurora,0.5",
            (136, 178, 92): "full moon,1.5",
            (51, 193, 217): "mountains,0.4",
            (61, 163, 35): "a half-frozen lake,0.3",
            (89, 102, 255): "boat,2.0",
        },
        "input_prompt": "aurora, full moon, mountains, a half-frozen lake, boat",
        "seed": 0,
        "name": "aurora_1",
    },
    {
        "color_context": {(255, 0, 0): "cat,1.0", (0, 0, 255): "dog,1.0"},
        "input_prompt": "a cat and a dog sitting together, realistic photo",
        "seed": 81,
        "name": "cat_dog",
    },
    {
        # a custom weight function (reference runner.py:45-58)
        "color_context": {(255, 0, 0): "cat,1.0", (0, 0, 255): "dog,1.0"},
        "input_prompt": "a cat and a dog sitting together, realistic photo",
        "seed": 0,
        "weight_function": WeightFunction(scale=0.4, sigma_mode="log1p_sigma",
                                          reduce_mode="max"),
        "name": "cat_dog_w04",
    },
    {
        # regional seeds (reference runner.py:61-72, README.md:192-228)
        "color_context": {
            (255, 0, 0): "a mecha robot,1.2,2077",
            (0, 0, 255): "a dog,1.0,42",
        },
        "input_prompt": "a mecha robot and a dog in a city",
        "seed": 2077,
        "name": "regional_seed",
    },
    {
        # the std-reduce weight function (README.md:119-164 sweep)
        "color_context": {(255, 0, 0): "cat,1.0", (0, 0, 255): "dog,1.0"},
        "input_prompt": "a cat and a dog sitting together, realistic photo",
        "seed": 0,
        "weight_function": WeightFunction(scale=0.3, sigma_mode="log1p_sigma2",
                                          reduce_mode="std"),
        "name": "cat_dog_std",
    },
]


def default_color_map(size: int = 512) -> np.ndarray:
    cm = np.zeros((size, size, 3), np.uint8)
    cm[:, : size // 2] = (255, 0, 0)
    cm[:, size // 2:] = (0, 0, 255)
    return cm


def example_color_map(ex: dict, size: int) -> np.ndarray:
    """The example's map: left/right halves for two regions, horizontal
    bands for more (the aurora example's five)."""
    colors = list(ex["color_context"])
    if len(colors) <= 2:
        return default_color_map(size)
    cm = np.zeros((size, size, 3), np.uint8)
    band = size // len(colors)
    for i, c in enumerate(colors):
        cm[i * band: (i + 1) * band if i + 1 < len(colors) else size] = c
    return cm


def load_pipeline(model, device: str, tiny: SDModelConfig) -> PwwPipeline:
    """``model`` through ``from_pretrained``, else ``tiny`` with random
    weights; f32 on the CPU, bf16 on the card."""
    dtype = torch.float32 if torch.device(device).type == "cpu" else torch.bfloat16
    if model:
        return PwwPipeline.from_pretrained(model, device=device, dtype=dtype)
    print("no --model given: running the tiny random-weight smoke config")
    return PwwPipeline(config=tiny, device=device, dtype=dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None,
                    help="diffusers directory, single .ckpt/.safetensors file or "
                         "params.msgpack directory")
    ap.add_argument("--out", default="contents_out")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--only", default=None, help="run a single example by name")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    pipe = load_pipeline(args.model, args.device, SDModelConfig.tiny())
    size = 512 if args.model else 128
    os.makedirs(args.out, exist_ok=True)
    for ex in EXAMPLES:
        if args.only and ex["name"] != args.only:
            continue
        cm = example_color_map(ex, size)
        img = paint_with_words(
            color_context=dict(ex["color_context"]),
            color_map_image=cm,
            input_prompt=ex["input_prompt"],
            num_inference_steps=args.steps,
            seed=ex["seed"],
            weight_function=ex.get("weight_function"),
            preloaded_utils=pipe,
            device=args.device,
        )
        out_path = os.path.join(args.out, f"output_{ex['name']}.png")
        img.save(out_path)
        fig = fig_from_settings({"color_map_image": cm, "color_context": ex["color_context"],
                                 "input_prompt": ex["input_prompt"]}, img)
        fig.save(os.path.join(args.out, f"fig_{ex['name']}.png"))
        print("wrote", out_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
