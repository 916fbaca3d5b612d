"""Textual inversion with paint-with-words (the reference's TI notebook,
``README.md:301-307``; the JAX package's ``examples/textual_inversion_pww.py``).

    python -m pww_tpu_torch.examples.textual_inversion_pww --model /path/sd15 \\
        --embedding /path/my-concept.bin [--device cuda]

Loads a learned embedding (diffusers ``.bin``/``.safetensors`` or an A1111
``.pt``), registers its placeholder and writes its vectors into the CLIP
table (:func:`~pww_tpu_torch.weights.textual_inversion.apply_textual_inversion`),
then puts the placeholder in the prompt and in a region label. Without
``--model`` the tiny random-weight config runs at 128² with a random
embedding, a structural demo.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from ..apps.runner import default_color_map, load_pipeline
from ..config import SDModelConfig
from ..pipeline.facade import paint_with_words
from ..weights.textual_inversion import apply_textual_inversion


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None)
    ap.add_argument("--embedding", default=None, help="learned_embeds.bin / .pt / .safetensors")
    ap.add_argument("--out", default="ti_output.png")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    pipe = load_pipeline(args.model, args.device, SDModelConfig.tiny())
    if args.embedding:
        placeholder = apply_textual_inversion(pipe, args.embedding)
    else:  # a random embedding, so that the flow runs without one
        vec = torch.randn(pipe.config.clip.hidden_size,
                          generator=torch.Generator().manual_seed(0)) * 0.01
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "emb.bin")
            torch.save({"<my-concept>": vec}, path)
            placeholder = apply_textual_inversion(pipe, path)
    print("placeholder token:", placeholder)

    size = 512 if args.model else 128
    img = paint_with_words(
        color_context={(255, 0, 0): f"{placeholder},1.2", (0, 0, 255): "a mountain lake,0.6"},
        color_map_image=default_color_map(size),
        input_prompt=f"a photo of {placeholder} beside a mountain lake",
        num_inference_steps=30 if args.model else 3,
        seed=0,
        preloaded_utils=pipe,
        device=args.device,
    )
    img.save(args.out)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
