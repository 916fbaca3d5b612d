"""Train a textual-inversion concept, then paint with it (the JAX package's
``examples/train_textual_inversion_pww.py``).

    python -m pww_tpu_torch.examples.train_textual_inversion_pww \\
        [--model /path/sd15] [--images img1.png img2.png ...] \\
        [--token "<my-cat>"] [--init-token cat] [--steps 3000] \\
        [--out learned_embeds.bin] [--sample ti_sample.png] [--device cuda]

The reference's TI notebook only injects trained embeddings; this example
trains one (:func:`~pww_tpu_torch.training.train_textual_inversion`: the
placeholder's new CLIP rows the only trainables, UNet, VAE and the rest of
CLIP frozen), writes it in the diffusers format, and paints with the
placeholder in the prompt and in a region label. Without ``--model`` the
tiny random-weight config trains at most 100 steps on synthetic images.
"""
from __future__ import annotations

import argparse

import numpy as np
from PIL import Image

from ..apps.runner import load_pipeline
from ..config import SDModelConfig
from ..training import train_textual_inversion


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None, help="checkpoint (diffusers directory or file)")
    ap.add_argument("--images", nargs="*", default=None, help="3-5 images of the concept")
    ap.add_argument("--token", default="<my-concept>")
    ap.add_argument("--init-token", default="thing",
                    help="an existing word whose embedding seeds the new token")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--vectors", type=int, default=1)
    ap.add_argument("--out", default="learned_embeds.bin")
    ap.add_argument("--sample", default="ti_sample.png")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    pipe = load_pipeline(args.model, args.device, SDModelConfig.tiny())
    steps = args.steps if args.model else min(args.steps, 100)
    if args.images:
        images = [Image.open(p).convert("RGB") for p in args.images]
    else:
        rng = np.random.default_rng(0)
        images = [Image.fromarray((rng.random((64, 64, 3)) * 80 + 100).astype(np.uint8))
                  for _ in range(3)]

    result = train_textual_inversion(
        pipe, images, args.token, initializer_token=args.init_token,
        num_vectors=args.vectors, num_steps=steps, batch_size=args.batch,
        learning_rate=args.lr, log_every=max(steps // 10, 1))
    result.save(args.out)
    print(f"trained {result.placeholder!r}; final loss {np.mean(result.losses[-10:]):.5f}; "
          f"wrote {args.out}")

    size = 512 if args.model else 64
    cm = np.zeros((size, size, 3), np.uint8)
    cm[:, : size // 2] = (255, 0, 0)
    img = pipe.generate(prompt=f"a photo of {result.placeholder}", color_map_image=cm,
                        color_context={(255, 0, 0): f"{result.placeholder},1.0"},
                        num_inference_steps=30 if args.model else 4, seed=0)
    img.save(args.sample)
    print("wrote", args.sample)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
