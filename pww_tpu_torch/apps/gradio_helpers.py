"""Color-content extraction helpers for the port's web UIs.

The port's own copy of ``apps/gradio_helpers.py`` (which imports
``pww_tpu.native``), on :mod:`pww_tpu_torch.native`'s numpy twins.
Re-implementation of the reference Gradio app's tooling
(reference `gradio_pww.py:24-99`): dominant-color extraction from a sketched
segmentation map (>1% pixel threshold), squared-distance color masks
(threshold 30), the color↔textbox round-trip, and the seed-chain for
multi-sample generation. Importable without gradio so they are unit-testable.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..native import color_mask_sqdist
from ..native import unique_colors as _native_unique

MAX_NUM_COLORS = 8
COLOR_DIST_THRESHOLD = 30  # squared-distance threshold (reference :69-76)
PIXEL_FRACTION_THRESHOLD = 0.01  # >1% of pixels (reference :78-85)


def unique_colors(img: np.ndarray,
                  threshold: float = PIXEL_FRACTION_THRESHOLD) -> List[Tuple[int, int, int]]:
    """Colors covering more than ``threshold`` of the image, most-common first."""
    return [c for c, _ in _native_unique(img, threshold, MAX_NUM_COLORS)]


def get_color_mask(
    color: Sequence[int], img: np.ndarray, threshold: float = COLOR_DIST_THRESHOLD
) -> np.ndarray:
    """Boolean mask of pixels within squared distance ``threshold`` of color."""
    return color_mask_sqdist(img, color, threshold)


def extract_color_textboxes(img: np.ndarray) -> Dict[Tuple[int, int, int], str]:
    """Initial color-context skeleton from a sketch: color → 'obj,0.5,-1'.

    The defaults match the reference's per-color textbox skeleton
    (reference `gradio_pww.py:61-64`) — a valid, runnable context entry the
    user then edits, not a placeholder that fails to parse.
    """
    return {c: "obj,0.5,-1" for c in unique_colors(img)}


def color_mask_preview(
    color: Sequence[int], img: np.ndarray,
    threshold: float = COLOR_DIST_THRESHOLD,
) -> np.ndarray:
    """Preview image with non-matching pixels zeroed (reference
    ``get_color_mask``, `gradio_pww.py:69-76`)."""
    mask = get_color_mask(color, img, threshold)
    return np.where(np.asarray(mask)[..., None], img, 0).astype(np.uint8)


FILLER_GRAY = (32, 32, 32)  # reference's empty-panel fill (gradio_pww.py:58)


def extract_color_panels(
    img: np.ndarray, max_colors: int = MAX_NUM_COLORS
) -> Tuple[List[np.ndarray], List[str], List[str], List[str],
           List[Optional[Tuple[int, int, int]]]]:
    """Sketch → per-color accordion panel contents (reference
    ``extract_color_textboxes``, `gradio_pww.py:52-66`).

    Returns ``(mask_previews, prompts, strengths, seeds, colors)``, each of
    length ``max_colors``: one panel per dominant color with its color-mask
    preview image and editable ``obj`` / ``0.5`` / ``-1`` defaults; unused
    panels get a dark filler image and empty strings (color ``None``).
    """
    colors: List[Optional[Tuple[int, int, int]]] = list(
        unique_colors(img)[:max_colors]
    )
    n = len(colors)
    masks = [color_mask_preview(c, img) for c in colors]
    filler = np.full(img.shape, FILLER_GRAY, np.uint8)
    masks += [filler] * (max_colors - n)
    prompts = ["obj"] * n + [""] * (max_colors - n)
    strengths = ["0.5"] * n + [""] * (max_colors - n)
    seeds = ["-1"] * n + [""] * (max_colors - n)
    colors += [None] * (max_colors - n)
    return masks, prompts, strengths, seeds, colors


def collect_color_panels(
    colors: Sequence[Optional[Tuple[int, int, int]]],
    prompts: Sequence[str],
    strengths: Sequence[str],
    seeds: Sequence[str],
) -> str:
    """Per-color textboxes → context-dict string (reference
    ``collect_color_content``, `gradio_pww.py:87-99`). Panels whose color is
    ``None``/empty are skipped; returns ``"{}"`` when nothing is filled in
    (``""`` would make the generate path's ``ast.literal_eval`` raise)."""
    parts = []
    for color, prompt, strength, seed in zip(colors, prompts, strengths, seeds):
        if isinstance(color, str):
            color = ast.literal_eval(color) if color.strip() else None
        if color is None:
            continue
        parts.append(f"{tuple(color)}: {f'{prompt},{strength},{seed}'!r}")
    return "{" + ", ".join(parts) + "}"


def collect_color_content(entries: Dict[Tuple[int, int, int], str]) -> str:
    """Round-trip the per-color textboxes into the context-dict string."""
    return (
        "{"
        + ", ".join(f"{color}: {content!r}" for color, content in entries.items())
        + "}"
    )


def parse_color_content(text: str) -> Dict:
    """Parse the UI's context string (reference uses ast.literal_eval, :20)."""
    return ast.literal_eval(text)


def build_color_panels(gr, sketch, content, max_colors: int = MAX_NUM_COLORS):
    """Wire the reference's per-color accordion panels into a gr.Blocks ctx.

    Mirrors `gradio_pww.py:116-157`: up to ``max_colors`` accordion items,
    each with a color-mask preview image and per-color prompt / strength /
    seed textboxes; "Extract color content" fills them from the sketch and
    "Generate color content" round-trips them into the ``content`` textbox.
    ``gr`` is passed in so this module stays importable without gradio.
    """
    with gr.Accordion("Color content options", open=False):
        with gr.Row():
            extract_btn = gr.Button("Extract color content")
            generate_btn = gr.Button("Generate color content")
        colors = [gr.Textbox(value="", visible=False) for _ in range(max_colors)]
        mask_imgs, prompts, strengths, seeds = [], [], [], []
        for n in range(max_colors):
            with gr.Accordion(f"item{n}", open=False):
                with gr.Row():
                    mask_imgs.append(gr.Image(interactive=False, type="numpy"))
                    with gr.Column():
                        prompts.append(gr.Textbox(label="Prompt", interactive=True))
                        with gr.Row():
                            strengths.append(
                                gr.Textbox(label="Strength", interactive=True)
                            )
                            seeds.append(
                                gr.Textbox(label="Random Seed", interactive=True)
                            )

    def _extract(img):
        if img is None:
            return tuple(gr.update() for _ in range(5 * max_colors))
        if isinstance(img, dict):  # sketch-tool payload
            img = img["image"]
        m, p, s, sd, c = extract_color_panels(
            np.asarray(img)[..., :3], max_colors
        )
        return (*m, *p, *s, *sd,
                *["" if ci is None else str(ci) for ci in c])

    extract_btn.click(
        _extract, inputs=[sketch],
        outputs=[*mask_imgs, *prompts, *strengths, *seeds, *colors],
    )
    generate_btn.click(
        lambda *a: collect_color_panels(
            a[:max_colors], a[max_colors:2 * max_colors],
            a[2 * max_colors:3 * max_colors], a[3 * max_colors:],
        ),
        inputs=[*colors, *prompts, *strengths, *seeds],
        outputs=[content],
    )


def derive_sample_seeds(base_seed: int, num_samples: int) -> List[int]:
    """Deterministic per-sample seed chain (reference derives via
    torch.randint chains, :24-28; here a splitmix-style hash — deterministic
    and collision-free without torch)."""
    mask = (1 << 64) - 1
    seeds = []
    s = int(base_seed) & mask
    for _ in range(num_samples):
        s = (s + 0x9E3779B97F4A7C15) & mask
        z = s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        seeds.append((z ^ (z >> 31)) & 0x7FFFFFFF)
    return seeds
