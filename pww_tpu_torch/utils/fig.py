"""The figure utility: an annotated color map beside the generated images.

Port of :mod:`pww_tpu.utils.fig` (the reference's ``fig_from_settings``,
``paint_with_words/utils.py:10-85``): each region's label at its top-left
pixel of the color map, the map and the outputs side by side, and the
prompt wrapped underneath. Host-side PIL, imported when called.
"""
from __future__ import annotations

import textwrap
from typing import Dict, Optional, Sequence

import numpy as np

from ..conditioning.color_context import parse_color, parse_context_entry


def _load_font(size: int = 14):
    from PIL import ImageFont

    for name in ("Arial.ttf", "DejaVuSans.ttf", "LiberationSans-Regular.ttf"):
        try:
            return ImageFont.truetype(name, size)
        except OSError:
            continue
    return ImageFont.load_default()


def annotate_color_map(color_map, color_context: Dict):
    """A copy of the PIL ``color_map`` with each region's label drawn at its
    top-left matching pixel, black on light colors, white on dark ones."""
    from PIL import ImageDraw

    img = color_map.convert("RGB").copy()
    arr = np.asarray(img)
    draw = ImageDraw.Draw(img)
    font = _load_font()
    for color_key, ctx in color_context.items():
        color = parse_color(color_key)
        try:
            label = parse_context_entry(ctx)[0]
        except (ValueError, IndexError):
            label = ctx.split(",")[0]
        ys, xs = np.nonzero((arr == np.array(color, np.uint8)).all(axis=-1))
        if len(ys) == 0:
            continue
        y, x = int(ys.min()), int(xs[ys.argmin()])
        lum = 0.299 * color[0] + 0.587 * color[1] + 0.114 * color[2]
        fill = (0, 0, 0) if lum > 128 else (255, 255, 255)
        draw.text((x + 2, y + 2), label, fill=fill, font=font)
    return img


def fig_from_settings(settings: Dict, images, caption_height: int = 48,
                      optional_captions: Optional[Sequence[str]] = None):
    """A montage: the annotated color map, the generated PIL image(s) at its
    height, and the wrapped prompt. ``settings`` as the reference runner's
    (``color_context``, ``color_map_img_path`` or ``color_map_image``,
    ``input_prompt``); ``optional_captions``: one caption above each image."""
    from PIL import Image, ImageDraw

    if isinstance(images, Image.Image):
        images = [images]
    cmap = settings.get("color_map_image")
    if cmap is None and settings.get("color_map_img_path"):
        cmap = Image.open(settings["color_map_img_path"])
    if isinstance(cmap, np.ndarray):
        cmap = Image.fromarray(cmap)

    panels = []
    h = max(im.height for im in images)
    if cmap is not None:
        cmap = annotate_color_map(cmap, settings.get("color_context", {}))
        panels.append(cmap.resize((int(cmap.width * h / cmap.height), h)))
    panels.extend(im if im.height == h else im.resize((im.width, h)) for im in images)

    total_w = sum(p.width for p in panels)
    band = 20 if optional_captions else 0  # the caption strip above the images
    fig = Image.new("RGB", (total_w, band + h + caption_height), (255, 255, 255))
    x = 0
    n_map_panels = len(panels) - len(images)
    cap_font = _load_font(12)
    for i, p in enumerate(panels):
        fig.paste(p, (x, band))
        cap_i = i - n_map_panels
        if optional_captions and 0 <= cap_i < len(optional_captions):
            ImageDraw.Draw(fig).text((x + 2, 2), optional_captions[cap_i], fill=(0, 0, 0),
                                     font=cap_font)
        x += p.width

    prompt = settings.get("input_prompt", "")
    if prompt:
        wrapped = textwrap.fill(prompt, width=max(20, total_w // 8))
        ImageDraw.Draw(fig).text((4, band + h + 4), wrapped, fill=(0, 0, 0), font=_load_font())
    return fig
