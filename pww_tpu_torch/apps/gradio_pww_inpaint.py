"""The Gradio inpainting app on the port (reference
``gradio_pww_inpaint.py:17-115``; the JAX package's
``apps/gradio_pww_inpaint.py``).

    python -m pww_tpu_torch.apps.gradio_pww_inpaint [--model DIR_OR_FILE] \\
        [--device cuda] [--host 0.0.0.0] [--port 7861]

The txt2img app's controls plus the sketch-tool mask on the init image
(taken as 'L'), mask blur, masked content and "inpaint only masked"; steps
up to 300, 150 by default, as in the reference. ``gradio`` is imported by
:func:`build_ui` alone.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..config import SDModelConfig
from ..pipeline.facade import paint_with_words_inpaint
from .gradio_helpers import (MAX_NUM_COLORS, build_color_panels, collect_color_content,
                             derive_sample_seeds, extract_color_textboxes,
                             parse_color_content)
from .gradio_pww import _error
from .runner import load_pipeline

_PIPE = None


def get_pipeline(model_path=None, device: str = "cuda"):
    """The app's one pipeline: ``model_path`` or a tiny random-weight
    9-channel config."""
    global _PIPE
    if _PIPE is None:
        _PIPE = load_pipeline(model_path, device, SDModelConfig.tiny(in_channels=9))
    return _PIPE


def _missing(payload) -> bool:
    return payload is None or (isinstance(payload, dict) and payload.get("image") is None)


def run_pww_inpaint(color_map_image, color_content: str, prompt: str, negative_prompt: str,
                    init_with_mask, width: int, height: int, num_samples: int, steps: int,
                    guidance_scale: float, seed: int, strength: float, mask_blur: float = 0.0,
                    masked_content: str = "original", inpaint_full_res: bool = False,
                    model_path=None, device: str = "cuda"):
    """One request → a list of PIL images. ``init_with_mask``: the sketch
    tool's ``{"image", "mask"}``, or an image alone (then all of it is
    painted)."""
    from PIL import Image

    pipe = get_pipeline(model_path, device)
    if _missing(init_with_mask):
        raise _error("Upload an init image (and sketch a mask) first.")
    if _missing(color_map_image):
        raise _error("Draw or upload a segmentation color map first.")
    if isinstance(init_with_mask, dict):
        init_image = Image.fromarray(np.asarray(init_with_mask["image"])[..., :3])
        mask = Image.fromarray(np.asarray(init_with_mask["mask"])[..., :3]).convert("L")
    else:
        init_image = Image.fromarray(np.asarray(init_with_mask)[..., :3])
        mask = Image.new("L", init_image.size, 255)
    init_image = init_image.resize((width, height), Image.BILINEAR)
    mask = mask.resize((width, height), Image.NEAREST)
    if isinstance(color_map_image, dict):
        color_map_image = color_map_image["image"]
    cm = Image.fromarray(np.asarray(color_map_image)[..., :3]).resize((width, height),
                                                                       Image.NEAREST)
    context = parse_color_content(color_content)
    return [paint_with_words_inpaint(
        color_context=dict(context), color_map_image=cm, init_image=init_image,
        mask_image=mask, input_prompt=prompt, unconditional_input_prompt=negative_prompt,
        num_inference_steps=steps, guidance_scale=guidance_scale, seed=s, strength=strength,
        mask_blur=mask_blur, masked_content=masked_content,
        inpaint_full_res=inpaint_full_res, preloaded_utils=pipe, device=str(pipe.device))
        for s in derive_sample_seeds(seed, num_samples)]


def build_ui(model_path=None, device: str = "cuda"):
    """The Gradio Blocks app; raises ``ImportError`` without gradio."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError("gradio is not installed (pip install gradio)") from e

    with gr.Blocks(title="Paint with Words Inpainting — PyTorch") as demo:
        gr.Markdown("## Paint with Words — Inpainting (PyTorch/CUDA)")
        with gr.Row():
            with gr.Column():
                sketch = gr.Image(label="color map", type="numpy")
                init = gr.Image(label="image + mask (draw the fill region)", type="numpy",
                                tool="sketch")
                content = gr.Textbox(label="color context", value="{(255, 0, 0): 'moon,1.5'}")
                extract = gr.Button("extract colors from sketch")
                prompt = gr.Textbox(label="prompt")
                negative = gr.Textbox(label="negative prompt", value="")
                with gr.Row():
                    width = gr.Slider(256, 1024, value=512, step=64, label="width")
                    height = gr.Slider(256, 1024, value=512, step=64, label="height")
                with gr.Row():
                    samples = gr.Slider(1, 12, value=1, step=1, label="samples")
                    steps = gr.Slider(1, 300, value=150, step=1, label="steps")
                with gr.Row():
                    scale = gr.Slider(1.0, 20.0, value=7.5, label="guidance")
                    seed = gr.Number(value=0, label="seed", precision=0)
                    strength = gr.Slider(0.0, 1.0, value=1.0, label="strength")
                with gr.Row():
                    mask_blur = gr.Slider(0.0, 64.0, value=0.0, step=0.5, label="mask blur")
                    masked_content = gr.Dropdown(
                        ["original", "fill", "latent_noise", "latent_nothing"],
                        value="original", label="masked content")
                    full_res = gr.Checkbox(value=False, label="inpaint only masked")
                go = gr.Button("generate", variant="primary")
            with gr.Column():
                build_color_panels(gr, sketch, content, MAX_NUM_COLORS)
                gallery = gr.Gallery(label="outputs")

        def _extract(img):
            if img is None:
                return gr.update()
            return collect_color_content(extract_color_textboxes(np.asarray(img)))

        extract.click(_extract, inputs=[sketch], outputs=[content])
        go.click(lambda *a: run_pww_inpaint(*a, model_path=model_path, device=device),
                 inputs=[sketch, content, prompt, negative, init, width, height, samples,
                         steps, scale, seed, strength, mask_blur, masked_content, full_res],
                 outputs=[gallery])
    return demo


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7861)
    args = ap.parse_args()
    get_pipeline(args.model, args.device)
    build_ui(args.model, args.device).launch(server_name=args.host, server_port=args.port)
