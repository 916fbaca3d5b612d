"""The Gradio txt2img/img2img app on the port (reference
``gradio_pww.py:15-157``; the JAX package's ``apps/gradio_pww.py``).

    python -m pww_tpu_torch.apps.gradio_pww [--model DIR_OR_FILE] [--device cuda] \\
        [--host 0.0.0.0] [--port 7860]

The same controls as the reference: a color-sketch canvas, the
color-context textbox (``ast.literal_eval`` format), per-color panels with
the extraction tools, and the size, samples, steps, scale, seed and strength
sliders. The pipeline loads once and serves every request. ``gradio`` is
imported by :func:`build_ui` alone, so that :func:`run_pww`, the callback,
runs without it.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..config import SDModelConfig
from ..pipeline.facade import paint_with_words
from .gradio_helpers import (MAX_NUM_COLORS, build_color_panels, collect_color_content,
                             derive_sample_seeds, extract_color_textboxes,
                             parse_color_content)
from .runner import load_pipeline

_PIPE = None


def get_pipeline(model_path=None, device: str = "cuda"):
    """The app's one pipeline, loaded at the first call: ``model_path`` or
    the tiny random-weight config."""
    global _PIPE
    if _PIPE is None:
        _PIPE = load_pipeline(model_path, device, SDModelConfig.tiny())
    return _PIPE


def _error(msg: str) -> Exception:
    try:
        import gradio as gr

        return gr.Error(msg)
    except ImportError:
        return ValueError(msg)


def run_pww(color_map_image, color_content: str, prompt: str, negative_prompt: str,
            init_image, width: int, height: int, num_samples: int, steps: int,
            guidance_scale: float, seed: int, strength: float, clip_skip: int = 0,
            freeu: bool = False, model_path=None, device: str = "cuda"):
    """One request → a list of PIL images, one per sample seed of the chain
    from ``seed``; img2img when ``init_image`` is given."""
    from PIL import Image

    pipe = get_pipeline(model_path, device)
    if isinstance(color_map_image, dict):  # the sketch tool's payload
        color_map_image = color_map_image["image"]
    if color_map_image is None:
        raise _error("Draw or upload a segmentation color map first.")
    cm = Image.fromarray(np.asarray(color_map_image)[..., :3]).resize((width, height),
                                                                       Image.NEAREST)
    if init_image is not None:
        init_image = Image.fromarray(np.asarray(init_image)[..., :3]).resize(
            (width, height), Image.BILINEAR)
    context = parse_color_content(color_content)
    return [paint_with_words(
        color_context=dict(context), color_map_image=np.asarray(cm), input_prompt=prompt,
        unconditional_input_prompt=negative_prompt, num_inference_steps=steps,
        guidance_scale=guidance_scale, seed=s, init_image=init_image, strength=strength,
        preloaded_utils=pipe, device=str(pipe.device), clip_skip=int(clip_skip),
        freeu=True if freeu else None)
        for s in derive_sample_seeds(seed, num_samples)]


def build_ui(model_path=None, device: str = "cuda"):
    """The Gradio Blocks app; raises ``ImportError`` without gradio."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError("gradio is not installed (pip install gradio)") from e

    with gr.Blocks(title="Paint with Words — PyTorch") as demo:
        gr.Markdown("## Paint with Words (PyTorch/CUDA)")
        with gr.Row():
            with gr.Column():
                sketch = gr.Image(label="color map (sketch your regions)", type="numpy")
                init = gr.Image(label="init image (optional, img2img)", type="numpy")
                content = gr.Textbox(label="color context",
                                     value="{(255, 0, 0): 'cat,1.0', (0, 0, 255): 'dog,1.0'}")
                extract = gr.Button("extract colors from sketch")
                prompt = gr.Textbox(label="prompt")
                negative = gr.Textbox(label="negative prompt", value="")
                with gr.Row():
                    width = gr.Slider(256, 1024, value=512, step=64, label="width")
                    height = gr.Slider(256, 1024, value=512, step=64, label="height")
                with gr.Row():
                    samples = gr.Slider(1, 12, value=1, step=1, label="samples")
                    steps = gr.Slider(1, 100, value=30, step=1, label="steps")
                with gr.Row():
                    scale = gr.Slider(1.0, 20.0, value=7.5, label="guidance")
                    seed = gr.Number(value=0, label="seed", precision=0)
                    strength = gr.Slider(0.0, 1.0, value=0.5, label="img2img strength")
                with gr.Accordion("advanced", open=False):
                    clip_skip = gr.Slider(0, 4, value=0, step=1, label="CLIP skip (diffusers k)")
                    freeu = gr.Checkbox(value=False, label="FreeU")
                go = gr.Button("generate", variant="primary")
            with gr.Column():
                # per-color panels (reference gradio_pww.py:116-157)
                build_color_panels(gr, sketch, content, MAX_NUM_COLORS)
                gallery = gr.Gallery(label="outputs")

        def _extract(img):
            if img is None:
                return gr.update()
            return collect_color_content(extract_color_textboxes(np.asarray(img)))

        extract.click(_extract, inputs=[sketch], outputs=[content])
        go.click(lambda *a: run_pww(*a, model_path=model_path, device=device),
                 inputs=[sketch, content, prompt, negative, init, width, height, samples,
                         steps, scale, seed, strength, clip_skip, freeu],
                 outputs=[gallery])
    return demo


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7860)
    args = ap.parse_args()
    get_pipeline(args.model, args.device)  # load once, before serving
    build_ui(args.model, args.device).launch(server_name=args.host, server_port=args.port)
