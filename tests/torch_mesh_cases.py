"""Rank-side cases for tests/test_torch_sharding.py: what every gloo rank of
a 4-process group runs, and the inputs the test process builds the same
way for the calls without a mesh. No JAX here: each spawned rank imports
this module, and only torch and the port."""
import dataclasses
import time

import numpy as np
import torch

from chip_smoke import ip_adapter_file_state
from pww_tpu_torch.config import CLIPVisionConfig, SDModelConfig
from pww_tpu_torch.models.clip_vision import CLIPVisionEncoder
from pww_tpu_torch.ops.weight_functions import CustomWeightFunction, WeightFunction
from pww_tpu_torch.parallel import mesh as M
from pww_tpu_torch.pipeline.pipeline import PwwPipeline
from pww_tpu_torch.serving.batcher import Batcher, follow
from pww_tpu_torch.training.lora import train_lora
from pww_tpu_torch.training.textual_inversion import train_textual_inversion
from pww_tpu_torch.types import PwwState
from pww_tpu_torch.weights.bridge import build_models, synthetic_state

MESHES = ((4, 1), (2, 2), (1, 4))
UNET_MODES = ("max", "mean", "std", "custom")
# the golden "tiny_txt2img_v1" case's regions, 2 LMS steps
KW = dict(prompt="a cat and a dog",
          color_context={(255, 0, 0): "cat,1.5", (0, 0, 255): "dog,0.5,7"},
          num_inference_steps=2, seed=0)
WEIGHT_FNS = {
    "std": WeightFunction(scale=0.4, reduce_mode="std"),
    "mean": WeightFunction(scale=0.4, reduce_mode="mean"),
}


def custom_fn(w, sigma, qk):
    """A callable that needs every head: the per-head max, scaled."""
    return 0.3 * w * torch.log1p(sigma) * qk.amax(dim=(1, 2), keepdim=True)


def color_map(size: int = 64) -> np.ndarray:
    """tests/golden_cases.py's map: red left half, blue top-right quarter."""
    cm = np.zeros((size, size, 3), np.uint8)
    cm[:, : size // 2] = (255, 0, 0)
    cm[: size // 4, size // 2:] = (0, 0, 255)
    return cm


def mask(size: int = 64) -> np.ndarray:
    """An f32 box mask in [0, 1]: a band across the rows' cut."""
    m = np.zeros((size, size), np.float32)
    m[size // 4: 3 * size // 4, size // 8: size // 2] = 1.0
    return m


def requests(n: int, first: int = 0):
    """``generate_batch`` requests, each with its own seed and prompt."""
    return [dict(prompt=f"a cat and a dog {i}", color_map_image=color_map(),
                 color_context=KW["color_context"], seed=10 + i) for i in range(first, n)]


def pipeline(params, mesh=None, scheduler: str = "lms", cfg=None, seed: int = 0) -> PwwPipeline:
    return PwwPipeline(cfg or SDModelConfig.tiny(), params=params, scheduler=scheduler,
                       device="cpu", dtype=torch.float32, mesh=mesh, seed=seed)


# Spatial sharding (generate(sharding="spatial")): the cases of the (2, 2)
# mesh, each with its kwargs beyond SPATIAL_KW and the pipeline it needs
SPATIAL_KW = dict(color_map_image=color_map(), num_samples=2, return_latents=True,
                  sharding="spatial", **KW)
SPATIAL_CASES = {
    "img2img": dict(init_image=color_map()[::-1].copy(), strength=0.6),
    "inpaint 9-channel": dict(init_image=color_map()[::-1].copy(), mask_image=mask(),
                              strength=0.8),
    "inpaint legacy": dict(init_image=color_map()[::-1].copy(), mask_image=mask(),
                           strength=0.8),
    "euler_ancestral": {},
    "custom weight function": dict(weight_function=custom_fn),
    "std weight function": dict(weight_function=WEIGHT_FNS["std"]),
    "sag": dict(sag_scale=0.75),
    "tome": dict(tome_ratio=0.5),
    "freeu": dict(freeu=(1.1, 1.2, 0.9, 0.2)),
    "deepcache": dict(cache_interval=2, num_inference_steps=3),
    "controlnet": dict(control_image=color_map()[:, ::-1].copy(),
                       controlnet_conditioning_scale=1.5),
    "ip-adapter": {},
    "sdxl": {},
    "prompt editing": dict(prompt="a [cat:dog:0.5] and a dog", prompt_editing=True),
    "inpaint full res": dict(init_image=color_map()[::-1].copy(), mask_image=mask(),
                             strength=0.8, inpaint_full_res=True, inpaint_full_res_padding=8,
                             return_latents=False, output_type="np"),
    "lcm": dict(guidance_scale=4.0),
    "t2i-adapter": dict(adapter_image=color_map()[:, ::-1].copy(),
                        adapter_conditioning_scale=20.0),
    "ip-adapter plus": dict(ip_adapter_image=color_map()[::-1].copy(), ip_adapter_scale=4.0),
    "sdxl ensemble": {},
    # generate_hires returns images: 64 px, then 128 px at strength 0.7
    "hires latent": dict(upscale_mode="latent", hires_strength=0.7, output_type="np"),
    "hires image": dict(upscale_mode="image", hires_strength=0.7, output_type="np",
                        num_samples=1),
}
# the SDXL ensemble: the base to this fraction, the refiner from its latents
ENSEMBLE_AT = 0.5


def spatial_pipelines(params, mesh, control_state, ip_embed):
    """{case: (pipeline, extra kwargs)} for SPATIAL_CASES on ``mesh``."""
    base = pipeline(params, mesh)
    tiny = SDModelConfig.tiny()
    tome = dataclasses.replace(tiny, unet=dataclasses.replace(tiny.unet, tome_min_tokens=64))
    ip = pipeline(params, mesh)
    ip.load_ip_adapter(seed=3, image_embed_dim=ip_embed.shape[1])
    control = pipeline(params, mesh)
    control.load_controlnet(params=control_state)
    lcm = dataclasses.replace(tiny, unet=dataclasses.replace(tiny.unet, time_cond_proj_dim=8))
    t2i = pipeline(params, mesh)
    t2i.load_t2i_adapter(seed=5)
    vision = CLIPVisionConfig.tiny()
    with torch.device("meta"):
        encoder = CLIPVisionEncoder(vision)
    plus = pipeline(params, mesh)
    plus.load_ip_adapter(ip_adapter_file_state(unet(params), vision.hidden_size, seed=8,
                                               plus=(16, 2, 2, 6), std=0.2, device="cpu"),
                         image_encoder=(vision, synthetic_state(
                             encoder, torch.Generator().manual_seed(6), torch.float32)))
    xl = pipeline(None, mesh, cfg=SDModelConfig.tiny_xl(), seed=11)
    pipes = {
        "inpaint 9-channel": pipeline(None, mesh, cfg=SDModelConfig.tiny(9), seed=4),
        "euler_ancestral": pipeline(params, mesh, "euler_ancestral"),
        "tome": pipeline(params, mesh, cfg=tome),
        "controlnet": control,
        "ip-adapter": ip,
        "sdxl": xl,
        "lcm": pipeline(None, mesh, "lcm", cfg=lcm, seed=12),
        "t2i-adapter": t2i,
        "ip-adapter plus": plus,
        "sdxl ensemble": (xl, pipeline(None, mesh, cfg=SDModelConfig.tiny_xl_refiner(),
                                       seed=13)),
    }
    extra = {"ip-adapter": dict(ip_adapter_image=ip_embed)}
    return {case: (pipes.get(case, base), dict(kw, **extra.get(case, {})))
            for case, kw in SPATIAL_CASES.items()}


def control_state(seed: int = 3):
    """A tiny ControlNet whose zero convolutions are not zero (a net that
    changes the UNet's output)."""
    net = build_models(SDModelConfig.tiny(), parts=("controlnet",))["controlnet"]
    state = synthetic_state(net, torch.Generator().manual_seed(seed), torch.float32)
    return {k: v * 25.0 if k.startswith(("controlnet_down_blocks", "controlnet_mid_block"))
            else v for k, v in state.items()}


def spatial_call(pipe, kw, **extra):
    """One SPATIAL_CASES call: ``generate``; for a (base, refiner) pair the
    base to ENSEMBLE_AT and the refiner from its latents; with an
    ``upscale_mode``, ``generate_hires`` (which returns images)."""
    kw = dict(kw, **extra)
    if isinstance(pipe, tuple):
        base, refiner = pipe
        lat = base.generate(denoising_end=ENSEMBLE_AT, **kw)
        return refiner.generate(init_latents=lat, denoising_start=ENSEMBLE_AT, **kw)
    if "upscale_mode" in kw:
        kw.pop("return_latents")
        return pipe.generate_hires(**kw)
    return pipe.generate(**kw)


def unet_grads(model, seed: int = 3):
    """The gradient of a fixed projection of the tiny UNet's output with
    respect to its latents and text states (no PwW bias, as in training)."""
    lat, text, _ = unet_inputs(2)
    lat, text = lat.requires_grad_(True), text.requires_grad_(True)
    out = model(lat, torch.tensor(500.0), text)
    proj = torch.from_numpy(np.random.default_rng(seed).standard_normal(out.shape)
                            .astype(np.float32))
    (out * proj).sum().backward()
    return lat.grad.numpy(), text.grad.numpy()


def train(pipe):
    """2 TI steps and 2 LoRA steps (rank 4) on two 64-px images:
    (embedding, TI losses, {site: {a, b}}, LoRA losses)."""
    images = [color_map(), color_map()[::-1].copy()]
    lora = train_lora(pipe, images, "a cat", rank=4, num_steps=2, seed=5, learning_rate=1e-2)
    ti = train_textual_inversion(pipe, images, "<cat>", "cat", num_steps=2, seed=3)
    return (ti.embedding.numpy(), ti.losses,
            {k: {n: t.numpy() for n, t in f.items()} for k, f in lora.factors.items()},
            lora.losses)


def serve(pipe, rank: int):
    """Rank 0: a Batcher over 4 requests submitted together, a bad one
    (a mask without an init image), then one more; the other ranks follow.
    Returns rank 0's (images, error, last image, stats), a follower's
    ``follow`` counts."""
    if rank != 0:
        return follow(pipe)
    b = Batcher(pipe, max_batch=4, max_wait_ms=2000.0)
    try:
        futs = [b.submit(dict(r, num_inference_steps=2)) for r in requests(4)]
        images = np.stack([np.asarray(f.result(timeout=300)) for f in futs])
        bad = dict(requests(1)[0], mask_image=mask(), num_inference_steps=2)
        try:
            b.submit(bad).result(timeout=300)
            error = None
        except ValueError as e:
            error = str(e)
        last = np.asarray(b.submit(dict(requests(5, 4)[0], num_inference_steps=2))
                          .result(timeout=300))
    finally:
        b.close()
    return images, error, last, dict(b.stats)


def unet_inputs(n: int = 8, h: int = 8):
    """Latents, text states and a strong PwW weight pyramid for the tiny UNet."""
    rng = np.random.default_rng(7)
    lat = torch.from_numpy(rng.standard_normal((n, 4, h, h)).astype(np.float32))
    text = torch.from_numpy(rng.standard_normal((n, 77, 32)).astype(np.float32))
    weights = {s: torch.from_numpy(3.0 * rng.random((n, s, 77)).astype(np.float32))
               for s in (h * h, h * h // 4)}
    return lat, text, weights


def unet_forward(unet, lat, text, weights, mode: str):
    """(output, SAG's mid-block probabilities) of one forward at sigma 8."""
    wf = (CustomWeightFunction(custom_fn) if mode == "custom"
          else WeightFunction(scale=0.4, reduce_mode=mode))
    pww = PwwState(weights=weights, weight_orig=None, sigma=torch.tensor(8.0), weight_fn=wf)
    probs = []
    with torch.no_grad():
        out = unet(lat, torch.tensor(500.0), text, pww, sag_probs=probs)
    return out, probs[0]


def unet(params):
    module = build_models(SDModelConfig.tiny(), parts=("unet",))["unet"]
    module.load_state_dict({k: v.clone() for k, v in params["unet"].items()}, assign=True)
    return module.eval()


def rank_cases(rank: int, params, lora_state, ip_embed, control):
    """Every case on this rank; returns {case: host value}."""
    torch.set_num_threads(1)
    out = {}
    cm = color_map()
    t0 = time.perf_counter()
    for dp, tp in MESHES:
        mesh = M.make_mesh(dp, tp, device_type="cpu")
        model = M.shard_params(unet(params), mesh)
        lat, text, weights = unet_inputs()
        for mode in UNET_MODES:
            y, probs = unet_forward(model, M.shard_batch(lat, mesh), M.shard_batch(text, mesh),
                                    {k: M.shard_batch(v, mesh) for k, v in weights.items()}, mode)
            out["unet", dp, tp, mode] = M.gather_batch(y, mesh, 8).numpy()
            out["sag_probs", dp, tp, mode] = M.gather_batch(probs, mesh, 8).numpy()
        pipe = pipeline(params, mesh)
        if (dp, tp) == (4, 1):
            pipe0 = pipe
        out["generate", dp, tp] = pipe.generate(color_map_image=cm, num_samples=4,
                                                return_latents=True, **KW)
        out["batch", dp, tp] = np.asarray(pipe.generate_batch(
            requests(4), num_inference_steps=2, output_type="np"))
        if tp < 4:  # spatial: (4, 1) and (2, 2)
            M.COLLECTIVES.clear()
            out["spatial", dp, tp] = pipe.generate(color_map_image=cm, num_samples=4,
                                                   return_latents=True, sharding="spatial",
                                                   **KW)
            out["spatial collectives", dp, tp] = dict(M.COLLECTIVES)
    # (4, 1): a 32-px map, whose 2-row level dp 4 does not divide (it runs
    # whole); and spatial images (the decode sharded too)
    out["spatial undivided"] = pipe0.generate(**dict(SPATIAL_KW, color_map_image=color_map(32)))
    M.COLLECTIVES.clear()
    out["spatial images"] = pipe0.generate(**dict(SPATIAL_KW, return_latents=False,
                                                  output_type="np"))
    out["spatial images collectives"] = dict(M.COLLECTIVES)

    mesh = M.make_mesh(2, 2, device_type="cpu")
    pipe = pipeline(params, mesh)
    kw = dict(color_map_image=cm, num_samples=4, return_latents=True, **KW)
    for name, wf in WEIGHT_FNS.items():
        out["weight_fn", name] = pipe.generate(weight_function=wf, **kw)
    out["weight_fn", "custom"] = pipe.generate(weight_function=custom_fn, **kw)
    out["sag"] = pipe.generate(sag_scale=0.75, **kw)
    seen = []
    out["callback"] = pipe.generate(callback=lambda i, t, x: seen.append(tuple(x.shape)), **kw)
    out["callback_shapes"] = seen
    out["img2img"] = pipe.generate(init_image=color_map(), strength=0.6, **kw)
    out["undivided", "generate"] = pipe.generate(**dict(kw, num_samples=1))
    out["undivided", "batch"] = np.asarray(pipe.generate_batch(
        requests(3), num_inference_steps=2, output_type="np"))
    out["images"] = pipe.generate(color_map_image=cm, num_samples=4, output_type="np", **KW)
    proj = "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj.weight"
    out["geglu"] = pipe.unet.state_dict()[proj].numpy()
    out["tp_cuts"] = dict(pipe.unet.tp_cuts)
    out["ancestral"] = pipeline(params, mesh, "euler_ancestral").generate(**kw)

    M.COLLECTIVES.clear()
    pipe.generate(color_map_image=cm, num_samples=4, **dict(KW, num_inference_steps=1))
    out["collectives"] = dict(M.COLLECTIVES)

    before = {k: v.clone() for k, v in pipe.unet.state_dict().items()}
    out["lora_modules"] = pipe.load_lora(lora_state, scale=0.8)
    out["lora"] = pipe.generate(**kw)
    pipe.unload_loras()
    out["lora_restored"] = all(torch.equal(v, pipe.unet.state_dict()[k])
                               for k, v in before.items())
    pipe.load_ip_adapter(seed=3, image_embed_dim=ip_embed.shape[1])
    out["ip"] = pipe.generate(ip_adapter_image=ip_embed, **kw)
    out["ip_cut"] = tuple(pipe.unet.state_dict()[
        "mid_block.attentions.0.transformer_blocks.0.attn2.to_k_ip.weight"].shape)

    out["seconds", "data and tensor parallel"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for case, (p, kw) in spatial_pipelines(params, mesh, control, ip_embed).items():
        seen, extra = [], {}
        if case == "img2img":
            extra = dict(callback=lambda i, t, x: seen.append(tuple(x.shape)))
        elif case == "hires latent":  # the last visit of each pass: its final latents
            extra = dict(callback=lambda i, t, x: seen.append(x.numpy().copy()),
                         callback_steps=100)
        out["spatial", case] = spatial_call(p, dict(SPATIAL_KW, **kw), **extra)
        if case == "img2img":
            out["spatial callback shapes"] = seen
        elif seen:
            out["spatial hires latents"] = seen[-1]
    out["seconds", "spatial"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out["serve"] = serve(pipeline(params, mesh), rank)
    out["seconds", "serve"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out["grads"] = unet_grads(M.shard_params(unet(params), mesh))
    M.COLLECTIVES.clear()
    out["train"] = train(pipeline(params, mesh))
    out["train collectives"] = dict(M.COLLECTIVES)
    out["seconds", "train"] = time.perf_counter() - t0

    try:
        M.make_mesh(3, 2, device_type="cpu")
    except ValueError as e:
        out["make_mesh_error"] = str(e)
    return out


def whole_cases(params, lora_state, ip_embed, control):
    """The same calls without a mesh, in this process."""
    out = {}
    cm = color_map()
    model = unet(params)
    lat, text, weights = unet_inputs()
    for mode in UNET_MODES:
        y, probs = unet_forward(model, lat, text, weights, mode)
        out["unet", mode], out["sag_probs", mode] = y.numpy(), probs.numpy()
    pipe = pipeline(params)
    kw = dict(color_map_image=cm, num_samples=4, return_latents=True, **KW)
    out["generate"] = pipe.generate(**kw)
    out["batch"] = np.asarray(pipe.generate_batch(requests(4), num_inference_steps=2,
                                                  output_type="np"))
    for name, wf in WEIGHT_FNS.items():
        out["weight_fn", name] = pipe.generate(weight_function=wf, **kw)
    out["weight_fn", "custom"] = pipe.generate(weight_function=custom_fn, **kw)
    out["sag"] = pipe.generate(sag_scale=0.75, **kw)
    out["img2img"] = pipe.generate(init_image=color_map(), strength=0.6, **kw)
    out["undivided", "generate"] = pipe.generate(**dict(kw, num_samples=1))
    out["undivided", "batch"] = np.asarray(pipe.generate_batch(
        requests(3), num_inference_steps=2, output_type="np"))
    out["images"] = pipe.generate(color_map_image=cm, num_samples=4, output_type="np", **KW)
    out["geglu"] = pipe.unet.state_dict()[
        "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj.weight"].numpy()
    out["ancestral"] = pipeline(params, None, "euler_ancestral").generate(**kw)
    pipe.load_lora(lora_state, scale=0.8)
    out["lora"] = pipe.generate(**kw)
    pipe.unload_loras()
    pipe.load_ip_adapter(seed=3, image_embed_dim=ip_embed.shape[1])
    out["ip"] = pipe.generate(ip_adapter_image=ip_embed, **kw)

    out["spatial undivided"] = pipeline(params).generate(
        **dict(SPATIAL_KW, color_map_image=color_map(32)))
    out["spatial images"] = pipeline(params).generate(**dict(SPATIAL_KW, return_latents=False,
                                                             output_type="np"))
    for case, (p, kw) in spatial_pipelines(params, None, control, ip_embed).items():
        out["spatial", case] = spatial_call(p, dict(SPATIAL_KW, **kw))
    out["plain small"] = pipeline(params).generate(**SPATIAL_KW)
    out["batch last"] = np.asarray(pipeline(params).generate_batch(
        [dict(requests(5, 4)[0], num_inference_steps=2)], num_inference_steps=2,
        output_type="np"))[0]
    out["grads"] = unet_grads(unet(params))
    out["train"] = train(pipeline(params))
    return out


def lora_state(params, rank: int = 4, seed: int = 0):
    """A kohya LoRA on every attention and feed-forward linear of the UNet."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, t in params["unet"].items():
        if not key.endswith(".weight") or t.dim() != 2 or not (
                ".attn" in key or ".ff." in key):
            continue
        flat = "lora_unet_" + key[:-len(".weight")].replace(".", "_")
        out_dim, in_dim = t.shape
        state[f"{flat}.lora_down.weight"] = torch.from_numpy(
            0.2 * rng.standard_normal((rank, in_dim)).astype(np.float32))
        state[f"{flat}.lora_up.weight"] = torch.from_numpy(
            0.2 * rng.standard_normal((out_dim, rank)).astype(np.float32))
        state[f"{flat}.alpha"] = torch.tensor(float(rank))
    return state

