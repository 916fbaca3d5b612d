"""Rank-side cases for tests/test_torch_sharding.py: what every gloo rank of
a 4-process group runs, and the inputs the test process builds the same
way for the calls without a mesh. No JAX here: each spawned rank imports
this module, and only torch and the port."""
import numpy as np
import torch

from pww_tpu_torch.config import SDModelConfig
from pww_tpu_torch.ops.weight_functions import CustomWeightFunction, WeightFunction
from pww_tpu_torch.parallel import mesh as M
from pww_tpu_torch.pipeline.pipeline import PwwPipeline
from pww_tpu_torch.serving.batcher import Batcher
from pww_tpu_torch.training.lora import LoraTrainer
from pww_tpu_torch.training.textual_inversion import TextualInversionTrainer
from pww_tpu_torch.types import PwwState
from pww_tpu_torch.weights.bridge import build_models

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


def requests(n: int):
    """``generate_batch`` requests, each with its own seed and prompt."""
    return [dict(prompt=f"a cat and a dog {i}", color_map_image=color_map(),
                 color_context=KW["color_context"], seed=10 + i) for i in range(n)]


def pipeline(params, mesh=None, scheduler: str = "lms", cfg=None) -> PwwPipeline:
    return PwwPipeline(cfg or SDModelConfig.tiny(), params=params, scheduler=scheduler,
                       device="cpu", dtype=torch.float32, mesh=mesh)


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


def rank_cases(rank: int, params, lora_state, ip_embed):
    """Every case on this rank; returns {case: host value}."""
    torch.set_num_threads(1)
    out = {}
    cm = color_map()
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
        out["generate", dp, tp] = pipe.generate(color_map_image=cm, num_samples=4,
                                                return_latents=True, **KW)
        out["batch", dp, tp] = np.asarray(pipe.generate_batch(
            requests(4), num_inference_steps=2, output_type="np"))

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

    ids = pipe.tokenizer("<cat>")["input_ids"]
    out["refusals"] = {}
    for name, make in (("textual inversion",
                        lambda: TextualInversionTrainer(pipe, [cm], "<cat>", "cat")),
                       ("lora", lambda: LoraTrainer(pipe, [cm], "a cat")),
                       ("batcher", lambda: Batcher(pipe))):
        try:
            make()
        except NotImplementedError as e:
            out["refusals"][name] = str(e)
    out["tokenizer_grew"] = pipe.tokenizer("<cat>")["input_ids"] != ids

    try:
        M.make_mesh(3, 2, device_type="cpu")
    except ValueError as e:
        out["make_mesh_error"] = str(e)
    return out


def whole_cases(params, lora_state, ip_embed):
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

