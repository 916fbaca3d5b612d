"""The norm sites' routing rule on the CPU (``ops/group_norm.py:
group_norm_site``, ``ops/layer_norm.py:layer_norm_site``).

At the default config a site runs K4 or K5 where its input is bf16 on the
card and autograd records no gradient through it, and the f32 composition
(``group_norm_f32``, ``layer_norm_f32``) everywhere else. Here the CPU is
"everywhere else"; the ``as_on_the_card`` fixture counts CPU tensors among
the kernels' devices, so that the rule's other tests run here and a site
that takes its kernel runs the kernel's plain version. Then the served
path's site tables and the launch counts of ``chip_smoke.py``'s gates
against the models, traced on the meta device. Nothing of JAX is compiled.
"""
import chip_smoke
import pytest
import torch
from torch import nn

from pww_tpu_torch.ops import cuda_build
from pww_tpu_torch.ops import group_norm as gn
from pww_tpu_torch.ops import layer_norm as ln
from torch_port_cases import few_torch_threads  # noqa: F401 (autouse)

BF16 = torch.bfloat16
GN_VARIANTS = [(False, False), (True, False), (True, True)]  # (silu, pre-add)


@pytest.fixture
def calls(monkeypatch):
    """Counts the sites' calls of the K4 and K5 wrappers, which still run."""
    seen = {"group_norm": 0, "layer_norm": 0}
    k4, k5 = gn.group_norm, ln.layer_norm

    def gn_rec(*args, **kwargs):
        seen["group_norm"] += 1
        return k4(*args, **kwargs)

    def ln_rec(*args, **kwargs):
        seen["layer_norm"] += 1
        return k5(*args, **kwargs)

    monkeypatch.setattr(gn, "group_norm", gn_rec)
    monkeypatch.setattr(ln, "layer_norm", ln_rec)
    return seen


@pytest.fixture
def as_on_the_card(monkeypatch):
    monkeypatch.setattr(cuda_build, "NORM_KERNEL_DEVICES", ("cuda", "cpu"))


def _affine(module, dtype):
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        module.weight.copy_(1.0 + 0.1 * torch.randn(module.weight.shape, generator=g))
        module.bias.copy_(0.1 * torch.randn(module.bias.shape, generator=g))
    return module.to(dtype).requires_grad_(False)


def _gn(dtype=BF16):
    return _affine(nn.GroupNorm(4, 16, eps=1e-5), dtype)


def _ln(c, dtype=BF16):
    return _affine(nn.LayerNorm(c, eps=1e-5), dtype)


def _x(shape, dtype=BF16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 2.0 + 0.5).to(dtype)


def _gn_inputs(dtype=BF16, with_add=False):
    return _x((2, 16, 6, 6), dtype), _x((2, 16), dtype, seed=1) if with_add else None


def _composition(m, x, silu, add):
    return gn.group_norm_f32(m, gn._with_add(x, add), silu=silu)


def _plain_k4(m, x, silu, add):
    return gn.group_norm_plain(x, m.weight, m.bias, groups=m.num_groups, eps=m.eps, silu=silu,
                               add=add)


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("silu,with_add", GN_VARIANTS)
def test_cpu_sites_run_the_composition_at_the_default_knobs(calls, dtype, silu, with_add):
    m, (x, add) = _gn(dtype), _gn_inputs(dtype, with_add)
    got = gn.group_norm_site(m, x, fused=False, silu=silu, add=add)
    torch.testing.assert_close(got, _composition(m, x, silu, add), rtol=0, atol=0)
    lm, lx = _ln(320, dtype), _x((2, 5, 320), dtype)
    torch.testing.assert_close(ln.layer_norm_site(lm, lx, fused=False),
                               ln.layer_norm_f32(lm, lx), rtol=0, atol=0)
    assert calls == {"group_norm": 0, "layer_norm": 0}


@pytest.mark.parametrize("silu,with_add", GN_VARIANTS)
def test_bf16_sites_off_autograd_take_the_kernels(calls, as_on_the_card, silu, with_add):
    """bf16, no gradient recorded: K4 with the pre-add and SiLU fused, and
    K5; an input that requires a gradient counts as none under no_grad."""
    m, (x, add) = _gn(), _gn_inputs(with_add=with_add)
    got = gn.group_norm_site(m, x, fused=False, silu=silu, add=add)
    torch.testing.assert_close(got, _plain_k4(m, x, silu, add), rtol=0, atol=0)
    lm, lx = _ln(320), _x((2, 5, 320))
    torch.testing.assert_close(ln.layer_norm_site(lm, lx, fused=False),
                               ln.layer_norm_plain(lx, lm.weight, lm.bias, eps=lm.eps),
                               rtol=0, atol=0)
    with torch.no_grad():
        gn.group_norm_site(m, x.clone().requires_grad_(True), fused=False, silu=silu, add=add)
        ln.layer_norm_site(lm, lx.clone().requires_grad_(True), fused=False)
    assert calls == {"group_norm": 2, "layer_norm": 2}


@pytest.mark.parametrize("case", ["x", "params", "add", "f32"])
def test_sites_keep_the_composition_under_autograd_and_in_f32(calls, as_on_the_card, case):
    """A gradient recorded through x, the affine or the pre-add, or an f32
    input: the composition, bit for bit, and under autograd its gradient."""
    dtype = torch.float32 if case == "f32" else BF16
    m, (x, add) = _gn(dtype), _gn_inputs(dtype, with_add=True)
    lm, lx = _ln(320, dtype), _x((2, 5, 320), dtype)
    if case == "x":
        x.requires_grad_(True)
        lx.requires_grad_(True)
    elif case == "params":
        m.requires_grad_(True)
        lm.requires_grad_(True)
    elif case == "add":
        add.requires_grad_(True)
    got = gn.group_norm_site(m, x, fused=False, silu=True, add=add)
    torch.testing.assert_close(got, _composition(m, x, True, add), rtol=0, atol=0)
    if case != "add":  # a LayerNorm site has no pre-add
        lgot = ln.layer_norm_site(lm, lx, fused=False)
        torch.testing.assert_close(lgot, ln.layer_norm_f32(lm, lx), rtol=0, atol=0)
        assert (lgot.grad_fn is not None) == (case != "f32")
    assert calls == {"group_norm": 0, "layer_norm": 0}
    if case != "f32":
        assert got.grad_fn is not None
        got.float().sum().backward()


@pytest.mark.parametrize("c", [12, 2056, 320, 2048])
def test_layer_norm_widths_the_kernel_refuses_fall_back(calls, as_on_the_card, c):
    """K5 takes a last dim that is a multiple of 8 and at most 2048; any
    other width takes the composition and does not raise."""
    lm, lx = _ln(c), _x((3, c))
    got = ln.layer_norm_site(lm, lx, fused=False)
    takes = c % 8 == 0 and c <= ln.MAX_WIDTH
    want = (ln.layer_norm_plain(lx, lm.weight, lm.bias, eps=lm.eps) if takes
            else ln.layer_norm_f32(lm, lx))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert calls["layer_norm"] == int(takes)


def test_layer_norm_off_a_16_byte_boundary_falls_back(calls, as_on_the_card):
    """A contiguous view that starts off a 16-byte boundary: the kernel's
    vector loads cannot take it, so the composition runs."""
    lm = _ln(320)
    lx = _x((2 * 320 + 1,))[1:].view(2, 320)
    assert lx.is_contiguous() and lx.data_ptr() % 16
    torch.testing.assert_close(ln.layer_norm_site(lm, lx, fused=False),
                               ln.layer_norm_f32(lm, lx), rtol=0, atol=0)
    assert calls["layer_norm"] == 0


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
def test_knobs_on_run_the_plain_kernels_on_the_cpu(calls, dtype):
    """``fused=True`` (the config's knobs) sends every site to K4 and K5 on
    every device: their plain versions on the CPU."""
    m, (x, add) = _gn(dtype), _gn_inputs(dtype, with_add=True)
    torch.testing.assert_close(gn.group_norm_site(m, x, fused=True, silu=True, add=add),
                               _plain_k4(m, x, True, add), rtol=0, atol=0)
    lm, lx = _ln(320, dtype), _x((2, 5, 320), dtype)
    torch.testing.assert_close(ln.layer_norm_site(lm, lx, fused=True),
                               ln.layer_norm_plain(lx, lm.weight, lm.bias, eps=lm.eps),
                               rtol=0, atol=0)
    assert calls == {"group_norm": 1, "layer_norm": 1}


def test_served_site_tables_match_the_models(monkeypatch):
    """``chip_smoke.py``'s SERVE_K4_SITES and SERVE_K5_SITES are the K4 and
    K5 calls of SD-1.5 at the default config under the rule on the card: one
    UNet visit at 16 CFG rows of 64² latents and a decode of 8 images,
    traced in bf16 on the meta device (shapes only, nothing computed)."""
    import pww_tpu_torch.models.unet as unet_mod
    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.weights.bridge import build_models

    calls, part = {}, [0]

    def gn_rec(x, weight, bias, *, groups, eps, silu=False, add=None, out_dtype=None):
        key = (tuple(x.shape), groups, eps, silu, add is not None)
        calls.setdefault(key, [0, 0, 0])[part[0]] += 1
        return torch.empty_like(x)

    def ln_rec(x, weight, bias, *, eps, out_dtype=None):
        key = (tuple(x.shape), eps)
        calls[key] = calls.get(key, 0) + 1
        return torch.empty_like(x)

    monkeypatch.setattr(cuda_build, "NORM_KERNEL_DEVICES", ("meta",))
    monkeypatch.setattr(gn, "group_norm", gn_rec)
    monkeypatch.setattr(ln, "layer_norm", ln_rec)
    monkeypatch.setattr(unet_mod, "flash_self_attention", lambda q, k, v: torch.empty_like(q))
    cfg = SDModelConfig.sd15()
    assert not (cfg.unet.fused_group_norm or cfg.unet.fused_layer_norm
                or cfg.vae.fused_group_norm)
    models = {k: m.to(BF16).requires_grad_(False)
              for k, m in build_models(cfg, parts=("unet", "vae")).items()}
    rows, images = chip_smoke.SERVE_ROWS, chip_smoke.SERVE_IMAGES
    with torch.device("meta"):
        models["unet"](torch.empty(rows, 4, 64, 64, dtype=BF16), torch.tensor(1.0),
                       torch.empty(rows, 77, 768, dtype=BF16))
        part[0] = 2
        models["vae"].decode(torch.empty(images, 4, 64, 64, dtype=BF16))
    assert {k: tuple(v) for k, v in calls.items() if len(k) == 5} == chip_smoke.SERVE_K4_SITES
    assert {k: v for k, v in calls.items() if len(k) == 2} == chip_smoke.SERVE_K5_SITES
    assert [sum(v[i] for v in chip_smoke.SERVE_K4_SITES.values()) for i in range(3)] == \
        [61, 0, 30]
    assert sum(chip_smoke.SERVE_K5_SITES.values()) == 48
    launches = chip_smoke.path_launches(30)
    assert (launches["group_norm"], launches["layer_norm"]) == (61 * 30 + 30, 48 * 30)


def _norm_modules(*modules):
    return tuple(sum(isinstance(m, t) for mod in modules for m in mod.modules())
                 for t in (nn.GroupNorm, nn.LayerNorm))


@pytest.mark.parametrize("name,norms,net", [
    ("sd15", "SD15_NORMS", "CONTROLNET_NORMS"), ("sd21", "SD15_NORMS", "CONTROLNET_NORMS"),
    ("sdxl", "SDXL_NORMS", "SDXL_CONTROLNET_NORMS"), ("sdxl_refiner", "SDXL_REFINER_NORMS", None),
    ("tiny", "TINY_NORMS", None)])
def test_launch_gates_count_the_norm_modules(name, norms, net):
    """Each GroupNorm and LayerNorm module runs once a forward, so
    ``chip_smoke.py``'s K4 / K5 launches a UNet visit, a VAE encode and a
    decode (and what a ControlNet adds to a visit) are the modules' counts;
    DeepCache's shallow visit runs down block 0, the last up block and
    ``conv_norm_out``."""
    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.weights.bridge import build_models

    cfg = getattr(SDModelConfig, name)()
    parts = ("unet", "vae") + (("controlnet",) if net else ())
    models = build_models(cfg, parts=parts)
    unet, vae = models["unet"], models["vae"]
    assert getattr(chip_smoke, norms) == (*_norm_modules(unet), _norm_modules(vae.encoder)[0],
                                          _norm_modules(vae.decoder)[0])
    if net:
        assert getattr(chip_smoke, net) == _norm_modules(models["controlnet"])
    if name == "sd15":
        assert chip_smoke.SHALLOW_NORMS == _norm_modules(
            unet.down_blocks[0], unet.up_blocks[-1], unet.conv_norm_out)


def test_unet_norm_sites_get_nchw_inputs(monkeypatch):
    """K4 reads NCHW group spans, so a site whose input is laid out
    otherwise pays a copy first. A Transformer2D's ``proj_out`` runs on
    token-major states and gives a channels-last result; the residual adds
    it to x (NCHW) second, so that the sum, and every site after it, stays
    NCHW."""
    import pww_tpu_torch.models.unet as unet_mod
    from pww_tpu_torch.config import UNetConfig

    layouts = []
    site = gn.group_norm_site

    def spy(g, x, **kwargs):
        layouts.append(x.is_contiguous())
        return site(g, x, **kwargs)

    monkeypatch.setattr(unet_mod, "group_norm_site", spy)
    torch.manual_seed(0)
    unet = unet_mod.UNet2DConditionModel(UNetConfig.tiny()).requires_grad_(False)
    with torch.no_grad():
        unet(torch.randn(2, 4, 16, 16), torch.tensor(1.0), torch.randn(2, 77, 32))
    assert len(layouts) == chip_smoke.TINY_NORMS[0] and all(layouts)
