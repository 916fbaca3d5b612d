"""A run with the timed path broken underneath comes out not correct.

Each tiny cell (one per entry: the batcher, ``generate``)
runs the whole harness on the CPU, past its look for a card, with one fault
planted in the program: a scheduler step that returns its state unchanged;
half of the CFG batch left out, the mean of the other half in its place; an
image altered where it is produced. A sound run comes out correct. The
cells run on one chip, so no exchange between chips can be left out.
"""
import pytest
import torch

from .conftest import run_tiny

CELLS = ("tiny_serve", "tiny_xl")


def step_unchanged(mp):
    from pww_tpu_torch.schedulers import schedules

    mp.setattr(schedules.Schedule, "_step_lms", lambda self, mo, i, sample, state, noise:
               (sample, state))


def half_batch_left_out(mp):
    from pww_tpu_torch.models import unet

    orig = unet.UNet2DConditionModel.forward

    def forward(self, sample, *a, **kw):
        out = orig(self, sample, *a, **kw)
        half = out.shape[0] // 2
        return torch.cat([out[:half], out[:half].mean(0, keepdim=True).expand_as(out[half:])])

    mp.setattr(unet.UNet2DConditionModel, "forward", forward)


def image_altered(mp):
    from pww_tpu_torch.pipeline import pipeline

    orig = pipeline.PwwPipeline.decode_uint8_device

    def decode(self, latents, shard=None):
        img = orig(self, latents, shard)
        return torch.clamp(img.int() + 16, 0, 255).to(torch.uint8)

    mp.setattr(pipeline.PwwPipeline, "decode_uint8_device", decode)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    out = run_tiny(tiny_root, cell)
    assert out["correct"], out["check"]


@pytest.mark.parametrize("fault", [step_unchanged, half_batch_left_out, image_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(tiny_root, cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run_tiny(tiny_root, cell)
    assert not out["correct"], out["check"]
    n = out["check"]["image_rel_l2"]
    assert n["value"] > n["limit"]
