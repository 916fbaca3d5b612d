"""The K1-K3 launches of one UNet visit, by configuration and latent grid:
frozen copies of ``chip_smoke.py``'s site tables (``SHAPES``, ``VISIT``,
``HIRES_VISIT``, ``SDXL_SITES``), which tests there trace on the meta device.
Each entry: (kernel, heads, Lq, Lk, head width, launches a visit); a visit
has B = 2 rows a sample (CFG). Cross-attention takes the 77 text keys.

* SD-1.5, latent 64² (512²): cross-attention K1 + K2 at 5 sites of each of
  Lq 4096 / 1024 / 256 (dh 40 / 80 / 160); self-attention K3 at the 5 sites
  of L 4096 and of L 1024 (the 8×8 mid block stays dense): 15 / 15 / 10.
* SD-1.5, latent 128² (the hires fix's second pass): Lq 16384 / 4096 /
  1024 at 5 sites each and the 16² mid block's Lq 256 (dh 160) for K1 + K2;
  K3 at the 15 sites of L ≥ 1024: 16 / 16 / 15.
* SDXL-base, latent 128²: 10 sites at (10 heads, 4096) and 60 at (20
  heads, 1024), dh 64, each K1, K2 and K3: 70 / 70 / 70.
"""
from __future__ import annotations

TEXT = 77


def _sd15(levels, k3_levels):
    out = []
    for lq, dh, n in levels:
        out += [("K1", 8, lq, TEXT, dh, n), ("K2", 8, lq, TEXT, dh, n)]
    for l, dh, n in k3_levels:
        out.append(("K3", 8, l, l, dh, n))
    return out


SITES = {
    ("sd15", 64, 64): _sd15([(4096, 40, 5), (1024, 80, 5), (256, 160, 5)],
                            [(4096, 40, 5), (1024, 80, 5)]),
    ("sd15", 128, 128): _sd15([(16384, 40, 5), (4096, 80, 5), (1024, 160, 5), (256, 160, 1)],
                              [(16384, 40, 5), (4096, 80, 5), (1024, 160, 5)]),
    ("sdxl_base", 128, 128): [(k, h, lq, TEXT if k != "K3" else lq, 64, n)
                              for h, lq, n in ((10, 4096, 10), (20, 1024, 60))
                              for k in ("K1", "K2", "K3")],
}


def visit_sites(config: str, h: int, w: int):
    return SITES[(config, h, w)]


def launches_per_visit(config: str, h: int, w: int):
    """{kernel: launches} of one visit."""
    out = {"K1": 0, "K2": 0, "K3": 0}
    for kernel, *_, n in SITES[(config, h, w)]:
        out[kernel] += n
    return out
