"""The readings that a cell's limit is set from, on the card, in one process.

    python3 portbench/control.py --workload <cell> --seeds 11 12 ... \
        --control-seeds 21 22 23 --seconds 6

For each of ``--seeds``: one run of the cell (``harness.run``, a short
window at the cell's own load) and its ``image_rel_l2``, the program's
reading. For each of ``--control-seeds``: the control, the reference put in
the program's place one precision step below the configuration's bfloat16:
every product with its operands rounded to fp8 e4m3 (``reference/lowp.py``),
on the first request of as many clients as a run checks, against the
float32 reference on the same requests, judged by the harness's own
decision (``check.judge``), which has to give ``correct`` false. The
benchmark's own runs never run this. One JSON line per reading, then a
summary line.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_reading(cell: str, seed: int):
    """(the numbers the harness compares, ``correct``) with the fp8
    reference's images in the program's place."""
    import torch

    from portbench import check, harness, loadgen, manifest, modelcfg, weights
    from portbench.reference.lowp import set_fp8
    from portbench.reference.models import build
    from portbench.wordtok import WordTokenizer

    man = manifest.load(ROOT)
    w = manifest.workload(man, cell)
    conf = next(c for c in man["configs"] if c["name"] == w["config"])
    cfg = modelcfg.load(os.path.join(ROOT, conf["file"]))
    mix = loadgen.load_mix(w["traffic"], os.path.join(ROOT, "portbench"))
    settings = harness.cell_settings(cell, os.path.join(ROOT, "portbench"))
    tok, tok2 = WordTokenizer(), (WordTokenizer(0) if cfg.get("clip2") else None)
    _, params = weights.draw(weights.shapes_of(build(cfg, "meta")), seed, "cuda",
                             torch.bfloat16)
    ref = check.build_reference(cfg, params, "cuda", tok, tok2)
    del params
    reqs = [loadgen.make_request(mix, seed, c, 0) for c in range(settings["check"]["sample"])]
    rows = int(settings["check"]["rows"])
    want = check.reference_images(ref, mix, reqs, rows)
    for m in ref.m.values():
        set_fp8(m, True)
    got = check.reference_images(ref, mix, reqs, rows)
    del ref
    torch.cuda.empty_cache()
    return check.judge(list(zip(got, want)), 0, settings["check"]["image_rel_l2"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("[control] no CUDA device", file=sys.stderr)
        return 2
    program, control = [], []
    for seed in args.seeds:
        t = time.perf_counter()
        out = harness.run(args.workload, seed, args.seconds, False, t)
        program.append(out["check"]["image_rel_l2"]["value"])
        print(json.dumps({"side": "program", "seed": seed, "correct": out["correct"],
                          "image_rel_l2": program[-1], "metrics": out["metrics"],
                          "attempted": out["attempted"], "failed": out["failed"],
                          "memory_peak_bytes": out["device"]["memory_peak_bytes"],
                          "s": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        t = time.perf_counter()
        numbers, correct = control_reading(args.workload, seed)
        control.append(numbers["image_rel_l2"]["value"])
        print(json.dumps({"side": "control_fp8", "seed": seed, "correct": correct,
                          "image_rel_l2": control[-1], "check": numbers,
                          "s": time.perf_counter() - t}), flush=True)
    print(json.dumps({"workload": args.workload, "program_max": max(program, default=None),
                      "control_min": min(control, default=None),
                      "device": torch.cuda.get_device_name(0),
                      "power_limit": harness.power_limit()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
