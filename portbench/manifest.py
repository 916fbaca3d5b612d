"""``BENCHMARK.json``: loading, and the checks of its form.

:func:`problems` lists every way the file departs from the form the
benchmark's contract sets (keys, names, units, bounds, cells, paths), and
that each name it gives has its file: a configuration, a traffic mix, a
cell's check settings, a reader for every metric.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$"
                   r"|experts_per_tok|channels)")


def load(root: str = REPO) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(manifest: Dict, name: str) -> Dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(manifest: Dict, cell: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    listing it, and those without a list that move a metric it reports."""
    cell_e2e = {m["name"] for m in manifest["end_to_end"]
                if cell in m.get("workloads", [cell])}
    out = []
    for m in manifest[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in cell_e2e:
            out.append(m)
    return out


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def problems(m: Dict, root: str = REPO) -> List[str]:
    p: List[str] = []
    if set(m) != TOP:
        p.append(f"top-level keys {sorted(m)}")
    cmd, paths = m.get("command", []), m.get("paths", [])
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32 and all(_line(c) for c in cmd)):
        p.append("command")
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16
            and all(PATH.match(x) and not x.startswith("/") and ".." not in x for x in paths)):
        p.append("paths")
    for c in cmd[1:]:
        if c.startswith("/") or ".." in c:
            p.append(f"command word {c}")
        elif ("/" in c or c.endswith(".py")) and not any(c.startswith(x + "/") for x in paths):
            p.append(f"command names {c} outside paths")
    rs = m.get("run_seconds")
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        p.append("run_seconds")
    configs = {c.get("name"): c for c in m.get("configs", [])}
    if not 1 <= len(configs) <= 24 or len(configs) != len(m.get("configs", [])):
        p.append("configs: count or duplicate names")
    files = set()
    for c in configs.values():
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            p.append(f"config {c.get('name')}: keys {sorted(c)}")
            continue
        if not NAME.match(c["name"]) or not _line(c["source"]) or not _line(c["why"]):
            p.append(f"config {c['name']}: name, source or why")
        if c["file"] in files or not any(c["file"].startswith(x + "/") for x in paths):
            p.append(f"config {c['name']}: file")
        files.add(c["file"])
        if not os.path.exists(os.path.join(root, c["file"])):
            p.append(f"config {c['name']}: {c['file']} missing")
        if len(c["reduced"]) > 16 or any(not NAME.match(k) or WIDTH.search(k)
                                         for k in c["reduced"]):
            p.append(f"config {c['name']}: reduced")
    cells = m.get("workloads", [])
    pairs, names = set(), set()
    for w in cells:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            p.append(f"workload {w.get('name')}: keys {sorted(w)}")
            continue
        if not all(NAME.match(w[k]) for k in ("name", "config", "traffic")) or not _line(w["why"]):
            p.append(f"workload {w['name']}: names or why")
        if w["config"] not in configs:
            p.append(f"workload {w['name']}: unknown config")
        if w["chips"] not in (1, 4) or (w["config"], w["traffic"]) in pairs or w["name"] in names:
            p.append(f"workload {w['name']}: chips or duplicate")
        pairs.add((w["config"], w["traffic"]))
        names.add(w["name"])
        for sub, name in (("traffic", w["traffic"]), ("cells", w["name"])):
            if not os.path.exists(os.path.join(root, "portbench", sub, name + ".json")):
                p.append(f"workload {w['name']}: portbench/{sub}/{name}.json missing")
    if not 1 <= len(cells) <= 24:
        p.append("workloads: count")
    if sum(w.get("chips") == 4 for w in cells) > max(1, len(cells) // 4):
        p.append("workloads: too many on 4 chips")
    used = {w.get("config") for w in cells}
    if set(configs) - used:
        p.append(f"configs used by no cell: {sorted(set(configs) - used)}")
    metric_names = set()
    for kind, lo, hi in (("end_to_end", 1, 16), ("per_layer", 1, 128)):
        ms = m.get(kind, [])
        if not lo <= len(ms) <= hi:
            p.append(f"{kind}: count")
        for x in ms:
            keys = {"name", "unit", "better", "source"} | (
                {"bound"} if kind == "end_to_end" else {"layer", "moves"})
            if set(x) - {"workloads"} != keys:
                p.append(f"{kind} {x.get('name')}: keys {sorted(x)}")
                continue
            if not NAME.match(x["name"]) or x["name"] in metric_names:
                p.append(f"{kind} {x['name']}: name")
            metric_names.add(x["name"])
            if not UNIT.match(x["unit"]) or x["better"] not in ("lower", "higher"):
                p.append(f"{kind} {x['name']}: unit or better")
            if x["source"] not in SOURCES or (kind == "end_to_end" and x["source"] not in
                                              ("host_clock", "device_trace")):
                p.append(f"{kind} {x['name']}: source")
            if kind == "end_to_end" and not 0.01 <= x["bound"] <= 0.25:
                p.append(f"{kind} {x['name']}: bound")
            if kind == "per_layer" and not _line(x["layer"]):
                p.append(f"{kind} {x['name']}: layer")
            if any(c not in names for c in x.get("workloads", [])):
                p.append(f"{kind} {x['name']}: unknown workload")
            folder = "e2e" if kind == "end_to_end" else "metrics"
            if not os.path.exists(os.path.join(root, "portbench", folder, x["name"] + ".py")):
                p.append(f"{kind} {x['name']}: no reader portbench/{folder}/{x['name']}.py")
    e2e = {x["name"] for x in m.get("end_to_end", [])}
    if "setup_s" not in e2e:
        p.append("end_to_end: no setup_s")
    for x in m.get("per_layer", []):
        if x.get("moves") not in e2e:
            p.append(f"per_layer {x.get('name')}: moves")
    for w in cells:
        rep = metrics_of(m, w["name"], "end_to_end")
        if len(rep) < 2 or not metrics_of(m, w["name"], "per_layer"):
            p.append(f"workload {w['name']}: reports too few metrics")
    if len(json.dumps(m)) > 64 * 1024:
        p.append("size")
    return p


def reader(kind: str, name: str, root: Optional[str] = None):
    """The ``read`` function of ``portbench/<e2e|metrics>/<name>.py``."""
    import importlib.util

    folder = "e2e" if kind == "end_to_end" else "metrics"
    path = os.path.join(root or HERE, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
