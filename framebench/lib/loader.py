"""Everything that belongs to one configuration, cell or per-layer metric
sits in files of its own, found by the name BENCHMARK.json gives it:

  configs/<config>.json      the configuration as it is run
  scenes/<config>.py         builds the program's cell: `build(config,
                             params, seed, device)`
  reference/<config>.py      the plain reference: `Reference(config,
                             device)`
  workloads/<cell>.json      the cell's traffic parameters and the limits
                             of its comparison
  metrics/<metric>.py        a per-layer metric's reader: `read(trace)`
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def json_file(kind: str, name: str, base: str = HERE) -> dict:
    with open(os.path.join(base, kind, f"{name}.json")) as f:
        return json.load(f)


def module(kind: str, name: str, base: str = HERE):
    """<base>/<kind>/<name>.py (base: this folder) as a module of its
    own."""
    path = os.path.join(base, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"framebench.{kind}.{name.replace('-', '_').replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench: dict, workload: str, base: str = HERE) -> dict:
    """The cell's BENCHMARK.json entry, its configuration entry and file,
    its workload file, and the per-layer and end-to-end metrics it
    reports."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(os.path.dirname(base), conf["file"])) as f:
        config = json.load(f)

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return dict(entry=entry, config_entry=conf, config=config,
                params=json_file("workloads", workload, base),
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))
