"""Resolve a cell of BENCHMARK.json to its files, by name:

  gpu_bench/configs/<config>.json    the deployment's settings
  gpu_bench/traffic/<traffic>.json   the traffic mix: its ``kind`` and
                                     that kind's parameters
  gpu_bench/drivers/<kind>.py        the generator of a traffic kind
  gpu_bench/metrics/<metric>.py      one reader per metric (a name such
                                     as ``k1_roofline.ggx`` is its file's
                                     name too)
  gpu_bench/limits/<workload>.json   the limit of each number compared
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
from typing import List

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def resolve(workload: str, bench_path: str = None) -> Cell:
    bench = load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; one of {sorted(cells)}")
    return cell(cells[workload], bench)


def cell(w: dict, bench: dict) -> Cell:
    """The cell of a ``workloads`` entry, with its files and metrics."""
    workload = w["name"]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"],
        traffic_name=w["traffic"],
        config=load_json(os.path.join(BENCH, "configs",
                                      w["config"] + ".json")),
        traffic=load_json(os.path.join(BENCH, "traffic",
                                       w["traffic"] + ".json")),
        limits=load_json(os.path.join(BENCH, "limits", workload + ".json")),
        end_to_end=e2e, per_layer=per_layer)


def kind(traffic: dict):
    """The module gpu_bench/drivers/<kind>.py of a traffic mix."""
    return importlib.import_module(f"gpu_bench.drivers.{traffic['kind']}")


def driver(config: dict, traffic: dict, seed: int, devices):
    """The ``Driver`` of a traffic mix's kind over the cell's ``devices``
    (one a card, in order)."""
    return kind(traffic).Driver(config, traffic, seed, devices=devices)


def reader(metric: str):
    """The ``read(ctx)`` of gpu_bench/metrics/<metric>.py, loaded from its
    file, since a metric split by cells has a dot in its name."""
    name = "gpu_bench.metrics." + metric.replace(".", "__")
    if name not in sys.modules:
        found = importlib.util.spec_from_file_location(
            name, os.path.join(BENCH, "metrics", metric + ".py"))
        module = importlib.util.module_from_spec(found)
        sys.modules[name] = module
        found.loader.exec_module(module)
    return sys.modules[name].read
