"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- a configuration: the file its ``configs`` entry names;
- a traffic mix: ``traffic/<mix>.json``, whose ``job`` names the driver in
  ``jobs/<job>.py`` that reads it;
- a cell's correctness limits: ``limits/<cell>.json``;
- a per-layer metric: ``metrics/<metric>.py``, whose ``read(ctx)`` returns
  the value or ``None`` when it finds nothing to read, and whose
  ``COUNTERS``, where it has them, name the program's launch counters it
  reads (``{kernel: "module:object"}``, the object's ``launches``);
- a configuration's plain reference: the file its ``reference`` names.

A run: set-up (the job builds and warms everything), the timed window of
``--seconds`` (end-to-end metrics; with ``--trace 1`` a burst of calls
timed on the host from an idle card and a traced slice follow it, and the
per-layer metrics are read instead), then the program's state is freed
and its answers are held against the plain reference.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
#: top-level module names that may not be loaded in a run: JAX and the JAX
#: package the port was made from (``repro_torch`` is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """A run that must end without a result line (exit code 2)."""


def cache_env(repo: Path) -> dict:
    """Fixed directories inside the checkout for every build and kernel
    cache, so that only a checkout's first run builds: the port's ``nvcc``
    builds, Triton's and Inductor's caches."""
    build = repo / "build"
    return {"REPRO_TORCH_KERNEL_DIR": str(build / "kernels"),
            "TRITON_CACHE_DIR": str(build / "triton"),
            "TORCHINDUCTOR_CACHE_DIR": str(build / "inductor")}


def store_dir(repo: Path) -> Path:
    """The port's ``ProgramStore`` (the mapper's searched schedules)."""
    return repo / "perfbench" / ".store"


def prepare(repo: Path = REPO) -> None:
    """Point the caches into the checkout and put the port on the path;
    before ``torch`` is imported."""
    os.environ.update(cache_env(repo))
    sys.path.insert(0, str(repo / "src"))


class Benchmark:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, repo: Path = REPO):
        self.repo, self.bench = repo, repo / "perfbench"
        path = repo / "BENCHMARK.json"
        if not path.is_file():
            raise Refused(f"no {path}")
        self.spec = json.loads(path.read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise Refused(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                config = json.loads((self.repo / c["file"]).read_text())
                # the plain reference beside it, found in this checkout
                config["reference"] = str(self.bench / config["reference"])
                return config
        raise Refused(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.bench / "limits" / f"{cell}.json").read_text())["limits"]

    def metrics(self, kind: str, cell: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports."""
        return [m for m in self.spec[kind] if cell in m.get("workloads", [cell])]

    def metric(self, name: str):
        """The module of a per-layer metric: ``read`` and, where it reads the
        program's launch counters, ``COUNTERS``."""
        path = self.bench / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


def read_counters(names: dict) -> dict:
    """The launch counters ``{kernel: "module:object"}`` as they stand."""
    out = {}
    for kernel, where in names.items():
        module, _, obj = where.partition(":")
        out[kernel] = int(getattr(importlib.import_module(module), obj).launches)
    return out


def job_class(kind: str):
    return importlib.import_module(f"jobs.{kind}").Job


def deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = deep_merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclass
class Window:
    seconds: float
    calls: int
    units: int
    spans: list  # (name, start_ns, end_ns) of the benchmark's own spans


def timed_window(job, seconds: float) -> Window:
    """Dispatch the job's calls back to back until ``seconds`` have passed
    on the host's clock, then finish and wait for the card: the window runs
    from the first dispatch to the end of that wait."""
    spans, units, i = [], 0, 0
    start = time.perf_counter_ns()
    stop = start + int(seconds * 1e9)
    while True:
        a = time.perf_counter_ns()
        units += job.dispatch(i)
        b = time.perf_counter_ns()
        spans.append((job.span, a, b))
        i += 1
        if b >= stop:
            break
    a = time.perf_counter_ns()
    job.finish()
    job.sync()
    b = time.perf_counter_ns()
    spans.append(("sync", a, b))
    return Window((b - start) / 1e9, i, units, spans)


def host_burst(job, first: int, n: int) -> list:
    """Calls ``first .. first + n - 1`` dispatched from an idle card, each
    timed on the host: what a call costs the host while the launch queue
    has room (in a device-bound window a call's host time is the wait for
    the queue)."""
    job.sync()
    spans = []
    for i in range(first, first + n):
        a = time.perf_counter_ns()
        job.dispatch(i)
        spans.append((job.span, a, time.perf_counter_ns()))
    job.finish()
    job.sync()
    return spans


@dataclass
class Traced:
    trace: object  # yardstick.Trace
    calls: list  # the window's call indices that ran traced
    counters: dict  # the program's counters over the traced calls


def traced_slice(job, first: int, n: int, path: Path, counters: dict) -> Traced:
    """Calls ``first .. first + n - 1`` under ``torch.profiler``, each
    inside the benchmark's span, in a ``window`` span that ends after the
    card has finished; the exported trace is read and deleted.  The launch
    ``counters`` are read before and after."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from yardstick import Trace

    acts = [ProfilerActivity.CPU]
    if job.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = read_counters(counters)
    with profile(activities=acts) as prof:
        with record_function("window"):
            for i in range(first, first + n):
                with record_function(job.span):
                    job.dispatch(i)
            with record_function("sync"):
                job.finish()
                job.sync()
    after = read_counters(counters)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        trace = Trace(path)
    finally:
        path.unlink(missing_ok=True)
    return Traced(trace, list(range(first, first + n)),
                  {k: after[k] - before[k] for k in after})


@dataclass
class Context:
    """What a per-layer metric's reader is given."""
    job: object
    window: Window
    traced: Traced | None
    burst: list  # host spans of the calls of ``host_burst``


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown (nvidia-smi gave nothing)"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t0: float,
             device: str = "cuda", repo: Path = REPO, overrides: dict | None = None,
             store: str | None = None) -> dict:
    """One run of ``workload``: the result line's object (without
    printing it).  ``device="cpu"`` and ``overrides`` (merged into the
    configuration and the traffic) are for the tests, at small sizes."""
    import torch

    bench = Benchmark(repo)
    cell = bench.cell(workload)
    overrides = overrides or {}
    config = deep_merge(bench.config(cell["config"]), overrides.get("config", {}))
    traffic = deep_merge(bench.traffic(cell["traffic"]), overrides.get("traffic", {}))
    limits = bench.limits(workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{workload} needs {cell['chips']} CUDA device(s); found "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        dev = torch.device("cuda", torch.cuda.current_device())
    from repro_torch.runtime.store import ProgramStore

    store = ProgramStore(store or store_dir(repo), kernel_cache=True)
    job = job_class(traffic["job"])(config, traffic, seed, dev, store)
    job.setup()
    setup_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    window = timed_window(job, seconds)
    traced, burst = None, []
    if trace:
        readers = {m["name"]: bench.metric(m["name"])
                   for m in bench.metrics("per_layer", workload)}
        counters = {k: v for r in readers.values() for k, v in getattr(r, "COUNTERS", {}).items()}
        burst = host_burst(job, window.calls, int(traffic.get("burst_calls", 0)))
        traced = traced_slice(job, window.calls + len(burst), int(traffic["trace_calls"]),
                              repo / "build" / "perfbench" / f"trace-{workload}.json", counters)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    bad = loaded_forbidden()
    if bad:
        raise Refused(f"modules loaded in the run: {', '.join(bad)}")
    metrics = {}
    if trace:
        ctx = Context(job, window, traced, burst)
        for m in bench.metrics("per_layer", workload):
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = {**job.end_to_end(window), "setup_s": setup_s}
        for m in bench.metrics("end_to_end", workload):
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    job.release()
    numbers, failed = job.check(limits)
    correct = failed == 0 and all(v <= limits[k] for k, v in numbers.items())
    result = {
        "correct": bool(correct),
        "attempted": int(window.units),
        "failed": int(failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(peak),
        },
    }
    if traced is not None:
        result["device"]["busy_s"] = traced.trace.busy_s
        result["device"]["window_s"] = traced.trace.window_s
        result["breakdown"] = {"device_ops": traced.trace.top_ops(),
                               "idle_gaps": traced.trace.idle_gaps()}
    # the numbers compared, each beside its limit: the line's last key
    result["compared"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return result


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    prepare()
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=t0)
    except Refused as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: modules loaded in the run: {', '.join(bad)}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
