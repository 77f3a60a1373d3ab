"""One run of one cell of ``BENCHMARK.json``: set-up, the measured window of
whole jobs through the program's CLI, the check of every job's output
against the plain reference, and one JSON line of results.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric is a file
found by its name: ``configs/<config>.json``, ``traffic/<traffic>.json``
(its ``mode`` names ``modes/<mode>.py``, which makes the inputs, the
arguments, the reference and the numbers compared of its jobs) and
``metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import io
import json
import multiprocessing
import os
import re
import shutil
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

from . import hoststate, trace as tr

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that may not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "rattle_tpu")
TRACE_RETRIES = 2
TOP = 10


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def cell_metrics(bench: dict, cell: str, trace: int) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced; an entry without ``workloads`` holds in
    every cell (a per-layer one: in every cell that reports its ``moves``)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def load_cell(root: str, name: str, trace: int):
    """(cell, configuration, traffic mix, metrics) of the cell ``name`` of
    ``root``'s BENCHMARK.json, each found by its name."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, entry["file"]))
    traffic = load_json(os.path.join(root, "gpubench", "traffic",
                                      cell["traffic"] + ".json"))
    return cell, config, traffic, cell_metrics(bench, name, trace)


def reader(name: str, root: str = ROOT):
    """``read(run)`` of ``gpubench/metrics/<name>.py`` under ``root``."""
    path = os.path.join(root, "gpubench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_mode(traffic: dict):
    return importlib.import_module("gpubench.modes." + traffic["mode"])


def _spawn_pool(workers: int) -> ProcessPoolExecutor:
    return ProcessPoolExecutor(max_workers=workers,
                               mp_context=multiprocessing.get_context("spawn"))


class Program:
    """The program's CLI, counters and device, and the jobs it runs."""

    def __init__(self, device: str):
        import torch
        from rattle_tpu_torch.ops import kernels
        from rattle_tpu_torch.pipeline import cli
        from rattle_tpu_torch.utils import metrics
        self.torch, self.cli, self.kernels = torch, cli, kernels
        self.stages = metrics.GLOBAL.stages
        self.cuda = device == "cuda"

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def job(self, argv: List[str]) -> dict:
        """One whole job through ``cli.main``: its wall seconds, and the
        engine's phase times and the kernels' launches it added."""
        st0, ln0 = dict(self.stages), self.kernels.launches()
        sink = io.StringIO()
        self.sync()
        t0, c0 = time.perf_counter(), time.process_time()
        with contextlib.redirect_stdout(sink), contextlib.redirect_stderr(sink):
            rc = self.cli.main(argv)
        self.sync()
        wall = time.perf_counter() - t0
        cpu = time.process_time() - c0
        if rc != 0:
            raise RuntimeError(f"job {argv} exited {rc}: "
                               f"{sink.getvalue()[-2000:]}")
        ln1 = self.kernels.launches()
        return dict(wall_s=wall, cpu_s=cpu,
                    stages={k: v - st0.get(k, 0.0)
                            for k, v in self.stages.items()},
                    launches={k: ln1[k] - ln0.get(k, 0) for k in ln1})

    @contextlib.contextmanager
    def spans(self, spans):
        """Record a profiler range named ``gpubench/<name>`` around each
        (module, class or None, attribute, name) of the program."""
        rf = self.torch.profiler.record_function
        saved = []
        for mod, cls, attr, name in spans:
            owner = importlib.import_module(mod)
            if cls:
                owner = getattr(owner, cls)
            fn = owner.__dict__[attr] if cls else getattr(owner, attr)

            def wrap(*a, _fn=fn, _n="gpubench/" + name, **kw):
                with rf(_n):
                    return _fn(*a, **kw)
            saved.append((owner, attr, fn))
            setattr(owner, attr, wrap)
        try:
            yield
        finally:
            for owner, attr, fn in reversed(saved):
                setattr(owner, attr, fn)

    def traced_job(self, argv: List[str], mode) -> dict:
        """One job under torch.profiler, with the mode's ``SPANS``: its wall
        and window, every device activity (kernels, copies, sets) and the
        spans, all in seconds of the profiler's clock; retried where the
        trace lost records of a kernel of the mode's ``TRACE_CHECKED``."""
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        for attempt in range(TRACE_RETRIES + 1):
            with self.spans(mode.SPANS), torch.profiler.profile(
                    activities=acts) as prof:
                with torch.profiler.record_function("gpubench/job"):
                    rec = self.job(argv)
            dev, sp, window = [], [], None
            for e in prof.events():
                a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    # the device's side of a range is no device activity
                    if not (e.is_user_annotation or e.name == ""
                            or e.name.startswith("gpubench/")):
                        dev.append((e.name, a, b))
                elif e.name == "gpubench/job":
                    window = (a, b)
                elif e.name.startswith("gpubench/"):
                    sp.append((e.name[9:], a, b))
            checked = mode.TRACE_CHECKED
            lost = {k: (n, sum(1 for d in dev if checked[k] in d[0]))
                    for k, n in rec["launches"].items() if k in checked}
            lost = {k: v for k, v in lost.items() if v[0] != v[1]}
            if not lost:
                rec.update(window=window, device=dev, spans=sp)
                return rec
        raise RuntimeError(f"the trace lost kernel records {TRACE_RETRIES + 1}"
                           f" times (launches, kernels in the trace): {lost}")


def kernel_name(name: str) -> str:
    """A device activity's name without return type, template or arguments."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0][:80]


def breakdown(traced: List[dict]) -> dict:
    ops: Dict[str, float] = {}
    idle: Dict[str, float] = {}
    for rec in traced:
        for n, a, b in rec["device"]:
            k = kernel_name(n)
            ops[k] = ops.get(k, 0.0) + (b - a)
        busy = tr.union((a, b) for _n, a, b in rec["device"])
        for k, v in tr.gaps_by_span(rec["window"], busy, rec["spans"],
                                    "cli").items():
            idle[k] = idle.get(k, 0.0) + v
    top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def judge(mode, pairs) -> Tuple[Dict[str, dict], int]:
    """The mode's ``CHECKS`` over (got, want) pairs of job outputs: each
    number combined over the jobs beside its limit, and the jobs with a
    number over its limit."""
    checks = {k: {"value": 0, "limit": lim}
              for k, (_how, lim) in mode.CHECKS.items()}
    failed = 0
    for got, want in pairs:
        c = mode.compare(got, want)
        failed += any(c[k] > lim for k, (_how, lim) in mode.CHECKS.items())
        for k, (how, _lim) in mode.CHECKS.items():
            v = checks[k]["value"]
            checks[k]["value"] = v + c[k] if how == "sum" else max(v, c[k])
    return checks, failed


def execute(cell: str, chips: int, config: dict, traffic: dict,
            entries: List[dict], seed: int, seconds: float, trace: int,
            t0: float, device: str = "cuda", root: str = ROOT,
            program: Optional[Callable] = None) -> dict:
    """One run of a cell; returns the result line as a dict (``checks``
    last).  Raises where the run cannot report: no card, a job that fails,
    a trace that keeps losing records.  ``program(inputs, jobs)``, where
    given, stands in the program's place (the control), made once the pool
    sets are written, with ``jobs`` their (argv, output directory)."""
    mode = load_mode(traffic)
    data = dict(config["data"], **traffic.get("data", {}))
    pool_n = traffic["pool"]
    work_dir = os.path.join(tempfile.gettempdir(), "gpubench",
                            f"{cell}.{seed}")
    shutil.rmtree(work_dir, ignore_errors=True)
    slots = [os.path.join(work_dir, f"slot{k}") for k in range(pool_n)]
    for d in slots:
        os.makedirs(os.path.join(d, "in"))
        os.makedirs(os.path.join(d, "out"))
    outs_dir = [os.path.join(d, "out") for d in slots]
    try:
        with _spawn_pool(pool_n) as gen:
            made = [gen.submit(mode.make_inputs, os.path.join(d, "in"), data,
                               seed, k) for k, d in enumerate(slots)]
            import torch
            if device == "cuda" and (not torch.cuda.is_available()
                                     or torch.cuda.device_count() < chips):
                raise SystemExit(
                    f"this cell needs {chips} CUDA card(s); torch sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            prog = Program(device) if program is None else None
            t_import = time.perf_counter() - t0
            inputs, works = zip(*[f.result() for f in made])
        t_inputs = time.perf_counter() - t0
        argvs = [mode.argv(config, inp, out, device)
                 for inp, out in zip(inputs, outs_dir)]
        if prog is None:
            prog = program(list(inputs), list(zip(argvs, outs_dir)))
        t_warm = time.perf_counter()
        prog.job(argvs[0])                      # warm-up: builds and loads
        if prog.cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0
        log(f"set-up {setup_s:.3f} s: imports {t_import:.3f}, inputs "
            f"{t_inputs:.3f}, warm-up job {time.perf_counter() - t_warm:.3f}"
            f"; {pool_n} sets, work {list(works)}")

        jobs, outs = [], []
        host0 = hoststate.snapshot()
        start = time.perf_counter()
        while True:
            k = len(jobs) % pool_n
            rec = prog.job(argvs[k])
            rec.update(slot=k, work=works[k])
            jobs.append(rec)
            outs.append((k, mode.output(outs_dir[k])))
            span = time.perf_counter() - start
            if span >= seconds and len(jobs) >= pool_n:
                break
        host1 = hoststate.snapshot()
        traced = []
        # traced jobs after the window: for the per-layer metrics, and for
        # an end-to-end metric that the device's trace gives
        if trace or any(m.get("source") == "device_trace" for m in entries):
            for k in range(pool_n):
                traced.append(prog.traced_job(argvs[k], mode))
                outs.append((k, mode.output(outs_dir[k])))
        log(f"window {span:.3f} s, {len(jobs)} jobs, walls: "
            + " ".join(f"{j['wall_s']:.3f}" for j in jobs))
        log("host: " + hoststate.describe(host0, host1, jobs))
        peak = torch.cuda.max_memory_allocated() if prog.cuda else 0
        kind = torch.cuda.get_device_name(0) if prog.cuda else "cpu"
        if prog.cuda:
            log(f"card: {kind}; " + hoststate.card(torch))
        del prog
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        want = reference_outputs(mode, list(inputs), config, "")
        log(f"reference {time.perf_counter() - t_ref:.3f} s")
        checks, failed = judge(mode, [(got, want[k]) for k, got in outs])
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    run = dict(mode=traffic["mode"], setup_s=setup_s, span_s=span,
               work=sum(j["work"] for j in jobs), jobs=jobs, traced=traced)
    metrics = {}
    for m in entries:
        v = reader(m["name"], root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
           "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": len(outs), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = sum(tr.covered((a, b) for _n, a, b in r["device"])
                            for r in traced)
        dev["window_s"] = sum(r["window"][1] - r["window"][0] for r in traced)
        out["breakdown"] = breakdown(traced)
    out["checks"] = checks
    return out


def reference_outputs(mode, inputs: List[dict], config: dict, control: str
                      ) -> List[Dict[str, bytes]]:
    """The reference's output on each pool set, one process a set."""
    with host_pool(len(inputs)) as ex:
        futs = [ex.submit(mode.reference, inp, config, control)
                for inp in inputs]
        return [f.result() for f in futs]


@contextlib.contextmanager
def host_pool(workers: int):
    """A pool of ``workers`` spawned processes that share the host's cores
    (their BLAS threads set to a share each)."""
    threads = str(max(1, (os.cpu_count() or 1) // workers))
    keys = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: threads for k in keys})
    try:
        with _spawn_pool(workers) as ex:
            yield ex
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(t0: float) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # the program's build and kernel caches: fixed places in the checkout
    cache = os.path.join(ROOT, "build", "gpubench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    try:
        cell, config, traffic, entries = load_cell(ROOT, args.workload,
                                                   args.trace)
    except KeyError as e:
        print(f"no {e} in BENCHMARK.json", file=sys.stderr)
        return 2
    out = execute(cell["name"], cell["chips"], config, traffic, entries,
                  args.seed, args.seconds, args.trace, t0)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the reporting process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
