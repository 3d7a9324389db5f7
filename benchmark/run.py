"""One run of one cell of the benchmark of ``powerpaint_tpu_torch``.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run finds the cell in ``BENCHMARK.json``,
its configuration in ``benchmark/configs/<config>.json``, its traffic mix in
``benchmark/traffic/<traffic>.json``, its metrics' readers in
``benchmark/metrics/<metric>.py`` and its correctness limits in
``benchmark/limits/<workload>.json``. Then:

1. set-up: build the served system's CUDA libraries, make the weights from
   the seed on the card, build the pipeline and its ``MicroBatcher`` at the
   mix's server settings (``traffic.SERVER_DEFAULTS``: the server's), and
   serve one batch of each size up to the batcher's largest for each of the
   mix's tasks (every shape the window will use);
2. the window (``Window``): the mix's load, closed-loop clients or an
   open-loop sender, sends requests made from the seed to the batcher for
   ``--seconds``, between two batches' returns, and the benchmark's host
   spans (client, collect, dispatch, fetch) are kept; the end-to-end
   metrics and the host's per-layer metrics read this window;
3. with ``--trace 1``, once that load has drained, a second window of the
   same load, ``TRACE_SECONDS`` long, that the profiler records: the device
   metrics and the breakdown read it;
4. after the windows: the card's peak memory is read, the served system is
   freed, and a sample of the first window's requests, drawn from the seed,
   is served again by the plain float32 reference (``reference/``) and
   compared with what the window returned (``check.py``);
5. one JSON line on standard output, the numbers compared beside their
   limits as the last lines of standard error and under ``check``, the
   line's last key.

Every cache a run writes lies inside the checkout: the served system builds
its libraries into ``powerpaint_tpu_torch/_build/``, and PyTorch's and
Triton's caches are pointed at ``.bench_cache/``.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
_CACHE = CHECKOUT / ".bench_cache"
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[_var] = str(_CACHE / _sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from collections import Counter  # noqa: E402
from typing import Dict, List, NamedTuple, Optional  # noqa: E402

import numpy as np  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "powerpaint_tpu")
KERNELS = ("flash_attention", "conv3x3", "group_norm", "layer_norm")


def process_age_s() -> float:
    """Seconds since this process started, from /proc."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def forbidden_modules(modules=None) -> List[str]:
    """The top-level names of ``modules`` (the loaded modules by default)
    that are one of ``FORBIDDEN``, compared whole."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_spec(root: Path = CHECKOUT):
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(relative: str) -> dict:
    """A JSON file of the checkout, by its path from the checkout's root."""
    return json.loads((CHECKOUT / relative).read_text())


def power_limit() -> Optional[str]:
    """nvidia-smi's "name, power.limit" of the card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


class Spans:
    """Host spans by name, on the ``perf_counter`` clock, thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self.by_name: Dict[str, list] = {}

    def add(self, name: str, start: float, end: float) -> None:
        with self._lock:
            self.by_name.setdefault(name, []).append((start, end))


class Request(NamedTuple):
    client: int
    index: int
    sent: float  # the submit call (closed loop) or the due time (open loop)
    done: float  # the image in the client's hands
    ok: bool
    canvas: tuple
    steps: int


class Batch(NamedTuple):
    size: int
    done: float  # the batch's images fetched to the host
    canvas: tuple
    steps: int


class Window:
    """One measured window of the loop: its requests and batches, the
    batcher's count of the batches it dispatched in it, the benchmark's
    host spans and, when traced, the device's intervals.

    It opens when the last image of the loop's ``FILL_BATCHES``-th batch is
    in its client's hands, and closes when the last image of the first batch
    that comes back ``seconds`` or more after the opening is: both ends lie
    between two batches, so the images in it are whole batches and its
    length the time they took."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.t0 = self.t1 = None
        self.requests: List[Request] = []
        self.batches: List[Batch] = []
        self.sizes = Counter()  # batches dispatched in the window, by size
        self.spans = Spans()
        self.events = None  # device trace: (name, start, end) on the host clock

    @property
    def length(self) -> float:
        return self.t1 - self.t0

    def timings(self):
        """(sent, done, ok) of every request, for ``stats``."""
        return [(r.sent, r.done, r.ok) for r in self.requests]

    def completed(self) -> List[Request]:
        return [r for r in self.requests if r.ok and self.t0 < r.done <= self.t1]

    def batches_in(self) -> List[Batch]:
        return [b for b in self.batches if self.t0 < b.done <= self.t1]


class Run:
    """Everything a metric's reader may read of one run: ``main``, the
    window of the end-to-end metrics and the check, and with ``--trace 1``
    ``traced``, a second window that the profiler records."""

    def __init__(self, config_file: dict, seconds: float, seed: int):
        self.config_name = config_file["name"]
        self.config = config_file["config"]
        self.seed = int(seed)
        self.main = Window(seconds)
        self.traced: Optional[Window] = None
        self.current: Optional[Window] = None  # the window being measured
        self.outputs: Dict[tuple, np.ndarray] = {}  # the main window's images
        self.setup_s = None


def _first(value):
    return value[0] if isinstance(value, list) else value


class _Fetch:
    """The batcher's pending result, timed: the fetch span and the batch's
    completion, in the window it was dispatched in."""

    def __init__(self, pending, batch: Batch, window: Optional[Window]):
        self._pending, self._batch, self._window = pending, batch, window

    def result(self):
        t0 = time.perf_counter()
        out = self._pending.result()
        t1 = time.perf_counter()
        if self._window is not None:
            self._window.spans.add("fetch", t0, t1)
            self._window.batches.append(self._batch._replace(done=t1))
        return out


def instrument(pipe, batcher, run: Run) -> None:
    """Wrap the pipeline instance's ``submit`` (the dispatch span; its
    result becomes a timed fetch) and the batcher's collect, as the
    repository's ``chip_smoke.instrument`` wraps methods: the program is not
    edited."""
    submit = pipe.submit

    def timed_submit(image, mask, **kw):
        window = run.current
        t0 = time.perf_counter()
        pending = submit(image, mask, **kw)
        if window is not None:
            window.spans.add("dispatch", t0, time.perf_counter())
        batch = Batch(len(image) if isinstance(image, list) else 1, 0.0,
                      tuple(_first(image).shape[:2]), int(kw["num_inference_steps"]))
        return _Fetch(pending, batch, window)

    pipe.submit = timed_submit
    collect = batcher._collect

    def timed_collect(first):
        window = run.current
        t0 = time.perf_counter()
        out = collect(first)
        if window is not None:
            window.spans.add("collect", t0, time.perf_counter())
        return out

    batcher._collect = timed_collect


def _serve_concurrently(batcher, reqs: list) -> None:
    threads = [threading.Thread(target=batcher.submit, args=(r["image"], r["mask"]),
                                kwargs=r["kwargs"]) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def warm_up(batcher, traffic) -> None:
    """For each task entry of the mix, one batch of each size
    1..max_batch through the batcher, so every shape the window uses has
    run once. Concurrent requests coalesce into one batch; a size the
    batcher split is served again, up to three times."""
    for e in range(len(traffic.entries)):
        for b in range(1, batcher.max_batch + 1):
            for attempt in range(3):
                before = batcher.sizes[b]
                _serve_concurrently(batcher, traffic.warmup(
                    e, b, offset=(1 << 20) + (e << 12) + 8 * b + attempt))
                if batcher.sizes[b] > before:
                    break


FILL_BATCHES = 2
TRACE_SECONDS = 20.0
LOOP_LIMIT_S = 600.0


def _serve_one(batcher, traffic, run: Run, win: Window, c: int, i: int,
               due: Optional[float], keep: bool) -> None:
    g0 = time.perf_counter()
    req = traffic.request(c, i)
    now = time.perf_counter()
    win.spans.add("client", g0, now)
    sent = now if due is None else due
    expect = req["image"].shape
    ok, out = True, None
    try:
        out = batcher.submit(req["image"], req["mask"], **req["kwargs"])
        ok = isinstance(out, np.ndarray) and out.dtype == np.uint8 and out.shape == expect
    except Exception as e:  # a failed request counts as failed
        print(f"request {c}/{i} failed: {e!r}", file=sys.stderr)
        ok = False
    done = time.perf_counter()
    win.requests.append(Request(c, i, sent, done, ok, tuple(expect[:2]),
                                int(req["kwargs"]["num_inference_steps"])))
    if ok and keep:
        run.outputs[(c, i)] = out


def start_load(batcher, traffic, run: Run, win: Window, stop: threading.Event,
               base: int, keep: bool) -> List[threading.Thread]:
    """The mix's load, until ``stop``: ``traffic.clients`` closed-loop
    clients (numbered from ``base``), or one open-loop sender that sends
    request ``i`` of client ``base`` at its arrival time, each on a thread
    of its own, and waits for them all before it ends."""
    serve = lambda c, i, due: _serve_one(batcher, traffic, run, win, c, i, due, keep)  # noqa: E731

    def client(c: int):
        i = 0
        while not stop.is_set():
            serve(c, i, None)
            i += 1

    def sender():
        start, workers = time.perf_counter(), []
        for i, at in enumerate(traffic.arrivals()):
            delay = start + at - time.perf_counter()
            if delay > 0 and stop.wait(delay):
                break
            if stop.is_set():
                break
            w = threading.Thread(target=serve, args=(base, i, start + at), daemon=True)
            w.start()
            workers.append(w)
        for w in workers:
            w.join(timeout=LOOP_LIMIT_S)

    if traffic.loop == "closed":
        threads = [threading.Thread(target=client, args=(base + c,), daemon=True)
                   for c in range(traffic.clients)]
    else:
        threads = [threading.Thread(target=sender, daemon=True)]
    for t in threads:
        t.start()
    return threads


def _boundary(win: Window, k: int, threads, deadline: float) -> float:
    """The moment the last image of the loop's first ``k`` batches was in
    its client's hands (batches come back in order, one at a time)."""
    while len(win.batches) < k or len(win.requests) < sum(b.size for b in win.batches[:k]):
        if time.perf_counter() > deadline or not any(t.is_alive() for t in threads):
            raise RuntimeError(f"the loop returned no batch {k} within {LOOP_LIMIT_S:.0f} s")
        time.sleep(0.001)
    n = sum(b.size for b in win.batches[:k])
    return sorted(r.done for r in list(win.requests))[n - 1]


def measure(batcher, traffic, run: Run, win: Window, trace=None, base: int = 0,
            keep: bool = True) -> None:
    """One window (see ``Window``): the load starts (with ``trace``, after
    the profiler), fills ``FILL_BATCHES`` batches, is measured, then stops:
    nothing is sent after the window closes, and what is in flight finishes
    before this returns."""
    run.current = win
    stop = threading.Event()
    if trace is not None:
        trace.start()
    threads = start_load(batcher, traffic, run, win, stop, base, keep)
    deadline = time.perf_counter() + LOOP_LIMIT_S
    win.t0 = _boundary(win, FILL_BATCHES, threads, deadline)
    sizes0 = Counter(batcher.sizes)
    time.sleep(max(0.0, win.t0 + win.seconds - time.perf_counter()))
    while not any(b.done >= win.t0 + win.seconds for b in list(win.batches)):
        if time.perf_counter() > deadline or not any(t.is_alive() for t in threads):
            raise RuntimeError("the loop returned no batch after the window's length")
        time.sleep(0.001)
    last = next(k for k, b in enumerate(list(win.batches)) if b.done >= win.t0 + win.seconds)
    win.t1 = _boundary(win, last + 1, threads, deadline)
    win.sizes = Counter(batcher.sizes) - sizes0
    stop.set()
    if trace is not None:
        trace.stop()
    for t in threads:
        t.join(timeout=LOOP_LIMIT_S)
        if t.is_alive():
            raise RuntimeError("the load did not finish within "
                               f"{LOOP_LIMIT_S:.0f} s of the window's end")
    run.current = None


def _metric_reader(name: str):
    return importlib.import_module(f"benchmark.metrics.{name}").read


def metrics_of(spec: dict, workload: str, trace: bool, run: Run) -> dict:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones,
    each read by ``metrics/<name>.py``; a reader that finds nothing to read
    returns None and the metric is left out."""
    out = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = _metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(spec: dict, workload_name: str, seed: int, seconds: float,
             trace: bool, device, setup_start: Optional[float] = None) -> dict:
    """One run of a cell; returns the result line's object. ``setup_start``:
    the process's start on the ``perf_counter`` clock."""
    import torch

    from benchmark import check
    from benchmark.traffic import Traffic
    from benchmark.weights import make_state
    from powerpaint_tpu_torch.serve.batcher import MicroBatcher
    from powerpaint_tpu_torch.text.tokenizer import (
        HashTokenizer,
        TokenizerWrapper,
        add_task_tokens,
    )

    t_setup = time.perf_counter() - process_age_s() if setup_start is None else setup_start
    setup_stages = []

    def stage(name):
        setup_stages.append(f"{name} at {time.perf_counter() - t_setup:.2f}")

    wl = next(w for w in spec["workloads"] if w["name"] == workload_name)
    config_file = _json(next(c for c in spec["configs"] if c["name"] == wl["config"])["file"])
    traffic_spec = _json(f"benchmark/traffic/{wl['traffic']}.json")
    limits = _json(f"benchmark/limits/{workload_name}.json")
    device = torch.device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    run = Run(config_file, seconds, seed)
    traffic = Traffic(traffic_spec, seed, config_file["default_scheduler"])
    server = traffic.server

    if device.type == "cuda":
        from powerpaint_tpu_torch.ops import _build

        _build.build(KERNELS)
    stage("kernels built")
    state = make_state(run.config, seed, device, dtype)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    stage("weights made")
    module, cls = config_file["pipeline"].rsplit(".", 1)
    from powerpaint_tpu_torch.core.config import PowerPaintConfig

    pcfg = PowerPaintConfig.from_dict(run.config)
    tok = TokenizerWrapper(HashTokenizer(pcfg.text_encoder.vocab_size))
    add_task_tokens(tok)
    pipe = getattr(importlib.import_module(module), cls)(
        pcfg, state, tok, dtype=dtype, device=device, int8=bool(server["int8"]))
    batcher = MicroBatcher(pipe, max_batch=int(server["max_batch"]),
                           window_ms=float(server["window_ms"]),
                           pipeline_depth=int(server["pipeline_depth"]))
    instrument(pipe, batcher, run)
    stage("pipeline built")
    warm_up(batcher, traffic)
    stage("batch sizes warmed")
    if device.type == "cuda":
        torch.cuda.synchronize()
    measure(batcher, traffic, run, run.main)
    run.setup_s = run.main.t0 - t_setup
    print(f"set-up {run.setup_s:.2f} s: {setup_stages}, window opened; "
          f"window {run.main.length:.3f} s", file=sys.stderr)
    if trace:
        from benchmark.trace import DeviceTrace

        run.traced = Window(min(run.main.seconds, TRACE_SECONDS))
        tracer = DeviceTrace()
        measure(batcher, traffic, run, run.traced, tracer, base=1 << 16, keep=False)
        run.traced.events = tracer.events()
        del tracer
    batcher.close()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del pipe, batcher
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    result_metrics = metrics_of(spec, workload_name, trace, run)
    traced = {}
    if run.traced is not None:
        from benchmark.trace import breakdown, busy_s

        w = run.traced
        traced = {"busy_s": busy_s(w.events, w.t0, w.t1), "window_s": w.length,
                  "breakdown": breakdown(w.events, w.spans.by_name, w.t0, w.t1)}
        w.events = None

    numbers = check.compare(run, traffic, state, device, limits)
    del state
    attempted = len(run.main.requests)
    failed = sum(1 for r in run.main.requests if not r.ok)
    if run.traced is not None:
        attempted += len(run.traced.requests)
        failed += sum(1 for r in run.traced.requests if not r.ok)
    correct = failed == 0 and all(v["value"] <= v["limit"] for v in numbers.values())
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": int(peak),
               "power_limit": power_limit()}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if traced:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": result_metrics, "device": dev}
    if traced:
        out["breakdown"] = traced["breakdown"]
    out["check"] = numbers
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    setup_start = time.perf_counter() - process_age_s()
    try:
        spec = load_spec()
        wl = next(w for w in spec["workloads"] if w["name"] == args.workload)
        import torch

        import powerpaint_tpu_torch  # noqa: F401  (the system under test)
    except (OSError, StopIteration, ImportError) as e:
        print(f"cannot run {args.workload!r}: {e!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", setup_start=setup_start)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: nothing it runs may import "
              "JAX or the JAX package", file=sys.stderr)
        return 4
    print(f"run took {process_age_s():.1f} s", file=sys.stderr)
    for name, v in out["check"].items():
        print(f"check {name} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
