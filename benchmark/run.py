"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (timed as ``setup_s``): import
the port, build its kernels or load them from its build directory in
the checkout, make the bank on the card and the traffic's pool of
waveforms from the seed, and warm up with one short scan over every
bucket the mix fills.  The window: one call of
``scan.detect_corpus_stream`` over a corpus that feeds the pool in the
seed's order until ``--seconds`` have passed since the call began; the
call drains its tail batches and returns with every detection on the
host.  With ``--trace 1`` a few seconds of the window are profiled and
the per-layer metrics are reported instead of the end-to-end ones.
Once the window has closed and the peak memory has been read, the
reference judges every utterance that the window scanned
(``reference.check``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(``breakdown`` with ``--trace 1``), and last ``check``: each number
compared beside its limit, which also end standard error.

``--control``: the run with the control that the cell's configuration
names (its ``control``: a ``pipeline`` override, the program's own path
at a lower precision, or ``reference_bits``, the reference in the
program's place at that precision); its ``correct`` has to come out
false.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BANNED = ("jax", "jaxlib", "flax", "template_speech_recognition_tpu")
CACHE = ROOT / ".bench_cache"


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    return p.parse_args(argv)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys set, nested groups merged."""
    out = dict(base)
    for key, val in over.items():
        out[key] = merged(out[key], val) if isinstance(val, dict) else val
    return out


def pipeline_config(cell, control: bool):
    from template_speech_recognition_tpu_torch import config as C

    pipe = merged(cell.config["pipeline"], {"detect": {"batch_size": cell.mix["batch_size"]}})
    if control:
        pipe = merged(pipe, cell.config["control"].get("pipeline", {}))
    return C.pipeline_from_dict(pipe)


class Held:
    """A corpus of waveforms held in memory, fed once each."""

    def __init__(self, waves, sample_rate):
        self.waves, self.sample_rate = waves, sample_rate

    def iter_utterances(self):
        for i, w in enumerate(self.waves):
            yield f"warm{i}", w, []


def warm_corpus(pool, batch_size, sample_rate):
    """Every bucket of the pool as one full batch and a tail of one row."""
    from benchmark.harness.buckets import bucket_length

    by_bucket = {}
    for w in pool:
        by_bucket.setdefault(bucket_length(len(w)), []).append(w)
    waves = []
    for _pad, ws in sorted(by_bucket.items()):
        waves += [ws[i % len(ws)] for i in range(batch_size + 1)]
    return Held(waves, sample_rate)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             control: bool = False, root: Path = ROOT, t_process: float = T_PROCESS,
             log=None) -> dict:
    """One run of a cell on ``device``; returns the result's fields."""
    import numpy as np
    import torch

    from benchmark.harness import spec, trace as tr, traffic
    from benchmark.harness.bank import make_templates
    from benchmark.reference.check import judge_window
    from template_speech_recognition_tpu_torch.models.bank import TemplateBank
    from template_speech_recognition_tpu_torch.scan import detect_corpus_stream
    from template_speech_recognition_tpu_torch.utils.compile_cache import enable_compile_cache

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = spec.find_cell(root, workload)
    mix, cfg_json = cell.mix, cell.config
    cuda = device.type == "cuda"
    marks = [("imports", time.perf_counter())]
    if cuda:
        enable_compile_cache()
    marks.append(("kernels", time.perf_counter()))
    cfg = pipeline_config(cell, control)
    fcfg = cfg_json["pipeline"]["frontend"]
    templates, background = make_templates(cfg_json["bank"], fcfg, seed, device)
    bank = TemplateBank(templates, background,
                        [f"t{i}" for i in range(templates.shape[0])])
    marks.append(("bank", time.perf_counter()))
    pool = traffic.make_pool(mix, seed)
    marks.append(("pool", time.perf_counter()))
    sr, bs = mix["sample_rate"], mix["batch_size"]
    detect_corpus_stream(warm_corpus(pool, bs, sr), bank, cfg)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    prev = t_process
    parts = []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.3f} s")
        prev = t
    log("set-up: " + ", ".join(parts))
    hooks = []
    stretch = None
    if trace:
        group = max(int(os.environ.get("SCAN_FETCH_GROUP", "8")), 1)
        stretch = tr.Stretch(mix["trace"]["start_s"], mix["trace"]["stretch_s"], group)
        hooks.append(stretch)
    corpus = traffic.WindowCorpus(pool, sr, bs, seed, seconds=seconds, hooks=hooks)
    # what set-up made stays: the collector no longer walks it in the window
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    corpus.t0 = t0
    res = detect_corpus_stream(corpus, bank, cfg)
    wall = time.perf_counter() - t0
    gc.unfreeze()
    batches = corpus.mirror.close()
    gaps = np.diff(np.asarray([t0] + corpus.fed_at)) * 1e3
    log(f"host: the scan asked for its next utterance after a median {np.median(gaps):.3f} ms, "
        f"p99 {np.percentile(gaps, 99):.3f}, max {gaps.max():.3f} (the first "
        f"{gaps[0]:.3f}: the bank build); {float(gaps[1:][gaps[1:] > 20].sum()):.1f} ms "
        f"in waits over 20 ms; tail and drain {(time.perf_counter() - corpus.fed_at[-1]) * 1e3:.1f} ms")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"window: {len(corpus.fed)} utterances, {corpus.audio_seconds:.1f} audio-s "
        f"(the scan counted {res.audio_seconds:.1f}), {len(batches)} batches "
        f"(the scan counted {res.counters.get('batches', 0):.0f}) in {wall:.3f} s; "
        f"set-up {setup_s:.3f} s; peak {peak / 1e9:.3f} GB")
    metrics, breakdown, dev_extra = {}, None, {}
    if not trace:
        values = {"scan_audio_s_per_s": corpus.audio_seconds / wall, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        st = stretch.read(batches) if stretch is not None else None
        ctx = types.SimpleNamespace(cell=cell, counters=res.counters, batches=batches,
                                    stretch=st)
        for m in cell.per_layer:
            value = spec.metric_reader(root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if st is not None:
            from benchmark.harness.trace import busy_union, gap_labels, idle_gaps

            ivals = [(s, e) for _n, s, e in st["device_events"]]
            dev_extra = {"busy_s": busy_union(ivals) / 1e6, "window_s": st["window_s"]}
            by_name = {}
            for name, s, e in st["device_events"]:
                by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
            breakdown = {
                "device_ops": sorted(([n[:120], v] for n, v in by_name.items()),
                                     key=lambda kv: -kv[1])[:10],
                "idle_gaps": [[n[:120], v] for n, v in
                              gap_labels(idle_gaps(ivals), st["host_events"])],
            }
            log(f"traced stretch: {len(st['batches'])} batches, {st['window_s']:.3f} s, "
                f"{len(st['device_events'])} device ops, busy {dev_extra['busy_s']:.3f} s")
        del st, ctx
    for m in metrics:
        log(f"metric {m} {metrics[m]['value']!r} {metrics[m]['unit']}")
    # the program's state goes before the reference runs
    dets, fed = res.detections, list(corpus.fed)
    del res, bank, corpus, stretch
    if cuda:
        torch.cuda.empty_cache()
    verdict = judge_window(pool=pool, fed=fed, dets=dets, templates=templates,
                           background=background, config=cfg_json, mix=mix,
                           limits=cell.limits,
                           reference_bits=(cell.config["control"].get("reference_bits")
                                           if control else None))
    log(f"check: {verdict['judged']} scans of {verdict['distinct']} utterances judged in "
        f"{verdict['seconds']:.2f} s, scale {verdict['scale']:.6g}, "
        f"{verdict['ambiguous_cells']} ambiguous cells; read "
        + json.dumps({k: float(f"{v:.4g}") for k, v in verdict["read"].items()}))
    numbers = verdict["numbers"]
    correct = verdict["failed"] == 0 and all(v["value"] <= v["limit"] for v in numbers.values())
    return {
        "correct": bool(correct),
        "attempted": len(fed),
        "failed": int(verdict["failed"]),
        "metrics": metrics,
        "device": dev_extra,
        "breakdown": breakdown,
        "memory_peak_bytes": int(peak),
        "check": numbers,
    }


def result_line(out: dict, kind: str, chips: int, card: str, trace: bool,
                control: str | None = None) -> dict:
    """The last line's object, ``check`` last."""
    line = {
        "correct": out["correct"],
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": out["metrics"],
        "device": {"platform": "gpu", "kind": kind, "count": chips,
                   "memory_peak_bytes": out["memory_peak_bytes"], **out["device"],
                   "card": card},
    }
    if trace and out["breakdown"] is not None:
        line["breakdown"] = out["breakdown"]
    if control:
        line["control"] = control
    line["check"] = out["check"]
    return line


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    import torch

    from benchmark.harness import spec

    cell = spec.find_cell(ROOT, args.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), dev,
                   control=args.control)
    found = banned_modules()
    if found:
        print(f"benchmark: JAX or the JAX package is loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    control = cell.config["control"]["name"] if args.control else None
    line = result_line(out, torch.cuda.get_device_name(dev), chips, card_line(),
                       bool(args.trace), control)
    print(json.dumps(line), flush=True)
    for name, v in out["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
