"""The checks and readings that ``chip_smoke.py``, ``verify_cuda.py``,
``soak_cuda.py`` and ``soak_bank10k_cuda.py`` share: a failed check
(``check`` raises ``CheckFailed``), the card's ``nvidia-smi`` line, the
device operations of a traced call, and a scan's detections held
against another's (bitwise, or in the bf16 / int8 score classes with the
binary-map cells that flipped exempt).  Imports nothing of JAX."""

from __future__ import annotations

import subprocess

import numpy as np

# the phones the soak's and the smoke test's banks are trained on
TRAIN_PHONES = ("aa", "iy")


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_events(torch, fn):
    """The device events (kernels, copies, memsets) of one traced call of
    ``fn`` (``torch.profiler``), in order of start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def device_op_names(torch, fn):
    """The names of the device operations one call of ``fn`` enqueues, in
    order; None if the trace holds no device event."""
    return [e.name for e in device_events(torch, fn)] or None


def map_flips(torch, fp, stream_scan, corpus, fcfg, batch, dev, local_rows=None):
    """The binary-map cells a scan's kernels set otherwise than its plain
    run, batched as the scan batches the corpus (``local_rows`` as
    ``stream_scan`` takes it: tail batches keep their shape) -> ({utterance:
    sorted frames holding such a cell}, cells that differ, cells).  A cell whose
    edge response ties its quantile threshold within float tolerance may
    flip between two fp32 evaluations of the planes (the frontend's
    parity contract: at most 1e-3 of the cells)."""
    n_cells = [0, 0]

    def compute(wavs, vs, _marks):
        mk = fp.frontend_batch_flat(wavs, vs, fcfg).binary
        mp = fp.frontend_batch_flat(wavs, vs, fcfg, plain=True).binary
        per_frame = (mk != mp).reshape(mk.shape[0], mk.shape[1], -1).sum(-1).float()
        n_cells[0] += int(per_frame.sum())
        n_cells[1] += mk.numel()
        t = torch.arange(per_frame.shape[1], device=dev).expand_as(per_frame)
        return torch.where(per_frame > 0, per_frame, float("-inf")), t, torch.zeros_like(t)

    d = stream_scan(corpus, fcfg, batch, compute, 1, dev, local_rows=local_rows).detections
    frames = {int(u): np.sort(d.times[d.utterance_ids == u]) for u in np.unique(d.utterance_ids)}
    return frames, n_cells[0], n_cells[1]


# the most of a scan's same-template matches that a flipped map cell may
# exempt from its score class (``match_detections``)
MAX_EXEMPT = 0.1


def match_detections(got, want, flips=None, window=0):
    """Peaks of two scans matched on (utterance, time) -> (matched share
    of the larger set, same-template share of the matched, max |score
    difference| over same-template matches, max |score| of ``want``,
    exempt share of the same-template matches).  With ``flips``
    (``map_flips``' frames), a match whose score window [t, t + window)
    holds a frame where the two maps differ is exempt from the score
    difference: a flipped cell moves such a score by a whole LLR term."""
    matched = same = exempt = 0
    diff = 0.0
    for ui in np.unique(np.concatenate([got.utterance_ids, want.utterance_ids])):
        a = {t: (k, s) for s, t, k in zip(got.scores[got.utterance_ids == ui].tolist(),
                                          got.times[got.utterance_ids == ui].tolist(),
                                          got.template_ids[got.utterance_ids == ui].tolist())}
        b = {t: (k, s) for s, t, k in zip(want.scores[want.utterance_ids == ui].tolist(),
                                          want.times[want.utterance_ids == ui].tolist(),
                                          want.template_ids[want.utterance_ids == ui].tolist())}
        fl = (flips or {}).get(int(ui), np.zeros(0, np.int64))
        for t in set(a) & set(b):
            matched += 1
            if a[t][0] == b[t][0]:
                same += 1
                i = np.searchsorted(fl, t)
                if i < len(fl) and fl[i] < t + window:
                    exempt += 1
                else:
                    diff = max(diff, abs(a[t][1] - b[t][1]))
    frac = matched / max(len(got.scores), len(want.scores), 1)
    return (frac, same / max(matched, 1), diff, float(np.max(np.abs(want.scores))),
            exempt / max(same, 1))


def check_scan_scores(dk, dp, flips, window, tol, label, say):
    """A scan's detections against its plain run's: >= 99% matched peaks
    with the same template, and the scores of the same-template matches
    within ``tol`` x max|score|, but those whose window holds a flipped
    map cell, which may be at most ``MAX_EXEMPT`` of them."""
    check(len(dk.scores) > 0 and bool(np.isfinite(dk.scores).all()), f"{label}: no detections")
    frac, id_frac, diff, top, ex = match_detections(dk, dp, flips, window)
    say(f"{label} vs plain scan: {len(dk.scores)} vs {len(dp.scores)} detections, "
        f"{frac:.4f} matched peaks, {id_frac:.4f} same template on matched; score max diff "
        f"{diff:.6g} = {diff / top:.3g} of max|score| {top:.6g} (tolerance {tol:g}) on the "
        f"matches whose {window}-frame window holds no flipped map cell; {ex:.4f} of them "
        f"exempt (limit {MAX_EXEMPT})")
    check(frac >= 0.99, f"{label}: matched peaks {frac} < 0.99")
    check(id_frac >= 0.99, f"{label}: template ids agree on {id_frac} < 0.99")
    check(ex <= MAX_EXEMPT, f"{label}: {ex} of the matches exempt > {MAX_EXEMPT}")
    check(diff <= tol * top, f"{label}: scores differ by {diff} > {tol:g} * {top}")


def same_detections(a, b) -> bool:
    """Two detection sets bitwise equal."""
    return all(np.array_equal(getattr(a, n), getattr(b, n))
               for n in ("scores", "times", "template_ids", "utterance_ids"))
