"""Streaming batched corpus scan -- the production detect path.

Counterpart of ``template_speech_recognition_tpu.scan``
(``detect_corpus_stream`` -> ``stream_scan`` -> ``scan_step``):

* utterances group into sample-length buckets (``bucket_length``);
* each full bucket batch runs one ``scan_step`` on the device:
  ``frontend_batch_flat -> fft_sliding_scores (or, with
  score_backend="conv", the f32 sliding_scores_batch) -> masked_scores
  -> batched NMS/top-K [-> batched DTW rescore]`` with no host sync
  inside; ``int8_spectra`` runs the scorer on int8 template spectra;
* tail batches shrink to the next power of two that holds their rows;
* each batch's waveforms go up from pinned host memory; its fixed-size
  (s, t, k) triple stays on the device until ``SCAN_FETCH_GROUP``
  (default 8, as the reference) consecutive batches have run, whose
  triples are then packed into one array and come back through ONE
  ``non_blocking`` copy into pinned host memory (a fetch);
* at most ``SCAN_PIPELINE_DEPTH`` (default 3, as the reference) fetches
  stay in flight: the oldest is read when one more starts.  With
  ``SCAN_FETCH_GROUP=1`` a fetch is one batch, the reference's
  per-batch pipeline.  The packing is lossless (times and template ids
  are exact in float32), so the knobs change no detection.  Unlike the
  reference's grouped mode, a grouped batch is copied to the host once
  (in its group's fetch, not also on its own), and the depth still
  bounds the work in flight: at most depth x group + group - 1 batches;
* ``manifest`` (a ``checkpoint.ScanManifest``): batches are shards,
  numbered in dispatch order (full buckets as they fill, then the tails
  in bucket order, as the reference numbers them); each computed shard
  is recorded when its fetch is drained, a completed shard is reloaded
  from disk (checked by its utterances and their lengths) and never
  recomputed, and on a failure the batches already run are fetched and
  recorded before the error goes on, so a scan killed part way resumes
  where it stopped.  A manifest written by either package resumes in
  the other;
* ``SCAN_UPLOAD_INT16=1`` (PCM16 upload): waveforms go up as int16
  (``round(w * 32768)``, clipped) and become ``float32 / 32768`` on the
  device, half the bytes of the float upload; exact for PCM16 sources.

As in the reference, the Pallas scorer and exact scores are not
options of the stream (``pipeline.detect_corpus`` routes them to its
per-utterance loop) and raise ``ValueError``.  Per-process feeding
(``local_rows``) is not ported yet and raises ``NotImplementedError``
naming its ROADMAP item.  ``SCAN_DEBUG`` (the reference's dispatch and
drain prints on stderr) is ignored; no other option is.
"""

from __future__ import annotations

import collections
import dataclasses
import os

import numpy as np
import torch

from template_speech_recognition_tpu_torch.align.dtw import (
    dtw_keyword_scores_batch,
    dtw_pairwise_scores,
    dtw_pairwise_scores_from_map,
)
from template_speech_recognition_tpu_torch.config import PipelineConfig
from template_speech_recognition_tpu_torch.detect import evaluate as ev
from template_speech_recognition_tpu_torch.detect.fft_scorer import (
    FFTBank,
    build_fft_bank,
    fft_sliding_scores,
)
from template_speech_recognition_tpu_torch.detect.nms import top_detections
from template_speech_recognition_tpu_torch.detect.scorer import (
    masked_scores,
    sliding_scores_batch,
)
from template_speech_recognition_tpu_torch.frontend import frontend_batch_flat
from template_speech_recognition_tpu_torch.models.bank import TemplateBank
from template_speech_recognition_tpu_torch.ops.layout import filters_to_flat
from template_speech_recognition_tpu_torch.utils.metrics import StageCounters

STAGES = ("frontend", "score", "nms", "dtw")


def bucket_length(n: int, quantum: int = 16384) -> int:
    """Round up to the bucket grid so a scan sees few distinct shapes."""
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


@dataclasses.dataclass
class CorpusDetections:
    detections: ev.DetectionSet
    labels_per_utterance: list[np.ndarray]   # frame-index starts
    audio_seconds: float
    utt_ids: list[str]
    counters: dict[str, float] = dataclasses.field(default_factory=dict)


def batched_top_detections(scores, valid_frames, template_length,
                           nms_radius, top_k, time_major):
    """[B, ...] scores + [B] valid -> per-utterance (s, t, k) top-K."""
    sc = masked_scores(scores, valid_frames, template_length,
                       time_major=time_major)
    return top_detections(sc, nms_radius, top_k, time_major=time_major)


@dataclasses.dataclass(frozen=True)
class DTWRescore:
    """What the config-4 rescore of the top-K peaks needs."""

    w_rows: torch.Tensor   # [K, L, D] flat per-row filters
    c_rows: torch.Tensor   # [K, L]
    m_seg: int             # window frames per peak (L + band)
    band: int
    top_r: int             # 1 verify-the-winner, 0 exhaustive


DTW_ROUTES = ("auto", "map", "gathered")


def dtw_rescore_batched(binary, valid_frames, scores, times, ids,
                        w_rows, c_rows, m_seg, band, top_r=0, plain=False,
                        route="auto"):
    """Batched config-4 rescore of the top-K peaks [B, P] -> (scores,
    ids) [B, P]; empty slots (score -inf) stay -inf with id 0.

    ``top_r == 1`` (verify-the-winner): each peak against the template
    that won it, by one of two routes (``route``):

    * ``route="map"``: straight from the feature map
      (``dtw_pairwise_scores_from_map``: the pair-LLR kernel on bf16
      filters, then the DTW kernel), the reference stream's bf16 class;
    * ``route="gathered"``: over gathered segments and f32 filters at
      full precision (``dtw_pairwise_scores``: an fp32 ``bmm``, then the
      DTW kernel), the reference's per-utterance loop;
    * ``route="auto"`` (the stream's): the map route on the card, the
      gathered one on the CPU, as the reference does off its accelerator.

    ``plain`` runs the kernels' plain versions.  ``top_r == 0``
    (exhaustive): every peak against every template
    (``dtw_keyword_scores_batch``), keeping the best; ``route`` is not
    read."""
    if route not in DTW_ROUTES:
        raise ValueError(f"route must be one of {DTW_ROUTES}, got {route!r}")
    if route == "auto":
        route = "map" if binary.device.type == "cuda" else "gathered"
    b, p = scores.shape
    tdim = binary.shape[1]
    t_idx = torch.clamp(times.to(torch.int64), 0, tdim - 1)
    keep = torch.isfinite(scores)
    if top_r == 1 and route == "map":
        pair1 = dtw_pairwise_scores_from_map(
            binary, t_idx, ids, w_rows, c_rows, valid_frames, m_seg, band,
            plain=plain,
        )
        return torch.where(keep, pair1, float("-inf")), torch.where(keep, ids, 0)
    dev = binary.device
    idx = torch.clamp(t_idx[:, :, None] + torch.arange(m_seg, device=dev), 0, tdim - 1)
    rows = (torch.arange(b, device=dev)[:, None, None] * tdim + idx).reshape(-1)
    feat_dims = tuple(binary.shape[2:])
    segs = binary.reshape((b * tdim,) + feat_dims)[rows].to(torch.float32)
    segs = segs.reshape((b * p, m_seg) + feat_dims)
    seg_lens = torch.clamp(valid_frames.to(torch.int64)[:, None] - t_idx, 1, m_seg)
    seg_lens = seg_lens.reshape(-1).to(torch.int32)
    if top_r == 1:
        safe = torch.clamp(ids.reshape(-1).to(torch.int64), 0, w_rows.shape[0] - 1)
        pair1 = dtw_pairwise_scores(
            segs, seg_lens, w_rows[safe], c_rows.to(torch.float32)[safe], band,
            plain=plain,
        ).reshape(b, p)
        return torch.where(keep, pair1, float("-inf")), torch.where(keep, ids, 0)
    pair = dtw_keyword_scores_batch(
        segs, seg_lens, w_rows, c_rows, band, plain=plain
    ).reshape(b, p, -1)                                  # [B, P, K]
    best = torch.amax(pair, dim=-1)
    bid = torch.argmax(pair, dim=-1).to(torch.int32)
    return torch.where(keep, best, float("-inf")), torch.where(keep, bid, 0)


def scan_step(
    wavs: torch.Tensor,            # [B, S] padded waveforms
    valid_samples: torch.Tensor,   # [B] int32
    scorer,                        # FFTBank, or (W [K, L, D], c [K]) for conv
    *,
    fcfg,
    template_length: int,
    nms_radius: int,
    top_k: int,
    dtw: DTWRescore | None = None,
    plain: bool = False,
    marks: list | None = None,
):
    """One scan step: waveforms -> fixed-size detections, no host sync.
    Padded batch rows (valid_samples == 0) come out as all -inf.
    An int16 batch (PCM16 upload) becomes ``float32 / 32768`` first.

    ``scorer``: an ``FFTBank`` runs the FFT scorer; a flat LLR filter
    ``(W, c)`` runs the f32 conv (``score_backend="conv"``).  ``dtw``:
    rescore the peaks (config 4).  ``plain=True`` runs every
    kernel's plain PyTorch version.  ``marks`` (CUDA only): a list that
    receives a recorded CUDA event after each stage, for device-time
    accounting."""
    def mark(name):
        if marks is not None:
            ev_ = torch.cuda.Event(enable_timing=True)
            ev_.record()
            marks.append((name, ev_))

    mark("start")
    if wavs.dtype == torch.int16:
        wavs = wavs.to(torch.float32) * (1.0 / 32768.0)
    fm = frontend_batch_flat(wavs, valid_samples, fcfg, plain=plain)
    mark("frontend")
    time_major = isinstance(scorer, FFTBank)
    if time_major:
        # time-major + trim=False: the iDFT kernel's native layout flows
        # straight into masking/NMS (no transpose, no tail slice)
        scores = fft_sliding_scores(fm.binary, scorer, time_major=True,
                                    trim=False, plain=plain)
    else:
        scores = sliding_scores_batch(fm.binary, *scorer)        # [B, K, T'']
    mark("score")
    s, t, k = batched_top_detections(scores, fm.valid_frames, template_length,
                                     nms_radius, top_k, time_major=time_major)
    mark("nms")
    if dtw is not None:
        s, k = dtw_rescore_batched(
            fm.binary, fm.valid_frames, s, t, k, dtw.w_rows, dtw.c_rows,
            dtw.m_seg, dtw.band, top_r=dtw.top_r, plain=plain,
        )
        mark("dtw")
    return s, t, k


def _check_options(cfg: PipelineConfig) -> None:
    dcfg = cfg.detect
    if dcfg.score_backend not in ("fft", "conv"):
        raise ValueError(f"streaming scan supports fft|conv, got {dcfg.score_backend!r}")
    if dcfg.exact_scores:
        raise ValueError(
            "exact_scores: the streaming scan has no int32 path; "
            "pipeline.detect_corpus runs it in its per-utterance loop"
        )


def detect_corpus_stream(
    corpus,
    bank: TemplateBank,
    cfg: PipelineConfig,
    target_phone: str | None = None,
    manifest=None,
    plain: bool = False,
) -> CorpusDetections:
    """Streaming bucketed corpus scan on the bank's device; same results
    contract as the reference (scores allclose, detections identical).

    ``plain=True`` runs the kernels' plain versions (the reference the
    kernels are held against).  ``manifest``: an optional
    ``checkpoint.ScanManifest`` to record the scan's shards in and to
    resume it from (the module's docstring)."""
    _check_options(cfg)
    fcfg, dcfg = cfg.frontend, cfg.detect
    dev = bank.device
    wf, cf = bank.llr()
    if dcfg.score_backend == "fft":
        scorer = build_fft_bank(filters_to_flat(wf), cf,
                                mm_dtype=torch.int8 if dcfg.int8_spectra else None)
    else:
        scorer = (filters_to_flat(wf), cf)
    dtw = None
    if dcfg.dtw_rescore:
        w_rows, c_rows = bank.llr_rows()
        w_rows = filters_to_flat(w_rows)
        if cfg.dtw.top_r == 1 and dev.type == "cuda":
            # one bf16 copy, the pair-LLR kernel's operand type
            w_rows = w_rows.to(torch.bfloat16)
        dtw = DTWRescore(w_rows.contiguous(), c_rows, bank.template_length + cfg.dtw.band,
                         cfg.dtw.band, cfg.dtw.top_r)

    def compute(wavs, vs, marks):
        return scan_step(
            wavs, vs, scorer,
            fcfg=fcfg, template_length=bank.template_length,
            nms_radius=dcfg.nms_radius,
            top_k=dcfg.effective_top_k(wavs.shape[1], fcfg.sample_rate),
            dtw=dtw, plain=plain, marks=marks,
        )

    return stream_scan(
        corpus, fcfg, max(1, dcfg.batch_size), compute, bank.num_templates,
        dev, target_phone=target_phone, manifest=manifest,
    )


def _pcm16(wav) -> np.ndarray:
    """A float waveform on the PCM16 grid, as int16 (the reference's
    ``SCAN_UPLOAD_INT16`` rows)."""
    return np.clip(np.round(np.asarray(wav) * 32768.0), -32768, 32767).astype(np.int16)


def stream_scan(
    corpus,
    fcfg,
    batch_size: int,
    compute,
    num_templates: int,
    device: torch.device,
    target_phone: str | None = None,
    manifest=None,
    local_rows=None,
) -> CorpusDetections:
    """bucket -> batch -> ``compute(wavs [B, S], valid [B], marks) ->
    (s, t, k)`` on ``device`` -> grouped, windowed fetch [-> manifest]
    (the module's docstring) -> ``DetectionSet``."""
    if local_rows is not None:
        raise NotImplementedError(
            "local_rows: per-process lazy feeding is not ported yet "
            "(ROADMAP.md Queue 1, item 7, 'parallel/ on torch.distributed')"
        )
    upload_i16 = os.environ.get("SCAN_UPLOAD_INT16", "0") == "1"
    # the reference's fetch knobs, read as it reads them
    depth = max(int(os.environ.get("SCAN_PIPELINE_DEPTH", "3")), 1)
    group_n = max(int(os.environ.get("SCAN_FETCH_GROUP", "8")), 1)
    cuda = device.type == "cuda"
    stats = StageCounters()
    done_shards = manifest.completed() if manifest is not None else set()
    results: dict[int, tuple] = {}
    labels: list[np.ndarray] = []
    utt_ids: list[str] = []
    pending: dict[int, list] = {}       # pad_samples -> [(gidx, wav)]
    open_grp: list = []                 # batches run, not yet in a fetch
    inflight = collections.deque()      # fetches started, not yet read
    device_ms = collections.defaultdict(float)
    total_samples = 0
    n_batches = 0
    n_loaded = 0
    n_fetches = 0
    stats.start("scan")

    def load(sid, items):
        """A completed shard from the manifest, checked against the
        batch the scan would run, straight into the results."""
        gidxs = [g for g, _w in items]
        lens = [len(w) for _g, w in items]
        z = manifest.load_shard(sid)
        if list(z["gidx"]) != gidxs or list(z["ns"]) != lens:
            raise ValueError(
                f"manifest shard {sid} covers utterances {list(z['gidx'])} "
                f"(lengths {list(z['ns'])}), scan expects {gidxs} (lengths "
                f"{lens}): corpus or config changed since the checkpointed scan"
            )
        # rows past the shard's utterances (a padded tail) are not read
        for row, g in enumerate(gidxs):
            results[g] = (np.asarray(z["s"][row], np.float32),
                          np.asarray(z["t"][row]).astype(np.int32),
                          np.asarray(z["k"][row]).astype(np.int32))

    def flush(sid, items, pad):
        b_eff = batch_size
        if len(items) < batch_size:
            b_eff = 1
            while b_eff < len(items):
                b_eff *= 2
            b_eff = min(b_eff, batch_size)
        dt = torch.int16 if upload_i16 else torch.float32
        wavs = torch.zeros((b_eff, pad), dtype=dt, pin_memory=cuda)
        vs = torch.zeros((b_eff,), dtype=torch.int32, pin_memory=cuda)
        w_np, v_np = wavs.numpy(), vs.numpy()
        for row, (_g, payload) in enumerate(items):
            v_np[row] = len(payload)
            w_np[row, : len(payload)] = _pcm16(payload) if upload_i16 else payload
        marks = [] if cuda else None
        s, t, k = compute(
            wavs.to(device, non_blocking=True), vs.to(device, non_blocking=True),
            marks,
        )
        # times and template ids are exact in float32 (< 2**24): one
        # packed [3, B, top-K] array a batch, left on the device
        packed = torch.stack([s, t.to(torch.float32), k.to(torch.float32)])
        return (sid, [g for g, _w in items], [len(w) for _g, w in items], packed, marks,
                (wavs, vs))

    def start_fetch():
        """Pack the open group's triples into one array (zero-padded to
        the group's largest batch and top-K) and start its one copy to
        the host."""
        nonlocal n_fetches
        if not open_grp:
            return
        if len(open_grp) == 1:
            arr = open_grp[0][3][None]
        else:
            bmax = max(b[3].shape[1] for b in open_grp)
            kmax = max(b[3].shape[2] for b in open_grp)
            arr = torch.zeros((len(open_grp), 3, bmax, kmax), dtype=torch.float32,
                              device=device)
            for i, batch in enumerate(open_grp):
                packed = batch[3]
                arr[i, :, : packed.shape[1], : packed.shape[2]] = packed
        done = None
        if cuda:
            host = torch.empty(arr.shape, dtype=torch.float32, pin_memory=True)
            host.copy_(arr, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host = arr
        metas = [(sid, g, lens, tuple(packed.shape[1:]), marks, keep)
                 for sid, g, lens, packed, marks, keep in open_grp]
        inflight.append((metas, host, done))
        open_grp.clear()
        n_fetches += 1

    def drain(flight):
        metas, host, done = flight
        if done is not None:
            done.synchronize()
        a = host.numpy()
        for i, (sid, gidxs, lens, (b, kb), marks, _keep_alive) in enumerate(metas):
            for (_n0, e0), (name, e1) in zip(marks or [], (marks or [])[1:]):
                device_ms[name] += e0.elapsed_time(e1)
            s = np.asarray(a[i, 0, :b, :kb], np.float32)
            t = a[i, 1, :b, :kb].astype(np.int32)
            k = a[i, 2, :b, :kb].astype(np.int32)
            if manifest is not None:
                manifest.record(sid, {"s": s, "t": t, "k": k,
                                      "gidx": np.asarray(gidxs, np.int64),
                                      "ns": np.asarray(lens, np.int64)})
            for row, g in enumerate(gidxs):
                results[g] = (s[row], t[row], k[row])

    def submit(batch):
        open_grp.append(batch)
        if len(open_grp) == group_n:
            start_fetch()
            while len(inflight) > depth:
                drain(inflight.popleft())

    def dispatch(sid, items, pad):
        nonlocal n_batches, n_loaded
        if sid in done_shards:
            load(sid, items)
            n_loaded += 1
        else:
            submit(flush(sid, items, pad))
            n_batches += 1

    def drain_surviving():
        """After a failure: fetch the batches already run and record
        them, oldest first, up to the first fetch that fails too (on the
        card a fault is sticky, so that may be the first)."""
        try:
            start_fetch()
        except Exception:
            open_grp.clear()
        while inflight:
            try:
                drain(inflight.popleft())
            except Exception:
                break

    shard_id = 0
    try:
        for gidx, (uid, wav, phones) in enumerate(corpus.iter_utterances()):
            nf = len(wav)
            total_samples += nf
            utt_ids.append(uid)
            if target_phone is not None:
                labels.append(np.asarray(
                    [s0 // fcfg.hop_length
                     for (ph, s0, _e) in phones if ph == target_phone],
                    dtype=np.int64,
                ))
            else:
                labels.append(np.zeros(0, np.int64))
            stats.add("frames", float(
                (nf - fcfg.frame_length) // fcfg.hop_length
                if nf >= fcfg.frame_length else 0
            ))
            pad = bucket_length(nf)
            pending.setdefault(pad, []).append((gidx, wav))
            if len(pending[pad]) == batch_size:
                dispatch(shard_id, pending.pop(pad), pad)
                shard_id += 1
        # partial tail batches, one per bucket (rows past the tail stay
        # zero -> valid 0 -> all -inf detections, dropped by DetectionSet)
        for pad in sorted(pending):
            dispatch(shard_id, pending[pad], pad)
            shard_id += 1
        start_fetch()
        while inflight:
            drain(inflight.popleft())
    except BaseException:
        if manifest is not None:
            drain_surviving()
        raise
    if not utt_ids:
        raise ValueError("empty corpus")

    per_utt = [results[g] for g in range(len(utt_ids))]
    dets = ev.DetectionSet.from_per_utterance(per_utt)
    stats.stop("scan")
    stats.add("batches", float(n_batches))
    if manifest is not None:
        stats.add("shards_loaded", float(n_loaded))
    stats.add("fetches", float(n_fetches))
    stats.add("utterances", float(len(utt_ids)))
    stats.add("audio_seconds", total_samples / corpus.sample_rate)
    stats.add("detections", float(len(dets.scores)))
    stats.add("windows_scored", stats.counters["frames"] * num_templates)
    for name in STAGES:
        if name in device_ms:
            stats.add(f"device_ms_{name}", device_ms[name])
    counters = stats.to_dict()
    counters["audio_s_per_s"] = stats.rate("audio_seconds", "scan")
    stats.log("detect_corpus_stream ")
    return CorpusDetections(
        dets, labels, total_samples / corpus.sample_rate, utt_ids, counters
    )
