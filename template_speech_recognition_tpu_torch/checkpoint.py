"""Checkpoint / resume.

Counterpart of ``template_speech_recognition_tpu.checkpoint``, without
orbax:

* ``save_bank`` / ``restore_bank`` -- a template bank as a directory
  holding the ``.npz`` of ``TemplateBank.save`` (``bank.npz``: the
  templates, the background, the labels in their order and, for a
  parts-coded bank, the part dictionary) and ``labels.json``.  The
  reference writes an orbax directory there instead, which the port
  cannot read: the ``.npz`` is the format that crosses between the
  packages (either package's ``TemplateBank.save`` / ``load``).
* ``save_em_state`` / ``restore_em_state`` -- the ``EMState`` fields as
  one ``.npz`` in a directory, written atomically.
* ``run_em_checkpointed`` -- EM in chunks of iterations, the state saved
  after each chunk; a killed run called again with the same arguments
  resumes from the last saved chunk, bitwise equal to an unbroken run.
* ``ScanManifest`` -- corpus-scan progress, one ``.npz`` a shard and a
  JSON list of the completed ones, in the reference's format letter for
  letter: a manifest written by either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zipfile

import numpy as np
import torch

from template_speech_recognition_tpu_torch.models.bank import TemplateBank
from template_speech_recognition_tpu_torch.models.mixture import EMState, resume_fit
from template_speech_recognition_tpu_torch.utils.device import resolve_device

BANK_FILE = "bank.npz"
EM_FILE = "em_state.npz"


def _savez_atomic(path: str, arrays: dict) -> None:
    """``np.savez`` to a temp file beside ``path``, then ``os.replace``:
    a reader sees the old file or the whole new one."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def save_bank(path: str, bank: TemplateBank) -> None:
    """A bank as the directory ``path``: ``bank.npz`` (``TemplateBank.save``)
    and ``labels.json``."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, "bank.tmp.npz")
    bank.save(tmp)
    os.replace(tmp, os.path.join(path, BANK_FILE))
    with open(os.path.join(path, "labels.json"), "w") as f:
        json.dump(bank.labels, f)


def restore_bank(path: str, device=None) -> TemplateBank:
    """The bank that ``save_bank`` wrote to ``path``, on ``device`` (the
    GPU unless the caller asks for the CPU)."""
    return TemplateBank.load(os.path.join(path, BANK_FILE), device=device)


def save_em_state(path: str, state: EMState) -> None:
    """The ``EMState`` fields as ``em_state.npz`` in the directory
    ``path``, written atomically."""
    os.makedirs(path, exist_ok=True)
    _savez_atomic(os.path.join(path, EM_FILE),
                  {k: torch.as_tensor(v).cpu().numpy() for k, v in state._asdict().items()})


def restore_em_state(path: str, device=None) -> EMState:
    """The ``EMState`` that ``save_em_state`` wrote to ``path``."""
    dev = resolve_device(device)
    with np.load(os.path.join(path, EM_FILE)) as z:
        return EMState(**{k: torch.from_numpy(z[k]).to(dev) for k in EMState._fields})


def run_em_checkpointed(
    x,
    init_resp,
    path: str,
    num_iters: int = 50,
    chunk_iters: int = 10,
    eps: float = 0.01,
    tol: float = 1e-4,
    mask=None,
    device=None,
) -> EMState:
    """EM with a checkpoint every ``chunk_iters`` iterations.

    The fit of ``models.mixture.bernoulli_mixture_em`` (x [N, D],
    init_resp [N, K], mask [N] optional) runs in chunks of at most
    ``chunk_iters`` iterations, the whole ``EMState`` saved to the
    directory ``path`` after each.  A killed job called again with the
    same arguments restores the last saved state and goes on; the result
    is bitwise that of an unbroken run (one chunk resumes exactly where
    the last stopped).  An empty or unreadable directory starts fresh,
    as in the reference.  Runs on ``x``'s device when ``x`` is a tensor,
    else on ``device`` (the GPU unless the caller asks for the CPU)."""
    dev = x.device if isinstance(x, torch.Tensor) and device is None else resolve_device(device)
    x = torch.as_tensor(x).to(device=dev, dtype=torch.float32)
    n = x.shape[0]
    mask_t = (torch.ones(n, device=dev) if mask is None
              else torch.as_tensor(mask).to(device=dev, dtype=torch.float32))
    state = None
    if os.path.isdir(path) and os.listdir(path):
        try:
            state = restore_em_state(path, dev)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            state = None
    if state is None:
        init = torch.as_tensor(init_resp).to(device=dev, dtype=torch.float32)
        k = init.shape[1]
        state = EMState(
            iteration=torch.zeros((), dtype=torch.int32, device=dev),
            responsibilities=init,
            means=torch.zeros((k, x.shape[1]), device=dev),
            weights=torch.full((k,), 1.0 / k, device=dev),
            log_likelihood=torch.full((), float("-inf"), device=dev),
            done=torch.zeros((), dtype=torch.bool, device=dev),
            history=torch.full((num_iters,), float("nan"), device=dev),
        )
    while int(state.iteration) < num_iters and not bool(state.done):
        lead = EMState(*(a[None] for a in state))
        state = EMState(*(a[0] for a in resume_fit(x, lead, num_iters, eps, tol, mask_t,
                                                   max_steps=chunk_iters)))
        save_em_state(path, state)
    return state


@dataclasses.dataclass
class ScanManifest:
    """Crash-tolerant corpus-scan progress.

    Shards are work units (the scan's batches, numbered in dispatch
    order).  ``manifest.json`` holds ``{"completed": [...]}``; shard
    ``i`` is ``shard_{i:05d}.npz``.  Both are written to a temp file and
    renamed into place, so a scan killed mid-shard never marks that shard
    and a resume recomputes it."""

    root: str

    def _manifest_path(self) -> str:
        return os.path.join(self.root, "manifest.json")

    def _shard_path(self, shard_id: int) -> str:
        return os.path.join(self.root, f"shard_{shard_id:05d}.npz")

    def completed(self) -> set[int]:
        try:
            with open(self._manifest_path()) as f:
                return set(json.load(f)["completed"])
        except FileNotFoundError:
            return set()

    def record(self, shard_id: int, arrays: dict[str, np.ndarray]) -> None:
        """Persist one shard's results, then mark it complete."""
        os.makedirs(self.root, exist_ok=True)
        _savez_atomic(self._shard_path(shard_id), arrays)
        done = sorted(self.completed() | {shard_id})
        tmp_m = self._manifest_path() + ".tmp"
        with open(tmp_m, "w") as f:
            json.dump({"completed": done}, f)
        os.replace(tmp_m, self._manifest_path())

    def load_shard(self, shard_id: int) -> dict[str, np.ndarray]:
        with np.load(self._shard_path(shard_id)) as z:
            return {k: z[k] for k in z.files}

    def run(self, shard_ids, work_fn) -> dict[int, dict[str, np.ndarray]]:
        """``work_fn(shard_id) -> {name: array}`` for every shard not yet
        completed, recorded as it returns; all shards' results (the
        completed ones loaded from disk).  Re-running after a crash
        resumes where the manifest left off."""
        results = {}
        done = self.completed()
        for sid in shard_ids:
            if sid in done:
                results[sid] = self.load_shard(sid)
            else:
                out = work_fn(sid)
                self.record(sid, out)
                results[sid] = out
        return results
