"""Template bank container.

Counterpart of ``template_speech_recognition_tpu.models.bank``: K
Bernoulli templates of one registered length stacked into [K, L, F, E],
with the background [F, E] and a class label per template, and for a
parts-coded bank the part dictionary.  ``save`` writes the reference's
``.npz`` keys and ``load`` reads them, so a bank crosses between the
packages both ways.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from template_speech_recognition_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TemplateBank:
    templates: torch.Tensor         # [K, L, F, E] float32 in (0, 1)
    background: torch.Tensor        # [F, E] float32 in (0, 1)
    labels: list[str]               # len K, class name per template
    # parts-coded banks: the patch dictionary [J, pt, pf, E] that re-codes
    # edge maps before scoring (then F, E above are the part map's
    # frequency extent and J); None for raw-edge banks
    parts: torch.Tensor | None = None

    @property
    def num_templates(self) -> int:
        return int(self.templates.shape[0])

    @property
    def template_length(self) -> int:
        return int(self.templates.shape[1])

    @property
    def device(self) -> torch.device:
        return self.templates.device

    @classmethod
    def from_classes(cls, class_templates: dict, background, parts=None,
                     device=None) -> "TemplateBank":
        """class name -> [L, F, E] or [C, L, F, E] (C components), classes
        sorted by name; arrays or tensors, put on ``device``."""
        dev = resolve_device(device)

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32).to(dev)

        tpls, labels = [], []
        for name in sorted(class_templates):
            t = f32(class_templates[name])
            for comp in (t[None] if t.dim() == 3 else t):
                tpls.append(comp)
                labels.append(name)
        return cls(torch.stack(tpls), f32(background), labels,
                   None if parts is None else f32(parts))

    def llr(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(W [K, L, F, E], c [K]) float32 log-likelihood-ratio filter."""
        p, q = self.templates, self.background
        w = (torch.log(p) - torch.log1p(-p)) - (torch.log(q) - torch.log1p(-q))
        c = torch.sum(torch.log1p(-p) - torch.log1p(-q), dim=(1, 2, 3))
        return w, c

    def llr_rows(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(W [K, L, F, E], c_rows [K, L]) -- per-row offsets for DTW."""
        p, q = self.templates, self.background
        w = (torch.log(p) - torch.log1p(-p)) - (torch.log(q) - torch.log1p(-q))
        c_rows = torch.sum(torch.log1p(-p) - torch.log1p(-q), dim=(2, 3))
        return w, c_rows

    def llr_quantized(self, scale: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Fixed-point (W [K, L, F, E] int32, c [K] int32) for the exact
        path: ``round(x * scale)``, half to even as the reference's
        ``jnp.round``."""
        w, c = self.llr()
        return (torch.round(w * scale).to(torch.int32),
                torch.round(c * scale).to(torch.int32))

    def save(self, path: str) -> None:
        """The reference's ``.npz``: ``templates``, ``background``, JSON
        ``labels`` and, for a parts-coded bank, ``parts``."""
        arrays = dict(
            templates=self.templates.cpu().numpy(),
            background=self.background.cpu().numpy(),
            labels=json.dumps(self.labels),
        )
        if self.parts is not None:
            arrays["parts"] = self.parts.cpu().numpy()
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str, device=None) -> "TemplateBank":
        """Read a bank ``.npz`` that either package's ``save`` wrote."""
        z = np.load(path, allow_pickle=False)
        dev = resolve_device(device)

        def f32(key):
            return torch.from_numpy(np.asarray(z[key], np.float32)).to(dev)

        return cls(f32("templates"), f32("background"), json.loads(str(z["labels"])),
                   f32("parts") if "parts" in z.files else None)
